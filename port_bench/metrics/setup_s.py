"""Seconds from the start of the run to the first timed step: loading the
map, making the actions, building the kernels, capturing the graphs and
warming up every call the window makes."""


def read(rec):
    return rec["setup_s"]
