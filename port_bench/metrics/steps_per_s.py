"""Env steps completed over the whole window: envs x ticks / seconds (host
clock around the window; every call ends in a wait for its observation)."""


def read(rec):
    if rec["pixels"]:
        return None
    w = rec["window"]
    return rec["envs"] * w.ticks / w.seconds
