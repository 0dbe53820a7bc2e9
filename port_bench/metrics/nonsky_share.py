"""The smallest non-sky share of any frame batch in the window
(harness/loop.py::nonsky): an empty frame cannot score."""


def read(rec):
    c = rec["window"].cov_min
    return None if c is None else float(c)
