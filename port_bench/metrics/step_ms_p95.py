"""The 95th percentile (nearest rank) over every step of the window,
resets included, of one agent step: CUDA events from before the step's
actions are handed over until its observation is ready (copied to pinned
host memory, or the frames on the card)."""

import math


def read(rec):
    if rec["loop"] != "closed":
        return None
    ms = sorted(rec["window"].step_ms)
    return ms[math.ceil(0.95 * len(ms)) - 1]
