"""Share of the traced window of a pixel cell in which no kernel, copy or
fill ran on the card (as device_idle.steps)."""

from harness import trace


def read(rec):
    tl = rec["timeline"]
    if tl is None or not rec["pixels"]:
        return None
    return 1.0 - trace.busy_s(tl) / tl.window_s
