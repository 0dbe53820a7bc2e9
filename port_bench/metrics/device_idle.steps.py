"""Share of the traced window in which no kernel, copy or fill ran on the
card: 1 - the union of the device's intervals on the profiler's timeline
over the window's length."""

from harness import trace


def read(rec):
    tl = rec["timeline"]
    if tl is None or rec["pixels"]:
        return None
    return 1.0 - trace.busy_s(tl) / tl.window_s
