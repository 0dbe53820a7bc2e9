"""Mean milliseconds of one tick through the entry in a pixel cell (CUDA
events around the step call)."""


def read(rec):
    if not rec["pixels"]:
        return None
    w = rec["window"]
    return sum(w.tick_ms) / w.ticks
