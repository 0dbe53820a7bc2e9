"""Mean milliseconds of one tick through the entry (CUDA events around the
step call, or around a segment's rollout_collect divided by its ticks),
the entry's copies on the card included."""


def read(rec):
    if rec["pixels"]:
        return None
    w = rec["window"]
    return sum(w.tick_ms) / w.ticks
