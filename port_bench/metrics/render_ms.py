"""Mean milliseconds of one frame batch (CUDA events around
render_batch)."""


def read(rec):
    ms = rec["window"].render_ms
    return sum(ms) / len(ms) if ms else None
