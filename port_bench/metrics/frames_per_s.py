"""Observation frames delivered over the whole window: envs x frame
batches / seconds (host clock around the window; every step ends with its
frames ready on the card)."""


def read(rec):
    if not rec["pixels"]:
        return None
    w = rec["window"]
    return rec["envs"] * w.calls / w.seconds
