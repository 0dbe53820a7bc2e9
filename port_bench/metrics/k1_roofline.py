"""K1's (capsule resolve's) share of its roofline in the traced calls: the
bound of the launches (harness/bounds.py::k1_bound on the arguments one
eager tick hands K1: the main launch and the stick-to-floor launch) over
the device seconds of the kernel `capsule_resolve_kernel` in the trace.
One main launch a tick; the launches beyond the ticks are stick
launches."""

from harness import bounds, trace

CAPTURE = ("c_game_engine_tpu_torch.physics.batched", "resolve_capsule", "tick")


def read(rec):
    tl, calls = rec["timeline"], rec["captured"].get(CAPTURE)
    if tl is None or not calls:
        return None
    dev_s, launches = trace.kernel(tl, "capsule_resolve_kernel")
    ticks = rec["traced_ticks"]
    if not launches or dev_s <= 0:
        return None
    main_ms = bounds.k1_bound(calls[0][0])[0]
    stick = launches - ticks
    if stick > 0 and len(calls) < 2:
        return None
    total_ms = min(ticks, launches) * main_ms + max(stick, 0) * (bounds.k1_bound(calls[1][0])[0] if stick > 0 else 0.0)
    return 100.0 * total_ms / (dev_s * 1e3)
