"""K4's (tile raster's) share of its roofline in the traced frame batches:
the bound of both passes (harness/bounds.py::k4_bound on what one eager
frame batch hands K4 and gets back) times the frame batches, over the
device seconds of the kernel `raster_tiles_kernel` in the trace."""

from harness import bounds, trace

CAPTURE = ("c_game_engine_tpu_torch.ops.raster_tiles", "raster_tiles_binned", "frame")


def read(rec):
    tl, calls = rec["timeline"], rec["captured"].get(CAPTURE)
    if tl is None or not calls:
        return None
    dev_s, launches = trace.kernel(tl, "raster_tiles_kernel")
    if not launches or dev_s <= 0:
        return None
    per_launch_ms = sum(bounds.k4_bound(a, kw, planes)[0] for a, kw, planes in calls) / len(calls)
    return 100.0 * per_launch_ms * launches / (dev_s * 1e3)
