"""Profile the port's render path on one GPU with torch.profiler.

    python3 -m c_game_engine_tpu_torch.profile_render [map] [batch] [size] [headings]

(defaults: arena_lit, 64 envs, 256 x 256, 4 headings). Loads a committed
map and its render bundle (c_game_engine_tpu_torch/maps/), runs 60 ticks of
the bench.py stream (hold W, look += 0.01), renders the yaw sweep of
benchmarks/run_all.py::bench_render (k * 2 pi / headings added to yaw)
once as warm-up, then profiles one more sweep and prints one JSON line:
the card, wall ms per frame batch, frames/s, device kernel ms per frame
batch, the device's busy share, kernel launches and host syncs per frame
batch, and each raster kernel's (K4 on the tile route, K5 on the big
route) device time per launch, launches and share. A run without a CUDA
device fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# ops module name: CUDA kernel name
KERNELS = {"raster_tiles": "raster_tiles_kernel", "raster_tiles_big": "raster_tiles_big_kernel"}


def render_calls(module, fn_name, bundle, cmap, state, size):
    """Run one size x size render_batch with module.fn_name wrapped and
    return the (args, kwargs) of each of its calls, in call order."""
    from c_game_engine_tpu_torch.render.raster import render_batch

    seen, kernel = [], getattr(module, fn_name)

    def rec(*a, **k):
        seen.append((a, k))
        return kernel(*a, **k)

    setattr(module, fn_name, rec)
    try:
        render_batch(bundle, cmap, state, size, size)
    finally:
        setattr(module, fn_name, kernel)
    return seen


def main(argv) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from c_game_engine_tpu_torch.models.sim import bench_actions, reset_batch, rollout
    from c_game_engine_tpu_torch.profile_tick import device_summary
    from c_game_engine_tpu_torch.render.bundle import load_render_map
    from c_game_engine_tpu_torch.render.raster import render_batch, yaw_sweep

    if not torch.cuda.is_available():
        print("profile_render: no CUDA device", file=sys.stderr)
        return 2
    name = argv[0] if argv else "arena_lit"
    batch = int(argv[1]) if len(argv) > 1 else 64
    size = int(argv[2]) if len(argv) > 2 else 256
    headings = int(argv[3]) if len(argv) > 3 else 4
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cmap, bundle = load_render_map(name, "cuda")
    states = yaw_sweep(rollout(cmap, reset_batch(cmap, batch), bench_actions(60, batch)), headings)
    for s in states:
        render_batch(bundle, cmap, s, size, size)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for s in states:
            render_batch(bundle, cmap, s, size, size)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_us, launches, syncs, found = device_summary(prof, tuple(KERNELS.values()))
    kernels = {}
    for op, kname in KERNELS.items():
        dev, n = found.get(kname, (0.0, 0))
        kernels[op] = {"ms_per_launch": dev / 1e3 / n if n else None, "launches": n,
                       "share_of_device_time": dev / device_us if device_us else None}
    print(json.dumps({
        "card": card, "map": name, "batch": batch, "size": size, "frame_batches": headings,
        "wall_ms_per_frame_batch": wall * 1e3 / headings,
        "frames_per_s": batch * headings / wall,
        "device_ms_per_frame_batch": device_us / 1e3 / headings,
        "busy_share": device_us / 1e6 / wall if wall else None,
        "launches_per_frame_batch": launches / headings,
        "host_syncs_per_frame_batch": syncs / headings,
        **kernels,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
