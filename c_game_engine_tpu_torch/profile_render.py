"""Profile the port's render path on one GPU with torch.profiler.

    python3 -m c_game_engine_tpu_torch.profile_render [map] [batch] [size] [headings] [eager|graph] [hud]

(defaults: arena_lit, 64 envs, 256 x 256, 4 headings, eager; with `hud`
the frames of render_with_hud_batch, with render/synthetic_hud.py's HUD
and viewmodel and HUD values). Loads a
committed map and its render bundle (c_game_engine_tpu_torch/maps/), runs
60 ticks of the bench.py stream (hold W, look += 0.01), renders the yaw
sweep of benchmarks/run_all.py::bench_render (k * 2 pi / headings added to
yaw) once as warm-up (in graph mode this captures the bundle's render
graph), then profiles one more sweep, through render_batch_eager or as
replays of the graph (render_batch on the card), and prints one JSON line:
the card, the mode, wall ms per frame batch, frames/s, device kernel ms
per frame batch, the device's busy share, device kernel launches, what
the host issued (kernel launches, graph launches, copies and fills), host
syncs and Memcpy HtoD and DtoH per frame batch, and each raster kernel's
(K4 on the tile route, K5 on the big route) device time per launch,
launches and share, and the device ops that take the most time. A run
without a CUDA device fails.
"""

from __future__ import annotations

import json
import sys
import time

# ops module name: CUDA kernel name
KERNELS = {"raster_tiles": "raster_tiles_kernel", "raster_tiles_big": "raster_tiles_big_kernel"}
TOP_OPS = 12  # the device ops listed by their time


def render_calls(module, fn_name, bundle, cmap, state, size, **options):
    """Run one size x size render_batch_eager with module.fn_name wrapped
    and return the (args, kwargs) of each of its calls, in call order."""
    from c_game_engine_tpu_torch.render.raster import render_batch_eager

    seen, kernel = [], getattr(module, fn_name)

    def rec(*a, **k):
        seen.append((a, k))
        return kernel(*a, **k)

    setattr(module, fn_name, rec)
    try:
        render_batch_eager(bundle, cmap, state, size, size, **options)
    finally:
        setattr(module, fn_name, kernel)
    return seen


def renderer(mode, hud=False):
    """The frame function profiled: render_batch (graph) or
    render_batch_eager, or with hud their render_with_hud_batch
    counterparts."""
    from c_game_engine_tpu_torch.render import raster as R

    return {(False, "eager"): R.render_batch_eager, (False, "graph"): R.render_batch,
            (True, "eager"): R.render_with_hud_batch_eager, (True, "graph"): R.render_with_hud_batch}[hud, mode]


def profile_sweep(bundle, cmap, states, size, mode="eager", hud=False):
    """Profile one size x size render of each state of `states` (a yaw
    sweep), eagerly or as replays of the bundle's graph (captured before:
    run the sweep once first, so the window holds replays only); with hud,
    render_with_hud_batch's frames. Returns a summary dict with
    per-frame-batch figures and the TOP_OPS device ops that take the most
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from c_game_engine_tpu_torch.profile_tick import device_summary, host_summary

    render = renderer(mode, hud)
    n = len(states)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for s in states:
            render(bundle, cmap, s, size, size)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_us, launches, syncs, found = device_summary(prof, tuple(KERNELS.values()))
    host = host_summary(prof)
    kernels = {}
    for op, kname in KERNELS.items():
        dev, k = found.get(kname, (0.0, 0))
        kernels[op] = {"ms_per_launch": dev / 1e3 / k if k else None, "launches": k,
                       "share_of_device_time": dev / device_us if device_us else None}
    batch = states[0].tick.shape[0]
    by_op = sorted(((getattr(e, "self_device_time_total", None) or e.self_cuda_time_total, e.count, e.key)
                    for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
    return {
        "mode": mode, "hud": hud, "batch": batch, "size": size, "frame_batches": n,
        "wall_ms_per_frame_batch": wall * 1e3 / n,
        "frames_per_s": batch * n / wall,
        "device_ms_per_frame_batch": device_us / 1e3 / n,
        "busy_share": device_us / 1e6 / wall if wall else None,
        "launches_per_frame_batch": launches / n,
        "host_per_frame_batch": {k: v / n for k, v in host.items() if not k.startswith("memcpy")},
        "host_syncs_per_frame_batch": syncs / n,
        "memcpy_htod_per_frame_batch": host["memcpy_htod"] / n,
        "memcpy_dtoh_per_frame_batch": host["memcpy_dtoh"] / n,
        **kernels,
        "top_ops": [{"op": k[:120], "ms_per_frame_batch": us / 1e3 / n, "launches_per_frame_batch": c / n}
                    for us, c, k in by_op[:TOP_OPS]],
    }


def main(argv) -> int:
    import torch

    from c_game_engine_tpu_torch.bench import card_line
    from c_game_engine_tpu_torch.models.sim import bench_actions, reset_batch, rollout
    from c_game_engine_tpu_torch.render.bundle import load_render_map
    from c_game_engine_tpu_torch.render.raster import yaw_sweep
    from c_game_engine_tpu_torch.render.synthetic_hud import hud_states, with_synthetic_hud

    if not torch.cuda.is_available():
        print("profile_render: no CUDA device", file=sys.stderr)
        return 2
    name = argv[0] if argv else "arena_lit"
    batch = int(argv[1]) if len(argv) > 1 else 64
    size = int(argv[2]) if len(argv) > 2 else 256
    headings = int(argv[3]) if len(argv) > 3 else 4
    mode = argv[4] if len(argv) > 4 else "eager"
    hud = len(argv) > 5 and argv[5] == "hud"
    cmap, bundle = load_render_map(name, "cuda")
    state = rollout(cmap, reset_batch(cmap, batch), bench_actions(60, batch))
    if hud:
        bundle, state = with_synthetic_hud(bundle), hud_states(state)
    states = yaw_sweep(state, headings)
    for s in states:  # warm-up (in graph mode the capture)
        renderer(mode, hud)(bundle, cmap, s, size, size)
    summary = profile_sweep(bundle, cmap, states, size, mode, hud)
    extra = {}
    if mode == "graph":
        (graph,) = bundle.graphs.values()
        extra = {"capture_s": graph.capture_s, "graph_pool_bytes": graph.pool_bytes}
    print(json.dumps({"card": card_line(), "map": name, **summary, **extra}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
