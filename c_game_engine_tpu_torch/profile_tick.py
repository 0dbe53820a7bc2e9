"""Profile the port's tick on one GPU with torch.profiler.

    python3 -m c_game_engine_tpu_torch.profile_tick [map] [batch] [ticks] [eager|graph]

(defaults: arena_bodies, 4096 envs, 10 ticks, eager). Loads a committed
map (c_game_engine_tpu_torch/maps/), runs 8 warm-up ticks of the bench.py
stream (hold W, look += 0.01), then profiles `ticks` more, either through
the eager loop (models/sim.py::rollout_eager) or as replays of the map's
captured tick graph (models/sim.py::rollout; the capture happens before
the profiled window), and prints one JSON line: the card, the mode, wall
ms per tick, device kernel ms per tick, the device's busy share, device
kernel launches per tick, what the host issued per tick (kernel
launches, graph launches, copies and fills), host syncs per tick, Memcpy
HtoD and DtoH per tick, and the device time of each hand-written kernel
per tick and per launch, with its share and its launches in the window.

A host sync here is a tensor read on the host (`aten::_local_scalar_dense`:
bool(t), int(t), t.item()). Copies from the host (Memcpy HtoD: a tensor
built from Python values on the card) and to it (Memcpy DtoH) stall the
host too; they are counted apart. A run without a CUDA device fails.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

MAPS = Path(__file__).resolve().parent / "maps"
# the hand-written kernels' CUDA function names
KERNEL_NAMES = ("capsule_resolve_kernel", "ray_tris_kernel", "body_contacts_kernel")
# host-side runtime calls that put work on the card
HOST_KERNEL_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
HOST_COPY_CALLS = ("cudaMemcpyAsync", "cudaMemsetAsync", "cudaMemcpy", "cudaMemset")


def device_summary(prof, kernel_names):
    """(device us, kernel launches, host syncs, {kernel name: (device us,
    launches)}) of a torch.profiler run; memcpy and memset are not counted
    as launches, a host sync is a tensor read on the host (bool(t), int(t))."""
    import torch

    device_us = 0.0
    launches = syncs = 0
    kernels = {}
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = e.self_cuda_time_total
        if dev > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            device_us += dev
            if not e.key.startswith(("Memcpy", "Memset")):
                launches += e.count
            for k in kernel_names:
                if k in e.key:
                    kernels[k] = (dev, e.count)
        if e.key == "aten::_local_scalar_dense":
            syncs += e.count
    return device_us, launches, syncs, kernels


def host_summary(prof):
    """What the host issued and copied in a torch.profiler run: {"kernel
    launches", "graph launches", "copies and fills" (runtime calls),
    "memcpy_htod", "memcpy_dtoh" (device copies)}."""
    out = dict.fromkeys(("kernel_launches", "graph_launches", "copies_and_fills", "memcpy_htod",
                         "memcpy_dtoh"), 0)
    for e in prof.key_averages():
        if e.key in HOST_KERNEL_CALLS:
            out["kernel_launches"] += e.count
        elif e.key == "cudaGraphLaunch":
            out["graph_launches"] += e.count
        elif e.key in HOST_COPY_CALLS:
            out["copies_and_fills"] += e.count
        elif e.key.startswith("Memcpy HtoD"):
            out["memcpy_htod"] += e.count
        elif e.key.startswith("Memcpy DtoH"):
            out["memcpy_dtoh"] += e.count
    return out


def tick_calls(cmap, state, acts):
    """Run one tick and record the arguments it hands K1, K2 and K3, each
    tensor cloned: (the next state, {"k1": [args, ...], "k2": ..., "k3": ...})."""
    from c_game_engine_tpu_torch.core.step import step_batch
    from c_game_engine_tpu_torch.physics import batched, bodies

    seen = {"k1": [], "k2": [], "k3": []}
    k1, k2, k3 = batched.resolve_capsule, batched.ray_tris, bodies.body_contacts

    def recorder(key, fn):
        def rec(*a):
            seen[key].append(tuple(t.clone() if hasattr(t, "clone") else t for t in a))
            return fn(*a)
        return rec

    batched.resolve_capsule, batched.ray_tris = recorder("k1", k1), recorder("k2", k2)
    bodies.body_contacts = recorder("k3", k3)
    try:
        state = step_batch(cmap, state, acts)
    finally:
        batched.resolve_capsule, batched.ray_tris, bodies.body_contacts = k1, k2, k3
    return state, seen


def profile_rollout(cmap, state, acts, mode="eager"):
    """Profile one rollout of `acts` from `state`, eagerly or as graph
    replays (the graph must be captured before, e.g. by a warm-up rollout,
    so the window holds replays only). Returns (final state, summary dict
    with per-tick figures and each hand kernel's launches in the window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from c_game_engine_tpu_torch.models.sim import rollout, rollout_eager

    roll = {"eager": rollout_eager, "graph": rollout}[mode]
    ticks = acts.move.shape[0]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = roll(cmap, state, acts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_us, launches, syncs, found = device_summary(prof, KERNEL_NAMES)
    host = host_summary(prof)
    kernels = {k: {"ms_per_tick": dev / 1e3 / ticks, "launches": n, "ms_per_launch": dev / 1e3 / n,
                   "share_of_device_time": dev / device_us if device_us else None}
               for k, (dev, n) in found.items()}
    return state, {
        "mode": mode, "ticks": ticks,
        "wall_ms_per_tick": wall * 1e3 / ticks,
        "device_ms_per_tick": device_us / 1e3 / ticks,
        "busy_share": device_us / 1e6 / wall if wall else None,
        "launches_per_tick": launches / ticks,
        "host_per_tick": {k: v / ticks for k, v in host.items() if not k.startswith("memcpy")},
        "host_syncs_per_tick": syncs / ticks,
        "memcpy_htod_per_tick": host["memcpy_htod"] / ticks,
        "memcpy_dtoh_per_tick": host["memcpy_dtoh"] / ticks,
        "kernels": kernels,
    }


def main(argv) -> int:
    import torch

    from c_game_engine_tpu_torch.bench import card_line
    from c_game_engine_tpu_torch.core.state import load_map
    from c_game_engine_tpu_torch.models.graph import tick_graph
    from c_game_engine_tpu_torch.models.sim import bench_actions, reset_batch, rollout_eager

    if not torch.cuda.is_available():
        print("profile_tick: no CUDA device", file=sys.stderr)
        return 2
    name = argv[0] if argv else "arena_bodies"
    batch = int(argv[1]) if len(argv) > 1 else 4096
    ticks = int(argv[2]) if len(argv) > 2 else 10
    mode = argv[3] if len(argv) > 3 else "eager"
    cmap = load_map(MAPS / f"{name}.npz", MAPS / f"{name}.json", "cuda")
    acts = bench_actions(8 + ticks, batch)
    state = rollout_eager(cmap, reset_batch(cmap, batch), acts[:8])
    extra = {}
    if mode == "graph":
        graph = tick_graph(cmap, state)
        graph.run(state, acts[8:])  # the first replays, outside the window
        extra = {"capture_s": graph.capture_s, "graph_pool_bytes": graph.pool_bytes}
    _, summary = profile_rollout(cmap, state, acts[8:], mode)
    print(json.dumps({"card": card_line(), "map": name, "batch": batch, **summary, **extra}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
