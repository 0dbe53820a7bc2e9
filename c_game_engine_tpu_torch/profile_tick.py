"""Profile the port's tick on one GPU with torch.profiler.

    python3 -m c_game_engine_tpu_torch.profile_tick [map] [batch] [ticks]

(defaults: arena_bodies, 4096 envs, 10 ticks). Loads a committed map
(c_game_engine_tpu_torch/maps/), runs 8 warm-up ticks of the bench.py
stream (hold W, look += 0.01), then profiles `ticks` more and prints one
JSON line: the card, wall ms per tick, device kernel ms per tick, the
device's busy share, kernel launches and host syncs per tick, and the
device time of each hand-written kernel per tick and per launch, with its
share. A run without a
CUDA device fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

MAPS = Path(__file__).resolve().parent / "maps"
# the hand-written kernels' CUDA function names
KERNEL_NAMES = ("capsule_resolve_kernel", "ray_tris_kernel", "body_contacts_kernel")


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


def main(argv) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from c_game_engine_tpu_torch.core.state import load_map
    from c_game_engine_tpu_torch.models.sim import bench_actions, reset_batch, rollout

    if not torch.cuda.is_available():
        print("profile_tick: no CUDA device", file=sys.stderr)
        return 2
    name = argv[0] if argv else "arena_bodies"
    batch = int(argv[1]) if len(argv) > 1 else 4096
    ticks = int(argv[2]) if len(argv) > 2 else 10
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cmap = load_map(MAPS / f"{name}.npz", MAPS / f"{name}.json", "cuda")
    acts = bench_actions(8 + ticks, batch)
    state = rollout(cmap, reset_batch(cmap, batch), acts[:8])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = rollout(cmap, state, acts[8:])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_us, launches, syncs, found = device_summary(prof, KERNEL_NAMES)
    kernels = {k: {"ms_per_tick": dev / 1e3 / ticks, "launches": n, "ms_per_launch": dev / 1e3 / n,
                   "share_of_device_time": dev / device_us if device_us else None}
               for k, (dev, n) in found.items()}
    print(json.dumps({
        "card": card, "map": name, "batch": batch, "ticks": ticks,
        "wall_ms_per_tick": wall * 1e3 / ticks,
        "device_ms_per_tick": device_us / 1e3 / ticks,
        "busy_share": device_us / 1e6 / wall if wall else None,
        "launches_per_tick": launches / ticks,
        "host_syncs_per_tick": syncs / ticks,
        "kernels": kernels,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
