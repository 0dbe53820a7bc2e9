"""Entry points (counterpart of __graft_entry__.py): `entry()`, the graphed
step of the flagship configuration with example arguments, and
`dryrun_multichip(n)`, one step of an env batch sharded over an n-entry
mesh.

    python3 -m c_game_engine_tpu_torch.entry [--map MAP]
    python3 -m c_game_engine_tpu_torch.entry --dryrun N [--cpu] [--map MAP]

The first runs the step once and prints "entry(): ok"; the second prints
"dryrun_multichip(N): ok, metric=...". MAP is a committed map's name
(default arena) or a `.gmap` or editor-JSON source path, which the port
compiles (models/sim.py::load_named_map).
"""

from __future__ import annotations

import sys

BATCH = 256


def entry(map_name="arena"):
    """Returns (fn, (state, actions)): fn(state, actions) is one tick of a
    256-env batch on `map_name` (default the committed arena map: the JAX
    entry point's test.gmap needs the reference assets) through the CUDA
    tick graph."""
    from c_game_engine_tpu_torch.core.actions import Actions
    from c_game_engine_tpu_torch.models.sim import make_sim

    sim = make_sim(map_name, BATCH, jit=True, device="cuda")
    return sim.step, (sim.reset(), Actions.zeros((BATCH,), device="cuda"))


def dryrun_multichip(n_devices: int, device="cuda", map_name="arena") -> float:
    """Shard a small batch (128 envs an entry, the least shard_sim takes)
    of `map_name` (default the committed arena map: the JAX dry run's
    test.gmap needs the reference assets) over an n-entry mesh, run one step of every shard
    and reduce the mean player height over the whole batch. The entries are `device` n times on the CPU; on
    CUDA they are the visible cards in turn, so one card holds every shard
    of a one-card machine. Prints the JAX dry run's line and returns the
    metric."""
    import torch

    from c_game_engine_tpu_torch.core.actions import Actions
    from c_game_engine_tpu_torch.models.sim import load_named_map
    from c_game_engine_tpu_torch.parallel.mesh import LANE_BLOCK, gather_states, make_mesh, shard_sim

    device = torch.device(device)
    if device.type == "cuda":
        count = torch.cuda.device_count()
        devices = [torch.device("cuda", i % count) for i in range(n_devices)] if count else []
    else:
        devices = [device] * n_devices
    mesh = make_mesh(devices=devices)
    cmap = load_named_map(map_name, mesh[0])
    batch = LANE_BLOCK * n_devices
    _, states, step_fn = shard_sim(cmap, batch, mesh)
    states = step_fn(states, Actions.zeros((batch,), device=mesh[0]))
    final = gather_states(states)
    # the metric's reduction crosses the mesh (the JAX dry run's collective)
    metric = float(final.player.pos[:, 1].mean())
    if int(final.tick.min()) != 1 or final.tick.shape != (batch,):
        raise AssertionError(f"dryrun_multichip({n_devices}): the step did not advance {batch} envs by one tick")
    print(f"dryrun_multichip({n_devices}): ok, metric={metric:.4f}")
    return metric


def main(argv) -> int:
    import torch

    device = "cpu" if "--cpu" in argv else "cuda"
    map_name = argv[argv.index("--map") + 1] if "--map" in argv else "arena"
    if device == "cuda" and not torch.cuda.is_available():
        print("entry: no CUDA device (pass --cpu for the dry run on the CPU)", file=sys.stderr)
        return 2
    if "--dryrun" in argv:
        dryrun_multichip(int(argv[argv.index("--dryrun") + 1]), device, map_name)
        return 0
    if device == "cpu":
        print("entry: entry() is the CUDA graph step; only --dryrun runs on the CPU", file=sys.stderr)
        return 2
    fn, args = entry(map_name)
    out = fn(*args)
    torch.cuda.synchronize()
    assert int(out.tick[0]) == 1 and bool(torch.isfinite(out.player.pos).all())
    print("entry(): ok")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
