"""Multi-device scaling: env-batch data parallelism over a 1-D mesh
(counterpart of c_game_engine_tpu/parallel/mesh.py).

As in the JAX package, per-env state never crosses devices while stepping
and only the metrics are reduced, so within a process the port needs no
collective: a mesh is an ordered list of devices, the env axis is split
into equal contiguous shards, one per entry, and each shard steps through
the port's own `rollout` on its device (the map's tick graph on a card,
the eager loop on the CPU). The same device may appear more than once; a
one-card machine or the CPU then checks the split.

A mesh of more than one entry takes shards of a multiple of 128 envs
only, and `shard_sim` refuses any other: the capsule kernel's candidate
set is per 128-lane block (fault f of the reference, ROADMAP §3 f, which
the plain CPU version copies), so a shard boundary inside a block would
change results on the card and on the CPU alike. Such shards give the
unsharded result bit for bit. On several cards each shard's capture and
replay run under its card's `torch.cuda.device`.

In a process group (parallel/distributed.py: one process per card, or per
host) the same calls work across processes. `make_mesh()` gives this
process's entries (its card), `shard_sim` takes the global batch and
builds only this process's envs (`distributed.env_range`), split over its
entries, and the 128-lane rule holds for every shard of every process.
Per-env inputs (`step_fn`'s actions, `split`, `sharded_rollout`'s
`actions`) are this process's envs: each process computes its envs'
actions from the global env index, nothing is broadcast. Still nothing
crosses processes while stepping: `sharded_rollout` gathers only the
metric columns (distributed.process_allgather, host tensors over gloo)
and reduces them as one process does, so its metrics equal the
one-process run's bit for bit.
"""

from __future__ import annotations

import contextlib

import torch

from c_game_engine_tpu_torch.core.actions import Actions
from c_game_engine_tpu_torch.core.state import tree_leaves, tree_map
from c_game_engine_tpu_torch.models.sim import reset_batch, rollout
from c_game_engine_tpu_torch.parallel import distributed

ENV_AXIS = "env"
LANE_BLOCK = 128  # the capsule kernel's lane block (ops/capsule_resolve.py::BLK)


def make_mesh(n_devices: int | None = None, devices=None) -> list[torch.device]:
    """The mesh's devices in order: `devices` (the same device may repeat),
    else this process's device in a process group, else every CUDA card;
    the first `n_devices` of them when given."""
    if devices is None and distributed.process_count() > 1:
        devices = [distributed.local_device()]
    elif devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    # "cuda" names the current card, as a tensor's device does
    devs = [torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda" and d.index is None else d
            for d in devs]
    if n_devices is not None:
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("an empty mesh: no CUDA device (pass devices=[...] for the CPU)")
    return devs


def _on(device):
    """The context a shard's work runs in: its card current, else nothing."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def shard_sim(cmap, batch: int, mesh):
    """Fresh batched state with the env axis of a global batch of `batch`
    split over the mesh of every process (shards of a multiple of
    LANE_BLOCK envs where there are several). Returns (cmaps, states,
    step_fn): the map on each local entry's device (one copy per distinct
    device), each local entry's [batch / (process_count() * len(mesh))]
    state, and step_fn(states, actions) -> states, one tick of every local
    shard for this process's [batch / process_count()] action batch."""
    procs = distributed.process_count()
    n = procs * len(mesh)
    where = f"a mesh of {len(mesh)} entries" + (f" in each of {procs} processes" if procs > 1 else "")
    if batch % n:
        raise ValueError(f"batch {batch} must divide {where}")
    if n > 1 and (batch // n) % LANE_BLOCK:
        raise ValueError(f"a shard of {batch // n} envs: {where} takes shards of a multiple of "
                         f"{LANE_BLOCK} envs, since the capsule kernel's candidate set is per {LANE_BLOCK}-lane "
                         "block (fault f, ROADMAP §3) and a shard boundary inside a block changes results")
    per_device = {}
    for dev in mesh:
        if dev not in per_device:
            per_device[dev] = cmap if cmap.device == dev else tree_map(lambda x: x.to(dev), cmap)
    cmaps = [per_device[dev] for dev in mesh]
    states = []
    for cm, dev in zip(cmaps, mesh):
        with _on(dev):
            states.append(reset_batch(cm, batch // n))

    def step_fn(sts, actions):
        return rollout_shards(cmaps, sts, [_repeat(a, 1) for a in split(actions, mesh)])

    return cmaps, states, step_fn


def split(tree, mesh, axis: int = 0) -> list:
    """`tree`'s env axis (`axis`) cut into the mesh's equal contiguous
    shards, each on its entry's device."""
    n = tree_leaves(tree)[0][1].shape[axis] // len(mesh)
    return [tree_map(lambda x: x.narrow(axis, i * n, n).to(d), tree) for i, d in enumerate(mesh)]


def _repeat(actions: Actions, n_ticks: int) -> Actions:
    """A [B] action batch as an [n_ticks, B] stream, the same every tick."""
    return tree_map(lambda x: x.expand(n_ticks, *x.shape), actions)


def rollout_shards(cmaps, states, streams) -> list:
    """Roll every shard through its stream; every shard is launched before
    anything is read back (nothing here waits for a card)."""
    out = []
    for cm, st, acts in zip(cmaps, states, streams):
        with _on(cm.device):
            out.append(rollout(cm, st, acts))
    return out


def gather_states(states, device=None):
    """The shards' states concatenated along the env axis on `device` (the
    first shard's by default)."""
    device = device or states[0].tick.device
    return tree_map(lambda *xs: torch.cat([x.to(device) for x in xs]), states[0], *states[1:])


def sharded_rollout(cmap, mesh, batch: int, n_ticks: int, actions: Actions | None = None):
    """n_ticks of a fresh sharded global batch of `batch` envs, each env
    repeating its entry of this process's [batch / process_count()]
    `actions` (zeros by default) every tick. Returns (this process's final
    state on the first entry's device, metrics reduced over the global
    batch)."""
    cmaps, states, _ = shard_sim(cmap, batch, mesh)
    if actions is None:
        actions = Actions.zeros((len(distributed.env_range(batch)),), device=mesh[0])
    final = gather_states(rollout_shards(cmaps, states, [_repeat(a, n_ticks) for a in split(actions, mesh)]))
    pos, coins = final.player.pos, final.save.coins
    if distributed.process_count() > 1:
        # the global columns on this process's device, reduced by the same
        # ops on the same shapes as in one process: the same bits
        pos, coins = (distributed.process_allgather(x).to(x.device) for x in (pos, coins))
    metrics = {
        "mean_player_y": pos[:, 1].mean(),
        "mean_coins": coins.float().mean(),
        "ticks": final.tick[0],
    }
    return final, metrics
