"""Batch-state checkpoint and resume (counterpart of
c_game_engine_tpu/utils/checkpoint.py).

A checkpoint is one `.npz` file holding every tensor leaf of the state
under its dotted name (core/state.py::tree_leaves), written with numpy and
read back with `allow_pickle=False`: no pickle, and no code runs on load.
A checkpoint of the JAX package (a pickled jax treedef, or an orbax
directory) cannot be read without jax, so the two packages do not read
each other's checkpoints; their states carry over through
core/state.py::state_from_numpy / state_to_numpy instead.

`load_checkpoint` returns new tensors on the template's device. To resume a
graphed run, hand them to models/sim.py::rollout, which copies them into
the tick graph's static buffers (the graph's buffers are never rebound).

In a process group (parallel/distributed.py) each process holds only its
envs. `save_checkpoint` then gathers the global value of every leaf
(process_allgather), process 0 alone writes the one file, and a named
barrier keeps every process from returning before the file is in place;
`load_checkpoint_shard` reads this process's envs of such a file back,
in a group of any size that divides the batch. As in the JAX package, a
file written by a group is the file one process would write of the same
global state.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from c_game_engine_tpu_torch.core.state import tree_leaves, tree_map
from c_game_engine_tpu_torch.parallel import distributed


def save_checkpoint(path, state) -> None:
    """Write every leaf of `state` to `path` (a .npz file), atomically. In
    a process group of several processes `state` is this process's envs:
    every process gathers the global state, process 0 writes it, and all
    return after the barrier `cge_ckpt_save:<path>`."""
    if distributed.process_count() > 1:
        # process 0 writes the gathered tree; every process waits at the
        # barrier, so none reads the file (a resume) before it is in place
        state = distributed.process_allgather(state, tiled=True)
        if distributed.process_index() == 0:
            _write(path, state)
        distributed.sync_global_devices(f"cge_ckpt_save:{path}")
        return
    _write(path, state)


def _write(path, state) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {name: t.detach().cpu().numpy() for name, t in tree_leaves(state)}
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_checkpoint(path, like):
    """The state saved at `path`, in the structure and on the device of
    `like` (a state of the same map and batch). A leaf that is missing or
    whose shape or dtype differs from `like`'s raises."""
    return _read(path, like, None)


def load_checkpoint_shard(path, like):
    """This process's envs (distributed.env_range) of the global state
    saved at `path`, in the structure and on the device of `like` (this
    process's state: [batch / process_count()] envs): the global leaves
    are read, and this process's rows kept. In one process, load_checkpoint.
    A leaf that is missing, whose rows are not `like`'s times the process
    count or whose dtype differs raises."""
    return _read(path, like, distributed.process_count())


def _read(path, like, procs):
    names = iter(name for name, _ in tree_leaves(like))
    with np.load(path, allow_pickle=False) as z:
        stored = set(z.files)

        def leaf(t):
            name = next(names)
            if name not in stored:
                raise KeyError(f"checkpoint {path} has no leaf {name}")
            a = z[name]
            want = tuple(t.shape) if procs is None else (t.shape[0] * procs, *t.shape[1:])
            if a.shape != want:
                raise ValueError(f"checkpoint leaf {name} has shape {a.shape}, expected {want}")
            b = torch.from_numpy(a)
            if b.dtype != t.dtype:
                raise ValueError(f"checkpoint leaf {name} has dtype {a.dtype}, expected {t.dtype}")
            if procs is not None:
                rows = distributed.env_range(a.shape[0])
                b = b[rows.start:rows.stop]
            return b.to(device=t.device)

        return tree_map(leaf, like)
