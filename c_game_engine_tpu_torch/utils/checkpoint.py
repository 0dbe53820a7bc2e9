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
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from c_game_engine_tpu_torch.core.state import tree_leaves, tree_map


def save_checkpoint(path, state) -> None:
    """Write every leaf of `state` to `path` (a .npz file), atomically."""
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
    names = iter(name for name, _ in tree_leaves(like))
    with np.load(path, allow_pickle=False) as z:
        stored = set(z.files)

        def leaf(t):
            name = next(names)
            if name not in stored:
                raise KeyError(f"checkpoint {path} has no leaf {name}")
            a = z[name]
            if a.shape != tuple(t.shape):
                raise ValueError(f"checkpoint leaf {name} has shape {a.shape}, expected {tuple(t.shape)}")
            b = torch.from_numpy(a)
            if b.dtype != t.dtype:
                raise ValueError(f"checkpoint leaf {name} has dtype {a.dtype}, expected {t.dtype}")
            return b.to(device=t.device)

        return tree_map(leaf, like)
