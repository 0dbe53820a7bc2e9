"""Shared inputs for the port's parity tests (tests/test_torch_*.py): the
arena map in both packages and the scripted action streams, all made on
the host with numpy so both packages see the same numbers."""

from __future__ import annotations

import dataclasses
import math
import sys
import traceback

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

# pytest runs several workers at once; each torch process would otherwise
# start a thread per core for the port's small CPU tensors, and together
# they oversubscribe the machine many times over (no faster with more)
torch.set_num_threads(1)

NUM_BUTTONS = 10  # core/actions.py Button count in both packages
JUMP, INTERACT, ITEM_NEXT, FIRE = 0, 1, 6, 8


def export_and_load(jax_cmap, tmp_dir, device="cpu"):
    """Carry a JAX CompiledMap over to the port through the file export."""
    from c_game_engine_tpu_torch.core.state import load_map
    from tests.torch_export_map import export

    npz, js = tmp_dir / "map.npz", tmp_dir / "map.json"
    export(jax_cmap, npz, js)
    return load_map(npz, js, device)


def block_streams(ticks: int, seed: int = 0):
    """Two scripted streams, (move, look, buttons) arrays [T, ...] each.

    Stream 0 walks -z from the arena spawn through a coin into the
    trigger wired to the door and the sound player, pressing interact,
    fire and item-next on the way. Stream 1 turns to +x and climbs the
    stair run, jumping once. Seeded look jitter keeps both off exact grid
    alignments."""
    rng = np.random.default_rng(seed)
    move = np.zeros((2, ticks, 2), np.float32)
    look = np.zeros((2, ticks, 2), np.float32)
    btn = np.zeros((2, ticks, NUM_BUTTONS), bool)
    move[:, :, 1] = -1.0  # hold W
    look[:, :, 0] = rng.uniform(-2e-3, 2e-3, size=(2, ticks))
    btn[0, 5::10, INTERACT] = True
    btn[0, 8::10, FIRE] = True
    btn[0, 12, ITEM_NEXT] = True
    look[1, 0, 0] = -math.pi / 2  # face +x, toward the stairs
    btn[1, 24, JUMP] = True
    return move, look, btn


def stream_batch(ticks: int, batch: int, seed: int = 0):
    """[T, B, ...] arrays: envs of block k (128 lanes each) follow stream
    k % 2."""
    move, look, btn = block_streams(ticks, seed)
    which = (np.arange(batch) // 128) % 2
    return (move[which].transpose(1, 0, 2), look[which].transpose(1, 0, 2),
            btn[which].transpose(1, 0, 2))


def jax_actions(move, look, btn):
    import jax.numpy as jnp

    from c_game_engine_tpu.core.actions import Actions

    return Actions(move=jnp.asarray(move), look=jnp.asarray(look), buttons=jnp.asarray(btn))


def torch_actions(move, look, btn, device="cpu"):
    from c_game_engine_tpu_torch.core.actions import Actions

    return Actions(
        move=torch.as_tensor(move, device=device),
        look=torch.as_tensor(look, device=device),
        buttons=torch.as_tensor(btn, device=device),
    )


def jax_leaves(obj, prefix=""):
    """{dotted name: ndarray} of a JAX pytree dataclass."""
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            if f.name == "aux":
                continue
            out.update(jax_leaves(getattr(obj, f.name), f"{prefix}.{f.name}" if prefix else f.name))
        return out
    return {prefix: np.asarray(obj)}


def torch_leaves(obj):
    from c_game_engine_tpu_torch.core.state import tree_leaves

    return {k: v.cpu().numpy() for k, v in tree_leaves(obj)}


def assert_leaves_match(J, P, float_tol=None, default=5e-3):
    """Same leaves, shapes and dtypes; floats within float_tol[name] (else
    `default`), everything else exact."""
    float_tol = float_tol or {}
    assert set(J) == set(P)
    for k in sorted(J):
        a, b = J[k], P[k]
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, atol=float_tol.get(k, default), rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


# ops whose output size depends on the data: a CUDA graph capture cannot hold them
DATA_DEPENDENT = {"nonzero", "masked_select", "unique", "_unique2", "unique_consecutive", "masked_scatter"}


class HostTraffic(TorchDispatchMode):
    """Counts what a CUDA graph capture would refuse: tensors built from
    host values (aten.lift_fresh), host reads (aten._local_scalar_dense)
    and ops with a data-dependent output size, each with the port's source
    line that issued it, outside the functions named in `plain` (the plain
    kernel versions, which read their list lengths on the host; the card
    path never calls them)."""

    def __init__(self, plain):
        super().__init__()
        self.plain = set(plain)
        self.seen = {"lift_fresh": [], "_local_scalar_dense": [], "data_dependent": []}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        kind = "data_dependent" if name in DATA_DEPENDENT else name
        if kind in self.seen:
            frames = traceback.extract_stack(sys._getframe(1))
            if not any(f.name in self.plain for f in frames):
                self.seen[kind].append(next((f"{f.filename}:{f.lineno}" for f in reversed(frames)
                                             if "c_game_engine_tpu_torch" in f.filename), "?"))
        return func(*args, **(kwargs or {}))
