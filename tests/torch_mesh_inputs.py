"""Inputs of the mesh tests (tests/test_torch_mesh*.py and the `cuda`
ones): a per-env action stream, and (from models/graph_check.py, which
chip_smoke.py shares) an arena_bodies batch whose body gate is open in
one half and closed in the other."""

from __future__ import annotations

import numpy as np
import torch

from c_game_engine_tpu_torch.models.graph_check import half_asleep  # noqa: F401

# one thread a test process, as tests/torch_parity.py sets: pytest runs
# several workers at once, and a thread per core in each oversubscribes
# the machine many times over
torch.set_num_threads(1)

NUM_BUTTONS = 10  # core/actions.py Button count
JUMP, INTERACT, SPRINT, FIRE = 0, 1, 3, 8


def per_env_stream(ticks, batch, seed, device="cpu"):
    """Distinct seeded actions for every (tick, env): mostly forward moves
    with strafes, look jitter, some jumps, sprints, interacts and fires."""
    from c_game_engine_tpu_torch.core.actions import Actions

    rng = np.random.default_rng(seed)
    move = rng.uniform(-1.0, 1.0, (ticks, batch, 2)).astype(np.float32)
    move[..., 1] -= 0.5
    look = rng.uniform(-0.03, 0.03, (ticks, batch, 2)).astype(np.float32)
    btn = np.zeros((ticks, batch, NUM_BUTTONS), bool)
    for b, p in ((JUMP, 0.05), (INTERACT, 0.05), (SPRINT, 0.3), (FIRE, 0.05)):
        btn[..., b] = rng.random((ticks, batch)) < p
    return Actions(*(torch.from_numpy(a).to(device) for a in (move, look, btn)))
