"""arena_bodies' batch-global body gate across mesh shards on the CPU.

The tick's body gate opens when a body of any env of the batch is awake.
Here envs 0-127 start with the bodies awake (reset: they settle) and envs
128-255 with every body asleep, so on the unsharded batch the gate opens
for all 256 envs while the second of two 128-env shards keeps it closed.
The sharded run must still equal the unsharded one bit for bit: the
rigid-body step leaves an env whose bodies all sleep untouched.
"""

from __future__ import annotations

import torch

from c_game_engine_tpu_torch.core.actions import Actions
from c_game_engine_tpu_torch.models.graph_check import same_leaves
from c_game_engine_tpu_torch.models.sim import load_named_map, rollout
from c_game_engine_tpu_torch.parallel.mesh import gather_states, make_mesh, rollout_shards, split
from c_game_engine_tpu_torch.utils import counters
from tests.torch_mesh_inputs import half_asleep

B, TICKS = 256, 4


def test_shards_equal_the_unsharded_run_with_the_body_gate_split():
    cmap = load_named_map("arena_bodies", "cpu")
    state = half_asleep(cmap, B)
    acts = Actions.zeros((TICKS, B), device="cpu")
    counters.reset()
    whole = rollout(cmap, state, acts)
    opened_whole = counters.read("body_gate")
    mesh = make_mesh(devices=["cpu", "cpu"])
    shards, streams = split(state, mesh), split(acts, mesh, axis=1)
    opened = []
    for st, a in zip(shards, streams):
        counters.reset()
        rollout_shards([cmap], [st], [a])
        opened.append(counters.read("body_gate"))
    assert opened_whole == TICKS and opened == [TICKS, 0]
    same_leaves("arena_bodies over 2 shards", whole, gather_states(rollout_shards([cmap] * 2, shards, streams)))
    # the front envs' bodies moved, the sleeping ones did not
    rows = cmap.dyn_slots[cmap.dyn_slots >= 0].long()
    moved = (whole.actors.pos[:, rows] != state.actors.pos[:, rows]).any(-1).any(-1)
    assert bool(moved[: B // 2].all()) and not bool(moved[B // 2:].any())
