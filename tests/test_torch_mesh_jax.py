"""The port's sharded_rollout against the JAX package's on its 8 fake CPU
devices (tests/conftest.py), arena, 256 envs of long_run.walk_and_turn's
per-env actions for 8 ticks (the coin 1 m ahead of the spawn is picked
up on the way): the metrics within tests/test_tpu_parity.py's bars
(mean player y 2e-3; coins and ticks exact). The port's mesh is two CPU
entries of 128 envs."""

from __future__ import annotations

import jax
import numpy as np

from c_game_engine_tpu.parallel import mesh as j_mesh
from c_game_engine_tpu_torch.long_run import walk_and_turn
from c_game_engine_tpu_torch.models.sim import load_named_map
from c_game_engine_tpu_torch.parallel import mesh
from tests.torch_parity import jax_actions

B, TICKS = 256, 8


def test_sharded_rollout_metrics_match_jax():
    from tests.torch_export_map import compile_arena

    acts = walk_and_turn(1, B, "cpu")[0]
    final, metrics = mesh.sharded_rollout(load_named_map("arena", "cpu"), mesh.make_mesh(devices=["cpu"] * 2), B,
                                          TICKS, acts)
    jm = j_mesh.make_mesh()
    assert jm.devices.size == 8
    j_acts = jax_actions(acts.move.numpy(), acts.look.numpy(), acts.buttons.numpy())
    j_final, j_metrics = j_mesh.sharded_rollout(compile_arena(), jm, B, TICKS, j_acts)
    assert final.tick.shape == (B,) and int(metrics["ticks"]) == int(j_metrics["ticks"]) == TICKS
    np.testing.assert_allclose(float(metrics["mean_player_y"]), float(j_metrics["mean_player_y"]), atol=2e-3, rtol=0)
    assert float(metrics["mean_coins"]) == float(j_metrics["mean_coins"]) > 0
    np.testing.assert_array_equal(final.save.coins.numpy(), np.asarray(jax.device_get(j_final.save.coins)))
    assert float(metrics["mean_player_y"]) == float(final.player.pos[:, 1].mean())
