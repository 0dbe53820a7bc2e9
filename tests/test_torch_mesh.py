"""The env-sharded mesh (parallel/mesh.py) on the CPU: shards of a
multiple of 128 envs step to the unsharded result bit for bit, every
leaf; the mesh's checks (other shard sizes are refused on a mesh of
several entries); and dryrun_multichip on CPU entries (128 envs each).

The same device appears several times in a CPU mesh, as one card does in
chip_smoke.py's mesh phase. The JAX package's sharded_rollout is held to
in tests/test_torch_mesh_jax.py, arena_bodies' batch-global gates in
tests/test_torch_mesh_bodies.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from c_game_engine_tpu_torch.models.graph_check import same_leaves
from c_game_engine_tpu_torch.models.sim import load_named_map, reset_batch, rollout
from c_game_engine_tpu_torch.parallel.mesh import gather_states, make_mesh, rollout_shards, shard_sim, split
from tests.torch_mesh_inputs import per_env_stream

TICKS = 10


def sharded_equals_unsharded(name, shards, batch, ticks, seed):
    """Roll `batch` envs of a per-env stream whole and as `shards` shards;
    raise unless the final states are equal bit for bit."""
    cmap = load_named_map(name, "cpu")
    acts = per_env_stream(ticks, batch, seed)
    whole = rollout(cmap, reset_batch(cmap, batch), acts)
    mesh = make_mesh(devices=["cpu"] * shards)
    cmaps, states, _ = shard_sim(cmap, batch, mesh)
    assert all(cm is cmap for cm in cmaps) and [s.tick.shape[0] for s in states] == [batch // shards] * shards
    parts = gather_states(rollout_shards(cmaps, states, split(acts, mesh, axis=1)))
    same_leaves(f"{name} over {shards} shards", whole, parts)
    return whole


@pytest.mark.parametrize("shards, batch", [(2, 256), (4, 512)])
def test_shards_equal_the_unsharded_run(shards, batch):
    whole = sharded_equals_unsharded("arena", shards, batch, TICKS, seed=shards)
    # the envs went different ways
    assert int(whole.tick[0]) == TICKS and whole.player.pos.std(0).min() > 0.01


def test_mesh_checks():
    assert make_mesh(devices=["cpu", "cpu", "cpu"], n_devices=2) == [torch.device("cpu")] * 2
    cmap = load_named_map("arena", "cpu")
    with pytest.raises(ValueError, match="divide"):
        shard_sim(cmap, 100, make_mesh(devices=["cpu"] * 3))
    with pytest.raises(ValueError, match="empty mesh"):
        make_mesh(devices=[])
    _, states, step_fn = shard_sim(cmap, 256, make_mesh(devices=["cpu"] * 2))
    from c_game_engine_tpu_torch.core.actions import Actions

    out = step_fn(states, Actions.zeros((256,), device="cpu"))
    assert [int(s.tick.sum()) for s in out] == [128, 128]


@pytest.mark.parametrize("shards, batch", [(2, 128), (4, 256), (3, 384 + 3)])
def test_shards_off_the_lane_block_are_refused(shards, batch):
    """A mesh of several entries whose shards are not whole 128-lane blocks
    of the capsule kernel (64 envs; 129) is refused, naming fault f; one
    entry takes any batch."""
    cmap = load_named_map("arena", "cpu")
    with pytest.raises(ValueError, match="fault f"):
        shard_sim(cmap, batch, make_mesh(devices=["cpu"] * shards))
    _, states, _ = shard_sim(cmap, 64, make_mesh(devices=["cpu"]))
    assert states[0].tick.shape == (64,)


def test_dryrun_multichip_on_cpu(capsys):
    from c_game_engine_tpu_torch.entry import dryrun_multichip

    metric = dryrun_multichip(2, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == f"dryrun_multichip(2): ok, metric={metric:.4f}" and np.isfinite(metric)


def test_long_run_over_two_cpu_entries(tmp_path):
    """long_run's checkpoints and bitwise resume proof on the CPU; its
    segments rolled over two CPU shards end in the same state."""
    from c_game_engine_tpu_torch import long_run

    lines = []
    one = long_run.run("arena", 4, 2, 256, "cpu", tmp_path, log=lines.append)
    assert lines[0] == "mesh: 1 device(s) (cpu)" and "BITWISE equal" in lines[-2] and one["devices"] == 1
    mesh = make_mesh(devices=["cpu", "cpu"])
    cmaps, states, _ = shard_sim(load_named_map("arena", "cpu"), 256, mesh)
    streams = split(long_run.walk_and_turn(2, 256, "cpu"), mesh, axis=1)
    for _ in range(2):
        states = rollout_shards(cmaps, states, streams)
    same_leaves("long_run over 2 entries", one["final_state"], gather_states(states))
