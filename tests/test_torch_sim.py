"""The port's entry points around the tick against the JAX package on the
CPU: rollout_collect, the single-env step, make_sim, the checkpoint, the
long run's resume proof, and the capture safety of a tick (what a CUDA
graph capture of it would refuse).

All on the arena map at B=128 (one 128-lane block, stream 0 of
tests/torch_parity.py: walk through a coin and the trigger, interact,
fire, item-next) over at most 16 ticks. Bars of tests/test_tpu_parity.py:
player position 2e-3, every other float 5e-3, integers and bools exact.
The CUDA graph itself is held to the eager loop on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torch_parity import (
    HostTraffic,
    assert_leaves_match,
    export_and_load,
    jax_actions,
    jax_leaves,
    stream_batch,
    torch_actions,
    torch_leaves,
)

B, TICKS = 128, 16
MAPS = Path(__file__).resolve().parents[1] / "c_game_engine_tpu_torch" / "maps"


@pytest.fixture(scope="module")
def arena(tmp_path_factory):
    from tests.torch_export_map import compile_arena

    jc = compile_arena()
    return jc, export_and_load(jc, tmp_path_factory.mktemp("arena"))


def streams():
    """Stream 0 for every env, its first TICKS ticks."""
    return [a[:TICKS] for a in stream_batch(30, B, seed=0)]


def test_rollout_collect_matches_jax(arena):
    import jax

    from c_game_engine_tpu.models.sim import reset_batch as j_reset
    from c_game_engine_tpu.models.sim import rollout_collect as j_collect
    from c_game_engine_tpu_torch.models.sim import reset_batch, rollout_collect

    jc, tc = arena
    js, jpos = jax.jit(lambda s, a: j_collect(jc, s, a, lambda st: st.player.pos))(
        j_reset(jc, B), jax_actions(*streams()))
    ts, tpos = rollout_collect(tc, reset_batch(tc, B), torch_actions(*streams()), lambda st: st.player.pos)
    assert tpos.shape == (TICKS, B, 3) and tpos.dtype == torch.float32
    np.testing.assert_allclose(tpos.numpy(), np.asarray(jpos), atol=2e-3, rtol=0)
    assert_leaves_match(jax_leaves(js), torch_leaves(ts), {"player.pos": 2e-3})
    assert int(ts.save.coins[0]) >= 1  # the stream reached the coin
    np.testing.assert_array_equal(tpos[-1].numpy(), ts.player.pos.numpy())  # row t is the state after tick t


def test_single_env_step_matches_jax(arena):
    import jax

    from c_game_engine_tpu.core.state import reset as j_reset_one
    from c_game_engine_tpu.core.step import step as j_step
    from c_game_engine_tpu_torch.core.state import reset
    from c_game_engine_tpu_torch.core.step import step

    jc, tc = arena
    move, look, btn = (a[:, 0] for a in streams())  # [T, ...] of env 0
    f = jax.jit(lambda s, a: j_step(jc, s, a))
    js, ts = j_reset_one(jc), reset(tc)
    for t in range(4):
        js = f(js, jax_actions(move[t], look[t], btn[t]))
        ts = step(tc, ts, torch_actions(move[t], look[t], btn[t]))
    assert ts.player.pos.shape == (3,) and int(ts.tick) == 4
    assert_leaves_match(jax_leaves(js), torch_leaves(ts), {"player.pos": 2e-3})


def test_make_sim_eager_on_cpu_and_graph_refused(arena):
    from c_game_engine_tpu_torch.models.sim import bench_actions, make_sim, rollout_eager

    sim = make_sim("arena", B, jit=False, device="cpu")
    assert sim.name == "arena" and sim.batch == B
    state = sim.reset()
    acts = bench_actions(2, B, "cpu")
    a = sim.rollout(state, acts)
    b = sim.step(sim.step(state, acts[0]), acts[1])
    c = rollout_eager(sim.cmap, state, acts)
    assert int(a.tick[0]) == 2
    for x, y, z in zip(torch_leaves(a).values(), torch_leaves(b).values(), torch_leaves(c).values()):
        assert x.tobytes() == y.tobytes() == z.tobytes()
    with pytest.raises(ValueError, match="CUDA graph"):
        make_sim("arena", B, jit=True, device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        from c_game_engine_tpu_torch.models.graph import TickGraph

        TickGraph(sim.cmap, state)


def test_checkpoint_round_trip_is_bitwise(arena, tmp_path):
    from c_game_engine_tpu_torch.core.state import tree_leaves
    from c_game_engine_tpu_torch.models.sim import bench_actions, reset_batch, rollout
    from c_game_engine_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    _, tc = arena
    state = rollout(tc, reset_batch(tc, B), bench_actions(2, B, "cpu"))
    save_checkpoint(tmp_path / "ck.npz", state)
    back = load_checkpoint(tmp_path / "ck.npz", reset_batch(tc, B))
    pairs = list(zip(tree_leaves(state), tree_leaves(back)))
    assert len(pairs) > 60
    for (name, a), (name_b, b) in pairs:
        assert name == name_b and a.dtype == b.dtype and torch.equal(a, b), name
    with np.load(tmp_path / "ck.npz", allow_pickle=False) as z:  # plain arrays, no pickled objects
        assert sorted(z.files) == sorted(n for (n, _), _ in pairs)
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(tmp_path / "ck.npz", reset_batch(tc, 2 * B))
    # a leaf stored wider than the state holds it is refused, not narrowed
    for wide in (state.replace(tick=state.tick.long()),
                 state.replace(player=state.player.replace(pos=state.player.pos.double()))):
        save_checkpoint(tmp_path / "wide.npz", wide)
        with pytest.raises(ValueError, match="dtype"):
            load_checkpoint(tmp_path / "wide.npz", reset_batch(tc, B))


def test_long_run_resume_proof_on_cpu(tmp_path, monkeypatch):
    from c_game_engine_tpu_torch import long_run

    lines = []
    out = long_run.run("arena", 4, 2, B, "cpu", tmp_path, log=lines.append)
    assert out["leaves"] > 60 and int(out["final_state"].tick[0]) == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ck_00000002.npz", "ck_00000004.npz"]
    assert "BITWISE equal" in lines[-2]
    # the proof is not vacuous: a restore one ulp off in one leaf fails it
    load = long_run.load_checkpoint_shard

    def nudged(path, like):
        st = load(path, like)
        return st.replace(player=st.player.replace(yaw=torch.nextafter(st.player.yaw, torch.tensor(9.0))))

    monkeypatch.setattr(long_run, "load_checkpoint_shard", nudged)
    with pytest.raises(AssertionError, match="player.yaw"):
        long_run.run("arena", 4, 2, B, "cpu", tmp_path / "again", log=lines.append)


# the plain kernel versions read their list lengths on the host; the card
# path never calls them
PLAIN = {"_resolve_plain", "_ray_tris_plain", "_contacts_plain"}


@pytest.mark.parametrize("name, gate_reads", [("arena", 3), ("arena_bodies", 5)])
def test_tick_is_capture_safe(name, gate_reads):
    """The second tick on a committed map builds no tensor from host values
    and reads the device only in the gate helper (core/gates.py): the stick
    gate and the two audio gates, and on arena_bodies the body and pair
    gates. Also with both sides of every gate run (gates.warm_up, as before
    a capture)."""
    from c_game_engine_tpu_torch.core import gates
    from c_game_engine_tpu_torch.core.state import load_map
    from c_game_engine_tpu_torch.core.step import step_batch
    from c_game_engine_tpu_torch.models.sim import bench_actions, reset_batch

    cmap = load_map(MAPS / f"{name}.npz", MAPS / f"{name}.json", "cpu")
    acts = bench_actions(2, B, "cpu")
    with gates.warm_up():
        state = step_batch(cmap, reset_batch(cmap, B), acts[0])
    for forced in (False, True):
        before = gates.host_reads
        with HostTraffic(PLAIN) as mode:
            if forced:
                with gates.warm_up():
                    step_batch(cmap, state, acts[1])
            else:
                step_batch(cmap, state, acts[1])
        seen = mode.seen
        assert seen["lift_fresh"] == [] and seen["data_dependent"] == [], seen
        assert gates.host_reads - before == gate_reads
        assert len(seen["_local_scalar_dense"]) == gate_reads, seen
        assert all("core/gates.py" in site for site in seen["_local_scalar_dense"]), seen
