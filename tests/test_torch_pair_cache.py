"""The pair warm cache keyed on each env's own pair activity (the port's
departure from the JAX package, ROADMAP §3 i), measured on the CPU.

The JAX package re-keys every env's pair warm cache when any env of the
batch has pair activity (c_game_engine_tpu/physics/batched.py:1752-1753);
the port keys it on the env's own activity (physics/bodies.py,
`pair_env`), so that a mesh shard steps as the whole batch does. The two
differ only when a pair with a stored impulse leaves an env's candidates
and comes back while that env has no live pair, and some other env of
the batch keeps the gate open. This batch builds exactly that, in a box
room with a 2-box stack (tests/worldgen.py through
tests/torch_export_map.py::make_stub_map):

  env A  the stack at rest with a warm pair cache (10 ticks of the JAX
         step from rest), its top box thrown up at 3 m/s: it leaves the
         bottom box's candidates, flies about 37 ticks and lands on it;
  env B  the stack dropped from its compiled poses: it bounces and
         settles, its pair gate open on every tick of env A's flight.

Both packages roll the batch through the rigid-body step
(`step_bodies_batched`, the JAX XLA path) from their own states for
TICKS ticks. Every tick, every leaf of env B and the poses and
velocities of env A meet the bars of tests/test_tpu_parity.py (actor
position and quaternion 5e-3, velocities 5e-3), sleep counters exact;
env A's pair keys differ while it flies (the JAX re-key drops the stack's
entry, the port keeps it) and the test checks that they do. The largest
differences are printed (ROADMAP §3 i records them).
"""

from __future__ import annotations

import numpy as np
import pytest

from tests.torch_parity import export_and_load

DT = 1.0 / 60.0
TICKS = 70
WARM_TICKS = 10
THROW = 3.0  # m/s, env A's top box
BAR = 5e-3
NAMES = ("pos", "quat", "vel", "omega", "sleep", "warm_n", "warm_pair", "warm_pair_idx")


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """(jax map, port map, [bottom row, top row])."""
    from tests.torch_export_map import make_stub_map
    from tests.worldgen import actor

    jc = make_stub_map([actor("prop_physbox", (1.0, -0.7, 1.0)), actor("prop_physbox", (1.0, -0.25, 1.0))],
                       spawn=(-3.0, 0.0, -4.0))
    rows = [i for i, c in enumerate(jc.aux["actor_classes"]) if c == "PHYSBOX"]
    return jc, export_and_load(jc, tmp_path_factory.mktemp("stack")), rows


def _np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def test_pair_cache_departure_keeps_poses_at_the_bars(stack):
    import jax

    import c_game_engine_tpu.physics.batched as jb
    from c_game_engine_tpu.models.sim import reset_batch as j_reset
    from c_game_engine_tpu_torch.core.state import state_from_numpy
    from c_game_engine_tpu_torch.physics import bodies

    jc, tc, (s0, s1) = stack
    f = jax.jit(lambda a, pp, pv: jb.step_bodies_batched(jc, a, pp, pv, DT))

    def jax_step(st):
        return [np.asarray(x) for x in f(st.actors, st.player.pos, st.player.vel)]

    def port_step(st):
        ts = state_from_numpy(st, tc)
        return [x.numpy() for x in bodies.step_bodies_batched(tc, ts.actors, ts.player.pos, ts.player.vel, DT)]

    def with_leaves(st, L):
        return st.replace(actors=st.actors.replace(**dict(zip(NAMES, L))))

    st = _np(j_reset(jc, 2))
    a = st.actors
    # env A: the stack at rest, then a warm cache from WARM_TICKS JAX ticks
    pos = np.array(a.pos)
    pos[0, s0], pos[0, s1] = (1.0, -0.802, 1.0), (1.0, -0.407, 1.0)
    st = st.replace(actors=a.replace(pos=pos))
    for _ in range(WARM_TICKS):
        st = with_leaves(st, [np.concatenate([x[:1], y[1:]]) for x, y in zip(jax_step(st), (
            getattr(st.actors, k) for k in NAMES))])
    keys0 = st.actors.warm_pair_idx[0]
    assert (keys0 >= 0).any() and (st.actors.warm_pair[0][keys0 >= 0] != 0).any(), "env A has no stored impulse"
    vel = np.array(st.actors.vel)
    vel[0, s1] = (0.0, THROW, 0.0)
    st = st.replace(actors=st.actors.replace(vel=vel))

    js, ps = st, st
    worst = {k: 0.0 for k in NAMES}
    dropped = kept = 0
    gap_ticks = []
    for t in range(TICKS):
        J, P = jax_step(js), port_step(ps)
        for k, j, p in zip(NAMES, J, P):
            assert j.dtype == p.dtype and j.shape == p.shape, k
            if k in ("sleep",):
                np.testing.assert_array_equal(p, j, err_msg=f"tick {t} {k}")
            elif k == "warm_pair_idx":
                np.testing.assert_array_equal(p[1], j[1], err_msg=f"tick {t} env B {k}")
            else:
                lanes = slice(None) if k in NAMES[:4] else slice(1, 2)
                d = float(np.abs(p[lanes] - j[lanes]).max())
                assert d <= BAR, f"tick {t} {k}: {d}"
            worst[k] = max(worst[k], float(np.abs(p.astype(np.float64) - j).max()) if k != "warm_pair_idx"
                           else float((p != j).sum()))
        # env A in flight: the JAX package drops its stored keys, the port keeps them
        if (J[7][0] != P[7][0]).any():
            dropped += int(((J[7][0] < 0) & (P[7][0] >= 0)).any())
            kept += int(np.isin(keys0[keys0 >= 0], P[7][0]).all())
            gap_ticks.append(t)
        js, ps = with_leaves(js, J), with_leaves(ps, P)
    height = js.actors.pos[0, s1, 1] - js.actors.pos[0, s0, 1]
    print(f"pair cache departure over {TICKS} ticks: env A's keys differ on {len(gap_ticks)} ticks "
          f"({gap_ticks[:1]}..{gap_ticks[-1:]}), largest |port - JAX| by leaf {worst}, "
          f"final stack height {height:.4f}")
    # the departure was exercised: env A's entry dropped by the JAX re-key
    # and kept by the port while env B's gate was open, then the box landed
    assert dropped > 0 and kept == dropped
    assert abs(height - 0.395) < 0.02
