"""tests/test_solver_oracle.py's closed-form rigid-body oracles on the flat
floor and the 55-degree single-quad ramp, run through the port and the JAX package
on the CPU (harness: tests/torch_oracles.py): Coulomb friction with mu =
sqrt(0.2 * 4.25) = 0.922, restitution 0. Each test holds the port's
trajectory to the JAX test's own bar and both packages to the parity bars
(player 2e-3, on_ground equal, actors 5e-3) on every tick.

    port test                                 replaces (tests/test_solver_oracle.py)
    test_kinetic_friction_stops_slider        test_kinetic_friction_stops_slider
    test_drop_lands_dead_restitution_zero     test_drop_lands_dead_restitution_zero
    test_flat_floor_matches_jax               (the parity bars of both)
    test_kick_across_the_floor_diagonal_creeps (ROADMAP fault r, in both packages)
    test_friction_cone_slides_above_threshold test_friction_cone_slides_above_threshold

The maps are the JAX tests' own (`_ramp_map(55)`, worldgen's box room),
compiled with the stub resolver. The two flat-floor tests share one map
holding both bodies at their JAX positions, which coincide (4, y, 4): env
0 runs the kick with the physbox moved to rest at (-4, -0.8, 4), env 1 the
drop with the npc moved to rest at (-4, -0.5, 4), 8 m away, env 2 a kick
at 82 degrees off +x with the physbox moved as in env 0.
"""

from __future__ import annotations

import numpy as np
import pytest

from tests.torch_export_map import make_stub_map
from tests.torch_oracles import MU, TPS, G, Pair, actions, assert_slides, both, ramp, row_of, slide

HALF = 0.2  # physbox half extent
KICK, DROP, CREEP = 0, 1, 2
CREEP_KICK = 3.0 * np.array([np.cos(1.43), 0.0, np.sin(1.43)], np.float32)  # 3 m/s, 82 degrees off +x


@pytest.fixture(scope="module")
def flat(tmp_path_factory):
    from tests.worldgen import actor

    jc, tc = both(make_stub_map([actor("npc_john", (4.0, -0.45, 4.0)), actor("prop_physbox", (4.0, 0.0, 4.0))],
                           spawn=(0.0, 0.0, -4.0)), tmp_path_factory.mktemp("flat"))
    john, box = row_of(jc, "NPC_JOHN"), row_of(jc, "PHYSBOX")
    pair = Pair(jc, tc, 3)
    for env in (KICK, CREEP):
        pair.set_actor(env, box, pos=(-4.0, -1.0 + HALF, 4.0))
    pair.set_actor(DROP, john, pos=(-4.0, -0.5, 4.0))
    pair.run(*actions(120, 3))
    settled = pair.port("actors.vel")[119, KICK, john]
    pair.set_actor(KICK, john, vel=(3.0, 0.0, 0.0), sleep=0)
    pair.set_actor(CREEP, john, vel=CREEP_KICK, sleep=0)
    pair.run(*actions(60, 3))
    return pair, john, box, settled


def test_flat_floor_matches_jax(flat):
    flat[0].assert_parity()


def test_kinetic_friction_stops_slider(flat):
    """Kicked to 3 m/s on the floor, the rot-locked cylinder decelerates
    at about mu g = 9.05 m/s^2 and is at rest 30 ticks later."""
    pair, john, _, settled = flat
    assert np.linalg.norm(settled) < 0.05
    v1 = pair.port("actors.vel")[129, KICK, john]
    a_meas = (3.0 - v1[0]) * TPS / 10
    assert 0.5 * MU * G < a_meas < 1.5 * MU * G, (a_meas, MU * G)
    assert np.linalg.norm(pair.port("actors.vel")[159, KICK, john]) < 0.15


def test_kick_across_the_floor_diagonal_creeps(flat):
    """ROADMAP fault r, a fault of the reference that the port copies: the
    same kick at 82 degrees off +x leaves the cylinder (which starts on the
    box room floor's diagonal edge x = z) creeping along that edge, above
    the oracle's 0.15 m/s 30 ticks later, in both packages alike
    (chip_smoke.py's oracle phase counts such lanes by this signature)."""
    pair, john, _, _ = flat
    for side in (pair.port, pair.jax):
        v, p = side("actors.vel")[159, CREEP, john], side("actors.pos")[159, CREEP, john]
        assert np.linalg.norm(v) >= 0.15, v
        assert abs(p[0] - p[2]) / np.sqrt(2.0) < 0.3, p
        assert abs(v[0] + v[2]) / np.sqrt(2.0) > np.cos(np.radians(10.0)) * np.linalg.norm(v[[0, 2]]), v


def test_drop_lands_dead_restitution_zero(flat):
    """A 1 m drop does not rebound: after first contact the box stays
    below rest + 0.05 and ends within 0.05 of rest (-0.8)."""
    pair, _, box, _ = flat
    ys = pair.port("actors.pos")[:, DROP, box, 1]
    rest = -1.0 + HALF
    touched = np.nonzero(ys < rest + 0.02)[0]
    assert len(touched), ys.min()
    assert ys[touched[0]:].max() < rest + 0.05, ys[touched[0]:].max()
    assert abs(ys[-1] - rest) < 0.05, ys[-1]


def test_friction_cone_slides_above_threshold(tmp_path):
    """tan(55 deg) = 1.43 > mu: the cylinder slides at a = g (sin t - mu
    cos t) = 2.85 m/s^2."""
    pair, v1, v2 = slide(*ramp(55.0, tmp_path))
    assert_slides(v1, v2)
    pair.assert_parity()
