"""tests/test_solver_oracle.py's rigid-body oracles on tessellated ground,
run through the port and the JAX package on the CPU (harness:
tests/torch_oracles.py): a kicked slider must decelerate at about mu g
across seams, and an overhanging box must tip with the torque's sign. Each test holds the port's trajectory to the JAX test's own
bar and both packages to the parity bars (player 2e-3, on_ground equal,
actors 5e-3) on every tick.

    port test                                     replaces (tests/test_solver_oracle.py)
    test_kinetic_friction_on_tessellated_floor    test_kinetic_friction_on_tessellated_floor
    test_offcenter_support_tips_with_torque_sign  test_offcenter_support_tips_with_torque_sign

The maps are the JAX tests' own geometry (the 12 x 12 floor, the ledge),
compiled with the stub resolver.
"""

from __future__ import annotations

import numpy as np

from tests.test_solver_oracle import _tess_quad
from tests.torch_export_map import make_stub_map
from tests.torch_oracles import MU, TPS, G, Pair, actions, both, row_of


def test_kinetic_friction_on_tessellated_floor(tmp_path):
    """Kicked to 3 m/s across a 12 x 12 tessellated floor: about mu g."""
    from tests.worldgen import actor

    f, hh = -1.0, 8.0
    tris = np.array(_tess_quad((-hh, f, -hh), (-hh, f, hh), (hh, f, hh), (hh, f, -hh), 12), np.float32)
    jc, tc = both(make_stub_map([actor("npc_john", (-4.0, -0.45, 0.0))], tris=tris, spawn=(0.0, 0.0, -7.0)), tmp_path)
    i = row_of(jc, "NPC_JOHN")
    pair = Pair(jc, tc, 1).run(*actions(120, 1))
    assert np.linalg.norm(pair.port("actors.vel")[119, 0, i]) < 0.05
    pair.set_actor(0, i, vel=(3.0, 0.0, 0.0), sleep=0)
    pair.run(*actions(10, 1))
    a_meas = (3.0 - pair.port("actors.vel")[129, 0, i][0]) * TPS / 10
    assert 0.5 * MU * G < a_meas < 1.5 * MU * G, (a_meas, MU * G)
    pair.assert_parity()


def test_offcenter_support_tips_with_torque_sign(tmp_path):
    """A box whose centre of mass overhangs a ledge by 0.1 m tips: tau_z =
    -x_com m g < 0, so omega_z goes negative, and it ends off the ledge."""
    from tests.worldgen import actor

    h = 12.0
    tris = np.array(
        _tess_quad((-h, 0.0, -h), (-h, 0.0, h), (0.0, 0.0, h), (0.0, 0.0, -h), 16)
        + _tess_quad((0.0, -2.0, -h), (0.0, -2.0, h), (h, -2.0, h), (h, -2.0, -h), 16)
        + _tess_quad((0.0, -2.0, -h), (0.0, -2.0, h), (0.0, 0.0, h), (0.0, 0.0, -h), 8),
        np.float32,
    )
    jc, tc = both(make_stub_map([actor("prop_physbox", (0.1, 0.25, 0.0))], tris=tris, spawn=(-6.0, 1.0, -6.0)), tmp_path)
    i = row_of(jc, "PHYSBOX")
    pair = Pair(jc, tc, 1).run(*actions(150, 1))
    wz = pair.port("actors.omega")[:, 0, i, 2]
    assert wz.min() < -0.5, wz.min()
    assert wz.min() < -abs(wz.max()), (wz.min(), wz.max())
    p = pair.port("actors.pos")[-1, 0, i]
    assert p[1] < -1.0 and p[0] > 0.05, p
    pair.assert_parity()
