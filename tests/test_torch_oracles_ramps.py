"""tests/test_solver_oracle.py's friction-cone oracles on the 30-degree
ramp and the tessellated 55-degree ramp, run through the port and the JAX
package on the CPU (harness: tests/torch_oracles.py): static friction
must pin the cylinder below the cone's threshold, and the slide must cross
interior tessellation edges without jamming (the active-edge fix). Each
test holds the port's trajectory to the JAX test's own bar and both
packages to the parity bars (player 2e-3, on_ground equal, actors 5e-3)
on every tick.

    port test                                 replaces (tests/test_solver_oracle.py)
    test_friction_cone_holds_below_threshold  test_friction_cone_holds_below_threshold
    test_friction_slide_on_tessellated_ramp   test_friction_slide_on_tessellated_ramp

The maps are the JAX tests' own (`_ramp_map(30)`, `_ramp_map(55,
tess=24)`: 1,152 triangles), compiled with the stub resolver.
"""

from __future__ import annotations

import numpy as np

from tests.torch_oracles import Pair, actions, assert_slides, ramp, row_of, slide


def test_friction_cone_holds_below_threshold(tmp_path):
    """tan(30 deg) = 0.577 < mu: static friction pins the cylinder (120
    ticks to settle, then under 0.05 m of travel and 0.05 m/s)."""
    jc, tc = ramp(30.0, tmp_path)
    i = row_of(jc, "NPC_JOHN")
    pair = Pair(jc, tc, 1).run(*actions(240, 1))
    p0, p1 = pair.port("actors.pos")[119, 0, i], pair.port("actors.pos")[239, 0, i]
    assert np.linalg.norm(p1 - p0) < 0.05, (p0, p1)
    assert np.linalg.norm(pair.port("actors.vel")[239, 0, i]) < 0.05
    pair.assert_parity()


def test_friction_slide_on_tessellated_ramp(tmp_path):
    """The 55-deg slide on a 24 x 24 tessellated ramp (1,152 triangles)."""
    pair, v1, v2 = slide(*ramp(55.0, tmp_path, tess=24))
    assert_slides(v1, v2)
    pair.assert_parity()
