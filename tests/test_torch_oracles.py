"""tests/test_physics.py's closed-form oracles, run through the port and the
JAX package on the CPU (harness: tests/torch_oracles.py). Each test holds
the port's trajectory to the JAX test's own bar, and both packages to the
parity bars (player 2e-3, on_ground equal, actors 5e-3) on every tick.

The JAX tests compile their maps through the default resolver, which
needs the reference assets; here the same geometry compiles with the
stub resolver (a physbox is the 0.2 m box either way). Several JAX tests
share one map, so their scenarios run as envs of one batch:

    port test                                  replaces (tests/test_physics.py)
    test_room_matches_jax                      (the parity bars of every env)
    test_physbox_freefall_analytic             test_physbox_freefall_analytic
    test_physbox_rests_on_floor                test_physbox_rests_on_floor
    test_player_rests_on_floor                 test_player_rests_on_floor
    test_walk_speed                            test_walk_speed
    test_slow_walk_speed                       test_slow_walk_speed
    test_wall_blocks_player                    test_wall_blocks_player
    test_wall_blocks_player_in_both_packages   (fault o: the split at the wall)
    test_jump_apex                             test_jump_apex
    test_noclip_through_wall                   test_noclip_through_wall
    test_determinism_and_batch_consistency     test_determinism_and_vmap_consistency
    test_body_sleeping                         test_body_sleeping
    test_walk_direction_matches_camera_forward test_walk_direction_matches_camera_forward_at_rotated_yaw
    test_oracle_maps_are_the_jax_tests_geometry (chip_smoke.py's oracle maps, written without JAX)

The room batch (7 envs, 240 ticks): 0 idle (the physbox drop, the
player's rest), 1 W from tick 30 for 30 ticks, 2 W + SLOW from tick 30 for
60 ticks, 3 W from tick 0 (the wall), 4 a jump on tick 30, 5 NOCLIP on
tick 0 then W, 6 move (1, -1) throughout (the determinism stream).
"""

from __future__ import annotations

from unittest import mock

import numpy as np
import pytest
import torch

from tests.torch_export_map import make_stub_map
from tests.torch_oracles import JUMP, NOCLIP, SLOW, Pair, actions, both, cube_resolver, row_of
from tests.torch_parity import torch_actions

T_ROOM = 240
WALL_CONTACT = 80  # W from the spawn at 6 m/s reaches z = -7.8 on tick 80
IDLE, WALK, SLOW_WALK, WALL, JUMPER, GHOST, DIAG = range(7)


@pytest.fixture(scope="module")
def room(tmp_path_factory):
    from tests.worldgen import actor

    jc, tc = both(make_stub_map([actor("prop_physbox", (0, 2.0, 4))]), tmp_path_factory.mktemp("room"))
    move, look, btn = actions(T_ROOM, 7)
    move[30:60, WALK, 1] = -1.0
    move[30:90, SLOW_WALK, 1] = -1.0
    btn[30:90, SLOW_WALK, SLOW] = True
    move[:, WALL, 1] = -1.0
    btn[30, JUMPER, JUMP] = True
    btn[0, GHOST, NOCLIP] = True
    move[1:181, GHOST, 1] = -1.0
    move[:, DIAG] = (1.0, -1.0)
    pair = Pair(jc, tc, 7).run(move, look, btn)
    return pair, row_of(jc, "PHYSBOX"), (move, look, btn)


def test_room_matches_jax(room):
    """Every env but the wall's within the parity bars on all 240 ticks;
    the wall's up to the tick its capsule reaches the wall."""
    pair, _, _ = room
    pair.assert_parity([IDLE, WALK, SLOW_WALK, JUMPER, GHOST, DIAG])
    assert not pair.split([WALL]) or min(pair.split([WALL])) >= WALL_CONTACT


def test_wall_blocks_player_in_both_packages(room):
    """Pressed into the wall, the capsule meets a step-up test that float
    rounding decides (ROADMAP fault o: the jitted JAX step climbs there
    where the JAX step run op by op and the port slide sideways;
    tests/torch_wall_split.py): past that tick the two packages part, but
    both keep the JAX test's bar on every tick from the contact on."""
    pair, _, _ = room
    for side in (pair.port, pair.jax):
        z = side("player.pos")[WALL_CONTACT:, WALL, 2]
        assert (z > -8.0).all() and (z < -7.0).all(), (z.min(), z.max())
    assert pair.port("player.pos")[WALL_CONTACT, WALL, 2] < -7.79


def test_physbox_freefall_analytic(room):
    """While airborne the box tracks substepped symplectic Euler at h =
    1/120: y_n = y0 - g h^2 n(n+1)/2, within 1e-3 (first 10 ticks)."""
    pair, i, _ = room
    ys = pair.port("actors.pos")[:, IDLE, i, 1]
    h = 1.0 / 120.0
    for t in range(10):
        n_sub = 2 * (t + 1)
        expected = 2.0 - 9.81 * h * h * (n_sub * (n_sub + 1) / 2)
        assert abs(ys[t] - expected) < 1e-3, (t, ys[t], expected)


def test_physbox_rests_on_floor(room):
    pair, i, _ = room
    assert abs(pair.port("actors.pos")[119, IDLE, i, 1] - (-0.8)) < 0.03
    assert np.linalg.norm(pair.port("actors.vel")[119, IDLE, i]) < 0.05


def test_player_rests_on_floor(room):
    """Capsule total half height 0.45: the centre rests at -0.55."""
    pair, _, _ = room
    assert abs(pair.port("player.pos")[59, IDLE, 1] - (-0.55)) < 0.02
    assert pair.port("player.on_ground")[59, IDLE]


def test_walk_speed(room):
    """W at yaw 0 moves -z at 6 m/s: 3.0 m in 30 ticks."""
    pos = room[0].port("player.pos")
    assert abs((pos[59, WALK, 2] - pos[29, WALK, 2]) - (-3.0)) < 0.1


def test_slow_walk_speed(room):
    pos = room[0].port("player.pos")
    assert abs((pos[89, SLOW_WALK, 2] - pos[29, SLOW_WALK, 2]) - (-0.6)) < 0.05


def test_wall_blocks_player(room):
    """Room half extent 8, capsule radius 0.2: stops short of -8 after
    reaching the wall."""
    z = room[0].port("player.pos")[T_ROOM - 1, WALL, 2]
    assert -8.0 < z < -7.0, z


def test_jump_apex(room):
    """v^2 / 2g = 4.25^2 / 19.62 = 0.921 m, then lands again."""
    y = room[0].port("player.pos")[:, JUMPER, 1]
    y0 = y[29]
    peak = max(y0, y[30:91].max())
    assert abs((peak - y0) - 0.921) < 0.06, peak - y0
    assert abs(y[120] - y0) < 0.02


def test_noclip_through_wall(room):
    pair, _, _ = room
    assert pair.port("player.noclip")[0, GHOST]
    assert pair.port("player.pos")[180, GHOST, 2] < -9.0


def test_determinism_and_batch_consistency(room):
    """The single-env step twice from reset, bit for bit, and equal to env
    6 of the batch (same stream) bit for bit after 30 ticks."""
    from c_game_engine_tpu_torch.core.state import reset, tree_leaves
    from c_game_engine_tpu_torch.core.step import step

    pair, _, (move, look, btn) = room
    runs = []
    for _ in range(2):
        st = reset(pair.tc)
        for t in range(30):
            st = step(pair.tc, st, torch_actions(move[t, DIAG], look[t, DIAG], btn[t, DIAG]))
        runs.append(st)
    for (k, a), (_, b) in zip(tree_leaves(runs[0]), tree_leaves(runs[1])):
        assert torch.equal(a, b), k
    np.testing.assert_array_equal(runs[0].player.pos.numpy(), pair.port("player.pos")[29, DIAG])


def test_body_sleeping(tmp_path):
    """A settled body sleeps after 0.5 s below the velocity threshold
    (frozen pose) and wakes on an external impulse (tests/worldgen.py::
    build_rig, a physbox among the rig's actors; every model the cube of
    tests/torch_map_sources.py, whose bounds the laser emitter reads)."""
    import tests.worldgen as wg
    from c_game_engine_tpu_torch.physics.batched import SLEEP_AFTER

    resolver = cube_resolver(tmp_path / "assets")
    with mock.patch.object(wg, "make_map", lambda acts: make_stub_map(acts, resolver=resolver)):
        jc = wg.build_rig()
    jc, tc = both(jc, tmp_path)
    i = row_of(jc, "PHYSBOX")
    pair = Pair(jc, tc, 1).run(*actions(40 + SLEEP_AFTER + 10, 1))
    assert int(pair.port("actors.sleep")[40 + SLEEP_AFTER - 1, 0, i]) >= SLEEP_AFTER
    frozen = pair.port("actors.pos")[40 + SLEEP_AFTER - 1, 0, i]
    np.testing.assert_array_equal(pair.port("actors.pos")[-1, 0, i], frozen)
    pair.set_actor(0, i, vel=(1.0, 0.0, 0.0))
    pair.run(*actions(3, 1))
    assert int(pair.port("actors.sleep")[-1, 0, i]) < SLEEP_AFTER
    assert abs(pair.port("actors.pos")[-1, 0, i, 0] - frozen[0]) > 0.01
    pair.assert_parity()


YAWS = (0.0, np.pi / 2, np.pi * 1.5, 2.2)


def test_walk_direction_matches_camera_forward(tmp_path):
    """W moves along the camera forward and D along its right at every
    spawn yaw: envs 2k walk W and 2k + 1 strafe D at YAWS[k], 20 ticks."""
    import jax.numpy as jnp

    from c_game_engine_tpu.core.step import _forward_xyz as j_forward
    from c_game_engine_tpu_torch.core.step import _forward_xyz

    jc, tc = both(make_stub_map([]), tmp_path)
    yaw = np.repeat(np.asarray(YAWS, np.float32), 2)
    move, look, btn = actions(20, len(yaw))
    move[:, 0::2] = (0.0, -1.0)
    move[:, 1::2] = (1.0, 0.0)
    pair = Pair(jc, tc, len(yaw), yaw=yaw).run(move, look, btn)
    p0 = tc.spawn_pos.numpy()
    for k, y in enumerate(YAWS):
        fwd = np.asarray(j_forward(jnp.asarray([y], jnp.float32), jnp.zeros(1)))[0]
        port_fwd = _forward_xyz(torch.tensor([y], dtype=torch.float32), torch.zeros(1))[0].numpy()
        np.testing.assert_allclose(port_fwd, fwd, atol=1e-6)
        for env, want in ((2 * k, fwd), (2 * k + 1, np.array([np.cos(y), 0.0, -np.sin(y)]))):
            d = pair.port("player.pos")[-1, env] - p0
            d[1] = 0.0
            d /= max(np.linalg.norm(d), 1e-9)
            assert float(d @ want) > 0.99, (y, env, d, want)
    pair.assert_parity()


def test_oracle_maps_are_the_jax_tests_geometry():
    """tests/torch_oracle_maps.py (chip_smoke.py's oracle phase, no JAX)
    builds the JAX tests' geometry: worldgen's box room, _ramp_map(55)'s
    plane and spawn."""
    import tests.test_solver_oracle as oracle
    import tests.torch_oracle_maps as M
    from tests.worldgen import box_room

    np.testing.assert_array_equal(M.box_room(), box_room())
    with mock.patch.object(oracle, "make_map", lambda actors, tris, spawn: (actors, tris, spawn)):
        (john,), tris, spawn = oracle._ramp_map(M.RAMP_DEG)
    np.testing.assert_array_equal(M.ramp_tris(M.RAMP_DEG), tris)
    assert M.ramp_spawn(M.RAMP_DEG) == spawn and tuple(john.position) == M.RAMP_JOHN
    gm = M.oracle_gmaps()
    assert [a.actor_class for a in gm["flat"].actors] == ["npc_john", "prop_physbox"]

