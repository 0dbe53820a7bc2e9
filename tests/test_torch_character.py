"""The port's single-env character controller (physics/character.py) and
the grid-candidate batched resolve (physics/batched.py::
resolve_capsule_batched), held to the JAX functions on the CPU.

update_character runs 60 ticks of the bench stream (hold W at 6 m/s,
turn 0.01 rad a tick, gravity while airborne) on arena (from 3 m before
the closed door into its box, and from the spawn up the stair run) and on
tests/worldgen.py::box_room (into a wall, then sliding along it). Bars
(ROADMAP, tests/test_tpu_parity.py): position 2e-3, on_ground exact,
held two ways: each package carries its own state over the 60 ticks, and
each tick of the port is held to one jitted JAX step from the port's own
inputs. Sliding into the box room's wall meets a tick (41) on which the
jitted JAX function and the same function run op by op (jax.disable_jit,
no FMA contraction) take different branches of the step-up test; the
port equals the op-by-op run there (to the last bit over all 60 ticks,
measured), so on such a tick it is held to that run and the two JAX runs
must differ, and the free-running comparison stops before it.
resolve_capsule_batched: 256 lanes in arena's features, pos and vel within
1e-5, grounded exact.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from tests.torch_export_map import SPAWN
from tests.torch_parity import export_and_load

TICKS = 60
DT = 1.0 / 60.0
MOVE_SPEED, GRAVITY = 6.0, -9.81  # core/step.py of both packages


@pytest.fixture(scope="module")
def maps(tmp_path_factory):
    from c_game_engine_tpu.core.state import reset as j_reset
    from c_game_engine_tpu_torch.core.state import reset as t_reset
    from tests.torch_export_map import compile_arena
    from tests.worldgen import make_map

    out = {}
    for name, jc in (("arena", compile_arena()), ("box_room", make_map([]))):
        tc = export_and_load(jc, tmp_path_factory.mktemp(name))
        out[name] = (jc, tc, j_reset(jc), t_reset(tc))
    return out


def _bench_vel(t, yaw0, vy, grounded):
    """The bench stream's velocity on tick t from the last tick's state."""
    yaw = yaw0 + 0.01 * (t + 1)
    vy = 0.0 if grounded else vy + GRAVITY * DT
    return np.array([-math.sin(yaw) * MOVE_SPEED, vy, -math.cos(yaw) * MOVE_SPEED], np.float32)


def _walk(step, pos, yaw0):
    """Drive `step(pos, vel, was_on_ground) -> (pos, vel, on_ground)` for
    TICKS ticks of the bench stream from pos [3]; returns the positions
    [TICKS, 3], on_ground [TICKS] and each tick's inputs."""
    pos, vy, grounded = np.asarray(pos, np.float32), 0.0, False
    out_p, out_g, inputs = [], [], []
    for t in range(TICKS):
        vel = _bench_vel(t, yaw0, vy, grounded)
        inputs.append((pos, vel, grounded))
        pos, vel, grounded = step(pos, vel, grounded)
        vy = float(vel[1])
        out_p.append(pos)
        out_g.append(grounded)
    return np.stack(out_p), np.array(out_g), inputs


def _agree(a, b):
    """Two step results (pos, vel, on_ground) within the bars."""
    return a[2] == b[2] and np.abs(a[0] - b[0]).max() <= 2e-3


# map, start position, start yaw: from 3 m before the closed door into
# its box, from the spawn up the stair run, into a wall
WALKS = [
    ("arena", (SPAWN[0], SPAWN[1], SPAWN[2] - 3.0), 0.0),
    ("arena", SPAWN, -math.pi / 2),
    ("box_room", (0.0, -0.55, -4.0), 0.0),
]


@pytest.mark.parametrize("name,start,yaw0", WALKS, ids=["arena_door", "arena_stairs", "box_room_wall"])
def test_update_character_matches_jax(maps, name, start, yaw0):
    import jax
    import jax.numpy as jnp

    from c_game_engine_tpu.physics import character as jch
    from c_game_engine_tpu_torch.physics.character import update_character

    jc, tc, js, ts = maps[name]
    j_upd = jax.jit(lambda pos, vel, og: jch.update_character(jc, js.actors, pos, vel, DT, og, False, False))

    def j_step(pos, vel, og):
        p, v, g, _ = j_upd(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(og))
        return np.asarray(p), np.asarray(v), bool(g)

    def op_by_op_step(pos, vel, og):
        with jax.disable_jit():
            p, v, g, _ = jch.update_character(jc, js.actors, jnp.asarray(pos), jnp.asarray(vel), DT, og, False, False)
        return np.asarray(p), np.asarray(v), bool(g)

    def t_step(pos, vel, og):
        p, v, g, n = update_character(tc, ts.actors, torch.as_tensor(pos), torch.as_tensor(vel), DT, og, False, False)
        assert p.shape == (3,) and g.shape == () and n.shape == (3,)
        return p.numpy(), v.numpy(), bool(g)

    pt, gt, inputs = _walk(t_step, start, yaw0)
    pj, gj, _ = _walk(j_step, start, yaw0)
    # one jitted JAX step from each tick's port inputs
    split = []
    for t, args in enumerate(inputs):
        mine = (pt[t], None, bool(gt[t]))
        if not _agree(mine, j_step(*args)):
            op = op_by_op_step(*args)
            assert _agree(mine, op), t  # the port is the JAX function's arithmetic ...
            assert not _agree(j_step(*args), op), t  # ... where its jitted form takes another branch
            split.append(t)
    assert len(split) <= 2 * TICKS // 10
    # the two packages' own trajectories, up to the first such tick
    end = min(split, default=TICKS)
    np.testing.assert_array_equal(gt[:end], gj[:end])
    np.testing.assert_allclose(pt[:end], pj[:end], atol=2e-3, rtol=0)
    assert end == TICKS or name == "box_room"
    step = np.linalg.norm(np.diff(pt[:, [0, 2]], axis=0), axis=-1)
    if yaw0 != 0.0:
        assert pt[-1, 1] > start[1] + 0.4  # climbed the stair run (step-up)
    else:
        assert step.min() < 0.09  # held back by the door's box or the wall


def test_update_character_noclip_and_stick(maps):
    """noclip integrates freely and reports no ground; stick-to-floor
    snaps a lane stepping off a ledge down onto the floor below (the box
    room floor, 0.2 m under the capsule's rest height), as in JAX."""
    import jax.numpy as jnp

    from c_game_engine_tpu.physics import character as jch
    from c_game_engine_tpu_torch.physics.character import update_character

    jc, tc, js, ts = maps["box_room"]
    for noclip, was, pos in ((True, True, (0.0, -0.55, 0.0)), (False, True, (0.0, -0.35, 0.0)),
                             (False, False, (0.0, -0.35, 0.0))):
        vel = np.array([1.0, 0.0, 0.5], np.float32)
        pos = np.asarray(pos, np.float32)
        want = [np.asarray(x) for x in jch.update_character(jc, js.actors, jnp.asarray(pos), jnp.asarray(vel), DT,
                                                            was, False, noclip)]
        got = [x.numpy() for x in update_character(tc, ts.actors, torch.as_tensor(pos), torch.as_tensor(vel), DT,
                                                   was, False, noclip)]
        for g, w in zip(got, want):
            if w.dtype == bool:
                assert g.dtype == bool and bool(g) == bool(w)
            else:
                np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
        if noclip:
            assert not got[2] and np.allclose(got[0], pos + vel * DT)
        elif was:
            assert got[2] and abs(got[0][1] + 0.55) < 1e-3  # stuck to the floor
        else:
            assert not got[2]


def test_resolve_capsule_batched_matches_jax(maps):
    """256 lanes around arena's spawn, door, stairs and ramp, some inside a
    wall, the floor or the door's box, with random velocities."""
    import jax
    import jax.numpy as jnp

    import c_game_engine_tpu.physics.batched as jb
    from c_game_engine_tpu.models.sim import reset_batch as j_reset
    from c_game_engine_tpu_torch.models.sim import reset_batch
    from c_game_engine_tpu_torch.physics import batched

    jc, tc, _, _ = maps["arena"]
    b = 256
    js, ts = j_reset(jc, b), reset_batch(tc, b)
    rng = np.random.default_rng(11)
    sx, _, sz = SPAWN
    anchors = np.array([[sx, 0.45, sz], [sx, 0.6, sz - 6.0], [10.5, 0.7, -2.0], [16.0, 1.2, 7.0],
                        [-8.0, 0.4, -8.0]], np.float32)
    pos = (anchors[rng.integers(0, len(anchors), b)] + rng.uniform(-0.6, 0.6, (b, 3))).astype(np.float32)
    vel = rng.uniform(-6.0, 6.0, (b, 3)).astype(np.float32)

    j_res = jax.jit(lambda p, v: jb.resolve_capsule_batched(jc, p, v, jb._solid_actor_soa(jc, js.actors, b)))
    pj, vj, gj = (np.asarray(x) for x in j_res(jnp.asarray(pos), jnp.asarray(vel)))
    pt, vt, gt = (x.numpy() for x in batched.resolve_capsule_batched(
        tc, torch.as_tensor(pos), torch.as_tensor(vel), batched._solid_actor_soa(tc, ts.actors)))
    np.testing.assert_array_equal(gt, gj)
    np.testing.assert_allclose(pt, pj, atol=1e-5, rtol=0)
    np.testing.assert_allclose(vt, vj, atol=1e-5, rtol=0)
    moved = np.linalg.norm(pt - pos, axis=-1)
    assert gt.any() and not gt.all() and (moved > 0.01).mean() > 0.2  # lanes pushed out, grounded and not


def test_grid_path_lists_candidates_per_lane(maps):
    """_grid_cells_at gives each lane its own cell's list ([L, B]) and
    _tri_comps gathers the triangle rows, as in JAX."""
    import jax.numpy as jnp

    import c_game_engine_tpu.physics.batched as jb
    from c_game_engine_tpu_torch.physics import batched

    jc, tc, _, _ = maps["arena"]
    rng = np.random.default_rng(2)
    px, pz = (rng.uniform(-30, 30, 64).astype(np.float32) for _ in range(2))
    want = np.asarray(jb._grid_cells_at(jc, jnp.asarray(px), jnp.asarray(pz)))
    got = batched._grid_cells_at(tc, torch.as_tensor(px), torch.as_tensor(pz))
    np.testing.assert_array_equal(got.numpy(), want)
    comps = batched._tri_comps(tc, got)
    for k, c in enumerate(np.asarray(x) for x in jb._tri_comps(jc, jnp.asarray(want))):
        np.testing.assert_array_equal(comps[k].numpy(), c)
    assert len({tuple(col) for col in want.T}) > 8  # lanes in different cells
