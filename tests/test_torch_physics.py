"""Module-level parity of the port's batched physics against the JAX XLA
path (physics/batched.py with _use_pallas() false, as on any CPU).

The port runs the kernel formulation (per-128-lane-block chunk lists);
the XLA path takes candidates per lane from the uniform grid. The two
agree when every env of a block follows one stream, as in bench.py, so
every block here is a single point. Bars from tests/test_tpu_parity.py:
position 2e-3, on_ground exact; rays: hit and actor index exact, hit
fraction 1e-5.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.torch_parity import export_and_load

B = 256


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import jax

    from c_game_engine_tpu.models.sim import reset_batch as j_reset
    from c_game_engine_tpu_torch.models.sim import reset_batch as t_reset
    from tests.torch_export_map import compile_arena

    jc = compile_arena()
    tc = export_and_load(jc, tmp_path_factory.mktemp("arena"))
    js, ts = j_reset(jc, B), t_reset(tc, B)

    from c_game_engine_tpu.physics.batched import update_character_batched as j_update

    j_char = jax.jit(
        lambda pos, vel, og, jump, nc: j_update(jc, js.actors, pos, vel, 1.0 / 60.0, og, jump, nc,
                                                exclude_idx=js.player.held_actor)
    )
    return jc, tc, js, ts, j_char


# (pos, vel, was_on_ground, jumping) for block 0 and block 1
SCENARIOS = {
    # into the first 0.2 m riser (step-up) / off a stair tread (stick-to-floor)
    "stairs": (((9.75, 0.45, -2.0), (6.0, 0.0, 0.0), True, False),
               ((11.85, 1.05, -2.5), (-6.0, 0.0, 0.0), True, False)),
    # into the closed door's box / falling onto the terrace
    "door_and_fall": (((8.2, 0.45, -7.75), (0.0, 0.0, -6.0), True, False),
                      ((16.0, 1.6, 0.0), (0.0, -5.0, 0.0), False, False)),
    # down the ramp / a jump off the floor
    "ramp_and_jump": (((16.0, 1.16, 7.0), (0.0, 0.0, 6.0), True, False),
                      ((0.0, 0.45, 0.0), (1.0, 4.25, 0.0), True, True)),
}


def _blocks(scn):
    rows = [scn[(i // 128) % 2] for i in range(B)]
    pos = np.array([r[0] for r in rows], np.float32)
    vel = np.array([r[1] for r in rows], np.float32)
    og = np.array([r[2] for r in rows], bool)
    jump = np.array([r[3] for r in rows], bool)
    return pos, vel, og, jump, np.zeros(B, bool)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_update_character_matches_xla_path(world, name):
    import jax.numpy as jnp

    from c_game_engine_tpu_torch.physics.batched import update_character_batched

    jc, tc, js, ts, j_char = world
    args = _blocks(SCENARIOS[name])
    pos_j, vel_j, og_j = (np.asarray(a) for a in j_char(*(jnp.asarray(a) for a in args)))
    p, v, og, jump, nc = (torch.as_tensor(a) for a in args)
    pos_t, vel_t, og_t = update_character_batched(
        tc, ts.actors, p, v, 1.0 / 60.0, og, jump, nc, exclude_idx=ts.player.held_actor
    )
    np.testing.assert_allclose(pos_t.numpy(), pos_j, atol=2e-3, rtol=0)
    np.testing.assert_allclose(vel_t.numpy(), vel_j, atol=2e-3, rtol=0)
    np.testing.assert_array_equal(og_t.numpy(), og_j)


def test_update_character_paths_are_exercised(world):
    """The scenarios above reach the step-up, stick-to-floor and box
    branches (guards the parity test against passing vacuously)."""
    from c_game_engine_tpu_torch.physics.batched import update_character_batched

    _, tc, _, ts, _ = world
    p, v, og, jump, nc = (torch.as_tensor(a) for a in _blocks(SCENARIOS["stairs"]))
    pos, vel, ground = update_character_batched(tc, ts.actors, p, v, 1.0 / 60.0, og, jump, nc)
    assert pos[0, 1] > 0.6  # stepped up onto the 0.2 m tread
    assert bool(ground[128]) and pos[128, 1] < 0.9  # stuck down onto the lower tread
    p, v, og, jump, nc = (torch.as_tensor(a) for a in _blocks(SCENARIOS["door_and_fall"]))
    pos, vel, ground = update_character_batched(tc, ts.actors, p, v, 1.0 / 60.0, og, jump, nc)
    assert pos[0, 2] > -7.76  # held off by the door box (-7.85 unblocked)
    assert abs(float(vel[0, 2])) < 1.0


def _ray_batch(tc):
    """Kind-major rays [3 * B]: interact rays (10 m), laser-like rays (50 m,
    exclude the laser, CAN_BLOCK_LASERS only) and static-only rays. Block
    0 and block 1 of each kind differ."""
    from c_game_engine_tpu_torch.actors.defs import ActorFlags

    kinds = [
        # (block-0 origin, dir), (block-1 origin, dir), max, exclude, flags, static_only
        (((8.0, 1.0, -2.0), (0.0, 0.0, -1.0)), ((9.0, 0.7, -2.0), (0.2, 1.0, 0.0)), 10.0, -1, 0, False),
        (((8.0, 1.0, -20.0), (0.0, 0.0, 1.0)), ((8.5, 1.0, -19.0), (0.05, 0.0, 1.0)), 50.0, 5,
         int(ActorFlags.CAN_BLOCK_LASERS), False),
        (((8.0, 1.0, -20.0), (0.0, 0.0, 1.0)), ((0.0, 2.0, 0.0), (0.3, -1.0, 0.2)), 50.0, 5,
         int(ActorFlags.CAN_BLOCK_LASERS), True),
    ]
    o, d, mx, ex, fl, st = [], [], [], [], [], []
    for (b0, b1, m, e, f, s) in kinds:
        for i in range(B):
            oo, dd = b0 if i < 128 else b1
            o.append(oo)
            d.append(np.asarray(dd) / np.linalg.norm(dd))
            mx.append(m), ex.append(e), fl.append(f), st.append(s)
    f32 = lambda a: np.asarray(a, np.float32)
    return (f32(o), f32(d), f32(mx), np.asarray(ex, np.int32), np.asarray(fl, np.int32),
            np.asarray(st, bool))


def test_cast_rays_matches_xla_path(world):
    import jax.numpy as jnp

    from c_game_engine_tpu.physics.batched import cast_rays_batched as j_cast
    from c_game_engine_tpu_torch.physics.batched import cast_rays_batched

    jc, tc, js, ts, _ = world
    o, d, mx, ex, fl, st = _ray_batch(tc)
    hj, fj, aj = (np.asarray(a) for a in j_cast(
        jc, js.actors, jnp.asarray(o), jnp.asarray(d), jnp.asarray(mx), exclude=jnp.asarray(ex),
        require_flags=jnp.asarray(fl), B_env=B, static_only=jnp.asarray(st), layout="kind_major"))
    t = lambda a: torch.as_tensor(a)
    ht, ft, at = (a.numpy() for a in cast_rays_batched(
        tc, ts.actors, t(o), t(d), t(mx), exclude=t(ex), require_flags=t(fl), B_env=B,
        static_only=t(st), layout="kind_major"))
    np.testing.assert_array_equal(ht, hj)
    np.testing.assert_array_equal(at, aj)
    np.testing.assert_allclose(ft, fj, atol=1e-5, rtol=0)
    assert (aj == 4).any() and (aj == -1).any() and hj.any()  # the door and the world
    assert not hj.all()  # and some misses


def test_small_batch_matches_the_pallas_path(world, monkeypatch):
    """At B=8 the port pads every kernel launch with zero lanes to 128, as
    the JAX package's TPU path does (physics/batched.py:238-247, ray
    padding in ops/ray_tris.py). Held against that path itself: JAX with
    _use_pallas() forced on and the Pallas kernels in interpret mode, so
    both sides take the same per-block candidate sets (1e-5, on_ground and
    hits exact)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    import c_game_engine_tpu.physics.batched as jb
    from c_game_engine_tpu.models.sim import reset_batch as j_reset
    from c_game_engine_tpu_torch.models.sim import reset_batch
    from c_game_engine_tpu_torch.physics.batched import cast_rays_batched, update_character_batched

    jc, tc, _, _, _ = world
    b = 8
    js, ts = j_reset(jc, b), reset_batch(tc, b)
    scn = SCENARIOS["stairs"]
    rows = [scn[i // 4] for i in range(b)]  # lanes 0-3 step up, 4-7 stick down
    args = (np.array([r[0] for r in rows], np.float32), np.array([r[1] for r in rows], np.float32),
            np.array([r[2] for r in rows]), np.array([r[3] for r in rows]), np.zeros(b, bool))
    o = np.array([[8.0, 1.0, -2.0]] * b + [[8.0, 1.0, -20.0]] * b, np.float32)
    d = np.array([[0.0, 0.0, -1.0]] * b + [[0.0, 0.0, 1.0]] * b, np.float32)
    mx = np.array([10.0] * b + [50.0] * b, np.float32)
    ex = np.array([-1] * b + [5] * b, np.int32)

    monkeypatch.setattr(jb, "_use_pallas", lambda: True)
    with pltpu.force_tpu_interpret_mode():
        pj, vj, gj = (np.asarray(a) for a in jb.update_character_batched(
            jc, js.actors, *(jnp.asarray(a) for a in args[:2]), 1.0 / 60.0,
            *(jnp.asarray(a) for a in args[2:])))
        hj, fj, aj = (np.asarray(a) for a in jb.cast_rays_batched(
            jc, js.actors, jnp.asarray(o), jnp.asarray(d), jnp.asarray(mx),
            exclude=jnp.asarray(ex), B_env=b, layout="kind_major"))
    pt, vt, gt = (a.numpy() for a in update_character_batched(
        tc, ts.actors, *(torch.as_tensor(a) for a in args[:2]), 1.0 / 60.0,
        *(torch.as_tensor(a) for a in args[2:])))
    ht, ft, at = (a.numpy() for a in cast_rays_batched(
        tc, ts.actors, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(mx),
        exclude=torch.as_tensor(ex), B_env=b, layout="kind_major"))
    np.testing.assert_allclose(pt, pj, atol=1e-5, rtol=0)
    np.testing.assert_allclose(vt, vj, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(gt, gj)
    np.testing.assert_array_equal(ht, hj)
    np.testing.assert_array_equal(at, aj)
    np.testing.assert_allclose(ft, fj, atol=1e-5, rtol=0)
    assert pt[0, 1] > 0.6 and gt[4]  # the step-up and the stick launch both ran
