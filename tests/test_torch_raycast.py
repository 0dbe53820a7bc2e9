"""The port's grid query, single-env raycast, batched ray layouts and laser
rays on arena, held to the JAX functions on the CPU: physics/grid.py::
query_cell, physics/raycast.py (cast_ray with each filter, forward_vector),
physics/batched.py::cast_rays_batched's two layouts, and
actors/behaviors.py::compute_laser_rays against jax.vmap of the JAX one.

Bars (tests/test_tpu_parity.py's): hits and actor ids exact, fractions
within 1e-5; grid cells exact.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.torch_export_map import SPAWN
from tests.torch_parity import export_and_load

DOOR, LASER = 4, 5  # arena's actor rows (tests/torch_export_map.py::arena_actors)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from c_game_engine_tpu.core.state import reset as j_reset
    from c_game_engine_tpu_torch.core.state import reset as t_reset
    from tests.torch_export_map import compile_arena

    jc = compile_arena()
    tc = export_and_load(jc, tmp_path_factory.mktemp("arena"))
    return jc, tc, j_reset(jc), t_reset(tc)


def test_query_cell_matches_jax(world):
    import jax
    import jax.numpy as jnp

    from c_game_engine_tpu.physics.grid import query_cell as j_query
    from c_game_engine_tpu_torch.physics.grid import query_cell

    jc, tc, _, _ = world
    rng = np.random.default_rng(3)
    lo = np.asarray(jc.grid_lo)
    gx, gz = jc.aux["grid_shape"]
    span = np.array([gx, gz]) / float(jc.grid_inv_cell)
    pos = np.stack([rng.uniform(lo[0] - 5, lo[0] + span[0] + 5, 2048), rng.uniform(-2, 4, 2048),
                    rng.uniform(lo[1] - 5, lo[1] + span[1] + 5, 2048)], -1)
    ix, iz = np.meshgrid(np.arange(gx) + 0.5, np.arange(gz) + 0.5, indexing="ij")  # every cell's centre
    centres = np.stack([lo[0] + ix.ravel() * span[0] / gx, np.zeros(gx * gz), lo[1] + iz.ravel() * span[1] / gz], -1)
    pos = np.concatenate([pos, centres]).astype(np.float32)
    want = np.asarray(jax.jit(lambda p: j_query(jc, p))(jnp.asarray(pos)))
    got = query_cell(tc, torch.as_tensor(pos)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and (got >= 0).any() and (got == -1).any()
    # every cell of the grid reached, and the clamp at both ends of both axes
    cells = np.clip(((pos[:, [0, 2]] - lo) * float(jc.grid_inv_cell)).astype(np.int64), 0, [gx - 1, gz - 1])
    assert len({tuple(c) for c in cells}) == gx * gz


def test_forward_vector_matches_jax():
    import jax.numpy as jnp

    from c_game_engine_tpu.physics.raycast import forward_vector as j_fwd
    from c_game_engine_tpu_torch.physics.raycast import forward_vector

    rng = np.random.default_rng(4)
    yaw, pitch = (rng.uniform(-4, 4, 1024).astype(np.float32) for _ in range(2))
    want = np.asarray(j_fwd(jnp.asarray(yaw), jnp.asarray(pitch)))
    got = forward_vector(torch.as_tensor(yaw), torch.as_tensor(pitch)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# (origin, direction, max_dist, exclude_actor, require_flags, static_layer_only,
# include_statics): the interact ray from the spawn, the laser's ray with its
# filter, the same as a triple laser, rays at the door, along the floor,
# into the sky, and with the statics left out
def _rays():
    from c_game_engine_tpu_torch.actors.defs import ActorFlags

    sx, sy, sz = SPAWN
    block = int(ActorFlags.CAN_BLOCK_LASERS)
    return [
        ((sx, sy + 0.5, sz), (0.0, 0.0, -1.0), 10.0, -1, 0, False, True),
        ((sx - 1.0, 1.0, -20.0), (0.0, 0.0, 1.0), 50.0, LASER, block, False, True),
        ((sx - 1.0, 1.0, -20.0), (0.0, 0.0, 1.0), 50.0, LASER, block, True, True),
        ((sx, 1.0, sz - 3.0), (0.0, 0.0, -1.0), 10.0, -1, 0, False, True),
        ((sx, 1.0, sz - 3.0), (0.0, 0.0, -1.0), 10.0, DOOR, 0, False, True),
        ((sx, 1.0, sz - 3.0), (0.0, 0.0, -1.0), 10.0, -1, 0, False, False),
        ((sx, 1.0, sz - 3.0), (0.0, 0.0, -1.0), 2.0, -1, 0, False, True),
        ((0.0, 0.3, 0.0), (0.6, -0.05, 0.8), 50.0, -1, 0, False, True),
        ((0.0, 1.0, 0.0), (0.0, 1.0, 0.0), 50.0, -1, 0, False, True),
        ((sx, 1.0, sz - 3.0), (0.1, -0.2, -1.0), 10.0, -1, block, False, False),
    ]


def test_cast_ray_matches_jax(world):
    import jax
    import jax.numpy as jnp

    from c_game_engine_tpu.physics.raycast import cast_ray as j_cast
    from c_game_engine_tpu_torch.physics.raycast import cast_ray

    jc, tc, js, ts = world
    got_any = set()
    for o, d, mx, ex, fl, so, inc in _rays():
        d = np.asarray(d, np.float32) / np.linalg.norm(d)
        o = np.asarray(o, np.float32)
        jf = jax.jit(lambda o_, d_: j_cast(jc, js.actors, o_, d_, mx, ex, fl, so, inc))
        hj, fj, aj = (np.asarray(x) for x in jf(jnp.asarray(o), jnp.asarray(d)))
        ht, ft, at = cast_ray(tc, ts.actors, torch.as_tensor(o), torch.as_tensor(d), mx, ex, fl, so, inc)
        assert ht.shape == () and ht.dtype == torch.bool and at.dtype == torch.int32 and ft.dtype == torch.float32
        assert bool(ht) == bool(hj) and int(at) == int(aj), (o, d, ex, fl, so, inc)
        np.testing.assert_allclose(float(ft), float(fj), atol=1e-5, rtol=0)
        got_any.add((bool(ht), int(at)))
    # the world, the door and a miss all occur
    assert {(True, -1), (True, DOOR), (False, -1)} <= got_any


def _layout_case(jc, tc):
    """B = 3 envs whose doors stand at different x; K = 2 rays an env,
    env-major: ray 0 at the env's own door, ray 1 where another env's door
    stands (a miss of the door in this env)."""
    from c_game_engine_tpu.models.sim import reset_batch as j_reset
    from c_game_engine_tpu_torch.models.sim import reset_batch

    b, k = 3, 2
    sx, _, sz = SPAWN
    js, ts = j_reset(jc, b), reset_batch(tc, b)
    pos = np.asarray(js.actors.pos).copy()
    for e in range(b):
        pos[e, DOOR, 0] = sx + 3.0 * e
    js = js.replace(actors=js.actors.replace(pos=pos))
    ts = ts.replace(actors=ts.actors.replace(pos=torch.as_tensor(pos)))
    o = np.array([[sx + 3.0 * x, 1.0, sz - 3.0] for e in range(b) for x in (e, (e + 1) % b)], np.float32)
    d = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (b * k, 1))
    return js, ts, o, d, b


def test_cast_rays_batched_default_layout_is_env_major(world):
    """The JAX default layout="interleaved" (env-major rays) tests each
    env's rays against that env's actors."""
    import jax.numpy as jnp

    from c_game_engine_tpu.physics.batched import cast_rays_batched as j_cast
    from c_game_engine_tpu_torch.physics.batched import cast_rays_batched

    jc, tc, _, _ = world
    js, ts, o, d, b = _layout_case(jc, tc)
    hj, fj, aj = (np.asarray(x) for x in j_cast(jc, js.actors, jnp.asarray(o), jnp.asarray(d), 10.0, B_env=b))
    ht, ft, at = (x.numpy() for x in cast_rays_batched(tc, ts.actors, torch.as_tensor(o), torch.as_tensor(d), 10.0,
                                                        B_env=b))
    np.testing.assert_array_equal(ht, hj)
    np.testing.assert_array_equal(at, aj)
    np.testing.assert_allclose(ft, fj, atol=1e-5, rtol=0)
    assert at.tolist() == [DOOR, -1] * b  # each env's own door, and no other env's


def test_cast_rays_batched_kind_major_layout(world):
    """The same rays laid out kind-major (every env's ray 0, then every
    env's ray 1), as the tick's merged launch lays them out."""
    import jax.numpy as jnp

    from c_game_engine_tpu.physics.batched import cast_rays_batched as j_cast
    from c_game_engine_tpu_torch.physics.batched import cast_rays_batched

    jc, tc, _, _ = world
    js, ts, o, d, b = _layout_case(jc, tc)
    o, d = (x.reshape(b, 2, 3).transpose(1, 0, 2).reshape(-1, 3).copy() for x in (o, d))
    hj, fj, aj = (np.asarray(x) for x in j_cast(jc, js.actors, jnp.asarray(o), jnp.asarray(d), 10.0, B_env=b,
                                                layout="kind_major"))
    ht, ft, at = (x.numpy() for x in cast_rays_batched(tc, ts.actors, torch.as_tensor(o), torch.as_tensor(d), 10.0,
                                                        B_env=b, layout="kind_major"))
    np.testing.assert_array_equal(ht, hj)
    np.testing.assert_array_equal(at, aj)
    np.testing.assert_allclose(ft, fj, atol=1e-5, rtol=0)
    assert at.tolist() == [DOOR] * b + [-1] * b


def test_compute_laser_rays_matches_vmapped_jax(world, monkeypatch):
    """3 envs with the laser moved and turned differently: through the
    door, into a wall, and out over the arena; the door moved aside in
    env 2. Held to jax.vmap of the JAX single-env function."""
    import jax
    import jax.numpy as jnp

    from c_game_engine_tpu.actors.behaviors import compute_laser_rays as j_lasers
    from c_game_engine_tpu.models.sim import reset_batch as j_reset
    from c_game_engine_tpu_torch.actors.behaviors import compute_laser_rays
    from c_game_engine_tpu_torch.models.sim import reset_batch
    from c_game_engine_tpu_torch.physics import batched

    jc, tc, _, _ = world
    b = 3
    sx, _, sz = SPAWN
    js = j_reset(jc, b)
    pos = np.asarray(js.actors.pos).copy()
    quat = np.asarray(js.actors.quat).copy()
    pos[1, LASER] = (sx - 1.0, 1.0, -14.0)
    quat[1, LASER] = (0.0, np.sin(np.pi / 4), 0.0, np.cos(np.pi / 4))  # a quarter turn: along -x
    pos[2, LASER] = (0.0, 2.5, 0.0)
    quat[2, LASER] = (0.0, 0.0, 0.0, 1.0)  # along -z
    pos[2, DOOR, 1] = -10.0
    js = js.replace(actors=js.actors.replace(pos=jnp.asarray(pos), quat=jnp.asarray(quat)))
    ts = reset_batch(tc, b)
    ts = ts.replace(actors=ts.actors.replace(pos=torch.as_tensor(pos), quat=torch.as_tensor(quat)))

    hj, lj = (np.asarray(x) for x in jax.jit(jax.vmap(lambda a: j_lasers(jc, a)))(js.actors))
    calls = []
    ray_tris = batched.ray_tris
    monkeypatch.setattr(batched, "ray_tris", lambda *a: calls.append(a[2].shape[0]) or ray_tris(*a))
    ht, lt = (x.numpy() for x in compute_laser_rays(tc, ts.actors))
    assert calls == [b * tc.num_actors]  # one call of K2's wrapper for all B * N rays
    np.testing.assert_array_equal(ht, hj)
    np.testing.assert_allclose(lt, lj, atol=1e-5 * 50.0, rtol=0)
    assert ht[:, LASER].tolist() == [True, True, True] and not ht[:, :LASER].any()
    assert len({round(float(x), 3) for x in lt[:, LASER]}) == 3  # three different beam lengths


def test_update_actors_casts_the_lasers_when_not_given(world):
    """update_actors(laser_hit=None) equals passing compute_laser_rays'
    result, as in the JAX function."""
    from c_game_engine_tpu_torch.actors.behaviors import compute_laser_rays, update_actors
    from c_game_engine_tpu_torch.actors.signals import empty_fired
    from c_game_engine_tpu_torch.core.state import tree_leaves
    from c_game_engine_tpu_torch.models.sim import reset_batch

    _, tc, _, _ = world
    ts = reset_batch(tc, 2)
    cam = ts.player.pos.clone()
    runs = []
    for given in (False, True):
        f, fpi = empty_fired(2, tc.num_actors, "cpu")
        lasers = compute_laser_rays(tc, ts.actors) if given else (None, None)
        runs.append(update_actors(tc, ts, f, fpi, 1.0, cam, *lasers))
    for (name, a), (_, b) in zip(tree_leaves(runs[0][0]), tree_leaves(runs[1][0])):
        assert torch.equal(a, b), name
    assert float(runs[0][0].actors.fdata[0, LASER, 0]) < 50.0  # the door stops the beam
