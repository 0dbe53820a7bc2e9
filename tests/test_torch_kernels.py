"""Kernel-level parity of the PyTorch port against the JAX package.

The port's kernels K1 (ops/capsule_resolve.py) and K2 (ops/ray_tris.py)
run here as their plain PyTorch versions (CPU tensors); the references are
the Pallas kernels themselves in TPU interpret mode, on the same inputs
made with numpy from a seed (K1 also on a small table of exact ties,
tests/torch_inputs.py::_capsule_tie_inputs; K2 also on an edge table of
exact hits, tests/torch_inputs.py::k2_edge_inputs). chunk_compact is held
to exact equality.

Tolerances: 1e-5 absolute for positions and ray t, and 1e-5 relative to
the lane's speed for velocities (the two sides differ only in float
evaluation order, and a clipped velocity carries the normal's rounding
times the speed); `grounded` and hit/miss exactly. Lanes scattered over the map can be pushed by metres through the
per-block candidate set (ROADMAP §3 f), so there the bar is 1e-5 relative
to the distance moved.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.torch_inputs import K1_TIE_X
from tests.torch_inputs import capsule_inputs as _capsule_inputs
from tests.torch_parity import export_and_load

B = 256


@pytest.fixture(scope="module")
def maps(tmp_path_factory):
    from tests.torch_export_map import compile_arena

    jc = compile_arena()
    return jc, export_and_load(jc, tmp_path_factory.mktemp("arena"))


def test_enums_and_constants_match_reference():
    import c_game_engine_tpu.actors.defs as jd
    import c_game_engine_tpu.assets.kvlist as jk
    import c_game_engine_tpu.core.actions as ja
    import c_game_engine_tpu.core.state as js
    import c_game_engine_tpu.physics.character as jch
    import c_game_engine_tpu_torch.actors.defs as td
    import c_game_engine_tpu_torch.assets.kvlist as tk
    import c_game_engine_tpu_torch.core.actions as ta
    import c_game_engine_tpu_torch.core.state as ts
    import c_game_engine_tpu_torch.physics.character as tch

    for name in ("ActorClass", "ActorFlags", "Input", "Output", "Motion", "Shape", "Layer",
                 "DoorState", "LaserHeight", "LogicOp", "DecimalOp"):
        assert {e.name: int(e) for e in getattr(td, name)} == {e.name: int(e) for e in getattr(jd, name)}
    assert {e.name: int(e) for e in tk.ParamType} == {e.name: int(e) for e in jk.ParamType}
    assert {e.name: int(e) for e in ta.Button} == {e.name: int(e) for e in ja.Button}
    for c in ("NUM_SFPARAMS", "NUM_SIPARAMS", "NUM_FDATA", "NUM_IDATA"):
        assert getattr(td, c) == getattr(jd, c)
    for c in ("PAIR_WARM_CAP", "EVENT_CAPACITY", "SIGNAL_ROUNDS"):
        assert getattr(ts, c) == getattr(js, c)
    for c in ("CAPSULE_RADIUS", "CAPSULE_HALF_HEIGHT", "MAX_SLOPE_COS", "STEP_UP", "STICK_DOWN"):
        assert getattr(tch, c) == getattr(jch, c)


def test_compact_chunk_lists_equal(maps):
    import jax.numpy as jnp

    from c_game_engine_tpu.ops.chunk_compact import block_minmax as j_minmax
    from c_game_engine_tpu.ops.chunk_compact import compact_chunk_lists as j_compact
    from c_game_engine_tpu_torch.ops.chunk_compact import block_minmax, compact_chunk_lists

    jc, tc = maps
    rng = np.random.default_rng(1)
    comp = rng.uniform(-26, 26, size=(2, 512)).astype(np.float32)
    lo_j, hi_j = j_minmax(jnp.asarray(comp), 128)
    lo_t, hi_t = block_minmax(torch.as_tensor(comp), 128)
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_j))
    # queries: the block boxes, an empty query (+inf, -inf), small random boxes
    x0 = np.concatenate([np.asarray(lo_j[0]), [np.inf], rng.uniform(-26, 26, 12)]).astype(np.float32)
    z0 = np.concatenate([np.asarray(lo_j[1]), [np.inf], rng.uniform(-26, 26, 12)]).astype(np.float32)
    x1 = np.concatenate([np.asarray(hi_j[0]), [-np.inf], x0[5:] + rng.uniform(0, 3, 12)]).astype(np.float32)
    z1 = np.concatenate([np.asarray(hi_j[1]), [-np.inf], z0[5:] + rng.uniform(0, 3, 12)]).astype(np.float32)
    for margin in (0.0, 1.0):
        ij, cj = j_compact(jc.chunk_bounds, *(jnp.asarray(a) for a in (x0, x1, z0, z1)), margin)
        it, ct = compact_chunk_lists(tc.chunk_bounds, *(torch.as_tensor(a) for a in (x0, x1, z0, z1)), margin)
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert int(np.asarray(cj)[4]) == 0  # the empty query


@pytest.mark.parametrize("layout", ["clustered", "scattered", "tie"])
def test_capsule_resolve_matches_pallas_kernel(maps, layout):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from c_game_engine_tpu.ops.capsule_resolve import resolve_capsule_pallas
    from c_game_engine_tpu_torch.ops import capsule_resolve as k1

    _, tc = maps
    args = _capsule_inputs(tc, layout, seed={"clustered": 2, "scattered": 3, "tie": 4}[layout])
    with pltpu.force_tpu_interpret_mode():
        pj, vj, gj = (np.asarray(a) for a in resolve_capsule_pallas(*(jnp.asarray(a) for a in args)))
    before = k1.launches
    pt, vt, gt = (a.numpy() for a in k1.resolve_capsule(*(torch.as_tensor(a) for a in args)))
    assert k1.launches == before  # CPU tensors take the plain version

    pos0 = args[4]
    moved = np.linalg.norm(pj - pos0, axis=-1, keepdims=True)
    scale = 1.0 if layout == "clustered" else np.maximum(moved, 1.0)
    assert np.all(np.abs(pt - pj) <= 1e-5 * scale)
    speed = np.maximum(np.linalg.norm(args[5], axis=-1, keepdims=True), 1.0)
    assert np.all(np.abs(vt - vj) <= 1e-5 * speed)
    np.testing.assert_array_equal(gt, gj)
    assert gt.any() and (~gt).any()
    assert moved.max() > 0.05  # real contacts were resolved
    if layout == "tie":
        # the first of each tie wins: the walls at rows 3 and 20 and box 1
        # push toward -x first, and after 4 pushes the capsules end 0.075 m
        # on the +x side; the floor beats the flush box, so x stays put
        x = pt[:, 0].reshape(-1, 4, 32)
        for k, (name, x0) in enumerate(K1_TIE_X.items()):
            want = x0 if name == "box_flush" else x0 + 0.075
            assert np.all(np.abs(x[:, k] - want) <= 1e-5), name
        assert (x[:, 2] == K1_TIE_X["box_flush"]).all()


def test_ray_tris_matches_pallas_kernel(maps):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from c_game_engine_tpu.ops.ray_tris import ray_tris_pallas
    from c_game_engine_tpu_torch.ops import ray_tris as k2

    _, tc = maps
    rng = np.random.default_rng(4)
    r = 300  # not a multiple of 128: exercises the zero-ray padding
    origin = np.stack(
        [rng.uniform(-20, 20, r), rng.uniform(0.1, 2.5, r), rng.uniform(-20, 20, r)], 1
    ).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    max_dist = rng.uniform(1.0, 50.0, r).astype(np.float32)
    tri16, cb = tc.tri16.numpy(), tc.chunk_bounds.numpy()
    with pltpu.force_tpu_interpret_mode():
        tj = np.asarray(ray_tris_pallas(*(jnp.asarray(a) for a in (tri16, cb, origin, d, max_dist))))
    tt = k2.ray_tris(*(torch.as_tensor(a) for a in (tri16, cb, origin, d, max_dist))).numpy()
    np.testing.assert_array_equal(tt < 1e29, tj < 1e29)
    np.testing.assert_allclose(tt, tj, atol=1e-5, rtol=0)
    assert (tj < 1e29).sum() > r // 4


def test_ray_tris_edge_table_matches_pallas_kernel():
    """K2's plain version against ray_tris_pallas in interpret mode on the
    edge table of tests/torch_inputs.py::k2_edge_inputs (rays on shared
    edges and vertices, in one chunk and across chunks; hits at exactly
    max_dist; rays parallel to the floors; blocks whose box touches a chunk
    bound exactly, or stops one float short of one; a NaN origin; R not a
    multiple of 128), with the bars of test_ray_tris_matches_pallas_kernel;
    both also equal the table's exact t for every built ray."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from c_game_engine_tpu.ops.ray_tris import ray_tris_pallas
    from c_game_engine_tpu_torch.ops import ray_tris as k2
    from tests.torch_inputs import k2_edge_inputs

    *args, expect = k2_edge_inputs()
    with pltpu.force_tpu_interpret_mode():
        tj = np.asarray(ray_tris_pallas(*(jnp.asarray(a) for a in args)))
    tt = k2.ray_tris(*(torch.as_tensor(a) for a in args)).numpy()
    np.testing.assert_array_equal(tt < 1e29, tj < 1e29)
    np.testing.assert_allclose(tt, tj, atol=1e-5, rtol=0)
    built = ~np.isnan(expect)
    np.testing.assert_array_equal(tt[built], expect[built])
    np.testing.assert_array_equal(tj[built], expect[built])
    assert (tt[~built] < 1e29).sum() > 8  # the random rays hit too


def test_wrappers_check_inputs_and_devices(maps):
    """Bad shapes raise; a tensor that is neither on the CPU nor on a CUDA
    device gets no fallback."""
    from c_game_engine_tpu_torch.ops import capsule_resolve as k1
    from c_game_engine_tpu_torch.ops import ray_tris as k2

    _, tc = maps
    args = [torch.as_tensor(a) for a in _capsule_inputs(tc, "clustered", seed=5)]
    with pytest.raises(ValueError, match="multiple of 128"):
        k1.resolve_capsule(*args[:4], args[4][:100], args[5][:100])
    with pytest.raises(ValueError, match="no capsule-resolve kernel"):
        k1.resolve_capsule(*(a.to("meta") for a in args))
    o = torch.zeros((5, 3))
    with pytest.raises(ValueError, match="no ray kernel"):
        k2.ray_tris(*(a.to("meta") for a in (tc.tri16, tc.chunk_bounds, o, o)), 10.0)
    with pytest.raises(TypeError):
        k2.ray_tris(tc.tri16, tc.chunk_bounds, o.double(), o.double(), 10.0)
    with pytest.raises(ValueError, match="chunk_bounds"):  # the kernel reads 4 bounds a chunk
        k2.ray_tris(tc.tri16, tc.chunk_bounds[:, :3], o, o, 10.0)
