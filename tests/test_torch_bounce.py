"""The lightmap baker's one-bounce term (compiler/baker.py: _hammersley,
_cosine_dirs, make_shader(bounces, albedo) with its nearest hit over every
occluder; compiler/sectors.py::bake_lightmap(bounces=1)) held to the JAX
package on the CPU, on rooms.json (tests/torch_map_sources.py): its two
lights, 52 occluders and every sample point its bake shades (5,912 luxels
x 4), each point shaded by both packages with its surface's normal.

The port rounds each product of its three-term dot products; XLA fuses
the JAX shader's arithmetic into fused multiply-adds. rooms.json is
axis-aligned, so bounce rays from its regular sample grids pass exactly
through the shared diagonal of a wall's two triangles, and there the two
roundings decide the hit differently (at the ray examined, XLA's misses
both triangles, a crack, where the port's hits one, as float64 does; an
FMA chain emulated for the dots alone did not reproduce XLA's results).
Such a ray moves a point by its share of the bounce light (this test
prints the share within 1e-4 and the largest difference; 32 of 23,648
points were beyond 1e-4 when it was written, the largest 0.0138). Bar:
99% of points within 1e-4, every point within 0.02; the direct term alone
is held at 1e-4 on every point.
"""

from __future__ import annotations

import numpy as np
import pytest

from tests import torch_map_sources as S
from tests import torch_parity  # noqa: F401  (one torch thread a process)

TOL = 1e-4


@pytest.fixture(scope="module")
def rooms_points(tmp_path_factory):
    """rooms.json's bake: (lights, occluders, every sample point [P, 3],
    its surface normal [P, 3]), as the port's bake_lightmap hands them to
    the shader."""
    from c_game_engine_tpu_torch.compiler import baker, sectors

    src = S.write_sources(tmp_path_factory.mktemp("sources"))
    seen = {}
    real = baker.make_shader

    def capture(lights, tris, bounces=0, albedo=baker.ALBEDO, device="cuda"):
        shade = real(lights, tris, bounces, albedo, device)
        seen["lights"], seen["tris"] = lights, tris

        def record(pts, normals=None):
            seen["pts"], seen["normals"] = pts, normals
            return shade(pts, normals)

        return record

    baker.make_shader = capture
    try:
        sectors.compile_map_source(str(src["rooms"]), device="cpu")
    finally:
        baker.make_shader = real
    return seen["lights"], seen["tris"], seen["pts"], seen["normals"]


@pytest.fixture(scope="module")
def jax_bounce(rooms_points):
    """The JAX shader with bounces=1 on every point, one call per surface
    normal (the JAX shade takes one normal a call)."""
    import jax.numpy as jnp

    from c_game_engine_tpu.compiler.baker import make_shader as j_make

    lights, tris, pts, normals = rooms_points
    shade = j_make(lights, tris, bounces=1)
    out = np.zeros_like(pts)
    groups = np.unique(normals, axis=0)
    size = max(int((normals == n).all(-1).sum()) for n in groups)
    for n in groups:
        rows = np.nonzero((normals == n).all(-1))[0]
        padded = np.zeros((size, 3), np.float32)  # one shape: one compile
        padded[: len(rows)] = pts[rows]
        out[rows] = np.asarray(shade(jnp.asarray(padded), jnp.asarray(n)))[: len(rows)]
    return out


def _jax_direct(lights, tris, pts):
    import jax.numpy as jnp

    from c_game_engine_tpu.compiler.baker import make_shader as j_make

    return np.asarray(j_make(lights, tris)(jnp.asarray(pts), jnp.zeros(3, jnp.float32)))


def test_hammersley_and_cosine_dirs_match_jax():
    from c_game_engine_tpu.compiler import baker as jb
    from c_game_engine_tpu_torch.compiler import baker

    for n in (1, 5, 16):
        np.testing.assert_array_equal(baker._hammersley(n), jb._hammersley(n))
        d = baker._cosine_dirs(n)
        np.testing.assert_array_equal(d, jb._cosine_dirs(n))
        assert d.dtype == np.float32 and np.allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-6)
    assert (baker.ALBEDO, baker.N_BOUNCE) == (jb.ALBEDO, jb.N_BOUNCE)


def test_bounce_matches_jax(rooms_points, jax_bounce):
    from c_game_engine_tpu_torch.compiler import baker

    lights, tris, pts, normals = rooms_points
    got = baker.make_shader(lights, tris, bounces=1, device="cpu")(pts, normals)
    direct = baker.make_shader(lights, tris, device="cpu")(pts)
    diff = np.abs(got - jax_bounce).max(-1)
    share = float((diff <= TOL).mean())
    print(f"rooms.json bounce: {len(pts)} points, {share:.6f} within {TOL} of JAX, largest difference "
          f"{diff.max():.3g}")
    assert got.dtype == np.float32 and got.shape == pts.shape
    assert share >= 0.99 and diff.max() < 0.02
    assert np.abs(direct - _jax_direct(lights, tris, pts)).max() <= TOL
    # the bounce adds light, also where the direct term is dark
    gain = got - direct
    assert gain.min() >= 0.0 and (gain.max(-1) > 1e-3).mean() > 0.1
    assert ((direct.max(-1) == 0) & (got.max(-1) > 0)).any()


def test_bake_lightmap_takes_bounces(rooms_points, monkeypatch):
    """bake_lightmap(bounces=1) shades with the bounce term and each point's
    surface normal; any bounces > 0 adds one bounce, as in JAX."""
    from c_game_engine_tpu_torch.compiler import baker, sectors

    lights, tris, pts, normals = rooms_points
    rows = np.random.default_rng(2).choice(len(pts), 64, replace=False)
    one = baker.make_shader(lights, tris, bounces=1, device="cpu")(pts[rows], normals[rows])
    two = baker.make_shader(lights, tris, bounces=2, device="cpu")(pts[rows], normals[rows])
    np.testing.assert_array_equal(one, two)
    seen = []
    real = baker.make_shader
    monkeypatch.setattr(baker, "make_shader", lambda *a, **k: seen.append(k["bounces"]) or real(*a, **k))

    class Surface:  # one luxel of a floor facing up
        lm_size_luxels, lm_rect, luxels_per_unit = (1, 1), (0, 0), 4.0
        lm_org = np.zeros(2, np.float32)
        lm_axes = np.array([[1, 0, 0], [0, 0, 1]], np.float32)
        verts = np.array([[0, 0.0, 0, 0, 0, 0, 0]], np.float32)
        normal = np.array([0, 1, 0], np.float32)

    lm = sectors.bake_lightmap([Surface()], (1, 1), lights, tris, bounces=1, device="cpu")
    assert seen == [1] and lm.shape == (1, 1, 4) and lm[0, 0, 3] == 1.0


def test_bounce_blocks_and_chunks(rooms_points, monkeypatch):
    """The nearest-hit search with its rays in several blocks and the
    occluders in several chunks (POINT_BLOCK and MAX_PAIRS shrunk) finds
    what one block and chunk finds, to the bit."""
    from c_game_engine_tpu_torch.compiler import baker

    lights, tris, pts, normals = rooms_points
    rows = np.random.default_rng(4).choice(len(pts), 200, replace=False)
    whole = baker.make_shader(lights, tris, bounces=1, device="cpu")(pts[rows], normals[rows])
    monkeypatch.setattr(baker, "POINT_BLOCK", 256)  # the 3,200 bounce rays in 13 blocks
    monkeypatch.setattr(baker, "MAX_PAIRS", 256 * 7)  # 7 occluders a chunk
    parts = baker.make_shader(lights, tris, bounces=1, device="cpu")(pts[rows], normals[rows])
    assert len(tris) > 14
    np.testing.assert_array_equal(parts, whole)
