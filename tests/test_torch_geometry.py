"""The port's single-env geometry (physics/geometry.py), the mathx helpers
it shares with the JAX package, and geometry_soa.capsule_tri_contact_soa,
held to the JAX functions on the CPU.

Random cases (4,096 of each, seeded numpy): floats within 1e-5 (XLA's
CPU code may fuse a * b - c * d into one FMA where PyTorch rounds twice,
tests/test_torch_render.py::test_xla_cpu_fuses_the_edge_function), booleans
and indices exact. An exact table of boundary cases with integer
coordinates and exact rotations (identity, a half turn about y), where no
rounding is left for an FMA to change: every output bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests import torch_parity  # noqa: F401  (one torch thread a process)

N = 4096
TOL = 1e-5


def _jax():
    import jax

    from c_game_engine_tpu.physics import geometry as jg
    from c_game_engine_tpu.physics import geometry_soa as js
    from c_game_engine_tpu.utils import mathx as jm

    return jax, jg, js, jm


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def cases():
    rng = np.random.default_rng(13)
    f = lambda *shape, lo=-2.0, hi=2.0: rng.uniform(lo, hi, size=shape).astype(np.float32)
    return {
        "p": f(N, 3), "a": f(N, 3), "b": f(N, 3), "c": f(N, 3), "s0": f(N, 3), "s1": f(N, 3),
        "center": f(N, 3), "quat": _unit_quats(rng, N), "half": f(N, 3, lo=0.1, hi=1.5),
        "radius": f(N, lo=0.05, hi=0.6), "dir": f(N, 3), "max_t": f(N, lo=0.5, hi=6.0),
        "euler": f(N, 3, lo=-3.2, hi=3.2), "v": np.concatenate([f(N - 4, 3), np.zeros((4, 3), np.float32)]),
    }


# (name, JAX and port function names, argument keys, the port's outputs
# that are boolean or integer)
FUNCTIONS = [
    ("closest_point_on_triangle", ("p", "a", "b", "c")),
    ("closest_point_on_segment", ("p", "s0", "s1")),
    ("capsule_triangle_closest", ("s0", "s1", "a", "b", "c")),
    ("point_in_obb", ("p", "center", "quat", "half")),
    ("closest_point_on_obb", ("p", "center", "quat", "half")),
    ("sphere_obb_penetration", ("p", "radius", "center", "quat", "half")),
    ("ray_triangle", ("p", "dir", "a", "b", "c", "max_t")),
    ("ray_obb", ("p", "dir", "center", "quat", "half", "max_t")),
    ("obb_corners", ("center", "quat", "half")),
]


def _compare(got, want, exact):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape
        if exact or g.dtype == bool or w.dtype == bool:
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
        else:
            finite = np.isfinite(w)
            np.testing.assert_array_equal(np.isfinite(g), finite)
            np.testing.assert_allclose(g[finite], w[finite], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name,keys", FUNCTIONS, ids=[f[0] for f in FUNCTIONS])
def test_geometry_matches_jax_on_random_cases(cases, name, keys):
    import jax.numpy as jnp

    from c_game_engine_tpu_torch.physics import geometry as tg

    jax, jg, _, _ = _jax()
    want = jax.jit(getattr(jg, name))(*(jnp.asarray(cases[k]) for k in keys))
    got = getattr(tg, name)(*(torch.as_tensor(cases[k]) for k in keys))
    _compare(got, want, exact=False)


def test_ray_hits_are_exercised(cases):
    """The random cases reach both sides of every branch worth holding."""
    from c_game_engine_tpu_torch.physics import geometry as tg

    t = lambda k: torch.as_tensor(cases[k])
    hit_tri, _ = tg.ray_triangle(t("p"), t("dir"), t("a"), t("b"), t("c"), t("max_t"))
    hit_obb, _ = tg.ray_obb(t("p"), t("dir"), t("center"), t("quat"), t("half"), t("max_t"))
    inside = tg.point_in_obb(t("p"), t("center"), t("quat"), t("half"))
    for mask in (hit_tri, hit_obb, inside):
        assert 0 < int(mask.sum()) < N


def _table():
    """Boundary cases with integer coordinates: a triangle a=(0,0,0),
    b=(2,0,0), c=(0,2,0); boxes at the origin with half extents 1 under the
    identity and a half turn about y."""
    tri = np.array([[0, 0, 0], [2, 0, 0], [0, 2, 0]], np.float32)
    degenerate = np.array([[0, 0, 0], [1, 1, 0], [2, 2, 0]], np.float32)
    point_tri = [  # (p, triangle)
        ((0, 0, 0), tri),  # on vertex a
        ((2, 0, 0), tri),  # on vertex b
        ((1, 0, 0), tri),  # on edge ab
        ((1, 1, 0), tri),  # on edge bc
        ((1, 1, 3), tri),  # above edge bc
        ((-1, -1, 0), tri),  # beyond vertex a
        ((0, 1, -4), tri),  # below edge ac
        ((1, 1, 1), degenerate),  # a degenerate (collinear) triangle
        ((5, 5, 5), np.zeros((3, 3), np.float32)),  # a point triangle
    ]
    segs = [  # (p, s0, s1)
        ((1, 2, 3), (0, 0, 0), (0, 0, 0)),  # zero-length segment
        ((1, 2, 3), (0, 0, 0), (0, 4, 0)),
        ((1, -2, 3), (0, 0, 0), (0, 4, 0)),  # before s0
        ((1, 9, 3), (0, 0, 0), (0, 4, 0)),  # past s1
    ]
    rays = [  # (origin, dir, max_t, triangle)
        ((1, 1, 5), (0, 0, -1), 8, tri),  # a hit
        ((0, 0, 5), (0, 0, -1), 5, tri),  # through vertex a, at exactly max_t
        ((1, 0, 5), (0, 0, -1), 4, tri),  # through edge ab, beyond max_t
        ((-1, 1, 1), (1, 0, 0), 9, tri),  # parallel to the face
        ((1, 1, 0), (0, 0, 1), 9, tri),  # starting on the face (t = 0)
        ((1, 1, 5), (0, 0, -1), 8, degenerate),
    ]
    ident = np.array([0, 0, 0, 1], np.float32)
    half_turn = np.array([0, 1, 0, 0], np.float32)
    ones = np.ones(3, np.float32)
    boxes = [  # (p, dir, max_t, quat, half extents)
        ((0, 0, 0), (1, 0, 0), 3, ident, ones),  # centre inside, tied face distances
        ((0, 0, 0), (0, 0, 1), 3, half_turn, np.array([2, 1, 1], np.float32)),  # tie of y and z
        ((1, 0, 0), (0, 1, 0), 3, ident, ones),  # on a face
        ((1, 1, 1), (-1, -1, -1), 3, half_turn, ones),  # on a corner
        ((3, 0, 0), (-1, 0, 0), 2, ident, ones),  # at exactly max_t
        ((3, 0, 0), (-1, 0, 0), 1, half_turn, ones),  # beyond max_t
        ((3, 0, 0), (0, 1, 0), 9, ident, ones),  # parallel to the x slabs, outside
        ((0, 3, 0), (0, -1, 0), 9, half_turn, ones),
        ((2, 2, 0), (0, 0, 1), 9, ident, ones),  # parallel to z, outside in x and y
    ]
    f = lambda rows: np.asarray(rows, np.float32)
    return {
        "closest_point_on_triangle": (f([r[0] for r in point_tri]), f([r[1][0] for r in point_tri]),
                                      f([r[1][1] for r in point_tri]), f([r[1][2] for r in point_tri])),
        "closest_point_on_segment": tuple(f([r[i] for r in segs]) for i in range(3)),
        "capsule_triangle_closest": (f([r[1] for r in segs[:3]] * 3), f([r[2] for r in segs[:3]] * 3),
                                     *(f([r[1][i] for r in point_tri[:9]]) for i in range(3))),
        "ray_triangle": (f([r[0] for r in rays]), f([r[1] for r in rays]), f([r[3][0] for r in rays]),
                         f([r[3][1] for r in rays]), f([r[3][2] for r in rays]), f([r[2] for r in rays])),
        "point_in_obb": (f([r[0] for r in boxes]), np.zeros((len(boxes), 3), np.float32),
                         f([r[3] for r in boxes]), f([r[4] for r in boxes])),
        "closest_point_on_obb": (f([(2 * r[0][0], 3, -r[0][2]) for r in boxes]), np.zeros((len(boxes), 3), np.float32),
                                 f([r[3] for r in boxes]), f([r[4] for r in boxes])),
        "sphere_obb_penetration": (f([r[0] for r in boxes]), f([0.5] * len(boxes)),
                                   np.zeros((len(boxes), 3), np.float32), f([r[3] for r in boxes]),
                                   f([r[4] for r in boxes])),
        "ray_obb": (f([r[0] for r in boxes]), f([r[1] for r in boxes]), np.zeros((len(boxes), 3), np.float32),
                    f([r[3] for r in boxes]), f([r[4] for r in boxes]), f([r[2] for r in boxes])),
        "obb_corners": (f([r[0] for r in boxes]), f([r[3] for r in boxes]), f([r[4] for r in boxes])),
    }


@pytest.mark.parametrize("name", [f[0] for f in FUNCTIONS])
def test_geometry_matches_jax_on_boundary_cases(name):
    import jax.numpy as jnp

    from c_game_engine_tpu_torch.physics import geometry as tg

    jax, jg, _, _ = _jax()
    args = _table()[name]
    want = jax.jit(getattr(jg, name))(*(jnp.asarray(a) for a in args))
    got = getattr(tg, name)(*(torch.as_tensor(a) for a in args))
    _compare(got, want, exact=True)


def test_boundary_table_reads_as_intended():
    """The table's cases land where their comments say, on the port."""
    from c_game_engine_tpu_torch.physics import geometry as tg

    t = {k: tuple(torch.as_tensor(a) for a in v) for k, v in _table().items()}
    hit, dist = tg.ray_triangle(*t["ray_triangle"])
    assert hit.tolist() == [True, True, False, False, False, False]
    assert dist[1] == 5.0
    depth, normal = tg.sphere_obb_penetration(*t["sphere_obb_penetration"])
    assert normal[0].tolist() == [1.0, 0.0, 0.0] and depth[0] == 1.5  # the first of three tied axes
    assert normal[1].tolist()[1] == 1.0  # y before z, turned by the half turn
    assert tg.point_in_obb(*t["point_in_obb"])[:4].all()
    bhit, bt = tg.ray_obb(*t["ray_obb"])
    assert bhit[4] and bt[4] == 2.0 and not bhit[5] and not bhit[6] and not bhit[8]
    q = tg.closest_point_on_segment(*t["closest_point_on_segment"])
    assert q[0].tolist() == [0.0, 0.0, 0.0] and q[3].tolist() == [0.0, 4.0, 0.0]


def test_one_hot_is_jax_one_hot():
    from c_game_engine_tpu_torch.physics.geometry import one_hot

    _, jg, _, _ = _jax()
    idx = np.array([[0, 2], [1, 3]], np.int32)
    np.testing.assert_array_equal(one_hot(torch.as_tensor(idx), 3).numpy(), np.asarray(jg.jax_one_hot(idx, 3)))


MATHX = [
    ("clamp", lambda c: (c["p"], -0.5, 0.75)),
    ("normalize", lambda c: (c["v"],)),
    ("safe_normalize", lambda c: (c["v"],)),
    ("dot", lambda c: (c["p"], c["a"])),
    ("quat_from_euler", lambda c: (c["euler"],)),
    ("quat_twist_angle", lambda c: (c["quat"], np.array([0.0, 1.0, 0.0], np.float32))),
]


@pytest.mark.parametrize("name,args", MATHX, ids=[m[0] for m in MATHX])
def test_mathx_helpers_match_jax(cases, name, args):
    import jax.numpy as jnp

    from c_game_engine_tpu_torch.utils import mathx as tm

    jax, _, _, jm = _jax()
    a = args(cases)
    want = jax.jit(getattr(jm, name), static_argnums=tuple(i for i, x in enumerate(a) if isinstance(x, float)))(
        *(x if isinstance(x, float) else jnp.asarray(x) for x in a))
    got = getattr(tm, name)(*(x if isinstance(x, float) else torch.as_tensor(x) for x in a))
    _compare(got, want, exact=False)
    if name == "safe_normalize":
        assert not got[-4:].any() and torch.isfinite(got).all()


def test_safe_normalize_takes_an_axis(cases):
    import jax.numpy as jnp

    from c_game_engine_tpu_torch.utils.mathx import safe_normalize

    _, _, _, jm = _jax()
    v = cases["p"].T.copy()
    _compare(safe_normalize(torch.as_tensor(v), axis=0), jm.safe_normalize(jnp.asarray(v), axis=0), exact=False)


def test_capsule_tri_contact_soa_matches_jax(cases):
    """[L, B] lanes: 16 triangles against 256 vertical capsule segments.
    Held to the JAX function run op by op (jax.disable_jit: no fusion)
    within 1e-5 on every output. Jitted, XLA's CPU code contracts products
    into FMAs, which turns the contact normal of a segment passing within
    a hair of a triangle (its closest-point delta nearly zero) by up to
    4e-3 here: against the jitted function the separation `signed` is held
    within 1e-5, the normal where the delta is longer than 0.05 (an FMA's
    error of about 1e-7 m in the delta turns a normal by that over the
    delta's length)."""
    import jax.numpy as jnp

    from c_game_engine_tpu_torch.physics import geometry_soa as ts

    jax, _, js, _ = _jax()
    rng = np.random.default_rng(5)
    tri = rng.uniform(-1.0, 1.0, size=(16, 1, 3, 3)).astype(np.float32)
    n = np.cross(tri[..., 1, :] - tri[..., 0, :], tri[..., 2, :] - tri[..., 0, :])
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    cap = rng.uniform(-1.0, 1.0, size=(1, 256, 3)).astype(np.float32)
    args = [cap[..., 0], cap[..., 1] - 0.25, cap[..., 1] + 0.25, cap[..., 2],
            *(tri[..., v, k] for v in range(3) for k in range(3)), *(n[..., k] for k in range(3))]
    jargs = [jnp.asarray(a) for a in args]
    with jax.disable_jit():
        want = js.capsule_tri_contact_soa(*jargs, 0.2)
    got = ts.capsule_tri_contact_soa(*(torch.as_tensor(a) for a in args), 0.2)
    _compare(got, want, exact=False)
    fused = jax.jit(lambda *a: js.capsule_tri_contact_soa(*a, 0.2))(*jargs)
    _compare(got[0], fused[0], exact=False)
    far = np.abs(got[0].numpy()) > 0.05  # |signed| bounds the delta's length from below
    for g, w in zip(got[1:], fused[1:]):
        np.testing.assert_allclose(g.numpy()[far], np.asarray(w)[far], atol=TOL, rtol=TOL)
    assert (got[0] < 0.2).any() and (got[0] > 0.2).any()  # contacts and separations both
    assert far.mean() > 0.9
