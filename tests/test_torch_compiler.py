"""The port's map compiler and bundle builder on the CPU, against the JAX
package on the same files and against the committed maps.

tests/torch_map_sources.py writes the four committed maps' sources as
`.gmap` files with their assets. For each map, the port's
`compile_map(path)` equals the JAX package's `compile_map(path)` leaf for
leaf (dtype, shape and bytes) and in `aux` without the resolver; and the
port's compile of the decoded source under the map's name equals the
committed `c_game_engine_tpu_torch/maps/<name>.npz|json`, bit for bit,
but for the one leaf the .gmap format rounds (the lightmap, stored as
RGBA16F, tests/torch_map_sources.py::FLOAT16_LEAVES), which equals the
committed lightmap rounded to float16. The bundles the port builds for
arena_lit and arena_orb equal the committed bundles likewise. Also:
`build_atlas` on textures of odd and one-texel-wide mip chains, bit for
bit with the JAX atlas and sampled like it, and the compile cache
(compiler/cache.py): a second load comes from the .npz/.json files and
equals the first, a changed source or asset file rebuilds, a load
without a bundle builds none, and no pickle is written.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from tests import torch_map_sources as S
from tests.torch_export_map import MAP_DIR


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    return S.write_sources(tmp_path_factory.mktemp("sources"))


def _assert_leaves_equal(got: dict, want: dict, label, float16=()):
    assert sorted(got) == sorted(want), label
    for k in want:
        a, b = got[k], want[k]
        assert a.dtype == b.dtype and a.shape == b.shape, f"{label} {k}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}"
        if k in float16:
            b = b.astype(np.float16).astype(b.dtype)
        assert a.tobytes() == b.tobytes(), f"{label} {k}"


def _committed(stem):
    with np.load(MAP_DIR / f"{stem}.npz") as z:
        leaves = {k: z[k] for k in z.files}
    with open(MAP_DIR / f"{stem}.json") as f:
        return leaves, json.load(f)


@pytest.mark.parametrize("name", S.MAPS)
def test_compile_map_matches_jax_and_committed(sources, name):
    from c_game_engine_tpu.compiler.compile import compile_map as j_compile
    from c_game_engine_tpu_torch.assets.gmap import decode_gmap
    from c_game_engine_tpu_torch.compiler.compile import compile_map
    from c_game_engine_tpu_torch.core.state import map_to_numpy
    from tests.torch_export_map import map_to_numpy as j_map_to_numpy

    sp = [sources["assets"]]
    path = str(sources[name])
    mine = compile_map(path, search_paths=sp, device="cpu")
    leaves, aux = map_to_numpy(mine)
    j_leaves, j_aux = j_map_to_numpy(j_compile(path, search_paths=sp))
    _assert_leaves_equal(leaves, j_leaves, f"{name} vs JAX")
    assert json.loads(json.dumps(aux)) == json.loads(json.dumps(j_aux)) and aux["name"] == path
    assert type(mine.aux["resolver"]).__module__ == "c_game_engine_tpu_torch.compiler.models"

    leaves, aux = map_to_numpy(compile_map(decode_gmap(path), name=name, search_paths=sp, device="cpu"))
    c_leaves, c_aux = _committed(name)
    f16 = {k for m, k in S.FLOAT16_LEAVES if m == name}
    _assert_leaves_equal(leaves, c_leaves, f"{name} vs committed", f16)
    assert json.loads(json.dumps(aux)) == c_aux
    if f16:  # the one leaf the format rounds really differs
        assert not np.array_equal(leaves["lightmap"], c_leaves["lightmap"])


@pytest.mark.parametrize("name", S.RENDER_MAPS)
def test_bundle_matches_committed(sources, name):
    """build_render_bundle of the port-compiled map: every array leaf
    (`atlas.blocked` as bfloat16 rounded exactly as JAX rounds it) and the
    static fields equal the committed bundle's; K5's Morton row order on
    arena_orb's 81,920-triangle model included."""
    from c_game_engine_tpu_torch.assets.gmap import decode_gmap
    from c_game_engine_tpu_torch.compiler.compile import compile_map
    from c_game_engine_tpu_torch.render.bundle import build_render_bundle, bundle_to_numpy, load_bundle

    cm = compile_map(decode_gmap(sources[name]), name=name, search_paths=[sources["assets"]], device="cpu")
    rb = build_render_bundle(cm)
    assert rb.atlas.blocked.dtype == torch.bfloat16
    leaves, static = bundle_to_numpy(rb)
    c_leaves, c_static = _committed(f"{name}_bundle")
    f16 = {k for m, k in S.FLOAT16_LEAVES if m == f"{name}_bundle"}
    _assert_leaves_equal(leaves, c_leaves, f"{name} bundle vs committed", f16)
    assert json.loads(json.dumps(static)) == c_static
    loaded = load_bundle(MAP_DIR / f"{name}_bundle.npz", MAP_DIR / f"{name}_bundle.json", cm)
    for k in ("mdl_actor_rows", "mdl_pool_rows", "wall_actor_rows"):  # the soup's row tables
        assert torch.equal(getattr(rb, k), getattr(loaded, k)), k
    if name == "arena_orb":
        assert rb.live_tri_bound > 65536 and leaves["mdl_pos"].shape[0] == 81920


class _Tex:
    def __init__(self, w, h, repeat, filt, mips):
        rng = np.random.RandomState((w * 31 + h * 7 + repeat * 3 + filt) % 2**31)
        self.pixels = rng.rand(h, w, 4).astype(np.float32)
        self.width, self.height = w, h
        self.repeat, self.filter, self.mipmaps = repeat, filt, mips


TEXS = [(64, 64, True, True, True), (32, 16, False, True, True), (128, 128, True, False, True),
        (8, 8, False, False, True), (16, 16, True, True, False), (5, 3, False, True, True), (1, 8, True, True, True)]


def test_atlas_matches_jax():
    """build_atlas on tests/test_render.py's five textures plus an odd 5 x 3
    chain and a one-texel-wide one (every branch of `_downsample`): every
    leaf bit for bit with the JAX atlas (the bfloat16 rows compared as
    bits), and `sample` with and without lod like the JAX sampler across
    repeat/clamp, filter/nearest and out-of-range uv and lod."""
    import jax.numpy as jnp

    from c_game_engine_tpu.render.textures import build_atlas as j_build
    from c_game_engine_tpu.render.textures import sample as j_sample
    from c_game_engine_tpu_torch.render.textures import build_atlas, sample

    texs = [_Tex(*t) for t in TEXS]
    mine, theirs = build_atlas(texs, device="cpu"), j_build(texs)
    assert mine.blocked.dtype == torch.bfloat16
    a, b = mine.blocked.view(torch.int16).numpy(), np.asarray(theirs.blocked).view(np.int16)
    assert a.shape == b.shape and np.array_equal(a, b)
    for k in ("table", "mips", "n_mips", "mip_pairs", "flag_words"):
        x, y = getattr(mine, k).numpy(), np.asarray(getattr(theirs, k))
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), k
    rng = np.random.RandomState(0)
    n = 4096
    tid = rng.randint(0, len(texs), n).astype(np.int32)
    uv = rng.uniform(-1.5, 2.5, (n, 2)).astype(np.float32)
    lod = rng.uniform(-0.5, 7, n).astype(np.float32)
    for args in ((tid, uv, lod), (tid, uv)):
        got = sample(mine, *map(torch.as_tensor, args))
        np.testing.assert_allclose(got.numpy(), np.asarray(j_sample(theirs, *map(jnp.asarray, args))), atol=1e-6)


def test_compile_cache_round_trip(sources, tmp_path, monkeypatch):
    """load_compiled: the first call compiles and writes the map and bundle
    as .npz/.json (no pickle); a second call reads them back equal, with a
    resolver again; a changed source gets a new key and is compiled anew."""
    import os

    from c_game_engine_tpu_torch.compiler import cache
    from c_game_engine_tpu_torch.core.state import map_to_numpy
    from c_game_engine_tpu_torch.render.bundle import bundle_to_numpy

    monkeypatch.setattr(cache, "CACHE_DIR", tmp_path / "cache")
    sp = [sources["assets"]]
    src = tmp_path / "arena_lit.v2.gmap"  # a dotted stem: the entry keeps its whole name
    src.write_bytes(sources["arena_lit"].read_bytes())
    calls = []
    import c_game_engine_tpu_torch.compiler.compile as C

    real = C.compile_map
    monkeypatch.setattr(C, "compile_map", lambda *a, **k: calls.append(a[0]) or real(*a, **k))
    first = cache.load_compiled(src, sp, device="cpu")
    files = sorted(p.name for p in (tmp_path / "cache").iterdir())
    assert len(files) == 4 and all(f.endswith((".npz", ".json")) for f in files), files
    second = cache.load_compiled(src, sp, device="cpu")
    assert len(calls) == 1
    (l1, a1), (l2, a2) = map_to_numpy(first[0]), map_to_numpy(second[0])
    _assert_leaves_equal(l2, l1, "cached map")
    assert json.loads(json.dumps(a1)) == json.loads(json.dumps(a2))
    _assert_leaves_equal(bundle_to_numpy(second[1])[0], bundle_to_numpy(first[1])[0], "cached bundle")
    assert second[0].aux["resolver"].search_paths == first[0].aux["resolver"].search_paths
    assert cache.load_compiled(src, sp, with_bundle=False, device="cpu")[1] is None and len(calls) == 1
    st = src.stat()
    os.utime(src, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    cache.load_compiled(src, sp, device="cpu")
    assert len(calls) == 2 and len(list((tmp_path / "cache").iterdir())) == 8
    assert not list((tmp_path / "cache").glob("*.pkl")) and not list((tmp_path / "cache").glob("*tmp*"))


def test_compile_cache_bundle_on_demand_and_assets_in_key(sources, tmp_path, monkeypatch):
    """load_compiled(with_bundle=False) writes the map's entry alone and
    builds no bundle; a later load with the bundle reuses the map and
    builds the bundle once; an asset file under the search paths changed
    on disk compiles the map anew."""
    import os
    import shutil

    import c_game_engine_tpu_torch.compiler.compile as C
    import c_game_engine_tpu_torch.render.bundle as B
    from c_game_engine_tpu_torch.compiler import cache

    monkeypatch.setattr(cache, "CACHE_DIR", tmp_path / "cache")
    assets = tmp_path / "assets"
    shutil.copytree(sources["assets"], assets)
    compiles, builds = [], []
    real_compile, real_build = C.compile_map, B.build_render_bundle
    monkeypatch.setattr(C, "compile_map", lambda *a, **k: compiles.append(a[0]) or real_compile(*a, **k))
    monkeypatch.setattr(B, "build_render_bundle", lambda *a, **k: builds.append(1) or real_build(*a, **k))
    src = sources["arena_lit"]
    cmap, bundle = cache.load_compiled(src, [assets], with_bundle=False, device="cpu")
    assert bundle is None and not builds and len(compiles) == 1
    assert len(list((tmp_path / "cache").iterdir())) == 2
    _, bundle = cache.load_compiled(src, [assets], device="cpu")
    assert bundle is not None and len(builds) == 1 and len(compiles) == 1
    assert len(list((tmp_path / "cache").iterdir())) == 4
    cache.load_compiled(src, [assets], device="cpu")
    assert len(builds) == 1 and len(compiles) == 1
    tex = next(assets.rglob("*.gtex"))
    st = tex.stat()
    os.utime(tex, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    cache.load_compiled(src, [assets], device="cpu")
    assert len(compiles) == 2 and len(builds) == 2
