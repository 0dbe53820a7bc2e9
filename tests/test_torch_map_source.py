"""The port's editor-JSON compiler (compiler/sectors.py) and its lightmap
bake (compiler/baker.py) on the CPU, against the JAX package on
tests/torch_map_sources.py's `rooms.json` (three sectors with a floor step
and a shared doorway, two point lights, a door, a coin and a physbox).

`compile_map_source`: the GMap's render surfaces (vertices with their
chart-packed lightmap uv, indices, materials), collision meshes, actors
and point lights equal the JAX GMap's bit for bit; the lightmap within
1e-4 absolute on at least 99.9% of luxels (a grazing shadow ray may flip
between two float32 implementations; the share is printed).
`compile_map` of the JSON path equals the JAX map leaf for leaf (the
lightmap at the same bar), and `build_render_bundle` equals the JAX
bundle of it. The shader with its points and occluders in several
chunks against the JAX shader; `halls_source` (the full-size editor map)
cut to 6 x 6 against the JAX compile. `make_sim` takes the `.json` and
`.gmap` paths (eager, on the CPU), and GameApp lists, compiles and draws
a `.gmap` level.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from tests import torch_map_sources as S

LUXEL_TOL, LUXEL_SHARE = 1e-4, 0.999


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    return S.write_sources(tmp_path_factory.mktemp("sources"))


@pytest.fixture(scope="module")
def gmaps(sources):
    from c_game_engine_tpu.compiler.sectors import compile_map_source as j_compile
    from c_game_engine_tpu_torch.compiler.sectors import compile_map_source

    path = str(sources["rooms"])
    return compile_map_source(path, device="cpu"), j_compile(path)


@pytest.fixture(scope="module")
def maps(sources):
    from c_game_engine_tpu.compiler.compile import compile_map as j_compile
    from c_game_engine_tpu_torch.compiler.compile import compile_map

    sp = [sources["assets"]]
    path = str(sources["rooms"])
    return compile_map(path, search_paths=sp, device="cpu"), j_compile(path, search_paths=sp)


def _luxel_share(got, want):
    return float((np.abs(got - want).max(-1) <= LUXEL_TOL).mean())


def test_gmap_matches_jax(gmaps):
    mine, theirs = gmaps
    assert len(mine.models) == len(theirs.models) == 3
    for a, b in zip(mine.models, theirs.models):
        assert a.material == b.material
        for f in ("vertices", "indices"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), (a.material, f)
    assert len(mine.collision) == len(theirs.collision) == 3
    for a, b in zip(mine.collision, theirs.collision):
        assert a.origin.tobytes() == b.origin.tobytes() and len(a.sub_tris) == len(b.sub_tris)
        for x, y in zip(a.sub_tris, b.sub_tris):
            assert x.tobytes() == y.tobytes()
    assert mine.point_lights.tobytes() == theirs.point_lights.tobytes() and mine.point_lights.shape == (2, 9)
    assert [a.actor_class for a in mine.actors] == [a.actor_class for a in theirs.actors]
    for a, b in zip(mine.actors + [mine.player_spawn], theirs.actors + [theirs.player_spawn]):
        assert a.position.tobytes() == b.position.tobytes() and a.rotation_euler.tobytes() == b.rotation_euler.tobytes()
        assert {k: (int(p.type), p.value) for k, p in a.params.items()} == {
            k: (int(p.type), p.value) for k, p in b.params.items()}
        assert [(c.output, c.target_name, c.target_input) for c in a.connections] == [
            (c.output, c.target_name, c.target_input) for c in b.connections]
    assert (mine.render_sky, mine.sky_texture, mine.discord_name) == (theirs.render_sky, theirs.sky_texture,
                                                                     theirs.discord_name)


def test_lightmap_bake_within_the_bar(gmaps):
    mine, theirs = gmaps
    assert mine.lightmap.shape == theirs.lightmap.shape and mine.lightmap.dtype == np.float32
    share = _luxel_share(mine.lightmap, theirs.lightmap)
    lit = theirs.lightmap[..., :3].max(-1)
    print(f"rooms.json lightmap {mine.lightmap.shape}: {share:.6f} of luxels within {LUXEL_TOL} of the JAX bake "
          f"(largest difference {np.abs(mine.lightmap - theirs.lightmap).max():.3g}); lit luxels of the atlas "
          f"{(lit > 0).mean():.3f}")
    assert share >= LUXEL_SHARE
    assert lit.max() > 1.0 and (lit > 0).mean() > 0.1 and np.all(mine.lightmap[..., 3] == 1.0)


def test_baker_chunks_match_jax(monkeypatch):
    """make_shader with the sample points split over several blocks and the
    occluders over several chunks (POINT_BLOCK and MAX_PAIRS shrunk)
    against the JAX shader, on random points in a closed box room with a
    floating slab: within 1e-4 on 99.9% of points."""
    import jax.numpy as jnp

    from c_game_engine_tpu.compiler.baker import make_shader as j_make
    from c_game_engine_tpu_torch.compiler import baker
    from tests.worldgen import box_room

    tris = box_room(4.0, 0.0, 3.0)
    tris = np.concatenate([tris, tris[:2] * 0.3 + np.array([0.0, 1.0, 0.0], np.float32)])  # a floating slab
    lights = np.array([[1, 2.5, 1, 1, 0.8, 0.6, 2, 8, 1], [-2, 2, -1, 0.3, 0.5, 1, 1, 6, 2]], np.float32)
    pts = np.random.default_rng(5).uniform([-3.9, 0.01, -3.9], [3.9, 0.01, 3.9], (300, 3)).astype(np.float32)
    normal = np.array([0.0, 1.0, 0.0], np.float32)
    want = np.asarray(j_make(lights, tris)(jnp.asarray(pts), jnp.asarray(normal)))
    monkeypatch.setattr(baker, "POINT_BLOCK", 128)  # blocks of 128, 128 and 44 points
    monkeypatch.setattr(baker, "MAX_PAIRS", 128 * 5)  # 5 occluders a chunk in a full block
    got = baker.make_shader(lights, tris, device="cpu")(pts)
    assert len(tris) > 10 and got.dtype == np.float32 and got.shape == (300, 3)
    assert _luxel_share(got, want) >= LUXEL_SHARE and float(np.abs(got - want).max()) < 1e-3
    assert (got.max(-1) > 0).mean() > 0.5 and (got.max(-1) == 0).any()  # lit points and shadowed ones


def _capture_bake(monkeypatch, sectors):
    """Patch sectors.bake_lightmap to record its arguments; returns ({"args":
    ...} once it has run, the real bake)."""
    seen = {}
    real = sectors.bake_lightmap

    def bake(*a, **k):
        seen["args"] = a
        return real(*a, **k)

    monkeypatch.setattr(sectors, "bake_lightmap", bake)
    return seen, real


def test_halls_matches_jax(monkeypatch):
    """tests/torch_map_sources.py::halls_source cut to a 6 x 6 grid (30
    sectors, 4 lights). The port's GMap surfaces and collision equal the
    JAX GMap's bit for bit (the JAX host compile run without its bake),
    so the vectorized neighbour and box searches pick what the JAX loops
    pick. The JAX bake of every twelfth surface alone meets the bar
    against the port's whole bake on those surfaces' luxels. And the
    port's bake of every third surface alone gives those luxels as its
    whole bake does, bit for bit, as chip_smoke.py's check of the
    full-size map on a subset of its surfaces assumes."""
    from c_game_engine_tpu.compiler import sectors as j_sectors
    from c_game_engine_tpu_torch.compiler import sectors

    src = S.halls_source(n=6, lights=4)
    seen, real_bake = _capture_bake(monkeypatch, sectors)
    j_bake = j_sectors.bake_lightmap
    monkeypatch.setattr(j_sectors, "bake_lightmap", lambda sfs, size, *a, **k: np.zeros((size[1], size[0], 4)))
    mine, theirs = sectors.compile_map_source(src, device="cpu"), j_sectors.compile_map_source(src)
    assert len(src["sectors"]) == 30 and len(mine.models) == len(theirs.models)
    for a, b in zip(mine.models, theirs.models):
        assert a.material == b.material and a.vertices.tobytes() == b.vertices.tobytes()
        assert a.indices.tobytes() == b.indices.tobytes()
    for a, b in zip(mine.collision, theirs.collision, strict=True):
        assert a.origin.tobytes() == b.origin.tobytes()
        assert [x.tobytes() for x in a.sub_tris] == [x.tobytes() for x in b.sub_tris]
    assert mine.lightmap.shape == theirs.lightmap.shape

    surfaces, atlas_size, lights, tris = seen["args"]

    def rects(sub):
        return [(slice(y0, y0 + h), slice(x0, x0 + w)) for (x0, y0), (w, h) in
                ((sf.lm_rect, sf.lm_size_luxels) for sf in sub)]

    sub = surfaces[::12]
    want = j_bake(sub, atlas_size, lights, tris)
    got = np.concatenate([mine.lightmap[r].reshape(-1, 4) for r in rects(sub)])
    want = np.concatenate([want[r].reshape(-1, 4) for r in rects(sub)])
    share = _luxel_share(got, want)
    print(f"halls 6 x 6: {share:.6f} of {len(got)} luxels of {len(sub)} surfaces within {LUXEL_TOL} of the JAX bake")
    assert share >= LUXEL_SHARE and (got[:, :3].max(-1) > 0).mean() > 0.1

    part = real_bake(surfaces[::3], atlas_size, lights, tris, device="cpu")
    for r in rects(surfaces[::3]):
        assert np.array_equal(part[r], mine.lightmap[r])


def test_compile_map_json_matches_jax(maps):
    mine, theirs = maps
    from c_game_engine_tpu_torch.core.state import map_to_numpy
    from tests.torch_export_map import map_to_numpy as j_map_to_numpy

    leaves, aux = map_to_numpy(mine)
    j_leaves, j_aux = j_map_to_numpy(theirs)
    assert sorted(leaves) == sorted(j_leaves)
    for k, b in j_leaves.items():
        a = leaves[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if k == "lightmap":
            assert _luxel_share(a, b) >= LUXEL_SHARE
        else:
            assert a.tobytes() == b.tobytes(), k
    assert json.loads(json.dumps(aux)) == json.loads(json.dumps(j_aux))
    assert aux["num_dynamic"] == 1 and aux["model_names"] == [S.CUBE_MODEL] and leaves["point_lights"].shape == (2, 9)


def test_bundle_of_json_map_matches_jax(maps):
    """build_render_bundle of the JSON map against the JAX bundle: every
    leaf bit for bit (the lightmap at the bake's bar), the static fields
    equal; the tile route (live_tri_bound far under 65,536)."""
    from c_game_engine_tpu.render.bundle import build_render_bundle as j_build
    from c_game_engine_tpu_torch.render.bundle import build_render_bundle, bundle_to_numpy
    from tests.torch_export_map import bundle_to_numpy as j_bundle_to_numpy

    mine, theirs = maps
    leaves, static = bundle_to_numpy(build_render_bundle(mine))
    j_leaves, j_static = j_bundle_to_numpy(j_build(theirs))
    assert sorted(leaves) == sorted(j_leaves)
    for k, b in j_leaves.items():
        a = leaves[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if k == "lightmap":
            assert _luxel_share(a, b) >= LUXEL_SHARE
        else:
            assert a.tobytes() == b.tobytes(), k
    assert json.loads(json.dumps(static)) == json.loads(json.dumps(j_static))
    assert static["live_tri_bound"] < 65536 and S.CUBE_TEX in static["tex_names"]


def test_make_sim_takes_source_paths(sources, tmp_path, monkeypatch):
    """make_sim of the `.json` and of a `.gmap` path (through the compile
    cache) runs eagerly on the CPU, the JSON map's rigid-body step
    included."""
    from c_game_engine_tpu_torch.compiler import cache
    from c_game_engine_tpu_torch.core.actions import Actions
    from c_game_engine_tpu_torch.models.sim import make_sim

    monkeypatch.setattr(cache, "CACHE_DIR", tmp_path / "cache")
    sp = [sources["assets"]]
    rooms = make_sim(str(sources["rooms"]), batch=4, jit=False, device="cpu", search_paths=sp)
    st = rooms.rollout(rooms.reset(), Actions.zeros((20, 4), device="cpu"))
    box = rooms.cmap.aux["actor_classes"].index("PHYSBOX")
    assert rooms.name == str(sources["rooms"]) and int(st.tick[0]) == 20
    assert bool(st.actors.pos.isfinite().all()) and float(st.actors.pos[0, box, 1]) > 0.4 + 0.19  # over room C's floor
    arena = make_sim(str(sources["arena"]), batch=2, jit=False, device="cpu", search_paths=sp)
    assert int(arena.rollout(arena.reset(), Actions.zeros((2, 2), device="cpu")).tick[0]) == 2
    with pytest.raises(ValueError, match="jit=False"):
        make_sim(str(sources["arena"]), batch=2, jit=True, device="cpu", search_paths=sp)


def test_game_app_compiles_a_gmap_level(sources, tmp_path, monkeypatch):
    """A `.gmap` in map_dir is a level: listed, compiled with its bundle
    built (no NotImplementedError), ticked and drawn."""
    import shutil

    from c_game_engine_tpu_torch.compiler import cache
    from c_game_engine_tpu_torch.models.game import GameApp, Screen

    monkeypatch.setattr(cache, "CACHE_DIR", tmp_path / "cache")
    d = tmp_path / "maps"
    d.mkdir()
    shutil.copy(sources["arena_lit"], d / "arena_lit.gmap")
    app = GameApp(map_dir=d, device="cpu", synthetic_assets=True, search_paths=[sources["assets"]])
    assert app.list_levels() == ["arena_lit"] and app.has_bundle("arena_lit")
    app.load_level("arena_lit")
    assert app.screen == Screen.IN_GAME and app.cmap.aux["name"] == str(d / "arena_lit.gmap")
    app.tick()
    frame = app.render_frame(128, 128)
    assert frame.shape == (128, 128, 3) and bool(frame.isfinite().all()) and float(frame.std()) > 0.02
    app.load_level(str(sources["rooms"]))
    assert app.screen == Screen.IN_GAME and app.cmap.point_lights.shape[0] == 2
    assert bool(app.render_frame(128, 128).isfinite().all())

