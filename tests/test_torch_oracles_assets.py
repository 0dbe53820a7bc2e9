"""The JAX package's hull, failure and app oracles that need asset files,
run through the port (and the JAX package where it takes the same files)
on the CPU. The reference assets are absent, so the models are built here
from tests/torch_map_sources.py's `cube_model()`: `model/orb.gmdl` a
DYNAMIC hull of radius 0.4 (an icosphere of 642 points, where the
reference orb is a sphere of that radius), `model/leafy.gmdl` a DYNAMIC
compound of two boxes (where the reference leafy is a compound of its
own), every other model the cube; the failure maps are editor-JSON
sources written here (the reference's invalid.json, missing_material
and entirely_skip maps are absent); the app runs on the committed maps.

    port test                                   replaces
    test_support_cloud_matches_numpy_oracle     tests/test_hulls.py::test_support_cloud_matches_numpy_oracle
    test_bodies_match_jax                       (the parity bars of the hull rollout)
    test_hull_body_rest_height                  tests/test_hulls.py::test_hull_body_rest_height (orb)
    test_pushed_pair_box_box                    tests/test_hulls.py::test_pushed_pair_box_box
    test_two_high_stack_sleeps                  tests/test_hulls.py::test_two_high_stack_sleeps
    test_hull_mass_properties_analytic          tests/test_hulls.py::test_hull_mass_properties_analytic
    test_compiled_inertia_and_density_mass      tests/test_hulls.py::test_compiled_inertia_and_density_mass
    test_invalid_json_source_compiles           tests/test_failures.py::test_invalid_json_source_compiles
    test_missing_material_falls_back            tests/test_failures.py::test_missing_material_falls_back
    test_entirely_skip_compiles_and_renders     tests/test_failures.py::test_entirely_skip_compiles_and_renders
    test_failed_load_recovers_to_menu           tests/test_failures.py::test_failed_load_recovers_to_menu
    test_save_data_persists_across_maps         tests/test_game_app.py::test_save_data_persists_across_maps
    test_physics_frame_uptime_persists          tests/test_game_app.py::test_physics_frame_uptime_persists_across_maps

tests/test_hulls.py::test_npc_john_cylinder_rest is held by
tests/test_torch_bodies.py::test_port_npc_john_rests. The hull rollout
holds the three body scenarios of tests/test_hulls.py in one box room at
their JAX positions (the orb at (2, -0.5, 2), the pushed pair at x 0 and
0.7, z 4, the stack at (4, 4)) for 300 ticks, in two envs: the pushed
target slides 3 m into the stack's place, so env 0 (the push) has the
stack moved to (-4, y, -1) and env 1 (the stack) the pair moved to x -4
and -5, z -1, at rest. The orb is in both.
"""

from __future__ import annotations

import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

from tests.torch_export_map import make_stub_map
from tests.torch_oracles import Pair, actions, both, cube_resolver

ORB_R = 0.4
PUSH, STACK = 0, 1  # the hull rollout's envs
PARITY_TICKS = 90


def _hull_models(assets):
    """Write model/orb.gmdl and model/leafy.gmdl under `assets`."""
    from c_game_engine_tpu_torch.assets import codecs
    from tests.torch_export_map import icosphere
    from tests.torch_map_sources import cube_model, encode_gmdl

    dyn = codecs.CollisionModelType.DYNAMIC
    sphere = np.unique(icosphere(3).reshape(-1, 3).round(6), axis=0) * ORB_R
    encode_gmdl(dataclasses.replace(cube_model(), collision_type=dyn, aabb_extents=np.full(3, ORB_R, np.float32),
                                    hulls=[{"points": sphere.astype(np.float32), "offset": np.zeros(3, np.float32)}]),
                assets / "model/orb.gmdl")
    box = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)], np.float32)
    encode_gmdl(dataclasses.replace(cube_model(), collision_type=dyn, aabb_extents=np.full(3, 0.5, np.float32),
                                    hulls=[{"points": box * (0.2, 0.3, 0.2), "offset": np.array([0, 0.2, 0], np.float32)},
                                           {"points": box * 0.15, "offset": np.array([0.3, -0.3, 0], np.float32)}]),
                assets / "model/leafy.gmdl")


@pytest.fixture(scope="module")
def hulls(tmp_path_factory):
    from tests.worldgen import P_str, actor

    tmp = tmp_path_factory.mktemp("hulls")
    resolver = cube_resolver(tmp / "assets")
    _hull_models(tmp / "assets")
    jc = make_stub_map([actor("prop_model_physics", (2.0, -0.5, 2.0), params={"model": P_str("model/orb.gmdl")}),
                   actor("prop_physbox", (0.0, -0.8, 4.0)), actor("prop_physbox", (0.7, -0.8, 4.0)),
                   actor("prop_physbox", (4.0, -0.8, 4.0)), actor("prop_physbox", (4.0, -0.399, 4.0))],
                  spawn=(0, 0, -4), resolver=resolver)
    jc, tc = both(jc, tmp)
    classes = jc.aux["actor_classes"]
    boxes = [i for i, c in enumerate(classes) if c == "PHYSBOX"]
    rows = {"orb": classes.index("PHYSICS_MODEL"), "pair": boxes[:2], "stack": boxes[2:]}
    pair = Pair(jc, tc, 2)
    for i, y in zip(rows["stack"], (-0.8, -0.399)):
        pair.set_actor(PUSH, i, pos=(-4.0, y, -1.0))
    for i, x in zip(rows["pair"], (-4.0, -5.0)):
        pair.set_actor(STACK, i, pos=(x, -0.8, -1.0))
    pair.set_actor(PUSH, rows["pair"][0], vel=(3.0, 0.0, 0.0))
    pair.run(*actions(300, 2))
    return pair, rows, tmp / "assets"


def test_bodies_match_jax(hulls):
    """The parity bars on every body over the first 90 ticks (ROADMAP fault
    p: past them the pushed target, sliding tipped on an edge across the
    room, and the stack's top box drift apart by more than 5e-3; both
    packages keep every oracle bar below)."""
    pair = hulls[0]
    split = pair.split()
    assert not split or min(split) >= PARITY_TICKS, list(split.items())[:3]


def test_support_cloud_matches_numpy_oracle(hulls):
    """Both packages' `_support_toward` equal the numpy support of the
    compiled cloud along 8 random directions (the closed-form box support
    for box rows) within 1e-5."""
    import jax.numpy as jnp

    from c_game_engine_tpu.physics.batched import _support_toward as j_support
    from c_game_engine_tpu_torch.physics.bodies import _support_toward

    pair = hulls[0]
    jc, tc = pair.jc, pair.tc
    hv, sl = np.asarray(jc.hull_verts), np.asarray(jc.dyn_slots)
    rows = sl[sl >= 0]
    is_box = np.asarray(jc.aux["dyn_is_box"][: len(rows)])
    assert not all(is_box) and any(is_box)
    he = np.asarray(jc.halfext)[rows]
    np.testing.assert_array_equal(tc.hull_verts.numpy(), hv)
    rng = np.random.default_rng(0)
    dirs = rng.normal(size=(8, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    d = len(rows)
    for n in dirs:
        want = np.where(is_box, np.abs(n) @ he.T, (hv[rows] @ (-n)).max(axis=1))
        jz, jo = jnp.zeros((d, 1)), jnp.ones((d, 1))
        got_j = j_support(jz, jz, jz, jo, *(jnp.asarray(he[:, k:k + 1]) for k in range(3)),
                          *(jnp.full((d, 1), n[k]) for k in range(3)), verts=jnp.asarray(hv[rows]), is_box=tuple(is_box))
        tz, to = torch.zeros((d, 1)), torch.ones((d, 1))
        got_t = _support_toward(tz, tz, tz, to, *(torch.as_tensor(he[:, k:k + 1]) for k in range(3)),
                                *(torch.full((d, 1), float(n[k])) for k in range(3)),
                                verts=torch.as_tensor(hv[rows]), is_box=torch.as_tensor(is_box))
        np.testing.assert_allclose(np.asarray(got_j)[:, 0], want, atol=1e-5)
        np.testing.assert_allclose(got_t.numpy()[:, 0], want, atol=1e-5)


def test_hull_body_rest_height(hulls):
    """The r = 0.4 hull rests with its support cloud's bottom on the floor:
    y -0.6 within 0.04 + 0.02, and comes to rest, in both packages."""
    pair, rows, _ = hulls
    for side in (pair.port, pair.jax):
        y = side("actors.pos")[299, :, rows["orb"], 1]
        assert (abs(y - (-0.6)) < 0.04 + 0.02).all(), y
        assert (np.linalg.norm(side("actors.vel")[299, :, rows["orb"]], axis=-1) < 0.2).all()


def test_pushed_pair_box_box(hulls):
    """A box shoved at 3 m/s into a resting one: the target slides away
    along +x, they do not interpenetrate, neither is launched (tick 180),
    in both packages."""
    pair, rows, _ = hulls
    for side in (pair.port, pair.jax):
        pa, pb = (side("actors.pos")[179, PUSH, r] for r in rows["pair"])
        assert not np.isnan(pa).any() and not np.isnan(pb).any()
        assert pb[0] > 0.85, pb
        assert pb[0] - pa[0] > 0.35, (pa, pb)
        assert -0.9 < pa[1] < -0.6 and -0.9 < pb[1] < -0.6, (pa, pb)


def test_two_high_stack_sleeps(hulls):
    """A 2-high stack settles to sleep at the stacking heights (tick 300),
    in both packages."""
    from c_game_engine_tpu_torch.physics.batched import SLEEP_AFTER

    pair, rows, _ = hulls
    for side in (pair.port, pair.jax):
        ys = sorted(side("actors.pos")[299, STACK, i, 1] for i in rows["stack"])
        assert abs(ys[0] - (-0.8)) < 0.03, ys
        assert 0.36 < ys[1] - ys[0] < 0.44, ys
        for i in rows["stack"]:
            assert int(side("actors.sleep")[299, STACK, i]) == SLEEP_AFTER


def test_hull_mass_properties_analytic():
    """hull_mass_properties matches the analytic box, sphere and compound
    values, and the JAX function to 1e-9."""
    from c_game_engine_tpu.compiler.models import hull_mass_properties as j_hmp
    from c_game_engine_tpu_torch.compiler.models import hull_mass_properties

    a, b, c = 0.3, 0.5, 0.7
    box = np.array([[sx * a, sy * b, sz * c] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
    i = np.arange(4000) + 0.5
    phi, th, r = np.arccos(1 - 2 * i / 4000), np.pi * (1 + 5**0.5) * i, 0.5
    sph = r * np.stack([np.sin(phi) * np.cos(th), np.sin(phi) * np.sin(th), np.cos(phi)], -1)
    b1, b2 = box * 0.5 + np.array([0, 1.0, 0]), box + np.array([0, -1.0, 0])
    cases = {"box": [box + np.array([1.0, 2.0, 3.0])], "sphere": [sph], "compound": [b1, b2]}
    got = {k: hull_mass_properties(v) for k, v in cases.items()}
    for k, v in cases.items():
        for x, y in zip(got[k], j_hmp(v)):
            np.testing.assert_allclose(x, y, rtol=1e-9, atol=1e-12, err_msg=k)

    vol, com, inertia = got["box"]
    assert abs(vol - 8 * a * b * c) < 1e-9
    np.testing.assert_allclose(com, [1.0, 2.0, 3.0], atol=1e-9)
    exp = 8 * a * b * c / 3.0 * np.array([b * b + c * c, a * a + c * c, a * a + b * b])
    np.testing.assert_allclose(np.diag(inertia), exp, rtol=1e-9)
    assert np.abs(inertia - np.diag(np.diag(inertia))).max() < 1e-9
    vol, _, inertia = got["sphere"]
    np.testing.assert_allclose(np.diag(inertia) / vol, 0.4 * r * r, rtol=2e-3)
    vol, com, _ = got["compound"]
    v1, v2 = 8 * a * b * c / 8, 8 * a * b * c
    assert abs(vol - (v1 + v2)) < 1e-9
    np.testing.assert_allclose(com, [0, (v1 - v2) / (v1 + v2), 0], atol=1e-9)


def test_compiled_inertia_and_density_mass(hulls):
    """The orb hull carries the sphere's I/m = 0.4 r^2 (not the solid
    box's) and a density mass of 1000 kg/m^3 x its volume, within 2%; the
    compound's volume is the sum of its sub-hulls, not the hull of their
    union; both as the JAX resolver reads the same files."""
    from c_game_engine_tpu.compiler.models import AssetResolver as JaxResolver
    from c_game_engine_tpu_torch.compiler.models import AssetResolver, hull_mass_properties

    assets = hulls[2]
    res, jres = AssetResolver([assets]), JaxResolver(search_paths=[assets])
    orb = res.model("model/orb.gmdl")
    np.testing.assert_allclose(orb.inertia_per_mass, 0.4 * ORB_R * ORB_R, rtol=0.02)
    assert abs(orb.mass_default - 1000 * 4 / 3 * np.pi * ORB_R**3) / orb.mass_default < 0.02
    leafy = res.model("model/leafy.gmdl")
    parts = [h["points"] + h["offset"][None] for h in leafy.model.hulls]
    vol, _, _ = hull_mass_properties(parts)
    union, _, _ = hull_mass_properties([np.concatenate(parts)])
    assert abs(vol - (0.4 * 0.6 * 0.4 + 0.3**3)) < 1e-6 and union > vol + 0.01, (vol, union)
    assert abs(leafy.mass_default - 1000 * vol) < 1e-3
    for name, info in (("model/orb.gmdl", orb), ("model/leafy.gmdl", leafy)):
        j = jres.model(name)
        np.testing.assert_array_equal(np.asarray(info.inertia_per_mass), np.asarray(j.inertia_per_mass))
        assert info.mass_default == j.mass_default


def _source(tmp, name, sectors, sky=False):
    """An editor-JSON map with a player spawn in its first sector."""
    from tests.torch_map_sources import _actor_json

    pts = sectors[0]["points"]
    x, z = np.mean([p["x"] for p in pts]), np.mean([p["z"] for p in pts])
    src = {"has_sky": sky, "discord_rpc_map_name": name, "sectors": sectors,
           "actors": [_actor_json("player", (x, sectors[0]["floorHeight"] + 0.45, z))]}
    path = tmp / f"{name}.json"
    path.write_text(json.dumps(src))
    return path


def _sector(points, material, walls=None):
    from tests.torch_map_sources import _mat

    m = _mat(material, luxels=1)
    return {"points": [{"x": x, "z": z} for x, z in points], "floorHeight": 0.0, "ceilingHeight": 3.0,
            "floorMaterial": m, "ceilingMaterial": m, "wallMaterials": [walls or m] * len(points)}


def _compile_both(path, assets):
    """The port's map of an editor source and the JAX package's num_real_tris
    of the same file."""
    from c_game_engine_tpu.compiler.compile import compile_map as j_compile
    from c_game_engine_tpu_torch.compiler.compile import compile_map

    cm = compile_map(str(path), search_paths=[assets], device="cpu")
    return cm, j_compile(str(path), search_paths=[assets]).aux["num_real_tris"]


def _assert_map_runs(cm):
    """5 ticks, then a 64 x 128 frame: finite, in [0, 1]."""
    from c_game_engine_tpu_torch.core.actions import Actions
    from c_game_engine_tpu_torch.core.state import reset
    from c_game_engine_tpu_torch.core.step import step
    from c_game_engine_tpu_torch.render.bundle import build_render_bundle
    from c_game_engine_tpu_torch.render.raster import render

    st = reset(cm)
    for _ in range(5):
        st = step(cm, st, Actions.zeros(device="cpu"))
    img = render(build_render_bundle(cm), cm, st, 64, 128).numpy()
    assert np.isfinite(img).all() and img.min() >= 0.0 and img.max() <= 1.0
    return img


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    from tests.torch_map_sources import write_assets

    tmp = tmp_path_factory.mktemp("sources")
    write_assets(tmp / "assets")
    return tmp


def test_invalid_json_source_compiles(sources):
    """A self-intersecting 5-point sector: the compiler does not crash, the
    triangulation stays bounded, the map steps and renders."""
    from tests.torch_export_map import FLOOR_MAT

    path = _source(sources, "invalid", [_sector([(0, 0), (4, 4), (4, 0), (0, 4), (2, -2)], FLOOR_MAT)])
    cm, j_tris = _compile_both(path, sources / "assets")
    n = cm.aux["num_real_tris"]
    assert 0 < n <= 32, n
    assert n == j_tris
    _assert_map_runs(cm)


def test_missing_material_falls_back(sources):
    """Walls whose material resolves nowhere draw with the magenta and
    black checkerboard: over 1% of the frame is strongly magenta."""
    from tests.torch_export_map import FLOOR_MAT

    path = _source(sources, "missing_material",
                   [_sector([(-4, -4), (4, -4), (4, 4), (-4, 4)], FLOOR_MAT,
                            walls=_sector([(0, 0)], "material/no_such.gmtl")["floorMaterial"])])
    cm, j_tris = _compile_both(path, sources / "assets")
    assert cm.aux["num_real_tris"] > 0 and cm.aux["num_real_tris"] == j_tris
    img = _assert_map_runs(cm)
    mask = (img[..., 0] > 0.4) & (img[..., 2] > 0.4) & (img[..., 1] < 0.2)
    assert mask.mean() > 0.01, mask.mean()


def test_entirely_skip_compiles_and_renders(sources):
    """Every surface skipped: no map triangle, yet the map loads, ticks and
    renders."""
    from c_game_engine_tpu_torch.compiler.sectors import SKIP_MATERIAL

    path = _source(sources, "entirely_skip", [_sector([(-4, -4), (4, -4), (4, 4), (-4, 4)], SKIP_MATERIAL)])
    cm, j_tris = _compile_both(path, sources / "assets")
    assert cm.aux["num_real_tris"] == 0 == j_tris
    _assert_map_runs(cm)


@pytest.fixture(scope="module")
def app_dir(tmp_path_factory):
    from c_game_engine_tpu_torch.audio.synthetic_sounds import write_synthetic_sounds
    from c_game_engine_tpu_torch.models.sim import MAPS

    tmp = tmp_path_factory.mktemp("app")
    maps = tmp / "maps"
    maps.mkdir()
    for name, suffixes in (("arena", (".npz", ".json")), ("arena_lit", (".npz", ".json", "_bundle.npz", "_bundle.json"))):
        for suffix in suffixes:
            shutil.copy(MAPS / f"{name}{suffix}", maps / f"{name}{suffix}")
    return maps, write_synthetic_sounds(tmp / "sounds")


def _app(app_dir, initial_map):
    from c_game_engine_tpu_torch.models.game import GameApp

    maps, sounds = app_dir
    return GameApp(map_dir=maps, batch=1, initial_map=initial_map, device="cpu", synthetic_assets=True,
                   sound_dir=sounds)


def test_failed_load_recovers_to_menu(app_dir, tmp_path):
    """A map that fails to load (missing, or not a container) drops to the
    menu; the previous map loads again and draws."""
    from c_game_engine_tpu_torch.models.game import Screen

    app = _app(app_dir, "arena_lit")
    assert app.screen == Screen.IN_GAME
    app.load_level(str(tmp_path / "no_such_map.gmap"))
    assert app.screen == Screen.MENU
    bad = tmp_path / "corrupt.gmap"
    bad.write_bytes(b"not a container at all")
    app.load_level(str(bad))
    assert app.screen == Screen.MENU
    app.load_level("arena_lit")
    assert app.screen == Screen.IN_GAME
    assert np.isfinite(app.render_frame(64, 128).numpy()).all()


def test_save_data_persists_across_maps(app_dir):
    app = _app(app_dir, "arena")
    save = app.state.save
    app.state = app.state.replace(save=save.replace(coins=torch.tensor([7], dtype=save.coins.dtype),
                                                    item_mask=torch.tensor([1], dtype=save.item_mask.dtype)))
    app.load_level("arena_lit")
    assert int(app.state.save.coins[0]) == 7
    assert int(app.state.save.item_mask[0]) == 1
    assert int(app.state.tick[0]) <= 1  # world state reset


def test_physics_frame_uptime_persists(app_dir):
    """The uptime frame counter carries over a map change while the map's
    tick restarts."""
    app = _app(app_dir, "arena")
    for _ in range(5):
        app.tick()
    f0 = int(app.state.frame[0])
    assert f0 >= 5
    app.load_level("arena_lit")
    assert int(app.state.tick[0]) <= 1
    assert int(app.state.frame[0]) >= f0
