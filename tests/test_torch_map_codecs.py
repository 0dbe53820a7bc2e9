"""The port's map and model codecs and the compiler's host helpers against
the JAX package, on files written by tests/torch_map_sources.py's encoders
(the port's container writer): `decode_gmap`, `decode_gmdl` and
`decode_gmtl` field by field, a wrong asset type raising in both,
`compiler/models.py` (support clouds, hull mass properties, box and
cylinder clouds, the resolver's model, texture and material answers and
their fallbacks), `edge_active_flags`, `build_grid`, and the compiler's
name tables. Everything bit for bit."""

from __future__ import annotations

import numpy as np
import pytest

from tests import torch_map_sources as S


def _hull_model():
    """A dynamic model of two offset hulls (a box and a random cloud), two
    LODs of two material slots and two skins."""
    from c_game_engine_tpu_torch.assets import codecs

    rng = np.random.default_rng(7)
    lods = []
    for k, n in ((0, 9), (1, 6)):
        verts = rng.normal(size=(n, 12)).astype(np.float32)
        lods.append(codecs.ModelLod(float(4.0 ** k) if k else 0.0, verts,
                                    [np.arange(3 * k, 3 * k + 3, dtype=np.uint32), np.arange(3, dtype=np.uint32)]))
    box = np.array([(x, y, z) for x in (-0.3, 0.3) for y in (-0.1, 0.5) for z in (-0.2, 0.2)], np.float32)
    return codecs.Model(
        materials=[{"texture": "texture/a.gtex", "color": np.array([1.0, 0.5, 0.25, 1.0], np.float32),
                    "shader": codecs.ModelShader.SHADED},
                   {"texture": "texture/b.gtex", "color": np.ones(4, np.float32), "shader": codecs.ModelShader.UNSHADED}],
        skins=np.array([[0, 1], [1, 0]], np.uint32), lods=lods,
        aabb_origin=np.array([0.0, 0.2, 0.0], np.float32), aabb_extents=np.array([0.3, 0.3, 0.2], np.float32),
        collision_type=codecs.CollisionModelType.DYNAMIC,
        hulls=[{"offset": np.zeros(3, np.float32), "points": box},
               {"offset": np.array([0.0, 0.6, 0.1], np.float32), "points": rng.normal(size=(40, 3)).astype(np.float32) * 0.1}])


def _static_model():
    from c_game_engine_tpu_torch.assets import codecs

    m = S.cube_model()
    m.collision_type = codecs.CollisionModelType.STATIC
    m.static_tris = np.random.default_rng(8).normal(size=(5, 3, 3)).astype(np.float32)
    return m


def _same(a, b, name):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), name
        for k in a:
            _same(a[k], b[k], f"{name}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), name
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{name}[{i}]")
    elif hasattr(a, "__dataclass_fields__"):
        for f in a.__dataclass_fields__:
            _same(getattr(a, f), getattr(b, f), f"{name}.{f}")
    elif hasattr(a, "type") and hasattr(a, "value"):  # kvlist Param
        assert int(a.type) == int(b.type), name
        _same(a.value, b.value, f"{name}.value")
    elif hasattr(a, "__int__") and not isinstance(a, float):
        assert int(a) == int(b), name
    else:
        assert a == b, name


def test_decode_gmap_matches_jax(tmp_path):
    """arena_lit's source with two point lights and a connection carrying a
    colour override: every field equal, the lightmap as float16 values."""
    from c_game_engine_tpu.assets.gmap import decode_gmap as j_decode
    from c_game_engine_tpu_torch.assets.gmap import decode_gmap
    from c_game_engine_tpu_torch.assets.kvlist import Param, ParamType

    gm = S.arena_gmaps()["arena_lit"]
    gm.point_lights = np.array([[1, 2, 3, 1, 0.5, 0.25, 2, 9, 1], [-4, 1, 0, 0.2, 0.4, 0.8, 1, 5, 2]], np.float32)
    gm.actors[0].connections.append(S.G.MapConnection("collected", "light1", "set_color",
                                                      Param(ParamType.COLOR, (0.5, 0.25, 1.0, 1.0)), 3))
    path = tmp_path / "m.gmap"
    S.encode_gmap(gm, path)
    mine, theirs = decode_gmap(path), j_decode(path)
    _same(mine, theirs, "gmap")
    assert mine.player_spawn.actor_class == "player" and len(mine.actors) == len(gm.actors)
    np.testing.assert_array_equal(mine.lightmap, gm.lightmap.astype(np.float16).astype(np.float32))
    np.testing.assert_array_equal(mine.all_collision_tris(), theirs.all_collision_tris())
    assert mine.actors[0].connections[-1].param_override.type == ParamType.COLOR


@pytest.mark.parametrize("kind", ["cube", "hulls", "static", "orb_sky"])
def test_decode_gmdl_matches_jax(tmp_path, kind):
    from c_game_engine_tpu.assets.codecs import decode_gmdl as j_decode
    from c_game_engine_tpu_torch.assets.codecs import decode_gmdl

    model = {"cube": S.cube_model, "hulls": _hull_model, "static": _static_model,
             "orb_sky": lambda: S.X._sky_model(S.PORT_KIT)}[kind]()
    path = tmp_path / "m.gmdl"
    S.encode_gmdl(model, path)
    mine, theirs = decode_gmdl(path), j_decode(path)
    _same(mine, theirs, kind)
    assert int(mine.collision_type) == int(model.collision_type) and len(mine.lods) == len(model.lods)
    np.testing.assert_array_equal(mine.lods[0].vertices, model.lods[0].vertices)


def test_decode_gmtl_matches_jax(tmp_path):
    from c_game_engine_tpu.assets.codecs import decode_gmtl as j_decode
    from c_game_engine_tpu_torch.assets.codecs import ModelShader, decode_gmtl

    path = tmp_path / "m.gmtl"
    S.encode_gmtl("texture/floor.gtex", ModelShader.UNSHADED, 3, path, uv_scale=(0.5, 2.0))
    mine, theirs = decode_gmtl(path), j_decode(path)
    assert (mine.texture, int(mine.shader), mine.sound_class) == (theirs.texture, int(theirs.shader),
                                                                  theirs.sound_class) == ("texture/floor.gtex", 2, 3)


@pytest.mark.parametrize("decoder", ["decode_gmap", "decode_gmdl", "decode_gmtl"])
def test_wrong_asset_type_raises(tmp_path, decoder):
    import c_game_engine_tpu.assets.codecs as jc
    import c_game_engine_tpu.assets.gmap as jg
    from c_game_engine_tpu.assets.reader import PayloadError as JPayloadError
    from c_game_engine_tpu_torch.assets import codecs, gmap
    from c_game_engine_tpu_torch.assets.reader import PayloadError

    path = tmp_path / "t.gtex"
    S.encode_gtex(np.ones((2, 2, 4)), path)
    mine = getattr(gmap if decoder == "decode_gmap" else codecs, decoder)
    theirs = getattr(jg if decoder == "decode_gmap" else jc, decoder)
    with pytest.raises(PayloadError, match="not a"):
        mine(path)
    with pytest.raises(JPayloadError, match="not a"):
        theirs(path)


def test_model_helpers_match_jax():
    """support_cloud (a cloud over the direction budget, one under it and a
    flat one), hull_mass_properties, box_corners, cylinder_cloud."""
    import c_game_engine_tpu.compiler.models as J
    import c_game_engine_tpu_torch.compiler.models as T

    rng = np.random.default_rng(3)
    for pts in (rng.normal(size=(300, 3)), rng.normal(size=(12, 3)), np.c_[rng.normal(size=(30, 2)), np.zeros(30)]):
        _same(T.support_cloud(pts), J.support_cloud(pts), "support_cloud")
    sets = [rng.normal(size=(50, 3)), rng.normal(size=(20, 3)) + 1.0]
    for a, b in zip(T.hull_mass_properties(sets), J.hull_mass_properties(sets)):
        _same(np.asarray(a), np.asarray(b), "hull_mass_properties")
    _same(T.box_corners(np.array([0.1, 0.2, 0.3])), J.box_corners(np.array([0.1, 0.2, 0.3])), "box_corners")
    _same(T.cylinder_cloud(0.25, 0.5), J.cylinder_cloud(0.25, 0.5), "cylinder_cloud")
    _same(T._SUPPORT_DIRS, J._SUPPORT_DIRS, "support dirs")


def test_resolver_matches_jax(tmp_path):
    """AssetResolver.model of a hull model, of the cube and of a missing
    model (the error-model fallback), texture() of a written and of a
    missing texture (the checkerboard), material() of a written and of a
    missing material: the same answers in both packages."""
    from c_game_engine_tpu.compiler.models import AssetResolver as JResolver
    from c_game_engine_tpu_torch.compiler.models import AssetResolver

    assets = tmp_path / "assets"
    S.write_assets(assets)
    S.encode_gmdl(_hull_model(), assets / "model/hulls.gmdl")
    S.encode_gmdl(S.cube_model(), assets / "model/error.gmdl")
    mine, theirs = AssetResolver([assets]), JResolver([assets])
    for rel in ("model/hulls.gmdl", S.CUBE_MODEL, "model/missing.gmdl"):
        a, b = mine.model(rel), theirs.model(rel)
        for f in ("box_halfext", "box_center", "hull_verts", "inertia_per_mass"):
            _same(getattr(a, f), getattr(b, f), f"{rel}.{f}")
        assert a.mass_default == b.mass_default and a.name == b.name == rel
        assert mine.model(rel) is a  # cached
    cube = mine.model(S.CUBE_MODEL)
    assert cube.hull_verts is None and np.all(cube.box_halfext == np.float32(0.2))
    assert mine.model("model/hulls.gmdl").hull_verts.shape[1] == 3
    for rel in ("texture/floor.gtex", "texture/none.gtex"):
        _same(mine.texture(rel), theirs.texture(rel), rel)
    assert mine.texture("texture/none.gtex").width == 64  # the checkerboard
    assert (mine.material(S.X.FLOOR_MAT).texture, int(mine.material(S.X.FLOOR_MAT).shader)) == (
        theirs.material(S.X.FLOOR_MAT).texture, int(theirs.material(S.X.FLOOR_MAT).shader))
    assert mine.material(S.X.STONE_MAT) is None and theirs.material(S.X.STONE_MAT) is None


def test_edges_and_grid_match_jax():
    """edge_active_flags and build_grid over arena_bodies' soup (a body
    margin above the default inflation) and over an empty soup."""
    from c_game_engine_tpu.compiler.broadphase import build_grid as j_grid
    from c_game_engine_tpu.compiler.edges import edge_active_flags as j_edges
    from c_game_engine_tpu_torch.compiler.broadphase import build_grid
    from c_game_engine_tpu_torch.compiler.edges import edge_active_flags

    tris = S.X.arena_tris()
    valid = np.ones(len(tris), bool)
    valid[::97] = False
    _same(edge_active_flags(tris, valid), j_edges(tris, valid), "edges")
    for inflate in (0.5, 1.9):
        a, b = build_grid(tris, valid, inflate), j_grid(tris, valid, inflate)
        _same(a, b, f"grid {inflate}")
    _same(build_grid(tris, np.zeros(len(tris), bool)), j_grid(tris, np.zeros(len(tris), bool)), "empty grid")


def test_compiler_name_tables_match_jax():
    import c_game_engine_tpu.actors.defs as J
    import c_game_engine_tpu_torch.actors.defs as T

    assert {k: int(v) for k, v in T.CLASS_NAMES.items()} == {k: int(v) for k, v in J.CLASS_NAMES.items()}
    assert T.COMPILE_TIME_CLASSES == J.COMPILE_TIME_CLASSES
    assert {k: int(v) for k, v in T.INPUT_NAMES.items()} == {k: int(v) for k, v in J.INPUT_NAMES.items()}
    assert {k: int(v) for k, v in T.OUTPUT_NAMES.items()} == {k: int(v) for k, v in J.OUTPUT_NAMES.items()}
    assert {int(k): sorted(map(int, v)) for k, v in T.CLASS_INPUTS.items()} == {
        int(k): sorted(map(int, v)) for k, v in J.CLASS_INPUTS.items()}
