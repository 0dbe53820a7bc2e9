"""The sources of the committed maps, and one editor-JSON map, written as
asset files with numpy and the port's container writer only (no JAX), so
both packages' compilers read the same bytes:

    write_sources(directory) -> {name: path}

writes `arena.gmap`, `arena_bodies.gmap`, `arena_lit.gmap` and
`arena_orb.gmap` (the maps of tests/torch_export_map.py, built by its
builders with the port's types, PORT_KIT), `rooms.json` (`rooms_source()`, an
editor source: three sectors with a floor step and a shared doorway, two point
lights, a player spawn, a door, a coin and a physbox), `halls.json`
(`halls_source()`, a full-size editor source for the lightmap bake: a
24 x 24 grid of sectors, 8 point lights), and their assets
under `directory/assets/{model,texture,material}/`, so a plain
`AssetResolver([directory / "assets"])` answers as the export's
`stub_resolver` and `render_resolver` do: `model/cube.gmdl` is a
non-dynamic 0.2 m box (the stub's box, 64 kg), the sky cube and the orb
are the export's models, the textures its procedural ones in RGBA8, and
`material/floor.gmtl` and `material/wall.gmtl` its two materials;
STONE_MAT is not written, so the compiler takes the fallback material.

The encoders (`encode_gmap`, `encode_gmdl`, `encode_gtex`, `encode_gmtl`)
are the inverses of the port's decoders (assets/gmap.py,
assets/codecs.py), for test tooling only.

One leaf cannot come back as committed: a .gmap stores its lightmap as
RGBA16F, so arena_lit's and arena_orb's gradient lightmap comes back
rounded to float16 (`FLOAT16_LEAVES`); the committed files keep the
float32 gradient. Every other leaf of the four maps and of the two
bundles comes back bit for bit.

Where a package named `tests` is installed (the card's machine), import
this file as a top-level module with its directory on sys.path, as
tests/test_torch_cuda.py's helpers are.
"""

from __future__ import annotations

import json
import sys
import types
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
if str(_HERE) not in sys.path:
    sys.path.insert(0, str(_HERE))
if str(_HERE.parent) not in sys.path:
    sys.path.insert(0, str(_HERE.parent))

import torch_export_map as X  # noqa: E402

from c_game_engine_tpu_torch.assets import codecs  # noqa: E402
from c_game_engine_tpu_torch.assets import gmap as G  # noqa: E402
from c_game_engine_tpu_torch.assets.container import Asset, AssetType, write_asset  # noqa: E402
from c_game_engine_tpu_torch.assets.kvlist import Param, ParamType, write_kvlist, write_param  # noqa: E402
from c_game_engine_tpu_torch.assets.reader import Writer  # noqa: E402

MAPS = ("arena", "arena_bodies", "arena_lit", "arena_orb")
RENDER_MAPS = ("arena_lit", "arena_orb")
# leaves whose written source holds them as float16: (map or bundle, leaf)
FLOAT16_LEAVES = {("arena_lit", "lightmap"), ("arena_orb", "lightmap"),
                  ("arena_lit_bundle", "lightmap"), ("arena_orb_bundle", "lightmap")}
CUBE_MODEL = "model/cube.gmdl"
CUBE_HALF = 0.2
CUBE_TEX = "texture/crate.gtex"


def _actor(cls, pos=(0, 0, 0), rot=(0, 0, 0), params=None, connections=()):
    conns = [G.MapConnection(o, tn, ti, po if po is not None else Param.none(), 0)
             for (o, tn, ti, po) in connections]
    return G.MapActor(cls, np.asarray(pos, np.float32), np.asarray(rot, np.float32), conns, params or {})


PORT_KIT = types.SimpleNamespace(
    actor=_actor,
    P_bool=lambda v: Param(ParamType.BOOL, bool(v)),
    P_int=lambda v: Param(ParamType.INTEGER, int(v)),
    P_float=lambda v: Param(ParamType.FLOAT, float(v)),
    P_byte=lambda v: Param(ParamType.BYTE, int(v)),
    P_str=lambda v: Param(ParamType.STRING, str(v)),
    P_vec2=lambda x, y: Param(ParamType.VEC2, (float(x), float(y))),
    P_color=lambda r, g, b, a=1.0: Param(ParamType.COLOR, (float(r), float(g), float(b), float(a))),
    GMap=G.GMap, MapCollisionMesh=G.MapCollisionMesh, MapModel=G.MapModel,
    Model=codecs.Model, ModelLod=codecs.ModelLod, CollisionModelType=codecs.CollisionModelType,
    ModelShader=codecs.ModelShader,
)


# ------------------------------------------------------------------ encoders


def _floats(w: Writer, values):
    for v in np.asarray(values, np.float32).reshape(-1):
        w.f32(float(v))


def encode_gmap(gm, path) -> None:
    """The inverse of assets/gmap.py::decode_gmap (MapLoader.c:40-313); the
    player spawn is written as the first actor, of class "player"."""
    w = Writer()
    w.u8(1 if gm.render_sky else 0)
    if gm.render_sky:
        w.string(gm.sky_texture)
    w.string(gm.discord_icon).string(gm.discord_name)
    actors = ([gm.player_spawn] if gm.player_spawn is not None else []) + list(gm.actors)
    w.u64(len(actors))
    for a in actors:
        w.string(a.actor_class)
        _floats(w, a.position)
        _floats(w, a.rotation_euler)
        w.u64(len(a.connections))
        for c in a.connections:
            w.string(c.output).string(c.target_name).string(c.target_input)
            override = c.param_override is not None and c.param_override.type != ParamType.NONE
            w.u8(1 if override else 0)
            if override:
                write_param(w, c.param_override)
            w.u64(int(c.num_refires))
        write_kvlist(w, a.params)
    w.u64(len(gm.models))
    for m in gm.models:
        w.string(m.material)
        verts = np.ascontiguousarray(m.vertices, np.float32).reshape(-1, 7)
        w.u32(len(verts)).raw(verts.tobytes())
        idx = np.ascontiguousarray(m.indices, np.uint32).reshape(-1)
        w.u32(len(idx)).raw(idx.tobytes())
    w.u64(len(gm.collision))
    for mesh in gm.collision:
        _floats(w, mesh.origin)
        w.u64(len(mesh.sub_tris))
        for tris in mesh.sub_tris:
            tris = np.ascontiguousarray(tris, np.float32).reshape(-1, 3, 3)
            w.u64(len(tris)).raw(tris.tobytes())
    lm = np.asarray(gm.lightmap, np.float32)
    w.u64(lm.shape[1]).u64(lm.shape[0]).raw(lm.astype(np.float16).tobytes())
    lights = np.asarray(gm.point_lights, np.float32).reshape(-1, 9)
    w.u16(len(lights))
    _floats(w, lights)
    write_asset(path, Asset(AssetType.MAP, 1, w.getvalue()))


def encode_gmdl(model, path) -> None:
    """The inverse of assets/codecs.py::decode_gmdl (ModelLoader.c:34-217)."""
    w = Writer()
    skins = np.asarray(model.skins, np.uint32)
    n_slots = skins.shape[1] if skins.ndim == 2 else len(model.lods[0].indices)
    w.u32(len(model.materials)).u32(n_slots).u32(len(skins)).u32(len(model.lods)).u8(int(model.collision_type))
    for mat in model.materials:
        w.string(mat["texture"])
        _floats(w, mat["color"])
        w.u32(int(mat["shader"]))
    for v in skins.reshape(-1):
        w.u32(int(v))
    for lod in model.lods:
        w.f32(float(np.sqrt(lod.distance_squared))).f32(lod.distance_squared)
        verts = np.ascontiguousarray(lod.vertices, np.float32).reshape(-1, 12)
        w.u64(len(verts)).raw(verts.tobytes())
        w.u32(sum(len(i) for i in lod.indices))
        for idx in lod.indices:
            w.u32(len(idx))
        for idx in lod.indices:
            w.raw(np.ascontiguousarray(idx, np.uint32).tobytes())
    _floats(w, model.aabb_origin)
    _floats(w, model.aabb_extents)
    if int(model.collision_type) == int(codecs.CollisionModelType.DYNAMIC):
        w.u64(len(model.hulls))
        for h in model.hulls:
            pts = np.ascontiguousarray(h["points"], np.float32).reshape(-1, 3)
            w.u64(len(pts))
            _floats(w, h["offset"])
            w.raw(pts.tobytes())
    elif int(model.collision_type) == int(codecs.CollisionModelType.STATIC):
        tris = np.ascontiguousarray(model.static_tris, np.float32).reshape(-1, 3, 3)
        w.u64(len(tris)).raw(tris.tobytes())
    write_asset(path, Asset(AssetType.MODEL, 1, w.getvalue()))


def encode_gtex(pixels, path, filter=True, repeat=True, mipmaps=False) -> None:
    """An RGBA8 texture (TextureLoader.c:70-140): `pixels` [H, W, 4] in
    [0, 1], rounded to 8 bits in their own dtype, as
    tests/torch_export_map.py::_q8 rounds them."""
    px = np.round(np.clip(np.asarray(pixels), 0.0, 1.0) * 255.0).astype(np.uint8)
    w = Writer()
    w.u64(px.shape[1]).u64(px.shape[0]).u8(int(filter)).u8(int(repeat)).u8(int(mipmaps)).u8(0)
    w.raw(np.ascontiguousarray(px).tobytes())
    write_asset(path, Asset(AssetType.TEXTURE, 1, w.getvalue()))


def encode_gmtl(texture, shader, sound_class, path, uv_scale=(1.0, 1.0)) -> None:
    """The inverse of assets/codecs.py::decode_gmtl (MapMaterialLoader.c)."""
    w = Writer()
    w.string(texture).f32(uv_scale[0]).f32(uv_scale[1]).u8(int(shader)).u8(int(sound_class))
    write_asset(path, Asset(AssetType.MAP_MATERIAL, 1, w.getvalue()))


# ------------------------------------------------------------------- assets


def cube_model():
    """The physbox model: a non-dynamic box of half extent CUBE_HALF (its
    collision shape is the AABB box: 0.2 m and 1000 kg/m^3 x 0.064 m^3),
    with one LOD of 12 triangles textured CUBE_TEX."""
    verts, idx = [], []
    for axis in range(3):
        for sign in (-1.0, 1.0):
            u_ax, v_ax = [a for a in range(3) if a != axis]
            base = len(verts)
            for a, b in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                p = np.zeros(3)
                p[axis], p[u_ax], p[v_ax] = sign * CUBE_HALF, a * CUBE_HALF, b * CUBE_HALF
                n = np.zeros(3)
                n[axis] = sign
                verts.append([*p, (a + 1) / 2, (b + 1) / 2, 1.0, 1.0, 1.0, 1.0, *n])
            quad = [base, base + 1, base + 2, base, base + 2, base + 3]
            idx += quad if sign > 0 else quad[::-1]
    lod = codecs.ModelLod(0.0, np.asarray(verts, np.float32), [np.asarray(idx, np.uint32)])
    return codecs.Model(
        materials=[{"texture": CUBE_TEX, "color": np.ones(4, np.float32), "shader": codecs.ModelShader.SHADED}],
        skins=np.zeros((1, 1), np.uint32), lods=[lod], aabb_origin=np.zeros(3, np.float32),
        aabb_extents=np.full(3, CUBE_HALF, np.float32), collision_type=codecs.CollisionModelType.NONE)


def _crate_pixels():
    yy, xx = np.mgrid[0:16, 0:16].astype(np.float32)
    edge = (np.minimum(np.minimum(xx, 15 - xx), np.minimum(yy, 15 - yy)) < 2)[..., None]
    return np.concatenate([np.where(edge, 0.35, 0.7), np.where(edge, 0.2, 0.5), np.where(edge, 0.1, 0.25),
                           np.ones((16, 16, 1))], -1)


def write_assets(assets: Path) -> None:
    """The models, textures and materials the maps name, under `assets`."""
    for sub in ("model", "texture/actor", "material"):
        (assets / sub).mkdir(parents=True, exist_ok=True)
    for name, (px, repeat, filt, mips) in X._texture_pixels().items():
        encode_gtex(px, assets / name, filter=filt, repeat=repeat, mipmaps=mips)
    encode_gtex(_crate_pixels(), assets / CUBE_TEX, filter=False, repeat=True, mipmaps=True)
    encode_gmtl("texture/floor.gtex", codecs.ModelShader.SHADED, 0, assets / X.FLOOR_MAT)
    encode_gmtl("texture/wall.gtex", codecs.ModelShader.UNSHADED, 0, assets / X.WALL_MAT)
    encode_gmdl(X._sky_model(PORT_KIT), assets / "model/sky.gmdl")
    encode_gmdl(X._orb_model(PORT_KIT), assets / X.ORB_MODEL)
    encode_gmdl(cube_model(), assets / CUBE_MODEL)


# ----------------------------------------------------------------- the maps


def arena_gmaps() -> dict:
    """The four maps' GMaps in the port's types, as tests/torch_export_map.py
    builds them (its lightmap in float32)."""
    k = PORT_KIT
    render = dict(render_sky=True, sky_texture=X.SKY_TEX, models=X.arena_render_models(k),
                  lightmap=X.arena_lightmap())
    return {
        "arena": X._arena_gmap(X.arena_actors(k), k),
        "arena_bodies": X._arena_gmap(X.arena_actors(k) + X.body_actors(k), k),
        "arena_lit": X._arena_gmap(X.arena_actors(k), k, **render),
        "arena_orb": X._arena_gmap(X.arena_actors(k) + [X.orb_actor(k)], k, **render),
    }


def _p(kind, value):
    return {"type": kind, "value": value}


def _mat(material, scale=(0.5, 0.5), luxels=4):
    return {"material": material, "uvScale": {"x": scale[0], "y": scale[1]}, "uvOffset": {"x": 0.0, "y": 0.0},
            "luxels_per_unit": luxels}


def _sector(points, floor, ceiling, walls):
    return {"points": [{"x": x, "z": z} for x, z in points], "floorHeight": floor, "ceilingHeight": ceiling,
            "floorMaterial": _mat(X.FLOOR_MAT), "ceilingMaterial": _mat(X.STONE_MAT),
            "wallMaterials": walls}


def _actor_json(cls, pos, rot=(0.0, 0.0, 0.0), params=None, connections=()):
    return {"class": cls, "position": dict(zip("xyz", map(float, pos))),
            "rotation": dict(zip("xyz", map(float, rot))), "params": params or {},
            "connections": [{"sourceOutput": o, "targetName": t, "targetInput": i, "overridesParam": False,
                             "numRefires": 0} for o, t, i in connections]}


def rooms_source() -> dict:
    """The editor-JSON map: room A (x -6..0, floor 0) and room C (x 2..8,
    floor 0.4) joined by a corridor B (x 0..2, z -1..1, floor 0.2, ceiling
    2.4) whose end edges each room shares, so the walls there keep only the
    step and the lintel; two point lights, one in each room, so the
    corridor's walls shadow part of each room; a player spawn in A facing
    the corridor; a door across the corridor, opened by a trigger; a coin
    on the way and a physbox in C. Lightmap at 4 luxels a metre."""
    wall, stone = _mat(X.WALL_MAT, (0.25, 0.5)), _mat(X.STONE_MAT)
    sectors = [
        _sector([(-6, -4), (0, -4), (0, -1), (0, 1), (0, 4), (-6, 4)], 0.0, 3.0, [wall, wall, stone, wall, wall, wall]),
        _sector([(0, -1), (2, -1), (2, 1), (0, 1)], 0.2, 2.4, [stone]),
        _sector([(2, -4), (8, -4), (8, 4), (2, 4), (2, 1), (2, -1)], 0.4, 3.2, [wall, wall, wall, wall, stone, wall]),
    ]
    light = lambda pos, rgb, brightness: _actor_json("light_point", pos, params={
        "color": _p("color", dict(zip("rgba", (*rgb, 1.0)))), "brightness": _p("float", brightness),
        "range": _p("float", 9.0), "attenuation": _p("float", 1.0)})
    actors = [
        _actor_json("player", (-4.0, 0.45, 0.3), (0.0, -np.pi / 2, 0.0)),
        light((-3.0, 2.5, 1.5), (1.0, 0.9, 0.7), 2.0),
        light((5.0, 2.8, -2.0), (0.6, 0.8, 1.0), 3.0),
        _actor_json("prop_coin", (-2.0, 0.5, 0.3), params={"isBlue": _p("bool", False)},
                    connections=[("collected", "count1", "increment")]),
        _actor_json("trigger", (-0.8, 1.0, 0.0), params={
            "width": _p("float", 1.0), "height": _p("float", 2.0), "depth": _p("float", 2.0),
            "oneShot": _p("bool", True)}, connections=[("entered", "door1", "open")]),
        _actor_json("prop_door", (1.0, 1.2, 0.0), (0.0, 0.0, 0.0), params={
            "name": _p("string", "door1"), "size": _p("vec2", {"x": 2.0, "y": 2.0}),
            "preventPlayerOpen": _p("bool", True)}),
        _actor_json("logic_counter", (0.0, 0.0, 0.0), params={
            "name": _p("string", "count1"), "min": _p("int", 0), "max": _p("int", 1)}),
        _actor_json("prop_physbox", (4.0, 0.65, 0.5)),
    ]
    return {"has_sky": True, "sky_texture": X.SKY_TEX, "discord_rpc_map_name": "rooms", "sectors": sectors,
            "actors": actors}


def halls_source(n: int = 24, lights: int = 8) -> dict:
    """A full-size editor-JSON map for the lightmap bake: an n x n grid of
    square sectors 2 m wide, about one in eight left out as a
    solid block, each with its own floor (0-0.6 m) and ceiling height, so
    most shared edges keep a step or a lintel and every block a full wall;
    `lights` point lights under the ceilings, a player spawn, 4 luxels a
    metre. At the defaults: 514 sectors, 2,749 lit surfaces, 5,498
    occluders, 117,512 luxels (four samples each). Made from seed 0."""
    rng = np.random.default_rng(0)
    cell = 2.0
    wall, stone, floor = _mat(X.WALL_MAT, (0.25, 0.5)), _mat(X.STONE_MAT), _mat(X.FLOOR_MAT)
    open_ = rng.random((n, n)) >= 0.125
    fh = rng.choice([0.0, 0.2, 0.4, 0.6], (n, n))
    ch = fh + rng.choice([2.4, 2.8, 3.2], (n, n))
    x0 = -0.5 * n * cell
    sectors, cells = [], []
    for i in range(n):
        for j in range(n):
            if not open_[i, j]:
                continue
            xa, za = x0 + i * cell, x0 + j * cell
            pts = [(xa, za), (xa + cell, za), (xa + cell, za + cell), (xa, za + cell)]
            sectors.append({"points": [{"x": x, "z": z} for x, z in pts], "floorHeight": float(fh[i, j]),
                            "ceilingHeight": float(ch[i, j]), "floorMaterial": floor, "ceilingMaterial": stone,
                            "wallMaterials": [wall, stone, wall, stone]})
            cells.append((xa + 0.5 * cell, za + 0.5 * cell, fh[i, j], ch[i, j]))
    pick = rng.choice(len(cells), lights + 1, replace=False)
    actors = [_actor_json("player", (cells[pick[0]][0], cells[pick[0]][2] + 0.45, cells[pick[0]][1]))]
    for k in pick[1:]:
        x, z, _, c = cells[k]
        actors.append(_actor_json("light_point", (x, c - 0.3, z), params={
            "color": _p("color", dict(zip("rgba", (*rng.uniform(0.5, 1.0, 3), 1.0)))),
            "brightness": _p("float", float(rng.uniform(2.0, 4.0))), "range": _p("float", 12.0),
            "attenuation": _p("float", 1.0)}))
    return {"has_sky": False, "discord_rpc_map_name": "halls", "sectors": sectors, "actors": actors}


def write_sources(directory) -> dict:
    """Write the four maps as .gmap files, the editor sources as rooms.json
    and halls.json and their assets under `directory`; returns {name:
    path} with "assets", the search path to compile them with."""
    directory = Path(directory)
    write_assets(directory / "assets")
    out = {"assets": directory / "assets"}
    for name, gm in arena_gmaps().items():
        out[name] = directory / f"{name}.gmap"
        encode_gmap(gm, out[name])
    out["rooms"] = directory / "rooms.json"
    out["rooms"].write_text(json.dumps(rooms_source(), indent=1) + "\n")
    out["halls"] = directory / "halls.json"
    out["halls"].write_text(json.dumps(halls_source()) + "\n")
    return out
