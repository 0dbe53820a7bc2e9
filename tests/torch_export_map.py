"""Build the asset-free `arena`, `arena_bodies`, `arena_lit` and
`arena_orb` maps with the JAX compiler and export them as plain numpy/JSON
files that the PyTorch port (`c_game_engine_tpu_torch`) loads without JAX.

Usage (from the repo root, on the CPU):

    JAX_PLATFORMS=cpu python tests/torch_export_map.py [name ...]

writes `c_game_engine_tpu_torch/maps/<name>.npz` (every array leaf of the
CompiledMap) and `<name>.json` (its `aux` dict, minus the AssetResolver)
for the named maps (all by default); for `arena_lit` and `arena_orb` also
`<name>_bundle.npz` and `<name>_bundle.json` (the JAX RenderBundle's
array leaves and static fields), and a summary of what the sweep frames
hand the raster kernel (render_summary).

The arena is a 48 x 48 m floor tessellated into 1 m cells, with a stair
run of 0.2 m risers up to a 0.8 m terrace, one ramp back down (the only
tilted triangles of the map), and tessellated perimeter walls. Flat parts
are exactly flat: a tilted triangle's extended plane is where the
per-block candidate set of the capsule-resolve kernel can read a far
triangle as a deep contact, so the map keeps those to the ramp.

`arena_bodies` is the arena plus 13 dynamic bodies: a 3-box and a 4-box
physbox stack on the flat floor, 3 physboxes dropped on the ramp, 2
`npc_john` cylinders (vertex-cloud hulls) on the terrace, and 1 physbox
1.7 m ahead of the spawn on the path the bench.py stream (hold W, turn 0.01
rad per tick) walks the player along: near tick 13 the player steps up onto
it and rides it, pushing it along (a stream that looks down can pick it up
instead, tests/test_torch_bodies.py). Physboxes need `model/cube.gmdl`,
which is not in this checkout: `StubResolver` stands in for it.

`arena_lit` is the arena (same collision mesh and actors) with render
content: see the arena_lit section below. `arena_orb` is arena_lit plus
an 81,920-triangle model (the arena_orb section).
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

MAP_DIR = REPO / "c_game_engine_tpu_torch" / "maps"

HALF = 24  # arena half extent in cells of 1 m
WALL_H = 3.0
SPAWN = (9.0, 0.45, -2.0)  # capsule centre at rest height on the y=0 floor
# the stair run climbs +x inside the band z in [STAIR_Z0, STAIR_Z1)
STAIR_Z0, STAIR_Z1 = -4, 0
STAIR_X0 = 10
STEP = 0.2
TERRACE = (14, 20, -10, 6)  # x0, x1, z0, z1 (cells) at 0.8 m
RAMP = (14, 18, 6, 10)  # descends from 0.8 m at z=6 to 0 at z=10


def _corner_heights():
    """[2H, 2H, 4] heights of each cell's corners (x0z0, x1z0, x1z1, x0z1)."""
    n = 2 * HALF
    h = np.zeros((n, n, 4), np.float64)
    for i in range(n):
        x = i - HALF
        for j in range(n):
            z = j - HALF
            if STAIR_Z0 <= z < STAIR_Z1 and STAIR_X0 <= x < STAIR_X0 + 4:
                h[i, j] = STEP * (x - STAIR_X0 + 1)
            if TERRACE[0] <= x < TERRACE[1] and TERRACE[2] <= z < TERRACE[3]:
                h[i, j] = 4 * STEP
            if RAMP[0] <= x < RAMP[1] and RAMP[2] <= z < RAMP[3]:
                top = 4 * STEP
                span = RAMP[3] - RAMP[2]
                h0 = top * (RAMP[3] - z) / span
                h1 = top * (RAMP[3] - z - 1) / span
                h[i, j] = [h0, h0, h1, h1]
    return h


def _riser(tris, p0, p1, lo, hi):
    """Vertical wall over edge p0 -> p1 (XZ) between heights lo and hi
    (pairs, one per end); zero-area halves are left out."""
    (x0, z0), (x1, z1) = p0, p1
    a = (x0, lo[0], z0)
    b = (x1, lo[1], z1)
    c = (x1, hi[1], z1)
    d = (x0, hi[0], z0)
    if hi[1] > lo[1]:
        tris.append([a, b, c])
    if hi[0] > lo[0]:
        tris.append([a, c, d])


def arena_tris() -> np.ndarray:
    h = _corner_heights()
    n = 2 * HALF
    tris = []
    for i in range(n):
        x0, x1 = i - HALF, i - HALF + 1
        for j in range(n):
            z0, z1 = j - HALF, j - HALF + 1
            c = h[i, j]
            p00, p10 = (x0, c[0], z0), (x1, c[1], z0)
            p11, p01 = (x1, c[2], z1), (x0, c[3], z1)
            # ccw seen from above: the face normal points up
            tris.append([p00, p01, p11])
            tris.append([p00, p11, p10])
            # risers to the +x and +z neighbours where heights differ
            if i + 1 < n:
                o = h[i + 1, j]
                mine, theirs = (c[1], c[2]), (o[0], o[3])
                lo = tuple(min(a, b) for a, b in zip(mine, theirs))
                hi = tuple(max(a, b) for a, b in zip(mine, theirs))
                _riser(tris, (x1, z0), (x1, z1), lo, hi)
            if j + 1 < n:
                o = h[i, j + 1]
                mine, theirs = (c[3], c[2]), (o[0], o[1])
                lo = tuple(min(a, b) for a, b in zip(mine, theirs))
                hi = tuple(max(a, b) for a, b in zip(mine, theirs))
                _riser(tris, (x0, z1), (x1, z1), lo, hi)
    # perimeter walls in 1 m panels
    for k in range(-HALF, HALF):
        for (p0, p1) in (
            ((k, -HALF), (k + 1, -HALF)),
            ((k + 1, HALF), (k, HALF)),
            ((-HALF, k + 1), (-HALF, k)),
            ((HALF, k), (HALF, k + 1)),
        ):
            _riser(tris, p0, p1, (0.0, 0.0), (WALL_H, WALL_H))
    return np.asarray(tris, np.float32)


def _kit(kit):
    """The constructors the map builders below use: `tests/worldgen.py`
    (the JAX package's GMap, Param and Model types) by default, or a
    namespace with the same names (tests/torch_map_sources.py::PORT_KIT,
    the port's types, which writes the maps' sources without JAX)."""
    if kit is None:
        import types

        import tests.worldgen as wg
        from c_game_engine_tpu.assets.codecs import CollisionModelType, Model, ModelLod, ModelShader
        from c_game_engine_tpu.assets.gmap import MapModel

        kit = types.SimpleNamespace(**vars(wg), MapModel=MapModel, Model=Model, ModelLod=ModelLod,
                                    CollisionModelType=CollisionModelType, ModelShader=ModelShader)
    return kit


def arena_actors(kit=None):
    k = _kit(kit)
    P_bool, P_color, P_float, P_int, P_str, P_vec2, actor = (k.P_bool, k.P_color, k.P_float, k.P_int, k.P_str,
                                                             k.P_vec2, k.actor)

    sx, _, sz = SPAWN
    return [
        actor("prop_coin", (sx, 0.5, sz - 1.0), params={"isBlue": P_bool(False)},
              connections=[("collected", "count1", "increment", None)]),
        actor("prop_coin", (sx - 1.5, 0.5, sz - 9.0), params={"isBlue": P_bool(True)},
              connections=[("collected", "count1", "increment", None)]),
        actor("prop_coin", (-6.0, 0.5, -10.0), params={"isBlue": P_bool(False)}),
        actor(
            "trigger",
            (sx, 0.5, sz - 2.5),
            params={
                "width": P_float(1.0),
                "height": P_float(2.0),
                "depth": P_float(1.0),
                "oneShot": P_bool(False),
                "name": P_str("trig1"),
            },
            connections=[
                ("entered", "door1", "open", None),
                ("entered", "snd1", "play", None),
            ],
        ),
        actor(
            "prop_door",
            (sx, 1.0, sz - 6.0),
            rot=(0.0, np.pi / 2, 0.0),
            params={"name": P_str("door1"), "size": P_vec2(2.0, 2.0),
                    "preventPlayerOpen": P_bool(True)},
        ),
        # beam along +z (rotation pi about y) through the closed door
        actor("prop_laser", (sx - 1.0, 1.0, -20.0), rot=(0.0, np.pi, 0.0),
              params={"height": P_int(1), "startOn": P_bool(True)}),
        actor(
            "logic_counter",
            (0, 0, 0),
            params={"name": P_str("count1"), "min": P_int(0), "max": P_int(2),
                    "counter": P_int(0)},
            connections=[("hit_max", "light1", "set_instant", None)],
        ),
        actor(
            "global_light",
            (0, 0, 0),
            params={"name": P_str("light1"), "light_color": P_color(1.0, 0.5, 0.25),
                    "interpolation_ticks": P_int(0), "start_on": P_bool(False)},
        ),
        actor("sound_player", (sx, 1.0, sz),
              params={"name": P_str("snd1"), "sound": P_str("sfx/click"),
                      "positional": P_bool(True)}),
        actor("io_proxy", (0, 0, 0),
              connections=[("first_tick", "snd1", "play", None)]),
    ]


def stub_resolver():
    """An AssetResolver that answers every model with a 0.2 m half-extent
    box centred on the body origin, with no hull cloud and no inertia
    override: the stand-in for the absent `model/cube.gmdl`, whose collision
    shape is such a box. `build_physbox` sets the physbox mass (10)."""
    from c_game_engine_tpu.compiler.models import AssetResolver, ModelInfo

    class StubResolver(AssetResolver):
        def model(self, rel):
            return ModelInfo(rel, None, np.full(3, 0.2, np.float32), np.zeros(3, np.float32), 64.0)

    return StubResolver(search_paths=())


# (x, z) of the two physbox stacks, the three ramp drops, the two johns and
# the box on the bench-stream path (where the player is near tick 17)
STACK3_XZ = (-6.0, 6.0)
STACK4_XZ = (-12.0, 10.0)
RAMP_DROPS = ((15.0, 7.0), (16.5, 8.0), (17.0, 9.2))
JOHNS_XZ = ((16.0, -6.0), (18.0, 2.0))
PATH_BOX_XZ = (8.85, -3.7)


def _ramp_y(z):
    top = 4 * STEP
    return top * (RAMP[3] - z) / (RAMP[3] - RAMP[2])


def body_actors(kit=None):
    """The 13 dynamic bodies of `arena_bodies`."""
    actor = _kit(kit).actor

    out = []
    for (x, z), n in ((STACK3_XZ, 3), (STACK4_XZ, 4)):
        # dropped in a column with small gaps (tests/test_stacking.py)
        out += [actor("prop_physbox", (x, 0.3 + 0.45 * i, z)) for i in range(n)]
    out += [actor("prop_physbox", (x, _ramp_y(z) + 0.6, z)) for x, z in RAMP_DROPS]
    out += [actor("npc_john", (x, 4 * STEP + 0.6, z)) for x, z in JOHNS_XZ]
    out.append(actor("prop_physbox", (PATH_BOX_XZ[0], 0.2, PATH_BOX_XZ[1])))
    return out


def compile_arena_bodies():
    from c_game_engine_tpu.compiler.compile import compile_map

    return compile_map(_arena_gmap(arena_actors() + body_actors()), name="arena_bodies",
                       resolver=stub_resolver())


def make_stub_map(actors, tris=None, spawn=(0.0, 0.0, 0.0), spawn_yaw=0.0, resolver=None):
    """tests/worldgen.py::make_map compiled with the stub resolver (or
    `resolver`), so physboxes compile without the reference models."""
    from c_game_engine_tpu.assets.gmap import GMap, MapCollisionMesh
    from c_game_engine_tpu.compiler.compile import compile_map
    from tests.worldgen import actor, box_room

    gmap = GMap(
        render_sky=False,
        sky_texture=None,
        discord_icon="",
        discord_name="synthetic",
        actors=list(actors),
        models=[],
        collision=[MapCollisionMesh(np.zeros(3, np.float32), [box_room() if tris is None else tris])],
        lightmap=np.ones((1, 1, 4), np.float32),
        point_lights=np.zeros((0, 9), np.float32),
        player_spawn=actor("player", spawn, (0, spawn_yaw, 0)),
    )
    return compile_map(gmap, name="synthetic", resolver=resolver or stub_resolver())


def compile_arena():
    from c_game_engine_tpu.compiler.compile import compile_map

    return compile_map(_arena_gmap(arena_actors()), name="arena")


def _arena_gmap(actors, kit=None, **render):
    k = _kit(kit)
    GMap, MapCollisionMesh, actor = k.GMap, k.MapCollisionMesh, k.actor
    kw = dict(render_sky=False, sky_texture=None, models=[], lightmap=np.ones((1, 1, 4), np.float32))
    kw.update(render)
    return GMap(
        discord_icon="",
        discord_name="arena",
        actors=actors,
        collision=[MapCollisionMesh(np.zeros(3, np.float32), [arena_tris()])],
        point_lights=np.zeros((0, 9), np.float32),
        player_spawn=actor("player", SPAWN, (0, 0, 0)),
        **kw,
    )


# ---------------------------------------------------------------- arena_lit
# The arena's actors and collision plus render content made here from
# numpy: a render mesh coarser than the collision mesh (4 m floor blocks
# where the floor is flat, split down to the 1 m cells of the stairs and
# the ramp, the risers, 4 m perimeter wall panels), a [64, 64] gradient
# lightmap, a sky cube, and procedural textures and materials behind
# `render_resolver()`. The coarse floor keeps every 8 x 128 tile's list
# under K4's L_CAP: at 128 x 128 one tile row spans the whole view, and
# the tiles on the horizon then list most of the floor in sight.

FLOOR_BLOCK = 4  # cells of 1 m

FLOOR_MAT = "material/floor.gmtl"  # shaded; texture repeat + filter + mipmaps
WALL_MAT = "material/wall.gmtl"  # unshaded; texture nearest, no mips
STONE_MAT = "material/stone.gmtl"  # resolves nowhere: the checkerboard fallback
SKY_TEX = "texture/sky.gtex"
SKY_HALF = 10.0  # the sky cube's half extent (it follows the camera)
LIGHTMAP_SIZE = 64


def _q8(px):
    """Texels as 8-bit values, as a decoded RGBA8 texture holds them."""
    return (np.round(np.clip(px, 0.0, 1.0) * 255.0) / 255.0).astype(np.float32)


def _sprite(w, h, rgb, frames):
    """A `frames`-frame horizontal strip of discs with alpha-0 backgrounds."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    fw = w // frames
    cx = (xx % fw) + 0.5 - fw / 2
    cy = yy + 0.5 - h / 2
    r = np.sqrt(cx * cx + cy * cy) / (h / 2)
    px = np.zeros((h, w, 4), np.float32)
    shade = 1.0 - 0.4 * r + 0.1 * np.cos(xx // fw)
    px[..., :3] = np.asarray(rgb, np.float32) * shade[..., None]
    px[..., 3] = (r < 0.85).astype(np.float32)
    return px


def _texture_pixels():
    """name -> (pixels [h, w, 4], repeat, filter, mipmaps)."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:64, 0:64].astype(np.float32)
    tile = ((xx // 16 + yy // 16) % 2)[..., None]
    floor = np.concatenate([0.45 + 0.25 * tile + 0.08 * rng.random((64, 64, 1)),
                            0.4 + 0.2 * tile + 0.08 * rng.random((64, 64, 1)),
                            0.35 + 0.1 * tile + 0.05 * rng.random((64, 64, 1)),
                            np.ones((64, 64, 1))], -1)
    by, bx = np.mgrid[0:32, 0:32]
    mortar = (by % 8 == 0) | (((bx + 8 * ((by // 8) % 2)) % 16) == 0)
    wall = np.where(mortar[..., None], [0.75, 0.75, 0.7, 1.0], [0.6, 0.25, 0.2, 1.0]).astype(np.float32)
    sy, _ = np.mgrid[0:32, 0:64].astype(np.float32)
    t = (sy / 31.0)[..., None]
    sky = np.concatenate([0.3 + 0.5 * t, 0.5 + 0.4 * t, np.full_like(t, 0.95), np.ones_like(t)], -1)
    dy, dx = np.mgrid[0:32, 0:32].astype(np.float32)
    door = np.stack([0.45 + 0.15 * ((dx // 8) % 2) + 0.05 * np.sin(dy), 0.3 + 0.1 * ((dx // 8) % 2),
                     0.15 + 0.0 * dx, np.ones_like(dx)], -1)
    ly, _ = np.mgrid[0:16, 0:16].astype(np.float32)
    core = np.exp(-(((ly + 0.5) - 8.0) / 3.0) ** 2)
    laser = np.stack([np.ones_like(core), 0.2 * core, 0.1 * core, 0.6 * core], -1)
    return {
        "texture/floor.gtex": (floor, True, True, True),
        "texture/wall.gtex": (wall, True, False, False),
        SKY_TEX: (sky, False, True, False),
        "texture/actor/coin.gtex": (_sprite(64, 16, (1.0, 0.85, 0.2), 4), False, False, False),
        "texture/actor/bluecoin.gtex": (_sprite(64, 16, (0.25, 0.45, 1.0), 4), False, False, False),
        "texture/actor/door.gtex": (door, False, True, True),
        "texture/actor/laser.gtex": (laser, True, False, True),
        ORB_TEX: (_orb_texture(), True, True, True),
    }


def _sky_model(kit=None):
    """A 12-triangle cube of half extent SKY_HALF, each face mapping the
    whole sky texture."""
    k = _kit(kit)
    CollisionModelType, Model, ModelLod = k.CollisionModelType, k.Model, k.ModelLod

    verts, idx = [], []
    for axis in range(3):
        for sign in (-1.0, 1.0):
            u_ax, v_ax = [a for a in range(3) if a != axis]
            for k, (a, b) in enumerate(((-1, -1), (1, -1), (1, 1), (-1, 1))):
                p = np.zeros(3, np.float32)
                p[axis], p[u_ax], p[v_ax] = sign * SKY_HALF, a * SKY_HALF, b * SKY_HALF
                uv = ((a + 1) / 2, (1 - b) / 2)
                verts.append([*p, *uv, 1.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0])
            base = len(verts) - 4
            idx += [base, base + 1, base + 2, base, base + 2, base + 3]
    lod = ModelLod(0.0, np.asarray(verts, np.float32), [np.asarray(idx, np.uint32)])
    return Model(
        materials=[{"texture": SKY_TEX, "color": np.ones(4, np.float32), "shader": 0}],
        skins=np.zeros((1, 1), np.uint32), lods=[lod],
        aabb_origin=np.zeros(3, np.float32), aabb_extents=np.full(3, SKY_HALF, np.float32),
        collision_type=CollisionModelType.NONE,
    )


def render_resolver():
    """An AssetResolver whose materials, textures and models are made here:
    FLOOR_MAT and WALL_MAT resolve, STONE_MAT does not (the compiler then
    takes the fallback material, whose "_generic_fallback" texture is the
    checkerboard); the sky, floor, wall and actor textures are procedural;
    the models are the sky cube and arena_orb's sphere."""
    from c_game_engine_tpu.assets.codecs import MapMaterial, ModelShader, Texture, checkerboard_fallback
    from c_game_engine_tpu.compiler.models import AssetResolver, ModelInfo

    materials = {
        FLOOR_MAT: MapMaterial("texture/floor.gtex", ModelShader.SHADED, 0),
        WALL_MAT: MapMaterial("texture/wall.gtex", ModelShader.UNSHADED, 0),
    }
    pixels = _texture_pixels()

    class RenderResolver(AssetResolver):
        def material(self, rel):
            return materials.get(rel)

        def texture(self, rel):
            if rel not in self._textures:
                if rel in pixels:
                    px, repeat, filt, mips = pixels[rel]
                    px = _q8(px)
                    self._textures[rel] = Texture(px.shape[1], px.shape[0], filt, repeat, mips, px)
                else:
                    self._textures[rel] = checkerboard_fallback()
            return self._textures[rel]

        def model(self, rel):
            if rel == "model/sky.gmdl":
                return ModelInfo(rel, _sky_model(), np.full(3, SKY_HALF, np.float32),
                                 np.zeros(3, np.float32), 1.0)
            if rel == ORB_MODEL:
                return ModelInfo(rel, _orb_model(), np.full(3, ORB_RADIUS, np.float32),
                                 np.zeros(3, np.float32), 1.0)
            raise ValueError(f"render_resolver has no model {rel!r}")

    return RenderResolver(search_paths=())


def _lm_uv(x, z):
    return ((x + HALF) / (2 * HALF), (z + HALF) / (2 * HALF))


def _quad(verts, idx, corners, uvs):
    """Two triangles (0, 1, 2) and (0, 2, 3) over four [x, y, z] corners."""
    base = len(verts)
    for p, uv in zip(corners, uvs):
        verts.append([*p, *uv, *_lm_uv(p[0], p[2])])
    idx += [base, base + 1, base + 2, base, base + 2, base + 3]


def arena_render_models(kit=None):
    """The render mesh as MapModels (floor, stone risers, walls), wound
    like the collision triangles (ccw seen from the visible side)."""
    MapModel = _kit(kit).MapModel

    h = _corner_heights()
    n = 2 * HALF
    meshes = {FLOOR_MAT: ([], []), STONE_MAT: ([], []), WALL_MAT: ([], [])}

    def floor_cell(x0, x1, z0, z1, c):
        # corners x0z0, x0z1, x1z1, x1z0: the collision triangles' order
        corners = [(x0, c[0], z0), (x0, c[3], z1), (x1, c[2], z1), (x1, c[1], z0)]
        _quad(*meshes[FLOOR_MAT], corners, [(p[0] / 2, p[2] / 2) for p in corners])

    def floor_block(i0, j0, size):
        """One quad where the block is flat, else its four sub-blocks."""
        block = h[i0:i0 + size, j0:j0 + size]
        x0, z0 = i0 - HALF, j0 - HALF
        if size == 1 or np.all(block == block[0, 0, 0]):
            floor_cell(x0, x0 + size, z0, z0 + size, h[i0, j0] if size == 1 else [block[0, 0, 0]] * 4)
            return
        half = size // 2
        for di in (0, half):
            for dj in (0, half):
                floor_block(i0 + di, j0 + dj, half)

    for bi in range(0, n, FLOOR_BLOCK):
        for bj in range(0, n, FLOOR_BLOCK):
            floor_block(bi, bj, FLOOR_BLOCK)
    # risers (the collision mesh's, as stone quads)
    risers = []
    for i in range(n):
        x0, x1 = i - HALF, i - HALF + 1
        for j in range(n):
            z0, z1 = j - HALF, j - HALF + 1
            c = h[i, j]
            for (p0, p1, mine, o) in (
                ((x1, z0), (x1, z1), (c[1], c[2]), h[i + 1, j] if i + 1 < n else None),
                ((x0, z1), (x1, z1), (c[3], c[2]), h[i, j + 1] if j + 1 < n else None),
            ):
                if o is None:
                    continue
                theirs = (o[0], o[3]) if p0[0] == p1[0] else (o[0], o[1])
                lo = tuple(min(a, b) for a, b in zip(mine, theirs))
                hi = tuple(max(a, b) for a, b in zip(mine, theirs))
                _riser(risers, p0, p1, lo, hi)
    verts, idx = meshes[STONE_MAT]
    for tri in risers:
        base = len(verts)
        for p in tri:
            along = p[0] + p[2]
            verts.append([*p, along, p[1], *_lm_uv(p[0], p[2])])
        idx += [base, base + 1, base + 2]
    # perimeter walls in 4 m panels (the collision walls' edge order)
    p = FLOOR_BLOCK
    for k in range(-HALF, HALF, p):
        for (p0, p1) in (
            ((k, -HALF), (k + p, -HALF)),
            ((k + p, HALF), (k, HALF)),
            ((-HALF, k + p), (-HALF, k)),
            ((HALF, k), (HALF, k + p)),
        ):
            (x0, z0), (x1, z1) = p0, p1
            corners = [(x0, 0.0, z0), (x1, 0.0, z1), (x1, WALL_H, z1), (x0, WALL_H, z0)]
            uvs = [(0.0, 1.0), (1.0, 1.0), (1.0, 0.0), (0.0, 0.0)]
            _quad(*meshes[WALL_MAT], corners, uvs)
    return [MapModel(mat, np.asarray(v, np.float32), np.asarray(i, np.uint32))
            for mat, (v, i) in meshes.items()]


def arena_lightmap():
    """[64, 64, 4] gradient over the arena's XZ square (lightmap uv)."""
    s = (np.arange(LIGHTMAP_SIZE, dtype=np.float32) + 0.5) / LIGHTMAP_SIZE
    v, u = np.meshgrid(s, s, indexing="ij")
    return np.stack([0.55 + 0.45 * u, 0.6 + 0.4 * v, 0.9 - 0.3 * u * v, np.ones_like(u)], -1)


def compile_arena_lit():
    from c_game_engine_tpu.compiler.compile import compile_map

    gmap = _arena_gmap(arena_actors(), render_sky=True, sky_texture=SKY_TEX,
                       models=arena_render_models(), lightmap=arena_lightmap())
    return compile_map(gmap, name="arena_lit", resolver=render_resolver())


# ---------------------------------------------------------------- arena_orb
# arena_lit plus one `prop_model_static` actor (collision 0: no physics
# body) carrying an icosphere of 81,920 triangles, so the live-triangle
# bound exceeds the 65,536 of the tile-kernel route and the map renders
# through the streamed kernel K5, as the shipped orb.gmap's 78k-triangle
# hull model does. The sphere stands between the first two headings of
# the bench_render sweep as seen after 60 ticks of the bench stream.

ORB_MODEL = "model/orb.gmdl"
ORB_TEX = "texture/orb.gtex"
ORB_SUBDIV = 6  # 20 * 4**6 = 81,920 triangles
ORB_RADIUS = 3.0
ORB_POS = (2.0, 3.0, -9.5)


def icosphere(subdiv):
    """[20 * 4**subdiv, 3, 3] triangles of the unit icosphere, each wound
    counter-clockwise seen from outside (the map's visible-side order)."""
    p = (1.0 + 5.0 ** 0.5) / 2.0
    v = np.array([[-1, p, 0], [1, p, 0], [-1, -p, 0], [1, -p, 0], [0, -1, p], [0, 1, p],
                  [0, -1, -p], [0, 1, -p], [p, 0, -1], [p, 0, 1], [-p, 0, -1], [-p, 0, 1]], np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    faces = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9], [5, 11, 4],
                      [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8],
                      [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]])
    tris = v[faces]
    unit = lambda x: x / np.linalg.norm(x, axis=-1, keepdims=True)
    for _ in range(subdiv):
        a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
        ab, bc, ca = unit(a + b), unit(b + c), unit(c + a)
        tris = np.stack([np.stack(t, 1) for t in ((a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca))], 1)
        tris = tris.reshape(-1, 3, 3)
    normal = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    inward = (normal * tris.mean(1)).sum(-1) < 0
    tris[inward] = tris[inward][:, ::-1]
    return tris


def _orb_model(kit=None):
    """The icosphere as a one-LOD, one-slot model: unshared vertices with
    spherical uv (4 repeats around, 2 pole to pole), white vertex colour
    and the outward normal."""
    k = _kit(kit)
    CollisionModelType, Model, ModelLod, ModelShader = k.CollisionModelType, k.Model, k.ModelLod, k.ModelShader

    unit = icosphere(ORB_SUBDIV).reshape(-1, 3)
    u = 4.0 * (0.5 + np.arctan2(unit[:, 2], unit[:, 0]) / (2 * np.pi))
    v = 2.0 * np.arccos(np.clip(unit[:, 1], -1.0, 1.0)) / np.pi
    n = len(unit)
    verts = np.concatenate([unit * ORB_RADIUS, u[:, None], v[:, None], np.ones((n, 4)), unit], 1)
    lod = ModelLod(0.0, verts.astype(np.float32), [np.arange(n, dtype=np.uint32)])
    return Model(
        materials=[{"texture": ORB_TEX, "color": np.ones(4, np.float32), "shader": int(ModelShader.SHADED)}],
        skins=np.zeros((1, 1), np.uint32), lods=[lod],
        aabb_origin=np.zeros(3, np.float32), aabb_extents=np.full(3, ORB_RADIUS, np.float32),
        collision_type=CollisionModelType.NONE,
    )


def _orb_texture():
    """64 x 64 bands and meridians (repeat, filter and mipmaps in
    _texture_pixels)."""
    yy, xx = np.mgrid[0:64, 0:64].astype(np.float32)
    band = ((yy // 8) % 2)[..., None]
    meridian = (xx % 16 < 2)[..., None]
    rgb = np.where(meridian, [0.9, 0.9, 0.85], np.where(band, [0.2, 0.55, 0.6], [0.75, 0.35, 0.2]))
    return np.concatenate([rgb, np.ones((64, 64, 1))], -1).astype(np.float32)


def orb_actor(kit=None):
    k = _kit(kit)
    P_byte, P_str, actor = k.P_byte, k.P_str, k.actor

    return actor("prop_model_static", ORB_POS, params={"model": P_str(ORB_MODEL), "collision": P_byte(0)})


def compile_arena_orb():
    from c_game_engine_tpu.compiler.compile import compile_map

    gmap = _arena_gmap(arena_actors() + [orb_actor()], render_sky=True, sky_texture=SKY_TEX,
                       models=arena_render_models(), lightmap=arena_lightmap())
    return compile_map(gmap, name="arena_orb", resolver=render_resolver())


def bundle_to_numpy(rb):
    """(array leaves {name: ndarray}, static fields) of a JAX RenderBundle,
    as c_game_engine_tpu_torch/render/bundle.py::load_bundle reads them."""
    from c_game_engine_tpu_torch.render.bundle import ARRAYS, ATLAS_ARRAYS
    from c_game_engine_tpu_torch.render.hud import HUD_FIELDS
    from c_game_engine_tpu_torch.ui.stack import UI_FIELDS

    leaves = {k: np.asarray(getattr(rb, k)) for k in ARRAYS}
    for k in ATLAS_ARRAYS:
        leaves[f"atlas.{k}"] = np.asarray(getattr(rb.atlas, k))
    for k in HUD_FIELDS:
        leaves[f"hud.{k}"] = np.asarray(getattr(rb.hud, k))
    for k in UI_FIELDS:
        leaves[f"ui.{k}"] = np.asarray(getattr(rb.ui, k))
    # bf16 -> f32 is exact
    leaves["atlas.blocked"] = np.asarray(rb.atlas.blocked.astype(np.float32))
    static = {"live_tri_bound": int(rb.live_tri_bound), "has_alpha": bool(rb.has_alpha),
              "tex_names": list(rb.tex_names)}
    return leaves, static


def export_bundle(rb, npz_path, json_path):
    leaves, static = bundle_to_numpy(rb)
    np.savez_compressed(npz_path, **leaves)
    with open(json_path, "w") as f:
        json.dump(static, f, indent=1, sort_keys=True)
        f.write("\n")


def render_summary(name):
    """What each bench_render sweep frame (4 headings) hands the raster
    kernel, at 256 x 256 and at the tests' 128 x 128, at the spawn and after
    60 ticks of the bench stream, rendered by the port on the CPU from the
    committed files. On the tile route: the largest per-tile list count
    (K4's L_CAP is 512). On the big route: the soup rows, the chunks NC,
    the live rows, the near-plane-crossing rows (CLIP_CAP keeps 2048), the
    largest per-tile count of bbox-overlapping rows, and the share of
    pixels whose pass-1 winner is an actor-model row."""
    from c_game_engine_tpu_torch.models.sim import bench_actions, reset_batch, rollout
    from c_game_engine_tpu_torch.ops import raster_tiles, raster_tiles_big
    from c_game_engine_tpu_torch.render import raster as R
    from c_game_engine_tpu_torch.render.bundle import load_render_map

    cm, rb = load_render_map(name, "cpu")
    big = rb.live_tri_bound > R.PALLAS_MAX_BOUND
    start = reset_batch(cm, 1)
    seen = {}
    binner, clipper = raster_tiles.bin_triangles, R._clip_near_compact
    kernel, attrs = raster_tiles_big.raster_tiles_big, R._attrs_from_winner

    def record_bins(*a):
        out = binner(*a)
        seen["largest per-tile count"] = int(out[1].max())
        return out

    def record_clip(clip, tri, cap):
        n_in = (clip[..., 3] > R.NEAR_W).sum(-1)
        seen["soup rows"] = clip.shape[1]
        seen["crossing rows"] = int((tri["valid"] & (n_in > 0) & (n_in < 3)).sum())
        return clipper(clip, tri, cap)

    def record_k5(trit, cbox, scb, h, w, exclude=None, tile_on=None):
        if tile_on is None:  # pass 1
            seen["NC"] = trit.shape[2] // raster_tiles_big.T_CHK
            seen["live rows"] = int((trit[:, 10] <= trit[:, 11]).sum())
            seen["largest per-tile count"] = int(raster_tiles_big.tile_lists(trit, h, w)[1].max())
        return kernel(trit, cbox, scb, h, w, exclude=exclude, tile_on=tile_on)

    def record_attrs(vattr36, enc, winner, gxx, gyy):
        out = attrs(vattr36, enc, winner, gxx, gyy)
        if winner.shape == gxx.shape and "model share" not in seen:  # pass 1 (full frame)
            kind = (out[6] >> 12) & 3
            seen["model share"] = round(float((out[0] & (kind == R.KIND_MODEL)).float().mean()), 4)
        return out

    raster_tiles.bin_triangles, R._clip_near_compact = record_bins, record_clip
    raster_tiles_big.raster_tiles_big, R._attrs_from_winner = record_k5, record_attrs
    try:
        for label, st in (("spawn", start), ("tick60", rollout(cm, start, bench_actions(60, 1, "cpu")))):
            for size in (256, 128):
                by_heading = []
                for sk in R.yaw_sweep(st, 4):
                    seen.clear()
                    R.render_batch(rb, cm, sk, size, size)
                    by_heading.append(dict(seen))
                keys = by_heading[0].keys()
                print(f"{name} {label} {size}x{size} by heading: "
                      + "; ".join(f"{k} {[h[k] for h in by_heading]}" for k in keys))
    finally:
        raster_tiles.bin_triangles, R._clip_near_compact = binner, clipper
        raster_tiles_big.raster_tiles_big, R._attrs_from_winner = kernel, attrs
    return rb.live_tri_bound


def map_to_numpy(cmap):
    """(leaves {field: ndarray}, aux dict without the AssetResolver)."""
    import dataclasses

    leaves = {}
    for f in dataclasses.fields(cmap):
        if f.name == "aux":
            continue
        leaves[f.name] = np.asarray(getattr(cmap, f.name))
    aux = {k: v for k, v in (cmap.aux or {}).items() if k != "resolver"}
    return leaves, aux


def export(cmap, npz_path, json_path):
    leaves, aux = map_to_numpy(cmap)
    np.savez_compressed(npz_path, **leaves)
    with open(json_path, "w") as f:
        json.dump(aux, f, indent=1, sort_keys=True)
        f.write("\n")


MAPS = {"arena": compile_arena, "arena_bodies": compile_arena_bodies, "arena_lit": compile_arena_lit,
        "arena_orb": compile_arena_orb}
# maps exported with a render bundle
RENDER_MAPS = ("arena_lit", "arena_orb")


def main(names):
    from c_game_engine_tpu.render.bundle import build_render_bundle

    MAP_DIR.mkdir(parents=True, exist_ok=True)
    for name in names or MAPS:
        cmap = MAPS[name]()
        export(cmap, MAP_DIR / f"{name}.npz", MAP_DIR / f"{name}.json")
        leaves, aux = map_to_numpy(cmap)
        line = (
            f"{name}: {aux['num_real_tris']} tris, {leaves['chunk_bounds'].shape[0]} chunks, "
            f"{len(aux['actor_names'])} actors, grid {aux['grid_shape']}, "
            f"num_dynamic {aux['num_dynamic']}, "
            f"npz {os.path.getsize(MAP_DIR / f'{name}.npz')} B"
        )
        if name in RENDER_MAPS:
            export_bundle(build_render_bundle(cmap), MAP_DIR / f"{name}_bundle.npz",
                          MAP_DIR / f"{name}_bundle.json")
            soup = render_summary(name)
            line += (f", render soup {soup} tris, bundle npz "
                     f"{os.path.getsize(MAP_DIR / f'{name}_bundle.npz')} B")
        print(line)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    main(sys.argv[1:])
