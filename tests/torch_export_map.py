"""Build the asset-free `arena` and `arena_bodies` maps with the JAX
compiler and export them as plain numpy/JSON files that the PyTorch port
(`c_game_engine_tpu_torch`) loads without JAX.

Usage (from the repo root, on the CPU):

    JAX_PLATFORMS=cpu python tests/torch_export_map.py

writes `c_game_engine_tpu_torch/maps/<name>.npz` (every array leaf of the
CompiledMap) and `<name>.json` (its `aux` dict, minus the AssetResolver)
for both maps.

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


def arena_actors():
    from tests.worldgen import P_bool, P_color, P_float, P_int, P_str, P_vec2, actor

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


def body_actors():
    """The 13 dynamic bodies of `arena_bodies`."""
    from tests.worldgen import actor

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


def make_stub_map(actors, tris=None, spawn=(0.0, 0.0, 0.0)):
    """tests/worldgen.py::make_map compiled with the stub resolver, so
    physboxes compile without the reference models."""
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
        player_spawn=actor("player", spawn, (0, 0, 0)),
    )
    return compile_map(gmap, name="synthetic", resolver=stub_resolver())


def compile_arena():
    from c_game_engine_tpu.compiler.compile import compile_map

    return compile_map(_arena_gmap(arena_actors()), name="arena")


def _arena_gmap(actors):
    from c_game_engine_tpu.assets.gmap import GMap, MapCollisionMesh
    from tests.worldgen import actor

    return GMap(
        render_sky=False,
        sky_texture=None,
        discord_icon="",
        discord_name="arena",
        actors=actors,
        models=[],
        collision=[MapCollisionMesh(np.zeros(3, np.float32), [arena_tris()])],
        lightmap=np.ones((1, 1, 4), np.float32),
        point_lights=np.zeros((0, 9), np.float32),
        player_spawn=actor("player", SPAWN, (0, 0, 0)),
    )


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


MAPS = {"arena": compile_arena, "arena_bodies": compile_arena_bodies}


def main():
    MAP_DIR.mkdir(parents=True, exist_ok=True)
    for name, build in MAPS.items():
        cmap = build()
        export(cmap, MAP_DIR / f"{name}.npz", MAP_DIR / f"{name}.json")
        leaves, aux = map_to_numpy(cmap)
        print(
            f"{name}: {aux['num_real_tris']} tris, {leaves['chunk_bounds'].shape[0]} chunks, "
            f"{len(aux['actor_names'])} actors, grid {aux['grid_shape']}, "
            f"num_dynamic {aux['num_dynamic']}, "
            f"npz {os.path.getsize(MAP_DIR / f'{name}.npz')} B"
        )


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    main()
