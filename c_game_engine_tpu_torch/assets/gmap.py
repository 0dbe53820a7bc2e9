"""Decoder for compiled `.gmap` map binaries (counterpart of
c_game_engine_tpu/assets/gmap.py), host side, numpy.

Layout mirrors the reference loader (engine/src/assets/MapLoader.c:40-313):
sky flag + texture, Discord strings, actor records (class, pos 3f, euler 3f,
connections, KvList params), render models (material name, MapVertex
{pos 3f, uv 2f, lightmapUv 2f}, u32 indices), collision compounds (origin,
sub-shapes of triangle soups), RGBA16F lightmap, point lights.

The decoded GMap is what compiler/compile.py::compile_map takes, as is the
GMap that compiler/sectors.py::compile_map_source makes from an editor
JSON source.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from c_game_engine_tpu_torch.assets.container import AssetType, read_asset
from c_game_engine_tpu_torch.assets.kvlist import Param, read_kvlist, read_param
from c_game_engine_tpu_torch.assets.reader import PayloadError, Reader


@dataclass
class MapConnection:
    output: str
    target_name: str
    target_input: str
    param_override: Param
    num_refires: int


@dataclass
class MapActor:
    actor_class: str
    position: np.ndarray  # [3]
    rotation_euler: np.ndarray  # [3] radians, JPH_Quat_FromEulerAngles order
    connections: list[MapConnection]
    params: dict[str, Param]


@dataclass
class MapModel:
    material: str
    vertices: np.ndarray  # [V, 7]: pos(3) uv(2) lightmapUv(2)
    indices: np.ndarray  # [I] u32


@dataclass
class MapCollisionMesh:
    origin: np.ndarray  # [3]
    sub_tris: list[np.ndarray]  # each [T, 3, 3]


@dataclass
class GMap:
    render_sky: bool
    sky_texture: str | None
    discord_icon: str
    discord_name: str
    actors: list[MapActor]
    models: list[MapModel]
    collision: list[MapCollisionMesh]
    lightmap: np.ndarray  # [H, W, 4] float32
    point_lights: np.ndarray  # [L, 9]: pos(3) color(3) brightness range attenuation
    player_spawn: MapActor | None = field(default=None)

    def all_collision_tris(self) -> np.ndarray:
        """Static collision triangles in world space, concatenated [T,3,3]."""
        parts = []
        for mesh in self.collision:
            for tris in mesh.sub_tris:
                parts.append(tris + mesh.origin[None, None, :])
        if not parts:
            return np.zeros((0, 3, 3), dtype=np.float32)
        return np.concatenate(parts, axis=0).astype(np.float32)


def decode_gmap(path: str | Path) -> GMap:
    asset = read_asset(path)
    if asset.type != AssetType.MAP:
        raise PayloadError(f"{path}: not a map asset")
    r = Reader(asset.data)

    render_sky = r.u8() != 0
    sky_texture = r.string() if render_sky else None
    discord_icon = r.string()
    discord_name = r.string()

    player_spawn = None
    actors: list[MapActor] = []
    n_actors = r.u64()
    for _ in range(n_actors):
        cls = r.string()
        pos = np.array([r.f32() for _ in range(3)], dtype=np.float32)
        rot = np.array([r.f32() for _ in range(3)], dtype=np.float32)
        n_conn = r.u64()
        conns = []
        for _ in range(n_conn):
            output = r.string()
            target_name = r.string()
            target_input = r.string()
            has_override = r.u8() != 0
            override = read_param(r) if has_override else Param.none()
            num_refires = r.u64()
            conns.append(MapConnection(output, target_name, target_input, override, num_refires))
        params = read_kvlist(r)
        actor = MapActor(cls, pos, rot, conns, params)
        if cls == "player":
            # consumed as spawn transform (MapLoader.c:126-133)
            player_spawn = actor
        else:
            actors.append(actor)

    models: list[MapModel] = []
    n_models = r.u64()
    for _ in range(n_models):
        material = r.string()
        n_verts = r.u32()
        verts = np.frombuffer(r.raw(n_verts * 7 * 4), dtype=np.float32).reshape(n_verts, 7).copy()
        n_idx = r.u32()
        idx = np.frombuffer(r.raw(n_idx * 4), dtype=np.uint32).copy()
        models.append(MapModel(material, verts, idx))

    collision: list[MapCollisionMesh] = []
    n_coll = r.u64()
    for _ in range(n_coll):
        origin = np.array([r.f32() for _ in range(3)], dtype=np.float32)
        n_sub = r.u64()
        subs = []
        for _ in range(n_sub):
            n_tris = r.u64()
            tris = np.frombuffer(r.raw(n_tris * 9 * 4), dtype=np.float32).reshape(n_tris, 3, 3).copy()
            subs.append(tris)
        collision.append(MapCollisionMesh(origin, subs))

    lw = r.u64()
    lh = r.u64()
    lightmap = (
        np.frombuffer(r.raw(lw * lh * 8), dtype=np.float16)
        .reshape(lh, lw, 4)
        .astype(np.float32)
    )

    n_lights = r.u16()
    lights = np.zeros((n_lights, 9), dtype=np.float32)
    for i in range(n_lights):
        for j in range(9):
            lights[i, j] = r.f32()

    return GMap(
        render_sky, sky_texture, discord_icon, discord_name, actors, models,
        collision, lightmap, lights, player_spawn,
    )
