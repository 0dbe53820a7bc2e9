"""The maps of chip_smoke.py's oracle phase, written as .gmap files with
numpy and the port's container writer only (no JAX):

    write_oracle_sources(directory) -> {name: path, "assets": search path}

  * "flat": tests/worldgen.py::box_room (floor y -1, walls at +-8), the
    npc_john of tests/test_solver_oracle.py::test_kinetic_friction_stops_slider
    at (4, -0.45, 4) and a physbox at (-4, 0, 4) (the drop; its height is
    set per lane), the player at (0, 0, -4);
  * "room": the box room alone, the player at the origin (the player
    oracles of tests/test_physics.py; the yaw is set per lane);
  * "ramp55": tests/test_solver_oracle.py::_ramp_map(55)'s single-quad
    plane y = -tan(55 deg) x with its npc_john at (0, 0.7, 0) and its
    player spawn.

The physbox's model/cube.gmdl and the other assets are
tests/torch_map_sources.py's, under directory/assets. The geometry
builders copy tests/worldgen.py's and tests/test_solver_oracle.py's, which
import JAX; tests/test_torch_oracles.py::test_oracle_maps_are_the_jax_tests_geometry
holds them equal. Import this file as a top-level module with its
directory on sys.path where a package named `tests` is installed.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
if str(_HERE) not in sys.path:
    sys.path.insert(0, str(_HERE))

import torch_map_sources as S  # noqa: E402

RAMP_DEG = 55.0
FLAT_JOHN, FLAT_BOX = (4.0, -0.45, 4.0), (-4.0, 0.0, 4.0)
RAMP_JOHN = (0.0, 0.7, 0.0)


def quad(a, b, c, d):
    return [[a, b, c], [a, c, d]]


def box_room(half=8.0, floor_y=-1.0, ceil_y=3.0) -> np.ndarray:
    """tests/worldgen.py::box_room: floor, ceiling and 4 walls, [12, 3, 3]."""
    h, f, c = half, floor_y, ceil_y
    tris = []
    tris += quad((-h, f, -h), (-h, f, h), (h, f, h), (h, f, -h))
    tris += quad((-h, c, -h), (h, c, -h), (h, c, h), (-h, c, h))
    tris += quad((-h, f, -h), (h, f, -h), (h, c, -h), (-h, c, -h))
    tris += quad((h, f, h), (-h, f, h), (-h, c, h), (h, c, h))
    tris += quad((-h, f, h), (-h, f, -h), (-h, c, -h), (-h, c, h))
    tris += quad((h, f, -h), (h, f, h), (h, c, h), (h, c, -h))
    return np.array(tris, dtype=np.float32)


def ramp_tris(theta_deg: float) -> np.ndarray:
    """tests/test_solver_oracle.py::_ramp_map's single quad, descending
    toward +x."""
    t = float(np.tan(np.radians(theta_deg)))
    h = 12.0
    return np.array(quad((-h, h * t, -h), (-h, h * t, h), (h, -h * t, h), (h, -h * t, -h)), np.float32)


def ramp_spawn(theta_deg: float):
    return (0.0, 8.0 * float(np.tan(np.radians(theta_deg))) + 1.0, -8.0)


def _gmap(actors, tris, spawn):
    k = S.PORT_KIT
    return k.GMap(render_sky=False, sky_texture=None, discord_icon="", discord_name="synthetic",
                  actors=list(actors), models=[], collision=[k.MapCollisionMesh(np.zeros(3, np.float32), [tris])],
                  lightmap=np.ones((1, 1, 4), np.float32), point_lights=np.zeros((0, 9), np.float32),
                  player_spawn=k.actor("player", spawn, (0, 0, 0)))


def oracle_gmaps() -> dict:
    a = S.PORT_KIT.actor
    return {
        "flat": _gmap([a("npc_john", FLAT_JOHN), a("prop_physbox", FLAT_BOX)], box_room(), (0.0, 0.0, -4.0)),
        "room": _gmap([], box_room(), (0.0, 0.0, 0.0)),
        "ramp55": _gmap([a("npc_john", RAMP_JOHN)], ramp_tris(RAMP_DEG), ramp_spawn(RAMP_DEG)),
    }


def write_oracle_sources(directory) -> dict:
    directory = Path(directory)
    S.write_assets(directory / "assets")
    out = {"assets": directory / "assets"}
    for name, gm in oracle_gmaps().items():
        out[name] = directory / f"{name}.gmap"
        S.encode_gmap(gm, out[name])
    return out
