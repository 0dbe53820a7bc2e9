"""Hitscan raycasts of one env against the static world and the actor
colliders (counterpart of c_game_engine_tpu/physics/raycast.py).

Replaces Jolt's NarrowPhaseQuery::CastRay with layer and body filters
(PlayerPhysics.c:297-315, the player's 10 m interaction ray; Laser.c:127-158,
the 50 m laser rays, honouring ACTOR_FLAG_CAN_BLOCK_LASERS). The batched
tick casts its rays through physics/batched.py::cast_rays_batched and
kernel K2; this is the plain single-env version, every triangle tested.
"""

from __future__ import annotations

import torch

from c_game_engine_tpu_torch.actors.defs import Layer
from c_game_engine_tpu_torch.physics.batched import solid_mask
from c_game_engine_tpu_torch.physics.geometry import ray_obb, ray_triangle
from c_game_engine_tpu_torch.utils.mathx import quat_rotate


def cast_ray(
    cmap,
    actors,
    origin,
    direction,
    max_dist,
    exclude_actor=-1,
    require_flags: int = 0,
    static_layer_only: bool = False,
    include_statics: bool = True,
):
    """Returns (hit: bool, fraction: float32 in [0, 1], actor_idx: int32,
    -1 for the static world), 0-d tensors. `actors` leaves are [N, ...].

    `require_flags`: actors missing these flags are transparent (the laser's
    JPH_BodyFilter, Laser.c:73-86); static triangles always hit.
    `static_layer_only`: triple lasers collide only the STATIC broadphase
    layer (Laser.c:64-71)."""
    dev = origin.device
    t_best = torch.tensor(torch.inf, device=dev)
    idx_best = torch.tensor(-1, dtype=torch.int32, device=dev)

    if include_statics:
        a, b, c = cmap.tris[:, 0], cmap.tris[:, 1], cmap.tris[:, 2]
        _, t = ray_triangle(origin, direction, a, b, c, max_dist)
        t = torch.where(cmap.tri_valid, t, torch.inf)
        t_best = torch.minimum(t_best, torch.amin(t))

    solid = solid_mask(cmap, actors.active) & (torch.arange(cmap.num_actors, device=dev) != exclude_actor)
    if static_layer_only:
        solid = solid & (cmap.layer == int(Layer.STATIC))
    if require_flags:
        solid = solid & ((cmap.flags & require_flags) == require_flags)

    box_ctr = actors.pos + quat_rotate(actors.quat, cmap.shape_center)
    bhit, bt = ray_obb(origin, direction, box_ctr, actors.quat, cmap.halfext, max_dist)
    bt = torch.where(solid & bhit, bt, torch.inf)
    k = torch.argmin(bt)  # the first nearest box
    t_act = bt[k]
    idx_best = torch.where(t_act < t_best, k.int(), idx_best)
    t_best = torch.minimum(t_best, t_act)

    hit_any = torch.isfinite(t_best)
    fraction = torch.where(hit_any, t_best / max_dist, 1.0)
    return hit_any, fraction.float(), idx_best


def forward_vector(yaw, pitch):
    """World forward for the player and camera orientation: -Z at yaw 0,
    pitch turning it up or down (W moves -Z, MovePlayer PlayerPhysics.c:225)."""
    cp = torch.cos(pitch)
    return torch.stack([-torch.sin(yaw) * cp, torch.sin(pitch), -torch.cos(yaw) * cp], dim=-1)
