"""Sensor overlap: player capsule vs static box sensors (counterpart of
c_game_engine_tpu/physics/sensors.py, batched over envs).

The per-tick overlap mask plus last tick's mask gives the contact
added/persisted/removed edges (actors/behaviors.py::contact_phase).
"""

from __future__ import annotations

import torch

from refsim.physics import geometry_soa as g
from refsim.physics.character import CAPSULE_HALF_HEIGHT, CAPSULE_RADIUS


def sensor_overlap(cmap, actors, player_pos):
    """bool [B, S]: the capsule at player_pos [B, 3] overlaps sensor s, whose
    owner must be active. Sensor axis first, env axis last inside."""
    px, py, pz = (player_pos[:, k][None, :] for k in range(3))  # [1, B]
    sy0, sy1 = py - CAPSULE_HALF_HEIGHT, py + CAPSULE_HALF_HEIGHT
    ox, oy, oz = (cmap.sensor_pos[:, k][:, None] for k in range(3))  # [S, 1]
    qx, qy, qz, qw = (cmap.sensor_quat[:, k][:, None] for k in range(4))
    hx, hy, hz = (cmap.sensor_halfext[:, k][:, None] for k in range(3))
    own = torch.clamp_min(cmap.sensor_owner, 0).long()
    if bool((cmap.aux or {}).get("has_follow_sensors", False)):
        # follow-sensors track their owner's live body pose
        folb = cmap.sensor_follow[:, None]
        scx, scy, scz = (cmap.shape_center[own, k][:, None] for k in range(3))
        apx, apy, apz = (actors.pos[:, own, k].T for k in range(3))
        aqx, aqy, aqz, aqw = (actors.quat[:, own, k].T for k in range(4))
        rcx, rcy, rcz = g.quat_rotate_soa(aqx, aqy, aqz, aqw, scx, scy, scz)
        ox = torch.where(folb, apx + rcx, ox)
        oy = torch.where(folb, apy + rcy, oy)
        oz = torch.where(folb, apz + rcz, oz)
        qx = torch.where(folb, aqx, qx)
        qy = torch.where(folb, aqy, qy)
        qz = torch.where(folb, aqz, qz)
        qw = torch.where(folb, aqw, qw)

    wx, wy, wz = g.closest_point_on_obb_soa(px, py, pz, ox, oy, oz, qx, qy, qz, qw, hx, hy, hz)
    for _ in range(2):
        spy = g.clip(wy, sy0, sy1)
        wx, wy, wz = g.closest_point_on_obb_soa(px, spy, pz, ox, oy, oz, qx, qy, qz, qw, hx, hy, hz)
    spy = g.clip(wy, sy0, sy1)
    dist = torch.sqrt((px - wx) ** 2 + (spy - wy) ** 2 + (pz - wz) ** 2).T  # [B, S]
    owner_ok = (cmap.sensor_owner >= 0)[None, :] & actors.active[:, own]
    return owner_ok & (dist < CAPSULE_RADIUS)
