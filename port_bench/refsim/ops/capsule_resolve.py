"""Kernel K1: capsule penetration-resolve against the static triangle soup
and the solid actor OBBs (counterpart of
c_game_engine_tpu/ops/capsule_resolve.py::resolve_capsule_pallas).

Per env, ITERS rounds of: deepest contact over the triangles of the env's
128-lane block chunk list (ops/chunk_compact.py, MARGIN 1.0 around the
block's XZ box) and over the N solid boxes; push out along the winning
normal, clip the inward velocity, `grounded` when n_y >= cos 50 deg. The
first deepest contact wins ties; a box wins only when strictly deeper.

The candidate set is per block, not per lane, exactly as on the TPU: a
tilted triangle whose extended plane passes near a capsule centre reads as
a deep contact even when the triangle is far away (ROADMAP §3 f). The port
keeps that for parity.

In this reference `resolve_capsule` always runs `resolve_capsule_plain`,
the plain PyTorch version of the port's kernel, on any device: it
launches no kernel and counts nothing.
"""

from __future__ import annotations

import functools

import torch

from refsim.ops.chunk_compact import (
    block_minmax,
    compact_chunk_lists,
    gather_listed_chunks,
)
from refsim.physics import geometry_soa as g
from refsim.physics.character import (
    CAPSULE_HALF_HEIGHT,
    CAPSULE_RADIUS,
    MAX_SLOPE_COS,
)

BLK = 128
T_CHUNK = 32
ITERS = 4
# covers the capsule radius (0.2) + contact tolerance + the <= 4 pushes
MARGIN = 1.0
_NEG_BIG = -1e30


def chunk_lists(chunk_bounds, pos):
    """Per-128-lane-block chunk lists around the block's capsule centres."""
    xmin, xmax = block_minmax(pos[:, 0], BLK)
    zmin, zmax = block_minmax(pos[:, 2], BLK)
    return compact_chunk_lists(chunk_bounds, xmin, xmax, zmin, zmax, MARGIN)


def _check(tri16, chunk_bounds, box8, boxh, pos, vel):
    b = pos.shape[0]
    if b % BLK:
        raise ValueError(f"batch {b} is not a multiple of {BLK}")
    if tri16.ndim != 2 or tri16.shape[1] != 16 or tri16.shape[0] < T_CHUNK * chunk_bounds.shape[0]:
        raise ValueError(f"tri16 {tuple(tri16.shape)} does not cover {chunk_bounds.shape[0]} chunks")
    n = box8.shape[1]
    if box8.shape != (8, n, b) or boxh.shape != (4, n, b):
        raise ValueError(f"box tables {tuple(box8.shape)}, {tuple(boxh.shape)} for batch {b}")
    if pos.shape != (b, 3) or vel.shape != (b, 3):
        raise ValueError(f"pos/vel must be [B, 3], got {tuple(pos.shape)}, {tuple(vel.shape)}")
    for t in (tri16, chunk_bounds, box8, boxh, pos, vel):
        if t.dtype != torch.float32:
            raise TypeError(f"expected float32, got {t.dtype}")
        if t.device != pos.device:
            raise ValueError("all inputs must be on one device")


def resolve_capsule(tri16, chunk_bounds, box8, boxh, pos, vel):
    """pos/vel [B, 3] (B a multiple of 128) -> (pos, vel, grounded [B]).

    tri16 [T, 16] triangle table (T >= 32 * NC); chunk_bounds [NC, 4];
    box8 [8, N, B] (ox oy oz qx qy qz qw mask); boxh [4, N, B] half extents.
    """
    _check(tri16, chunk_bounds, box8, boxh, pos, vel)
    idx, cnt = chunk_lists(chunk_bounds, pos)
    return _resolve_plain(tri16, idx, cnt, box8, boxh, pos, vel)


def _qrot(qx, qy, qz, qw, vx, vy, vz):
    """Quaternion rotation in the TPU kernel's term order."""
    tx = 2 * (qy * vz - qz * vy)
    ty = 2 * (qz * vx - qx * vz)
    tz = 2 * (qx * vy - qy * vx)
    return (
        vx + qw * tx + qy * tz - qz * ty,
        vy + qw * ty + qz * tx - qx * tz,
        vz + qw * tz + qx * ty - qy * tx,
    )


def _first_max(depth):
    """Index of the first maximum along the last axis."""
    best = depth.amax(dim=-1, keepdim=True)
    k = torch.arange(depth.shape[-1], device=depth.device)
    return torch.where(depth == best, k, depth.shape[-1]).amin(dim=-1)


def _resolve_plain(tri16, idx, cnt, box8, boxh, pos, vel):
    b = pos.shape[0]
    G = b // BLK
    tri, tvalid = gather_listed_chunks(tri16, idx, cnt, T_CHUNK)
    col = lambda k: tri[:, None, :, k]  # [G, 1, K]
    ax, ay, az = col(0), col(1), col(2)
    bx, by, bz = col(3), col(4), col(5)
    cx, cy, cz = col(6), col(7), col(8)
    fnx, fny, fnz = col(9), col(10), col(11)
    tvalid = tvalid[:, None, :]
    ox, oy, oz, bqx, bqy, bqz, bqw, bmask = (box8[k] for k in range(8))  # [N, B]
    hx, hy, hz = boxh[0], boxh[1], boxh[2]

    def obb_closest(wx, wy, wz):
        lx, ly, lz = _qrot(-bqx, -bqy, -bqz, bqw, wx - ox, wy - oy, wz - oz)
        lx, ly, lz = g.clip(lx, -hx, hx), g.clip(ly, -hy, hy), g.clip(lz, -hz, hz)
        gx_, gy_, gz_ = _qrot(bqx, bqy, bqz, bqw, lx, ly, lz)
        return gx_ + ox, gy_ + oy, gz_ + oz

    px, py, pz = pos[:, 0], pos[:, 1], pos[:, 2]
    vx, vy, vz = vel[:, 0], vel[:, 1], vel[:, 2]
    grounded = torch.zeros(b, dtype=torch.bool, device=pos.device)
    for _ in range(ITERS):
        sy0 = py - CAPSULE_HALF_HEIGHT
        sy1 = py + CAPSULE_HALF_HEIGHT

        # ---- triangles of the block's chunk list: [G, 128, K]
        lane = lambda a: a.reshape(G, BLK, 1)
        lpx, lpy, lpz, ly0, ly1 = (lane(a) for a in (px, py, pz, sy0, sy1))
        qx, qy, qz = g.closest_point_on_triangle_soa(lpx, lpy, lpz, ax, ay, az, bx, by, bz, cx, cy, cz)
        for _k in range(2):
            spy = g.clip(qy, ly0, ly1)
            qx, qy, qz = g.closest_point_on_triangle_soa(lpx, spy, lpz, ax, ay, az, bx, by, bz, cx, cy, cz)
        spy = g.clip(qy, ly0, ly1)
        dx, dy, dz = lpx - qx, spy - qy, lpz - qz
        dist = torch.sqrt(dx * dx + dy * dy + dz * dz)
        inv = 1.0 / torch.clamp_min(dist, 1e-9)
        rx, ry, rz = dx * inv, dy * inv, dz * inv
        side = torch.sign((lpx - ax) * fnx + (lpy - ay) * fny + (lpz - az) * fnz)
        side = torch.where(side == 0, 1.0, side)
        flip = torch.sign(rx * fnx + ry * fny + rz * fnz) * side
        flip = torch.where(flip == 0, 1.0, flip)
        far = dist > 1e-6
        nx = torch.where(far, rx * flip, fnx * side)
        ny = torch.where(far, ry * flip, fny * side)
        nz = torch.where(far, rz * flip, fnz * side)
        signed = dx * nx + dy * ny + dz * nz
        depth = torch.where(tvalid > 0.5, CAPSULE_RADIUS - signed, _NEG_BIG)
        flat = lambda a: a.reshape(b, -1)

        # ---- boxes: alternating projection segment <-> OBB, [N, B]
        qbx, qby, qbz = obb_closest(px, py, pz)
        for _k in range(2):
            spby = g.clip(qby, sy0, sy1)
            qbx, qby, qbz = obb_closest(px, spby, pz)
        spby = g.clip(qby, sy0, sy1)
        ddx, ddy, ddz = px - qbx, spby - qby, pz - qbz
        bdist = torch.sqrt(ddx * ddx + ddy * ddy + ddz * ddz)
        binv = 1.0 / torch.clamp_min(bdist, 1e-9)
        depth_b = torch.where(bmask > 0.5, CAPSULE_RADIUS - bdist, _NEG_BIG)

        # [initial, triangles in list order, boxes]: the first maximum is
        # the kernel's strict-`>` running best with its tie rules
        init_d = torch.full((b, 1), _NEG_BIG, device=pos.device)
        zeros, ones = torch.zeros_like(init_d), torch.ones_like(init_d)
        all_d = torch.cat([init_d, flat(depth), depth_b.T], 1)
        win = _first_max(all_d)[:, None]
        pick = lambda i0, t, bx_: torch.cat([i0, flat(t), bx_.T], 1).gather(1, win)[:, 0]
        best = all_d.gather(1, win)[:, 0]
        wnx = pick(zeros, nx, ddx * binv)
        wny = pick(ones, ny, ddy * binv)
        wnz = pick(zeros, nz, ddz * binv)

        hit = best > -0.01
        push = torch.where(hit, torch.clamp_min(best, 0.0), 0.0)
        px = px + wnx * push
        py = py + wny * push
        pz = pz + wnz * push
        vn = vx * wnx + vy * wny + vz * wnz
        clip = hit & (vn < 0)
        vx = torch.where(clip, vx - wnx * vn, vx)
        vy = torch.where(clip, vy - wny * vn, vy)
        vz = torch.where(clip, vz - wnz * vn, vz)
        grounded = grounded | (hit & (wny >= MAX_SLOPE_COS))
    return torch.stack([px, py, pz], 1), torch.stack([vx, vy, vz], 1), grounded
