"""Kernel K2: closest-hit t of rays against the static triangle soup
(counterpart of c_game_engine_tpu/ops/ray_tris.py::ray_tris_pallas).

Two-sided Moller-Trumbore; a hit needs |det| > 1e-9 and t in
(1e-5, max_dist]; 1e30 means a miss. Each 128-ray block visits the chunks
that overlap its rays' segment XZ box (margin 0). Rays are padded with
zeros to a multiple of 128; a padded lane is a point at the origin, which
widens its block's box as it does on the TPU.

In this reference `ray_tris` always runs `ray_tris_plain`, the plain
PyTorch version of the port's kernel, on any device: it builds the lists
with `chunk_lists`, launches no kernel and counts nothing.
"""

from __future__ import annotations

import functools

import torch

from refsim.ops.capsule_resolve import T_CHUNK
from refsim.ops.chunk_compact import (
    block_minmax,
    compact_chunk_lists,
    gather_listed_chunks,
)
from refsim.physics import geometry_soa as g

BLK = 128
MISS = 1e30


def _pack(origin, direction, max_dist):
    """[8, R'] ray table (ox oy oz dx dy dz max_t pad), R' = R padded with
    zero rays to a multiple of 128."""
    r = origin.shape[0]
    pad = (-r) % BLK
    rays = torch.zeros((8, r + pad), dtype=torch.float32, device=origin.device)
    rays[0:3, :r] = origin.T
    rays[3:6, :r] = direction.T
    rays[6, :r] = max_dist
    return rays


def chunk_lists(chunk_bounds, rays):
    """Per-128-ray-block chunk lists over the ray segments' XZ boxes."""
    exx = rays[0] + rays[3] * rays[6]
    ezz = rays[2] + rays[5] * rays[6]
    xmin, _ = block_minmax(torch.minimum(rays[0], exx), BLK)
    _, xmax = block_minmax(torch.maximum(rays[0], exx), BLK)
    zmin, _ = block_minmax(torch.minimum(rays[2], ezz), BLK)
    _, zmax = block_minmax(torch.maximum(rays[2], ezz), BLK)
    return compact_chunk_lists(chunk_bounds, xmin, xmax, zmin, zmax, 0.0)


def _check(tri16, chunk_bounds, origin, direction, max_dist):
    if tri16.ndim != 2 or tri16.shape[1] != 16 or tri16.shape[0] < T_CHUNK * chunk_bounds.shape[0]:
        raise ValueError(f"tri16 {tuple(tri16.shape)} does not cover {chunk_bounds.shape[0]} chunks")
    if chunk_bounds.ndim != 2 or chunk_bounds.shape[1] != 4:
        raise ValueError(f"chunk_bounds must be [NC, 4], got {tuple(chunk_bounds.shape)}")
    r = origin.shape[0]
    if origin.shape != (r, 3) or direction.shape != (r, 3):
        raise ValueError(f"origin/direction must be [R, 3], got {tuple(origin.shape)}, {tuple(direction.shape)}")
    ts = (tri16, chunk_bounds, origin, direction)
    if isinstance(max_dist, torch.Tensor):
        if max_dist.shape not in ((), (r,)):
            raise ValueError(f"max_dist must be a scalar or [R], got {tuple(max_dist.shape)}")
        ts += (max_dist,)
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"expected float32, got {t.dtype}")
        if t.device != origin.device:
            raise ValueError("all inputs must be on one device")


def ray_tris(tri16, chunk_bounds, origin, direction, max_dist):
    """origin/direction [R, 3], max_dist scalar or [R] -> t [R] (1e30 = miss)."""
    _check(tri16, chunk_bounds, origin, direction, max_dist)
    rays = _pack(origin, direction, max_dist)
    t = _ray_tris_plain(tri16, *chunk_lists(chunk_bounds, rays), rays)
    return t[: origin.shape[0]]


def _ray_tris_plain(tri16, idx, cnt, rays):
    r = rays.shape[1]
    G = r // BLK
    tri, tvalid = gather_listed_chunks(tri16, idx, cnt, T_CHUNK)
    col = lambda k: tri[:, None, :, k]  # [G, 1, K]
    lane = lambda k: rays[k].reshape(G, BLK, 1)
    hit, t = g.ray_tri_soa(
        lane(0), lane(1), lane(2), lane(3), lane(4), lane(5),
        col(0), col(1), col(2), col(3), col(4), col(5), col(6), col(7), col(8),
        lane(6),
    )
    t = torch.where(hit & (tvalid[:, None, :] > 0.5), t, MISS)
    tbest = torch.full((G, BLK, 1), MISS, device=rays.device)
    return torch.cat([tbest, t], -1).amin(-1).reshape(r)
