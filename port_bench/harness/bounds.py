"""The least time the card could take for a hand kernel's call: the work
its inputs need, counted from the inputs, over the published peaks of one
NVIDIA H100 SXM (67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s
of HBM). The counts are a frozen copy of the arithmetic the port's
chip_smoke.py prints (bound_ms, k1_bound, k4_bound), over the frozen
chunk lists and binning of refsim, so they read the same whatever
implements the kernel."""

from __future__ import annotations

import torch

from refsim.ops import capsule_resolve as K1
from refsim.ops import raster_tiles as K4

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# operations per (lane, triangle) pair and per (lane, box) of K1's
# resolve iteration; K4's (K5's walk counts): per listed (row, tile), per
# line and column of the tile, per (pixel, row) pair, per pair inside;
# K4's binning: per row's box and per compare against a tile; per covered
# pixel's attributes
K1_PAIR_FLOPS, K1_BOX_FLOPS = 380, 220
ROW_FLOPS, LINE_FLOPS, PAIR_FLOPS, INSIDE_FLOPS = 6, 6, 9, 13
K4_BOX_FLOPS, K4_BIN_FLOPS, K4_PIXEL_FLOPS = 8, 4, 67


def bound_ms(flops, nbytes) -> tuple:
    """(ms, "operations" or "bytes"): the larger of operations over the
    peak float32 rate and bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def distinct_listed(idx, cnt, env_rows=0) -> int:
    """How many distinct entries the lists idx [..., L] (first cnt [...]
    valid) hold; with env_rows > 0 the first axis is the env and each env
    lists rows of its own table of env_rows rows."""
    listed = torch.arange(idx.shape[-1], device=idx.device) < cnt[..., None]
    env = torch.arange(idx.shape[0], device=idx.device).view(-1, *([1] * (idx.ndim - 1)))
    return int(torch.unique((idx.long() + env * env_rows)[listed]).numel())


def listed_chunk_bytes(idx, cnt) -> int:
    """Bytes of the distinct 32-triangle chunks (2 KB each) some block lists."""
    return distinct_listed(idx, cnt) * 32 * 16 * 4


def k1_bound(args) -> tuple:
    """K1 (capsule resolve) on (tri16, chunk_bounds, box8, boxh, pos, vel)."""
    tri16, cb, box8, boxh, pos, vel = args
    idx, cnt = K1.chunk_lists(cb, pos)
    b, n = pos.shape[0], box8.shape[1]
    flops = K1.ITERS * (int(cnt.sum()) * 32 * K1.BLK * K1_PAIR_FLOPS + n * b * K1_BOX_FLOPS)
    nbytes = listed_chunk_bytes(idx, cnt) + (box8.numel() + boxh.numel()) * 4 + 4 * b * 3 * 4 + b
    return bound_ms(flops, nbytes)


def k4_bound(args, kwargs, planes) -> tuple:
    """K4 (tile raster, binning included) on (tri48, tri_ok, height,
    width) with its `exclude` and `tile_on` and the planes it returned.
    Bytes: every row's box and tri_ok once per env, the 38 columns of the
    rows some enabled tile lists, tile_on, the exclude ids of the enabled
    tiles' pixels and the 12 planes; operations: the binning, each listed
    (row, tile)'s edge-function factors, each (pixel, row) pair's inside
    test, z on the pairs inside, the attributes once per covered pixel."""
    tri48, tri_ok, h, w = args
    tile_on, exclude = kwargs.get("tile_on"), kwargs.get("exclude")
    b, t = tri48.shape[:2]
    idx, cnt = K4.bin_triangles(tri48[..., 0:6:2], tri48[..., 1:6:2], tri_ok, h, w)
    if tile_on is not None:
        cnt = torch.where(tile_on.reshape(cnt.shape) != 0, cnt, 0)
    n_rows = distinct_listed(idx, cnt, t)
    overlaps = int(cnt.sum())
    pairs = overlaps * K4.TILE_H * K4.TILE_W
    covered = int((planes[1] >= 0).sum())
    pixels = b * h * w
    tiles_on = cnt.numel() if tile_on is None else int((tile_on != 0).sum())
    nbytes = (t * b * (6 * 4 + 1) + n_rows * 38 * 4 + (0 if tile_on is None else tile_on.numel() * 4)
              + (0 if exclude is None else tiles_on * K4.TILE_H * K4.TILE_W * 4) + 12 * pixels * 4)
    inside = K4.inside_pairs(tri48, tri_ok, h, w, tile_on)
    flops = (K4_BOX_FLOPS * b * t + K4_BIN_FLOPS * t * tiles_on
             + (ROW_FLOPS + LINE_FLOPS * (K4.TILE_H + K4.TILE_W)) * overlaps
             + PAIR_FLOPS * pairs + INSIDE_FLOPS * inside + K4_PIXEL_FLOPS * covered)
    return bound_ms(flops, nbytes)
