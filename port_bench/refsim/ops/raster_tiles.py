"""Kernel K4: tile rasterization with in-kernel binning and attribute
interpolation (counterpart of
c_game_engine_tpu/ops/raster_tiles.py::raster_tiles_pallas, with its
binning pass `bin_triangles`).

The framebuffer is cut into 8 x 128 tiles. `bin_triangles` hands every tile
the indices of the triangles whose screen bbox overlaps it, in index order,
at most L = min(T, L_CAP) of them (a tile with more drops the highest
indices). For each pixel the walk goes over its tile's list in order: edge
functions, affine z, and a strictly-closer test
`inside & (z > 0) & (z < 1) & (z < zbuf) & (id != exclude)`; where it holds,
the triangle's perspective-correct uv, lightmap uv, rgba, fragment depth
and enc word replace the pixel's. The walk is serial and the test strict,
so of two triangles at equal z the lower index wins.

tri48 column layout (f32): 0-5 sx0 sy0 sx1 sy1 sx2 sy2 | 6-8 z0 z1 z2 |
9 id | 10-12 iw0 iw1 iw2 | 13-18 uv per vertex | 19-24 lmuv per vertex |
25-36 rgba per vertex | 37 enc (exact in f32 below 2^24) | 38-47 unused.

Outputs, each [B, H, W]: zbuf f32 (+inf none), winner i32 (-1 none),
frag_depth, uv_u, uv_v, lm_u, lm_v, col_r, col_g, col_b, col_a (f32, 0
none), enc i32 (0 none).

`raster_tiles_binned` is the render path's entry point. In this
reference it always runs `bin_triangles` and the plain walk `_plain`, the
plain PyTorch version of the port's kernel, on any device: it launches no
kernel and counts nothing. `tile_on` gates tiles off, as K5's does: a
gated tile lists nothing and keeps the initial values. `raster_tiles` and
`raster_tiles_plain` take lists built by `bin_triangles` (or any lists)
and run the plain walk.
"""

from __future__ import annotations

import functools

import torch


TILE_H = 8
TILE_W = 128
L_CAP = 512
N_COLS = 48


def bin_triangles(sx, sy, tri_ok, height, width):
    """Per-tile triangle lists. sx/sy [B, T, 3] screen coordinates, tri_ok
    [B, T] bool. Returns (idx [B, NTy, NTx, L] i32, cnt [B, NTy, NTx] i32):
    the overlapping triangle ids of each tile first, in increasing order,
    the rest of the row T - 1, and cnt clipped to L = min(T, L_CAP)."""
    b, t = sx.shape[:2]
    nty, ntx = height // TILE_H, width // TILE_W
    L = min(t, L_CAP)
    dev = sx.device
    xmin, xmax = sx.amin(-1), sx.amax(-1)
    ymin, ymax = sy.amin(-1), sy.amax(-1)
    tyi = torch.arange(nty, dtype=torch.float32, device=dev)[:, None, None]
    txi = torch.arange(ntx, dtype=torch.float32, device=dev)[None, :, None]
    e = lambda a: a[:, None, None, :]
    ov = (
        e(tri_ok)
        & (e(xmin) <= (txi + 1.0) * TILE_W)
        & (e(xmax) >= txi * TILE_W)
        & (e(ymin) <= (tyi + 1.0) * TILE_H)
        & (e(ymax) >= tyi * TILE_H)
    )  # [B, NTy, NTx, T]
    # stream compaction in index order: the same lists a sort of
    # where(ov, id, T) gives, with the pad entries clipped to T - 1
    pos = torch.cumsum(ov, dim=-1, dtype=torch.int32) - 1
    dest = torch.where(ov & (pos < L), pos, L).long()
    ids = torch.arange(t, dtype=torch.int32, device=dev).expand(ov.shape)
    idx = torch.full((b, nty, ntx, L + 1), t - 1, dtype=torch.int32, device=dev)
    idx.scatter_(-1, dest, ids)  # slot L takes every dropped id and is cut off
    cnt = ov.sum(-1, dtype=torch.int32).clamp_max(L)
    return idx[..., :L].contiguous(), cnt


def _check_table(tri48, height, width):
    if height % TILE_H or width % TILE_W:
        raise NotImplementedError(f"K4 needs whole {TILE_H}x{TILE_W} tiles, got {height}x{width}")
    if tri48.ndim != 3 or tri48.shape[2] != N_COLS or tri48.shape[1] == 0:
        raise ValueError(f"tri48 must be [B, T, {N_COLS}] with T > 0, got {tuple(tri48.shape)}")
    if tri48.dtype != torch.float32:
        raise TypeError(f"tri48: expected torch.float32, got {tri48.dtype}")


def _check_inputs(tri48, named):
    """Each (name, tensor or None, shape, dtype) of `named` against tri48."""
    for name, x, shape, dt in named:
        if x is None:
            continue
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got {tuple(x.shape)}")
        if x.dtype != dt:
            raise TypeError(f"{name}: expected {dt}, got {x.dtype}")
        if x.device != tri48.device:
            raise ValueError("all inputs must be on one device")


def _check_binned(tri48, tri_ok, exclude, tile_on, height, width):
    _check_table(tri48, height, width)
    b, t = tri48.shape[:2]
    nty, ntx = height // TILE_H, width // TILE_W
    _check_inputs(tri48, (("tri_ok", tri_ok, (b, t), torch.bool),
                          ("exclude", exclude, (b, height, width), torch.int32),
                          ("tile_on", tile_on, (b, nty * ntx), torch.int32)))


def raster_tiles_binned(tri48, tri_ok, height, width, exclude=None, tile_on=None):
    """tri48 [B, T, 48], tri_ok [B, T] bool, exclude [B, H, W] i32 (-1
    none; None: no image), tile_on [B, NTy * NTx] i32 (0 gates a tile off;
    None: all on) -> the 12 planes: `bin_triangles` and the plain walk, on
    any device."""
    _check_binned(tri48, tri_ok, exclude, tile_on, height, width)
    return _binned_plain(tri48, tri_ok, exclude, tile_on, height, width)


def _gated_lists(tri48, tri_ok, tile_on, height, width):
    """bin_triangles' lists of the table's screen coordinates, with the
    counts of the gated-off tiles zeroed."""
    idx, cnt = bin_triangles(tri48[..., 0:6:2], tri48[..., 1:6:2], tri_ok, height, width)
    if tile_on is not None:
        cnt = torch.where(tile_on.reshape(cnt.shape) != 0, cnt, 0)
    return idx, cnt


def _binned_plain(tri48, tri_ok, exclude, tile_on, height, width):
    idx, cnt = _gated_lists(tri48, tri_ok, tile_on, height, width)
    return _plain(tri48, idx, cnt, exclude, height, width)


def inside_pairs(tri48, tri_ok, height, width, tile_on=None):
    """How many (pixel, row) pairs of the walk have the pixel inside the
    row's triangle: the pairs on which the kernel computes the denominator,
    z and the division (chip_smoke.py's bound). The edge functions of
    `_plain`; reads the lists' lengths on the host."""
    idx, cnt = _gated_lists(tri48, tri_ok, tile_on, height, width)
    gx, gy = _centres(height // TILE_H, width // TILE_W, tri48.device)
    bi = torch.arange(tri48.shape[0], device=tri48.device)[:, None, None]
    n = torch.zeros((), dtype=torch.int64, device=tri48.device)
    for j in range(int(cnt.max()) if cnt.numel() else 0):
        row = tri48[bi, idx[..., j].long()]  # [B, NTy, NTx, 48]
        ax, ay, bx, by, cx, cy = (row[..., k, None, None] for k in range(6))
        e0 = (bx - ax) * (gy - ay) - (by - ay) * (gx - ax)
        e1 = (cx - bx) * (gy - by) - (cy - by) * (gx - bx)
        e2 = (ax - cx) * (gy - cy) - (ay - cy) * (gx - cx)
        inside = ((e0 <= 0) & (e1 <= 0) & (e2 <= 0)) | ((e0 >= 0) & (e1 >= 0) & (e2 >= 0))
        n += (inside & (cnt > j)[..., None, None]).sum()
    return int(n)


def _planes(out_f, out_i):
    z, fd, u, v, lu, lv, cr, cg, cb, ca = out_f.unbind(0)
    return (z, out_i[0], fd, u, v, lu, lv, cr, cg, cb, ca, out_i[1])


def _centres(nty, ntx, dev):
    """The pixel centres (gx, gy), each [1, NTy, NTx, TILE_H, TILE_W]."""
    f32 = torch.float32
    gx = ((torch.arange(ntx, device=dev) * TILE_W).to(f32)[None, :, None, None]
          + torch.arange(TILE_W, device=dev).to(f32)[None, None, None, :]) + 0.5
    gy = ((torch.arange(nty, device=dev) * TILE_H).to(f32)[:, None, None, None]
          + torch.arange(TILE_H, device=dev).to(f32)[None, None, :, None]) + 0.5
    return gx.expand(nty, ntx, TILE_H, TILE_W)[None], gy.expand(nty, ntx, TILE_H, TILE_W)[None]


def _plain(tri48, idx, cnt, exclude, height, width):
    """Every tile's pixels at once, a serial loop over list position (no
    exclude image: nothing excluded). Each expression is the kernel's, in
    its order."""
    b = tri48.shape[0]
    nty, ntx = height // TILE_H, width // TILE_W
    dev = tri48.device
    f32 = torch.float32
    gx, gy = _centres(nty, ntx, dev)
    tiled = lambda a: a.reshape(b, nty, TILE_H, ntx, TILE_W).permute(0, 1, 3, 2, 4)
    excl = torch.tensor(-1, dtype=torch.int32, device=dev) if exclude is None else tiled(exclude)
    shape = (b, nty, ntx, TILE_H, TILE_W)
    zbuf = torch.full(shape, torch.inf, dtype=f32, device=dev)
    tid = torch.full(shape, -1.0, dtype=f32, device=dev)
    attrs = [torch.zeros(shape, dtype=f32, device=dev) for _ in range(10)]  # fd u v lu lv cr cg cb ca enc
    n = int(cnt.max()) if cnt.numel() else 0
    bi = torch.arange(b, device=dev)[:, None, None]
    for j in range(n):
        live = (cnt > j)[..., None, None]
        row = tri48[bi, idx[..., j].long()]  # [B, NTy, NTx, 48]
        c = lambda k: row[..., k, None, None]
        ax, ay, bx, by, cx, cy = c(0), c(1), c(2), c(3), c(4), c(5)
        e0 = (bx - ax) * (gy - ay) - (by - ay) * (gx - ax)
        e1 = (cx - bx) * (gy - by) - (cy - by) * (gx - bx)
        e2 = (ax - cx) * (gy - cy) - (ay - cy) * (gx - cx)
        inside = ((e0 <= 0) & (e1 <= 0) & (e2 <= 0)) | ((e0 >= 0) & (e1 >= 0) & (e2 >= 0))
        denom = e0 + e1 + e2
        denom = torch.where(denom.abs() > 1e-9, denom, torch.tensor(1e-9, dtype=f32, device=dev))
        z0, z1, z2 = c(6), c(7), c(8)
        z = (e1 * z0 + e2 * z1 + e0 * z2) / denom
        ti = c(9)
        closer = live & inside & (z > 0.0) & (z < 1.0) & (z < zbuf) & (ti.to(torch.int32) != excl)
        zbuf = torch.where(closer, z, zbuf)
        b0, b1, b2 = e1 / denom, e2 / denom, e0 / denom
        iw0, iw1, iw2 = c(10), c(11), c(12)
        iw = b0 * iw0 + b1 * iw1 + b2 * iw2
        pw = 1.0 / torch.clamp_min(iw, 1e-12)
        bw0, bw1, bw2 = b0 * iw0, b1 * iw1, b2 * iw2
        interp = lambda k0: (bw0 * c(k0) + bw1 * c(k0 + 2) + bw2 * c(k0 + 4)) * pw
        interp4 = lambda k0: (bw0 * c(k0) + bw1 * c(k0 + 4) + bw2 * c(k0 + 8)) * pw
        new = [(b0 * z0 + b1 * z1 + b2 * z2) * pw, interp(13), interp(14), interp(19), interp(20),
               interp4(25), interp4(26), interp4(27), interp4(28), c(37)]
        tid = torch.where(closer, ti, tid)
        attrs = [torch.where(closer, nv, old) for nv, old in zip(new, attrs)]
    image = lambda a: a.permute(0, 1, 3, 2, 4).reshape(b, height, width)
    fd, u, v, lu, lv, cr, cg, cb, ca, enc = attrs
    out_f = torch.stack([image(a) for a in (zbuf, fd, u, v, lu, lv, cr, cg, cb, ca)])
    out_i = torch.stack([image(tid).to(torch.int32), image(enc).to(torch.int32)])
    return _planes(out_f, out_i)
