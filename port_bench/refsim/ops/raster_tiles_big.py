"""Kernel K5: the streamed z and winner pass for big triangle tables
(counterpart of c_game_engine_tpu/ops/raster_tiles_big.py::raster_tiles_big,
with its `level_bboxes`).

The render path takes this route for maps whose live-triangle bound
exceeds the tile-kernel route's 65,536 (render/raster.py). The table is
not compacted: every soup row keeps its row, dead rows carry a screen bbox
that can never overlap (+1e30, -1e30, +1e30, -1e30), so winner ids stay in
the table's own row space and the attributes are gathered from the winner
image afterwards (render/raster.py::_attrs_from_winner). Two levels of
bbox unions prune the work: one per T_CHK-row chunk (`cbox`) and one per
SUB-row subchunk (`scb`); a row whose own bbox misses a tile is skipped
too. For each pixel the rows that remain are walked in increasing id
order with the strictly-closer test
`inside & (z > 0) & (z < 1) & (z < zbuf) & (id != exclude)`, so of two
rows at equal z the lower id wins. A tile whose `tile_on` entry is 0 keeps
the initial values (z +inf, winner -1).

trit layout [B, 16, T] f32, fields-major (T a multiple of T_CHK): rows 0-5
sx0 sy0 sx1 sy1 sx2 sy2 | 6-8 z0 z1 z2 | 9 unused | 10-13 bbox xmin xmax
ymin ymax | 14-15 unused.

In this reference `raster_tiles_big` always runs `raster_tiles_big_plain`,
the plain PyTorch version of the port's kernel, on any device: it
launches no kernel and counts nothing.
"""

from __future__ import annotations

import functools

import torch

from refsim.ops.raster_tiles import TILE_H, TILE_W

T_CHK = 4096  # rows per chunk
SUB = 64  # rows per subchunk
N_COLS_BIG = 16  # fields of the table (csrc/raster_tiles_big.cu: N_ROWS)
DEAD = 1e30  # the bbox bound of a row that can never overlap a tile


def level_bboxes(bxmin, bxmax, bymin, bymax, group):
    """Per-row screen bboxes [B, T] (dead rows +1e30/-1e30) grouped into
    [B, T // group, 4] unions (xmin, xmax, ymin, ymax); an all-dead group
    gets an inverted box, which overlaps nothing."""
    b = bxmin.shape[0]
    f = lambda a, red: red(a.reshape(b, -1, group), -1)
    return torch.stack([f(bxmin, torch.amin), f(bxmax, torch.amax), f(bymin, torch.amin),
                        f(bymax, torch.amax)], -1)


def _check(trit, cbox, scb, exclude, tile_on, height, width):
    if height % TILE_H or width % TILE_W:
        raise NotImplementedError(f"K5 needs whole {TILE_H}x{TILE_W} tiles, got {height}x{width}")
    if trit.ndim != 3 or trit.shape[1] != N_COLS_BIG or trit.shape[2] == 0 or trit.shape[2] % T_CHK:
        raise ValueError(f"trit must be [B, {N_COLS_BIG}, NC * {T_CHK}], got {tuple(trit.shape)}")
    b, nc = trit.shape[0], trit.shape[2] // T_CHK
    n_tiles = (height // TILE_H) * (width // TILE_W)
    for name, x, shape, dt in (
        ("cbox", cbox, (b, nc, 4), torch.float32),
        ("scb", scb, (b, nc * (T_CHK // SUB), 4), torch.float32),
        ("exclude", exclude, (b, height, width), torch.int32),
        ("tile_on", tile_on, (b, n_tiles), torch.int32),
    ):
        if x is None:
            continue
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got {tuple(x.shape)}")
        if x.dtype != dt:
            raise TypeError(f"{name}: expected {dt}, got {x.dtype}")
        if x.device != trit.device:
            raise ValueError("all inputs must be on one device")
    if trit.dtype != torch.float32:
        raise TypeError(f"trit: expected torch.float32, got {trit.dtype}")


def _all_on(trit, height, width, tile_on):
    if tile_on is not None:
        return tile_on
    n_tiles = (height // TILE_H) * (width // TILE_W)
    return torch.ones((trit.shape[0], n_tiles), dtype=torch.int32, device=trit.device)


def raster_tiles_big(trit, cbox, scb, height, width, exclude=None, tile_on=None):
    """trit [B, 16, T], cbox [B, NC, 4] and scb [B, NC * 64, 4] from
    level_bboxes, exclude [B, H, W] i32 (-1 none; None: no image),
    tile_on [B, NTy * NTx] i32 (0 gates a tile off; None: all on) ->
    (z [B, H, W] f32, winner [B, H, W] i32)."""
    tile_on = _all_on(trit, height, width, tile_on)
    _check(trit, cbox, scb, exclude, tile_on, height, width)
    return _plain(trit, exclude, tile_on, height, width)


def tile_lists(trit, height, width, tile_on=None):
    """(idx [B, NT, L] i64, cnt [B, NT] i64): for each (env, tile) of the
    flattened NTy x NTx tile order, the ids of the rows whose bbox overlaps
    the tile, in increasing order, with no cap (L = the longest list, at
    least 1; pad entries 0); a gated tile's list is empty."""
    b, _, t = trit.shape
    nty, ntx = height // TILE_H, width // TILE_W
    dev = trit.device
    x0 = (torch.arange(ntx, device=dev) * TILE_W).float().repeat(nty)
    y0 = (torch.arange(nty, device=dev) * TILE_H).float().repeat_interleave(ntx)
    r = lambda k: trit[:, k, None, :]
    ov = ((r(10) <= (x0 + TILE_W)[:, None]) & (r(11) >= x0[:, None])
          & (r(12) <= (y0 + TILE_H)[:, None]) & (r(13) >= y0[:, None]))  # [B, NT, T]
    if tile_on is not None:
        ov &= (tile_on != 0)[..., None]
    cnt = ov.sum(-1)
    nz = ov.nonzero()  # (env, tile, row), rows increasing within each (env, tile)
    start = torch.cumsum(cnt.reshape(-1), 0) - cnt.reshape(-1)
    flat = nz[:, 0] * nty * ntx + nz[:, 1]
    pos = torch.arange(nz.shape[0], device=dev) - start[flat]
    idx = torch.zeros((b * nty * ntx, max(int(cnt.max()), 1)), dtype=torch.int64, device=dev)
    idx[flat, pos] = nz[:, 2]
    return idx.reshape(b, nty * ntx, -1), cnt


def _plain(trit, exclude, tile_on, height, width):
    """Every tile's pixels at once, a serial loop over list position. Each
    expression is the kernel's, in its order."""
    b = trit.shape[0]
    nty, ntx = height // TILE_H, width // TILE_W
    dev = trit.device
    f32 = torch.float32
    idx, cnt = tile_lists(trit, height, width, tile_on)
    # pixel centres [1, NT, TILE_H, TILE_W]
    gx = ((torch.arange(ntx, device=dev) * TILE_W).to(f32)[None, :, None, None]
          + torch.arange(TILE_W, device=dev).to(f32)[None, None, None, :]) + 0.5
    gy = ((torch.arange(nty, device=dev) * TILE_H).to(f32)[:, None, None, None]
          + torch.arange(TILE_H, device=dev).to(f32)[None, None, :, None]) + 0.5
    gx = gx.expand(nty, ntx, TILE_H, TILE_W).reshape(1, nty * ntx, TILE_H, TILE_W)
    gy = gy.expand(nty, ntx, TILE_H, TILE_W).reshape(1, nty * ntx, TILE_H, TILE_W)
    tiled = lambda a: a.reshape(b, nty, TILE_H, ntx, TILE_W).permute(0, 1, 3, 2, 4).reshape(
        b, nty * ntx, TILE_H, TILE_W)
    excl = torch.tensor(-1, dtype=torch.int32, device=dev) if exclude is None else tiled(exclude)
    shape = (b, nty * ntx, TILE_H, TILE_W)
    zbuf = torch.full(shape, torch.inf, dtype=f32, device=dev)
    win = torch.full(shape, -1, dtype=torch.int32, device=dev)
    rows = trit[:, :9].transpose(1, 2)  # [B, T, 9]
    bi = torch.arange(b, device=dev)[:, None]
    tiny = torch.tensor(1e-9, dtype=f32, device=dev)
    for j in range(idx.shape[-1]):
        live = (cnt > j)[..., None, None]
        ids = idx[..., j]
        row = rows[bi, ids]  # [B, NT, 9]
        c = lambda k: row[..., k, None, None]
        ax, ay, bx, by, cx, cy = c(0), c(1), c(2), c(3), c(4), c(5)
        e0 = (bx - ax) * (gy - ay) - (by - ay) * (gx - ax)
        e1 = (cx - bx) * (gy - by) - (cy - by) * (gx - bx)
        e2 = (ax - cx) * (gy - cy) - (ay - cy) * (gx - cx)
        inside = ((e0 <= 0) & (e1 <= 0) & (e2 <= 0)) | ((e0 >= 0) & (e1 >= 0) & (e2 >= 0))
        denom = e0 + e1 + e2
        denom = torch.where(denom.abs() > 1e-9, denom, tiny)
        z = (e1 * c(6) + e2 * c(7) + e0 * c(8)) / denom
        ti = ids.to(torch.int32)[..., None, None]
        closer = live & inside & (z > 0.0) & (z < 1.0) & (z < zbuf) & (ti != excl)
        zbuf = torch.where(closer, z, zbuf)
        win = torch.where(closer, ti, win)
    image = lambda a: a.reshape(b, nty, ntx, TILE_H, TILE_W).permute(0, 1, 3, 2, 4).reshape(b, height, width)
    return image(zbuf), image(win)


def inside_pairs(trit, height, width, tile_on=None):
    """How many (pixel, row) pairs of the walk have the pixel inside the
    row's triangle: the pairs on which the kernel computes the denominator,
    z and the division (chip_smoke.py's bound). The same edge functions
    as `_plain`; reads the lists' lengths on the host."""
    b = trit.shape[0]
    nty, ntx = height // TILE_H, width // TILE_W
    dev = trit.device
    idx, cnt = tile_lists(trit, height, width, tile_on)
    x = torch.arange(ntx * TILE_W, device=dev).float().reshape(ntx, 1, TILE_W) + 0.5
    y = torch.arange(nty * TILE_H, device=dev).float().reshape(nty, TILE_H, 1) + 0.5
    gx = x.expand(nty, ntx, TILE_H, TILE_W).reshape(1, nty * ntx, TILE_H, TILE_W)
    gy = y[:, None].expand(nty, ntx, TILE_H, TILE_W).reshape(1, nty * ntx, TILE_H, TILE_W)
    rows = trit[:, :6].transpose(1, 2)  # [B, T, 6]
    bi = torch.arange(b, device=dev)[:, None]
    n = torch.zeros((), dtype=torch.int64, device=dev)
    for j in range(idx.shape[-1]):
        row = rows[bi, idx[..., j]]  # [B, NT, 6]
        ax, ay, bx, by, cx, cy = (row[..., k, None, None] for k in range(6))
        e0 = (bx - ax) * (gy - ay) - (by - ay) * (gx - ax)
        e1 = (cx - bx) * (gy - by) - (cy - by) * (gx - bx)
        e2 = (ax - cx) * (gy - cy) - (ay - cy) * (gx - cx)
        inside = ((e0 <= 0) & (e1 <= 0) & (e2 <= 0)) | ((e0 >= 0) & (e1 >= 0) & (e2 >= 0))
        n += (inside & (cnt > j)[..., None, None]).sum()
    return int(n)


