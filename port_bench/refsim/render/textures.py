"""Texture atlas (counterpart of c_game_engine_tpu/render/textures.py): all
textures a map references packed into one array (`build_atlas`, host side,
numpy, then moved to a device) and sampled with PyTorch ops.

`blocked[y, x]` holds a texel's 2x2 neighbourhood (c00, c10(+x), c01(+y),
c11) as 16 channels in bfloat16, the +1 neighbours pre-wrapped or clamped
per the texture's repeat mode, so a bilinear tap is one gather. The rows
are built in float32 and rounded to bfloat16 once, to nearest even, as
`jnp.asarray(...).astype(bfloat16)` rounds them. Per-texture flags: repeat
wraps the uv, else clamps; filter is bilinear (trilinear across mip
levels), else nearest.

`build_atlas(dual=True)` also packs the dual-level rows (`TextureAtlas.dual`):
each texel's 2x2 block beside the next mip level's 3x3 neighbourhood, so a
trilinear tap is one 52-channel gather (`_sample_dual`) instead of two
16-channel ones, with the same result bit for bit. The bundle construction
(render/bundle.py) builds no dual atlas, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

MAX_MIPS = 6  # copied from c_game_engine_tpu/render/textures.py:28


@dataclasses.dataclass
class TextureAtlas:
    blocked: torch.Tensor  # [AH, AW, 16] bf16
    table: torch.Tensor  # [T, 6] f32: x0, y0, w, h, repeat, filter
    mips: torch.Tensor  # [T, MAX_MIPS, 4] f32: x0, y0, w, h per level
    n_mips: torch.Tensor  # [T] f32 (1 = no chain)
    mip_pairs: torch.Tensor | None = None  # [T, MAX_MIPS, 8] f32: level L rect | level min(L+1, last) rect
    flag_words: torch.Tensor | None = None  # [T] i32: repeat << 21 | filter << 22
    # dual-level rows: dual[y, x, 0:16] = blocked[y, x]; dual[y, x, 16:52] =
    # the next mip level's 3x3 texel neighbourhood (row-major (dy, dx), 4
    # channels each) anchored at (x // 2 - 1, y // 2 - 1) in that level,
    # wrapped or clamped per the texture's repeat mode. A level L+1
    # bilinear footprint from the same uv lands within that 3x3, so a
    # trilinear tap is one gather. A chain's last level embeds itself (its
    # blend fraction is 0). None unless build_atlas(dual=True).
    dual: torch.Tensor | None = None  # [AH, AW, 52]

    @property
    def size(self):
        """(width, height) of the blocked atlas."""
        return self.blocked.shape[1], self.blocked.shape[0]


def _block_coords(rect, repeat, u, v):
    """The texel block (xi, yi) of the atlas a tap at (u, v) in `rect`
    reads, its fractions (tx, ty), and its block within the level (bx, by).
    Clamp mode pins fx into [0, w-1] before the floor; repeat mode floors
    first and wraps the block index."""
    x0, y0, w, h = rect[..., 0], rect[..., 1], rect[..., 2], rect[..., 3]
    fx = u * w - 0.5
    fy = v * h - 0.5
    fx = torch.where(repeat, fx, torch.minimum(fx.clamp_min(0.0), (w - 1.0).clamp_min(0.0)))
    fy = torch.where(repeat, fy, torch.minimum(fy.clamp_min(0.0), (h - 1.0).clamp_min(0.0)))
    ix0 = torch.floor(fx)
    iy0 = torch.floor(fy)
    tx = fx - ix0
    ty = fy - iy0
    bx = torch.where(repeat, torch.remainder(ix0, w.clamp_min(1.0)), ix0)
    by = torch.where(repeat, torch.remainder(iy0, h.clamp_min(1.0)), iy0)
    return x0 + bx, y0 + by, tx, ty, bx, by


def _wrap_uv(repeat, uv):
    u = uv[..., 0]
    v = uv[..., 1]
    u = torch.where(repeat, u - torch.floor(u), u.clamp(0.0, 1.0))
    v = torch.where(repeat, v - torch.floor(v), v.clamp(0.0, 1.0))
    return u, v


def _fetch(rows, xf, yf):
    """rows[yi, xi] as float32 for float atlas coordinates; an index the JAX
    gather would clamp is clamped here too."""
    ah, aw, ch = rows.shape
    xi = xf.to(torch.int32).clamp(0, aw - 1)
    yi = yf.to(torch.int32).clamp(0, ah - 1)
    return rows.reshape(ah * aw, ch)[(yi * aw + xi).long()].float()


def _filter_block(blk, tx, ty, bilinear):
    """Bilinear or nearest value of a 2x2 block [..., 16] (c00, c10, c01, c11)."""
    c00, c10, c01, c11 = blk[..., 0:4], blk[..., 4:8], blk[..., 8:12], blk[..., 12:16]
    lin = (
        c00 * ((1 - tx) * (1 - ty))[..., None]
        + c10 * (tx * (1 - ty))[..., None]
        + c01 * ((1 - tx) * ty)[..., None]
        + c11 * (tx * ty)[..., None]
    )
    near_x = (tx > 0.5)[..., None]
    near_y = (ty > 0.5)[..., None]
    nearest = torch.where(near_y, torch.where(near_x, c11, c01), torch.where(near_x, c10, c00))
    return torch.where(bilinear[..., None], lin, nearest)


def _sample_dual(atlas, rect, rect1, repeat, bilinear, uv, frac):
    """Trilinear tap from one dual-row gather: the level-L 2x2 block and the
    embedded level-L+1 3x3 neighbourhood (TextureAtlas.dual). The level-L
    math is _sample_level's; the L+1 bilinear footprint is found in the
    stored 3x3 by its offset from the anchor (x // 2 - 1, y // 2 - 1),
    exact for even level widths (every power-of-two chain); odd deep levels
    clip to the nearest stored texel."""
    u, v = _wrap_uv(repeat, uv)
    xf, yf, tx, ty, bx, by = _block_coords(rect, repeat, u, v)
    blk = _fetch(atlas.dual, xf, yf)  # [..., 52]
    c0 = _filter_block(blk, tx, ty, bilinear)

    # ---- the L+1 tap out of the embedded 3x3
    w1, h1 = rect1[..., 2], rect1[..., 3]
    fx1 = u * w1 - 0.5
    fy1 = v * h1 - 0.5
    fx1 = torch.where(repeat, fx1, torch.minimum(fx1.clamp_min(0.0), (w1 - 1.0).clamp_min(0.0)))
    fy1 = torch.where(repeat, fy1, torch.minimum(fy1.clamp_min(0.0), (h1 - 1.0).clamp_min(0.0)))
    ix1 = torch.floor(fx1)
    iy1 = torch.floor(fy1)
    tx1 = fx1 - ix1
    ty1 = fy1 - iy1
    bx1 = torch.where(repeat, torch.remainder(ix1, w1.clamp_min(1.0)), ix1)
    by1 = torch.where(repeat, torch.remainder(iy1, h1.clamp_min(1.0)), iy1)
    offx = bx1 - torch.floor(bx * 0.5) + 1.0
    offy = by1 - torch.floor(by * 0.5) + 1.0
    offx = torch.where(repeat, torch.remainder(offx, w1.clamp_min(1.0)), offx).clamp(0.0, 1.0)
    offy = torch.where(repeat, torch.remainder(offy, h1.clamp_min(1.0)), offy).clamp(0.0, 1.0)

    cidx = torch.arange(3, dtype=torch.float32, device=uv.device)
    nx = offx + (tx1 > 0.5)
    ny = offy + (ty1 > 0.5)
    wx3 = torch.where(
        bilinear[..., None],
        (cidx == offx[..., None]) * (1.0 - tx1)[..., None] + (cidx == offx[..., None] + 1.0) * tx1[..., None],
        (cidx == nx[..., None]).float(),
    )  # [..., 3]
    wy3 = torch.where(
        bilinear[..., None],
        (cidx == offy[..., None]) * (1.0 - ty1)[..., None] + (cidx == offy[..., None] + 1.0) * ty1[..., None],
        (cidx == ny[..., None]).float(),
    )
    # the 9 terms added in the JAX order (row-major), each weight one
    # product: the two-tap path's four nonzero terms in its own order
    c1 = torch.zeros_like(c0)
    for j in range(3):
        for i in range(3):
            ch = 16 + (j * 3 + i) * 4
            c1 = c1 + (wy3[..., j] * wx3[..., i])[..., None] * blk[..., ch : ch + 4]
    return c0 + (c1 - c0) * frac[..., None]


def _sample_level(atlas, rect, repeat, bilinear, uv):
    """Bilinear or nearest fetch within one mip rect: one blocked gather."""
    u, v = _wrap_uv(repeat, uv)
    xf, yf, tx, ty, _, _ = _block_coords(rect, repeat, u, v)
    return _filter_block(_fetch(atlas.blocked, xf, yf), tx, ty, bilinear)


def sample(atlas: TextureAtlas, tex_id, uv, lod=None, flags=None):
    """Sample texture `tex_id` [...] i32 at `uv` [..., 2]; returns [..., 4].
    lod [...] f32 is the mip level (None = base level only). Trilinear
    between the two straddling levels for filtered textures, nearest level
    otherwise.

    flags: optional ([...] repeat bool, [...] bilinear bool) carried per
    pixel by the rasterizer's enc word; with them and a lod already clamped
    to the texture's chain, the per-pixel metadata is one mip_pairs row.
    Results equal the flagless path's."""
    tid = tex_id.clamp(0, atlas.table.shape[0] - 1).long()
    if flags is not None:
        repeat, bilinear = flags
        mp = atlas.mip_pairs.reshape(-1, 8)
        if lod is None:
            rect = mp[tid * MAX_MIPS][..., :4]
            return _sample_level(atlas, rect, repeat, bilinear, uv)
        l0 = torch.floor(lod).to(torch.int32)
        frac = torch.where(bilinear, lod - l0.float(), 0.0)
        pair = mp[tid * MAX_MIPS + l0.long()]  # [..., 8]
        c0 = _sample_level(atlas, pair[..., 0:4], repeat, bilinear, uv)
        c1 = _sample_level(atlas, pair[..., 4:8], repeat, bilinear, uv)
        return c0 + (c1 - c0) * frac[..., None]

    t = atlas.table[tid]
    repeat = t[..., 4] > 0.5
    bilinear = t[..., 5] > 0.5
    if lod is None:
        return _sample_level(atlas, t[..., :4], repeat, bilinear, uv)

    max_l = (atlas.n_mips[tid] - 1.0).clamp_min(0.0)
    lodc = torch.minimum(lod.clamp_min(0.0), max_l)
    l0 = torch.floor(torch.where(bilinear, lodc, torch.round(lodc))).to(torch.int32)
    l1 = torch.minimum(l0 + 1, max_l.to(torch.int32))
    frac = torch.where(bilinear, lodc - l0.float(), 0.0)
    mips_flat = atlas.mips.reshape(-1, 4)
    r0 = mips_flat[tid * MAX_MIPS + l0.long()]
    r1 = mips_flat[tid * MAX_MIPS + l1.long()]
    if atlas.dual is not None:
        return _sample_dual(atlas, r0, r1, repeat, bilinear, uv, frac)
    c0 = _sample_level(atlas, r0, repeat, bilinear, uv)
    c1 = _sample_level(atlas, r1, repeat, bilinear, uv)
    return c0 + (c1 - c0) * frac[..., None]
