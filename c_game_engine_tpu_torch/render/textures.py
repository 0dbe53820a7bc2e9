"""Texture atlas sampling (counterpart of c_game_engine_tpu/render/textures.py).

The atlas itself is built by the JAX package (`build_atlas`) and arrives
with the render bundle (`render/bundle.py::load_bundle`); this module holds
it as tensors and samples it. `blocked[y, x]` holds a texel's 2x2
neighbourhood (c00, c10(+x), c01(+y), c11) as 16 channels in bfloat16, the
+1 neighbours pre-wrapped or clamped per the texture's repeat mode, so a
bilinear tap is one gather. Per-texture flags: repeat wraps the uv, else
clamps; filter is bilinear (trilinear across mip levels), else nearest.

The dual-level atlas (`build_atlas(dual=True)`, `_sample_dual`) is not
ported: the exported bundle never carries one.
"""

from __future__ import annotations

import dataclasses

import torch

MAX_MIPS = 6  # copied from c_game_engine_tpu/render/textures.py:28


@dataclasses.dataclass
class TextureAtlas:
    blocked: torch.Tensor  # [AH, AW, 16] bf16
    table: torch.Tensor  # [T, 6] f32: x0, y0, w, h, repeat, filter
    mips: torch.Tensor  # [T, MAX_MIPS, 4] f32: x0, y0, w, h per level
    n_mips: torch.Tensor  # [T] f32 (1 = no chain)
    mip_pairs: torch.Tensor  # [T, MAX_MIPS, 8] f32: level L rect | level min(L+1, last) rect
    flag_words: torch.Tensor  # [T] i32: repeat << 21 | filter << 22


def _sample_level(atlas, rect, repeat, bilinear, uv):
    """Bilinear or nearest fetch within one mip rect: one blocked gather.
    Clamp mode pins fx into [0, w-1] before the floor; repeat mode floors
    first and wraps the block index."""
    x0, y0, w, h = rect[..., 0], rect[..., 1], rect[..., 2], rect[..., 3]
    u = uv[..., 0]
    v = uv[..., 1]
    u = torch.where(repeat, u - torch.floor(u), u.clamp(0.0, 1.0))
    v = torch.where(repeat, v - torch.floor(v), v.clamp(0.0, 1.0))

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
    ah, aw = atlas.blocked.shape[:2]
    # an index the JAX gather would clamp is clamped here too
    xi = (x0 + bx).to(torch.int32).clamp(0, aw - 1)
    yi = (y0 + by).to(torch.int32).clamp(0, ah - 1)
    flat = atlas.blocked.reshape(ah * aw, 16)
    blk = flat[(yi * aw + xi).long()].float()  # [..., 16]
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
    c0 = _sample_level(atlas, r0, repeat, bilinear, uv)
    c1 = _sample_level(atlas, r1, repeat, bilinear, uv)
    return c0 + (c1 - c0) * frac[..., None]
