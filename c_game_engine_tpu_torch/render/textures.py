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

The JAX dual-level atlas (`build_atlas(dual=True)`, `_sample_dual`) is
not ported: nothing in either package builds one.
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
    mip_pairs: torch.Tensor  # [T, MAX_MIPS, 8] f32: level L rect | level min(L+1, last) rect
    flag_words: torch.Tensor  # [T] i32: repeat << 21 | filter << 22


def _downsample(px: np.ndarray) -> np.ndarray:
    """2x2 box filter (odd sizes drop the last row/col, min size 1)."""
    h, w = px.shape[:2]
    nh, nw = max(h // 2, 1), max(w // 2, 1)
    px = px[: nh * 2, : nw * 2] if (h > 1 and w > 1) else px
    if h > 1 and w > 1:
        return 0.25 * (px[0::2, 0::2] + px[1::2, 0::2] + px[0::2, 1::2] + px[1::2, 1::2])
    if h > 1:
        return 0.5 * (px[0::2] + px[1::2])
    if w > 1:
        return 0.5 * (px[:, 0::2] + px[:, 1::2])
    return px


def build_atlas(textures: list, device="cuda") -> TextureAtlas:
    """Shelf-pack decoded Texture objects (assets/codecs.py::Texture) and the
    mip chains of those with the mipmaps flag, on `device`. The rows are
    stored in bfloat16, the JAX default (8-bit sources lose at most 0.2% a
    channel)."""
    textures = list(textures or [])
    # per-texture mip pyramids (level 0 = the texture itself)
    chains = []
    for t in textures:
        levels = [np.asarray(t.pixels, np.float32)]
        if t.mipmaps:
            while len(levels) < MAX_MIPS and max(levels[-1].shape[:2]) > 1:
                levels.append(_downsample(levels[-1]))
        chains.append(levels)

    rects = [(lv.shape[1], lv.shape[0]) for ch in chains for lv in ch]
    # shelf pack, 1px gutter
    width = 1
    max_w = max([w for w, h in rects], default=1)
    area = sum((w + 2) * (h + 2) for w, h in rects) or 1
    while width < max_w + 2 or width * width < area:
        width *= 2
    x, y, shelf = 1, 1, 0
    pos = []
    for w, h in rects:
        if x + w + 1 > width:
            x, y, shelf = 1, y + shelf + 2, 0
        pos.append((x, y))
        x += w + 2
        shelf = max(shelf, h)
    height = 1
    while height < y + shelf + 1:
        height *= 2

    blocked = np.zeros((height, width, 16), np.float32)
    nt = max(len(textures), 1)
    table = np.zeros((nt, 6), np.float32)
    mips = np.zeros((nt, MAX_MIPS, 4), np.float32)
    n_mips = np.ones(nt, np.float32)
    ri = 0
    for i, (t, ch) in enumerate(zip(textures, chains)):
        for li, lv in enumerate(ch):
            px, py = pos[ri]
            ri += 1
            lh, lw = lv.shape[:2]
            if t.repeat:
                xn = (np.arange(lw) + 1) % lw
                yn = (np.arange(lh) + 1) % lh
            else:
                xn = np.minimum(np.arange(lw) + 1, lw - 1)
                yn = np.minimum(np.arange(lh) + 1, lh - 1)
            blocked[py : py + lh, px : px + lw, 0:4] = lv
            blocked[py : py + lh, px : px + lw, 4:8] = lv[:, xn]
            blocked[py : py + lh, px : px + lw, 8:12] = lv[yn]
            blocked[py : py + lh, px : px + lw, 12:16] = lv[yn][:, xn]
            mips[i, li] = [px, py, lw, lh]
            if li == 0:
                table[i] = [px, py, lw, lh, float(t.repeat), float(t.filter)]
        # pad the chain by repeating the last level (lod clamps there)
        for li in range(len(ch), MAX_MIPS):
            mips[i, li] = mips[i, len(ch) - 1]
        n_mips[i] = len(ch)
    if not textures:
        mips[0, :] = [0, 0, 1, 1]
    # rect pairs: level L alongside min(L+1, n_mips-1)
    pairs = np.concatenate([mips, np.concatenate([mips[:, 1:], mips[:, -1:]], axis=1)], axis=2)
    flag_words = ((table[:, 4] > 0.5).astype(np.int32) * (1 << 21)
                  + (table[:, 5] > 0.5).astype(np.int32) * (1 << 22))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return TextureAtlas(
        blocked=t(blocked).to(torch.bfloat16),
        table=t(table),
        mips=t(mips),
        n_mips=t(n_mips),
        mip_pairs=t(pairs),
        flag_words=t(flag_words),
    )

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
