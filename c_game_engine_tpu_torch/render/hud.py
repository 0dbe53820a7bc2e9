"""HUD overlay: coin counter, blue-coin icons and crosshair (counterpart
of c_game_engine_tpu/render/hud.py).

A 2D compositing pass over rendered frames: textured rects alpha-blended
(src-alpha, 1 - src-alpha) and bitmap-font text. Every function takes
frames [B, H, W, 3] and per-env values with a leading batch axis where the
JAX one takes one env; the assets are shared. As in the JAX package, a
rect samples its texture whatever its id and masks the pixels of an id
below 0 (a missing asset), so a HUD without assets leaves the frame as it
was.
"""

from __future__ import annotations

import dataclasses

import torch

from c_game_engine_tpu_torch.render.textures import sample
from c_game_engine_tpu_torch.utils.mathx import const

# copied from c_game_engine_tpu/render/hud.py: NORMAL, INTERACTABLE,
# INVISIBLE, ENEMY (Player.h:15-18)
CROSSHAIR_COLORS = ((1.0, 0.8, 0.8, 1.0), (0.0, 0.4, 0.0, 1.0), (1.0, 0.0, 0.0, 0.0), (1.0, 0.0, 0.0, 1.0))
MAX_DIGITS = 8


@dataclasses.dataclass
class HudAssets:
    ycoin_tex: torch.Tensor  # [] i32 atlas ids (-1 = missing)
    bcoin_tex: torch.Tensor
    crosshair_tex: torch.Tensor
    font_tex: torch.Tensor
    font_start_u: torch.Tensor  # [128] start U per ASCII code (-1 = absent)
    font_end_u: torch.Tensor  # [128]
    font_widths: torch.Tensor  # [128] glyph widths in texture pixels
    font_height: torch.Tensor  # [] texture height in pixels
    font_spacing: torch.Tensor  # [] spacing in pixels


HUD_FIELDS = tuple(f.name for f in dataclasses.fields(HudAssets))


def prefix_sum(x):
    """Inclusive prefix sum of float x [..., L] along its last axis, added
    in the order of the JAX package's `jnp.cumsum` on the CPU (XLA splits
    the scan into blocks of 16: each block summed left to right, the
    blocks' totals prefix-summed the same way and added to the next
    block's sums), so glyph positions round as the JAX ones do.
    torch.cumsum adds in its own order."""
    n = x.shape[-1]
    if n <= 16:
        cols = [x[..., 0]]
        for k in range(1, n):
            cols.append(cols[-1] + x[..., k])
        return torch.stack(cols, -1)
    nb = -(-n // 16)
    blocks = torch.nn.functional.pad(x, (0, nb * 16 - n)).reshape(*x.shape[:-1], nb, 16)
    within = prefix_sum(blocks)
    carry = prefix_sum(within[..., -1])  # [..., nb]
    out = torch.cat([within[..., :1, :], within[..., 1:, :] + carry[..., :-1, None]], -2)
    return out.reshape(*x.shape[:-1], nb * 16)[..., :n]


def _frame_axes(frame):
    """The frame's pixel rows [H, 1] and columns [1, W] as float32."""
    fh, fw = frame.shape[-3:-1]
    ys = torch.arange(fh, dtype=torch.float32, device=frame.device)[:, None]
    xs = torch.arange(fw, dtype=torch.float32, device=frame.device)[None, :]
    return ys, xs


def blit(frame, atlas, tex_id, x0, y0, w, h, mod_color):
    """Alpha-blend a textured rect onto frames [B, H, W, 3]; tex_id [] i32,
    the rect in frame pixels, mod_color [4] or per env [B, 4]."""
    ys, xs = _frame_axes(frame)
    u, v = torch.broadcast_tensors((xs - x0) / max(w, 1e-6), (ys - y0) / max(h, 1e-6))
    inside = (u >= 0) & (u < 1) & (v >= 0) & (v < 1) & (tex_id >= 0)
    tex = sample(atlas, tex_id.expand(u.shape), torch.stack([u, v], -1))  # [H, W, 4]
    rgba = tex * (mod_color[:, None, None, :] if mod_color.ndim == 2 else mod_color)
    a = torch.where(inside, rgba[..., 3], 0.0)[..., None]
    return frame * (1 - a) + rgba[..., :3] * a


def draw_number(frame, atlas, hud: HudAssets, value, x0, y0, size, color):
    """Each env's value [B] i32 in decimal, without leading zeros, in the
    HUD's bitmap font, at (x0, y0) in frame pixels, `size` pixels high,
    tinted by color [4]."""
    v = value.clamp_min(0)
    digits = torch.stack([torch.div(v, 10 ** (MAX_DIGITS - 1 - i), rounding_mode="floor") % 10
                          for i in range(MAX_DIGITS)], -1)  # [B, MAX_DIGITS], most significant first
    leading = torch.cumsum(digits, -1) == 0
    last = torch.arange(MAX_DIGITS, device=v.device) == MAX_DIGITS - 1
    visible = ~leading | last
    scale = size / torch.clamp_min(hud.font_height, 1.0)
    codes = (digits + ord("0")).long()
    widths = hud.font_widths[codes] * scale
    advances = torch.where(visible, widths + hud.font_spacing * scale, 0.0)
    offs = torch.cat([torch.zeros_like(advances[:, :1]), prefix_sum(advances)[:, :-1]], -1)
    return _glyphs(frame, atlas, hud, codes, visible, x0 + offs, widths, y0, size, color)


def draw_text(frame, atlas, font, codes, x, y, size, color, halign="left"):
    """A string in a bitmap font (any struct with the font_* fields of
    HudAssets) on frames [B, H, W, 3]: codes [L] or per env [B, L] i32
    ASCII codes, -1 skipped with no advance; halign "left" anchors the
    string at x, "center" centres it on x."""
    b = frame.shape[0]
    codes = codes.expand(b, -1) if codes.ndim == 1 else codes
    visible = codes >= 0
    ci = codes.clamp(0, 127).long()
    scale = size / torch.clamp_min(font.font_height, 1.0)
    widths = font.font_widths[ci] * scale
    advances = torch.where(visible, widths + font.font_spacing * scale, 0.0)
    offs = torch.cat([torch.zeros_like(advances[:, :1]), prefix_sum(advances)[:, :-1]], -1)
    x0 = x - advances.sum(-1, keepdim=True) * 0.5 if halign == "center" else x
    shown = visible & (font.font_start_u[ci] >= 0)
    return _glyphs(frame, atlas, font, ci, shown, x0 + offs, widths, y, size, color)


def _glyphs(frame, atlas, font, codes, shown, cx, widths, y, size, color):
    """Blend glyph i of each env ([B, L] codes, shown, left edges cx and
    widths) in order; the JAX loop body of draw_number and draw_text."""
    ys, xs = _frame_axes(frame)
    color = torch.as_tensor(color, dtype=torch.float32, device=frame.device)
    v_loc = (ys - y) / max(size, 1e-6)
    out = frame
    for i in range(codes.shape[1]):
        px = lambda x: x[:, i, None, None]  # glyph i of each env, over its pixels
        u_loc, v_b = torch.broadcast_tensors((xs - px(cx)) / px(widths).clamp_min(1e-6), v_loc)
        su, eu = px(font.font_start_u[codes]), px(font.font_end_u[codes])
        u_tex = su + u_loc * (eu - su)
        inside = (u_loc >= 0) & (u_loc < 1) & (v_b >= 0) & (v_b < 1) & px(shown) & (font.font_tex >= 0)
        tex = sample(atlas, font.font_tex.expand(u_loc.shape), torch.stack([u_tex, v_b], -1))
        a = torch.where(inside, tex[..., 3] * color[3], 0.0)[..., None]
        out = out * (1 - a) + tex[..., :3] * color[:3] * a
    return out


def render_hud(atlas, hud: HudAssets, state, frame):
    """The in-game HUD over each env's frame (Drawing.c:235-271): the coin
    icon and count top right, up to 5 blue-coin icons below, and the
    crosshair in the centre coloured by its state; an env whose camera is
    an actor keeps its frame."""
    h, w = frame.shape[-3:-1]
    dev = frame.device
    ones = const((1.0, 1.0, 1.0, 1.0), dev)
    out = blit(frame, atlas, hud.ycoin_tex, w - 260, 16, 40, 40, ones)
    out = draw_number(out, atlas, hud, state.save.coins, w - 210.0, 16.0, 40.0, ones)
    for i in range(5):
        mod = torch.where(state.save.blue_coins > i, 1.0, 0.0)[:, None] * ones
        out = blit(out, atlas, hud.bcoin_tex, w - 260 + i * 48, 64, 40, 40, mod)
    cc = const(CROSSHAIR_COLORS, dev)[state.player.crosshair.clamp(0, 3).long()]
    out = blit(out, atlas, hud.crosshair_tex, w * 0.5 - 12, h * 0.5 - 12, 24, 24, cc)
    return torch.where((state.camera_actor < 0)[:, None, None, None], out, frame)
