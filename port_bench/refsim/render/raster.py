"""Batched software rasterizer (counterpart of
c_game_engine_tpu/render/raster.py).

    frames = render_batch(bundle, cmap, states, 256, 256)  # [B, H, W, 3]

Per frame batch: gather each env's triangle soup (sky first, then map,
actor models, actor walls, and with debug_wireframe the collision
wireframes as thin quads, render/debug_draw.py) -> camera transform ->
pre-clip cull -> near-plane clip -> per-triangle mip level (anisotropic
with aniso > 1) and enc word -> a z pass -> shade. Where the map has alpha
content, a second z pass re-rasterizes with each screen-door-discarded
winner excluded, and its layer is shaded on a compacted set of tiles; when
some env has more such tiles than the budget, every env is re-shaded over
the full frame instead (a `core/gates.py` gate: a host `if` eagerly, a
conditional node in a CUDA graph).

`render` and `render_batch` take the JAX package's parameters in its
order. Two module switches, as in the JAX module: CULL_MODE ("neg", the
default, keeps triangles of negative screen area; "pos" the other side;
"none" every valid row; two-sided rows always) at both cull sites, before
and after the near-plane clip, on every route (the kernels do no culling:
the culled soup reaches them); BACKEND, what backend=None means. A
render graph's key holds both, so a switch between two calls captures a
new graph and never replays one taken under the other setting. The route
follows the JAX _resolve_backend on a TPU:
  * "tiles" (backend "auto" up to PALLAS_MAX_BOUND = 65,536 live
    triangles, or "pallas"): the T_CULL compaction, `_clip_near` (1
    triangle -> up to 2), the tri48 table and kernel K4
    (ops/raster_tiles.py), which bins the rows into tiles, keeps each
    pixel's z winner and interpolates its attributes;
  * "big" (above the bound, or "pallas_big"): no compaction,
    `_clip_near_compact` (the near-plane crossing rows, at most CLIP_CAP,
    clipped and appended), the fields-major table with per-row screen
    bboxes and their chunk and subchunk unions, and kernel K5
    (ops/raster_tiles_big.py), which keeps the winner id only;
  * "xla" (backend "xla", and every frame that is not whole 8 x 128
    tiles on either kernel route): the compaction to the bundle's live
    bound, `_clip_near`, and `_pass1_xla`, the chunked edge-function scan
    in PyTorch ops (no kernel).
On the big and xla routes `_attrs_from_winner` gathers and interpolates
the winner's attributes from the flattened vertex table.

In this reference `render_batch` is the eager call on any device (the
port replays a captured graph on a card). Every function that
the JAX package vmaps over envs takes a leading batch axis here; `render`,
`render_viewmodel` and `render_with_hud` keep the JAX one-env signatures.
The shade samples the bundle's atlas, which has no dual rows, as in the JAX
package (`textures.py::build_atlas(dual=True)` builds them on request).
"""

from __future__ import annotations

import functools
import math

import torch

from refsim.actors.defs import ActorClass
from refsim.core import gates
from refsim.core.state import tree_map
from refsim.ops import raster_tiles as K4
from refsim.ops import raster_tiles_big as K5
from refsim.render.textures import sample
from refsim.utils.mathx import (
    perspective_lh_zo,
    quat_from_axis_angle,
    quat_from_yaw_pitch,
    quat_look,
    quat_mul,
    quat_rotate,
)

# copied from c_game_engine_tpu/render/raster.py
CHUNK = 64
MAGIC_XY = (0.06711056, 0.00583715)
MAGIC_Z = 52.9829189
CULL_MODE = "neg"  # neg | pos | none (debug)
BACKEND = "auto"  # what backend=None means: auto | xla | pallas | pallas_big
KIND_MAP = 0
KIND_MODEL = 1
KIND_WALL = 2
KIND_SKY = 3
PALLAS_MAX_BOUND = 65536  # beyond it the soup streams through K5
T_CULL = 4096  # post-cull live-triangle cap of the tile route
CLIP_CAP = 2048  # big route: near-plane-crossing rows clipped per env
REVEAL_TILE_FRAC = 8  # compacted reveal shade budget: num_tiles // 8 tiles
RTILE_H, RTILE_W = K4.TILE_H, K4.TILE_W
NEAR_W = 0.01


def _matmul4(a, b):
    """[..., 4, 4] @ [..., 4, 4] as explicit float32 products and sums in a
    fixed order, so the CPU and the card round alike (full f32, no TF32)."""
    cols = []
    for j in range(4):
        acc = a[..., :, 0] * b[..., 0, j, None]
        for k in range(1, 4):
            acc = acc + a[..., :, k] * b[..., k, j, None]
        cols.append(acc)
    return torch.stack(cols, dim=-1)


@functools.lru_cache(maxsize=None)
def _projection(fov_deg, aspect, device):
    """(perspective [4, 4], the camera's pi rotation about X [4]), computed
    once on the CPU in float32, so the card and the CPU use the same bits,
    and kept on `device` (no host-to-device copy per frame)."""
    fov = torch.tensor(fov_deg, dtype=torch.float32) * (math.pi / 180.0)
    persp = perspective_lh_zo(fov, aspect, 0.01, 2000.0)
    flip = quat_from_axis_angle([1.0, 0.0, 0.0], torch.tensor(math.pi))
    return persp.to(device), flip.to(device)


@functools.lru_cache(maxsize=None)
def _wall_quad(device):
    """The unit wall quad's corners [4, 2] (+-0.5), their uv [4, 2] and its
    two triangles' corner ids [6], kept on `device`."""
    corners2 = torch.tensor([[0.5, -0.5], [0.5, 0.5], [-0.5, 0.5], [-0.5, -0.5]])
    base_uv = torch.stack([corners2[:, 0] + 0.5, 0.5 - corners2[:, 1]], -1)
    return corners2.to(device), base_uv.to(device), torch.tensor([0, 1, 2, 0, 2, 3], device=device)


def camera_matrix(cmap, state, width, height, fov_deg=90.0):
    """[B, 4, 4] view-projection matrices and [B, 3] camera positions:
    perspective_lh_zo(fov, w/h, 0.01, 2000) x quat_look(pos, rot * rotX(pi)),
    in full float32 (a reduced-precision product rounds the z row's
    1.000005 to 1 and pushes far geometry to z = 1, where it is culled)."""
    p = state.player
    dev = p.pos.device
    persp, flip = _projection(fov_deg, width / height, dev)
    eye = p.pos.clone()
    eye[:, 1] += 0.25
    cam_pos = torch.where(p.freecam[:, None], p.freecam_pos, eye)
    cam_rot = quat_from_yaw_pitch(p.yaw, p.pitch)
    use_actor = (state.camera_actor >= 0)[:, None]
    ci = state.camera_actor.clamp(0, cmap.num_actors - 1).long()
    bi = torch.arange(ci.shape[0], device=dev)
    cam_pos = torch.where(use_actor, state.actors.pos[bi, ci], cam_pos)
    cam_rot = torch.where(use_actor, state.actors.quat[bi, ci], cam_rot)
    view = quat_look(cam_pos, quat_mul(cam_rot, flip))
    return _matmul4(persp.expand_as(view), view), cam_pos


def _part(pos, uv, color, tex, kind, shaded, valid, twosided, lmuv=None):
    b, t = pos.shape[:2]
    dev = pos.device
    return dict(
        pos=pos,
        uv=uv,
        lmuv=torch.zeros((b, t, 3, 2), device=dev) if lmuv is None else lmuv,
        color=color,
        tex=tex,
        kind=torch.full((b, t), kind, dtype=torch.int32, device=dev),
        shaded=shaded,
        valid=valid,
        twosided=torch.full((b, t), twosided, dtype=torch.bool, device=dev),
    )


def gather_triangles(bundle, cmap, state, camera_pos_hint=None):
    """Each env's world-space triangle soup with attributes, as a list of
    parts (map, actor models, actor walls), every array [B, t, ...]:
    pos [3,3], uv [3,2], lmuv [3,2], color [3,4], tex, kind, shaded, valid,
    twosided."""
    actors = state.actors
    b = actors.pos.shape[0]
    dev = actors.pos.device
    ex = lambda x: x.unsqueeze(0).expand(b, *x.shape)
    parts = []

    # ---- map ----
    tm = bundle.map_pos.shape[0]
    parts.append(_part(
        ex(bundle.map_pos), ex(bundle.map_uv), torch.ones((b, tm, 3, 4), device=dev),
        ex(bundle.map_tex), KIND_MAP, ex(bundle.map_shaded),
        torch.ones((b, tm), dtype=torch.bool, device=dev), False, lmuv=ex(bundle.map_lmuv),
    ))

    # ---- actor models ----
    a_of, p_of = bundle.mdl_actor_rows, bundle.mdl_pool_rows
    if a_of.numel():
        local = bundle.mdl_pos[p_of]  # [Tmo, 3, 3]
        aq = actors.quat[:, a_of]
        ap = actors.pos[:, a_of]
        world = quat_rotate(aq[:, :, None, :], local[None]) + ap[:, :, None, :]
        slot = bundle.mdl_slot[p_of].long()
        mid = cmap.model_id[a_of].long()
        skin = actors.skin[:, a_of].clamp(0, bundle.mdl_skin_tex.shape[1] - 1).long()
        tex = bundle.mdl_skin_tex[mid, skin, slot]
        mat_color = bundle.mdl_skin_color[mid, skin, slot]
        shaded = bundle.mdl_skin_shaded[mid, skin, slot]
        vcolor = bundle.mdl_color[p_of]
        color = vcolor[None] * mat_color[:, :, None, :] * actors.mod_color[:, a_of][:, :, None, :]
        # LOD per actor: camera distance^2 against the per-LOD thresholds
        cam = camera_pos_hint if camera_pos_hint is not None else state.player.pos
        d2 = ((actors.pos - cam[:, None, :]) ** 2).sum(-1)  # [B, N]
        thresh = bundle.mdl_lod_dist_sq[cmap.model_id.clamp_min(0).long()]  # [N, MAX_LODS]
        sel_lod = (d2[:, :, None] >= thresh[None, :, 1:]).sum(-1, dtype=torch.int32)
        sel_lod = sel_lod.clamp(0, bundle.mdl_lod_dist_sq.shape[1] - 1)
        valid = actors.active[:, a_of] & actors.visible[:, a_of] & (bundle.mdl_lod[p_of] == sel_lod[:, a_of])
        parts.append(_part(world, ex(bundle.mdl_uv[p_of]), color, tex, KIND_MODEL, shaded, valid, False))

    # ---- actor walls (two-sided quads) ----
    w_of = bundle.wall_actor_rows
    if w_of.numel():
        wq = actors.quat[:, w_of]
        wp = actors.pos[:, w_of]
        axis = cmap.wall_axis[w_of]
        size = cmap.wall_size[w_of]
        is_laser = cmap.cls[w_of] == int(ActorClass.LASER)
        length = torch.where(is_laser, actors.fdata[:, w_of, 0], size[:, 0])  # [B, W]
        size = torch.stack([length, size[:, 1].expand_as(length)], -1)
        zero = torch.zeros_like(length)
        center = torch.where(is_laser[:, None], torch.stack([-length / 2, zero], -1), cmap.wall_center[w_of])
        uv_scale = cmap.wall_uv_scale[w_of]
        is_coin = cmap.cls[w_of] == int(ActorClass.COIN)
        uv_off = torch.where(is_coin[:, None],
                             torch.stack([0.25 * actors.idata[:, w_of, 0].float(), zero], -1),
                             cmap.wall_uv_offset[w_of])
        uv_off = torch.where(is_laser[:, None], torch.stack([actors.fdata[:, w_of, 1], zero], -1), uv_off)
        corners2, base_uv, tri_idx = _wall_quad(dev)
        p2 = corners2 * size[:, :, None, :] + center[:, :, None, :]  # [B, W, 4, 2]
        ax = torch.where(axis == 0, 1.0, 0.0)[:, None]
        az = torch.where(axis == 1, 1.0, 0.0)[:, None]
        p3 = torch.stack([p2[..., 0] * ax, p2[..., 1], p2[..., 0] * az], -1)
        world4 = quat_rotate(wq[:, :, None, :], p3) + wp[:, :, None, :]  # [B, W, 4, 3]
        uv4 = base_uv * uv_scale[:, None, :] * size[:, :, None, :] + uv_off[:, :, None, :]
        nw = 2 * w_of.numel()
        wpos = world4[:, :, tri_idx].reshape(b, nw, 3, 3)
        wuv = uv4[:, :, tri_idx].reshape(b, nw, 3, 2)
        wtex = ex(cmap.wall_tex[w_of].repeat_interleave(2))
        wshaded = ex((~cmap.wall_unshaded[w_of]).repeat_interleave(2))
        wcolor = actors.mod_color[:, w_of].repeat_interleave(2, dim=1)[:, :, None, :].expand(b, nw, 3, 4)
        wvalid = (actors.active[:, w_of] & actors.visible[:, w_of]
                  & (cmap.wall_tex[w_of] >= 0)).repeat_interleave(2, dim=1)
        parts.append(_part(wpos, wuv, wcolor, wtex, KIND_WALL, wshaded, wvalid, True))
    return parts


def _concat_parts(parts):
    return {k: torch.cat([p[k] for p in parts], dim=1) for k in parts[0]}


def _resolve_backend(backend, height, width, bundle=None):
    """The route of the JAX `backend` as the JAX _resolve_backend picks it
    on a TPU: None is the module's BACKEND, "pallas" is "tiles" (K4),
    "pallas_big" is "big" (K5), "auto" is "tiles" up to PALLAS_MAX_BOUND
    live triangles and "big" above (a bundle of None: "tiles"), and "xla"
    is "xla" (`_pass1_xla`), which also takes every frame that is not whole
    8 x 128 tiles."""
    backend = BACKEND if backend is None else backend
    if backend not in ("auto", "pallas", "pallas_big", "xla"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "xla" or height % RTILE_H or width % RTILE_W:
        return "xla"
    if backend == "auto":
        return "big" if bundle is not None and bundle.live_tri_bound > PALLAS_MAX_BOUND else "tiles"
    return "tiles" if backend == "pallas" else "big"


def _front(area, twosided):
    """The rows CULL_MODE keeps by their signed screen area (JAX
    raster.py:530, :586): "neg" area < 0 (the reference's front faces),
    "pos" area > 0, anything else every row; two-sided rows always."""
    if CULL_MODE == "neg":
        return (area < 0.0) | twosided
    if CULL_MODE == "pos":
        return (area > 0.0) | twosided
    return torch.ones_like(twosided)


def _tile_pack(a, order_c, nty, ntx):
    """Gather [B, H, W, ...] image tiles into [B, K, RTILE_H, RTILE_W, ...]
    by flat tile ids `order_c` [B, K] (pre-clipped to a valid range)."""
    b, extra = a.shape[0], a.shape[3:]
    at = a.reshape(b, nty, RTILE_H, ntx, RTILE_W, *extra).transpose(2, 3)
    at = at.reshape(b, nty * ntx, RTILE_H, RTILE_W, *extra)
    return at[torch.arange(b, device=a.device)[:, None], order_c]


def _tile_unpack(vals, order, nty, ntx, fill):
    """Scatter [B, K, RTILE_H, RTILE_W, C] tiles back to [B, H, W, C]
    images initialized to `fill` [B, C]; order entries == nty*ntx
    (padding) drop."""
    b, c = vals.shape[0], vals.shape[-1]
    nt = nty * ntx
    buf = fill[:, None, None, None, :].expand(b, nt + 1, RTILE_H, RTILE_W, c).clone()
    buf[torch.arange(b, device=vals.device)[:, None], order] = vals
    buf = buf[:, :nt].reshape(b, nty, ntx, RTILE_H, RTILE_W, c).transpose(2, 3)
    return buf.reshape(b, nty * RTILE_H, ntx * RTILE_W, c)


def _per_env(x, like):
    """[B, ...] env values reshaped to broadcast against [B, <pixels>, ...]."""
    return x.reshape(x.shape[0], *([1] * (like.ndim - 1)), *x.shape[1:])


def shade(bundle, state, gx, gy, uv, lmuv, color, tex_id, kind, shaded, frag_depth,
          lod=None, flags=None, aniso_step=None, aniso_taps=0):
    """The fragment math of the map, model and sky shaders over pixel arrays
    [B, ...]. Returns (rgb, discard); a screen-door-discarded pixel is the
    caller's (the reveal pass). aniso_step [B, ..., 2] with aniso_taps > 1
    averages min(aniso_taps, 8) taps spaced along the footprint's major
    axis, summed in tap order (the step is zero for isotropic pixels)."""
    env = state.env
    pe = lambda x: _per_env(x, kind)
    if aniso_step is not None and aniso_taps > 1:
        taps = min(int(aniso_taps), 8)
        acc = None
        for k in range(taps):
            s = sample(bundle.atlas, tex_id, uv + aniso_step * ((k + 0.5) / taps - 0.5), lod=lod, flags=flags)
            acc = s if acc is None else acc + s
        tex4 = acc / taps
    else:
        tex4 = sample(bundle.atlas, tex_id, uv, lod=lod, flags=flags)
    tex4 = torch.where((tex_id < 0)[..., None], 1.0, tex4)  # -1: flat vertex colour

    out = tex4 * color[..., 3:4]
    fade = out[..., 3].clamp(0.0, 1.0)
    frac = lambda x: x - torch.trunc(x)
    hash_ = frac(MAGIC_Z * frac(gx * MAGIC_XY[0] + gy * MAGIC_XY[1]))
    discard = (fade < 0.001) | (fade < hash_)

    lh, lw = bundle.lightmap.shape[:2]
    lx = (lmuv[..., 0] * lw).to(torch.int32).clamp(0, lw - 1)
    ly = (lmuv[..., 1] * lh).to(torch.int32).clamp(0, lh - 1)
    lm = bundle.lightmap.reshape(lh * lw, -1)[(ly * lw + lx).long()][..., :3]

    light = pe(env.light_color[:, :3])
    base = out[..., :3] * color[..., :3]
    lit = torch.where(shaded[..., None],
                      base * light * torch.where((kind == KIND_MAP)[..., None], lm, 1.0), base)
    fog_factor = (
        ((frag_depth - pe(env.fog_start)) / pe(torch.clamp_min(env.fog_end - env.fog_start, 1e-6)))
        .clamp(0.0, 1.0) * pe(env.fog_color[:, 3])
    )
    fog = pe(env.fog_color[:, :3])
    exposure = pe(env.exposure)[..., None]
    rgb = lit + (fog - lit) * fog_factor[..., None]
    rgb = (rgb * exposure).clamp(0.0, 1.0)
    sky_rgb = (tex4[..., :3] * exposure).clamp(0.0, 1.0)
    rgb = torch.where((kind == KIND_SKY)[..., None], sky_rgb, rgb)
    return rgb, discard


def _shade_generic(bundle, state, pass_data, gxx, gyy, aniso_uv, mipmaps, aniso):
    """Decode the enc word and shade a pass's pixels at any image shape;
    aniso_uv [B, T, 2] (or None) is each row's tap step. Returns (rgb,
    discard with sky left out)."""
    has, winner, uv, lmuv, color, frag_depth, genc = pass_data
    tex_id = (genc & 0xFFF) - 1
    kind = (genc >> 12) & 3
    shaded = ((genc >> 14) & 1).bool()
    lod_pix = ((genc >> 15) & 63).float() * 0.25 if mipmaps else None
    flags = (((genc >> 21) & 1).bool(), ((genc >> 22) & 1).bool())
    astep = None
    if aniso_uv is not None:
        bi = torch.arange(winner.shape[0], device=winner.device).reshape(-1, *([1] * (winner.ndim - 1)))
        astep = aniso_uv[bi, winner.clamp_min(0).long()]
    rgb, disc = shade(bundle, state, gxx, gyy, uv, lmuv, color, tex_id, kind, shaded, frag_depth,
                      lod=lod_pix, flags=flags, aniso_step=astep, aniso_taps=aniso)
    return rgb, disc & has & (kind != KIND_SKY)


def _attrs_from_winner(vattr36, enc, winner, gxx, gyy):
    """The per-pixel attribute tuple from a winner-id image [B, ...] of any
    shape (full frame or packed tiles): gather the winner's row of the
    flattened vertex table vattr36 [B, T, 36] (vertex-major 3 x 12: sx, sy,
    1/w, z, uv, lmuv, rgba) and interpolate perspective-correct at the
    pixel centres gxx, gyy, in the order of K4's in-kernel interpolation."""
    b = winner.shape[0]
    has = winner >= 0
    bi = torch.arange(b, device=winner.device).reshape(b, *([1] * (winner.ndim - 1)))
    widx = winner.clamp_min(0).long()
    ga = vattr36[bi, widx].reshape(*winner.shape, 3, 12)
    g = lambda k, ch: ga[..., k, ch]

    def edge_at(i, j):
        return (g(j, 0) - g(i, 0)) * (gyy - g(i, 1)) - (g(j, 1) - g(i, 1)) * (gxx - g(i, 0))

    e0, e1, e2 = edge_at(0, 1), edge_at(1, 2), edge_at(2, 0)
    denom = e0 + e1 + e2
    denom = torch.where(denom.abs() > 1e-9, denom, 1e-9)
    b0, b1, b2 = e1 / denom, e2 / denom, e0 / denom
    iw0, iw1, iw2 = g(0, 2), g(1, 2), g(2, 2)
    iw = b0 * iw0 + b1 * iw1 + b2 * iw2
    pw = 1.0 / torch.clamp_min(iw, 1e-12)
    bw0, bw1, bw2 = b0 * iw0, b1 * iw1, b2 * iw2
    interp = lambda ch: (bw0 * g(0, ch) + bw1 * g(1, ch) + bw2 * g(2, ch)) * pw
    uv = torch.stack([interp(4), interp(5)], -1)
    lmuv = torch.stack([interp(6), interp(7)], -1)
    color = torch.stack([interp(8), interp(9), interp(10), interp(11)], -1)
    frag_depth = (b0 * g(0, 3) + b1 * g(1, 3) + b2 * g(2, 3)) * pw
    return has, winner, uv, lmuv, color, frag_depth, enc[bi, widx]


def _pass_data_of(route, raw, vattr36, enc, gxx, gyy):
    """A pass's raw output as the per-pixel attribute tuple: on the tile
    route the 12 kernel planes, on the big and xla routes the winner
    image, whose attributes are gathered and interpolated here."""
    if route != "tiles":
        return _attrs_from_winner(vattr36, enc, raw, gxx, gyy)
    (_zb, winner, frag_depth, uv_u, uv_v, lm_u, lm_v, col_r, col_g, col_b, col_a, genc) = raw
    has = winner >= 0
    uv = torch.stack([uv_u, uv_v], -1)
    lmuv = torch.stack([lm_u, lm_v], -1)
    color = torch.stack([col_r, col_g, col_b, col_a], -1)
    return has, winner, uv, lmuv, color, frag_depth, genc


def _combine_layers(rgb1, disc1, has1, layer2):
    rgb = torch.where(disc1[..., None], layer2, rgb1)
    rgb = torch.where(has1[..., None], rgb, 0.0)
    return rgb.clamp(0.0, 1.0)


@functools.lru_cache(maxsize=None)
def _pixel_grid(height, width, device):
    """The pixel centres (gx, gy), each [H, W], built once per (size,
    device)."""
    px = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    py = torch.arange(height, dtype=torch.float32, device=device) + 0.5
    gy, gx = torch.meshgrid(py, px, indexing="ij")
    return gx, gy


def _fog_rgb(state):
    env = state.env
    return (env.fog_color[:, :3] * env.exposure[:, None]).clamp(0.0, 1.0)  # [B, 3]


def _finish_reveal_full(bundle, ctx, state, height, width, mipmaps):
    """Overflow fallback: shade the reveal pass over the full frame from
    the carried pass-2 output (the kernel planes, or the winner image and
    the vertex table on the big and xla routes)."""
    b = ctx["rgb1"].shape[0]
    gx, gy = (g.expand(b, height, width) for g in _pixel_grid(height, width, ctx["rgb1"].device))
    p2 = _pass_data_of(ctx["route"], ctx["raw2"], ctx["vattr36"], ctx["enc"], gx, gy)
    rgb2, disc2 = _shade_generic(bundle, state, p2, gx, gy, ctx["aniso_uv"], mipmaps, ctx["aniso"])
    layer2 = torch.where((p2[0] & ~disc2)[..., None], rgb2, _fog_rgb(state)[:, None, None, :])
    return _combine_layers(ctx["rgb1"], ctx["disc1"], ctx["has1"], layer2)


def render_batch_eager(bundle, cmap, states, height=256, width=256, fov_deg=90.0, backend=None,
                       mipmaps=True, ssaa=1, aniso=0, debug_wireframe=False):
    """render_batch as plain PyTorch calls on the states' device. The
    reveal overflow (some env's screen-door pixels on more tiles than the
    budget) re-shades every env over the full frame, through a
    `core/gates.py` branch (JAX: lax.cond outside the vmap)."""
    if ssaa > 1:
        big = render_batch_eager(bundle, cmap, states, height * ssaa, width * ssaa, fov_deg, backend, mipmaps,
                                 1, aniso, debug_wireframe)
        return big.reshape(-1, height, ssaa, width, ssaa, 3).mean((2, 4))
    rgb_cmp, overflow, ctx = _render_envs(bundle, cmap, states, height, width, fov_deg, mipmaps, backend, aniso,
                                          debug_wireframe)
    if ctx is None:
        return rgb_cmp
    return gates.branch(gates.read(overflow.any()),
                        lambda: _finish_reveal_full(bundle, ctx, states, height, width, mipmaps),
                        lambda: rgb_cmp)


def _render_envs(bundle, cmap, state, height, width, fov_deg, mipmaps, backend=None, aniso=0,
                 debug_wireframe=False):
    """The batch's pipeline. Returns (rgb, reveal_overflow [B], ctx): ctx is
    None when the reveal resolved here (no alpha content, or a frame that
    is not whole tiles); otherwise rgb has the tile-compacted reveal, and
    ctx carries what _finish_reveal_full needs."""
    route = _resolve_backend(backend, height, width, bundle)
    vp, cam_pos = camera_matrix(cmap, state, width, height, fov_deg)
    parts = gather_triangles(bundle, cmap, state, camera_pos_hint=cam_pos)
    b = cam_pos.shape[0]
    dev = cam_pos.device
    extra_live = 0
    if debug_wireframe:
        raise ValueError("the reference draws no debug wireframe")

    # sky first in the soup (the cull compaction drops the highest rows),
    # following the camera, its depth forced to 0.999999 below
    ts = bundle.sky_pos.shape[0]
    if ts:
        parts.insert(0, _part(
            bundle.sky_pos[None] + cam_pos[:, None, None, :],
            bundle.sky_uv.expand(b, ts, 3, 2),
            torch.ones((b, ts, 3, 4), device=dev),
            bundle.sky_tex.to(torch.int32).expand(b, ts),
            KIND_SKY,
            torch.zeros((b, ts), dtype=torch.bool, device=dev),
            (bundle.sky_tex >= 0).expand(b, ts),
            True,
        ))
    tri = _concat_parts(parts)
    t_total = tri["pos"].shape[1]
    # an empty soup (no map triangle, no sky) keeps one chunk of dead rows:
    # the kernels take a table of at least one row
    pad = (-t_total) % CHUNK if t_total else CHUNK
    if pad:
        tri = {k: torch.cat([v, torch.zeros((b, pad, *v.shape[2:]), dtype=v.dtype, device=dev)], 1)
               for k, v in tri.items()}

    # ---- vertex transform: vp . (x, y, z, 1) summed pairwise in float32,
    # the order XLA's CPU dot takes for the JAX package's einsum ----
    pos = tri["pos"]
    m = lambda i, j: vp[:, None, None, i, j]
    clip = torch.stack(
        [(pos[..., 0] * m(i, 0) + pos[..., 1] * m(i, 1)) + (pos[..., 2] * m(i, 2) + m(i, 3))
         for i in range(4)], -1)  # [B, T, 3, 4]

    # ---- pre-clip cull + compaction (stable order; to T_CULL rows on the
    # tile route, to the bundle's live bound on the xla route, none on the
    # big route, where K5's bbox tests skip the dead rows) ----
    w0 = clip[..., 3]
    any_pos = (w0 > 0.01).any(-1)
    all_pos = (w0 > 0.01).all(-1)
    inv_w0 = 1.0 / torch.where(w0.abs() > 1e-9, w0, 1e-9)
    sx0 = (clip[..., 0] * inv_w0 + 1.0) * 0.5 * width
    sy0 = (clip[..., 1] * inv_w0 + 1.0) * 0.5 * height
    area0 = (sx0[..., 1] - sx0[..., 0]) * (sy0[..., 2] - sy0[..., 0]) - (
        sy0[..., 1] - sy0[..., 0]) * (sx0[..., 2] - sx0[..., 0])
    front0 = _front(area0, tri["twosided"])
    keep = tri["valid"] & any_pos & (~all_pos | (front0 & (area0.abs() > 1e-9)))
    t = keep.shape[1]
    if route == "tiles":
        cap = min(t, T_CULL)
    elif route == "big":
        cap = t
    else:
        bound = -(-max(bundle.live_tri_bound + extra_live, 1) // CHUNK) * CHUNK
        cap = min(t, max(bound, CHUNK))
    if cap < t:
        ids = torch.arange(t, dtype=torch.int32, device=dev)
        order = torch.sort(torch.where(keep, ids, t), dim=1).values[:, :cap]
        safe = order.clamp_max(t - 1).long()
        gather = lambda v: v[torch.arange(b, device=dev)[:, None], safe]
        tri = {k: gather(v) for k, v in tri.items()}
        tri["valid"] = tri["valid"] & (order < t)
        clip = gather(clip)
    else:
        tri["valid"] = keep

    # ---- near-plane clipping: 1 triangle -> up to 2 ----
    if route == "big":
        clip, tri = _clip_near_compact(clip, tri, min(CLIP_CAP, clip.shape[1]))
    else:
        clip, tri = _clip_near(clip, tri)
    w = clip[..., 3]
    ok_w = (w > 1e-5).all(-1)
    inv_w = 1.0 / torch.where(w.abs() > 1e-9, w, 1e-9)
    ndc = clip[..., :3] * inv_w[..., None]
    sx = (ndc[..., 0] + 1.0) * 0.5 * width
    sy = (ndc[..., 1] + 1.0) * 0.5 * height
    sz = ndc[..., 2]
    is_sky = tri["kind"] == KIND_SKY
    sz = torch.where(is_sky[..., None], 0.999999, sz)

    area2 = (sx[..., 1] - sx[..., 0]) * (sy[..., 2] - sy[..., 0]) - (
        sy[..., 1] - sy[..., 0]) * (sx[..., 2] - sx[..., 0])
    front = _front(area2, tri["twosided"])
    tri_ok = tri["valid"] & ok_w & front & (area2.abs() > 1e-9)

    # ---- per-triangle mip level, sampler flags and the enc word ----
    atlas = bundle.atlas
    tclip = tri["tex"].clamp_min(0).long()
    tex_wh = atlas.table[tclip][..., 2:4]
    fw = atlas.flag_words[tclip]  # rep << 21 | bil << 22
    bil_t = ((fw >> 22) & 1).bool()
    uvv = tri["uv"]
    du1 = (uvv[:, :, 1] - uvv[:, :, 0]) * tex_wh
    du2 = (uvv[:, :, 2] - uvv[:, :, 0]) * tex_wh
    texel_area = (du1[..., 0] * du2[..., 1] - du1[..., 1] * du2[..., 0]).abs()
    px_area = area2.abs()
    lod = 0.5 * torch.log2(texel_area.clamp_min(1e-12) / px_area.clamp_min(1e-12))
    aniso_uv = None
    if aniso > 1 and mipmaps:
        lod, aniso_uv = _aniso_footprint(sx, sy, du1, du2, tex_wh, bil_t & (atlas.n_mips[tclip] > 1), lod, aniso)
    lod_q = torch.round(lod * 4.0).clamp(0, 63).to(torch.int32)
    max_q = ((atlas.n_mips[tclip] - 1.0) * 4.0).to(torch.int32)
    lod_qc = torch.minimum(lod_q, max_q.clamp_min(0))
    lod_q = torch.where(bil_t, lod_qc, (torch.round(lod_qc.float() * 0.25) * 4.0).to(torch.int32))
    enc = ((tri["tex"] + 1) | (tri["kind"] << 12) | (tri["shaded"].to(torch.int32) << 14)
           | (lod_q << 15) | fw)  # < 2^23: exact in f32

    gx0, gy0 = _pixel_grid(height, width, dev)
    gx, gy = gx0.expand(b, height, width), gy0.expand(b, height, width)
    if route == "tiles":
        t_act = sx.shape[1]
        tri48 = torch.cat([
            torch.stack([sx, sy], -1).reshape(b, t_act, 6),
            sz,
            torch.arange(t_act, dtype=torch.float32, device=dev).expand(b, t_act)[..., None],
            inv_w,
            tri["uv"].reshape(b, t_act, 6),
            tri["lmuv"].reshape(b, t_act, 6),
            tri["color"].reshape(b, t_act, 12),
            enc.float()[..., None],
            torch.zeros((b, t_act, K4.N_COLS - 38), device=dev),
        ], -1).contiguous()
        vattr36 = None

        def z_pass(exclude=None, gate=None):
            tile_on = None if gate is None else gate.reshape(b, -1).to(torch.int32)
            return K4.raster_tiles_binned(tri48, tri_ok.contiguous(), height, width, exclude=exclude,
                                          tile_on=tile_on)
    else:
        # the attributes of the winners, gathered afterwards: [B, T, 36]
        vattr36 = torch.cat([sx[..., None], sy[..., None], inv_w[..., None], sz[..., None],
                             tri["uv"], tri["lmuv"], tri["color"]], -1).reshape(b, sx.shape[1], 36)
        if route == "big":
            trit, cbox, scb = _big_table(sx, sy, sz, tri_ok)

            def z_pass(exclude=None, gate=None):
                tile_on = None if gate is None else gate.reshape(b, -1).to(torch.int32)
                return K5.raster_tiles_big(trit, cbox, scb, height, width, exclude=exclude, tile_on=tile_on)[1]
        else:
            def z_pass(exclude=None, gate=None):  # no tile gate: the whole frame again
                return _pass1_xla(sx, sy, sz, tri_ok, gx0, gy0, exclude)

    raw1 = z_pass()
    p1 = _pass_data_of(route, raw1, vattr36, enc, gx, gy)
    has1, win1 = p1[0], p1[1]
    rgb, disc1 = _shade_generic(bundle, state, p1, gx, gy, aniso_uv, mipmaps, aniso)
    fog_rgb = _fog_rgb(state)
    if not bundle.has_alpha:
        return _combine_layers(rgb, disc1, has1, fog_rgb[:, None, None, :].expand_as(rgb)), None, None

    # ---- screen-door reveal: re-rasterize with the discarded winner
    # excluded per pixel (on the kernel routes only on the tiles that have
    # such a pixel) ----
    ex_img = torch.where(disc1, win1, -1).contiguous()
    if height % RTILE_H or width % RTILE_W:  # the xla route only: shade the whole frame
        p2 = _pass_data_of(route, z_pass(ex_img), vattr36, enc, gx, gy)
        rgb2, disc2 = _shade_generic(bundle, state, p2, gx, gy, aniso_uv, mipmaps, aniso)
        layer2 = torch.where((p2[0] & ~disc2)[..., None], rgb2, fog_rgb[:, None, None, :])
        return _combine_layers(rgb, disc1, has1, layer2), None, None
    nty, ntx = height // RTILE_H, width // RTILE_W
    disc_tile = disc1.reshape(b, nty, RTILE_H, ntx, RTILE_W).any(4).any(2)
    raw2 = z_pass(ex_img, disc_tile)

    # tile-compacted pass-2 shade over a budget of K tiles per env
    nt = nty * ntx
    k_budget = min(nt, max(8, nt // REVEAL_TILE_FRAC))
    flat = disc_tile.reshape(b, nt)
    overflow = flat.sum(-1) > k_budget
    dest = torch.cumsum(flat, dim=-1) - 1
    dest = torch.where(flat & (dest < k_budget), dest, k_budget)
    order = torch.full((b, k_budget + 1), nt, dtype=torch.int64, device=dev)
    order.scatter_(1, dest, torch.arange(nt, device=dev).expand(b, nt))
    order = order[:, :k_budget]  # slot k_budget took every tile past the budget
    order_c = order.clamp_max(nt - 1)
    pk = lambda a: _tile_pack(a, order_c, nty, ntx)
    gxp, gyp = pk(gx), pk(gy)
    raw2p = tuple(pk(o) for o in raw2) if route == "tiles" else pk(raw2)
    p2p = _pass_data_of(route, raw2p, vattr36, enc, gxp, gyp)
    rgb2p, disc2p = _shade_generic(bundle, state, p2p, gxp, gyp, aniso_uv, mipmaps, aniso)
    layer2p = torch.where((p2p[0] & ~disc2p)[..., None], rgb2p, _per_env(fog_rgb, rgb2p[..., 0]))
    layer2_img = _tile_unpack(layer2p, order, nty, ntx, fog_rgb)
    rgb_cmp = _combine_layers(rgb, disc1, has1, layer2_img)
    ctx = dict(route=route, rgb1=rgb, disc1=disc1, has1=has1, raw2=raw2, vattr36=vattr36, enc=enc,
               aniso_uv=aniso_uv, aniso=aniso)
    return rgb_cmp, overflow, ctx


def _aniso_footprint(sx, sy, du1, du2, tex_wh, elig, lod, aniso):
    """The anisotropic footprint (the JAX _render_env's aniso_uv): each
    row's texel-per-pixel jacobian from its affine screen -> texel map, the
    ellipse's axes from the eigenvalues of M M^T, and for the eligible rows
    (linear-filtered, mipmapped) the level log2(rho_major / ratio) with the
    ratio clipped to `aniso`. Returns (lod [B, T], tap step [B, T, 2] in
    normalized uv, zero where not eligible)."""
    dp1x, dp1y = sx[..., 1] - sx[..., 0], sy[..., 1] - sy[..., 0]
    dp2x, dp2y = sx[..., 2] - sx[..., 0], sy[..., 2] - sy[..., 0]
    det = dp1x * dp2y - dp1y * dp2x
    idet = 1.0 / torch.where(det.abs() > 1e-9, det, 1e-9)
    m00 = (du1[..., 0] * dp2y - du2[..., 0] * dp1y) * idet
    m01 = (-du1[..., 0] * dp2x + du2[..., 0] * dp1x) * idet
    m10 = (du1[..., 1] * dp2y - du2[..., 1] * dp1y) * idet
    m11 = (-du1[..., 1] * dp2x + du2[..., 1] * dp1x) * idet
    a_ = m00 * m00 + m01 * m01
    b_ = m10 * m10 + m11 * m11
    c_ = m00 * m10 + m01 * m11
    disc = torch.sqrt(((a_ - b_) ** 2 + 4.0 * c_ * c_).clamp_min(0.0))
    lam_hi = (0.5 * (a_ + b_ + disc)).clamp_min(1e-12)
    lam_lo = (0.5 * (a_ + b_ - disc)).clamp_min(1e-12)
    rho_maj = torch.sqrt(lam_hi)
    ratio = torch.sqrt(lam_hi / lam_lo).clamp(1.0, float(aniso))
    lod = torch.where(elig, torch.log2(rho_maj) - torch.log2(ratio), lod)
    # the major axis of [[a, c], [c, b]] in texel space
    big_c = c_.abs() > 1e-12
    vx = torch.where(big_c, c_, torch.where(a_ >= b_, 1.0, 0.0))
    vy = torch.where(big_c, lam_hi - a_, torch.where(a_ >= b_, 0.0, 1.0))
    vn = torch.sqrt((vx * vx + vy * vy).clamp_min(1e-24))
    span = rho_maj * (1.0 - 1.0 / ratio)  # texels covered by the taps t in [-0.5, 0.5]
    step = torch.stack([vx / vn, vy / vn], -1) * span[..., None] / tex_wh.clamp_min(1.0)
    return lod, torch.where(elig[..., None], step, 0.0)


def _pass1_xla(sx, sy, sz, tri_ok, gx, gy, exclude=None):
    """The JAX XLA pass 1: a z buffer over [B, CHUNK, H, W] edge functions,
    chunk after chunk. sx, sy, sz [B, T, 3] (T a multiple of CHUNK), tri_ok
    [B, T], pixel centres gx, gy [H, W], exclude [B, H, W] i32 (one row id
    per pixel to skip, -1 none) -> winner [B, H, W] i32 (-1 none). Tie
    rule: strictly closer wins, so of equal z the lowest row (within a
    chunk the first minimum, taken explicitly)."""
    b, t = sx.shape[:2]
    dev = sx.device
    ids = torch.arange(CHUNK, dtype=torch.int32, device=dev)[None, :, None, None]
    zbuf = torch.full((b, *gx.shape), math.inf, device=dev)
    winner = torch.full((b, *gx.shape), -1, dtype=torch.int32, device=dev)
    ex = None if exclude is None else exclude[:, None]
    e = lambda a: a[..., None, None]  # [B, CHUNK] -> [B, CHUNK, 1, 1]
    for c0 in range(0, t, CHUNK):
        cx, cy, cz = sx[:, c0:c0 + CHUNK], sy[:, c0:c0 + CHUNK], sz[:, c0:c0 + CHUNK]

        def edges(i, j):
            return e(cx[..., j] - cx[..., i]) * (gy - e(cy[..., i])) - e(cy[..., j] - cy[..., i]) * (gx - e(cx[..., i]))

        e0, e1, e2 = edges(0, 1), edges(1, 2), edges(2, 0)
        inside = ((e0 <= 0) & (e1 <= 0) & (e2 <= 0)) | ((e0 >= 0) & (e1 >= 0) & (e2 >= 0))
        denom = e0 + e1 + e2
        denom = torch.where(denom.abs() > 1e-9, denom, 1e-9)
        z = (e1 * e(cz[..., 0]) + e2 * e(cz[..., 1]) + e0 * e(cz[..., 2])) / denom
        zvalid = inside & e(tri_ok[:, c0:c0 + CHUNK]) & (z > 0.0) & (z < 1.0)
        if ex is not None:
            zvalid &= (ids + c0) != ex
        z = torch.where(zvalid, z, math.inf)
        bz = z.amin(1)
        best = torch.where(z == bz[:, None], ids, CHUNK).amin(1)
        closer = bz < zbuf
        zbuf = torch.where(closer, bz, zbuf)
        winner = torch.where(closer, best + c0, winner)
    return winner


def _big_table(sx, sy, sz, tri_ok):
    """The big route's table: per-row screen bboxes (dead rows +-1e30, so
    they overlap no tile), every column padded to a multiple of T_CHK rows,
    the fields-major trit [B, 16, T] (ops/raster_tiles_big.py layout) and
    its chunk and subchunk bbox unions [B, NC, 4] and [B, NC * 64, 4]."""
    b, t = sx.shape[:2]
    pad = (-t) % K5.T_CHK
    dead = lambda fill: torch.full((b, pad), fill, dtype=torch.float32, device=sx.device)
    padc = lambda col, fill: torch.cat([col, dead(fill)], 1) if pad else col
    okf = lambda col, fill: padc(torch.where(tri_ok, col, fill), fill)
    bxmin, bxmax = okf(sx.amin(-1), K5.DEAD), okf(sx.amax(-1), -K5.DEAD)
    bymin, bymax = okf(sy.amin(-1), K5.DEAD), okf(sy.amax(-1), -K5.DEAD)
    zero = torch.zeros_like(bxmin)
    trit = torch.stack([
        padc(sx[..., 0], 0.0), padc(sy[..., 0], 0.0), padc(sx[..., 1], 0.0), padc(sy[..., 1], 0.0),
        padc(sx[..., 2], 0.0), padc(sy[..., 2], 0.0),
        padc(sz[..., 0], 0.0), padc(sz[..., 1], 0.0), padc(sz[..., 2], 0.0), zero,
        bxmin, bxmax, bymin, bymax, zero, zero,
    ], 1)
    cbox = K5.level_bboxes(bxmin, bxmax, bymin, bymax, K5.T_CHK)
    scb = K5.level_bboxes(bxmin, bxmax, bymin, bymax, K5.SUB)
    return trit, cbox, scb


def _clip_near_compact(clip, tri, cap, near_w=NEAR_W):
    """The big route's near-plane clip: rows wholly in front of the plane
    keep their row, unchanged; the rows that cross it are compacted, in
    increasing row order, into `cap` slots (past `cap` they drop), clipped
    by `_clip_near` and appended as 2 * cap extension rows: [B, T, 3, 4]
    -> [B, T + 2 cap, 3, 4]. The compaction is a cumsum and a scatter,
    not a sort."""
    b, t = clip.shape[:2]
    dev = clip.device
    n_in = (clip[..., 3] > near_w).sum(-1)
    crossing = tri["valid"] & (n_in > 0) & (n_in < 3)
    dest = torch.cumsum(crossing, dim=1) - 1
    dest = torch.where(crossing & (dest < cap), dest, cap)
    order = torch.full((b, cap + 1), t, dtype=torch.int64, device=dev)
    order.scatter_(1, dest, torch.arange(t, device=dev).expand(b, t))
    order = order[:, :cap]  # slot cap took every row that is not kept
    safe = order.clamp_max(t - 1)
    bi = torch.arange(b, device=dev)[:, None]
    tri_c = {k: v[bi, safe] for k, v in tri.items()}
    tri_c["valid"] = tri_c["valid"] & (order < t)
    clip_x, tri_x = _clip_near(clip[bi, safe], tri_c, near_w)
    tri_out = dict(tri, valid=tri["valid"] & (n_in == 3))
    return torch.cat([clip, clip_x], 1), {k: torch.cat([tri_out[k], v], 1) for k, v in tri_x.items()}


def _clip_near(clip, tri, near_w=NEAR_W):
    """Clip every triangle against the near plane (clip.w > near_w),
    emitting up to two per input: [B, T, 3, 4] -> [B, 2T, 3, 4], with the
    per-vertex attributes clipped alongside. Vertex order is rotated so
    the winding is kept. (World positions are not carried: nothing
    downstream reads them.)"""
    w = clip[..., 3]
    inside = w > near_w
    n_in = inside.sum(-1)
    i0, i1, i2 = inside.unbind(-1)
    zero, one, two = (torch.full_like(n_in, v) for v in (0, 1, 2))
    # the first outside and the first inside vertex (0 when there is none)
    out_idx = torch.where(~i0, zero, torch.where(~i1, one, torch.where(~i2, two, zero)))
    in_idx = torch.where(i0, zero, torch.where(i1, one, torch.where(i2, two, zero)))
    r = torch.where(n_in == 2, (out_idx + 1) % 3, torch.where(n_in == 1, in_idx, zero))
    order = (r[..., None] + torch.arange(3, device=clip.device)) % 3  # [B, T, 3]

    attrs = torch.cat([tri["uv"], tri["lmuv"], tri["color"]], -1)  # [B, T, 3, 8]
    rot = lambda x: torch.gather(x, 2, order[..., None].expand(*order.shape, x.shape[-1]))
    clip_r = rot(clip)
    attrs_r = rot(attrs)
    wr = clip_r[..., 3]

    def isect(i, j):
        wa, wb = wr[..., i], wr[..., j]
        tt = (near_w - wa) / torch.where((wb - wa).abs() > 1e-12, wb - wa, 1e-12)
        tt = tt.clamp(0.0, 1.0)[..., None]
        cp = clip_r[:, :, i] + (clip_r[:, :, j] - clip_r[:, :, i]) * tt
        ap = attrs_r[:, :, i] + (attrs_r[:, :, j] - attrs_r[:, :, i]) * tt
        return cp, ap

    e01c, e01a = isect(0, 1)
    e12c, e12a = isect(1, 2)
    e20c, e20a = isect(2, 0)
    c3 = (n_in == 3)[..., None, None]
    c2 = (n_in == 2)[..., None, None]
    c1 = (n_in == 1)[..., None, None]

    def pick(case3, case2, case1):
        return torch.where(c3, case3, torch.where(c2, case2, torch.where(c1, case1, case3)))

    v = lambda x, k: x[:, :, k]
    out1_c = pick(clip_r, torch.stack([v(clip_r, 0), v(clip_r, 1), e12c], 2),
                  torch.stack([v(clip_r, 0), e01c, e20c], 2))
    out1_a = pick(attrs_r, torch.stack([v(attrs_r, 0), v(attrs_r, 1), e12a], 2),
                  torch.stack([v(attrs_r, 0), e01a, e20a], 2))
    out2_c = torch.stack([v(clip_r, 0), e12c, e20c], 2)
    out2_a = torch.stack([v(attrs_r, 0), e12a, e20a], 2)

    valid1 = tri["valid"] & (n_in > 0)
    valid2 = tri["valid"] & (n_in == 2)
    clip_out = torch.cat([out1_c, out2_c], 1)
    attrs_out = torch.cat([out1_a, out2_a], 1)
    dup = lambda x: torch.cat([x, x], 1)
    tri_out = {k: dup(tri[k]) for k in ("tex", "kind", "shaded", "twosided")}
    tri_out["valid"] = torch.cat([valid1, valid2], 1)
    tri_out["uv"] = attrs_out[..., 0:2]
    tri_out["lmuv"] = attrs_out[..., 2:4]
    tri_out["color"] = attrs_out[..., 4:8]
    return clip_out, tri_out


