"""Debug wireframe and rate-graph overlays (counterpart of
c_game_engine_tpu/render/debug_draw.py).

The collision wireframes (every dynamic and kinematic body's box, the
sensor volumes, the character capsule) become thin camera-facing quads,
unshaded and flat-coloured, that ride the render path's triangle soup
(`render_batch(..., debug_wireframe=True)`), depth-tested like the rest.
The rate graph is a polyline composited over finished frames.

Every function takes a leading batch axis of envs where the JAX one takes
one env; the map's own arrays (sensor volumes) are shared by the batch.
"""

from __future__ import annotations

import math

import torch

from c_game_engine_tpu_torch.actors.defs import Motion, Shape
from c_game_engine_tpu_torch.utils.mathx import const, cross, quat_rotate, safe_normalize

# copied from c_game_engine_tpu/render/debug_draw.py
COLOR_BODY = (1.0, 1.0, 1.0, 1.0)
COLOR_SENSOR = (0.2, 1.0, 0.2, 1.0)
COLOR_CHARACTER = (0.2, 0.9, 1.0, 1.0)
# box topology: 8 corners (x, y, z in -1, 1), 12 edges
_CORNERS = tuple((sx, sy, sz) for sx in (-1.0, 1.0) for sy in (-1.0, 1.0) for sz in (-1.0, 1.0))
_EDGES = ((0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7), (0, 4), (1, 5), (2, 6), (3, 7))
LINE_WIDTH = 0.012  # world-space half-thickness per metre of camera distance


def _hex():
    """The capsule's ring directions (cos a, 0, sin a) at a = k 2 pi / 6,
    computed in float64 as numpy's linspace gives the angles."""
    return tuple((math.cos(k * (2.0 * math.pi / 6)), 0.0, math.sin(k * (2.0 * math.pi / 6))) for k in range(6))


def box_edge_segments(pos, quat, halfext, center):
    """[..., N, 12, 2, 3] world-space edge segments of oriented boxes
    (pos, center, halfext [..., N, 3], quat [..., N, 4])."""
    corners = const(_CORNERS, pos.device) * halfext[..., None, :]  # [..., N, 8, 3]
    corners = quat_rotate(quat[..., None, :], corners + center[..., None, :]) + pos[..., None, :]
    return corners[..., const(_EDGES, pos.device, torch.long), :]


def capsule_segments(pos, radius=0.2, half_height=0.25):
    """The character capsule's wireframe (two hexagonal rings at the cap
    centres and 6 verticals): pos [B, 3] -> [B, 18, 2, 3]."""
    dev = pos.device
    top = pos + const((0.0, half_height, 0.0), dev)
    bot = pos - const((0.0, half_height, 0.0), dev)
    ring = const(_hex(), dev) * radius
    ring_t = top[:, None, :] + ring
    ring_b = bot[:, None, :] + ring
    nxt = const((1, 2, 3, 4, 5, 0), dev, torch.long)
    return torch.cat([torch.stack([ring_t, ring_t[:, nxt]], 2), torch.stack([ring_b, ring_b[:, nxt]], 2),
                      torch.stack([ring_t, ring_b], 2)], 1)


def collect_segments(cmap, state):
    """Every debug segment of each env: the boxes of the dynamic and
    kinematic bodies with a shape (their collision half extents), the
    sensor volumes of active owners and the character capsule. Returns
    (segments [B, L, 2, 3], colours [B, L, 4], valid [B, L])."""
    actors = state.actors
    b, n = actors.pos.shape[:2]
    dev = actors.pos.device
    solid = (((cmap.motion == int(Motion.DYNAMIC)) | (cmap.motion == int(Motion.KINEMATIC)))
             & (cmap.shape != int(Shape.EMPTY)))
    body_segs = box_edge_segments(actors.pos, actors.quat, cmap.halfext, cmap.shape_center)  # [B, N, 12, 2, 3]
    body_valid = (solid & actors.active)[..., None].expand(b, n, 12)

    s_segs = box_edge_segments(cmap.sensor_pos, cmap.sensor_quat, cmap.sensor_halfext,
                               torch.zeros_like(cmap.sensor_pos))  # [S, 12, 2, 3]
    ns = s_segs.shape[0]
    owner = cmap.sensor_owner.clamp(0, max(n - 1, 0)).long()
    s_active = torch.where(cmap.sensor_owner >= 0, actors.active[:, owner], False)  # [B, S]
    s_valid = s_active[..., None].expand(b, ns, 12)

    c_segs = capsule_segments(state.player.pos)
    segments = torch.cat([body_segs.reshape(b, -1, 2, 3), s_segs.reshape(1, -1, 2, 3).expand(b, -1, 2, 3), c_segs],
                         1)
    colors = torch.cat([const(COLOR_BODY, dev).expand(b, n * 12, 4), const(COLOR_SENSOR, dev).expand(b, ns * 12, 4),
                        const(COLOR_CHARACTER, dev).expand(b, 18, 4)], 1)
    valid = torch.cat([body_valid.reshape(b, -1), s_valid.reshape(b, -1),
                       torch.ones((b, 18), dtype=torch.bool, device=dev)], 1)
    return segments, colors, valid


def segments_to_part(segments, colors, valid, cam_pos):
    """Each segment as a thin two-sided quad (2 triangles) facing the
    camera, as a soup part of render/raster.py (KIND_MODEL, unshaded, no
    texture, flat colour): [B, 2L] rows."""
    from c_game_engine_tpu_torch.render.raster import KIND_MODEL, _part

    a, b_ = segments[:, :, 0], segments[:, :, 1]
    mid = (a + b_) * 0.5
    view = mid - cam_pos[:, None, :]
    dist = torch.sqrt((view * view).sum(-1, keepdim=True))
    side = safe_normalize(cross(b_ - a, view)) * (LINE_WIDTH * dist)
    v0, v1, v2, v3 = a - side, a + side, b_ + side, b_ - side
    b, n = segments.shape[:2]
    tris = torch.stack([torch.stack([v0, v1, v2], 2), torch.stack([v0, v2, v3], 2)], 2).reshape(b, 2 * n, 3, 3)
    col = colors.repeat_interleave(2, dim=1)[:, :, None, :].expand(b, 2 * n, 3, 4)
    dev = segments.device
    return _part(tris, torch.zeros((b, 2 * n, 3, 2), device=dev), col,
                 torch.full((b, 2 * n), -1, dtype=torch.int32, device=dev), KIND_MODEL,
                 torch.zeros((b, 2 * n), dtype=torch.bool, device=dev), valid.repeat_interleave(2, dim=1), True)


def graph_overlay(frame, values, lo=0.0, hi=None, origin=(8, 8), size=(120, 40), color=(1.0, 1.0, 0.0),
                  alpha=0.85):
    """FrameGrapher's polyline of `values` [K] f32 (oldest first) in the
    bottom-left corner of frames [..., H, W, 3], offset by `origin` (x from
    the left, y from the bottom), over a dimmed panel; y scales from `lo`
    to `hi` (the largest value when None)."""
    h, w = frame.shape[-3:-1]
    dev = frame.device
    values = torch.as_tensor(values, dtype=torch.float32, device=dev)
    k = values.shape[0]
    vhi = values.max() if hi is None else hi
    span = torch.clamp_min(torch.as_tensor(vhi - lo, dtype=torch.float32, device=dev), 1e-6)
    gw, gh = size
    x0 = origin[0]
    y1 = h - origin[1]  # the bottom edge (frame y grows downward)
    xs = x0 + torch.arange(k, device=dev).float() * (gw / max(k - 1, 1))
    ys = y1 - ((values - lo) / span).clamp(0.0, 1.0) * gh
    px = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    py = torch.arange(h, dtype=torch.float32, device=dev)[:, None]

    # each pixel's distance to each of the K - 1 segments
    ax, ay, bx, by = xs[:-1], ys[:-1], xs[1:], ys[1:]
    dx, dy = bx - ax, by - ay
    seg_len2 = torch.clamp_min(dx * dx + dy * dy, 1e-6)
    e = lambda a: a[:, None, None]
    t = (((px[None] - e(ax)) * e(dx) + (py[None] - e(ay)) * e(dy)) / e(seg_len2)).clamp(0.0, 1.0)
    cx = e(ax) + t * e(dx)
    cy = e(ay) + t * e(dy)
    hit = (((px[None] - cx) ** 2 + (py[None] - cy) ** 2) <= 0.8 ** 2).any(0)  # about 1.6 px wide

    panel = (px >= x0 - 2) & (px <= x0 + gw + 2) & (py <= y1 + 2) & (py >= y1 - gh - 2)
    out = torch.where(panel[..., None], frame * 0.55, frame)
    line_rgb = const(tuple(color), dev)
    return torch.where(hit[..., None], frame * (1 - alpha) + line_rgb * alpha, out)
