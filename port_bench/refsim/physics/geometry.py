"""Branchless collision geometry primitives for one env (counterpart of
c_game_engine_tpu/physics/geometry.py).

Closed-form tests for the shapes the game uses in place of Jolt's
narrowphase: capsules (player, npc), boxes (props, doors, sensors) and
triangles (the static world). Every function broadcasts over leading axes
and has no data-dependent control flow; the arithmetic is written in the
JAX module's order so the two round alike (XLA's CPU code may still fuse
a * b - c * d into one FMA where PyTorch rounds twice).
"""

from __future__ import annotations

import torch

from refsim.utils.mathx import clamp, const, cross, dot, norm, quat_conj, quat_rotate


def closest_point_on_triangle(p, a, b, c):
    """Closest point on triangle (a, b, c) to point p. Shapes: [..., 3]."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = dot(ab, ap)
    d2 = dot(ac, ap)

    bp = p - b
    d3 = dot(ab, bp)
    d4 = dot(ac, bp)

    cp = p - c
    d5 = dot(ab, cp)
    d6 = dot(ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    denom_abc = torch.clamp_min(va + vb + vc, 1e-30)
    v_face = vb / denom_abc
    w_face = vc / denom_abc
    face = a + ab * v_face[..., None] + ac * w_face[..., None]

    # edge AB
    t_ab = torch.clamp(d1 / torch.clamp_min(d1 - d3, 1e-30), 0.0, 1.0)
    on_ab = a + ab * t_ab[..., None]
    # edge AC
    t_ac = torch.clamp(d2 / torch.clamp_min(d2 - d6, 1e-30), 0.0, 1.0)
    on_ac = a + ac * t_ac[..., None]
    # edge BC
    t_bc = torch.clamp((d4 - d3) / torch.clamp_min((d4 - d3) + (d5 - d6), 1e-30), 0.0, 1.0)
    on_bc = b + (c - b) * t_bc[..., None]

    out = face
    # region tests, applied in reverse priority so earlier (vertex) regions win
    out = torch.where(((vc <= 0) & (d1 >= 0) & (d3 <= 0))[..., None], on_ab, out)
    out = torch.where(((vb <= 0) & (d2 >= 0) & (d6 <= 0))[..., None], on_ac, out)
    out = torch.where(((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0))[..., None], on_bc, out)
    out = torch.where(((d1 <= 0) & (d2 <= 0))[..., None], a, out)
    out = torch.where(((d3 >= 0) & (d4 <= d3))[..., None], b, out)
    out = torch.where(((d6 >= 0) & (d5 <= d6))[..., None], c, out)
    return out


def closest_point_on_segment(p, s0, s1):
    d = s1 - s0
    t = dot(p - s0, d) / torch.clamp_min(dot(d, d), 1e-30)
    t = torch.clamp(t, 0.0, 1.0)
    return s0 + d * t[..., None]


def capsule_triangle_closest(s0, s1, a, b, c, iters: int = 2):
    """Approximate closest points between segment [s0, s1] and triangle
    (a, b, c) by alternating projections. Returns (point_on_segment,
    point_on_triangle); exact for the face case, within epsilon for edge
    cases at iters >= 3."""
    q = closest_point_on_triangle((s0 + s1) * 0.5, a, b, c)
    for _ in range(iters):
        p = closest_point_on_segment(q, s0, s1)
        q = closest_point_on_triangle(p, a, b, c)
    return p, q


def point_in_obb(p, center, quat, halfext):
    lp = quat_rotate(quat_conj(quat), p - center)
    return torch.all(torch.abs(lp) <= halfext, dim=-1)


def closest_point_on_obb(p, center, quat, halfext):
    lp = quat_rotate(quat_conj(quat), p - center)
    clamped = clamp(lp, -halfext, halfext)
    return quat_rotate(quat, clamped) + center


def one_hot(idx, n):
    """[..., n] float32 one-hot rows of integer indices `idx`."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def sphere_obb_penetration(p, radius, center, quat, halfext):
    """Penetration of a sphere into an OBB. Returns (depth, normal), the
    normal pushing the sphere out of the box; depth <= 0 means no contact.
    A centre inside the box is pushed along the axis of least distance to
    a face (ties go to the first axis, as jnp.argmin's)."""
    lp = quat_rotate(quat_conj(quat), p - center)
    halfext = torch.as_tensor(halfext, dtype=lp.dtype, device=lp.device).expand_as(lp)
    clamped = clamp(lp, -halfext, halfext)
    delta = lp - clamped
    dist = norm(delta)
    outside = dist > 1e-9
    n_out = delta / torch.clamp_min(dist, 1e-9)[..., None]
    # inside: push along the axis with least distance to a face
    face_dist = halfext - torch.abs(lp)
    axis = torch.argmin(face_dist, dim=-1)
    sign = torch.sign(torch.gather(lp, -1, axis[..., None]))[..., 0]
    sign = torch.where(sign == 0, 1.0, sign)
    n_in = one_hot(axis, 3) * sign[..., None]
    depth_out = radius - dist
    depth_in = radius + torch.gather(face_dist, -1, axis[..., None])[..., 0]
    depth = torch.where(outside, depth_out, depth_in)
    n_local = torch.where(outside[..., None], n_out, n_in)
    normal = quat_rotate(quat, n_local)
    return depth, normal


def ray_triangle(origin, direction, a, b, c, max_t):
    """Moller-Trumbore, two-sided (Jolt's mesh raycasts hit back faces for
    the game's use). Returns (hit bool, t; inf where no hit)."""
    e1 = b - a
    e2 = c - a
    h = cross(direction, e2)
    det = dot(e1, h)
    valid = torch.abs(det) > 1e-9
    inv_det = 1.0 / torch.where(valid, det, 1.0)
    s = origin - a
    u = dot(s, h) * inv_det
    q = cross(s, e1)
    v = dot(direction, q) * inv_det
    t = dot(e2, q) * inv_det
    hit = valid & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-5) & (t <= max_t)
    return hit, torch.where(hit, t, torch.inf)


def ray_obb(origin, direction, center, quat, halfext, max_t):
    """Slab test in the box frame. Returns (hit, t; inf where no hit)."""
    lo = quat_rotate(quat_conj(quat), origin - center)
    ld = quat_rotate(quat_conj(quat), direction)
    safe_ld = torch.where(torch.abs(ld) < 1e-9, 1e-9, ld)
    t1 = (-halfext - lo) / safe_ld
    t2 = (halfext - lo) / safe_ld
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    hit = (tmax >= torch.clamp_min(tmin, 0.0)) & (tmin <= max_t)
    t = torch.where(tmin > 0, tmin, 0.0)
    return hit & (t <= max_t), torch.where(hit, t, torch.inf)


_CORNER_SIGNS = (
    (-1.0, -1.0, -1.0), (1.0, -1.0, -1.0), (-1.0, 1.0, -1.0), (1.0, 1.0, -1.0),
    (-1.0, -1.0, 1.0), (1.0, -1.0, 1.0), (-1.0, 1.0, 1.0), (1.0, 1.0, 1.0),
)


def obb_corners(center, quat, halfext):
    """The 8 corners of an OBB: [..., 8, 3]."""
    local = const(_CORNER_SIGNS, halfext.device) * halfext[..., None, :]
    return quat_rotate(quat[..., None, :], local) + center[..., None, :]
