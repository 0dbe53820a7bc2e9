"""Component-wise (structure-of-arrays) collision primitives (counterpart of
c_game_engine_tpu/physics/geometry_soa.py).

Each coordinate is its own broadcastable tensor (typically [L, B] or
[N, B]); functions return component tuples. The arithmetic is written in
the same order as the JAX module so the two round alike.
"""

from __future__ import annotations

import torch


def _maxs(x, s):
    return torch.clamp_min(x, s)


def clip(x, lo, hi):
    """jnp.clip semantics with tensor bounds: min(max(x, lo), hi)."""
    return torch.minimum(torch.maximum(x, lo), hi)


def dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def cross3(ax, ay, az, bx, by, bz):
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def norm3(x, y, z):
    return torch.sqrt(x * x + y * y + z * z)


def normalize3(x, y, z, eps=1e-9):
    n = _maxs(norm3(x, y, z), eps)
    return x / n, y / n, z / n, n


def closest_point_on_triangle_soa(px, py, pz, ax, ay, az, bx, by, bz, cx, cy, cz):
    """Closest point on triangle (a,b,c) to p (Ericson). Returns (qx, qy, qz)."""
    abx, aby, abz = bx - ax, by - ay, bz - az
    acx, acy, acz = cx - ax, cy - ay, cz - az
    apx, apy, apz = px - ax, py - ay, pz - az
    d1 = dot3(abx, aby, abz, apx, apy, apz)
    d2 = dot3(acx, acy, acz, apx, apy, apz)

    bpx, bpy, bpz = px - bx, py - by, pz - bz
    d3 = dot3(abx, aby, abz, bpx, bpy, bpz)
    d4 = dot3(acx, acy, acz, bpx, bpy, bpz)

    cpx, cpy, cpz = px - cx, py - cy, pz - cz
    d5 = dot3(abx, aby, abz, cpx, cpy, cpz)
    d6 = dot3(acx, acy, acz, cpx, cpy, cpz)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    denom = _maxs(va + vb + vc, 1e-30)
    v_f = vb / denom
    w_f = vc / denom
    qx = ax + abx * v_f + acx * w_f
    qy = ay + aby * v_f + acy * w_f
    qz = az + abz * v_f + acz * w_f

    one = torch.ones((), dtype=d1.dtype, device=d1.device)
    zero = torch.zeros((), dtype=d1.dtype, device=d1.device)
    t_ab = clip(d1 / _maxs(d1 - d3, 1e-30), zero, one)
    t_ac = clip(d2 / _maxs(d2 - d6, 1e-30), zero, one)
    t_bc = clip((d4 - d3) / _maxs((d4 - d3) + (d5 - d6), 1e-30), zero, one)

    def sel(cond, x_, y_, z_, qx, qy, qz):
        return torch.where(cond, x_, qx), torch.where(cond, y_, qy), torch.where(cond, z_, qz)

    m_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    qx, qy, qz = sel(m_ab, ax + abx * t_ab, ay + aby * t_ab, az + abz * t_ab, qx, qy, qz)
    m_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    qx, qy, qz = sel(m_ac, ax + acx * t_ac, ay + acy * t_ac, az + acz * t_ac, qx, qy, qz)
    m_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    qx, qy, qz = sel(
        m_bc, bx + (cx - bx) * t_bc, by + (cy - by) * t_bc, bz + (cz - bz) * t_bc, qx, qy, qz
    )
    m_a = (d1 <= 0) & (d2 <= 0)
    qx, qy, qz = sel(m_a, ax, ay, az, qx, qy, qz)
    m_b = (d3 >= 0) & (d4 <= d3)
    qx, qy, qz = sel(m_b, bx, by, bz, qx, qy, qz)
    m_c = (d6 >= 0) & (d5 <= d6)
    qx, qy, qz = sel(m_c, cx, cy, cz, qx, qy, qz)
    return qx, qy, qz


def closest_point_on_vseg_soa(px, py, pz, sx, sy0, sy1, sz):
    """Closest point on the vertical segment x=sx, z=sz, y in [sy0, sy1]."""
    qy = clip(py, sy0, sy1)
    return sx.expand(qy.shape), qy, sz.expand(qy.shape)


def capsule_tri_contact_soa(
    s_x, s_y0, s_y1, s_z, ax, ay, az, bx, by, bz, cx, cy, cz, nx, ny, nz, radius, iters=2
):
    """Deepest-point contact between a vertical capsule axis segment
    (x = s_x, z = s_z, y in [s_y0, s_y1]) and a triangle with face normal
    (nx, ny, nz). Returns (signed, onx, ony, onz): the contact normal
    oriented toward the capsule centre's side of the face and the
    separation along it, so depth = radius - signed (the convention of
    physics/character.py::_collect_contacts)."""
    mx = s_x
    my = (s_y0 + s_y1) * 0.5
    mz = s_z
    qx, qy, qz = closest_point_on_triangle_soa(mx, my, mz, ax, ay, az, bx, by, bz, cx, cy, cz)
    for _ in range(iters):
        px_, py_, pz_ = closest_point_on_vseg_soa(qx, qy, qz, s_x, s_y0, s_y1, s_z)
        qx, qy, qz = closest_point_on_triangle_soa(px_, py_, pz_, ax, ay, az, bx, by, bz, cx, cy, cz)
    dx, dy, dz = px_ - qx, py_ - qy, pz_ - qz
    rx, ry, rz, dist = normalize3(dx, dy, dz)

    side = torch.sign(dot3(mx - ax, my - ay, mz - az, nx, ny, nz))
    side = torch.where(side == 0, 1.0, side)
    flip = torch.sign(dot3(rx, ry, rz, nx, ny, nz)) * side
    flip = torch.where(flip == 0, 1.0, flip)
    onx, ony, onz = rx * flip, ry * flip, rz * flip
    deg = dist <= 1e-6
    onx = torch.where(deg, nx * side, onx)
    ony = torch.where(deg, ny * side, ony)
    onz = torch.where(deg, nz * side, onz)
    signed = dot3(dx, dy, dz, onx, ony, onz)
    return signed, onx, ony, onz


def ray_tri_soa(ox, oy, oz, dx, dy, dz, ax, ay, az, bx, by, bz, cx, cy, cz, max_t):
    """Moller-Trumbore, two-sided. Returns (hit, t)."""
    e1x, e1y, e1z = bx - ax, by - ay, bz - az
    e2x, e2y, e2z = cx - ax, cy - ay, cz - az
    hx, hy, hz = cross3(dx, dy, dz, e2x, e2y, e2z)
    det = dot3(e1x, e1y, e1z, hx, hy, hz)
    valid = torch.abs(det) > 1e-9
    inv = 1.0 / torch.where(valid, det, 1.0)
    sx_, sy_, sz_ = ox - ax, oy - ay, oz - az
    u = dot3(sx_, sy_, sz_, hx, hy, hz) * inv
    qx_, qy_, qz_ = cross3(sx_, sy_, sz_, e1x, e1y, e1z)
    v = dot3(dx, dy, dz, qx_, qy_, qz_) * inv
    t = dot3(e2x, e2y, e2z, qx_, qy_, qz_) * inv
    hit = valid & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-5) & (t <= max_t)
    return hit, torch.where(hit, t, torch.inf)


def quat_rotate_soa(qx, qy, qz, qw, vx, vy, vz):
    """Rotate vector by quaternion, component-wise."""
    tx, ty, tz = cross3(qx, qy, qz, vx, vy, vz)
    tx, ty, tz = 2 * tx, 2 * ty, 2 * tz
    cx_, cy_, cz_ = cross3(qx, qy, qz, tx, ty, tz)
    return vx + qw * tx + cx_, vy + qw * ty + cy_, vz + qw * tz + cz_


def quat_rotate_inv_soa(qx, qy, qz, qw, vx, vy, vz):
    return quat_rotate_soa(-qx, -qy, -qz, qw, vx, vy, vz)


def quat_mul_soa(ax_, ay_, az_, aw_, bx_, by_, bz_, bw_):
    """Hamilton product a*b, component-wise."""
    return (
        aw_ * bx_ + ax_ * bw_ + ay_ * bz_ - az_ * by_,
        aw_ * by_ - ax_ * bz_ + ay_ * bw_ + az_ * bx_,
        aw_ * bz_ + ax_ * by_ - ay_ * bx_ + az_ * bw_,
        aw_ * bw_ - ax_ * bx_ - ay_ * by_ - az_ * bz_,
    )


def closest_point_on_obb_soa(px, py, pz, ox, oy, oz, qx, qy, qz, qw, hx, hy, hz):
    """Closest point on an OBB (center o, quat q, half extents h) to p."""
    lx, ly, lz = quat_rotate_inv_soa(qx, qy, qz, qw, px - ox, py - oy, pz - oz)
    lx = clip(lx, -hx, hx)
    ly = clip(ly, -hy, hy)
    lz = clip(lz, -hz, hz)
    wx, wy, wz = quat_rotate_soa(qx, qy, qz, qw, lx, ly, lz)
    return wx + ox, wy + oy, wz + oz


def ray_obb_soa(ox, oy, oz, dx, dy, dz, cx_, cy_, cz_, qx, qy, qz, qw, hx, hy, hz, max_t):
    """Slab test in the box frame. Returns (hit, t)."""
    lox, loy, loz = quat_rotate_inv_soa(qx, qy, qz, qw, ox - cx_, oy - cy_, oz - cz_)
    ldx, ldy, ldz = quat_rotate_inv_soa(qx, qy, qz, qw, dx, dy, dz)

    def slab(lo, ld, h):
        sld = torch.where(torch.abs(ld) < 1e-9, 1e-9, ld)
        t1 = (-h - lo) / sld
        t2 = (h - lo) / sld
        return torch.minimum(t1, t2), torch.maximum(t1, t2)

    n1, x1 = slab(lox, ldx, hx)
    n2, x2 = slab(loy, ldy, hy)
    n3, x3 = slab(loz, ldz, hz)
    tmin = torch.maximum(torch.maximum(n1, n2), n3)
    tmax = torch.minimum(torch.minimum(x1, x2), x3)
    hit = (tmax >= torch.clamp_min(tmin, 0.0)) & (tmin <= max_t)
    t = torch.clamp_min(tmin, 0.0)
    return hit & (t <= max_t), torch.where(hit, t, torch.inf)


def box_support_soa(qx, qy, qz, qw, hx, hy, hz, nx, ny, nz):
    """Box support extent along direction n: sum_i |h_i * (R_i . n)|."""
    lx, ly, lz = quat_rotate_inv_soa(qx, qy, qz, qw, nx, ny, nz)
    return torch.abs(lx) * hx + torch.abs(ly) * hy + torch.abs(lz) * hz
