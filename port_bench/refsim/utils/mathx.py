"""Scalar, vector, quaternion and camera-matrix helpers used by the tick
and the renderer (counterpart of c_game_engine_tpu/utils/mathx.py).

Quaternions are (x, y, z, w) like Jolt's JPH_Quat.
"""

from __future__ import annotations

import functools

import torch


@functools.cache
def const(values: tuple, device, dtype=torch.float32) -> torch.Tensor:
    """A constant vector built once per (values, device, dtype): the tick
    then copies nothing from the host (a CUDA graph capture refuses such a
    copy). Callers must not write into it."""
    return torch.tensor(values, dtype=dtype, device=device)


def clamp(x, lo, hi):
    return torch.minimum(torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype, device=x.device)),
                         torch.as_tensor(hi, dtype=x.dtype, device=x.device))


def lerp(a, b, t):
    return a + (b - a) * t


def remap(x, in_lo, in_hi, out_lo, out_hi):
    return out_lo + (x - in_lo) * (out_hi - out_lo) / (in_hi - in_lo)


def norm(v, axis=-1, keepdim=False):
    """Euclidean norm over `axis`: the square root of the sum of squares,
    as jnp.linalg.norm computes it."""
    return torch.sqrt(torch.sum(v * v, dim=axis, keepdim=keepdim))


def normalize(v, axis=-1, eps=1e-12):
    return v / torch.clamp_min(norm(v, axis, keepdim=True), eps)


def safe_normalize(v, axis=-1, eps=1e-12):
    """v / |v| along `axis`, and the zero vector where |v| <= eps (no NaN)."""
    n = norm(v, axis, keepdim=True)
    return torch.where(n > eps, v / torch.clamp_min(n, eps), torch.zeros_like(v))


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def dot(a, b, axis=-1):
    return torch.sum(a * b, dim=axis)


# (x, y, z, w). A tuple, not a tensor: a module-level tensor would live on
# one device, and const(QUAT_IDENTITY, device) gives it on any device once.
QUAT_IDENTITY = (0.0, 0.0, 0.0, 1.0)


def quat_from_axis_angle(axis, angle):
    """Unit quaternion for `angle` radians about unit `axis`.
    Broadcasts: axis [..., 3], angle [...]."""
    angle = angle.float()[..., None]
    if isinstance(axis, (list, tuple)):
        axis = const(tuple(axis), angle.device)
    else:
        axis = torch.as_tensor(axis, dtype=torch.float32, device=angle.device)
    xyz = axis * torch.sin(angle * 0.5)
    w = torch.cos(angle * 0.5).expand(xyz.shape[:-1] + (1,))
    return torch.cat([xyz, w], dim=-1)


def quat_normalize(q, eps=1e-12):
    n = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    return q / torch.clamp_min(n, eps)


def quat_rotate(q, v):
    """Rotate vec3 v by unit quaternion q (v' = q v q*)."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    t = 2.0 * cross(qv, v)
    return v + qw * t + cross(qv, t)


def quat_from_euler(euler):
    """ZYX-composed euler (x = pitch, y = yaw, z = roll) to quaternion,
    q = qz * qy * qx, as Jolt's Quat::sEulerAngles."""
    ex, ey, ez = euler[..., 0] * 0.5, euler[..., 1] * 0.5, euler[..., 2] * 0.5
    cx, sx = torch.cos(ex), torch.sin(ex)
    cy, sy = torch.cos(ey), torch.sin(ey)
    cz, sz = torch.cos(ez), torch.sin(ez)
    return torch.stack(
        [
            sx * cy * cz - cx * sy * sz,
            cx * sy * cz + sx * cy * sz,
            cx * cy * sz - sx * sy * cz,
            cx * cy * cz + sx * sy * sz,
        ],
        dim=-1,
    )


def quat_twist_angle(q, axis):
    """Signed rotation angle of q about unit `axis` (the twist of a
    swing-twist decomposition, JPH_Quat's GetRotationAngle(axis))."""
    axis = torch.as_tensor(axis, dtype=q.dtype, device=q.device)
    return 2.0 * torch.atan2(dot(q[..., :3], axis), q[..., 3])


def quat_lerp(a, b, t):
    """Component-wise lerp (JPH_Quat_Lerp semantics; caller normalizes)."""
    return a + (b - a) * t


def quat_mul(a, b):
    """Hamilton product a*b (apply b's rotation first, then a's)."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def quat_conj(q):
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_from_yaw_pitch(yaw, pitch):
    """Camera orientation as yaw about Y then pitch about X
    (q = q_yaw * q_pitch; pitch 0 = level)."""
    hy = yaw * 0.5
    hp = pitch * 0.5
    cy, sy = torch.cos(hy), torch.sin(hy)
    cp, sp = torch.cos(hp), torch.sin(hp)
    return torch.stack([cy * sp, sy * cp, -sy * sp, cy * cp], dim=-1)


def perspective_lh_zo(fov_y_rad, aspect, near, far):
    """Left-handed, zero-to-one depth perspective matrix [4, 4] on the CPU
    (cglm's glm_perspective_lh_zo). `fov_y_rad` is a float32 tensor; the
    z-row constants are computed in double and rounded to float32 as the
    JAX package does."""
    f = 1.0 / torch.tan(torch.as_tensor(fov_y_rad, dtype=torch.float32, device="cpu") * 0.5)
    m = torch.zeros((4, 4), dtype=torch.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = far / (far - near)
    m[2, 3] = -(far * near) / (far - near)
    m[3, 2] = 1.0
    return m


def quat_to_mat3(q):
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    row0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1)
    row1 = torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1)
    row2 = torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def quat_look(position, q):
    """View matrix [..., 4, 4] for a camera at `position` [..., 3] with
    orientation `q` [..., 4] (cglm's glm_quat_look: rotation inverse, then
    translate). The translation is an elementwise product and sum in
    float32, never a matrix product."""
    rot = quat_to_mat3(quat_conj(quat_normalize(q)))
    m = torch.eye(4, dtype=torch.float32, device=rot.device).repeat(*rot.shape[:-2], 1, 1)
    m[..., :3, :3] = rot
    m[..., :3, 3] = -(rot * position[..., None, :]).sum(-1)
    return m
