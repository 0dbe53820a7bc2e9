"""Batch-wide physics of the tick in lanes-major layout (counterpart of the
parts of c_game_engine_tpu/physics/batched.py on the ported path).

Shapes: B = env batch, N = actor slots, R = flattened ray count.

The tick always runs the kernel formulation the JAX package takes on the
TPU (`_use_pallas()` true): the character controller resolves through
kernel K1 (ops/capsule_resolve.py) with one doubled [2B] launch for the
main and step-up poses, and the static part of every ray goes through
kernel K2 (ops/ray_tris.py). The rigid-body step, with kernel K3
(ops/body_contacts.py), is physics/bodies.py::step_bodies_batched. On a CPU
tensor the kernels run as their plain PyTorch versions.

`resolve_capsule_batched` is the JAX package's other formulation (its XLA
path, `_use_pallas()` false): triangle candidates per lane from the
uniform grid (`_grid_cells_at`) instead of K1's per-128-lane-block chunk
lists. It is plain PyTorch and not on the tick; it measures how far K1's
block-wide candidate set moves a lane (ROADMAP fault f).
"""

from __future__ import annotations

import torch

from refsim.actors.defs import Layer, Motion, Shape
from refsim.core import gates
from refsim.ops.capsule_resolve import BLK, resolve_capsule
from refsim.ops.ray_tris import ray_tris
from refsim.physics import geometry_soa as g
from refsim.physics.character import (
    CAPSULE_HALF_HEIGHT,
    CAPSULE_RADIUS,
    MAX_SLOPE_COS,
    STEP_UP,
    STICK_DOWN,
)
from refsim.physics.grid import cell_of
from refsim.utils.mathx import const, norm

# the rigid-body solver's constants (physics/bodies.py steps the bodies),
# copied from c_game_engine_tpu/physics/batched.py:65-89
GRAVITY_Y = -9.81
MAP_FRICTION = 4.25
# combined constraint sweeps per substep: the triangle solve, then the pair
# solve, so a stack's weight reaches the floor contact within a tick
SOLVER_ITERS = 6
# island sleeping (Jolt: 0.03 m/s point velocity for 0.5 s = 30 ticks)
SLEEP_SPEED2 = 0.03 * 0.03
SLEEP_AFTER = 30
BAUMGARTE = 0.2
PENETRATION_SLOP = 0.005
RELAX = 0.7
REST_BLEED = 0.6  # per-tick velocity kept by slow flat-supported bodies
MANIFOLD_K = 4
# pair narrowphase: P_CAP candidate slots per env, each a K2-point manifold
P_CAP = 16
K2 = 4
PAIR_CAND_SLACK = 0.3


def solid_mask(cmap, active):
    """[B, N] actors that collide: active, with a shape, not motion NONE,
    not a sensor."""
    return (
        active
        & (cmap.shape != int(Shape.EMPTY))
        & (cmap.motion != int(Motion.NONE))
        & (cmap.layer != int(Layer.SENSOR))
    )


def _solid_actor_soa(cmap, actors):
    """Per-actor solid-collider comps, [N, B] each (from [B, N])."""
    solid = solid_mask(cmap, actors.active)  # [B, N]
    qx, qy, qz, qw = (actors.quat[..., k].T for k in range(4))  # [N, B]
    scx, scy, scz = (cmap.shape_center[:, k][:, None] for k in range(3))
    ox, oy, oz = g.quat_rotate_soa(qx, qy, qz, qw, scx, scy, scz)
    ox = ox + actors.pos[..., 0].T
    oy = oy + actors.pos[..., 1].T
    oz = oz + actors.pos[..., 2].T
    hx, hy, hz = (cmap.halfext[:, k][:, None] for k in range(3))
    return solid.T, (ox, oy, oz), (qx, qy, qz, qw), (hx, hy, hz)


def _grid_cells_at(cmap, px, pz):
    """[B] positions -> candidate triangle lists [L, B] (-1 padded)."""
    return cmap.grid_cells[cell_of(cmap, px, pz)].T


def _tri_comps(cmap, cand):
    """The 12 per-triangle components (tri_soa rows) for the candidate
    index tensor `cand` (any shape, -1 for none): 12 tensors shaped like
    cand."""
    candc = torch.clamp_min(cand, 0).long()
    return [cmap.tri_soa[k][candc] for k in range(12)]


def _capsule_contacts(cmap, pos, solid_t, box_o, box_q, box_h):
    """Every capsule contact at positions pos [B, 3]: triangles from the
    grid cell of each lane, then the actor boxes.
    Returns (depth [L+N, B], normal components [L+N, B] x 3)."""
    px, py, pz = pos[:, 0], pos[:, 1], pos[:, 2]
    sy0, sy1 = py - CAPSULE_HALF_HEIGHT, py + CAPSULE_HALF_HEIGHT

    # ---- static triangles
    cand = _grid_cells_at(cmap, px, pz)  # [L, B]
    c = _tri_comps(cmap, cand)
    cand_ok = (cand >= 0) & cmap.tri_valid[torch.clamp_min(cand, 0).long()]
    signed, nx, ny, nz = g.capsule_tri_contact_soa(
        px[None], sy0[None], sy1[None], pz[None], *c, CAPSULE_RADIUS,
    )
    tri_depth = torch.where(cand_ok, CAPSULE_RADIUS - signed, -torch.inf)

    # ---- solid actor boxes
    ox, oy, oz = box_o
    qx, qy, qz, qw = box_q
    hx, hy, hz = box_h
    wx, wy, wz = g.closest_point_on_obb_soa(px[None], py[None], pz[None], ox, oy, oz, qx, qy, qz, qw, hx, hy, hz)
    for _ in range(2):
        spx, spy, spz = g.closest_point_on_vseg_soa(wx, wy, wz, px[None], sy0[None], sy1[None], pz[None])
        wx, wy, wz = g.closest_point_on_obb_soa(spx, spy, spz, ox, oy, oz, qx, qy, qz, qw, hx, hy, hz)
    bnx, bny, bnz, bdist = g.normalize3(spx - wx, spy - wy, spz - wz)
    box_depth = torch.where(solid_t, CAPSULE_RADIUS - bdist, -torch.inf)

    depth = torch.cat([tri_depth, box_depth], 0)
    return depth, torch.cat([nx, bnx], 0), torch.cat([ny, bny], 0), torch.cat([nz, bnz], 0)


def resolve_capsule_batched(cmap, pos, vel, solid_ctx, iters=4):
    """Penetration resolution with per-lane grid candidates (the JAX
    package's XLA path, not K1). pos/vel [B, 3]; solid_ctx from
    `_solid_actor_soa`. Returns (pos, vel, grounded [B])."""
    solid_t, box_o, box_q, box_h = solid_ctx
    grounded = torch.zeros(pos.shape[0], dtype=torch.bool, device=pos.device)
    for _ in range(iters):
        depth, nx, ny, nz = _capsule_contacts(cmap, pos, solid_t, box_o, box_q, box_h)
        worst = torch.argmax(depth, dim=0)[None]  # [1, B]: the first deepest contact
        d = depth.gather(0, worst)[0]
        n = torch.stack([nx.gather(0, worst)[0], ny.gather(0, worst)[0], nz.gather(0, worst)[0]], -1)
        hit = d > -0.01
        push = torch.clamp_min(d, 0.0) * hit
        pos = pos + n * push[:, None]
        vn = vel[:, 0] * n[:, 0] + vel[:, 1] * n[:, 1] + vel[:, 2] * n[:, 2]
        clip = hit & (vn < 0)
        vel = vel - n * torch.where(clip, vn, 0.0)[:, None]
        grounded = grounded | (hit & (n[:, 1] >= MAX_SLOPE_COS))
    return pos, vel, grounded


def _make_kernel_ctx(solid_ctx):
    """K1 box inputs: [8, N, B] (center, quat, mask) and [4, N, B] (half
    extents, pad) — the box half of physics/batched.py::_make_pallas_ctx;
    the triangle table is cached on the map (CompiledMap.tri16)."""
    solid_t, box_o, box_q, box_h = solid_ctx
    n, b = solid_t.shape
    bc = lambda a: a.expand(n, b)
    box8 = torch.stack([bc(box_o[0]), bc(box_o[1]), bc(box_o[2]),
                        bc(box_q[0]), bc(box_q[1]), bc(box_q[2]), bc(box_q[3]),
                        solid_t.float()])
    boxh = torch.stack([bc(box_h[0]), bc(box_h[1]), bc(box_h[2]),
                        torch.zeros((n, b), dtype=torch.float32, device=solid_t.device)])
    return box8, boxh


def _resolve_dispatch(cmap, pos, vel, box8, boxh):
    """K1 over pos/vel [B, 3], padding the batch with zero lanes to a
    multiple of 128 (physics/batched.py:238-247)."""
    b = pos.shape[0]
    pad = (-b) % BLK
    if pad:
        zp = torch.zeros((pad, 3), dtype=pos.dtype, device=pos.device)
        pos = torch.cat([pos, zp], 0)
        vel = torch.cat([vel, zp], 0)
        zb = lambda t: torch.zeros((*t.shape[:2], pad), dtype=t.dtype, device=t.device)
        box8 = torch.cat([box8, zb(box8)], -1)
        boxh = torch.cat([boxh, zb(boxh)], -1)
    p, v, gr = resolve_capsule(cmap.tri16, cmap.chunk_bounds, box8.contiguous(), boxh.contiguous(), pos, vel)
    if pad:
        p, v, gr = p[:b], v[:b], gr[:b]
    return p, v, gr


def update_character_batched(cmap, actors, pos, vel, dt, was_on_ground, jumping, noclip, exclude_idx=None):
    """Batched CharacterVirtual step. pos/vel [B, 3], flags [B]. exclude_idx
    [B] drops one actor's collider per env (the held body)."""
    b = pos.shape[0]
    dev = pos.device
    solid_t, box_o, box_q, box_h = _solid_actor_soa(cmap, actors)
    if exclude_idx is not None:
        solid_t = solid_t & (torch.arange(cmap.num_actors, device=dev)[:, None] != exclude_idx[None, :])
    box8, boxh = _make_kernel_ctx((solid_t, box_o, box_q, box_h))
    new_pos = pos + vel * dt
    lifted = new_pos + const((0.0, STEP_UP, 0.0), dev)

    # main + step-up resolves as one double-batch kernel launch
    p12, v12, g12 = _resolve_dispatch(
        cmap,
        torch.cat([new_pos, lifted], 0),
        torch.cat([vel, vel], 0),
        box8.repeat(1, 1, 2),
        boxh.repeat(1, 1, 2),
    )
    p, v, grounded = p12[:b], v12[:b], g12[:b]
    p2, v2, g2 = p12[b:], v12[b:], g12[b:]

    # stair step-up
    horiz = const((1.0, 0.0, 1.0), dev)
    h_in = norm(vel * horiz)
    h_out = norm(v * horiz)
    blocked = (h_in > 1e-4) & (h_out < 0.9 * h_in)
    h2 = norm(v2 * horiz)
    use_step = blocked & (h2 > h_out + 1e-4)
    p = torch.where(use_step[:, None], p2, p)
    v = torch.where(use_step[:, None], v2, v)
    grounded = torch.where(use_step, g2, grounded)

    # stick-to-floor: a full resolve launch, consumed only by lanes that
    # just left the ground; skipped batch-globally when nobody needs it
    # (the JAX tick's lax.cond; a gate of core/gates.py)
    want_stick = was_on_ground & ~jumping & (v[:, 1] <= 1e-4) & ~grounded

    def stick_to_floor():
        p3, v3, g3 = _resolve_dispatch(cmap, p + const((0.0, -STICK_DOWN, 0.0), dev), v, box8, boxh)
        stick = want_stick & g3
        return torch.where(stick[:, None], p3, p), torch.where(stick[:, None], v3, v), grounded | stick

    p, v, grounded = gates.gate(gates.read(want_stick.any()), stick_to_floor, lambda: (p, v, grounded))

    pos_out = torch.where(noclip[:, None], new_pos, p)
    vel_out = torch.where(noclip[:, None], vel, v)
    grounded_out = torch.where(noclip, False, grounded)
    return pos_out, vel_out, grounded_out


def cast_rays_batched(
    cmap,
    actors,
    origin,
    direction,
    max_dist,
    exclude=None,
    require_flags=0,
    B_env=None,
    static_only=None,
    layout="interleaved",
):
    """Batched hitscan. origin/direction [R, 3] (R = B * K rays, flattened
    over the batch); `actors` leaves are [B, N, ...] (pass B_env=B). max_dist
    and require_flags are scalars or [R] tensors; exclude [R] actor ids;
    static_only [R] bool restricts a ray to the static world.
    layout: how the K rays of each env are flattened, "interleaved" =
    env-major [e0k0, e0k1, ..., e1k0, ...], "kind_major" = every env's ray
    0, then every env's ray 1, ... (the tick's merged launch, which keeps
    K2's 128-ray blocks spatially tight).

    Returns (hit [R], fraction [R], actor_idx [R] with -1 = static world)."""
    r = origin.shape[0]
    dev = origin.device
    ox, oy, oz = origin[:, 0], origin[:, 1], origin[:, 2]
    dx, dy, dz = direction[:, 0], direction[:, 1], direction[:, 2]

    # ---- static triangles (K2)
    t_static = ray_tris(cmap.tri16, cmap.chunk_bounds, origin, direction, max_dist)
    t_static = torch.where(t_static > 1e29, torch.inf, t_static)

    # ---- actor boxes: [N, R]
    b = B_env if B_env is not None else r
    k = r // b
    n = cmap.num_actors

    def actor_comp(a):  # [B, N] -> [N, R]
        if k == 1:
            return a.T
        if layout == "kind_major":
            return a.T.repeat(1, k)
        return a.T[:, :, None].expand(n, b, k).reshape(n, r)

    qx, qy, qz, qw = (actor_comp(actors.quat[..., j]) for j in range(4))
    scx, scy, scz = (cmap.shape_center[:, j][:, None] for j in range(3))
    cx_, cy_, cz_ = g.quat_rotate_soa(qx, qy, qz, qw, scx, scy, scz)
    cx_ = cx_ + actor_comp(actors.pos[..., 0])
    cy_ = cy_ + actor_comp(actors.pos[..., 1])
    cz_ = cz_ + actor_comp(actors.pos[..., 2])
    hx, hy, hz = (cmap.halfext[:, j][:, None] for j in range(3))
    bhit, bt = g.ray_obb_soa(
        ox[None], oy[None], oz[None], dx[None], dy[None], dz[None],
        cx_, cy_, cz_, qx, qy, qz, qw, hx, hy, hz, max_dist,
    )
    solid = actor_comp(solid_mask(cmap, actors.active))
    req = require_flags  # an int or [R]
    solid = solid & ((cmap.flags[:, None] & req) == req)
    if exclude is not None:
        solid = solid & (torch.arange(n, device=dev)[:, None] != exclude[None, :])
    if static_only is not None:
        solid = solid & ~static_only[None, :]
    bt = torch.where(solid & bhit, bt, torch.inf)
    k_best = torch.argmin(bt, dim=0)  # [R] first minimum
    t_act = bt.gather(0, k_best[None])[0]

    t_best = torch.minimum(t_static, t_act)
    idx = torch.where(t_act < t_static, k_best.int(), -1)
    hit_any = torch.isfinite(t_best)
    frac = torch.where(hit_any, t_best / max_dist, 1.0).float()
    return hit_any, frac, idx
