"""Batched rigid-body step (counterpart of
c_game_engine_tpu/physics/batched.py::step_bodies_batched, :459-1808).

Shapes: B = env batch, N = actor slots, D = dynamic-body slots, P = pair
slots (P_CAP), K = triangle manifold size, K2 = pair manifold size. Per-body
arrays are [D, B] components, pair arrays [P, B] or [P, K2, B].

Once per tick: the persistent pair normals and support radii, the
island-synchronized sleep test and the wake tests, then (only when some
body in the batch is awake) the compacted SAT pair narrowphase, the
warm-start key match and the triangle manifold from kernel K3
(ops/body_contacts.py), then n_substeps substeps of gravity, the player
contact, depth recompute, warm start and SOLVER_ITERS Jacobi sweeps of the
triangle and pair solves, then rest-bleed and the warm-cache writeback.

The port takes the kernel formulation the JAX package takes on the TPU
(`_use_pallas()` true): triangle contacts come from K3's per-block chunk
lists, not from the uniform grid. The JAX function's batch-global
`lax.cond` gates stay gates with the same semantics (core/gates.py: in
this reference a host `if`; the port makes them conditional nodes of its
tick graph): the body-activity gate (`awake.any()`, batched.py:1764) and,
inside it, the pair-activity gate (`pair_any`, batched.py:955 and :1664).
An open gate leaves an env that needed neither stage as the closed
gate would, so a shard of the batch steps as the whole batch does
(parallel/mesh.py). For that the pair warm-cache writeback keys on each
env's own pair activity (`pair_env`), a departure from the JAX package,
which re-keys every env's cache when any env of the batch has one
(batched.py:1752-1753; ROADMAP.md §3 i). The one-hot contractions
(`torch.einsum` with d2n, ohA, ohB: the JAX package's `_einsum32`) stay
exact because TF32 is off
(the benchmark turns it off). The upstream engine's known faults
(ROADMAP.md §3 e) are kept for parity, as in the port: this copy carries
every departure of the port's from the JAX package as it stood.
"""

from __future__ import annotations

import numpy as np
import torch

from refsim.actors.defs import Motion
from refsim.core import gates
from refsim.core.state import PAIR_WARM_CAP
from refsim.ops.body_contacts import BLK as PBLK
from refsim.ops.body_contacts import BODY_ROWS, body_contacts
from refsim.physics import geometry_soa as g
from refsim.physics.batched import (
    BAUMGARTE,
    GRAVITY_Y,
    K2,
    MANIFOLD_K,
    MAP_FRICTION,
    P_CAP,
    PAIR_CAND_SLACK,
    PENETRATION_SLOP,
    RELAX,
    REST_BLEED,
    SLEEP_AFTER,
    SLEEP_SPEED2,
    SOLVER_ITERS,
    solid_mask,
)
from refsim.physics.character import (
    CAPSULE_HALF_HEIGHT,
    CAPSULE_RADIUS,
    CHARACTER_MASS,
)
from refsim.utils.mathx import const

LAT_M = 0.05  # lateral clip margin of the pair manifold (batched.py:853)

assert P_CAP <= PAIR_WARM_CAP, "warm-start cache narrower than the pair table"


# the 8 signed corners of a box (batched.py:746-754)
_SIGNS = np.array(
    [(sx, sy, sz) for sx in (-1.0, 1.0) for sy in (-1.0, 1.0) for sz in (-1.0, 1.0)], np.float32
)


def _clip0(x, hi):
    """jnp.clip(x, 0.0, hi) with a tensor upper bound."""
    return torch.minimum(torch.clamp_min(x, 0.0), hi)


def _support_toward(qx, qy, qz, qw, hx, hy, hz, nx, ny, nz, verts=None, is_box=None):
    """Support extent of a dynamic body from its shape centre along -n (n the
    world contact normal pointing toward the centre). verts None: the
    closed-form box support; verts [D, V, 3]: the max over the vertex cloud,
    with is_box [D] bool rows taking the closed form."""
    lx, ly, lz = g.quat_rotate_inv_soa(qx, qy, qz, qw, nx, ny, nz)
    box_sup = torch.abs(lx) * hx + torch.abs(ly) * hy + torch.abs(lz) * hz
    if verts is None:
        return box_sup
    d, v_cnt, _ = verts.shape
    extra = (1,) * (lx.ndim - 1)
    vsh = (d, v_cnt) + extra
    vx = verts[:, :, 0].reshape(vsh)
    vy = verts[:, :, 1].reshape(vsh)
    vz = verts[:, :, 2].reshape(vsh)
    acc = torch.amax(-(vx * lx[:, None] + vy * ly[:, None] + vz * lz[:, None]), dim=1)
    if is_box is not None:
        acc = torch.where(is_box[:d].reshape((d,) + extra), box_sup, acc)
    return acc


def _rot_inv_apply(qx, qy, qz, qw, iIx, iIy, iIz, tx, ty, tz):
    """World I^-1 @ t for a diagonal local inertia."""
    lx, ly, lz = g.quat_rotate_inv_soa(qx, qy, qz, qw, tx, ty, tz)
    lx, ly, lz = lx * iIx, ly * iIy, lz * iIz
    return g.quat_rotate_soa(qx, qy, qz, qw, lx, ly, lz)


def _rot_rows(qx, qy, qz, qw):
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    return (
        (1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)),
        (2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)),
        (2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)),
    )


def _gather1(a, i):
    """a[p, i[p, b], b] for a [P, C, B] and i [P, B]."""
    return a.gather(1, i[:, None, :])[:, 0, :]


def _pair_gen(cmap, w):
    """Compacted SAT pair narrowphase (batched.py:665-923): the top-P
    broadphase candidates per env, a 16-axis SAT and a K2-point manifold
    each. `w` holds the per-tick tables of step_bodies_batched."""
    n, D, B, P, DN = w["n"], w["D"], w["B"], w["P"], w["D"] * w["n"]
    dev = w["dev"]
    slc = w["slc"]
    prio = torch.where(
        (w["pair_bp"] & w["keep_pair"][:, :, None]).reshape(DN, B),
        DN - torch.arange(DN, dtype=torch.int32, device=dev)[:, None],
        0,
    ).int()
    vals = torch.topk(prio.T, P, dim=1).values.T  # [P, B]
    pr_on = vals > 0
    fidx = torch.where(pr_on, DN - vals, 0).long()
    p_d = fidx // n  # A-side dyn lane
    p_n = fidx % n  # B-side actor slot
    a_act = slc[p_d]
    fidx_keys = torch.where(pr_on, fidx, -1).int()
    use_hulls = not cmap.aux["hulls_are_boxes"]
    stat_cols = [cmap.halfext, cmap.inv_mass[:, None], cmap.inv_inertia, cmap.friction[:, None]]
    if use_hulls:
        stat_cols.append(cmap.hull_verts.reshape(n, -1))
    stat = torch.cat(stat_cols, 1)  # [N, F]
    sa = stat[a_act]  # [P, B, F]
    sb = stat[p_n]
    hax, hay, haz = sa[..., 0], sa[..., 1], sa[..., 2]
    hbx, hby, hbz = sb[..., 0], sb[..., 1], sb[..., 2]
    a_invm = sa[..., 3]
    a_iIx, a_iIy, a_iIz = sa[..., 4], sa[..., 5], sa[..., 6]
    b_iIx, b_iIy, b_iIz = sb[..., 4], sb[..., 5], sb[..., 6]
    dyn_b = torch.stack([*w["o_c"], *w["o_q"], *w["o_v"], w["o_inv_m"]], -1)  # [N, B, 11]
    db = dyn_b.gather(0, p_n[:, :, None].expand(P, B, 11))  # [P, B, 11]
    pB_cx, pB_cy, pB_cz = db[..., 0], db[..., 1], db[..., 2]
    pB_qx, pB_qy, pB_qz, pB_qw = db[..., 3], db[..., 4], db[..., 5], db[..., 6]
    b_invm = db[..., 10]
    dyn_a = torch.stack([*w["cc0"], *w["dq0"]], -1)  # [D, B, 7]
    da = dyn_a.gather(0, p_d[:, :, None].expand(P, B, 7))
    pA_cx, pA_cy, pA_cz = da[..., 0], da[..., 1], da[..., 2]
    pA_qx, pA_qy, pA_qz, pA_qw = da[..., 3], da[..., 4], da[..., 5], da[..., 6]
    a2d_pn = cmap.actor_to_dyn[p_n]
    b_dyn = (a2d_pn >= 0) & pr_on
    b_dl = torch.clamp(a2d_pn, 0, D - 1)
    b_dynf = b_dyn.float()
    b_iIx, b_iIy, b_iIz = b_iIx * b_dynf, b_iIy * b_dynf, b_iIz * b_dynf
    # kinematic/static B-side velocity contribution (doors push boxes)
    vkBx = db[..., 7] * (1.0 - b_dynf)
    vkBy = db[..., 8] * (1.0 - b_dynf)
    vkBz = db[..., 9] * (1.0 - b_dynf)
    tx_p = pA_cx - pB_cx
    ty_p = pA_cy - pB_cy
    tz_p = pA_cz - pB_cz

    # per-side support vertex clouds [P, NV, B] (boxes: their 8 corners)
    if use_hulls:
        v_cnt = cmap.hull_verts.shape[1]
        hvA = sa[..., 8: 8 + 3 * v_cnt].reshape(P, B, v_cnt, 3)
        hvB = sb[..., 8: 8 + 3 * v_cnt].reshape(P, B, v_cnt, 3)
        vA_x, vA_y, vA_z = (hvA[..., k].permute(0, 2, 1) for k in range(3))
        vB_x, vB_y, vB_z = (hvB[..., k].permute(0, 2, 1) for k in range(3))
    else:
        s_of = lambda k: const(tuple(_SIGNS[:, k].tolist()), dev)[None, :, None]  # [1, 8, 1]
        vA_x, vA_y, vA_z = (s_of(k) * h[:, None, :] for k, h in enumerate((hax, hay, haz)))
        vB_x, vB_y, vB_z = (s_of(k) * h[:, None, :] for k, h in enumerate((hbx, hby, hbz)))

    # ---- SAT over 16 axes [P, 16, B]: 3+3 face axes, 9 edge crosses, centre
    RA = _rot_rows(pA_qx, pA_qy, pA_qz, pA_qw)
    RB = _rot_rows(pB_qx, pB_qy, pB_qz, pB_qw)
    axA = [(RA[0][c], RA[1][c], RA[2][c]) for c in range(3)]
    axB = [(RB[0][c], RB[1][c], RB[2][c]) for c in range(3)]
    ax_list = axA + axB
    for ia in range(3):
        for ib in range(3):
            ax_list.append(g.cross3(*axA[ia], *axB[ib]))
    ax_list.append((tx_p, ty_p, tz_p))
    AXS = torch.stack([a[0] for a in ax_list], 1)
    AYS = torch.stack([a[1] for a in ax_list], 1)
    AZS = torch.stack([a[2] for a in ax_list], 1)
    len2 = AXS * AXS + AYS * AYS + AZS * AZS
    axis_ok = len2 > 1e-12
    inv_l = torch.rsqrt(torch.clamp_min(len2, 1e-12))
    AXS, AYS, AZS = AXS * inv_l, AYS * inv_l, AZS * inv_l

    e5 = lambda a: a[:, None, :]  # [P, B] -> [P, 1, B]
    lAX = e5(RA[0][0]) * AXS + e5(RA[1][0]) * AYS + e5(RA[2][0]) * AZS
    lAY = e5(RA[0][1]) * AXS + e5(RA[1][1]) * AYS + e5(RA[2][1]) * AZS
    lAZ = e5(RA[0][2]) * AXS + e5(RA[1][2]) * AYS + e5(RA[2][2]) * AZS
    lBX = e5(RB[0][0]) * AXS + e5(RB[1][0]) * AYS + e5(RB[2][0]) * AZS
    lBY = e5(RB[0][1]) * AXS + e5(RB[1][1]) * AYS + e5(RB[2][1]) * AZS
    lBZ = e5(RB[0][2]) * AXS + e5(RB[1][2]) * AYS + e5(RB[2][2]) * AZS
    # every vertex against every axis at once: [P, NV, 16, B]
    ev = lambda a: a[:, :, None, :]
    ea = lambda a: a[:, None]
    sA = ev(vA_x) * ea(lAX) + ev(vA_y) * ea(lAY) + ev(vA_z) * ea(lAZ)
    sB = ev(vB_x) * ea(lBX) + ev(vB_y) * ea(lBY) + ev(vB_z) * ea(lBZ)
    supAp, supAm = sA.amax(1), (-sA).amax(1)
    supBp, supBm = sB.amax(1), (-sB).amax(1)
    tdot = e5(tx_p) * AXS + e5(ty_p) * AYS + e5(tz_p) * AZS
    pen_p = supBp + supAm - tdot  # A toward +a side of B
    pen_m = supBm + supAp + tdot
    d_ax = torch.where(axis_ok, torch.minimum(pen_p, pen_m), torch.inf)
    best_ax = torch.argmin(d_ax, dim=1)
    sat_d = _gather1(d_ax, best_ax)
    sgn = torch.where(_gather1(pen_p, best_ax) <= _gather1(pen_m, best_ax), 1.0, -1.0)
    pn2_x = _gather1(AXS, best_ax) * sgn
    pn2_y = _gather1(AYS, best_ax) * sgn
    pn2_z = _gather1(AZS, best_ax) * sgn

    # ---- manifold candidates along the SAT normal (n points B -> A)
    lAx, lAy, lAz = g.quat_rotate_inv_soa(pA_qx, pA_qy, pA_qz, pA_qw, pn2_x, pn2_y, pn2_z)
    lBx, lBy, lBz = g.quat_rotate_inv_soa(pB_qx, pB_qy, pB_qz, pB_qw, pn2_x, pn2_y, pn2_z)
    tn_p = tx_p * pn2_x + ty_p * pn2_y + tz_p * pn2_z
    qBAx, qBAy, qBAz, qBAw = g.quat_mul_soa(-pB_qx, -pB_qy, -pB_qz, pB_qw, pA_qx, pA_qy, pA_qz, pA_qw)
    qABx, qABy, qABz, qABw = g.quat_mul_soa(-pA_qx, -pA_qy, -pA_qz, pA_qw, pB_qx, pB_qy, pB_qz, pB_qw)
    tBx, tBy, tBz = g.quat_rotate_inv_soa(pB_qx, pB_qy, pB_qz, pB_qw, tx_p, ty_p, tz_p)
    tAx, tAy, tAz = g.quat_rotate_inv_soa(pA_qx, pA_qy, pA_qz, pA_qw, tx_p, ty_p, tz_p)
    dA_n = vA_x * e5(lAx) + vA_y * e5(lAy) + vA_z * e5(lAz)  # [P, NV, B]
    dB_n = vB_x * e5(lBx) + vB_y * e5(lBy) + vB_z * e5(lBz)
    supAm_n = torch.amax(-dA_n, dim=1)  # A's extent toward B (along -n)
    supBp_n = torch.amax(dB_n, dim=1)  # B's extent toward A (along +n)
    iA_ = torch.argmin(dA_n, dim=1)  # A's support vertex along -n
    iB_ = torch.argmax(dB_n, dim=1)
    eA_x, eA_y, eA_z = _gather1(vA_x, iA_), _gather1(vA_y, iA_), _gather1(vA_z, iA_)
    eB_x, eB_y, eB_z = _gather1(vB_x, iB_), _gather1(vB_y, iB_), _gather1(vB_z, iB_)

    # A's vertices into B: depth along n + lateral containment in B's box
    dvA = e5(supBp_n - tn_p) - dA_n
    liAx, liAy, liAz = g.quat_rotate_soa(e5(qBAx), e5(qBAy), e5(qBAz), e5(qBAw), vA_x, vA_y, vA_z)
    latA = (
        (torch.abs(liAx + e5(tBx)) <= e5(hbx) + LAT_M)
        & (torch.abs(liAy + e5(tBy)) <= e5(hby) + LAT_M)
        & (torch.abs(liAz + e5(tBz)) <= e5(hbz) + LAT_M)
    )
    wAx, wAy, wAz = g.quat_rotate_soa(e5(pA_qx), e5(pA_qy), e5(pA_qz), e5(pA_qw), vA_x, vA_y, vA_z)
    # B's vertices into A
    dvB = e5(supAm_n - tn_p) + dB_n
    liBx, liBy, liBz = g.quat_rotate_soa(e5(qABx), e5(qABy), e5(qABz), e5(qABw), vB_x, vB_y, vB_z)
    latB = (
        (torch.abs(liBx - e5(tAx)) <= e5(hax) + LAT_M)
        & (torch.abs(liBy - e5(tAy)) <= e5(hay) + LAT_M)
        & (torch.abs(liBz - e5(tAz)) <= e5(haz) + LAT_M)
    )
    wBx, wBy, wBz = g.quat_rotate_soa(e5(pB_qx), e5(pB_qy), e5(pB_qz), e5(pB_qw), vB_x, vB_y, vB_z)
    # edge-edge / deep-support fallback: midpoint of the two support points
    eAw = g.quat_rotate_soa(pA_qx, pA_qy, pA_qz, pA_qw, eA_x, eA_y, eA_z)
    eBw = g.quat_rotate_soa(pB_qx, pB_qy, pB_qz, pB_qw, eB_x, eB_y, eB_z)

    cat = lambda a, b, c: torch.cat([a, b, c[:, None, :]], 1)
    sat_b = sat_d[:, None, :]
    dstack = cat(torch.minimum(dvA, sat_b), torch.minimum(dvB, sat_b), sat_d - 1e-4)  # [P, C, B]
    ok_stack = cat(latA, latB, torch.ones_like(pr_on))
    pxs = cat(e5(pA_cx) + wAx, e5(pB_cx) + wBx, 0.5 * (pA_cx + eAw[0] + pB_cx + eBw[0]))
    pys = cat(e5(pA_cy) + wAy, e5(pB_cy) + wBy, 0.5 * (pA_cy + eAw[1] + pB_cy + eBw[1]))
    pzs = cat(e5(pA_cz) + wAz, e5(pB_cz) + wBz, 0.5 * (pA_cz + eAw[2] + pB_cz + eBw[2]))
    C = dstack.shape[1]
    live_gate = pr_on & (sat_d > -PAIR_CAND_SLACK)
    dstack = torch.where(ok_stack & live_gate[:, None, :], dstack, -torch.inf)
    selp = [[] for _ in range(4)]
    dwork = dstack
    c_ids = torch.arange(C, device=dev)[None, :, None]
    for _k in range(K2):
        i_ = torch.argmax(dwork, dim=1)
        for li, a in enumerate((dwork, pxs, pys, pzs)):
            selp[li].append(_gather1(a, i_))
        dwork = torch.where(c_ids == i_[:, None, :], -torch.inf, dwork)
    pd0, pp_x, pp_y, pp_z = (torch.stack(s, 1) for s in selp)  # [P, K2, B]

    # one-hot pair -> dyn-lane routing maps [P, D, B]
    d_ids = torch.arange(D, device=dev)[None, :, None]
    ohA = ((p_d[:, None, :] == d_ids) & pr_on[:, None, :]).float()
    ohB = ((b_dl[:, None, :] == d_ids) & b_dyn[:, None, :]).float()
    a_mu_p = torch.sqrt(cmap.friction[a_act] * cmap.friction[p_n])  # geometric mean
    return dict(
        pd0=pd0, pp_x=pp_x, pp_y=pp_y, pp_z=pp_z, pcand_live=pd0 > -PAIR_CAND_SLACK,
        pn2_x=pn2_x, pn2_y=pn2_y, pn2_z=pn2_z, ohA=ohA, ohB=ohB, a_mu_p=a_mu_p,
        a_invm=a_invm, b_invm=b_invm, a_iI=(a_iIx, a_iIy, a_iIz), b_iI=(b_iIx, b_iIy, b_iIz),
        pA_q=(pA_qx, pA_qy, pA_qz, pA_qw), pB_q=(pB_qx, pB_qy, pB_qz, pB_qw),
        pA_c=(pA_cx, pA_cy, pA_cz), pB_c=(pB_cx, pB_cy, pB_cz), vkB=(vkBx, vkBy, vkBz),
        b_dynf=b_dynf, fidx_keys=fidx_keys,
    )


def _pair_zero(D, B, P, dev):
    """What the idle pair gate hands the solver (batched.py:925-936)."""
    zpk = torch.zeros((P, K2, B), device=dev)
    zp = torch.zeros((P, B), device=dev)
    zpd = torch.zeros((P, D, B), device=dev)
    return dict(
        pd0=zpk, pp_x=zpk, pp_y=zpk, pp_z=zpk, pcand_live=torch.zeros((P, K2, B), dtype=torch.bool, device=dev),
        pn2_x=zp, pn2_y=zp, pn2_z=zp, ohA=zpd, ohB=zpd, a_mu_p=zp, a_invm=zp, b_invm=zp,
        a_iI=(zp, zp, zp), b_iI=(zp, zp, zp), pA_q=(zp, zp, zp, zp), pB_q=(zp, zp, zp, zp),
        pA_c=(zp, zp, zp), pB_c=(zp, zp, zp), vkB=(zp, zp, zp), b_dynf=zp,
        fidx_keys=torch.full((P, B), -1, dtype=torch.int32, device=dev),
    )


def _no_bodies(cmap, actors, dt):
    """A map without dynamic bodies: kinematic actors integrate their
    velocity and everything else passes through — what the JAX function
    computes when no dynamic slot is live (only the idle branch runs; the
    writeback keeps the first P pair slots and pads the rest with (0, -1),
    P = min(P_CAP, D * N))."""
    kinematic = actors.active & (cmap.motion == int(Motion.KINEMATIC))[None, :]
    k_pos = actors.pos + torch.where(kinematic[..., None], actors.vel * dt, 0.0)
    p = min(P_CAP, cmap.dyn_slots.shape[0] * cmap.num_actors)
    warm_pair = actors.warm_pair.clone()
    warm_pair_idx = actors.warm_pair_idx.clone()
    if p < PAIR_WARM_CAP:
        warm_pair[:, p:] = 0.0
        warm_pair_idx[:, p:] = -1
    return (k_pos, actors.quat, actors.vel, actors.omega, actors.sleep,
            actors.warm_n, warm_pair, warm_pair_idx)


def step_bodies_batched(cmap, actors, player_pos, player_vel, dt, n_substeps: int = 2):
    """Batched rigid-body update. actors leaves [B, N, ...]; player [B, 3].

    Returns (pos, quat, vel, omega, sleep, warm_n, warm_pair,
    warm_pair_idx) like the JAX function."""
    if cmap.aux.get("num_dynamic", 1) == 0:
        return _no_bodies(cmap, actors, dt)
    B, n = actors.pos.shape[0], cmap.num_actors
    dev = actors.pos.device
    sl = cmap.dyn_slots
    D = sl.shape[0]
    slc = torch.clamp(sl, 0, n - 1).long()
    d_on = (sl >= 0)[None, :] & actors.active[:, slc]  # [B, D]
    d_on_t = d_on.T  # [D, B]
    kinematic = actors.active & (cmap.motion == int(Motion.KINEMATIC))[None, :]
    solid_full = solid_mask(cmap, actors.active)  # [B, N]
    h = dt / n_substeps
    arange_n = torch.arange(n, device=dev)

    gcomp = lambda a, k: a[:, slc, k].T  # [B, N, C] -> [D, B]
    dpx, dpy, dpz = (gcomp(actors.pos, k) for k in range(3))
    dqx, dqy, dqz, dqw = (gcomp(actors.quat, k) for k in range(4))
    dvx, dvy, dvz = (gcomp(actors.vel, k) for k in range(3))
    dwx, dwy, dwz = (gcomp(actors.omega, k) for k in range(3))
    d_inv_m = cmap.inv_mass[slc][:, None]  # [D, 1]
    iIx, iIy, iIz = (cmap.inv_inertia[slc, k][:, None] for k in range(3))
    dhx, dhy, dhz = (cmap.halfext[slc, k][:, None] for k in range(3))
    dcx, dcy, dcz = (cmap.shape_center[slc, k][:, None] for k in range(3))
    d_mu = torch.sqrt(cmap.friction[slc] * MAP_FRICTION)[:, None]
    # support clouds (None on all-box maps keeps the closed-form support)
    hulls = not cmap.aux["hulls_are_boxes"]
    d_verts = cmap.hull_verts[slc] if hulls else None
    d_is_box = cmap.dyn_is_box if hulls else None

    # kinematic motion on full lanes
    k_pos = actors.pos + torch.where(kinematic[..., None], actors.vel * dt, 0.0)

    # other-actor tables for pair contacts, [N, B] (kinematics at their
    # end-of-tick pose)
    o_pos = torch.where(kinematic[..., None], k_pos, actors.pos)
    oqx, oqy, oqz, oqw = (actors.quat[..., k].T for k in range(4))
    oscx, oscy, oscz = (cmap.shape_center[:, k][:, None] for k in range(3))
    rx, ry, rz = g.quat_rotate_soa(oqx, oqy, oqz, oqw, oscx, oscy, oscz)
    o_cx = rx + o_pos[..., 0].T
    o_cy = ry + o_pos[..., 1].T
    o_cz = rz + o_pos[..., 2].T
    ohx, ohy, ohz = (cmap.halfext[:, k][:, None] for k in range(3))
    o_solid = solid_full.T
    o_inv_m = torch.where(
        (cmap.motion == int(Motion.DYNAMIC))[None, :] & actors.active, cmap.inv_mass[None, :], 0.0
    ).T  # [N, B]
    ovx, ovy, ovz = (actors.vel[..., k].T for k in range(3))
    a2d = cmap.actor_to_dyn
    ppx, ppy, ppz = player_pos[:, 0], player_pos[:, 1], player_pos[:, 2]
    pvx, pvy, pvz = player_vel[:, 0], player_vel[:, 1], player_vel[:, 2]

    # ---- persistent pair normals and support radii at the pre-integration
    # poses (batched.py:551-601)
    ccx0, ccy0, ccz0 = g.quat_rotate_soa(dqx, dqy, dqz, dqw, dcx, dcy, dcz)
    ccx0, ccy0, ccz0 = ccx0 + dpx, ccy0 + dpy, ccz0 + dpz
    e3g = lambda a: a[:, None, :]  # [D, B] -> [D, 1, B]
    og = lambda a: a[None, :, :]  # [N, B] -> [1, N, B]
    pvx0 = e3g(ccx0) - og(o_cx)
    pvy0 = e3g(ccy0) - og(o_cy)
    pvz0 = e3g(ccz0) - og(o_cz)
    pnx, pny, pnz, pdist0 = g.normalize3(pvx0, pvy0, pvz0)
    r_i0 = g.box_support_soa(
        e3g(dqx), e3g(dqy), e3g(dqz), e3g(dqw),
        e3g(dhx.expand(D, B)), e3g(dhy.expand(D, B)), e3g(dhz.expand(D, B)), pnx, pny, pnz,
    )
    r_j0 = g.box_support_soa(
        og(oqx), og(oqy), og(oqz), og(oqw),
        og(ohx.expand(n, B)), og(ohy.expand(n, B)), og(ohz.expand(n, B)), -pnx, -pny, -pnz,
    )
    p_rsum = 0.8 * (r_i0 + r_j0)
    not_self = (sl[:, None] != arange_n[None, :])[:, :, None]
    pair_ok0 = e3g(d_on_t) & og(o_solid) & not_self
    pair_bp = pair_ok0 & ((r_i0 + r_j0) - pdist0 > -PAIR_CAND_SLACK)
    # mirrored dyn-dyn pairs collapse to one slot (solved bilaterally)
    keep_pair = (~(a2d >= 0))[None, :] | (sl[:, None] < arange_n[None, :])
    P = min(P_CAP, D * n)

    # ---- island-synchronized sleep and the wake tests (batched.py:603-662)
    sleep_d = actors.sleep[:, slc].T  # [D, B]
    d2n = ((sl[:, None] == arange_n[None, :]) & (sl >= 0)[:, None]).float()  # [D, N]
    touch = pair_ok0 & ((r_i0 + r_j0) - pdist0 > -0.05)  # [D, N, B]
    bigc = 1e6
    cnt_n = torch.where(o_inv_m > 0.0, actors.sleep.T.float(), bigc)
    cnt_d = sleep_d.float()
    has_lane = (a2d >= 0)[:, None]  # [N, 1]
    for _hop in range(4):
        pmin = torch.amin(torch.where(touch, cnt_n[None, :, :], bigc), dim=1)
        cnt_d = torch.minimum(cnt_d, pmin)
        scat = torch.einsum("db,dn->nb", cnt_d, d2n)
        cnt_n = torch.where(has_lane, torch.minimum(cnt_n, scat), cnt_n)
    asleep0 = cnt_d >= SLEEP_AFTER
    self_moving = dvx * dvx + dvy * dvy + dvz * dvz > SLEEP_SPEED2
    near0 = pair_ok0 & (p_rsum - pdist0 > -0.05)
    o_speed2 = ovx * ovx + ovy * ovy + ovz * ovz  # [N, B]
    wake_pair = torch.any(near0 & og(o_speed2 > SLEEP_SPEED2), dim=1)  # [D, B]
    # player proximity at the pre-integration pose
    sy0w = ppy - CAPSULE_HALF_HEIGHT
    sy1w = ppy + CAPSULE_HALF_HEIGHT
    qpx0, qpy0, qpz0 = g.closest_point_on_vseg_soa(ccx0, ccy0, ccz0, ppx[None], sy0w[None], sy1w[None], ppz[None])
    pnxw, pnyw, pnzw, pdw = g.normalize3(ccx0 - qpx0, ccy0 - qpy0, ccz0 - qpz0)
    rsw = _support_toward(dqx, dqy, dqz, dqw, dhx, dhy, dhz, pnxw, pnyw, pnzw, verts=d_verts, is_box=d_is_box)
    p_speed2 = torch.sum(player_vel * player_vel, -1)[None]  # [1, B]
    wake_player = (0.9 * rsw + CAPSULE_RADIUS - pdw > -0.05) & (p_speed2 > SLEEP_SPEED2)
    awake = d_on_t & (~asleep0 | self_moving | wake_pair | wake_player)
    awake_nb = torch.einsum("db,dn->nb", awake.float(), d2n) > 0.5  # [N, B]

    # stored warm-start cache in solver layouts: [D, B] and [PAIR_WARM_CAP, B]
    wt_st = actors.warm_n[:, slc].T * (sl >= 0).float()[:, None]
    wvals_st = actors.warm_pair.T
    wkeys_st = actors.warm_pair_idx.T

    carry0 = (dpx, dpy, dpz, dqx, dqy, dqz, dqw, dvx, dvy, dvz, dwx, dwy, dwz)

    def active():
        # batch-global pair-activity gate (batched.py:955); pair_env [B] is
        # each env's own pair activity
        pair_env = torch.any(pair_bp & (awake[:, None, :] | awake_nb[None, :, :]), dim=1).any(0)
        pair_any = gates.read(pair_env.any())
        tables = dict(
            n=n, D=D, B=B, P=P, dev=dev, slc=slc, pair_bp=pair_bp, keep_pair=keep_pair,
            o_c=(o_cx, o_cy, o_cz), o_q=(oqx, oqy, oqz, oqw), o_v=(ovx, ovy, ovz), o_inv_m=o_inv_m,
            cc0=(ccx0, ccy0, ccz0), dq0=(dqx, dqy, dqz, dqw),
        )
        pr = gates.gate(pair_any, lambda: _pair_gen(cmap, tables), lambda: _pair_zero(D, B, P, dev))
        body = dict(
            D=D, B=B, P=P, h=h, n_substeps=n_substeps, awake=awake, pair_any=pair_any, pair_env=pair_env,
            d_inv_m=d_inv_m, iI=(iIx, iIy, iIz), dh=(dhx, dhy, dhz), dc=(dcx, dcy, dcz), d_mu=d_mu,
            d_verts=d_verts, d_is_box=d_is_box, cc0=(ccx0, ccy0, ccz0), player=(ppx, ppy, ppz, pvx, pvy, pvz),
            d_on_t=d_on_t, pair_bp=pair_bp, pny=pny,
        )
        return _bodies_active(cmap, body, pr, carry0, wt_st, wvals_st, wkeys_st)

    # nothing awake: poses frozen, warm cache passes through untouched
    idle = lambda: (*carry0, wt_st, wvals_st[:P], wkeys_st[:P])
    # ---- batch-global body-activity gate (batched.py:1764)
    carry = gates.gate(gates.read(awake.any()), active, idle)
    (dpx, dpy, dpz, dqx, dqy, dqz, dqw, dvx, dvy, dvz, dwx, dwy, dwz, wt_ret, wp_ret, wkeys_ret) = carry

    # sleep counter: consecutive ticks with point speed under threshold
    diag2 = dhx * dhx + dhy * dhy + dhz * dhz  # [D, 1]
    final_speed2 = dvx * dvx + dvy * dvy + dvz * dvz + (dwx * dwx + dwy * dwy + dwz * dwz) * diag2
    slow = final_speed2 <= SLEEP_SPEED2
    sleep_new = torch.where(d_on_t & slow, torch.clamp_max(sleep_d + 1, SLEEP_AFTER), 0).int()

    # write dynamic lanes back ([D, B] -> [B, N, .]) through the one-hot d2n
    expand = lambda comps: torch.einsum("cdb,dn->bnc", torch.stack(comps), d2n)
    live = torch.einsum("db,dn->bn", d_on_t.float(), d2n) > 0.5  # [B, N]
    m3 = live[..., None]
    pos = torch.where(m3, expand([dpx, dpy, dpz]), k_pos)
    quat = torch.where(m3, expand([dqx, dqy, dqz, dqw]), actors.quat)
    vel = torch.where(m3, expand([dvx, dvy, dvz]), actors.vel)
    omega = torch.where(m3, expand([dwx, dwy, dwz]), actors.omega)
    sleep_n = torch.einsum("db,dn->bn", sleep_new.float(), d2n).int()
    sleep = torch.where(live, sleep_n, actors.sleep)
    warm_n = torch.where(live, torch.einsum("db,dn->bn", wt_ret, d2n), actors.warm_n)
    pc_pad = actors.warm_pair.shape[1] - P
    if pc_pad:
        wp_ret = torch.cat([wp_ret, torch.zeros((pc_pad, B), device=dev)], 0)
        wkeys_ret = torch.cat([wkeys_ret, torch.full((pc_pad, B), -1, dtype=torch.int32, device=dev)], 0)
    return pos, quat, vel, omega, sleep, warm_n, wp_ret.T, wkeys_ret.T


def _body_table(cc0, dq, dh, awake, dv):
    """K3's [16, D, B'] body rows, B' = B padded with zero lanes to a
    multiple of 128 (batched.py:965-977)."""
    D, B = awake.shape
    pad = (-B) % PBLK
    rows = [*cc0, *dq, *(h.expand(D, B) for h in dh), awake.float(), *dv]
    body = torch.zeros((BODY_ROWS, D, B + pad), device=awake.device)
    body[: len(rows), :, :B] = torch.stack(rows)
    return body


def _bodies_active(cmap, w, pr, carry0, wt_st, wvals_st, wkeys_st):
    """The gated half of the step (batched.py:952-1755): warm-start match,
    K3 triangle manifold, the substeps, rest-bleed and the warm-cache
    writeback."""
    D, B, P, h = w["D"], w["B"], w["P"], w["h"]
    awake = w["awake"]
    pair_any = w["pair_any"]
    d_inv_m, d_mu = w["d_inv_m"], w["d_mu"]
    iIx, iIy, iIz = w["iI"]
    dhx, dhy, dhz = w["dh"]
    dcx, dcy, dcz = w["dc"]
    d_verts, d_is_box = w["d_verts"], w["d_is_box"]
    ccx0, ccy0, ccz0 = w["cc0"]
    ppx, ppy, ppz, pvx, pvy, pvz = w["player"]
    (dpx, dpy, dpz, dqx, dqy, dqz, dqw, dvx, dvy, dvz, dwx, dwy, dwz) = carry0

    pd0, pp_x, pp_y, pp_z, pcand_live = pr["pd0"], pr["pp_x"], pr["pp_y"], pr["pp_z"], pr["pcand_live"]
    pn2_x, pn2_y, pn2_z = pr["pn2_x"], pr["pn2_y"], pr["pn2_z"]
    ohA, ohB, a_mu_p, a_invm, b_invm = pr["ohA"], pr["ohB"], pr["a_mu_p"], pr["a_invm"], pr["b_invm"]
    a_iIx, a_iIy, a_iIz = pr["a_iI"]
    b_iIx, b_iIy, b_iIz = pr["b_iI"]
    pA_qx, pA_qy, pA_qz, pA_qw = pr["pA_q"]
    pB_qx, pB_qy, pB_qz, pB_qw = pr["pB_q"]
    pA_cx, pA_cy, pA_cz = pr["pA_c"]
    pB_cx, pB_cy, pB_cz = pr["pB_c"]
    vkBx, vkBy, vkBz = pr["vkB"]
    b_dynf, fidx_keys = pr["b_dynf"], pr["fidx_keys"]

    # warm-start lookup: re-key last tick's pair impulses onto this tick's
    # pair slots ([P, PC] key match per env)
    match_w = (fidx_keys[:, None, :] == wkeys_st[None, :, :]) & (fidx_keys[:, None, :] >= 0)
    wp0 = torch.sum(match_w.float() * wvals_st[None, :, :], dim=1)  # [P, B]

    # ---- triangle manifold: kernel K3 (batched.py:962-990)
    sl = cmap.dyn_slots
    slc = torch.clamp(sl, 0, cmap.num_actors - 1).long()
    body = _body_table((ccx0, ccy0, ccz0), (dqx, dqy, dqz, dqw), (dhx, dhy, dhz), awake, (dvx, dvy, dvz))
    # per-body chunk margin: the support diagonal + candidate slack
    margin_d = torch.sqrt(dhx * dhx + dhy * dhy + dhz * dhz)[:, 0] + 0.35
    outc = body_contacts(cmap.tri16, cmap.chunk_bounds, body, margin_d, cmap.hull_verts[slc],
                         cmap.dyn_is_box)[:, :, :B]
    gen_d, c_nx, c_ny, c_nz, c_px, c_py, c_pz = (outc[k].reshape(D, MANIFOLD_K, B) for k in range(7))
    # candidate set: contacts + near-contacts (catch mid-tick impacts)
    cand_live = gen_d > -0.3

    e2 = lambda a: a[:, None, :]  # [D, B] -> [D, 1, B]
    e4 = lambda a: a[:, None, :]  # [P, B] -> [P, 1, B]
    gAh = lambda a: torch.einsum("db,pdb->pb", a, ohA)
    gBh = lambda a: torch.einsum("db,pdb->pb", a, ohB)
    sAh = lambda a: torch.einsum("pb,pdb->db", a, ohA)
    sBh = lambda a: torch.einsum("pb,pdb->db", a, ohB)
    frame_a = (pA_qx, pA_qy, pA_qz, pA_qw, a_iIx, a_iIy, a_iIz)
    frame_b = (pB_qx, pB_qy, pB_qz, pB_qw, b_iIx, b_iIy, b_iIz)

    def rotA(tx, ty, tz, per_point=False):
        """A-side world I^-1 @ t; per_point: t is [P, K2, B]."""
        return _rot_inv_apply(*(e4(a) if per_point else a for a in frame_a), tx, ty, tz)

    def rotB(tx, ty, tz, per_point=False):
        return _rot_inv_apply(*(e4(a) if per_point else a for a in frame_b), tx, ty, tz)

    def substep(carry):
        (dpx, dpy, dpz, dqx, dqy, dqz, dqw, dvx, dvy, dvz, dwx, dwy, dwz, wt_c, wp_c) = carry
        on = awake  # sleeping lanes: frozen pose, no gravity or pushes
        # symplectic Euler: gravity -> velocity solve -> position integration
        dvy = torch.where(on, dvy + GRAVITY_Y * h, dvy)

        # ---- vs player [D, B], before the contact solver (MapPhysics.c order)
        ccx3, ccy3, ccz3 = g.quat_rotate_soa(dqx, dqy, dqz, dqw, dcx, dcy, dcz)
        ccx3, ccy3, ccz3 = ccx3 + dpx, ccy3 + dpy, ccz3 + dpz
        sy0 = ppy - CAPSULE_HALF_HEIGHT
        sy1 = ppy + CAPSULE_HALF_HEIGHT
        qpx, qpy, qpz = g.closest_point_on_vseg_soa(ccx3, ccy3, ccz3, ppx[None], sy0[None], sy1[None], ppz[None])
        pnx2, pny2, pnz2, pd = g.normalize3(ccx3 - qpx, ccy3 - qpy, ccz3 - qpz)
        rs = _support_toward(dqx, dqy, dqz, dqw, dhx, dhy, dhz, pnx2, pny2, pnz2, verts=d_verts, is_box=d_is_box)
        cdepth = torch.where(on, 0.9 * rs + CAPSULE_RADIUS - pd, -torch.inf)
        inv_m_player = 1.0 / CHARACTER_MASS
        rel_v = (dvx - pvx[None]) * pnx2 + (dvy - pvy[None]) * pny2 + (dvz - pvz[None]) * pnz2
        jn = torch.where((cdepth > 0) & (rel_v < 0), -rel_v / (d_inv_m + inv_m_player + 1e-9), 0.0)
        dvx = dvx + pnx2 * jn * d_inv_m
        dvy = dvy + pny2 * jn * d_inv_m
        dvz = dvz + pnz2 * jn * d_inv_m
        pp = torch.clamp_min(cdepth - PENETRATION_SLOP, 0.0) * 0.5 * ((cdepth > PENETRATION_SLOP) & on)
        dpx = dpx + pnx2 * pp
        dpy = dpy + pny2 * pp
        dpz = dpz + pnz2 * pp

        # box centres
        ccx, ccy, ccz = g.quat_rotate_soa(dqx, dqy, dqz, dqw, dcx, dcy, dcz)
        ccx, ccy, ccz = ccx + dpx, ccy + dpy, ccz + dpz

        # ---- manifold depths at the live pose
        r_sup_k = _support_toward(
            e2(dqx), e2(dqy), e2(dqz), e2(dqw), e2(dhx), e2(dhy), e2(dhz), c_nx, c_ny, c_nz,
            verts=d_verts, is_box=d_is_box,
        )
        signed_k = (e2(ccx) - c_px) * c_nx + (e2(ccy) - c_py) * c_ny + (e2(ccz) - c_pz) * c_nz
        c_d = torch.where(cand_live & e2(on), r_sup_k - signed_k, -torch.inf)
        active = c_d > 0.0
        # centroid of the active manifold
        t_actf = active.float()
        t_nact = torch.clamp_min(torch.sum(t_actf, 1), 1.0)  # [D, B]
        t_any = torch.any(active, 1)
        tc_px = torch.sum(c_px * t_actf, 1) / t_nact
        tc_py = torch.sum(c_py * t_actf, 1) / t_nact
        tc_pz = torch.sum(c_pz * t_actf, 1) / t_nact
        tnx0 = torch.sum(c_nx * t_actf, 1)
        tny0 = torch.sum(c_ny * t_actf, 1)
        tnz0 = torch.sum(c_nz * t_actf, 1)
        tnx, tny, tnz, tnl = g.normalize3(tnx0, tny0, tnz0)
        coherent = t_any & (tnl > 0.5 * t_nact)  # skip mixed-normal wedges
        tnx = torch.where(coherent, tnx, 0.0)
        tny = torch.where(coherent, tny, 1.0)
        tnz = torch.where(coherent, tnz, 0.0)

        # ---- warm start, body vs world: last substep's centroid impulse
        wt_eff = torch.where(coherent & on, wt_c, 0.0)  # [D, B]
        iwx, iwy, iwz = tnx * wt_eff, tny * wt_eff, tnz * wt_eff
        dvx = dvx + iwx * d_inv_m
        dvy = dvy + iwy * d_inv_m
        dvz = dvz + iwz * d_inv_m
        tqwx, tqwy, tqwz = g.cross3(tc_px - ccx, tc_py - ccy, tc_pz - ccz, iwx, iwy, iwz)
        awx_, awy_, awz_ = _rot_inv_apply(dqx, dqy, dqz, dqw, iIx, iIy, iIz, tqwx, tqwy, tqwz)
        dwx, dwy, dwz = dwx + awx_, dwy + awy_, dwz + awz_

        def tri_centroid_pass(vo):
            dvx, dvy, dvz, dwx, dwy, dwz, acc = vo
            rx_ = tc_px - ccx
            ry_ = tc_py - ccy
            rz_ = tc_pz - ccz
            vptx = dvx + dwy * rz_ - dwz * ry_
            vpty = dvy + dwz * rx_ - dwx * rz_
            vptz = dvz + dwx * ry_ - dwy * rx_
            vn = vptx * tnx + vpty * tny + vptz * tnz
            rxn_x, rxn_y, rxn_z = g.cross3(rx_, ry_, rz_, tnx, tny, tnz)
            ia_x, ia_y, ia_z = _rot_inv_apply(dqx, dqy, dqz, dqw, iIx, iIy, iIz, rxn_x, rxn_y, rxn_z)
            ca_x, ca_y, ca_z = g.cross3(ia_x, ia_y, ia_z, rx_, ry_, rz_)
            k_n = d_inv_m + ca_x * tnx + ca_y * tny + ca_z * tnz
            jn_d = torch.where(coherent, -vn / torch.clamp_min(k_n, 1e-9), 0.0) * RELAX
            jn_tot = torch.clamp_min(acc["tc_n"] + jn_d, 0.0)
            jn = jn_tot - acc["tc_n"]
            ix_, iy_, iz_ = tnx * jn, tny * jn, tnz * jn
            # friction at the centroid
            vtx = vptx - tnx * vn
            vty = vpty - tny * vn
            vtz = vptz - tnz * vn
            tdx, tdy, tdz, vt_mag = g.normalize3(vtx, vty, vtz)
            rxt_x, rxt_y, rxt_z = g.cross3(rx_, ry_, rz_, tdx, tdy, tdz)
            ft_x, ft_y, ft_z = _rot_inv_apply(dqx, dqy, dqz, dqw, iIx, iIy, iIz, rxt_x, rxt_y, rxt_z)
            ct_x, ct_y, ct_z = g.cross3(ft_x, ft_y, ft_z, rx_, ry_, rz_)
            k_t = d_inv_m + ct_x * tdx + ct_y * tdy + ct_z * tdz
            # Coulomb clamp against the accumulated normal impulse
            jt = torch.where(
                coherent,
                _clip0(vt_mag / torch.clamp_min(k_t, 1e-9) * RELAX,
                       torch.clamp_min(d_mu * jn_tot - acc["tc_t"], 0.0)),
                0.0,
            )
            acc = dict(acc, tc_n=jn_tot, tc_t=acc["tc_t"] + jt)
            ix_, iy_, iz_ = ix_ - tdx * jt, iy_ - tdy * jt, iz_ - tdz * jt
            dvx = dvx + ix_ * d_inv_m
            dvy = dvy + iy_ * d_inv_m
            dvz = dvz + iz_ * d_inv_m
            tqx, tqy, tqz = g.cross3(rx_, ry_, rz_, ix_, iy_, iz_)
            wx_, wy_, wz_ = _rot_inv_apply(dqx, dqy, dqz, dqw, iIx, iIy, iIz, tqx, tqy, tqz)
            return dvx, dvy, dvz, dwx + wx_, dwy + wy_, dwz + wz_, acc

        eq = (e2(dqx), e2(dqy), e2(dqz), e2(dqw), e2(iIx), e2(iIy), e2(iIz))

        def solver_iter(vo):
            dvx, dvy, dvz, dwx, dwy, dwz, acc = vo
            rx_ = c_px - e2(ccx)
            ry_ = c_py - e2(ccy)
            rz_ = c_pz - e2(ccz)
            vptx = e2(dvx) + e2(dwy) * rz_ - e2(dwz) * ry_
            vpty = e2(dvy) + e2(dwz) * rx_ - e2(dwx) * rz_
            vptz = e2(dvz) + e2(dwx) * ry_ - e2(dwy) * rx_
            vn = g.dot3(vptx, vpty, vptz, c_nx, c_ny, c_nz)
            rxnx, rxny, rxnz = g.cross3(rx_, ry_, rz_, c_nx, c_ny, c_nz)
            ax_, ay_, az_ = _rot_inv_apply(*eq, rxnx, rxny, rxnz)
            axr_x, axr_y, axr_z = g.cross3(ax_, ay_, az_, rx_, ry_, rz_)
            k_n = d_inv_m[:, None, :] + g.dot3(axr_x, axr_y, axr_z, c_nx, c_ny, c_nz)
            jn_d = torch.where(active, -vn / torch.clamp_min(k_n, 1e-9), 0.0) * RELAX
            tp_n = torch.clamp_min(acc["tp_n"] + jn_d, 0.0)
            jn = tp_n - acc["tp_n"]
            impx, impy, impz = c_nx * jn, c_ny * jn, c_nz * jn
            dvx = dvx + torch.sum(impx, 1) * d_inv_m
            dvy = dvy + torch.sum(impy, 1) * d_inv_m
            dvz = dvz + torch.sum(impz, 1) * d_inv_m
            tqx, tqy, tqz = g.cross3(rx_, ry_, rz_, impx, impy, impz)
            wx_, wy_, wz_ = _rot_inv_apply(*eq, tqx, tqy, tqz)
            dwx = dwx + torch.sum(wx_, 1)
            dwy = dwy + torch.sum(wy_, 1)
            dwz = dwz + torch.sum(wz_, 1)

            # friction
            vptx = e2(dvx) + e2(dwy) * rz_ - e2(dwz) * ry_
            vpty = e2(dvy) + e2(dwz) * rx_ - e2(dwx) * rz_
            vptz = e2(dvz) + e2(dwx) * ry_ - e2(dwy) * rx_
            vn2 = g.dot3(vptx, vpty, vptz, c_nx, c_ny, c_nz)
            vtx = vptx - c_nx * vn2
            vty = vpty - c_ny * vn2
            vtz = vptz - c_nz * vn2
            tdx, tdy, tdz, vt_mag = g.normalize3(vtx, vty, vtz)
            rxtx, rxty, rxtz = g.cross3(rx_, ry_, rz_, tdx, tdy, tdz)
            at_x, at_y, at_z = _rot_inv_apply(*eq, rxtx, rxty, rxtz)
            atr_x, atr_y, atr_z = g.cross3(at_x, at_y, at_z, rx_, ry_, rz_)
            k_t = d_inv_m[:, None, :] + g.dot3(atr_x, atr_y, atr_z, tdx, tdy, tdz)
            jt = torch.where(
                active,
                _clip0(vt_mag / torch.clamp_min(k_t, 1e-9) * RELAX,
                       torch.clamp_min(d_mu[:, None, :] * tp_n - acc["tp_t"], 0.0)),
                0.0,
            )
            acc = dict(acc, tp_n=tp_n, tp_t=acc["tp_t"] + jt)
            fx, fy, fz = -tdx * jt, -tdy * jt, -tdz * jt
            dvx = dvx + torch.sum(fx, 1) * d_inv_m
            dvy = dvy + torch.sum(fy, 1) * d_inv_m
            dvz = dvz + torch.sum(fz, 1) * d_inv_m
            tqx, tqy, tqz = g.cross3(rx_, ry_, rz_, fx, fy, fz)
            wx_, wy_, wz_ = _rot_inv_apply(*eq, tqx, tqy, tqz)
            dwx = dwx + torch.sum(wx_, 1)
            dwy = dwy + torch.sum(wy_, 1)
            dwz = dwz + torch.sum(wz_, 1)
            return dvx, dvy, dvz, dwx, dwy, dwz, acc

        def tri_iter(vo):
            return solver_iter(tri_centroid_pass(vo))

        # positional push averaged over the manifold (one contact patch)
        over = torch.clamp_min(c_d - PENETRATION_SLOP, 0.0) * BAUMGARTE
        dpx = dpx + torch.sum(c_nx * over, 1) / t_nact
        dpy = dpy + torch.sum(c_ny * over, 1) / t_nact
        dpz = dpz + torch.sum(c_nz * over, 1) / t_nact

        # accumulated impulses of the Coulomb clamps; tc_n starts at the
        # warm-start impulse already applied
        tri_acc0 = {"tc_n": wt_eff, "tc_t": torch.zeros_like(tc_px),
                    "tp_n": torch.zeros_like(c_d), "tp_t": torch.zeros_like(c_d)}
        c0 = (dvx, dvy, dvz, dwx, dwy, dwz)

        def tri_only():
            # no live pair candidates this tick: the fused triangle solve
            c = c0 + (tri_acc0,)
            for _i in range(SOLVER_ITERS):
                c = tri_iter(c)
            zz = torch.zeros_like(dpx)
            return c[:6] + (zz, zz, zz, c[6]["tc_n"], wp_c)

        outs = gates.branch(
            pair_any,
            lambda: loop_with_pairs(c0, tri_iter, tri_acc0, dqx, dqy, dqz, dqw, dpx, dpy, dpz, wp_c),
            tri_only,
        )
        (dvx, dvy, dvz, dwx, dwy, dwz, pushdx, pushdy, pushdz, tc_n, wp_new) = outs
        wt_new = torch.where(coherent, tc_n, 0.0)
        # slew-rate-limited, EMA-smoothed cache update (batched.py:1669-1686)
        seed_t = (h * -GRAVITY_Y) / torch.clamp_min(d_inv_m, 1e-6)  # [D, 1]
        wt_new = torch.minimum(0.5 * (wt_new + wt_c), wt_c * 2.0 + seed_t)
        seed_p = (h * -GRAVITY_Y) / torch.clamp_min(a_invm, 1e-6)  # [P, B]
        wp_new = torch.minimum(0.5 * (wp_new + wp_c), wp_c * 2.0 + seed_p)
        # position integration with the post-solve velocities + the push
        dpx = torch.where(on, dpx + dvx * h + pushdx, dpx)
        dpy = torch.where(on, dpy + dvy * h + pushdy, dpy)
        dpz = torch.where(on, dpz + dvz * h + pushdz, dpz)
        # quaternion integration: q += 0.5*h*(omega_quat * q)
        nqx = dqx + 0.5 * h * (dwx * dqw + dwy * dqz - dwz * dqy)
        nqy = dqy + 0.5 * h * (-dwx * dqz + dwy * dqw + dwz * dqx)
        nqz = dqz + 0.5 * h * (dwx * dqy - dwy * dqx + dwz * dqw)
        nqw = dqw + 0.5 * h * (-dwx * dqx - dwy * dqy - dwz * dqz)
        qn = torch.clamp_min(torch.sqrt(nqx * nqx + nqy * nqy + nqz * nqz + nqw * nqw), 1e-12)
        dqx = torch.where(on, nqx / qn, dqx)
        dqy = torch.where(on, nqy / qn, dqy)
        dqz = torch.where(on, nqz / qn, dqz)
        dqw = torch.where(on, nqw / qn, dqw)
        return (dpx, dpy, dpz, dqx, dqy, dqz, dqw, dvx, dvy, dvz, dwx, dwy, dwz, wt_new, wp_new)

    def loop_with_pairs(c, tri_iter, tri_acc0, dqx, dqy, dqz, dqw, dpx, dpy, dpz, wp_c):
        """Triangle + pair sweeps on the compacted [P, K2, B] pair manifolds
        (batched.py:1319-1660)."""
        ccx2, ccy2, ccz2 = g.quat_rotate_soa(dqx, dqy, dqz, dqw, dcx, dcy, dcz)
        ccx2, ccy2, ccz2 = ccx2 + dpx, ccy2 + dpy, ccz2 + dpz
        cA_tx, cA_ty, cA_tz = gAh(ccx2), gAh(ccy2), gAh(ccz2)
        nb_f = 1.0 - b_dynf
        cB_tx = gBh(ccx2) + pB_cx * nb_f
        cB_ty = gBh(ccy2) + pB_cy * nb_f
        cB_tz = gBh(ccz2) + pB_cz * nb_f
        shift_p = (
            (cA_tx - pA_cx - (cB_tx - pB_cx)) * pn2_x
            + (cA_ty - pA_cy - (cB_ty - pB_cy)) * pn2_y
            + (cA_tz - pA_cz - (cB_tz - pB_cz)) * pn2_z
        )
        pd_k = pd0 - shift_p[:, None, :]
        pact = pcand_live & (pd_k > 0.0)
        rAx = pp_x - e4(cA_tx)
        rAy = pp_y - e4(cA_ty)
        rAz = pp_z - e4(cA_tz)
        rBx = pp_x - e4(cB_tx)
        rBy = pp_y - e4(cB_ty)
        rBz = pp_z - e4(cB_tz)
        nkx, nky, nkz = e4(pn2_x), e4(pn2_y), e4(pn2_z)
        # normal effective mass (constant over iterations)
        rxnAx, rxnAy, rxnAz = g.cross3(rAx, rAy, rAz, nkx, nky, nkz)
        iAx, iAy, iAz = rotA(rxnAx, rxnAy, rxnAz, True)
        cAx_, cAy_, cAz_ = g.cross3(iAx, iAy, iAz, rAx, rAy, rAz)
        kA_n = g.dot3(cAx_, cAy_, cAz_, nkx, nky, nkz)
        rxnBx, rxnBy, rxnBz = g.cross3(rBx, rBy, rBz, nkx, nky, nkz)
        iBx, iBy, iBz = rotB(rxnBx, rxnBy, rxnBz, True)
        cBx_, cBy_, cBz_ = g.cross3(iBx, iBy, iBz, rBx, rBy, rBz)
        kB_n = g.dot3(cBx_, cBy_, cBz_, nkx, nky, nkz)
        k_pair = e4(a_invm + b_invm) + kA_n + kB_n

        n_act = torch.clamp_min(torch.sum(pact, dim=1, keepdim=True).float(), 1.0)
        actf = pact.float()
        # manifold centroid pre-pass (central effective mass)
        anyact = torch.any(pact, dim=1)  # [P, B]
        cen_x = torch.sum(pp_x * actf, 1) / n_act[:, 0, :]
        cen_y = torch.sum(pp_y * actf, 1) / n_act[:, 0, :]
        cen_z = torch.sum(pp_z * actf, 1) / n_act[:, 0, :]

        # ---- warm start, pair contacts (both dynamic sides awake)
        aw_f = awake.float()
        awA = gAh(aw_f) > 0.5
        awB = gBh(aw_f) > 0.5
        paw = awA & (awB | (b_dynf < 0.5))
        wp_eff = torch.where(anyact & paw, wp_c, 0.0)  # [P, B]
        dvx_w, dvy_w, dvz_w, dwx_w, dwy_w, dwz_w = c
        pwx = pn2_x * wp_eff
        pwy = pn2_y * wp_eff
        pwz = pn2_z * wp_eff
        dvx_w = dvx_w + sAh(pwx * a_invm)
        dvy_w = dvy_w + sAh(pwy * a_invm)
        dvz_w = dvz_w + sAh(pwz * a_invm)
        tqwx, tqwy, tqwz = g.cross3(cen_x - cA_tx, cen_y - cA_ty, cen_z - cA_tz, pwx, pwy, pwz)
        awx_, awy_, awz_ = rotA(tqwx, tqwy, tqwz)
        dwx_w = dwx_w + sAh(awx_)
        dwy_w = dwy_w + sAh(awy_)
        dwz_w = dwz_w + sAh(awz_)
        dvx_w = dvx_w - sBh(pwx * b_invm)
        dvy_w = dvy_w - sBh(pwy * b_invm)
        dvz_w = dvz_w - sBh(pwz * b_invm)
        tqwx, tqwy, tqwz = g.cross3(cen_x - cB_tx, cen_y - cB_ty, cen_z - cB_tz, -pwx, -pwy, -pwz)
        bwx_, bwy_, bwz_ = rotB(tqwx, tqwy, tqwz)
        dwx_w = dwx_w + sBh(bwx_)
        dwy_w = dwy_w + sBh(bwy_)
        dwz_w = dwz_w + sBh(bwz_)
        c = (dvx_w, dvy_w, dvz_w, dwx_w, dwy_w, dwz_w)

        def solve_point(st_, acc, rax, ray, raz, rbx, rby, rbz, act_k):
            vAx, vAy, vAz, wAx, wAy, wAz, vBx, vBy, vBz, wBx, wBy, wBz = st_

            def rel_at(st_):
                vAx, vAy, vAz, wAx, wAy, wAz, vBx, vBy, vBz, wBx, wBy, wBz = st_
                relx = vAx + wAy * raz - wAz * ray - (vBx + wBy * rbz - wBz * rby)
                rely = vAy + wAz * rax - wAx * raz - (vBy + wBz * rbx - wBx * rbz)
                relz = vAz + wAx * ray - wAy * rax - (vBz + wBx * rby - wBy * rbx)
                return relx, rely, relz

            def keff(dx_, dy_, dz_):
                rxk, ryk, rzk = g.cross3(rax, ray, raz, dx_, dy_, dz_)
                fx_, fy_, fz_ = rotA(rxk, ryk, rzk)
                fx_, fy_, fz_ = g.cross3(fx_, fy_, fz_, rax, ray, raz)
                k_ = a_invm + b_invm + fx_ * dx_ + fy_ * dy_ + fz_ * dz_
                rxk, ryk, rzk = g.cross3(rbx, rby, rbz, dx_, dy_, dz_)
                fx_, fy_, fz_ = rotB(rxk, ryk, rzk)
                fx_, fy_, fz_ = g.cross3(fx_, fy_, fz_, rbx, rby, rbz)
                return k_ + fx_ * dx_ + fy_ * dy_ + fz_ * dz_

            def apply_(st_, ix_, iy_, iz_):
                vAx, vAy, vAz, wAx, wAy, wAz, vBx, vBy, vBz, wBx, wBy, wBz = st_
                vAx, vAy, vAz = vAx + ix_ * a_invm, vAy + iy_ * a_invm, vAz + iz_ * a_invm
                tqx, tqy, tqz = g.cross3(rax, ray, raz, ix_, iy_, iz_)
                ax_, ay_, az_ = rotA(tqx, tqy, tqz)
                wAx, wAy, wAz = wAx + ax_, wAy + ay_, wAz + az_
                vBx, vBy, vBz = vBx - ix_ * b_invm, vBy - iy_ * b_invm, vBz - iz_ * b_invm
                tqx, tqy, tqz = g.cross3(rbx, rby, rbz, -ix_, -iy_, -iz_)
                bx_, by_, bz_ = rotB(tqx, tqy, tqz)
                return [vAx, vAy, vAz, wAx, wAy, wAz, vBx, vBy, vBz, wBx + bx_, wBy + by_, wBz + bz_]

            relx, rely, relz = rel_at(st_)
            vn = relx * pn2_x + rely * pn2_y + relz * pn2_z
            k_n = keff(pn2_x, pn2_y, pn2_z)
            jn_d = torch.where(act_k, -vn / torch.clamp_min(k_n, 1e-9), 0.0) * RELAX
            pc_n = torch.clamp_min(acc["pc_n"] + jn_d, 0.0)
            jn = pc_n - acc["pc_n"]
            st_ = apply_(st_, pn2_x * jn, pn2_y * jn, pn2_z * jn)
            relx, rely, relz = rel_at(st_)
            vn2 = relx * pn2_x + rely * pn2_y + relz * pn2_z
            vtx = relx - pn2_x * vn2
            vty = rely - pn2_y * vn2
            vtz = relz - pn2_z * vn2
            tdx, tdy, tdz, vt_mag = g.normalize3(vtx, vty, vtz)
            k_t = keff(tdx, tdy, tdz)
            jt = torch.where(
                act_k,
                _clip0(vt_mag / torch.clamp_min(k_t, 1e-9) * RELAX,
                       torch.clamp_min(a_mu_p * pc_n - acc["pc_t"], 0.0)),
                0.0,
            )
            st_ = apply_(st_, -tdx * jt, -tdy * jt, -tdz * jt)
            return st_, dict(acc, pc_n=pc_n, pc_t=acc["pc_t"] + jt)

        def pair_iter(carry):
            dvx, dvy, dvz, dwx, dwy, dwz, acc = carry
            vAx0, vAy0, vAz0 = gAh(dvx), gAh(dvy), gAh(dvz)
            wAx0, wAy0, wAz0 = gAh(dwx), gAh(dwy), gAh(dwz)
            vBx0 = gBh(dvx) + vkBx
            vBy0 = gBh(dvy) + vkBy
            vBz0 = gBh(dvz) + vkBz
            wBx0, wBy0, wBz0 = gBh(dwx), gBh(dwy), gBh(dwz)
            st_ = [vAx0, vAy0, vAz0, wAx0, wAy0, wAz0, vBx0, vBy0, vBz0, wBx0, wBy0, wBz0]
            # centroid pre-pass (bulk of the normal impulse, central mass)
            st_, acc = solve_point(
                st_, acc,
                cen_x - cA_tx, cen_y - cA_ty, cen_z - cA_tz,
                cen_x - cB_tx, cen_y - cB_ty, cen_z - cB_tz,
                anyact,
            )
            # per-point Jacobi from the post-centroid state
            vAx, vAy, vAz, wAx, wAy, wAz, vBx, vBy, vBz, wBx, wBy, wBz = st_
            relx = e4(vAx) + e4(wAy) * rAz - e4(wAz) * rAy - (e4(vBx) + e4(wBy) * rBz - e4(wBz) * rBy)
            rely = e4(vAy) + e4(wAz) * rAx - e4(wAx) * rAz - (e4(vBy) + e4(wBz) * rBx - e4(wBx) * rBz)
            relz = e4(vAz) + e4(wAx) * rAy - e4(wAy) * rAx - (e4(vBz) + e4(wBx) * rBy - e4(wBy) * rBx)
            vn = relx * nkx + rely * nky + relz * nkz
            jn_d = torch.where(pact, -vn / torch.clamp_min(k_pair, 1e-9), 0.0) * RELAX
            pp_n = torch.clamp_min(acc["pp_n"] + jn_d, 0.0)
            jn = pp_n - acc["pp_n"]
            ix_, iy_, iz_ = nkx * jn, nky * jn, nkz * jn
            # friction per point against the pre-impulse tangential motion
            vtx = relx - nkx * vn
            vty = rely - nky * vn
            vtz = relz - nkz * vn
            tdx, tdy, tdz, vt_mag = g.normalize3(vtx, vty, vtz)
            rxk, ryk, rzk = g.cross3(rAx, rAy, rAz, tdx, tdy, tdz)
            fx_, fy_, fz_ = rotA(rxk, ryk, rzk, True)
            fx_, fy_, fz_ = g.cross3(fx_, fy_, fz_, rAx, rAy, rAz)
            k_t = e4(a_invm + b_invm) + fx_ * tdx + fy_ * tdy + fz_ * tdz
            rxk, ryk, rzk = g.cross3(rBx, rBy, rBz, tdx, tdy, tdz)
            fx_, fy_, fz_ = rotB(rxk, ryk, rzk, True)
            fx_, fy_, fz_ = g.cross3(fx_, fy_, fz_, rBx, rBy, rBz)
            k_t = k_t + fx_ * tdx + fy_ * tdy + fz_ * tdz
            jt = torch.where(
                pact,
                _clip0(vt_mag / torch.clamp_min(k_t, 1e-9) * RELAX,
                       torch.clamp_min(e4(a_mu_p) * pp_n - acc["pp_t"], 0.0)),
                0.0,
            )
            acc = dict(acc, pp_n=pp_n, pp_t=acc["pp_t"] + jt)
            ix_, iy_, iz_ = ix_ - tdx * jt, iy_ - tdy * jt, iz_ - tdz * jt
            # the summed point impulses on the pair-local state
            sx_, sy_, sz_ = torch.sum(ix_, 1), torch.sum(iy_, 1), torch.sum(iz_, 1)
            vAx, vAy, vAz = vAx + sx_ * a_invm, vAy + sy_ * a_invm, vAz + sz_ * a_invm
            tqx, tqy, tqz = g.cross3(rAx, rAy, rAz, ix_, iy_, iz_)
            ax_, ay_, az_ = rotA(tqx, tqy, tqz, True)
            wAx = wAx + torch.sum(ax_, 1)
            wAy = wAy + torch.sum(ay_, 1)
            wAz = wAz + torch.sum(az_, 1)
            vBx, vBy, vBz = vBx - sx_ * b_invm, vBy - sy_ * b_invm, vBz - sz_ * b_invm
            tqx, tqy, tqz = g.cross3(rBx, rBy, rBz, -ix_, -iy_, -iz_)
            bx_, by_, bz_ = rotB(tqx, tqy, tqz, True)
            wBx = wBx + torch.sum(bx_, 1)
            wBy = wBy + torch.sum(by_, 1)
            wBz = wBz + torch.sum(bz_, 1)

            dvx = dvx + sAh(vAx - vAx0)
            dvy = dvy + sAh(vAy - vAy0)
            dvz = dvz + sAh(vAz - vAz0)
            dwx = dwx + sAh(wAx - wAx0)
            dwy = dwy + sAh(wAy - wAy0)
            dwz = dwz + sAh(wAz - wAz0)
            dvx = dvx + sBh(vBx - vBx0)
            dvy = dvy + sBh(vBy - vBy0)
            dvz = dvz + sBh(vBz - vBz0)
            dwx = dwx + sBh(wBx - wBx0)
            dwy = dwy + sBh(wBy - wBy0)
            dwz = dwz + sBh(wBz - wBz0)
            return dvx, dvy, dvz, dwx, dwy, dwz, acc

        vo = c + (dict(tri_acc0, pc_n=wp_eff, pc_t=torch.zeros_like(cen_x),
                       pp_n=torch.zeros_like(pd0), pp_t=torch.zeros_like(pd0)),)
        for _i in range(SOLVER_ITERS):
            vo = pair_iter(tri_iter(vo))
        dvx, dvy, dvz, dwx, dwy, dwz, acc_f = vo
        # positional correction split by inverse mass, averaged over the
        # active manifold points
        over_p = torch.where(pact, torch.clamp_min(pd_k - PENETRATION_SLOP, 0.0) * BAUMGARTE, 0.0)
        wsum_p = torch.clamp_min(a_invm + b_invm, 1e-9)
        pux = torch.sum(nkx * over_p, 1) / n_act[:, 0, :]  # [P, B]
        puy = torch.sum(nky * over_p, 1) / n_act[:, 0, :]
        puz = torch.sum(nkz * over_p, 1) / n_act[:, 0, :]
        shareA = a_invm / wsum_p
        shareB = b_invm / wsum_p
        pushdx = sAh(pux * shareA) - sBh(pux * shareB)
        pushdy = sAh(puy * shareA) - sBh(puy * shareB)
        pushdz = sAh(puz * shareA) - sBh(puz * shareB)
        wp_o = torch.where(anyact, acc_f["pc_n"], 0.0)
        return (dvx, dvy, dvz, dwx, dwy, dwz, pushdx, pushdy, pushdz, acc_f["tc_n"], wp_o)

    carry = (dpx, dpy, dpz, dqx, dqy, dqz, dqw, dvx, dvy, dvz, dwx, dwy, dwz, wt_st, wp0)
    for _s in range(w["n_substeps"]):
        carry = substep(carry)

    # ---- rest-bleed damping for slow bodies on a near-horizontal support
    (dpx, dpy, dpz, dqx, dqy, dqz, dqw, dvx, dvy, dvz, dwx, dwy, dwz, wt_fin, wp_fin) = carry
    flat_tri = torch.any((gen_d > -0.05) & (c_ny > 0.95), dim=1)  # [D, B]
    flat_pair = torch.any(w["pair_bp"] & (w["pny"] > 0.95), dim=1)
    diag2a = dhx * dhx + dhy * dhy + dhz * dhz
    spd2 = dvx * dvx + dvy * dvy + dvz * dvz + (dwx * dwx + dwy * dwy + dwz * dwz) * diag2a
    bleed = w["d_on_t"] & (flat_tri | flat_pair) & (spd2 <= 9.0 * SLEEP_SPEED2)
    damp = torch.where(bleed, REST_BLEED, 1.0)
    dvx, dvy, dvz = dvx * damp, dvy * damp, dvz * damp
    dwx, dwy, dwz = dwx * damp, dwy * damp, dwz * damp

    # warm-cache writeback: sleeping lanes and pairs keep their stored
    # values; ticks with no live pair activity keep the stored keys
    wt_act = torch.where(awake, wt_fin, wt_st)
    aw_f2 = awake.float()
    paw2 = (torch.einsum("db,pdb->pb", aw_f2, ohA) + torch.einsum("db,pdb->pb", aw_f2, ohB)) > 0.5
    # an env without live pair activity keeps its stored keys and values,
    # as the closed gate does: the batch-global gate of the JAX package
    # (batched.py:1752-1753) re-keys them when another env of the batch is
    # active, so an env's cache would depend on its neighbours in the batch
    # and a shard of the batch would step differently from the whole
    pair_env = w["pair_env"]
    wp_act = torch.where(pair_env, torch.where(paw2, wp_fin, wp0), wvals_st[:P])
    keys_act = torch.where(pair_env, fidx_keys, wkeys_st[:P])
    return (dpx, dpy, dpz, dqx, dqy, dqz, dqw, dvx, dvy, dvz, dwx, dwy, dwz, wt_act, wp_act, keys_act)
