"""Kernel K3: top-K support contacts of the dynamic bodies against the static
triangle soup (counterpart of
c_game_engine_tpu/ops/body_contacts.py::body_contacts_pallas).

Per (env lane, dynamic body): over the triangles of the body's compacted
chunk list for the lane's 128-lane block (ops/chunk_compact.py, with the
body's own margin around the block's XZ box of awake lanes), the contact
normal from the closest point on the triangle to the body centre, the
body's support radius along it (closed-form box, or the max over the
body's vertex cloud for hull bodies), the depth, and the active-edge
normal fix. The K=4 deepest contacts are kept as the TPU kernel keeps
them: each 32-triangle chunk's top 4 (an earlier row wins a tie), then
bubbled into a running top 4 with a strict `>` at every slot.

Output [8, D*K, B]: depth, nx, ny, nz, px, py, pz, pad (0). A lane whose
body is off (`on` row 0: asleep, absent or padding) keeps the initial
buffer: depth -1e30, normal (0, 1, 0), point 0.

In this reference `body_contacts` always runs `_contacts_plain`, the plain
PyTorch version of the port's kernel, on any device: it launches no
kernel and counts nothing.
"""

from __future__ import annotations

import functools

import torch

from refsim.ops.capsule_resolve import T_CHUNK, _qrot
from refsim.ops.chunk_compact import (
    block_minmax,
    compact_chunk_lists,
    gather_listed_chunks,
)
from refsim.physics import geometry_soa as g

BLK = 128
K = 4
# barycentric weight below which the closest point counts as lying ON the
# corresponding edge (weights sum to 1, so this is a relative tolerance)
EDGE_EPS = 1e-3
# rows of the [16, D, B] body table
BODY_ROWS = 16
_NEG_BIG = -1e30


def _feature_active(qtx, qty, qtz, ax, ay, az, bx, by, bz, cx, cy, cz, f_ab, f_bc, f_ca):
    """True where the closest point qt on triangle ABC sits on the interior
    or on an ACTIVE edge or vertex (compiler/edges.py flags). Barycentric
    classification: w ~ 0 is edge AB, u ~ 0 edge BC, v ~ 0 edge CA; a vertex
    is two edges at once and is active iff either incident edge is."""
    v0x, v0y, v0z = bx - ax, by - ay, bz - az
    v1x, v1y, v1z = cx - ax, cy - ay, cz - az
    v2x, v2y, v2z = qtx - ax, qty - ay, qtz - az
    d00 = v0x * v0x + v0y * v0y + v0z * v0z
    d01 = v0x * v1x + v0y * v1y + v0z * v1z
    d11 = v1x * v1x + v1y * v1y + v1z * v1z
    d20 = v2x * v0x + v2y * v0y + v2z * v0z
    d21 = v2x * v1x + v2y * v1y + v2z * v1z
    den = d00 * d11 - d01 * d01
    inv_den = 1.0 / torch.where(torch.abs(den) > 1e-12, den, 1e-12)
    v = (d11 * d20 - d01 * d21) * inv_den
    w = (d00 * d21 - d01 * d20) * inv_den
    u = 1.0 - v - w
    on_ab = w < EDGE_EPS
    on_bc = u < EDGE_EPS
    on_ca = v < EDGE_EPS
    interior = ~(on_ab | on_bc | on_ca)
    return interior | (on_ab & (f_ab > 0.5)) | (on_bc & (f_bc > 0.5)) | (on_ca & (f_ca > 0.5))


def chunk_lists(chunk_bounds, body11, margin):
    """Per-(body, 128-lane block) chunk lists around the block's awake body
    centres: (idx [D, G, NC], cnt [D, G])."""
    on = body11[10] > 0.5  # [D, B]
    xmin, xmax = block_minmax(body11[0], BLK, mask=on)
    zmin, zmax = block_minmax(body11[2], BLK, mask=on)
    return compact_chunk_lists(chunk_bounds, xmin, xmax, zmin, zmax, margin)


def _check(tri16, chunk_bounds, body11, margin, verts, is_box):
    if body11.ndim != 3 or body11.shape[0] != BODY_ROWS:
        raise ValueError(f"body11 must be [{BODY_ROWS}, D, B], got {tuple(body11.shape)}")
    _, d, b = body11.shape
    if b % BLK:
        raise ValueError(f"batch {b} is not a multiple of {BLK}")
    if tri16.ndim != 2 or tri16.shape[1] != 16 or tri16.shape[0] < T_CHUNK * chunk_bounds.shape[0]:
        raise ValueError(f"tri16 {tuple(tri16.shape)} does not cover {chunk_bounds.shape[0]} chunks")
    if margin.shape != (d,) or verts.ndim != 3 or verts.shape[0] != d or verts.shape[2] != 3:
        raise ValueError(f"margin {tuple(margin.shape)} / verts {tuple(verts.shape)} for {d} bodies")
    if is_box.shape != (d,) or is_box.dtype != torch.bool:
        raise ValueError(f"is_box must be a [{d}] bool tensor")
    for t in (tri16, chunk_bounds, body11, margin, verts):
        if t.dtype != torch.float32:
            raise TypeError(f"expected float32, got {t.dtype}")
    for t in (tri16, chunk_bounds, margin, verts, is_box):
        if t.device != body11.device:
            raise ValueError("all inputs must be on one device")


def body_contacts(tri16, chunk_bounds, body11, margin, verts, is_box):
    """[8, D*K, B] contacts of D bodies over B lanes (B a multiple of 128).

    tri16 [T, 16] triangle table with the active-edge flags in columns
    13-15 (CompiledMap.tri16); chunk_bounds [NC, 4]; body11 [16, D, B]
    rows: centre xyz, quat xyzw, half extents xyz, on, velocity xyz, 0, 0;
    margin [D] chunk radius per body; verts [D, V, 3] support clouds about
    the shape centre; is_box [D] bool (True: closed-form box support).
    """
    _check(tri16, chunk_bounds, body11, margin, verts, is_box)
    idx, cnt = chunk_lists(chunk_bounds, body11, margin)
    return _contacts_plain(tri16, idx, cnt, body11, verts, is_box)


def _first_max(x):
    """Index of the first maximum along the last axis."""
    best = x.amax(dim=-1, keepdim=True)
    k = torch.arange(x.shape[-1], device=x.device)
    return torch.where(x == best, k, x.shape[-1]).amin(dim=-1)


def _contacts_plain(tri16, idx, cnt, body11, verts, is_box):
    _, d, b = body11.shape
    G = b // BLK
    nc = idx.shape[-1]
    tri, tvalid = gather_listed_chunks(tri16, idx.reshape(d * G, nc), cnt.reshape(d * G), T_CHUNK)
    kt = tri.shape[1]
    tri = tri.reshape(d, G, 1, kt, 16)
    tvalid = tvalid.reshape(d, G, 1, kt)
    col = lambda k: tri[..., k]  # [D, G, 1, Kt]
    ax, ay, az = col(0), col(1), col(2)
    bx, by, bz = col(3), col(4), col(5)
    cx, cy, cz = col(6), col(7), col(8)
    fnx, fny, fnz = col(9), col(10), col(11)
    lane = lambda k: body11[k].reshape(d, G, BLK, 1)
    ccx, ccy, ccz = lane(0), lane(1), lane(2)
    qx, qy, qz, qw = lane(3), lane(4), lane(5), lane(6)
    hx, hy, hz = lane(7), lane(8), lane(9)
    on = lane(10)
    bvx, bvy, bvz = lane(11), lane(12), lane(13)

    qtx, qty, qtz = g.closest_point_on_triangle_soa(ccx, ccy, ccz, ax, ay, az, bx, by, bz, cx, cy, cz)
    dx, dy, dz = ccx - qtx, ccy - qty, ccz - qtz
    dist = torch.sqrt(dx * dx + dy * dy + dz * dz)
    inv = 1.0 / torch.clamp_min(dist, 1e-9)
    rx, ry, rz = dx * inv, dy * inv, dz * inv
    side = torch.sign((ccx - ax) * fnx + (ccy - ay) * fny + (ccz - az) * fnz)
    side = torch.where(side == 0, 1.0, side)
    flip = torch.sign(rx * fnx + ry * fny + rz * fnz) * side
    flip = torch.where(flip == 0, 1.0, flip)
    far = dist > 1e-6
    nx = torch.where(far, rx * flip, fnx * side)
    ny = torch.where(far, ry * flip, fny * side)
    nz = torch.where(far, rz * flip, fnz * side)

    fx, fy, fz = fnx * side, fny * side, fnz * side
    lx, ly, lz = _qrot(-qx, -qy, -qz, qw, nx, ny, nz)
    r_sup = torch.abs(lx) * hx + torch.abs(ly) * hy + torch.abs(lz) * hz
    hull = ~is_box
    if bool(hull.any()):
        vv = lambda v, k: verts[:, v, k].reshape(d, 1, 1, 1)
        r_hull = None
        for v in range(verts.shape[1]):
            s = -(vv(v, 0) * lx + vv(v, 1) * ly + vv(v, 2) * lz)
            r_hull = s if r_hull is None else torch.maximum(r_hull, s)
        r_sup = torch.where(hull.reshape(d, 1, 1, 1), r_hull, r_sup)

    signed = dx * nx + dy * ny + dz * nz
    depth = torch.where((tvalid > 0.5) & (on > 0.5), r_sup - signed, _NEG_BIG)
    feat_act = _feature_active(qtx, qty, qtz, ax, ay, az, bx, by, bz, cx, cy, cz,
                               col(13), col(14), col(15))
    align = nx * fx + ny * fy + nz * fz
    vdotf = bvx * fx + bvy * fy + bvz * fz
    vt2 = bvx * bvx + bvy * bvy + bvz * bvz - vdotf * vdotf
    use_fix = ~feat_act & (depth > -0.02) & (align > 0.7) & (vt2 > 0.05 * 0.05)
    nx = torch.where(use_fix, fx, nx)
    ny = torch.where(use_fix, fy, ny)
    nz = torch.where(use_fix, fz, nz)

    # chunk top-K: the K first maxima of each 32-row chunk, the TPU kernel's
    # repeated first-row max (rows past a block's count are invalid)
    C = kt // T_CHUNK
    rows = lambda a: a.expand(d, G, BLK, kt).reshape(d, G, BLK, C, T_CHUNK)
    comps = torch.stack([rows(a) for a in (depth, nx, ny, nz, qtx, qty, qtz)])  # [7, D, G, BLK, C, 32]
    top = []
    for _k in range(K):
        # a picked row's depth is masked to -1e30, so once a chunk runs out
        # of valid rows its later picks carry -1e30 and never enter the buffer
        i = _first_max(comps[0])[..., None]
        top.append(comps.gather(-1, i.expand(7, *i.shape))[..., 0])  # [7, D, G, BLK, C]
        comps = torch.cat([comps[:1].scatter(-1, i[None], _NEG_BIG), comps[1:]])
    # running top-K: each chunk's K, deepest first, bubbled in with a strict
    # `>` at every slot, as the TPU kernel does (not a stable merge: between
    # equal entries of two chunks the later one can survive a displacement)
    empty = torch.tensor([_NEG_BIG, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0], device=body11.device)
    best = [empty.reshape(7, 1, 1, 1).expand(7, d, G, BLK) for _ in range(K)]
    for c in range(C):
        for k in range(K):
            cand = top[k][..., c]
            for s in range(K):
                swap = (cand[0] > best[s][0])[None]
                best[s], cand = torch.where(swap, cand, best[s]), torch.where(swap, best[s], cand)
    out = torch.stack(best, -1)  # [7, D, G, BLK, K]
    out = out.permute(0, 1, 4, 2, 3).reshape(7, d * K, b)
    return torch.cat([out, torch.zeros((1, d * K, b), device=body11.device)], 0)
