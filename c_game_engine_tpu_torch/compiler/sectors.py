"""mapSources/*.json -> GMap IR compiler (sector triangulation + lightmap
bake); counterpart of c_game_engine_tpu/compiler/sectors.py. The geometry
is numpy on the host in the JAX module's order; the bake runs on a device
(compiler/baker.py, PyTorch ops).

The reference ships only compiled .gmap binaries; its editor-side compiler
is external (SURVEY.md §2.6). This module reimplements it, reverse-derived
from shipped (json, gmap) pairs:

  - sectors are 2.5D polygons (points in XZ, floorHeight/ceilingHeight)
  - floor = polygon triangulated, normal up; ceiling mirrored, normal down
  - one wall quad per edge, facing inward ([TL,TR,BL,BR], indices
    [BL,TR,TL],[TR,BL,BR]); when another sector shares the (reversed) edge
    only the uncovered height ranges get walls (lower: my floor..their
    floor, upper: their ceiling..my ceiling)
  - wall uv.u = cumulative distance around the sector perimeter * uvScale.x
    + uvOffset.x; uv.v = -y * uvScale.y + uvOffset.y
  - floor/ceiling uv = (x, z) * uvScale + uvOffset
  - material/tools/skip.gmtl -> no render, no collision;
    material/tools/invisible.gmtl -> no render, collision kept
  - collision: one triangle-soup compound per sector, origin =
    (mean(points), (floor+ceiling)/2)
  - lightmap: per-surface luxel rects (surface luxels_per_unit) packed into
    a power-of-two atlas with 2-luxel margins; maps without light_point
    actors get a 1x1 white lightmap (verified: test/button.gmap)

light_point actors are consumed into baked lighting + the point-light table
(the runtime light uniform is declared but never bound in the reference —
SURVEY.md §2.4 — so baked + global light is the full lighting model).

Plane-touch CSG: when sector A's ceiling plane equals sector B's floor
plane and their footprints overlap, the overlap is an OPENING between the
rooms — removed from both surfaces, render AND collision (verified
against stacked.gmap's annulus geometry; per-plane areas match exactly,
tests/test_compiler.py). Our convex-decomposition tessellation is finer
than the editor's. Partial VOLUME overlap (as opposed to touching planes)
appears in no shipped content and is not implemented. Shipped
test.gmap/stacked.gmap also predate their current JSON sources (sector-3
circle coordinates differ), so exact byte-parity checks are only
meaningful on button/advanced_doors (verified bit-exact there).
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from c_game_engine_tpu_torch.assets.gmap import GMap, MapActor, MapCollisionMesh, MapConnection, MapModel
from c_game_engine_tpu_torch.assets.kvlist import Param, kvlist_from_json

SKIP_MATERIAL = "material/tools/skip.gmtl"
INVISIBLE_MATERIAL = "material/tools/invisible.gmtl"
MARGIN = 2  # luxels of padding around each lightmap rect


# ---------------------------------------------------------------------------
# polygon triangulation (ear clipping, XZ plane, CCW or CW tolerant)
# ---------------------------------------------------------------------------


def _signed_area(pts):
    x, z = pts[:, 0], pts[:, 1]
    return 0.5 * np.sum(x * np.roll(z, -1) - np.roll(x, -1) * z)


def triangulate_polygon(pts: np.ndarray) -> list[tuple[int, int, int]]:
    """Ear clipping over [N,2] polygon; returns index triples (in input
    order, wound CCW in the XZ plane)."""
    n = len(pts)
    if n < 3:
        return []
    idx = list(range(n))
    if _signed_area(pts) < 0:
        idx.reverse()
    tris = []
    guard = 0
    while len(idx) > 3 and guard < 10 * n:
        guard += 1
        n_cur = len(idx)
        ear_found = False
        for k in range(n_cur):
            i0, i1, i2 = idx[(k - 1) % n_cur], idx[k], idx[(k + 1) % n_cur]
            a, b, c = pts[i0], pts[i1], pts[i2]
            cross = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
            if cross <= 1e-12:
                continue  # reflex or degenerate
            # no other vertex inside
            inside = False
            for j in idx:
                if j in (i0, i1, i2):
                    continue
                p = pts[j]
                d1 = (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (p[0] - a[0])
                d2 = (c[0] - b[0]) * (p[1] - b[1]) - (c[1] - b[1]) * (p[0] - b[0])
                d3 = (a[0] - c[0]) * (p[1] - c[1]) - (a[1] - c[1]) * (p[0] - c[0])
                if d1 >= -1e-12 and d2 >= -1e-12 and d3 >= -1e-12:
                    inside = True
                    break
            if inside:
                continue
            tris.append((i0, i1, i2))
            idx.pop(k)
            ear_found = True
            break
        if not ear_found:
            # fall back to a fan (degenerate/self-touching polygon)
            break
    if len(idx) >= 3:
        if len(tris) == 0 or len(idx) > 3:
            # fan whatever remains
            for k in range(1, len(idx) - 1):
                tris.append((idx[0], idx[k], idx[k + 1]))
        else:
            tris.append((idx[0], idx[1], idx[2]))
    return tris


# ---------------------------------------------------------------------------
# lightmap atlas
# ---------------------------------------------------------------------------


@dataclass
class Surface:
    material: str
    uv_scale: np.ndarray
    uv_offset: np.ndarray
    luxels_per_unit: float
    verts: np.ndarray  # [V, 5]: pos(3), uv(2)
    tris: np.ndarray  # [T, 3] indices into verts
    normal: np.ndarray  # [3]
    # world->lightmap chart mapping: lm_uv = (proj(pos) - lm_org) * lm_step
    lm_axes: np.ndarray = field(default_factory=lambda: np.zeros((2, 3), np.float32))
    lm_org: np.ndarray = field(default_factory=lambda: np.zeros(2, np.float32))
    lm_size_luxels: tuple = (0, 0)
    lm_rect: tuple = (0, 0)  # atlas position (filled by the packer)
    collidable: bool = True
    visible: bool = True


def _shelf_pack(sizes: list[tuple[int, int]]):
    """Shelf packer with MARGIN-luxel gaps; returns (positions, (W, H))."""
    if not sizes:
        return [], (1, 1)
    max_w = max(w for w, h in sizes)
    total_area = sum((w + 2 * MARGIN) * (h + 2 * MARGIN) for w, h in sizes)
    width = 1
    while width < max_w + 2 * MARGIN or width * width < total_area:
        width *= 2
    while True:
        x, y, shelf_h = MARGIN, MARGIN, 0
        pos = []
        ok = True
        for w, h in sizes:
            if x + w + MARGIN > width:
                x = MARGIN
                y += shelf_h + 2 * MARGIN
                shelf_h = 0
            pos.append((x, y))
            x += w + 2 * MARGIN
            shelf_h = max(shelf_h, h)
        height = y + shelf_h + MARGIN
        h_pow = 1
        while h_pow < height:
            h_pow *= 2
        if h_pow <= width * 2:
            return pos, (width, h_pow)
        width *= 2


# ---------------------------------------------------------------------------
# main compiler
# ---------------------------------------------------------------------------


def _mat_path(m: dict) -> str:
    return m["material"]


def _mat_render(m: dict) -> bool:
    return m["material"] not in (SKIP_MATERIAL, INVISIBLE_MATERIAL)


def _mat_collide(m: dict) -> bool:
    return m["material"] != SKIP_MATERIAL


def _uv(m: dict):
    return (
        np.array([m["uvScale"]["x"], m["uvScale"]["y"]], np.float32),
        np.array([m["uvOffset"]["x"], m["uvOffset"]["y"]], np.float32),
    )


# ---------------------------------------------------------------------------
# plane-touch CSG (stacked sectors): when sector A's ceiling plane equals
# sector B's floor plane and their footprints overlap, the overlap is an
# OPENING between the rooms — the editor removes it from BOTH surfaces,
# render AND collision (verified against stacked.gmap: sector 5's ceiling
# at y=-1 is an annulus around sector 6's footprint, in the draw mesh and
# the collision soup alike; sealing it would block a real passage).
# ---------------------------------------------------------------------------


def _clip_halfplane(poly, a, b, keep_inside):
    """Sutherland-Hodgman clip of convex CCW polygon [N,2] against edge
    a->b; keep_inside keeps the left side (the triangle interior for CCW
    edges)."""
    if len(poly) == 0:
        return poly
    ex, ez = b[0] - a[0], b[1] - a[1]

    def side(p):
        s = ex * (p[1] - a[1]) - ez * (p[0] - a[0])
        return s if keep_inside else -s

    out = []
    n = len(poly)
    for i in range(n):
        p, q = poly[i], poly[(i + 1) % n]
        sp, sq = side(p), side(q)
        if sp >= -1e-12:
            out.append(p)
        if (sp > 1e-12 and sq < -1e-12) or (sp < -1e-12 and sq > 1e-12):
            t = sp / (sp - sq)
            out.append(p + (q - p) * t)
    return np.array(out) if out else np.zeros((0, 2))


def _poly_area2(poly):
    if len(poly) < 3:
        return 0.0
    x, z = poly[:, 0], poly[:, 1]
    return float(np.sum(x * np.roll(z, -1) - np.roll(x, -1) * z))


def _convex_subtract(piece, clip_tri):
    """piece minus clip_tri for convex CCW `piece` and convex CCW clip: returns a
    list of convex CCW pieces (the classic per-edge outside decomposition)."""
    out = []
    inside = piece
    for e in range(len(clip_tri)):
        a, b = clip_tri[e], clip_tri[(e + 1) % len(clip_tri)]
        outside_part = _clip_halfplane(inside, a, b, keep_inside=False)
        if abs(_poly_area2(outside_part)) > 1e-9:
            out.append(outside_part)
        inside = _clip_halfplane(inside, a, b, keep_inside=True)
        if abs(_poly_area2(inside)) <= 1e-12:
            break
    return out


def _ccw_tri_coords(pts, tris):
    """Index triples -> CCW coordinate triangles [T, 3, 2]."""
    out = []
    for t in tris:
        c = np.array([pts[t[0]], pts[t[1]], pts[t[2]]], np.float64)
        if _poly_area2(c) < 0:
            c = c[::-1]
        out.append(c)
    return out


def _merge_convex(tris_coords):
    """Greedy Hertel-Mehlhorn-style merge: combine edge-adjacent convex
    pieces while the union stays convex — fewer, larger pieces keep the
    subtraction from fragmenting the subject quadratically. Adjacency via
    hashed (rounded) directed edges, so the pass is O(n * edges)."""

    def is_convex(poly):
        n = len(poly)
        for i in range(n):
            a, b, c = poly[i - 1], poly[i], poly[(i + 1) % n]
            if (b[0] - a[0]) * (c[1] - b[1]) - (b[1] - a[1]) * (c[0] - b[0]) < -1e-9:
                return False
        return True

    def key(p):
        return (round(float(p[0]) * 1e6), round(float(p[1]) * 1e6))

    pieces = {i: np.asarray(t, np.float64) for i, t in enumerate(tris_coords)}

    def edges_of(pid):
        poly = pieces[pid]
        n = len(poly)
        return [((key(poly[k]), key(poly[(k + 1) % n])), k) for k in range(n)]

    changed = True
    while changed:
        changed = False
        # rebuild adjacency each round (stale incremental entries after a
        # merge were a correctness trap; dict rebuilds are cheap)
        edge_map = {}
        for pid in pieces:
            for e, k in edges_of(pid):
                edge_map[e] = (pid, k)
        for pid in list(pieces.keys()):
            if pid not in pieces:
                continue
            done = False
            for (e0, e1), ii in edges_of(pid):
                other = edge_map.get((e1, e0))
                if other is None or other[0] == pid or other[0] not in pieces:
                    continue
                qid, jj = other
                a, b = pieces[pid], pieces[qid]
                if not (
                    key(a[ii]) == key(b[(jj + 1) % len(b)])
                    and key(a[(ii + 1) % len(a)]) == key(b[jj])
                ):
                    continue
                union = np.concatenate(
                    [
                        [a[(ii + 1 + k) % len(a)] for k in range(len(a))],
                        [b[(jj + 1 + k) % len(b)] for k in range(1, len(b) - 1)],
                    ]
                )
                if not is_convex(union):
                    continue
                pieces[pid] = union
                del pieces[qid]
                changed = True
                done = True
                break
            if done:
                break
    return list(pieces.values())


def _face_geometry(pts, clip_polys):
    """Triangulated polygon minus the clip footprints: returns
    (verts2 [V,2], tris [T,3]) wound CCW in XZ."""
    pieces = _ccw_tri_coords(pts, triangulate_polygon(pts))
    for cp in clip_polys:
        for ct in _merge_convex(_ccw_tri_coords(cp, triangulate_polygon(cp))):
            nxt = []
            for piece in pieces:
                nxt.extend(_convex_subtract(piece, ct))
            pieces = nxt
            if not pieces:
                return np.zeros((0, 2)), np.zeros((0, 3), np.int32)
    # NOTE: merging the FINAL pieces (not just the clip decomposition) was
    # tried and reverted: pieces from different subtraction stages can
    # share partial/collinear edges where the exact-endpoint merge builds
    # non-simple unions. The clip-side merge alone keeps counts sane.
    verts, tris = [], []
    for piece in pieces:
        base = len(verts)
        verts.extend(piece)
        for k in range(1, len(piece) - 1):
            tris.append((base, base + k, base + k + 1))
    return np.asarray(verts, np.float64), np.asarray(tris, np.int32).reshape(-1, 3)


def compile_map_source(path_or_dict, name: str = "mapsource", device="cuda") -> GMap:
    """Compile a mapSources JSON file (or its dict) into GMap IR (same shape
    the shipped .gmap decoder produces), baking the lightmap on `device`."""
    if isinstance(path_or_dict, (str, Path)):
        name = str(path_or_dict)
        with open(path_or_dict) as f:
            src = json.load(f)
    else:
        src = path_or_dict

    sectors = src.get("sectors", [])
    surfaces: list[Surface] = []
    collision: list[MapCollisionMesh] = []

    # precompute sector edge lists for adjacency, and every edge and box
    # as arrays so the all-pairs searches below are vectorized
    sec_pts = [np.array([[p["x"], p["z"]] for p in s["points"]], np.float64) for s in sectors]
    edge_q0 = np.concatenate([p for p in sec_pts] or [np.zeros((0, 2))], 0)
    edge_q1 = np.concatenate([np.roll(p, -1, 0) for p in sec_pts] or [np.zeros((0, 2))], 0)
    edge_owner = np.repeat(np.arange(len(sec_pts)), [len(p) for p in sec_pts])
    box_lo = np.array([p.min(0) for p in sec_pts]).reshape(-1, 2)
    box_hi = np.array([p.max(0) for p in sec_pts]).reshape(-1, 2)

    def close(q, x):
        """np.allclose(q[e], x, atol=1e-6) for every edge row e."""
        return np.all(np.abs(q - x) <= 1e-6 + 1e-5 * np.abs(x), 1)

    def neighbor_of(si, a, b):
        """Find a sector (not si) with edge (b -> a): the first in sector
        and edge order."""
        hit = np.flatnonzero(close(edge_q0, b) & close(edge_q1, a) & (edge_owner != si))
        return int(edge_owner[hit[0]]) if len(hit) else None

    def overlapping(si):
        """Sectors (not si) whose XZ box overlaps si's with a strict margin,
        in order."""
        lo, hi = box_lo[si], box_hi[si]
        ov = (lo[0] < box_hi[:, 0]) & (hi[0] > box_lo[:, 0]) & (lo[1] < box_hi[:, 1]) & (hi[1] > box_lo[:, 1])
        ov[si] = False
        return np.flatnonzero(ov)

    for si, s in enumerate(sectors):
        pts = sec_pts[si]
        fh, ch = float(s["floorHeight"]), float(s["ceilingHeight"])
        n = len(pts)
        sector_tris_collision = []

        # ---- floor & ceiling (with plane-touch CSG openings) ----
        for which, mat, y, up in (
            ("floor", s["floorMaterial"], fh, True),
            ("ceiling", s["ceilingMaterial"], ch, False),
        ):
            clips = []
            for sj in overlapping(si):
                o = sectors[sj]
                oh = float(o["ceilingHeight"]) if up else float(o["floorHeight"])
                if abs(oh - y) < 1e-6:
                    clips.append(sec_pts[sj])
            v2, tris = _face_geometry(pts, clips)
            if len(tris) == 0:
                continue
            scale, off = _uv(mat)
            verts = np.zeros((len(v2), 5), np.float32)
            verts[:, 0] = v2[:, 0]
            verts[:, 1] = y
            verts[:, 2] = v2[:, 1]
            verts[:, 3] = v2[:, 0] * scale[0] + off[0]
            verts[:, 4] = v2[:, 1] * scale[1] + off[1]
            if up:
                tris = tris[:, ::-1]  # CCW-in-XZ faces down; flip for up
            surf = Surface(
                material=_mat_path(mat),
                uv_scale=scale,
                uv_offset=off,
                luxels_per_unit=float(mat.get("luxels_per_unit", 16)),
                verts=verts,
                tris=tris,
                normal=np.array([0, 1.0 if up else -1.0, 0], np.float32),
                collidable=_mat_collide(mat),
                visible=_mat_render(mat),
            )
            lo = pts.min(0)
            surf.lm_axes = np.array([[1, 0, 0], [0, 0, 1]], np.float32)
            surf.lm_org = lo.astype(np.float32)
            ext = pts.max(0) - lo
            surf.lm_size_luxels = (
                max(int(math.ceil(ext[0] * surf.luxels_per_unit)), 1),
                max(int(math.ceil(ext[1] * surf.luxels_per_unit)), 1),
            )
            surfaces.append(surf)
            if surf.collidable:
                w = verts[:, :3]
                sector_tris_collision.append(w[tris.reshape(-1)].reshape(-1, 3, 3))

        # ---- walls ----
        perimeter = 0.0
        wall_mats = s.get("wallMaterials", [])
        for e in range(n):
            a2, b2 = pts[e], pts[(e + 1) % n]
            elen = float(np.linalg.norm(b2 - a2))
            mat = wall_mats[e % len(wall_mats)] if wall_mats else {
                "material": SKIP_MATERIAL,
                "uvScale": {"x": 1, "y": 1},
                "uvOffset": {"x": 0, "y": 0},
            }
            u0 = perimeter
            perimeter += elen
            nb = neighbor_of(si, a2, b2)
            segments = []
            if nb is None:
                segments.append((fh, ch))
            else:
                nfh, nch = float(sectors[nb]["floorHeight"]), float(sectors[nb]["ceilingHeight"])
                if nfh > fh:
                    segments.append((fh, min(nfh, ch)))
                if nch < ch:
                    segments.append((max(nch, fh), ch))
            if elen < 1e-9:
                continue
            for lo_y, hi_y in segments:
                if hi_y - lo_y < 1e-9:
                    continue
                scale, off = _uv(mat)
                # [TL, TR, BL, BR] (decoded from button.gmap)
                verts = np.array(
                    [
                        [a2[0], hi_y, a2[1], u0 * scale[0] + off[0], -hi_y * scale[1] + off[1]],
                        [b2[0], hi_y, b2[1], (u0 + elen) * scale[0] + off[0], -hi_y * scale[1] + off[1]],
                        [a2[0], lo_y, a2[1], u0 * scale[0] + off[0], -lo_y * scale[1] + off[1]],
                        [b2[0], lo_y, b2[1], (u0 + elen) * scale[0] + off[0], -lo_y * scale[1] + off[1]],
                    ],
                    np.float32,
                )
                tris = np.array([[2, 1, 0], [1, 2, 3]], np.int32)
                edge_dir = (b2 - a2) / elen
                normal3 = np.array([-edge_dir[1], 0.0, edge_dir[0]], np.float32)
                # wall normals face the sector interior (verified against
                # button.gmap winding); interior is left of the CCW edge
                if _signed_area(pts) < 0:
                    normal3 = -normal3
                surf = Surface(
                    material=_mat_path(mat),
                    uv_scale=scale,
                    uv_offset=off,
                    luxels_per_unit=float(mat.get("luxels_per_unit", 16)),
                    verts=verts,
                    tris=tris,
                    normal=normal3,
                    collidable=_mat_collide(mat),
                    visible=_mat_render(mat),
                )
                surf.lm_axes = np.array(
                    [[edge_dir[0], 0, edge_dir[1]], [0, -1, 0]], np.float32
                )
                surf.lm_org = np.array(
                    [a2[0] * edge_dir[0] + a2[1] * edge_dir[1], -hi_y], np.float32
                )
                surf.lm_size_luxels = (
                    max(int(math.ceil(elen * surf.luxels_per_unit)), 1),
                    max(int(math.ceil((hi_y - lo_y) * surf.luxels_per_unit)), 1),
                )
                surfaces.append(surf)
                if surf.collidable:
                    w = verts[:, :3]
                    sector_tris_collision.append(w[tris.reshape(-1)].reshape(-1, 3, 3))

        origin = np.array(
            [pts[:, 0].mean(), (fh + ch) / 2.0, pts[:, 1].mean()], np.float32
        )
        if sector_tris_collision:
            rel = np.concatenate(sector_tris_collision, 0) - origin[None, None, :]
            collision.append(MapCollisionMesh(origin, [rel.astype(np.float32)]))
        else:
            collision.append(MapCollisionMesh(origin, []))

    # ------------------------------------------------------------- actors
    actors: list[MapActor] = []
    player_spawn = None
    lights = []
    for a in src.get("actors", []):
        pos = np.array([a["position"]["x"], a["position"]["y"], a["position"]["z"]], np.float32)
        rot = np.array([a["rotation"]["x"], a["rotation"]["y"], a["rotation"]["z"]], np.float32)
        params = kvlist_from_json(a.get("params", {}))
        conns = [
            MapConnection(
                c["sourceOutput"],
                c["targetName"],
                c["targetInput"],
                Param.from_json(c["param"]) if c.get("overridesParam") else Param.none(),
                int(c.get("numRefires", 0)),
            )
            for c in a.get("connections", [])
        ]
        actor = MapActor(a["class"], pos, rot, conns, params)
        if a["class"] == "player":
            player_spawn = actor
        elif a["class"] == "light_point":
            from c_game_engine_tpu_torch.assets import kvlist as kvmod

            color = kvmod.get_color(params, "color", (1, 1, 1, 1))
            lights.append(
                [
                    pos[0], pos[1], pos[2],
                    color[0], color[1], color[2],
                    kvmod.get_float(params, "brightness", 1.0),
                    kvmod.get_float(params, "range", 10.0),
                    kvmod.get_float(params, "attenuation", 1.0),
                ]
            )
        else:
            actors.append(actor)
    point_lights = np.array(lights, np.float32).reshape(-1, 9)

    # ---------------------------------------------------- lightmap + models
    vis = [sf for sf in surfaces if sf.visible]
    if len(point_lights):
        pos_list, (aw, ah) = _shelf_pack([sf.lm_size_luxels for sf in vis])
        for sf, rect in zip(vis, pos_list):
            sf.lm_rect = rect
        all_tris = np.concatenate(
            [
                np.concatenate(m.sub_tris, 0) + m.origin[None, None, :]
                for m in collision
                if m.sub_tris
            ],
            0,
        ) if any(m.sub_tris for m in collision) else np.zeros((0, 3, 3), np.float32)
        lightmap = bake_lightmap(vis, (aw, ah), point_lights, all_tris, device=device)
    else:
        for sf in vis:
            sf.lm_rect = (0, 0)
        aw = ah = 1
        lightmap = np.ones((1, 1, 4), np.float32)

    # group surfaces by material into MapModels, assigning lightmap UVs
    by_mat: dict[str, list[Surface]] = {}
    for sf in vis:
        by_mat.setdefault(sf.material, []).append(sf)
    models = []
    for mat, sfs in by_mat.items():
        verts_all, idx_all = [], []
        voff = 0
        for sf in sfs:
            v7 = np.zeros((sf.verts.shape[0], 7), np.float32)
            v7[:, :5] = sf.verts
            # lightmap uv: project world pos onto the chart
            w = sf.verts[:, :3]
            u_l = w @ sf.lm_axes[0] - sf.lm_org[0]
            v_l = w @ sf.lm_axes[1] - sf.lm_org[1]
            v7[:, 5] = (sf.lm_rect[0] + u_l * sf.luxels_per_unit) / aw
            v7[:, 6] = (sf.lm_rect[1] + v_l * sf.luxels_per_unit) / ah
            verts_all.append(v7)
            idx_all.append(sf.tris.reshape(-1).astype(np.int64) + voff)
            voff += v7.shape[0]
        models.append(
            MapModel(mat, np.concatenate(verts_all, 0), np.concatenate(idx_all, 0).astype(np.uint32))
        )

    return GMap(
        render_sky=bool(src.get("has_sky", False)),
        sky_texture=src.get("sky_texture"),
        discord_icon=src.get("discord_rpc_icon_id", ""),
        discord_name=src.get("discord_rpc_map_name", ""),
        actors=actors,
        models=models,
        collision=collision,
        lightmap=lightmap,
        point_lights=point_lights,
        player_spawn=player_spawn,
    )


def bake_lightmap(surfaces, atlas_size, point_lights, occluder_tris, bounces=0, device="cuda"):
    """Lightmap bake with the recovered editor model (compiler/baker.py):
    per-luxel color*brightness*visible*max(1/d^att - 1/range^att, 0) —
    cosine-free, shadow-rayed, unit gain — 2x2 supersampled per luxel so
    shadow boundaries resolve softly. The sample points are made on the
    host as the JAX module makes them; the shading runs on `device` in one
    call over every surface's four supersamples (a point's radiance does
    not depend on the batch it is shaded in, so the JAX module's per-surface
    calls padded to a fixed chunk are not needed), summed in the JAX
    order. bounces > 0 adds the shader's one-bounce estimate (each point
    with its surface's normal)."""
    from c_game_engine_tpu_torch.compiler.baker import GAIN, make_shader

    aw, ah = atlas_size
    out = np.zeros((ah, aw, 4), np.float32)
    out[..., 3] = 1.0

    # 2x2 rotated-grid supersample offsets within a luxel
    SS = np.array([[-0.25, -0.25], [0.25, -0.25], [-0.25, 0.25], [0.25, 0.25]], np.float32) * 0.8

    pts = []  # per surface [len(SS), h*w, 3]
    normals = []  # per surface [len(SS), h*w, 3]
    for sf in surfaces:
        w, h = sf.lm_size_luxels
        pts_ss = []
        for off in SS:
            lx = (np.arange(w) + 0.5 + off[0]) / sf.luxels_per_unit
            ly = (np.arange(h) + 0.5 + off[1]) / sf.luxels_per_unit
            gu, gv = np.meshgrid(lx, ly)  # [h, w]
            # world position of each sample: org + u*axis0 + v*axis1 (+ lift
            # off the surface along the normal to avoid self-shadowing)
            world = (
                (gu[..., None] + sf.lm_org[0]) * sf.lm_axes[0]
                + (gv[..., None] + sf.lm_org[1]) * sf.lm_axes[1]
            )
            # the chart axes don't span 3D; reconstruct the missing
            # coordinate from the surface plane via any vertex
            ref = sf.verts[0, :3]
            missing = ref - (ref @ sf.lm_axes[0]) * sf.lm_axes[0] - (ref @ sf.lm_axes[1]) * sf.lm_axes[1]
            world = world + missing + sf.normal * 1e-2
            pts_ss.append(world.reshape(-1, 3).astype(np.float32))
        pts.append(np.stack(pts_ss))
        normals.append(np.broadcast_to(np.asarray(sf.normal, np.float32), pts[-1].shape))
    if not pts:
        return out
    shade = make_shader(point_lights, occluder_tris, bounces=bounces, device=device)
    res = shade(np.concatenate(pts, 1).reshape(-1, 3), np.concatenate(normals, 1).reshape(-1, 3))
    res = res.reshape(len(SS), -1, 3)
    acc_ss = res[0]
    for k in range(1, len(SS)):
        acc_ss = acc_ss + res[k]
    acc_ss = GAIN * (acc_ss / len(SS))
    n0 = 0
    for sf in surfaces:
        w, h = sf.lm_size_luxels
        x0, y0 = sf.lm_rect
        out[y0 : y0 + h, x0 : x0 + w, :3] = acc_ss[n0 : n0 + h * w].reshape(h, w, 3)
        n0 += h * w
    return out
