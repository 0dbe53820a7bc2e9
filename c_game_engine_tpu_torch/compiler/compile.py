"""Map compiler (counterpart of c_game_engine_tpu/compiler/compile.py): IR
(a decoded .gmap or a compiled mapSources JSON) -> CompiledMap tensors on a
device.

Replaces the reference's load-time object graph construction
(engine/src/assets/MapLoader.c:40-313 + per-class Init functions) with a
host-side compile into fixed-shape SoA tables. String-keyed I/O connections
(Actor.c:80-122) become integer edge tables; name lookup
(GetActorsByName) is resolved here, one edge per matching target.

Everything is numpy on the host, in the JAX module's order (the Morton
sort, np.unique, the float64 products of `_snap_to_box`), so every leaf
comes out bit for bit; only the finished arrays go to the device. Each
leaf takes the dtype the JAX package gives it: under JAX's default 32-bit
mode `jnp.asarray` narrows float64 to float32 and int64 to int32, and
`_tensor` does the same, where `torch.as_tensor` would keep them.
"""

from __future__ import annotations

import logging
import warnings
from pathlib import Path

import numpy as np
import torch

from c_game_engine_tpu_torch.actors.defs import (
    NUM_FDATA,
    NUM_IDATA,
    NUM_SFPARAMS,
    NUM_SIPARAMS,
    ActorClass,
    CLASS_INPUTS,
    CLASS_NAMES,
    COMPILE_TIME_CLASSES,
    INPUT_NAMES,
    Motion,
    OUTPUT_NAMES,
    Output,
)
from c_game_engine_tpu_torch.assets.gmap import GMap, decode_gmap
from c_game_engine_tpu_torch.assets.kvlist import Param, ParamType
from c_game_engine_tpu_torch.compiler.actor_rows import BUILDERS, Row
from c_game_engine_tpu_torch.compiler.models import AssetResolver, DEFAULT_SEARCH_PATHS
from c_game_engine_tpu_torch.core.state import EVENT_CAPACITY, CompiledMap

log = logging.getLogger(__name__)

# what jnp.asarray narrows to with jax_enable_x64 off
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32, np.dtype(np.uint64): np.uint32}


def _tensor(a, device) -> torch.Tensor:
    """A host array on `device`, in the dtype jnp.asarray gives it."""
    a = np.asarray(a)
    return torch.from_numpy(np.array(a, dtype=_NARROW.get(a.dtype, a.dtype), order="C")).to(device)


def _round_up(n: int, m: int) -> int:
    return max(((n + m - 1) // m) * m, m)


def _sound_lengths(resolver, names) -> np.ndarray:
    """Per-sound resampled frame counts for CompiledMap.sound_len (the
    jitted tick's loop/finish bookkeeping; PCM itself stays host-side in
    audio/bank.py's SoundBank). Must match build_sound_bank's layout."""
    from c_game_engine_tpu_torch.audio.bank import MIX_RATE
    from c_game_engine_tpu_torch.assets.codecs import decode_gsnd

    out = []
    for nm in names:
        path = resolver.resolve(nm)
        if path is None:
            out.append(1)
            continue
        snd = decode_gsnd(path)
        n = snd.pcm.shape[0]
        out.append(max(int(round(n * MIX_RATE / snd.rate)), 1) if snd.rate != MIX_RATE else n)
    return np.array(out or [1], np.int32)


class _Ctx:
    def __init__(self, resolver: AssetResolver):
        from c_game_engine_tpu_torch.audio.bank import BUILTIN_SOUNDS

        self.resolver = resolver
        self.texture_ids: dict[str, int] = {}
        # builtins first so Coin.c's coincling / UI clicks always have ids
        self.sound_ids: dict[str, int] = {n: i for i, n in enumerate(BUILTIN_SOUNDS)}

    def texture_id(self, name: str | None) -> int:
        if not name:
            return -1
        if name not in self.texture_ids:
            self.texture_ids[name] = len(self.texture_ids)
        return self.texture_ids[name]

    def sound_id(self, name: str | None) -> int:
        """Intern a sound asset path (SoundPlayer SOUND("%s") prefixing is
        the caller's job) into the map's SoundBank id space."""
        if not name:
            return -1
        if name not in self.sound_ids:
            self.sound_ids[name] = len(self.sound_ids)
        return self.sound_ids[name]


def _pack_param(p: Param) -> tuple[int, np.ndarray, int]:
    """Pack a Param override into (type, f32[4], i32) runtime encoding."""
    pf = np.zeros(4, np.float32)
    pi = 0
    if p.type == ParamType.COLOR:
        pf[:] = p.value
    elif p.type == ParamType.FLOAT:
        pf[0] = p.value
    elif p.type in (ParamType.BYTE, ParamType.INTEGER, ParamType.UINT_64):
        pi = int(p.value)
        pf[0] = float(p.value)
    elif p.type == ParamType.BOOL:
        pi = 1 if p.value else 0
        pf[0] = float(pi)
    elif p.type == ParamType.VEC2:
        pf[:2] = p.value
    elif p.type == ParamType.VEC3:
        pf[:3] = p.value
    elif p.type in (ParamType.STRING, ParamType.KV_LIST, ParamType.ARRAY):
        # not representable at runtime; none of the used actor inputs take
        # these (set_color takes COLOR, counters take INTEGER)
        warnings.warn(f"unsupported runtime param type {p.type.name}; dropped")
    return int(p.type), pf, pi


def compile_map(
    source: GMap | str,
    search_paths=DEFAULT_SEARCH_PATHS,
    resolver: AssetResolver | None = None,
    name: str = "map",
    device="cuda",
) -> CompiledMap:
    """CompiledMap of a GMap, or of a `.gmap` or editor-JSON path (named by
    its path, as in the JAX package), with its leaves on `device`. A JSON
    source's lightmap is baked on `device` (compiler/sectors.py)."""
    if isinstance(source, Path):
        source = str(source)
    if isinstance(source, str):
        name = source
        if source.endswith(".json"):
            from c_game_engine_tpu_torch.compiler.sectors import compile_map_source

            gmap = compile_map_source(source, device=device)
        else:
            gmap = decode_gmap(source)
    else:
        gmap = source
    resolver = resolver or AssetResolver(search_paths)
    ctx = _Ctx(resolver)
    _t = lambda a: _tensor(a, device)

    # ------------------------------------------------------------------ rows
    rows: list[Row] = []
    row_conns: list[list] = []  # parallel: IR connections per row
    for ir in gmap.actors:
        if ir.actor_class in COMPILE_TIME_CLASSES:
            continue
        cls = CLASS_NAMES.get(ir.actor_class)
        if cls is None:
            log.warning("unknown actor class %r; skipped", ir.actor_class)
            continue
        row = BUILDERS[cls](ir, ctx)
        rows.append(row)
        row_conns.append(list(ir.connections))
        for child in row.children:
            rows.append(child)
            row_conns.append([])

    n_real = len(rows)
    n = _round_up(n_real, 8)

    # intern wall textures now so aux["texture_names"] below is complete
    for r in rows:
        ctx.texture_id(r.wall_texture)

    # name -> indices (GetActorsByName semantics: all actors with that name)
    by_name: dict[str, list[int]] = {}
    for i, r in enumerate(rows):
        if r.name:
            by_name.setdefault(r.name, []).append(i)

    # laser emitters: record child laser slot (first child after the emitter)
    for i, r in enumerate(rows):
        if r.cls == int(ActorClass.LASER_EMITTER) and r.children:
            r.si[2] = i + 1  # child laser slot (pre-spawned immediately after)
    # lasers: si[1] = actor excluded from the beam raycast (parent emitter;
    # self for map-placed lasers)
    for i, r in enumerate(rows):
        if r.cls == int(ActorClass.LASER):
            r.si[1] = i - 1 if r.si[1] == -2 else i

    def stack(get, shape_tail, dtype, pad=0):
        out = np.full((n, *shape_tail), pad, dtype)
        for i, r in enumerate(rows):
            out[i] = get(r)
        return _tensor(out, device)

    # ----------------------------------------------------------------- edges
    edge_src, edge_out, edge_dst, edge_in = [], [], [], []
    edge_ptype, edge_pf, edge_pi = [], [], []
    for i, conns in enumerate(row_conns):
        for c in conns:
            out_id = OUTPUT_NAMES.get(c.output)
            in_id = INPUT_NAMES.get(c.target_input)
            if out_id is None or in_id is None:
                log.warning("unknown signal names %r -> %r; edge dropped", c.output, c.target_input)
                continue
            targets = by_name.get(c.target_name, [])
            if not targets:
                log.warning("connection target %r not found (fired warnings at runtime in the reference)", c.target_name)
            for t in targets:
                if in_id not in CLASS_INPUTS[ActorClass(rows[t].cls)]:
                    log.warning(
                        "target %r (class %s) has no handler for input %r; edge dropped",
                        c.target_name, ActorClass(rows[t].cls).name, c.target_input,
                    )
                    continue
                pt, pf, pi = _pack_param(c.param_override)
                edge_src.append(i)
                edge_out.append(int(out_id))
                edge_dst.append(t)
                edge_in.append(int(in_id))
                edge_ptype.append(pt)
                edge_pf.append(pf)
                edge_pi.append(pi)

    e_real = len(edge_src)
    e = _round_up(e_real, 8) if e_real else 8

    def pad_list(lst, fill, dtype, tail=()):
        out = np.full((e, *tail), fill, dtype)
        for i, v in enumerate(lst):
            out[i] = v
        return _tensor(out, device)

    # --------------------------------------------------------- init events
    # spawned fires at creation in map order (Actor.c:49)
    iq_t, iq_i, iq_pt, iq_pf, iq_pi = [], [], [], [], []
    for i in range(n_real):
        for k in range(e_real):
            if edge_src[k] == i and edge_out[k] == int(Output.SPAWNED):
                iq_t.append(edge_dst[k])
                iq_i.append(edge_in[k])
                iq_pt.append(edge_ptype[k])
                iq_pf.append(edge_pf[k])
                iq_pi.append(edge_pi[k])
    if len(iq_t) > EVENT_CAPACITY:
        warnings.warn(f"{len(iq_t)} spawn events exceed event capacity {EVENT_CAPACITY}")
        iq_t = iq_t[:EVENT_CAPACITY]
    q = EVENT_CAPACITY
    init_ev_target = np.full(q, -1, np.int32)
    init_ev_input = np.zeros(q, np.int32)
    init_ev_ptype = np.full(q, int(ParamType.NONE), np.int32)
    init_ev_pf = np.zeros((q, 4), np.float32)
    init_ev_pi = np.zeros(q, np.int32)
    for j in range(len(iq_t)):
        init_ev_target[j] = iq_t[j]
        init_ev_input[j] = iq_i[j]
        init_ev_ptype[j] = iq_pt[j]
        init_ev_pf[j] = iq_pf[j]
        init_ev_pi[j] = iq_pi[j]

    # --------------------------------------------------------------- sensors
    s_owner, s_pos, s_quat, s_ext, s_follow = [], [], [], [], []
    for i, r in enumerate(rows):
        if r.sensor_pos is not None:
            s_owner.append(i)
            s_pos.append(r.sensor_pos)
            s_follow.append(bool(getattr(r, "sensor_follow", False)))
            # coin/goal sensors use identity rotation (Coin.c adjustedTransform);
            # door/trigger sensors use the actor rotation
            if r.cls in (int(ActorClass.COIN), int(ActorClass.GOAL)):
                s_quat.append(np.array([0, 0, 0, 1], np.float32))
            else:
                s_quat.append(r.quat)
            s_ext.append(r.sensor_halfext)
    s_real = len(s_owner)
    s = _round_up(s_real, 4) if s_real else 4
    sensor_owner = np.full(s, -1, np.int32)
    sensor_pos = np.zeros((s, 3), np.float32)
    sensor_quat = np.tile(np.array([0, 0, 0, 1], np.float32), (s, 1))
    sensor_halfext = np.zeros((s, 3), np.float32)
    sensor_follow = np.zeros(s, bool)
    for j in range(s_real):
        sensor_owner[j] = s_owner[j]
        sensor_pos[j] = s_pos[j]
        sensor_quat[j] = s_quat[j]
        sensor_halfext[j] = s_ext[j]
        sensor_follow[j] = s_follow[j]

    # ------------------------------------------------------------- collision
    tris = gmap.all_collision_tris()
    t_real = tris.shape[0]
    t = _round_up(t_real, 8)
    tris_p = np.zeros((t, 3, 3), np.float32)
    tris_p[:, :, 1] = -1e6  # pad tris far below the world
    tris_p[:t_real] = tris
    e0 = tris_p[:, 1] - tris_p[:, 0]
    e1 = tris_p[:, 2] - tris_p[:, 0]
    nrm = np.cross(e0, e1)
    ln = np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = nrm / np.maximum(ln, 1e-12)
    tri_valid = np.zeros(t, bool)
    tri_valid[:t_real] = (ln[:t_real, 0] > 1e-12)

    # Morton-order triangles by centroid so the Pallas kernels' fixed-size
    # chunks are spatially coherent (enables per-chunk AABB skipping)
    cent = tris_p.mean(axis=1)
    lo_c = cent[:t_real].min(0) if t_real else np.zeros(3)
    hi_c = cent[:t_real].max(0) if t_real else np.ones(3)
    qx = np.clip(((cent[:, 0] - lo_c[0]) / max(hi_c[0] - lo_c[0], 1e-6) * 1023), 0, 1023).astype(np.uint32)
    qz = np.clip(((cent[:, 2] - lo_c[2]) / max(hi_c[2] - lo_c[2], 1e-6) * 1023), 0, 1023).astype(np.uint32)

    def _part1by1(v):
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v

    morton = _part1by1(qx) | (_part1by1(qz) << 1)
    morton[~tri_valid] = np.uint32(0xFFFFFFFF)  # pad tris sort last
    order = np.argsort(morton, kind="stable")
    tris_p = tris_p[order]
    nrm = nrm[order]
    tri_valid = tri_valid[order]

    # active-edge flags over the reordered soup (Jolt MeshShape cooking,
    # MapLoader.c:200-273; see compiler/edges.py)
    from c_game_engine_tpu_torch.compiler.edges import edge_active_flags

    tri_edge_act = edge_active_flags(tris_p, tri_valid)

    # per-T_CHUNK chunk AABBs in XZ (for kernel chunk skipping)
    from c_game_engine_tpu_torch.ops.capsule_resolve import T_CHUNK

    t_padded = ((t + T_CHUNK - 1) // T_CHUNK) * T_CHUNK
    n_chunks = t_padded // T_CHUNK
    chunk_bounds = np.zeros((n_chunks, 4), np.float32)
    for ci in range(n_chunks):
        sl = slice(ci * T_CHUNK, min((ci + 1) * T_CHUNK, t))
        v = tris_p[sl][tri_valid[sl]] if sl.start < t else np.zeros((0, 3, 3))
        if len(v):
            chunk_bounds[ci] = [v[..., 0].min(), v[..., 2].min(), v[..., 0].max(), v[..., 2].max()]
        else:
            chunk_bounds[ci] = [1e30, 1e30, -1e30, -1e30]  # empty: never overlaps

    # --------------------------------------------------------------- inertia
    mass = np.array([r.mass for r in rows] + [0.0] * (n - n_real), np.float32)
    motion = np.array([r.motion for r in rows] + [0] * (n - n_real), np.int32)
    halfext = np.zeros((n, 3), np.float32)
    for i, r in enumerate(rows):
        halfext[i] = r.halfext
    dynamic = motion == int(Motion.DYNAMIC)
    dyn_list = np.where(dynamic)[0].astype(np.int32)
    d_pad = max(((len(dyn_list) + 3) // 4) * 4, 4)
    dyn_slots = np.full(d_pad, -1, np.int32)
    dyn_slots[: len(dyn_list)] = dyn_list
    actor_to_dyn = np.full(n, -1, np.int32)
    for di, ai in enumerate(dyn_list):
        actor_to_dyn[ai] = di
    inv_mass = np.where(dynamic & (mass > 0), 1.0 / np.maximum(mass, 1e-9), 0.0).astype(np.float32)
    hx, hy, hz = halfext[:, 0], halfext[:, 1], halfext[:, 2]
    # solid-box tensor from the bound box, overridden by the exact
    # shape tensor where the row carries one (hull/cylinder bodies —
    # Jolt's OverrideMassProperties=CalculateInertia scales the true
    # shape tensor to the body mass, PhysicsModel.c:45-52)
    ibody = (mass[:, None] / 3.0) * np.stack(
        [hy * hy + hz * hz, hx * hx + hz * hz, hx * hx + hy * hy], axis=-1
    )
    for i, r in enumerate(rows):
        if getattr(r, "inertia_per_mass", None) is not None:
            ibody[i] = r.mass * r.inertia_per_mass
    inv_inertia = np.where(
        dynamic[:, None] & (ibody > 1e-12), 1.0 / np.maximum(ibody, 1e-12), 0.0
    ).astype(np.float32)
    rot_lock = np.array([r.rot_lock_y for r in rows] + [False] * (n - n_real), bool)
    # TestActor/NpcJohn allow only Y rotation (TestActor.c:42-46)
    inv_inertia[rot_lock, 0] = 0.0
    inv_inertia[rot_lock, 2] = 0.0

    # Chunk-skip margin for the body-contact kernel (ops/body_contacts.py)
    # and inflation for the XLA fallback's broadphase grid: a triangle chunk
    # or grid cell may only be skipped for a body when it provably cannot
    # produce a manifold candidate (depth > -CAND_SLACK, see
    # physics/batched.py cand_live). Worst case = the largest dynamic body's
    # support radius (half-extent diagonal) + that slack; computed from the
    # actual map content instead of hard-coding (ADVICE r1: a too-small
    # margin silently drops contacts and lets bodies tunnel).
    BODY_CAND_SLACK = 0.3
    dyn_diag = (
        float(np.sqrt((halfext[dynamic] ** 2).sum(-1)).max()) if dynamic.any() else 0.0
    )
    body_margin = dyn_diag + BODY_CAND_SLACK + 0.05

    from c_game_engine_tpu_torch.compiler.broadphase import build_grid

    grid = build_grid(tris_p, tri_valid, inflate=body_margin)

    # ---------------------------------------------------------------- render
    mv, mi, mt, ms = [], [], [], []
    voff = 0
    for model in gmap.models:
        mat = resolver.material(model.material)
        # a material that resolves nowhere becomes the fallbackMaterial
        # (MapMaterialLoader.c:21-26,56): unshaded + "_generic_fallback",
        # which the atlas resolves to the checkerboard missing-texture image
        tex = ctx.texture_id(mat.texture if mat else "_generic_fallback")
        shaded = bool(mat and int(mat.shader) == 1)  # ModelShader.SHADED
        mv.append(model.vertices)
        mi.append(model.indices.astype(np.int64) + voff)
        mt.append(np.full(model.vertices.shape[0], tex, np.int32))
        ms.append(np.full(model.vertices.shape[0], shaded, bool))
        voff += model.vertices.shape[0]
    map_verts = np.concatenate(mv, 0) if mv else np.zeros((0, 7), np.float32)
    map_indices = np.concatenate(mi, 0).astype(np.int32) if mi else np.zeros(0, np.int32)
    map_vert_tex = np.concatenate(mt, 0) if mt else np.zeros(0, np.int32)
    map_vert_shaded = np.concatenate(ms, 0) if ms else np.zeros(0, bool)

    # ---------------------------------------------------------------- player
    if gmap.player_spawn is not None:
        spawn_pos = np.asarray(gmap.player_spawn.position, np.float32)
        spawn_yaw = np.float32(gmap.player_spawn.rotation_euler[1])
        spawn_pitch = np.float32(gmap.player_spawn.rotation_euler[0])
    else:
        spawn_pos = np.zeros(3, np.float32)
        spawn_yaw = np.float32(0)
        spawn_pitch = np.float32(0)

    # longest signal chain: how many rounds process_signals needs per tick
    # (edges whose target can fire an output consumed by another edge)
    depth = 1 if e_real else 0
    src_set = set(edge_src[:e_real])
    frontier = set(edge_dst[k] for k in range(e_real))
    seen_depth = 0
    while depth < 4:
        nxt = {edge_dst[k] for k in range(e_real) if edge_src[k] in frontier}
        if not (frontier & src_set):
            break
        depth += 1
        frontier = nxt
    signal_rounds = max(depth, 1)

    # ------------------------------------------------- support vert clouds
    # Per-actor narrowphase support clouds relative to shape_center
    # (reference: ModelLoader.c:323-351 builds ConvexHullShape compounds;
    # models.py support_cloud reduces the raw .gmdl point clouds). Bodies
    # without a hull cloud use their 8 box corners, which makes the
    # vert-cloud support function equal to the closed-form box support;
    # when EVERY actor reduces to a plain box, aux['hulls_are_boxes'] lets
    # the batched physics keep the cheap closed form (test/stacked/max_box
    # pay nothing for the hull path).
    from c_game_engine_tpu_torch.compiler.models import box_corners

    def _is_box_cloud(cloud: np.ndarray, h: np.ndarray) -> bool:
        if cloud.shape[0] != 8:
            return False
        want = box_corners(h)
        order_a = np.lexsort(cloud.T)
        order_b = np.lexsort(want.T)
        return bool(np.allclose(cloud[order_a], want[order_b], atol=1e-5))

    from c_game_engine_tpu_torch.compiler.models import _SUPPORT_DIRS

    def _snap_to_box(cloud: np.ndarray, h: np.ndarray, tol: float = 0.02) -> bool:
        """True when the cloud's support function is within `tol` of its
        AABB box everywhere on the direction set — e.g. cube.gmdl, whose
        hull is a box with ~8 mm corner bevels. Jolt itself shrinks hulls
        by a 0.05 convex radius, so snapping these to exact boxes is
        within the reference's own tolerance AND restores perfectly
        symmetric 4-corner face manifolds (a beveled face's 1-center +
        3-of-4-edge-vert manifold applies a net torque every tick)."""
        sup_c = (cloud.astype(np.float64) @ _SUPPORT_DIRS.T.astype(np.float64)).max(0)
        sup_b = np.abs(_SUPPORT_DIRS.astype(np.float64)) @ h.astype(np.float64)
        return bool(np.all(np.abs(sup_c - sup_b) <= tol))

    clouds = []
    hulls_are_boxes = True
    for i in range(n):
        r = rows[i] if i < n_real else None
        if r is not None and r.hull_verts is not None:
            c = np.asarray(r.hull_verts, np.float32)
            if _is_box_cloud(c, halfext[i]) or _snap_to_box(c, halfext[i]):
                c = box_corners(halfext[i])
            else:
                hulls_are_boxes = False
        else:
            c = box_corners(halfext[i])
        clouds.append(c)
    v_max = max(8, max(c.shape[0] for c in clouds))
    hull_verts = np.zeros((n, v_max, 3), np.float32)
    for i, c in enumerate(clouds):
        hull_verts[i, : c.shape[0]] = c
        hull_verts[i, c.shape[0] :] = c[0]  # support-neutral padding
    # static per-dyn-slot box flags: the Pallas body-contact kernel unrolls
    # its body loop in Python, so box bodies keep the closed-form support
    # at zero cost even on maps that also carry hull bodies
    dyn_is_box = tuple(
        _is_box_cloud(clouds[ai], halfext[ai]) for ai in dyn_list
    ) + (True,) * (d_pad - len(dyn_list))

    aux = {
        "name": name,
        "signal_rounds": signal_rounds,
        "hulls_are_boxes": hulls_are_boxes,
        "dyn_is_box": dyn_is_box,
        "num_dynamic": int(len(dyn_list)),
        "has_follow_sensors": bool(any(s_follow)),
        "actor_names": [r.name for r in rows],
        "actor_classes": [ActorClass(r.cls).name for r in rows],
        "texture_names": list(ctx.texture_ids.keys()),
        "sound_names": list(ctx.sound_ids.keys()),
        "model_names": sorted({r.model for r in rows if r.model}),
        "num_real_actors": n_real,
        "num_real_tris": t_real,
        "num_real_sensors": s_real,
        "num_real_edges": e_real,
        "sky_texture": gmap.sky_texture,
        "resolver": resolver,
        "grid_shape": grid["shape"],
        "body_margin": body_margin,
    }

    return CompiledMap(
        tris=_t(tris_p),
        tri_normal=_t(nrm.astype(np.float32)),
        tri_valid=_t(tri_valid),
        tri_soa=_t(
            np.concatenate([tris_p.reshape(t, 9).T, nrm.astype(np.float32).T], axis=0)
        ),
        tri_edge_active=_t(tri_edge_act),
        chunk_bounds=_t(chunk_bounds),
        grid_lo=_t(grid["lo"]),
        grid_inv_cell=_t(grid["inv_cell"]),
        grid_cells=_t(grid["cells"]),
        dyn_slots=_t(dyn_slots),
        actor_to_dyn=_t(actor_to_dyn),
        cls=stack(lambda r: r.cls, (), np.int32),
        init_active=stack(lambda r: r.active, (), bool, pad=False),
        init_pos=stack(lambda r: r.pos, (3,), np.float32),
        init_quat=stack(lambda r: r.quat, (4,), np.float32),
        init_visible=stack(lambda r: r.visible, (), bool, pad=False),
        init_skin=stack(lambda r: r.skin, (), np.int32),
        init_mod_color=stack(lambda r: r.mod_color, (4,), np.float32),
        init_fdata=stack(lambda r: r.fdata, (NUM_FDATA,), np.float32),
        init_idata=stack(lambda r: r.idata, (NUM_IDATA,), np.int32),
        flags=stack(lambda r: r.flags, (), np.int32),
        sfparams=stack(lambda r: r.sf, (NUM_SFPARAMS,), np.float32),
        siparams=stack(lambda r: r.si, (NUM_SIPARAMS,), np.int32),
        motion=_t(motion),
        shape=stack(lambda r: r.shape, (), np.int32),
        halfext=_t(halfext),
        hull_verts=_t(hull_verts),
        shape_center=stack(lambda r: r.shape_center, (3,), np.float32),
        layer=stack(lambda r: r.layer, (), np.int32),
        mass=_t(mass),
        inv_mass=_t(inv_mass),
        inv_inertia=_t(inv_inertia),
        friction=stack(lambda r: r.friction, (), np.float32),
        restitution=stack(lambda r: r.restitution, (), np.float32),
        sensor_owner=_t(sensor_owner),
        sensor_pos=_t(sensor_pos),
        sensor_quat=_t(sensor_quat),
        sensor_halfext=_t(sensor_halfext),
        sensor_follow=_t(sensor_follow),
        edge_src=pad_list(edge_src, -1, np.int32),
        edge_out=pad_list(edge_out, 0, np.int32),
        edge_dst=pad_list(edge_dst, 0, np.int32),
        edge_in=pad_list(edge_in, 0, np.int32),
        edge_ptype=pad_list(edge_ptype, int(ParamType.NONE), np.int32),
        edge_pf=pad_list(edge_pf, 0.0, np.float32, tail=(4,)),
        edge_pi=pad_list(edge_pi, 0, np.int32),
        init_ev_target=_t(init_ev_target),
        init_ev_input=_t(init_ev_input),
        init_ev_ptype=_t(init_ev_ptype),
        init_ev_pf=_t(init_ev_pf),
        init_ev_pi=_t(init_ev_pi),
        init_ev_count=_t(np.int32(len(iq_t))),
        wall_axis=stack(lambda r: r.wall_axis, (), np.int32, pad=-1),
        wall_size=stack(lambda r: r.wall_size, (2,), np.float32),
        wall_center=stack(lambda r: r.wall_center, (2,), np.float32),
        wall_uv_scale=stack(lambda r: r.wall_uv_scale, (2,), np.float32),
        wall_uv_offset=stack(lambda r: r.wall_uv_offset, (2,), np.float32),
        wall_tex=stack(lambda r: ctx.texture_id(r.wall_texture), (), np.int32, pad=-1),
        wall_unshaded=stack(lambda r: r.wall_unshaded, (), bool, pad=False),
        model_id=stack(
            lambda r: aux["model_names"].index(r.model) if r.model else -1, (), np.int32, pad=-1
        ),
        billboard=stack(lambda r: r.billboard, (), bool, pad=False),
        spawn_pos=_t(spawn_pos),
        spawn_yaw=_t(spawn_yaw),
        spawn_pitch=_t(spawn_pitch),
        # Map.c:37-47 defaults: fog 0xff000000 (black, a=1), start 2000 end
        # 2500, light white, exposure 1
        default_light=_t(np.ones(4, np.float32)),
        default_fog_color=_t(np.array([0, 0, 0, 1], np.float32)),
        default_fog_start=_t(np.float32(2000.0)),
        default_fog_end=_t(np.float32(2500.0)),
        default_exposure=_t(np.float32(1.0)),
        sound_len=_t(_sound_lengths(resolver, list(ctx.sound_ids.keys()))),
        map_verts=_t(map_verts),
        map_indices=_t(map_indices),
        map_vert_tex=_t(map_vert_tex),
        map_vert_shaded=_t(map_vert_shaded),
        lightmap=_t(gmap.lightmap),
        point_lights=_t(gmap.point_lights),
        aux=aux,
    )
