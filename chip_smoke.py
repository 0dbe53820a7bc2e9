"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. the card's name and power limit; no CUDA device is a failure;
  2. build the hand-written kernels from c_game_engine_tpu_torch/csrc/
     with nvcc for sm_90a, one nvcc per source, all at once;
  3. kernel phase: the capsule-resolve (K1) and ray (K2) kernels against
     their plain PyTorch versions on the card, on the inputs a tick of a
     4096-env run of the arena map hands them, bit for bit (K1 on its main
     and its stick-to-floor launch; K2 on the merged ray launch's 8192
     rays, timed as the wrapper and as the kernel alone without `_pack`);
     then the body-contact
     kernel (K3) likewise, bit for bit, on the inputs a 4096-env tick of
     arena_bodies hands it (every body awake, the hull bodies present);
     K1's and K3's wrapper times come with their chunk-list ops' share;
     then the tile-raster
     kernel (K4, its binning included) on the inputs one 64-env 256 x 256
     render_batch of arena_lit hands it, for pass 1 and for the reveal
     pass, bit for bit, with the time of the binning ops it replaced; then the
     streamed raster kernel (K5) likewise on arena_orb (82,568 live
     triangles: the big route, on which K4 never launches), bit for bit,
     with two bounds: the work the function needs (each edge function's
     per-row, per-line and per-column factors once, its final subtraction
     and the inside test on every hit pair, z and the division only on the
     pairs that are inside), and the earlier count that charged every hit
     pair 40 flops;
  4. reference checks: 30 ticks at 256 envs of each tick map on the card
     against the same ticks run by the plain versions on the CPU; then 4
     envs after 30 ticks, one per sweep heading, rendered at 256 x 256 on
     the card against the plain path on the CPU (at most 0.2% of pixels off
     by more than 1/255), of arena_lit and of arena_orb;
  5. main paths, each with every kernel's launch counter reset just before
     and read just after: load_map -> reset_batch(4096) -> rollout of 240
     ticks of the bench.py stream (hold W, look += 0.01), first on arena
     (K1, K2), then on arena_bodies (K1, K2, K3; K3 launches once on each
     tick on which some body is awake, the rigid-body step's gate); then
     the render path: load_map + load_bundle of arena_lit ->
     reset_batch(64) -> 60 ticks of the stream -> the 4-heading yaw sweep
     of benchmarks/run_all.py::bench_render at 256 x 256, once as warm-up
     and once timed (K4 twice per frame batch: pass 1 and the reveal);
     then the same render path on arena_orb (K5 twice per frame batch, K4
     never).
The last three lines are the card's name and power limit, a JSON object
with each kernel's launches, error, times and bound, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BATCH, TICKS = 4096, 240
KERNELS = ("capsule_resolve", "ray_tris", "body_contacts", "raster_tiles", "raster_tiles_big")
# the render main path: bench_render's batch, size and sweep
RENDER_BATCH, SIZE, HEADINGS, RENDER_TICKS = 64, 256, 4, 60
FRAME_BAR = 0.002  # share of pixels that may differ by more than 1/255

# H100 SXM published peaks (float32 outside the tensor cores; HBM3)
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# float operations per (lane, triangle) pair, counted from the CUDA sources:
# the closest point on a triangle is ~110; K1 runs three of them plus ~50
# for the contact per iteration and ~220 per (lane, box); K2's two-sided
# Moller-Trumbore is ~60; K3's contact, support radius, edge test and
# insertion are ~256 for a box body plus 7 per cloud vertex for a hull.
K1_PAIR_FLOPS, K1_BOX_FLOPS, K2_PAIR_FLOPS = 380, 220, 60
K3_BOX_PAIR_FLOPS, K3_VERTEX_FLOPS = 256, 7
# K5, counted where the function needs each operation: per (row, tile) whose
# row's bbox overlaps the tile, the edges' six coordinate differences; per
# (row, pixel line) and per (row, pixel column) of that tile, one difference
# and one product for each of the three edges; per (pixel, row) pair, each
# edge function's final subtraction and the inside test's 6 compares; on
# the pairs that are inside, the denominator (3), affine z with its division
# (6) and the four compares of the strictly-closer test; no attributes.
# The earlier count charged every pair 40 (27 for the edge functions and
# inside test, 13 for z), K5_EVERY_PAIR_FLOPS.
K5_ROW_FLOPS, K5_LINE_FLOPS, K5_PAIR_FLOPS, K5_INSIDE_FLOPS = 6, 6, 9, 13
K5_EVERY_PAIR_FLOPS = 40
# K4, counted as K5 is for its walk (K5_ROW_FLOPS per listed (row, tile),
# K5_LINE_FLOPS per line and per column of that tile, K5_PAIR_FLOPS per
# (pixel, row) pair, K5_INSIDE_FLOPS per pair that is inside), plus its
# binning, the box of each row once per env (the 4 min and 4 max of its
# three vertices, K4_BOX_FLOPS) and its 4 compares for each tile it is
# tested against (K4_BIN_FLOPS), and the winner's attributes once per
# covered pixel (K4_PIXEL_FLOPS: three barycentric divisions, 1/w and its
# clamp, 5 for the interpolated 1/w, 3 weights, fragment depth 6 and eight
# interpolations of 6).
K4_BOX_FLOPS, K4_BIN_FLOPS, K4_PIXEL_FLOPS = 8, 4, 67


def kernel_modules():
    """{kernel name: its ops module}; each module counts its launches."""
    from c_game_engine_tpu_torch.ops import body_contacts, capsule_resolve, raster_tiles, raster_tiles_big, ray_tris

    return {"capsule_resolve": capsule_resolve, "ray_tris": ray_tris, "body_contacts": body_contacts,
            "raster_tiles": raster_tiles, "raster_tiles_big": raster_tiles_big}


def reset_counts():
    for m in kernel_modules().values():
        m.launches = 0


def read_counts():
    return {k: m.launches for k, m in kernel_modules().items()}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time(fn, reps=20):
    """Mean ms per call over `reps` calls after two warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops, nbytes):
    """The least time the card could take: the larger of operations over
    the peak float32 rate and bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def distinct_listed(idx, cnt, env_rows=0):
    """How many distinct entries the lists idx [..., L] (first cnt [...]
    valid) hold; with env_rows > 0 the first axis is the env and each env
    lists rows of its own table of env_rows rows."""
    import torch

    listed = torch.arange(idx.shape[-1], device=idx.device) < cnt[..., None]
    env = torch.arange(idx.shape[0], device=idx.device).view(-1, *([1] * (idx.ndim - 1)))
    return int(torch.unique((idx.long() + env * env_rows)[listed]).numel())


def listed_chunk_bytes(idx, cnt):
    """Bytes of the distinct 32-triangle chunks (2 KB each) some block lists."""
    return distinct_listed(idx, cnt) * 32 * 16 * 4


def k1_bound(args):
    from c_game_engine_tpu_torch.ops import capsule_resolve as K1

    tri16, cb, box8, boxh, pos, vel = args
    idx, cnt = K1.chunk_lists(cb, pos)
    b, n = pos.shape[0], box8.shape[1]
    flops = K1.ITERS * (int(cnt.sum()) * 32 * K1.BLK * K1_PAIR_FLOPS + n * b * K1_BOX_FLOPS)
    nbytes = listed_chunk_bytes(idx, cnt) + (box8.numel() + boxh.numel()) * 4 + 4 * b * 3 * 4 + b
    return bound_ms(flops, nbytes)


def k2_bound(args):
    from c_game_engine_tpu_torch.ops import ray_tris as K2

    tri16, cb, origin, direction, max_dist = args
    rays = K2._pack(origin, direction, max_dist)
    idx, cnt = K2.chunk_lists(cb, rays)
    r = origin.shape[0]
    flops = int(cnt.sum()) * 32 * K2.BLK * K2_PAIR_FLOPS
    nbytes = listed_chunk_bytes(idx, cnt) + r * (6 + 1) * 4 + r * 4
    return bound_ms(flops, nbytes)


def k3_bound(args):
    from c_game_engine_tpu_torch.ops import body_contacts as K3

    tri16, cb, body, margin, verts, is_box = args
    idx, cnt = K3.chunk_lists(cb, body, margin)
    _, d, b = body.shape
    on = (body[10] > 0.5).reshape(d, b // K3.BLK, K3.BLK).sum(-1)  # awake lanes per (body, block)
    pair_flops = K3_BOX_PAIR_FLOPS + (~is_box).float() * K3_VERTEX_FLOPS * verts.shape[1]  # [D]
    pairs = (cnt * on).float() * 32  # (lane, triangle) pairs per (body, block)
    flops = float((pairs.sum(1) * pair_flops).sum())
    nbytes = listed_chunk_bytes(idx, cnt) + body.numel() * 4 + verts.numel() * 4 + 8 * d * K3.K * b * 4
    return bound_ms(flops, nbytes)


def kernel_phase(cmap, state, acts):
    import torch

    from c_game_engine_tpu_torch.ops import capsule_resolve as K1
    from c_game_engine_tpu_torch.ops import ray_tris as K2
    from c_game_engine_tpu_torch.profile_tick import tick_calls

    _, seen = tick_calls(cmap, state, acts)
    main = seen["k1"][0]
    assert main[4].shape[0] == 2 * BATCH, f"K1 main launch has {main[4].shape[0]} lanes"
    tri16, cb, box8, boxh, pos, vel = main
    # the stick-to-floor launch: the first B lanes dropped by STICK_DOWN
    drop = torch.tensor([0.0, 0.25, 0.0], device=pos.device)
    stick = (tri16, cb, box8[..., :BATCH].contiguous(), boxh[..., :BATCH].contiguous(),
             pos[:BATCH] - drop, vel[:BATCH])
    k1_err, k1_ms = 0.0, {}
    for label, args in (("main", main), ("stick", stick)):
        pk, vk, gk = K1.resolve_capsule(*args)
        pp, vp, gp = K1.resolve_capsule_plain(*args)
        torch.cuda.synchronize()
        err = max(float((pk - pp).abs().max()), float((vk - vp).abs().max()))
        if not (torch.equal(pk, pp) and torch.equal(vk, vp) and torch.equal(gk, gp)):
            raise AssertionError(f"K1 ({label}) differs from its plain version: "
                                 f"max err {err}, grounded equal {torch.equal(gk, gp)}")
        k1_err = max(k1_err, err)
        k1_ms[label] = (cuda_time(lambda: K1.resolve_capsule(*args)),
                        cuda_time(lambda: K1.resolve_capsule_plain(*args)),
                        cuda_time(lambda: K1.chunk_lists(args[1], args[4])))
        print(f"K1 capsule_resolve {label} ({args[4].shape[0]} lanes): kernel {k1_ms[label][0]:.4f} ms "
              f"(its chunk lists {k1_ms[label][2]:.4f} ms), plain {k1_ms[label][1]:.4f} ms, bitwise equal",
              flush=True)
    k1_b, k1_by = k1_bound(main)

    rays = seen["k2"][0]
    tri16, cb, origin, direction, max_dist = rays
    tk = K2.ray_tris(*rays)
    tp = K2.ray_tris_plain(*rays)
    torch.cuda.synchronize()
    k2_err = float((tk - tp).abs().max())
    if not torch.equal(tk, tp):
        raise AssertionError(f"K2 differs from its plain version at {int((tk != tp).sum())} rays: "
                             f"max err {k2_err}")
    packed = K2._pack(origin, direction, max_dist)
    k2_ms = (cuda_time(lambda: K2.ray_tris(*rays)), cuda_time(lambda: K2.ray_tris_plain(*rays)),
             cuda_time(lambda: K2._launch(tri16, cb, packed)))
    k2_b, k2_by = k2_bound(rays)
    print(f"K2 ray_tris {origin.shape[0]} rays: kernel {k2_ms[0]:.4f} ms (alone, without _pack, "
          f"{k2_ms[2]:.4f} ms), plain {k2_ms[1]:.4f} ms, bitwise equal, hits {int((tk < 1e29).sum())}, "
          f"bound {k2_b:.4f} ms ({k2_by})", flush=True)
    return [
        {"name": "capsule_resolve", "route": "cuda",
         "source": "c_game_engine_tpu_torch/csrc/capsule_resolve.cu",
         "replaces": "c_game_engine_tpu/ops/capsule_resolve.py:240",
         "max_abs_err": k1_err, "ms": k1_ms["main"][0], "plain_ms": k1_ms["main"][1],
         "bound_ms": k1_b, "bound_by": k1_by, "library_ms": None, "ms_chunk_lists": k1_ms["main"][2],
         "ms_stick": k1_ms["stick"][0], "plain_ms_stick": k1_ms["stick"][1]},
        {"name": "ray_tris", "route": "cuda",
         "source": "c_game_engine_tpu_torch/csrc/ray_tris.cu",
         "replaces": "c_game_engine_tpu/ops/ray_tris.py:64",
         "max_abs_err": k2_err, "ms": k2_ms[0], "plain_ms": k2_ms[1],
         "bound_ms": k2_b, "bound_by": k2_by, "library_ms": None, "ms_kernel_alone": k2_ms[2]},
    ]


def body_kernel_phase(cmap, state, acts):
    """K3 against its plain version on the inputs a bodies tick hands it."""
    import torch

    from c_game_engine_tpu_torch.ops import body_contacts as K3
    from c_game_engine_tpu_torch.profile_tick import tick_calls

    _, seen = tick_calls(cmap, state, acts)
    if len(seen["k3"]) != 1:
        raise AssertionError(f"the tick launched K3 {len(seen['k3'])} times, expected 1")
    args = seen["k3"][0]
    body, is_box = args[2], args[5]
    n_on = int((body[10] > 0.5).sum())
    if n_on < int(cmap.aux["num_dynamic"]) * BATCH or bool(is_box[: cmap.aux["num_dynamic"]].all()):
        raise AssertionError(f"K3 inputs have {n_on} awake (lane, body) pairs and no hull body")
    ok = K3.body_contacts(*args)
    op = K3.body_contacts_plain(*args)
    torch.cuda.synchronize()
    err = float((ok - op).abs().max())
    if not torch.equal(ok, op):
        raise AssertionError(f"K3 differs from its plain version: max err {err}")
    ms = (cuda_time(lambda: K3.body_contacts(*args)), cuda_time(lambda: K3.body_contacts_plain(*args)),
          cuda_time(lambda: K3.chunk_lists(args[1], body, args[3])))
    b_ms, b_by = k3_bound(args)
    print(f"K3 body_contacts ({body.shape[1]} bodies x {body.shape[2]} lanes, {n_on} awake): "
          f"kernel {ms[0]:.4f} ms (its chunk lists {ms[2]:.4f} ms), plain {ms[1]:.4f} ms, bitwise equal, "
          f"bound {b_ms:.4f} ms ({b_by})", flush=True)
    return {"name": "body_contacts", "route": "cuda",
            "source": "c_game_engine_tpu_torch/csrc/body_contacts.cu",
            "replaces": "c_game_engine_tpu/ops/body_contacts.py:202",
            "max_abs_err": err, "ms": ms[0], "plain_ms": ms[1],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "ms_chunk_lists": ms[2]}


def reference_phase(name, cmap_gpu, cmap_cpu):
    """30 ticks at 256 envs: kernels on the card vs plain versions on the CPU.
    Bars of tests/test_tpu_parity.py: player position 2e-3, other floats
    (actor position and quaternion included) 5e-3, integers exact."""
    import torch

    from c_game_engine_tpu_torch.core.state import tree_leaves
    from c_game_engine_tpu_torch.models.sim import bench_actions, reset_batch, rollout

    b, t = 256, 30
    acts = bench_actions(t, b, "cpu")
    acts.look[:, 128:, 0] = -0.02  # a second stream on the second block
    gpu = rollout(cmap_gpu, reset_batch(cmap_gpu, b), bench_actions(t, b, "cuda").replace(
        look=acts.look.cuda()))
    cpu = rollout(cmap_cpu, reset_batch(cmap_cpu, b), acts)
    G, C = dict(tree_leaves(gpu)), dict(tree_leaves(cpu))
    for k, c in C.items():
        g = G[k].cpu()
        if c.is_floating_point():
            tol = 2e-3 if k == "player.pos" else 5e-3
            if not torch.allclose(g, c, atol=tol, rtol=0):
                raise AssertionError(f"{name} {k}: card vs CPU differ by {float((g - c).abs().max())}")
        elif not torch.equal(g, c):
            raise AssertionError(f"{name} {k}: card vs CPU differ")
    print(f"reference {name}: {t} ticks x {b} envs on the card match the CPU plain path "
          f"(player y {float(C['player.pos'][0, 1]):.4f})", flush=True)


def main_path(cmap, label):
    """240 ticks x 4096 envs with every launch counter reset just before and
    read just after. Returns (final state, counts, seconds, gate ticks)."""
    import torch

    from c_game_engine_tpu_torch.models.sim import bench_actions, reset_batch, rollout
    from c_game_engine_tpu_torch.physics import bodies

    acts = bench_actions(TICKS, BATCH, "cuda")
    rollout(cmap, reset_batch(cmap, BATCH), acts[:4])  # warm-up
    torch.cuda.synchronize()
    state = reset_batch(cmap, BATCH)
    torch.cuda.synchronize()
    reset_counts()
    bodies.active_ticks = 0
    t0 = time.perf_counter()
    state = rollout(cmap, state, acts)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    gate = bodies.active_ticks

    from c_game_engine_tpu_torch.core.state import tree_leaves

    for k, v in tree_leaves(state):
        if v.is_floating_point() and not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{label}: non-finite state leaf {k}")
        if not bool((v == v[:1]).all()):
            raise AssertionError(f"{label}: envs on one stream diverged in {k}")
    if int(state.tick[0]) != TICKS:
        raise AssertionError(f"{label}: tick {int(state.tick[0])} != {TICKS}")
    return state, counts, dt, gate


def sunk_bodies(cmap, state):
    """Dynamic bodies whose centre is more than 0.05 m lower than their
    smallest half extent above the ground under it (ground: the first
    static hit of a ray cast straight down from 2 m above the centre)."""
    import torch

    from c_game_engine_tpu_torch.ops.ray_tris import ray_tris

    rows = cmap.dyn_slots[cmap.dyn_slots >= 0].long()
    centre = state.actors.pos[0, rows]  # one env: every env follows one stream
    origin = centre + torch.tensor([0.0, 2.0, 0.0], device=centre.device)
    down = torch.tensor([0.0, -1.0, 0.0], device=centre.device).expand_as(origin).contiguous()
    t = ray_tris(cmap.tri16, cmap.chunk_bounds, origin, down, 10.0)
    ground = origin[:, 1] - t
    rest = ground + cmap.halfext[rows].amin(-1)
    sunk = rest - centre[:, 1] > 0.05
    return [(int(r), float(c), float(g)) for r, c, g, s in zip(rows, centre[:, 1], ground, sunk) if s]



def k4_bound(args, kwargs, planes):
    """Bytes: every row's box (columns 0-5) and tri_ok once per env, the
    38 columns of the rows some enabled tile lists, tile_on (if given),
    the exclude ids of the enabled tiles' pixels (none without an exclude
    image) and the 12 planes; operations: the binning (each row's box
    once, its compares for each enabled tile), each listed (row, tile)'s
    per-row, per-line and per-column factors of the edge functions, each
    (pixel, row) pair's final subtractions and inside test, z with its
    division on the pairs that are inside, and the attributes once per
    covered pixel. Returns (ms, bound by, what the print adds)."""
    import torch

    from c_game_engine_tpu_torch.ops import raster_tiles as K4

    tri48, tri_ok, h, w = args
    tile_on, exclude = kwargs.get("tile_on"), kwargs.get("exclude")
    b, t = tri48.shape[:2]
    idx, cnt = K4.bin_triangles(tri48[..., 0:6:2], tri48[..., 1:6:2], tri_ok, h, w)
    if tile_on is not None:
        cnt = torch.where(tile_on.reshape(cnt.shape) != 0, cnt, 0)
    n_rows = distinct_listed(idx, cnt, t)
    overlaps = int(cnt.sum())
    pairs = overlaps * K4.TILE_H * K4.TILE_W
    covered = int((planes[1] >= 0).sum())
    pixels = b * h * w
    tiles_on = cnt.numel() if tile_on is None else int((tile_on != 0).sum())
    nbytes = (t * b * (6 * 4 + 1) + n_rows * 38 * 4 + (0 if tile_on is None else tile_on.numel() * 4)
              + (0 if exclude is None else tiles_on * K4.TILE_H * K4.TILE_W * 4) + 12 * pixels * 4)
    inside = K4.inside_pairs(tri48, tri_ok, h, w, tile_on)
    flops = (K4_BOX_FLOPS * b * t + K4_BIN_FLOPS * t * tiles_on
             + (K5_ROW_FLOPS + K5_LINE_FLOPS * (K4.TILE_H + K4.TILE_W)) * overlaps
             + K5_PAIR_FLOPS * pairs + K5_INSIDE_FLOPS * inside + K4_PIXEL_FLOPS * covered)
    return (*bound_ms(flops, nbytes),
            f"T {t}, {n_rows} listed rows, {overlaps} listed (row, tile), largest tile list {int(cnt.max())}, "
            f"{pairs} pairs, {inside} inside, {covered} covered pixels")


def k5_bound(args, kwargs, planes):
    """Bytes: the 14 columns of the rows whose bbox overlaps an enabled
    tile, tile_on (if given), the exclude ids of the enabled tiles' pixels
    (none without an exclude image) and the two output planes; operations:
    each (row, tile) overlap's per-row, per-line and per-column factors of
    the edge functions, each (pixel, row) pair's final subtractions and
    inside test, and z with its division on the pairs that are inside. The
    chunk and subchunk boxes only prune, so the function needs none of
    their bytes. Returns (ms, bound by, what the print adds); the print
    also gives the bound by the earlier count (K5_EVERY_PAIR_FLOPS on every
    pair)."""
    from c_game_engine_tpu_torch.ops import raster_tiles_big as K5

    trit, cbox, scb, h, w = args
    tile_on, exclude = kwargs.get("tile_on"), kwargs.get("exclude")
    b, _, t = trit.shape
    idx, cnt = K5.tile_lists(trit, h, w, tile_on)
    n_rows = distinct_listed(idx, cnt, t)
    overlaps = int(cnt.sum())
    pairs = overlaps * K5.TILE_H * K5.TILE_W
    pixels = b * h * w
    on_pixels = pixels if tile_on is None else int((tile_on != 0).sum()) * K5.TILE_H * K5.TILE_W
    nbytes = (n_rows * 14 * 4 + (0 if tile_on is None else tile_on.numel() * 4)
              + (0 if exclude is None else on_pixels * 4) + 2 * pixels * 4)
    inside = K5.inside_pairs(trit, h, w, tile_on)
    live = int((trit[:, 10] <= trit[:, 11]).sum())
    per_overlap = K5_ROW_FLOPS + K5_LINE_FLOPS * (K5.TILE_H + K5.TILE_W)
    every, _ = bound_ms(K5_EVERY_PAIR_FLOPS * pairs, nbytes)
    return (*bound_ms(per_overlap * overlaps + K5_PAIR_FLOPS * pairs + K5_INSIDE_FLOPS * inside, nbytes),
            f"T {t}, NC {cbox.shape[1]}, {live} live rows, {n_rows} hit rows, {pairs} hit pairs, "
            f"{inside} inside; bound {every:.4f} ms by the earlier count, {K5_EVERY_PAIR_FLOPS} flops a pair")


def capture_passes(module, fn_name, cmap, bundle, state):
    """The (args, kwargs) of each call of module.fn_name in one SIZE x SIZE
    render_batch, and the launches of every kernel during it."""
    from c_game_engine_tpu_torch.profile_render import render_calls

    before = read_counts()
    seen = render_calls(module, fn_name, bundle, cmap, state, SIZE)
    return seen, {k: v - before[k] for k, v in read_counts().items()}


def raster_passes(tag, kernel, plain, seen, compare, bound):
    """Each captured pass (pass 1, the reveal) through the kernel and its
    plain version on the same inputs: compare(label, kernel's, plain's)
    raises on a disagreement and returns the largest error; then both are
    timed (the kernel over 20 calls, the plain version over 5) and
    bound(args, kwargs, kernel's) gives the bound. Returns the fields of
    the kernel's entry in the kernels line."""
    import torch

    out, worst = {}, 0.0
    for label, (a, k) in zip(("pass1", "reveal"), seen):
        got = kernel(*a, **k)
        want = plain(*a, **k)
        torch.cuda.synchronize()
        err = compare(label, got, want)
        worst = max(worst, err)
        ms = (cuda_time(lambda: kernel(*a, **k)), cuda_time(lambda: plain(*a, **k), reps=5))
        b_ms, b_by, note = bound(a, k, got)
        out[label] = (ms, b_ms, b_by)
        print(f"{tag} {label} ({a[0].shape[0]} envs x {SIZE}x{SIZE}, {note}): kernel {ms[0]:.4f} ms, "
              f"plain {ms[1]:.4f} ms, max abs err {err:.3g}, bound {b_ms:.4f} ms ({b_by})", flush=True)
    (ms, b_ms, b_by), (ms2, b2, _) = out["pass1"], out["reveal"]
    return {"max_abs_err": worst, "ms": ms[0], "plain_ms": ms[1],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "ms_reveal": ms2[0], "plain_ms_reveal": ms2[1], "bound_ms_reveal": b2}


def render_kernel_phase(cmap, bundle, state):
    """K4 against its plain version on the inputs one 64-env render_batch
    hands it: pass 1 and the reveal pass, all 12 planes bit for bit; the
    card path runs no `bin_triangles` (the kernel bins). Also times the
    binning ops that the kernel replaced (`bin_triangles` on pass 1's
    inputs, as the wrapper before the fused kernel ran it once per frame
    batch), so that a run of the earlier tree can add them to its kernel's
    time."""
    import torch

    from c_game_engine_tpu_torch.ops import raster_tiles as K4

    binning, bin_triangles = [], K4.bin_triangles
    K4.bin_triangles = lambda *a: binning.append(1) or bin_triangles(*a)
    try:
        seen, _ = capture_passes(K4, "raster_tiles_binned", cmap, bundle, state)
    finally:
        K4.bin_triangles = bin_triangles
    if len(seen) != 2 or binning:
        raise AssertionError(f"one render_batch launched K4 {len(seen)} times and ran bin_triangles "
                             f"{len(binning)} times, expected 2 and 0")

    def compare(label, pk, pp):
        for k, (g, p) in enumerate(zip(pk, pp)):
            if not torch.equal(g, p):
                err = float(torch.where(torch.isfinite(p), g - p, 0.0).abs().max()) if g.is_floating_point() else 0
                raise AssertionError(f"K4 ({label}) plane {k} differs from its plain version at "
                                     f"{int((g != p).sum())} pixels (max err {err})")
        return 0.0

    entry = raster_passes("K4 raster_tiles", K4.raster_tiles_binned, K4.raster_tiles_binned_plain, seen, compare,
                          k4_bound)
    (tri48, tri_ok, h, w), _ = seen[0]
    bin_ms = cuda_time(lambda: bin_triangles(tri48[..., 0:6:2], tri48[..., 1:6:2], tri_ok, h, w))
    print(f"K4 binning ops the kernel replaced (bin_triangles on pass 1's inputs): {bin_ms:.4f} ms", flush=True)
    return {"name": "raster_tiles", "route": "cuda",
            "source": "c_game_engine_tpu_torch/csrc/raster_tiles.cu",
            "replaces": "c_game_engine_tpu/ops/raster_tiles.py:182",
            **entry, "ms_bin_triangles": bin_ms}


def render_big_kernel_phase(cmap, bundle, state):
    """K5 against its plain version on the inputs one 64-env render_batch
    of a big-route map hands it: pass 1 and the reveal pass. Winner planes
    equal, z equal where finite and infinite alike; K4 does not launch."""
    import torch

    from c_game_engine_tpu_torch.ops import raster_tiles_big as K5

    seen, launched = capture_passes(K5, "raster_tiles_big", cmap, bundle, state)
    if len(seen) != 2 or launched["raster_tiles"] != 0:
        raise AssertionError(f"one render_batch launched K5 {len(seen)} times and K4 "
                             f"{launched['raster_tiles']} times, expected 2 and 0")

    def compare(label, got, want):
        (zk, wk), (zp, wp) = got, want
        if not torch.equal(wk, wp):
            raise AssertionError(f"K5 ({label}) winner plane differs from its plain version "
                                 f"at {int((wk != wp).sum())} pixels")
        if not torch.equal(torch.isinf(zk), torch.isinf(zp)):
            raise AssertionError(f"K5 ({label}) empty pixels differ from its plain version")
        err = float(torch.where(torch.isfinite(zp), zk - zp, 0.0).abs().max())
        if err != 0.0:
            raise AssertionError(f"K5 ({label}) z differs from its plain version: max err {err}")
        return err

    return {"name": "raster_tiles_big", "route": "cuda",
            "source": "c_game_engine_tpu_torch/csrc/raster_tiles_big.cu",
            "replaces": "c_game_engine_tpu/ops/raster_tiles_big.py:187",
            **raster_passes("K5 raster_tiles_big", K5.raster_tiles_big, K5.raster_tiles_big_plain, seen,
                            compare, k5_bound)}


def render_reference_phase(name, cmap, bundle):
    """4 envs of the map `name` after 30 ticks of the stream, each at its
    own sweep heading, rendered on the card and by the plain path on the
    CPU."""
    import math

    import torch

    from c_game_engine_tpu_torch.core.state import tree_map
    from c_game_engine_tpu_torch.models.sim import bench_actions, reset_batch, rollout
    from c_game_engine_tpu_torch.render.bundle import load_render_map
    from c_game_engine_tpu_torch.render.raster import render_batch

    cm_cpu, rb_cpu = load_render_map(name, "cpu")
    st = rollout(cm_cpu, reset_batch(cm_cpu, HEADINGS), bench_actions(30, HEADINGS, "cpu"))
    st = st.replace(player=st.player.replace(
        yaw=st.player.yaw + torch.arange(HEADINGS) * (2.0 * math.pi / HEADINGS)))
    cpu = render_batch(rb_cpu, cm_cpu, st, SIZE, SIZE)
    gpu = render_batch(bundle, cmap, tree_map(lambda x: x.cuda(), st), SIZE, SIZE).cpu()
    off = (gpu - cpu).abs().amax(-1) > 1 / 255
    share = float(off.float().mean())
    if not share <= FRAME_BAR or not bool(torch.isfinite(gpu).all()):
        raise AssertionError(f"render {name}: {int(off.sum())} pixels ({share:.4%}) differ from the CPU "
                             "by more than 1/255")
    print(f"reference render {name}: {HEADINGS} envs x {SIZE}x{SIZE} on the card match the CPU plain path "
          f"({int(off.sum())} pixels, {share:.4%}, off by more than 1/255)", flush=True)


def coverage(frame):
    """bench_render's non-sky share: pixels whose 8-bit colour differs from
    the top-left pixel's by more than 12 (summed over channels)."""
    import torch

    u8 = (frame.clamp(0, 1) * 255).to(torch.uint8).int()
    return float(((u8 - u8[0, 0]).abs().sum(-1) > 12).float().mean())


def render_main_path(cmap, bundle, state, kernel):
    """The sweep once as warm-up (coverage checked there, as bench_render
    does), then once timed with every launch counter reset just before and
    read just after; `kernel` is the raster kernel of the map's route,
    which must launch twice per frame batch, and the other none. Returns
    (counts, seconds, coverages)."""
    import torch

    from c_game_engine_tpu_torch.render.raster import render_batch, yaw_sweep

    states = yaw_sweep(state, HEADINGS)
    warm = [render_batch(bundle, cmap, s, SIZE, SIZE) for s in states]
    covs = [coverage(f[0]) for f in warm]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    frames = [render_batch(bundle, cmap, s, SIZE, SIZE) for s in states]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    for k, (f, w) in enumerate(zip(frames, warm)):
        if f.shape != (RENDER_BATCH, SIZE, SIZE, 3) or not bool(torch.isfinite(f).all()):
            raise AssertionError(f"render heading {k}: frames {tuple(f.shape)} not finite")
        if not torch.equal(f, w):
            raise AssertionError(f"render heading {k}: the timed frames differ from the warm-up's")
    if min(covs) < 0.03:
        raise AssertionError(f"render: sweep non-sky coverage {covs} below 0.03")
    other = ({"raster_tiles", "raster_tiles_big"} - {kernel}).pop()
    if counts[kernel] != 2 * HEADINGS or counts[other] != 0:
        raise AssertionError(f"render: {kernel} launched {counts[kernel]} times and {other} "
                             f"{counts[other]} times for {HEADINGS} frame batches")
    return counts, dt, covs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}", flush=True)

    sys.path.insert(0, str(ROOT))
    from c_game_engine_tpu_torch.core.state import load_map
    from c_game_engine_tpu_torch.models.sim import bench_actions, reset_batch, rollout
    from c_game_engine_tpu_torch.ops import build
    from c_game_engine_tpu_torch.render.bundle import load_render_map

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(build.build, KERNELS))
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(KERNELS)} kernels in parallel "
          f"(nvcc {' '.join(build.NVCC_FLAGS)})", flush=True)

    maps = ROOT / "c_game_engine_tpu_torch" / "maps"
    load = lambda name, dev: load_map(maps / f"{name}.npz", maps / f"{name}.json", dev)
    arena, bodies_map = load("arena", "cuda"), load("arena_bodies", "cuda")
    lit, lit_bundle = load_render_map("arena_lit", "cuda")
    orb, orb_bundle = load_render_map("arena_orb", "cuda")

    # kernel phases on real states: a few ticks of the bench stream first
    state = rollout(arena, reset_batch(arena, BATCH), bench_actions(8, BATCH, "cuda"))
    report = kernel_phase(arena, state, bench_actions(1, BATCH, "cuda")[0])
    report.append(body_kernel_phase(bodies_map, reset_batch(bodies_map, BATCH),
                                    bench_actions(1, BATCH, "cuda")[0]))
    lit_state = rollout(lit, reset_batch(lit, RENDER_BATCH), bench_actions(RENDER_TICKS, RENDER_BATCH, "cuda"))
    report.append(render_kernel_phase(lit, lit_bundle, lit_state))
    orb_state = rollout(orb, reset_batch(orb, RENDER_BATCH), bench_actions(RENDER_TICKS, RENDER_BATCH, "cuda"))
    report.append(render_big_kernel_phase(orb, orb_bundle, orb_state))

    reference_phase("arena", arena, load("arena", "cpu"))
    reference_phase("arena_bodies", bodies_map, load("arena_bodies", "cpu"))
    render_reference_phase("arena_lit", lit, lit_bundle)
    render_reference_phase("arena_orb", orb, orb_bundle)

    # main paths
    by_path = {}
    state, counts, dt, _ = main_path(arena, "arena")
    for name in ("capsule_resolve", "ray_tris"):
        if counts[name] < TICKS:
            raise AssertionError(f"arena: {name} launched {counts[name]} times in {TICKS} ticks")
    steps = BATCH * TICKS / dt
    by_path["arena"] = {"counts": counts, "steps_per_s": steps}
    print(f"main path arena: {TICKS} ticks x {BATCH} envs in {dt:.3f} s = {steps:.1f} steps/s "
          f"on {card}; launches {counts}; final player pos {state.player.pos[0].tolist()}", flush=True)

    state, counts, dt, gate = main_path(bodies_map, "arena_bodies")
    for name in ("capsule_resolve", "ray_tris"):
        if counts[name] < TICKS:
            raise AssertionError(f"arena_bodies: {name} launched {counts[name]} times in {TICKS} ticks")
    if not 0 < counts["body_contacts"] == gate:
        raise AssertionError(f"arena_bodies: K3 launched {counts['body_contacts']} times, "
                             f"the body gate opened on {gate} ticks")
    sunk = sunk_bodies(bodies_map, state)
    if sunk:
        raise AssertionError(f"arena_bodies: bodies below their floor (row, y, ground): {sunk}")
    steps = BATCH * TICKS / dt
    by_path["arena_bodies"] = {"counts": counts, "steps_per_s": steps, "gate_ticks": gate}
    print(f"main path arena_bodies: {TICKS} ticks x {BATCH} envs in {dt:.3f} s = {steps:.1f} steps/s "
          f"on {card}; launches {counts}; body gate open on {gate} ticks; "
          f"final player pos {state.player.pos[0].tolist()}", flush=True)

    for path, name, cm, rb, st, kernel in (("render", "arena_lit", lit, lit_bundle, lit_state, "raster_tiles"),
                                           ("render_orb", "arena_orb", orb, orb_bundle, orb_state,
                                            "raster_tiles_big")):
        counts, dt, covs = render_main_path(cm, rb, st, kernel)
        fps = RENDER_BATCH * HEADINGS / dt
        by_path[path] = {"counts": counts, "frames_per_s": fps, "coverage": covs}
        print(f"main path render {name}: {HEADINGS} frame batches x {RENDER_BATCH} envs x {SIZE}x{SIZE} "
              f"in {dt:.4f} s = {fps:.1f} frames/s on {card}; non-sky coverage by heading "
              f"{[round(c, 4) for c in covs]}; launches {counts}", flush=True)

    home = {"body_contacts": "arena_bodies", "raster_tiles": "render", "raster_tiles_big": "render_orb"}
    for k in report:
        k["launches"] = by_path[home.get(k["name"], "arena")]["counts"][k["name"]]
        k["launches_by_path"] = {p: v["counts"][k["name"]] for p, v in by_path.items()}
    print(card)
    print(json.dumps({"kernels": report,
                      "steps_per_s": {p: v["steps_per_s"] for p, v in by_path.items() if "steps_per_s" in v},
                      "frames_per_s": {p: v["frames_per_s"] for p, v in by_path.items() if "frames_per_s" in v}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
