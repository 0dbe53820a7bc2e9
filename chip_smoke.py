"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. the card's name and power limit; no CUDA device is a failure;
  2. build the hand-written kernels from c_game_engine_tpu_torch/csrc/
     with nvcc for sm_90a, one nvcc per source, all at once;
  2b. the compiler phase (`compiler_phase`): tests/torch_map_sources.py
     writes the four maps' sources (.gmap files and their assets) and an
     editor-JSON map (rooms.json) under build/map_sources/; the port's
     compiler compiles the four maps on the card and its builder builds
     their bundles there, each timed, and every leaf of arena, arena_bodies,
     arena_lit and arena_orb and of the two render maps' bundles is held to
     the committed files bit for bit (the lightmap, which a .gmap stores as
     RGBA16F, to the committed lightmap rounded to float16); every later
     phase runs on these compiled maps and bundles, and the CPU sides of
     the reference checks on the same sources compiled on the CPU. Then
     rooms.json is compiled with its lightmap baked on the card and on the
     CPU (bake seconds of each), the two lightmaps within 1e-4 on at least
     99.9% of luxels; 30 ticks x 256 envs of it go through the reference
     check and 4 envs at 256 x 256 through the render reference check,
     with K4 launching. halls.json, a full-size editor map (514 sectors,
     117,512 luxels, 5,498 occluders, 8 lights), is compiled with its whole
     lightmap baked on the card (seconds, luxels/s) and
     every 101st surface baked again on the CPU, its luxels at the same
     bar. The compile cache is timed cold and on a hit (arena_lit.gmap and
     rooms.json, with their bundles), then make_sim of a .gmap and a .json
     path goes through it. No module of jax, jaxlib, flax or the JAX
     package may be loaded by then;
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
     (through the tick graph) against the same ticks run by the plain
     versions on the CPU; then 4
     envs after 30 ticks, one per sweep heading, rendered at 256 x 256 on
     the card against the plain path on the CPU (at most 0.2% of pixels off
     by more than 1/255), of arena_lit and of arena_orb;
  5. graph phase: 240 ticks x 4096 envs of arena and 60 of arena_bodies
     from reset through the map's captured tick graph
     (models/graph.py) and through the eager loop, bit for bit, with the
     same kernel launches and gate counts; each graph's capture seconds
     and pool memory; then gate states (`gate_states`: lanes lifted above
     the floor with on_ground set; sound-op bits; arena_bodies with every
     body asleep until the player walks into a box), each gate open on
     some ticks and closed on others, graph against eager bit for bit
     (models/graph_check.py); then rollout_collect of player.pos over 250
     ticks x 256 envs of arena (two chunks of the graph's 240-tick action
     stream, a different turn on every tick), the final state and every
     row against the eager loop bit for bit;
  6. main paths, through the tick graph, each with every device count
     (kernel launches, gate ticks; utils/counters.py) reset just before
     and read just after: compile_map -> reset_batch(4096) -> rollout of 240
     ticks of the bench.py stream (hold W, look += 0.01), first on arena
     (K1, K2), then on arena_bodies (K1, K2, K3; K3 launches once on each
     tick on which some body is awake, the rigid-body step's gate); then
     60 replays of arena and 8 of arena_bodies under torch.profiler: K1,
     K2 and K3 launches counted in the trace against the ticks and gate
     counts, and no host sync and no Memcpy HtoD in the replays; then
     the render path: compile_map + build_render_bundle of arena_lit ->
     reset_batch(64) -> 60 ticks of the stream -> the 4-heading yaw sweep
     of benchmarks/run_all.py::bench_render at 256 x 256, once as warm-up
     and once timed (K4 twice per frame batch: pass 1 and the reveal);
     then the same render path on arena_orb (K5 twice per frame batch, K4
     never);
  7. the platform around the tick: the audio phase (60 graphed ticks x
     4096 envs of arena with the synthetic sounds of
     audio/synthetic_sounds.py, the channel tables then filled by
     `audio_states`, one mix_frame of 800 samples for every env timed
     against its bound, 64 envs held to the CPU plain path within 1e-5);
     the mesh phase (parallel/mesh.py::sharded_rollout of arena, 4096 envs
     x 240 ticks of long_run's per-env stream, and of arena_bodies, 512
     envs x 60 ticks, over make_mesh() and over two entries of the one
     card: each equal to the unsharded rollout bit for bit, steps/s of
     both, 0 host syncs between the shards' launches, the kernels'
     launches counted); the multi-process phase (`multiprocess_phase`:
     parallel/worker.py in two processes of a gloo group on the one card,
     arena at 4096 global envs for 120 + 120 ticks and arena_bodies for
     30 + 30 of long_run's per-env stream, a distributed checkpoint
     between the halves that process 0 alone writes and a resume in a
     fresh group; each half equal to the one-process rollout through the
     tick graph bit for bit, K1-K3 launches of each process against the
     one-process counts, steps/s of each process, of both together and of
     one process, checkpoint seconds; then long_run under
     torch.distributed.run with 2 processes, 40 ticks x 256 envs in
     segments of 20, its resume proof passing); the action stream phase
     (240 ticks x 4096 envs recorded with core/actions_io.py's
     ActionRecorder, saved, loaded onto the card unchanged, its replay
     equal to the original rollout bit for bit);
  8. the entry points: a c_game_engine_tpu_torch.long_run resume proof
     over make_mesh() (40 ticks of 256 envs in segments of 20, bitwise),
     one c_game_engine_tpu_torch.bench call, one entry() step,
     dryrun_multichip(2) on the card and the demo (30 ticks, 2 frames of
     arena_lit: a WAV peak above 0, each frame's non-sky coverage at least
     0.03);
  9. the app layer (`app_phase`): GameApp (models/game.py) with the
     synthetic HUD, UI, viewmodel and sounds through the scripted session
     of models/game_check.py (splash -> menu -> level select -> arena_lit
     -> 60 ticks of the bench stream -> pause -> options -> video options,
     one FOV step -> back -> pause -> resume -> 60 ticks), a 256 x 256
     frame of every screen, every count reset just before and read just
     after (K1, K2 and K4 launch; K3 and K5 not); the same session on the
     CPU port in a subprocess: equal screens and events, the in-game
     frames within the frame bar of the CPU's and with non-sky coverage
     of at least 0.03, every control of the widget screens drawn over its
     background; 0 host syncs over in-game tick + render_frame pairs and
     their rate; play.py --script --seconds 5 headless and its frames/s.
  10. the closing slice (`closing_phase`), on the card against the CPU:
     actors/behaviors.py::compute_laser_rays over 4096 envs of arena after
     60 ticks of the bench stream, exactly one K2 launch (the launch count
     reset just before and read just after), the first 256 envs' hits and
     actor ids equal to the CPU's and fractions within 1e-5, ms a call;
     single-env physics/character.py::update_character for 60 ticks of the
     bench stream (positions within 2e-3, on_ground equal; ms a tick, one
     env: launch-bound); physics/raycast.py::cast_ray for the interact ray
     and a laser; physics/batched.py::resolve_capsule_batched (per-lane
     grid candidates) against the K1 path on 4096 lanes of long_run's
     per-env stream after 480 ticks (ROADMAP fault f: the lanes whose
     position differs by more than 1e-3 and by how much, ms a call of each;
     a measurement, not a gate); the dual atlas of arena_lit's textures
     (build_atlas(dual=True)) sampled through its dual rows against the
     two-tap path on 4.2 M taps, bit for bit, ms a call of each;
     bake_lightmap(bounces=1) of rooms.json on the card and the CPU (99% of
     luxels within 1e-4, every one within 0.02; seconds) and of one in every
     101 of halls.json's surfaces on the card (seconds); where this machine
     has g++ and zlib's header (native.py::have_toolchain), the native host
     library: its double-precision oracle within 0.06 of update_character
     on the card over 90 ticks, and a 240 x 4096 CGAS stream written by
     both codecs byte for byte the same.
  11. the oracle phase (`oracle_phase`): the JAX package's closed-form
     acceptance tests at full width through the tick graph, on maps that
     tests/torch_oracle_maps.py writes (tests/worldgen.py's box room,
     tests/test_solver_oracle.py's 55-degree ramp) and the port compiles
     on the card, 4096 lanes each from its own initial condition (seed
     0): a physbox dropped from 0.5-2 m (freefall within 1e-3 of the
     substepped closed form until 0.35 m above rest, no rebound above
     rest + 0.05, rest within 0.05 of -0.8) and an npc_john kicked at 1-4
     m/s in any heading after 120 ticks (deceleration over 10 ticks within
     [0.5, 1.5] mu g, below 0.15 m/s 30 ticks later; lanes outside that
     last bar must each show ROADMAP fault r's signature), K3 on every
     tick; the player at any yaw (rests at -0.55, walks 3.0 +- 0.1 m
     along its forward in 30 ticks, jumps 0.921 +- 0.06 and lands, walks
     into the walls for 240 ticks and stays inside them), K1 and K2; the
     npc on the 55-degree ramp from 0.5-1.5 m (slide acceleration within
     [0.5, 1.5] g (sin - mu cos), downhill); the lanes outside each bar, ms
     a tick and K1-K3 launches a tick of each rollout; the first 256 lanes
     against the CPU port on every tick under the parity bars (player
     2e-3, on_ground equal, actors 5e-3), which also holds them to every
     bar; then arena_lit (K4) and arena_orb (K5) under render/raster.py's
     CULL_MODE neg, pos, none and neg again through the render graph: each
     frame batch equal to render_batch_eager under the same mode, both
     passes of the kernel equal to its plain version, the live rows that
     reach the kernel, the last neg frames equal to the first.
The render path runs through its CUDA graphs (render/graph.py): on the
card render_batch and render_with_hud_batch replay one captured graph per
option set, the reveal overflow a conditional node in it. So phase 3 also
holds K4 to its plain version on the inputs the render options hand it (a
512 x 512 frame of ssaa 2 with aniso 4 and the debug wireframes); phase 4
also renders 4 envs of each option (a 100 x 128 xla frame, ssaa 2, aniso
4, the wireframes, render_with_hud with the synthetic HUD and viewmodel of
render/synthetic_hud.py) on the card against the CPU; and the render
phases of 6 are: the render graph phase (each sweep heading and a frame
batch with envs 0.12 m from a coin, graph against render_batch_eager bit
for bit, the overflow gate closed and open; the graphs' capture seconds
and pools; the replayed sweep under torch.profiler: no host sync, no HtoD
copy, the route's kernel twice a frame batch), the render main paths
timed through the graph and eagerly, and the HUD main path
(render_with_hud_batch over 64 envs x 256 x 256 of arena_lit: a
crosshair and a viewmodel on the frames; frames/s).
The last three lines are the card's name and power limit, a JSON object
with each kernel's launches, error, times and bound (and steps/s of the
graph and of the eager loop, the graphs, the per-replay figures, frames/s
of the render graphs and of the eager render, the long run and the
bench, the audio, mesh, action stream, demo, app and closing figures), and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BATCH, TICKS = 4096, 240
# arena_bodies' eager loop takes about 0.3 s a tick at 4096 envs: the graph
# phase holds 60 replays to 60 eager ticks; the profiled window is shorter
# still (a replay traces about 31,600 kernels, and a 24-replay window lost
# events)
BODIES_EAGER_TICKS, PROFILE_BODIES_TICKS = 60, 8
# arena's profiled window: a replay traces about 3,500 kernels, and a
# window of 240 replays (about 840,000 kernel records) held one replay's
# K1 and K2 launches fewer than the device counts in one run; 60 replays
# trace about as many records as arena_bodies' 8
PROFILE_ARENA_TICKS = 60
HALLS_EVERY = 101  # halls.json: every 101st surface is baked on the CPU too
LONG_RUN = ("arena", 40, 20, 256)  # map, ticks, segment, envs
DEMO = ("arena_lit", 2, 30)  # map, frames, ticks
# the audio phase: graphed ticks with the synthetic sounds, then one mix of
# every env, MIX_CHECK_ENVS of them held to the CPU
MIX_TICKS, MIX_CHECK_ENVS = 60, 64
# the mesh phase's cells: map, envs, ticks (shards of 2048 and of 256 envs,
# multiples of K1's 128-lane block)
MESH = (("arena", 4096, 240), ("arena_bodies", 512, 60))
# the multi-process phase: parallel/worker.py in PROCESSES processes on the
# one card, each cell's start and resume half (map, global envs, ticks a
# half); long_run under torch.distributed.run (map, ticks, segment, envs);
# the longest wait on one launch of the processes
MULTIPROCESS = (("arena", 4096, 120), ("arena_bodies", 4096, 30))
PROCESSES = 2
MP_LONG_RUN = ("arena", 40, 20, 256)
MP_LAUNCH_S = 300
# rollout_collect on the graph: more ticks than the graph's action stream
# holds (models/graph.py::CAP, 240), so it runs in two chunks
COLLECT_BATCH, COLLECT_TICKS = 256, 250
KERNELS = ("capsule_resolve", "ray_tris", "body_contacts", "raster_tiles", "raster_tiles_big")
# the render main path: bench_render's batch, size and sweep
RENDER_BATCH, SIZE, HEADINGS, RENDER_TICKS = 64, 256, 4, 60
FRAME_BAR = 0.002  # share of pixels that may differ by more than 1/255
# the app phase: in-game ticks each way of the session; tick + render_frame
# pairs counted for host syncs and timed
APP_TICKS, APP_SYNC_TICKS, APP_RATE_TICKS = 60, 5, 60
# the closing phase: ticks of the bench stream before the laser rays and
# of the single-env walk; ticks of long_run's per-env stream before the
# fault-f resolve; the bench stream's walk (core/step.py); the arena spawn
# (tests/torch_export_map.py::SPAWN) and the native oracle's start (2 m
# from two perimeter walls, which the walk slides along)
CLOSING_TICKS, FAULT_F_TICKS = 60, 480
WALK_SPEED, WALK_GRAVITY = 6.0, -9.81
SPAWN_ARENA, NATIVE_START = (9.0, 0.45, -2.0), (-20.0, 0.6, -20.0)
# envs of the laser rays also cast on the CPU (each env's rays see only its
# own actors)
LASER_CPU_ENVS = 256
# the oracle phase: lanes on the card (each from its own initial
# condition) and of them on the CPU; the maps (tests/torch_oracle_maps.py);
# the flat map's ticks before the kick and after it; the room's ticks (W
# from tick WALL_FROM into a wall); the ramp's
ORACLE_LANES, ORACLE_CPU_LANES = 4096, 256
ORACLE_MAPS = ("flat", "room", "ramp55")
FLAT_SETTLE, FLAT_KICK, ROOM_TICKS, WALL_FROM, RAMP_TICKS = 120, 40, 391, 151, 90
# ROADMAP fault r (a reference fault the port copies): a cylinder kicked
# across the floor's diagonal edge keeps creeping along it; the lanes
# outside the kinetic friction's at-rest bar that show its signature
FAULT_R = "of them creeping along the floor's diagonal edge (ROADMAP fault r)"

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


def graph_phase(name, cmap, ticks):
    """BATCH envs x `ticks` of the bench stream through the tick graph and
    through the eager loop: bit for bit, the same launches and gate
    counts. Returns both steps/s and the graph's capture figures."""
    from c_game_engine_tpu_torch.models.graph import tick_graph
    from c_game_engine_tpu_torch.models.graph_check import graph_and_eager, same_leaves
    from c_game_engine_tpu_torch.models.sim import bench_actions, reset_batch

    state = reset_batch(cmap, BATCH)
    runs = graph_and_eager(cmap, state, bench_actions(ticks, BATCH, "cuda"))
    (g, gk, gg, gs), (e, ek, eg, es) = runs["graph"], runs["eager"]
    n = same_leaves(f"graph phase {name}", g, e)
    if (gk, gg) != (ek, eg):
        raise AssertionError(f"graph phase {name}: graph counts {gk} {gg}, eager {ek} {eg}")
    graph = tick_graph(cmap, state)
    out = {"graph_steps_per_s": BATCH * ticks / gs, "eager_steps_per_s": BATCH * ticks / es, "ticks": ticks,
           "capture_s": graph.capture_s, "pool_bytes": graph.pool_bytes}
    print(f"graph phase {name}: {ticks} ticks x {BATCH} envs, graph equals the eager loop bit for bit "
          f"({n} leaves); graph {gs:.3f} s = {out['graph_steps_per_s']:.1f} steps/s, eager {es:.3f} s = "
          f"{out['eager_steps_per_s']:.1f} steps/s; launches {gk}, gates {gg} in both; capture "
          f"{graph.capture_s:.2f} s, pool {graph.pool_bytes / 2**20:.1f} MiB", flush=True)
    return out


def main_path(cmap, label):
    """240 ticks x 4096 envs through the map's tick graph (captured by an
    earlier phase; four replays first), with every count reset just
    before and read just after. Returns (final state, counts, seconds,
    gate ticks)."""
    import torch

    from c_game_engine_tpu_torch.models.graph_check import gate_counts, kernel_counts
    from c_game_engine_tpu_torch.models.sim import bench_actions, reset_batch, rollout
    from c_game_engine_tpu_torch.utils import counters

    acts = bench_actions(TICKS, BATCH, "cuda")
    rollout(cmap, reset_batch(cmap, BATCH), acts[:4])  # warm-up
    torch.cuda.synchronize()
    state = reset_batch(cmap, BATCH)
    torch.cuda.synchronize()
    counters.reset()
    t0 = time.perf_counter()
    state = rollout(cmap, state, acts)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kernel_counts()
    gate = gate_counts()["body_gate"]

    from c_game_engine_tpu_torch.core.state import tree_leaves

    for k, v in tree_leaves(state):
        if v.is_floating_point() and not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{label}: non-finite state leaf {k}")
        if not bool((v == v[:1]).all()):
            raise AssertionError(f"{label}: envs on one stream diverged in {k}")
    if int(state.tick[0]) != TICKS:
        raise AssertionError(f"{label}: tick {int(state.tick[0])} != {TICKS}")
    return state, counts, dt, gate


def profile_phase(name, cmap, ticks):
    """`ticks` replays of the tick graph from reset under torch.profiler:
    K1-K3 launches counted in the trace (K1 once a tick plus once a tick
    the stick gate opens, K2 once a tick, K3 once a tick the body gate
    opens, read from the device counts), and no host sync and no HtoD
    copy in the window."""
    from c_game_engine_tpu_torch.models.graph_check import gate_counts
    from c_game_engine_tpu_torch.models.sim import bench_actions, reset_batch
    from c_game_engine_tpu_torch.profile_tick import profile_rollout
    from c_game_engine_tpu_torch.utils import counters

    state, acts = reset_batch(cmap, BATCH), bench_actions(ticks, BATCH, "cuda")
    counters.reset()
    _, prof = profile_rollout(cmap, state, acts, "graph")
    opened = gate_counts()
    seen = {k: prof["kernels"].get(f"{k}_kernel", {}).get("launches", 0) for k in KERNELS[:3]}
    want = {"capsule_resolve": ticks + opened["stick_gate"], "ray_tris": ticks, "body_contacts": opened["body_gate"]}
    if seen != want:
        raise AssertionError(f"profile {name}: the trace holds launches {seen}, expected {want}")
    if prof["host_syncs_per_tick"] != 0 or prof["memcpy_htod_per_tick"] != 0:
        raise AssertionError(f"profile {name}: {prof['host_syncs_per_tick']} host syncs and "
                             f"{prof['memcpy_htod_per_tick']} HtoD copies per replayed tick")
    print(f"profile {name}: {ticks} replays, launches in the trace {seen}; per tick: "
          f"{prof['host_syncs_per_tick']} host syncs, {prof['memcpy_htod_per_tick']} HtoD, "
          f"{prof['memcpy_dtoh_per_tick']} DtoH, host {prof['host_per_tick']}, device "
          f"{prof['device_ms_per_tick']:.3f} ms, wall {prof['wall_ms_per_tick']:.3f} ms, "
          f"busy {prof['busy_share']:.3f}", flush=True)
    return {**prof, "trace_launches": seen}


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
    from c_game_engine_tpu_torch.models.graph_check import kernel_counts
    from c_game_engine_tpu_torch.profile_render import render_calls

    before = kernel_counts()
    seen = render_calls(module, fn_name, bundle, cmap, state, SIZE)
    return seen, {k: v - before[k] for k, v in kernel_counts().items()}


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
    hands it: pass 1 and the reveal pass, all 12 planes bit for bit, and
    likewise on the inputs of a 512 x 512 frame batch with ssaa 2, aniso 4
    and the debug wireframes; the card path runs no `bin_triangles` (the
    kernel bins). Also times the
    binning ops that the kernel replaced (`bin_triangles` on pass 1's
    inputs, as the wrapper before the fused kernel ran it once per frame
    batch), so that a run of the earlier tree can add them to its kernel's
    time."""
    import torch

    from c_game_engine_tpu_torch.ops import raster_tiles as K4
    from c_game_engine_tpu_torch.profile_render import render_calls

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
    # the inputs the render options hand K4: 512 x 512 (ssaa 2), the
    # wireframe quads' rows, aniso's levels in the enc column
    for label, (a, k) in zip(("options pass1", "options reveal"),
                             render_calls(K4, "raster_tiles_binned", bundle, cmap, state, SIZE, ssaa=2, aniso=4,
                                          debug_wireframe=True)):
        compare(label, K4.raster_tiles_binned(*a, **k), K4.raster_tiles_binned_plain(*a, **k))
        print(f"K4 raster_tiles {label} ({a[0].shape[0]} envs x {a[2]}x{a[3]}, T {a[0].shape[1]}): "
              f"bitwise equal", flush=True)
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


def render_reference_phase(name, cmap, bundle, cpu):
    """4 envs of the map `name` after 30 ticks of the stream, each at its
    own sweep heading, rendered on the card and by the plain path on the
    CPU (`cpu`: the same map and bundle there)."""
    import math

    import torch

    from c_game_engine_tpu_torch.core.state import tree_map
    from c_game_engine_tpu_torch.models.sim import bench_actions, reset_batch, rollout
    from c_game_engine_tpu_torch.render.raster import render_batch

    cm_cpu, rb_cpu = cpu
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


def render_graph_phase(name, cmap, bundle, state, kernel):
    """The map's render graph against render_batch_eager on the card, bit
    for bit, on each sweep heading (the overflow gate closed on some and
    open on others where the sweep overflows) and on a frame batch with
    every eighth env 0.12 m from a coin (open); then the sweep profiled
    eagerly and as graph replays: per replayed frame batch no host sync,
    no HtoD copy, and `kernel` twice in the trace. Returns the profiles and
    the gate states."""
    from c_game_engine_tpu_torch.profile_render import profile_sweep
    from c_game_engine_tpu_torch.render.graph_check import graph_against_eager, overflow_states
    from c_game_engine_tpu_torch.render.raster import yaw_sweep

    states = yaw_sweep(state, HEADINGS)
    opened = [graph_against_eager(bundle, cmap, s, SIZE, SIZE)[1] for s in states]
    _, forced = graph_against_eager(bundle, cmap, overflow_states(states[0], list(range(0, RENDER_BATCH, 8))),
                                    SIZE, SIZE)
    if not forced or all(opened):
        raise AssertionError(f"render graph {name}: gate open by heading {opened}, forced {forced}: "
                             "each side must be held")
    prof = {mode: profile_sweep(bundle, cmap, states, SIZE, mode) for mode in ("eager", "graph")}
    g = prof["graph"]
    other = ({"raster_tiles", "raster_tiles_big"} - {kernel}).pop()
    if g[kernel]["launches"] != 2 * HEADINGS or g[other]["launches"] != 0:
        raise AssertionError(f"render graph {name}: the trace of {HEADINGS} replays holds {kernel} "
                             f"{g[kernel]['launches']} and {other} {g[other]['launches']} times")
    if g["host_syncs_per_frame_batch"] != 0 or g["memcpy_htod_per_frame_batch"] != 0:
        raise AssertionError(f"render graph {name}: {g['host_syncs_per_frame_batch']} host syncs and "
                             f"{g['memcpy_htod_per_frame_batch']} HtoD copies per replayed frame batch")
    for mode, p in prof.items():
        print(f"render {mode} {name}, per frame batch of {RENDER_BATCH} x {SIZE}x{SIZE}: wall "
              f"{p['wall_ms_per_frame_batch']:.3f} ms, device {p['device_ms_per_frame_batch']:.3f} ms, busy "
              f"{p['busy_share']:.3f}, device launches {p['launches_per_frame_batch']:.1f}, host "
              f"{p['host_per_frame_batch']}, host syncs {p['host_syncs_per_frame_batch']}, HtoD "
              f"{p['memcpy_htod_per_frame_batch']}, DtoH {p['memcpy_dtoh_per_frame_batch']}, {kernel} "
              f"{p[kernel]['ms_per_launch']:.4f} ms a launch", flush=True)
    print(f"render graph {name}: graph equals render_batch_eager bit for bit on {HEADINGS} headings (gate open "
          f"{opened}) and with every eighth env 0.12 m from a coin (open)", flush=True)
    return {"gate_open_by_heading": opened, "profile": prof}


def render_main_path(cmap, bundle, state, kernel):
    """The sweep once as warm-up (coverage checked there, as bench_render
    does), then once timed through the map's render graph with every
    launch counter reset just before and read just after, then once timed
    eagerly (render_batch_eager); `kernel` is the raster kernel of the
    map's route, which must launch twice per frame batch, and the other
    none. Returns (counts, graph seconds, eager seconds, coverages)."""
    import torch

    from c_game_engine_tpu_torch.models.graph_check import kernel_counts
    from c_game_engine_tpu_torch.render.raster import render_batch, render_batch_eager, yaw_sweep
    from c_game_engine_tpu_torch.utils import counters

    states = yaw_sweep(state, HEADINGS)
    warm = [render_batch(bundle, cmap, s, SIZE, SIZE) for s in states]
    covs = [coverage(f[0]) for f in warm]
    torch.cuda.synchronize()
    counters.reset()
    t0 = time.perf_counter()
    frames = [render_batch(bundle, cmap, s, SIZE, SIZE) for s in states]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kernel_counts()
    t0 = time.perf_counter()
    eager = [render_batch_eager(bundle, cmap, s, SIZE, SIZE) for s in states]
    torch.cuda.synchronize()
    dt_eager = time.perf_counter() - t0
    for k, (f, w, e) in enumerate(zip(frames, warm, eager)):
        if f.shape != (RENDER_BATCH, SIZE, SIZE, 3) or not bool(torch.isfinite(f).all()):
            raise AssertionError(f"render heading {k}: frames {tuple(f.shape)} not finite")
        if not (torch.equal(f, w) and torch.equal(f, e)):
            raise AssertionError(f"render heading {k}: the timed frames differ from the warm-up's or the eager ones")
    if min(covs) < 0.03:
        raise AssertionError(f"render: sweep non-sky coverage {covs} below 0.03")
    other = ({"raster_tiles", "raster_tiles_big"} - {kernel}).pop()
    if counts[kernel] != 2 * HEADINGS or counts[other] != 0:
        raise AssertionError(f"render: {kernel} launched {counts[kernel]} times and {other} "
                             f"{counts[other]} times for {HEADINGS} frame batches")
    return counts, dt, dt_eager, covs


def options_reference_phase(cmap, bundle, cpu):
    """4 envs of arena_lit after 30 ticks, each at its own sweep heading,
    rendered with each option of render/graph_check.py's OPTIONS on the
    card (through its graph, held to render_batch_eager bit for bit) and
    by the plain path on the CPU, and render_with_hud_batch with the
    synthetic HUD and viewmodel likewise: at most FRAME_BAR of pixels off
    by more than 1/255."""
    import math

    import torch

    from c_game_engine_tpu_torch.core.state import tree_map
    from c_game_engine_tpu_torch.models.sim import bench_actions, reset_batch, rollout
    from c_game_engine_tpu_torch.render import raster as R
    from c_game_engine_tpu_torch.render.graph_check import OPTIONS, graph_against_eager
    from c_game_engine_tpu_torch.render.synthetic_hud import hud_states, with_synthetic_hud

    cm_cpu, rb_cpu = cpu
    st = rollout(cm_cpu, reset_batch(cm_cpu, HEADINGS), bench_actions(30, HEADINGS, "cpu"))
    st = st.replace(player=st.player.replace(
        yaw=st.player.yaw + torch.arange(HEADINGS) * (2.0 * math.pi / HEADINGS)))
    gst = tree_map(lambda x: x.cuda(), st)
    out = {}
    for label, h, w, kw in OPTIONS + (("hud", SIZE, SIZE, None),):
        if kw is None:
            gpu = R.render_with_hud_batch(with_synthetic_hud(bundle), cmap, hud_states(gst), h, w)
            cpu = R.render_with_hud_batch(with_synthetic_hud(rb_cpu), cm_cpu, hud_states(st), h, w)
        else:
            gpu, _ = graph_against_eager(bundle, cmap, gst, h, w, **kw)
            cpu = R.render_batch(rb_cpu, cm_cpu, st, h, w, **kw)
        off = ((gpu.cpu() - cpu).abs().amax(-1) > 1 / 255).float().mean()
        out[label] = float(off)
        if not out[label] <= FRAME_BAR or not bool(torch.isfinite(gpu).all()):
            raise AssertionError(f"render option {label}: {out[label]:.4%} of pixels differ from the CPU by more "
                                 "than 1/255")
        print(f"reference render option {label}: {HEADINGS} envs x {h}x{w} on the card (graph, bit-equal to the "
              f"eager render) match the CPU plain path ({out[label]:.4%} of pixels off by more than 1/255)",
              flush=True)
    return out


def hud_main_path(cmap, bundle, state):
    """render_with_hud_batch over RENDER_BATCH envs x SIZE x SIZE with the
    synthetic HUD and viewmodel and the HUD values of
    synthetic_hud.hud_states: once as warm-up (the graph's capture), once
    timed through the graph with every count reset just before and read
    just after (K4 twice), once timed eagerly; frames equal, finite, and a
    crosshair and a viewmodel on every env that shows them. Returns
    (counts, graph seconds, eager seconds)."""
    import torch

    from c_game_engine_tpu_torch.models.graph_check import kernel_counts
    from c_game_engine_tpu_torch.render import raster as R
    from c_game_engine_tpu_torch.render.synthetic_hud import hud_states, with_synthetic_hud
    from c_game_engine_tpu_torch.utils import counters

    hb, st = with_synthetic_hud(bundle), hud_states(state)
    warm = R.render_with_hud_batch(hb, cmap, st, SIZE, SIZE)
    torch.cuda.synchronize()
    counters.reset()
    t0 = time.perf_counter()
    frames = R.render_with_hud_batch(hb, cmap, st, SIZE, SIZE)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kernel_counts()
    t0 = time.perf_counter()
    eager = R.render_with_hud_batch_eager(hb, cmap, st, SIZE, SIZE)
    torch.cuda.synchronize()
    dt_eager = time.perf_counter() - t0
    if not (torch.equal(frames, warm) and torch.equal(frames, eager) and bool(torch.isfinite(frames).all())):
        raise AssertionError("hud: the graph's frames differ from the warm-up's or the eager ones, or are not finite")
    if counts["raster_tiles"] != 2 or counts["raster_tiles_big"] != 0:
        raise AssertionError(f"hud: launches {counts} for one frame batch")
    world = R.render_batch(hb, cmap, st, SIZE, SIZE)
    vm = R.render_viewmodel_batch(hb, st, world)
    mid = slice(SIZE // 2 - 12, SIZE // 2 + 12)
    cross = (frames[:, mid, mid] != vm[:, mid, mid]).any(-1).float().mean((1, 2))
    vm_px = (vm != world).any(-1).sum((1, 2))
    show = st.camera_actor < 0
    want_cross, want_vm = show & (st.player.crosshair != 2), show & (st.save.current_item == 0)
    if not bool((cross[want_cross] > 0.2).all() and (vm_px[want_vm] > 100).all() and (vm_px[~want_vm] == 0).all()):
        raise AssertionError(f"hud: crosshair shares {cross.tolist()}, viewmodel pixels {vm_px.tolist()}")
    print(f"hud frames: crosshair on {int(want_cross.sum())} envs (at least {float(cross[want_cross].min()):.2f} of "
          f"its square), viewmodel on {int(want_vm.sum())} envs (at least {int(vm_px[want_vm].min())} pixels)",
          flush=True)
    return counts, dt, dt_eager


def host_syncs(fn):
    """(fn(), how many synchronizing CUDA calls it made): torch.cuda's sync
    debug mode at its warning level, each warning counted. A deliberate
    sync is counted first, so a count of 0 means none was made."""
    import warnings

    import torch

    def counted(f):
        torch.cuda.synchronize()
        prev = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = f()
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        return out, sum("synchroniz" in str(w.message) for w in seen)

    if counted(lambda: int(torch.ones(1, device="cuda").sum()))[1] < 1:
        raise AssertionError("host sync count: the sync debug mode did not see a deliberate sync")
    return counted(fn)


def audio_phase(arena, card):
    """MIX_TICKS graphed ticks of the bench stream on arena at BATCH envs
    with the synthetic sounds (audio/synthetic_sounds.py), the channel
    tables then overwritten by `audio_states`; mix_frame of every env's
    SAMPLES_PER_TICK samples at its listener, timed with CUDA events, and
    MIX_CHECK_ENVS of the envs held to the CPU plain path on the same
    inputs (abs and rel 1e-5). The bound: the bytes the function must move
    (its output written once; the channel tables, the bank's PCM and
    table, the listeners and the volumes read once) over the memory rate.
    The [B, C, n, 2] block that the PyTorch formulation gathers is its own
    intermediate, printed beside it, not in the bound."""
    import tempfile

    import torch

    from c_game_engine_tpu_torch.audio.bank import SAMPLES_PER_TICK
    from c_game_engine_tpu_torch.audio.mixer import NUM_CHANNELS, listener_from_state, mix_frame
    from c_game_engine_tpu_torch.audio.synthetic_sounds import audio_states, with_synthetic_sounds
    from c_game_engine_tpu_torch.core.state import tree_leaves, tree_map
    from c_game_engine_tpu_torch.models.sim import bench_actions, reset_batch, rollout

    with tempfile.TemporaryDirectory() as tmp:
        cm, bank = with_synthetic_sounds(arena, tmp)
    st = rollout(cm, reset_batch(cm, BATCH), bench_actions(MIX_TICKS, BATCH, "cuda"))
    plays = int(st.sound_plays.min())
    if plays < 2:
        raise AssertionError(f"audio: {plays} sound plays in {MIX_TICKS} ticks (the first_tick click and the cling)")
    st = audio_states(st, seed=0)
    vols = torch.tensor([0.8, 0.6, 1.0, 0.5], device="cuda")
    pos, quat = listener_from_state(st)
    mix = lambda: mix_frame(bank, st.audio, pos, quat, vols, SAMPLES_PER_TICK)
    out = mix()
    ms = cuda_time(mix, reps=10)
    sel = torch.arange(0, BATCH, BATCH // MIX_CHECK_ENVS, device="cuda")
    cpu = lambda x: x[sel].cpu()
    plain = mix_frame(tree_map(lambda x: x.cpu(), bank), tree_map(cpu, st.audio), cpu(pos), cpu(quat), vols.cpu(),
                      SAMPLES_PER_TICK)
    got = out[sel].cpu()
    err = float((got - plain).abs().max())
    if out.shape != (BATCH, SAMPLES_PER_TICK, 2) or not torch.allclose(got, plain, atol=1e-5, rtol=1e-5):
        raise AssertionError(f"audio: mix {tuple(out.shape)} off the CPU plain path by up to {err}")
    if float(out.abs().max()) <= 0.0:
        raise AssertionError("audio: the mix is silent")
    gathered = BATCH * NUM_CHANNELS * SAMPLES_PER_TICK * 2 * 4
    nbytes = sum(x.numel() * x.element_size() for x in (out, bank.pcm, bank.table, pos, quat, vols,
                                                         *(leaf for _, leaf in tree_leaves(st.audio))))
    bound = nbytes / PEAK_BYTES * 1e3
    print(f"audio: mix_frame of {BATCH} envs x {NUM_CHANNELS} channels x {SAMPLES_PER_TICK} samples "
          f"{ms:.4f} ms a mix, bound {bound:.4f} ms ({nbytes / 1e6:.3f} MB moved; the formulation's gathered "
          f"block {gathered / 1e9:.3f} GB is not counted) on {card}; "
          f"{MIX_CHECK_ENVS} envs equal the CPU plain path within 1e-5 (max abs error {err:.3g}); "
          f"{plays} sound plays a env in {MIX_TICKS} ticks", flush=True)
    return {"envs": BATCH, "samples": SAMPLES_PER_TICK, "ms": ms, "bound_ms": bound, "bound_by": "bytes",
            "bound_bytes": nbytes, "gathered_bytes": gathered, "max_abs_err": err, "sound_plays_per_env": plays}


def mesh_phase(cmaps, card):
    """MESH's cells over make_mesh() and over a 2-entry mesh of the one
    card, each env on long_run.walk_and_turn's per-env actions. arena runs
    sharded_rollout (parallel/mesh.py) from a fresh batch; arena_bodies
    starts from graph_check.half_asleep, whose back half's bodies sleep,
    and its two shards must open the body gate on different numbers of
    ticks (the back shard's stays closed until a player wakes a body). The
    final state equals the unsharded rollout's bit for bit (this first
    call captures each shard's graph); then the shards are launched again
    with their host syncs counted (0), timed, and checked once more, with
    the kernels' launches counted. Returns ({cell: figures}, {path:
    counts})."""
    import torch

    from c_game_engine_tpu_torch.long_run import walk_and_turn
    from c_game_engine_tpu_torch.models.graph import tick_graph
    from c_game_engine_tpu_torch.models.graph_check import half_asleep, kernel_counts, same_leaves
    from c_game_engine_tpu_torch.models.sim import reset_batch, rollout
    from c_game_engine_tpu_torch.parallel.mesh import (
        gather_states,
        make_mesh,
        rollout_shards,
        shard_sim,
        sharded_rollout,
        split,
    )
    from c_game_engine_tpu_torch.utils import counters

    def gate_ticks(fn):
        torch.cuda.synchronize()
        counters.reset()
        fn()
        torch.cuda.synchronize()
        return counters.read("body_gate")

    out, paths = {}, {}
    for name, batch, ticks in MESH:
        cm = cmaps[name]
        stream = walk_and_turn(ticks, batch, "cuda")
        state = reset_batch(cm, batch) if name == "arena" else half_asleep(cm, batch)
        tick_graph(cm, state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        whole = rollout(cm, state, stream)
        torch.cuda.synchronize()
        unsharded = batch * ticks / (time.perf_counter() - t0)
        cell = {"envs": batch, "ticks": ticks, "unsharded_steps_per_s": unsharded}
        for label, mesh in (("make_mesh", make_mesh()), ("two_on_one_card", make_mesh(devices=["cuda:0"] * 2))):
            shard_maps = shard_sim(cm, batch, mesh)[0]
            streams = split(stream, mesh, axis=1)
            if name == "arena":
                final, _ = sharded_rollout(cm, mesh, batch, ticks, stream[0])
            else:
                final = gather_states(rollout_shards(shard_maps, split(state, mesh), streams))
            n = same_leaves(f"mesh {name} over {label}", whole, final)
            gates = ""
            if name == "arena_bodies":
                opened = [gate_ticks(lambda: rollout(cm, state, stream))]
                opened += [gate_ticks(lambda: rollout_shards([m], [s], [a]))
                           for m, s, a in zip(shard_maps, split(state, mesh), streams)]
                if len(mesh) > 1 and len(set(opened[1:])) < 2:
                    raise AssertionError(f"mesh {name} over {label}: body gate open ticks {opened} (whole, "
                                         "shards): the shards open it alike, so the split is not exercised")
                cell.setdefault("body_gate_ticks", {})[label] = opened
                gates = f"; body gate open on {opened[0]} ticks whole, {opened[1:]} in the shards"
            states = split(state, mesh)
            start = {}

            def launch():
                start["t"] = time.perf_counter()
                return rollout_shards(shard_maps, states, streams)

            counters.reset()
            parts, syncs = host_syncs(launch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - start["t"]
            counts = kernel_counts()
            final = gather_states(parts)
            same_leaves(f"mesh {name} over {label}, timed", whole, final)
            want = {"capsule_resolve": ticks * len(mesh), "ray_tris": ticks * len(mesh)}
            if name == "arena_bodies":
                want["body_contacts"] = 1
            low = {k: counts[k] for k, v in want.items() if counts[k] < v}
            if syncs or low:
                raise AssertionError(f"mesh {name} over {label}: {syncs} host syncs, launches {counts}")
            steps = batch * ticks / dt
            paths[f"mesh_{name}_{label}"] = {"counts": counts, "steps_per_s": steps}
            cell[label] = {"shards": len(mesh), "steps_per_s": steps, "host_syncs": syncs,
                           "mean_player_y": float(final.player.pos[:, 1].mean()),
                           "mean_coins": float(final.save.coins.float().mean()), "launches": counts}
            print(f"mesh {name}: {len(mesh)} shard(s) of {batch // len(mesh)} envs ({label}) x {ticks} ticks equal "
                  f"the unsharded rollout bit for bit ({n} leaves){gates}; {steps:.1f} steps/s sharded, "
                  f"{unsharded:.1f} unsharded on {card}; {syncs} host syncs between the shards' launches; mean "
                  f"player y {cell[label]['mean_player_y']:.4f}, mean coins {cell[label]['mean_coins']:.4f}; "
                  f"launches {counts}", flush=True)
        out[name] = cell
    return out, paths


def action_stream_phase(arena):
    """TICKS x BATCH of long_run.walk_and_turn's stream recorded tick by
    tick with ActionRecorder, saved as a CGAS file and loaded back onto the
    card: equal to the recorded stream, and its rollout equal to the
    original stream's bit for bit. Returns (figures, the replay's kernel
    launches)."""
    import tempfile

    import torch

    from c_game_engine_tpu_torch.core.actions_io import ActionRecorder, load_actions, save_actions
    from c_game_engine_tpu_torch.long_run import walk_and_turn
    from c_game_engine_tpu_torch.models.graph_check import kernel_counts, same_leaves
    from c_game_engine_tpu_torch.models.sim import reset_batch, rollout
    from c_game_engine_tpu_torch.utils import counters

    stream = walk_and_turn(TICKS, BATCH, "cuda")
    rec = ActionRecorder()
    for t in range(TICKS):
        rec.record(stream[t])
    recorded = rec.stream()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "walk_and_turn.cgas"
        t0 = time.perf_counter()
        save_actions(path, recorded, native=False)
        save_s = time.perf_counter() - t0
        size = path.stat().st_size
        t0 = time.perf_counter()
        loaded = load_actions(path, native=False, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    for f in ("move", "look", "buttons"):
        if not torch.equal(getattr(loaded, f), getattr(recorded, f)):
            raise AssertionError(f"action stream: loaded {f} differs from the recorded one")
    original = rollout(arena, reset_batch(arena, BATCH), stream)
    torch.cuda.synchronize()
    counters.reset()
    replay = rollout(arena, reset_batch(arena, BATCH), loaded)
    torch.cuda.synchronize()
    counts = kernel_counts()
    n = same_leaves("action stream replay", original, replay)
    if counts["capsule_resolve"] < TICKS or counts["ray_tris"] < TICKS:
        raise AssertionError(f"action stream replay: launches {counts}")
    print(f"action stream: {TICKS} ticks x {BATCH} envs recorded, saved ({size:,} bytes in {save_s:.3f} s) and "
          f"loaded onto the card ({load_s:.3f} s) unchanged; its rollout equals the original's bit for bit "
          f"({n} leaves); launches {counts}", flush=True)
    return {"ticks": TICKS, "envs": BATCH, "bytes": size, "save_s": save_s, "load_s": load_s}, counts


def _launch(cmds, env=None, limit=MP_LAUNCH_S):
    """Run the commands at once from the repo root: [(rc, stdout, stderr)].
    Each runs in a session of its own, which is killed whole (torchrun's
    workers too) when its wait ends, so nothing started here outlives the
    call; a command still running after `limit` seconds fails."""
    import signal
    import subprocess

    procs = [subprocess.Popen(c, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              start_new_session=True) for c in cmds]
    out, deadline = [], time.monotonic() + limit
    try:
        for p in procs:
            o, e = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            out.append((p.returncode, o, e))
    finally:
        for p in procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.communicate()
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def multiprocess_phase(card):
    """The multi-process tier on the one card (parallel/distributed.py):
    for each MULTIPROCESS cell, parallel/worker.py in PROCESSES processes
    of a gloo group, `start` (a fresh global batch, the ticks of
    long_run.walk_and_turn's per-env stream through sharded_rollout, a
    distributed checkpoint that process 0 writes) and then, in a fresh
    group, `resume` (each process restores its envs of the checkpoint and
    steps the ticks again; the gathered final state written the same way).
    Each half is held bit for bit, every leaf, to the one-process rollout
    of the global batch through the tick graph, the start half's metrics
    to the one-process reduction; each process's kernel launches (counts
    reset after its graph's capture) against the one-process counts: no
    process launches a kernel more often than one process does, and the
    processes together launch it at least as often and at most PROCESSES
    times as often (K2 every tick; K1's stick launch and K3 are gated per
    process); only process 0 writes a file. Then long_run under
    `torch.distributed.run --standalone --nproc_per_node PROCESSES`
    (MP_LONG_RUN), its resume proof passing. A process that fails fails
    the phase. Returns (figures, {path: counts})."""
    import numpy as np
    import torch

    from c_game_engine_tpu_torch.long_run import walk_and_turn
    from c_game_engine_tpu_torch.models.graph import tick_graph
    from c_game_engine_tpu_torch.models.graph_check import kernel_counts, same_leaves
    from c_game_engine_tpu_torch.models.sim import load_named_map, reset_batch, rollout
    from c_game_engine_tpu_torch.utils import counters
    from c_game_engine_tpu_torch.utils.checkpoint import load_checkpoint

    t_phase = time.perf_counter()
    root = ROOT / "build" / "multiprocess"
    shutil.rmtree(root, ignore_errors=True)
    figures, paths = {}, {}
    for name, batch, ticks in MULTIPROCESS:
        out = root / name
        recs, launch_s = {}, {}
        for phase in ("start", "resume"):
            port = _free_port()
            cmds = [[sys.executable, "-m", "c_game_engine_tpu_torch.parallel.worker", phase, str(out),
                     "--coordinator", f"127.0.0.1:{port}", "--processes", str(PROCESSES), "--rank", str(r),
                     "--map", name, "--batch", str(batch), "--ticks", str(ticks)] for r in range(PROCESSES)]
            t0 = time.perf_counter()
            results = _launch(cmds)
            launch_s[phase] = time.perf_counter() - t0
            for r, (rc, o, e) in enumerate(results):
                if rc != 0 or not o.strip().endswith("WORKER_OK"):
                    raise AssertionError(f"multi-process {name} {phase}: process {r} exited {rc}:\n{o[-2000:]}\n"
                                         f"{e[-4000:]}")
            recs[phase] = [json.loads((out / f"rank{r}_{phase}.json").read_text()) for r in range(PROCESSES)]

        # one process, the same global batch and stream, through the tick graph
        cm = load_named_map(name, "cuda")
        stream = walk_and_turn(ticks, batch, "cuda")
        state = reset_batch(cm, batch)
        tick_graph(cm, state)
        cell = {"envs": batch, "ticks_a_half": ticks, "processes": PROCESSES}
        total = {k: 0 for k in KERNELS}
        for phase, ck in (("start", "ckpt.npz"), ("resume", "final.npz")):
            torch.cuda.synchronize()
            counters.reset()
            t0 = time.perf_counter()
            state = rollout(cm, state, stream)
            torch.cuda.synchronize()
            one_s = time.perf_counter() - t0
            one = kernel_counts()
            n = same_leaves(f"multi-process {name} {phase}", state, load_checkpoint(out / ck, state))
            pos = np.load(out / f"pos_{phase}.npy")
            if not np.array_equal(pos, state.player.pos.cpu().numpy()):
                raise AssertionError(f"multi-process {name} {phase}: the gathered positions differ")
            rs = recs[phase]
            if phase == "start":
                want = {"mean_player_y": float(state.player.pos[:, 1].mean()),
                        "mean_coins": float(state.save.coins.float().mean()), "ticks": float(state.tick[0])}
                if any(r["metrics"] != want for r in rs):
                    raise AssertionError(f"multi-process {name}: metrics {[r['metrics'] for r in rs]}, one process "
                                         f"{want}")
            ranks = [r["launches"] for r in rs]
            summed = {k: sum(c[k] for c in ranks) for k in KERNELS}
            gated = ("capsule_resolve", "ray_tris") + (("body_contacts",) if name == "arena_bodies" else ())
            bad = [k for k in gated if not max(c[k] for c in ranks) <= one[k] <= summed[k] <= PROCESSES * one[k]]
            if bad or any(c["capsule_resolve"] < ticks or c["ray_tris"] < ticks for c in ranks) or any(
                    c[k] for c in ranks for k in KERNELS if k not in gated):
                raise AssertionError(f"multi-process {name} {phase}: launches {ranks}, one process {one}")
            writers = [r["rank"] for r in rs if r["writes"]]
            if writers != [0] or len({r["checkpoint_mtime_ns"] for r in rs}) != 1:
                raise AssertionError(f"multi-process {name} {phase}: files written by processes {writers}, "
                                     f"checkpoint mtimes {[r['checkpoint_mtime_ns'] for r in rs]}")
            for k in KERNELS:
                total[k] += summed[k]
            together = batch * ticks / (max(r["wall"][1] for r in rs) - min(r["wall"][0] for r in rs))
            cell[phase] = {
                "steps_per_s_by_process": [r["steps_per_s"] for r in rs], "steps_per_s_together": together,
                "one_process_steps_per_s": batch * ticks / one_s, "launches_by_process": ranks,
                "one_process_launches": one, "capture_s_by_process": [r["capture_s"] for r in rs],
                "checkpoint_s_by_process": [r["checkpoint_s"] for r in rs], "launch_s": launch_s[phase],
                "leaves": n}
            print(f"multi-process {name} {phase}: {PROCESSES} processes x {batch // PROCESSES} envs x {ticks} ticks "
                  f"on one card equal one process's {batch} envs bit for bit ({n} leaves"
                  f"{', and its metrics' if phase == 'start' else ''}); steps/s "
                  f"{[round(r['steps_per_s'], 1) for r in rs]} by process, {together:.1f} together, "
                  f"{batch * ticks / one_s:.1f} in one process on {card}; checkpoint gather + write "
                  f"{[round(r['checkpoint_s'], 3) for r in rs]} s by process (written by process 0 only); "
                  f"launch {launch_s[phase]:.1f} s; launches {ranks}, one process {one}", flush=True)
        paths[f"multiprocess_{name}"] = {"counts": total}
        figures[name] = cell

    name, ticks, segment, envs = MP_LONG_RUN
    env = dict(os.environ, CGE_BATCH=str(envs), CGE_CKDIR=str(root / "long_run"), PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    ((rc, o, e),) = _launch([[sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
                              str(PROCESSES), "-m", "c_game_engine_tpu_torch.long_run", name, str(ticks),
                              str(segment)]], env)
    lr_s = time.perf_counter() - t0
    if rc or "BITWISE equal" not in o or f"in each of {PROCESSES} processes" not in o:
        raise AssertionError(f"long_run under torch.distributed.run exited {rc}:\n{o[-2000:]}\n{e[-4000:]}")
    for line in o.strip().splitlines():
        print(f"long_run x {PROCESSES} processes: {line}", flush=True)
    figures["long_run"] = {"map": name, "ticks": ticks, "segment": segment, "envs": envs, "processes": PROCESSES,
                           "seconds": lr_s}
    figures["phase_s"] = time.perf_counter() - t_phase
    print(f"multi-process phase: {figures['phase_s']:.1f} s", flush=True)
    return figures, paths


def entry_points_phase(card):
    """The entry points around the graph: a long_run resume proof at a small
    size (LONG_RUN) over make_mesh(), one bench call (4096 envs x 240 ticks
    of arena; its card must be this card), one entry() step,
    dryrun_multichip(2) on the card and the demo (DEMO: arena_lit, the
    single-env step, a 160 x 160 HUD frame every ticks // frames ticks, the
    mix of every tick): its WAV's peak above 0 (the first_tick click),
    each frame's non-sky coverage at least 0.03, its tick count. Returns
    (figures, the demo's kernel launches)."""
    import tempfile

    import torch

    from c_game_engine_tpu_torch import bench, demo, long_run
    from c_game_engine_tpu_torch.entry import dryrun_multichip, entry
    from c_game_engine_tpu_torch.models.graph_check import kernel_counts
    from c_game_engine_tpu_torch.utils import counters

    name, total, segment, batch = LONG_RUN
    run = long_run.run(name, total, segment, batch, "cuda", ROOT / "build" / "long_run",
                       log=lambda line: print(f"long_run: {line}", flush=True))
    b = bench.bench("arena", BATCH, TICKS)
    if f"{b['card']}, {b['power_limit']}" != card or b["map"] != "arena":
        raise AssertionError(f"bench names card {b['card']}, {b['power_limit']} and map {b['map']}")
    print(f"bench: {json.dumps(b)}", flush=True)
    fn, args = entry()
    out = fn(*args)
    if int(out.tick[0]) != 1 or not bool(torch.isfinite(out.player.pos).all()) or out.tick.shape != (256,):
        raise AssertionError("entry(): the graphed step did not advance 256 envs by one finite tick")
    print("entry(): ok, one graphed tick of 256 envs on arena", flush=True)
    dry = dryrun_multichip(2)
    if not torch.isfinite(torch.tensor(dry)):
        raise AssertionError(f"dryrun_multichip(2): metric {dry}")

    map_name, frames, ticks = DEMO
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        counters.reset()
        d = demo.run(tmp, map_name, frames, ticks, "cuda", log=lambda line: print(f"demo: {line}", flush=True))
        torch.cuda.synchronize()
        counts = kernel_counts()
        written = d["image"].stat().st_size > 0 and d["wav"].stat().st_size > 44
    covs = [coverage(f) for f in d["frames"]]
    if (d["ticks"] != ticks or len(covs) != frames or min(covs) < 0.03 or not d["peak"] > 0 or not written
            or counts["capsule_resolve"] < ticks or counts["ray_tris"] < ticks):
        raise AssertionError(f"demo: tick {d['ticks']}, coverage {covs}, peak {d['peak']}, written {written}, "
                             f"launches {counts}")
    print(f"demo {map_name}: {ticks} ticks, {frames} frames (non-sky coverage {[round(c, 4) for c in covs]}), "
          f"WAV peak {d['peak']:.4f} over {d['samples']} samples, {d['play_events']} play events, in "
          f"{d['seconds']:.2f} s on {card}; launches {counts}", flush=True)
    demo_out = {"map": map_name, "ticks": ticks, "frames": frames, "coverage": covs, "peak": d["peak"],
                "play_events": d["play_events"], "seconds": d["seconds"]}
    return {"long_run": {k: run[k] for k in ("map", "batch", "ticks", "segment", "devices", "leaves",
                                             "env_steps_per_s")},
            "bench": b, "dryrun_multichip_metric": dry, "demo": demo_out}, counts


def _widget_contrast(frame, bg, sd):
    """The least share, over the stack's controls, of the pixels of a
    control's rect (virtual units scaled to the frame, clipped to it) that
    differ from the background by more than 1/255: how much of its rect
    the faintest widget drew on (a checkbox draws its box and label only;
    the video options' last one lies half below the frame)."""
    h, w = frame.shape[:2]
    least = float("inf")
    for x0, y0, cw, ch in sd.rect:
        xs = slice(max(int(x0 * w / 640), 0), min(int((x0 + cw) * w / 640) + 1, w))
        ys = slice(max(int(y0 * h / 480), 0), min(int((y0 + ch) * h / 480) + 1, h))
        changed = (frame[ys, xs] - bg[ys, xs]).abs().amax(-1) > 1 / 255
        least = min(least, float(changed.float().mean()))
    return least


def app_phase(card):
    """The app layer on the card (models/game.py, models/game_check.py):
    GameApp with the synthetic HUD, UI and viewmodel assets and sounds, the
    scripted session (splash -> menu -> level select -> arena_lit ->
    APP_TICKS ticks of the bench stream -> pause -> options -> video
    options, one FOV step -> back -> pause -> resume -> APP_TICKS ticks), a
    SIZE x SIZE frame at every step that reaches a screen, every count
    reset just before the session and read just after (K1, K2 and K4 must
    launch, K3 and K5 not). Beside it the same session runs on the CPU port
    in a subprocess (game_check.py's CLI, on one host thread): equal
    screens and events, every frame of the session (the widget screens and
    the world under them too) within FRAME_BAR of the CPU's, the in-game
    frames each with non-sky coverage of at least 0.03, and, as an extra
    guard, every widget screen's controls drawn over their background (at
    least 1% of each control's rect changed). Then 0 host syncs over
    APP_SYNC_TICKS in-game tick + render_frame pairs. Only once the CPU
    session has ended, so nothing else contends for the host: the pairs'
    rate over APP_RATE_TICKS and play.py --script --seconds 5 headless (its
    frames/s). Returns (figures, the session's kernel launches)."""
    import subprocess
    import tempfile

    import numpy as np
    import torch

    from c_game_engine_tpu_torch.audio.synthetic_sounds import write_synthetic_sounds
    from c_game_engine_tpu_torch.models.game import GameApp, Screen
    from c_game_engine_tpu_torch.models.game_check import app_script, check_session, run_script
    from c_game_engine_tpu_torch.models.graph_check import kernel_counts
    from c_game_engine_tpu_torch.models.sim import bench_actions
    from c_game_engine_tpu_torch.ui.screens import draw_rect
    from c_game_engine_tpu_torch.ui.stack import UiInput
    from c_game_engine_tpu_torch.utils import counters

    with tempfile.TemporaryDirectory() as tmp:
        sounds = write_synthetic_sounds(Path(tmp) / "sounds")
        cpu_out = str(Path(tmp) / "cpu_session")
        t_cpu = time.perf_counter()
        cpu = subprocess.Popen([sys.executable, "-m", "c_game_engine_tpu_torch.models.game_check", cpu_out,
                                "--ticks", str(APP_TICKS), "--size", str(SIZE), "--sounds", str(sounds)],
                               cwd=ROOT, stdout=subprocess.DEVNULL)
        play = None
        try:
            app = GameApp(device="cuda", synthetic_assets=True, sound_dir=sounds)
            steps = app_script(app.list_levels(), "arena_lit", APP_TICKS)
            acts = bench_actions(2 * APP_TICKS, 1, "cuda")
            torch.cuda.synchronize()
            counters.reset()
            t0 = time.perf_counter()
            rec = run_script(app, steps, lambda kw: UiInput.at_mouse(-1.0, -1.0, **kw), lambda t: acts[t], SIZE)
            torch.cuda.synchronize()
            session_s = time.perf_counter() - t0
            counts = kernel_counts()

            sync_acts = bench_actions(APP_SYNC_TICKS, 1, "cuda")
            _, syncs = host_syncs(lambda: [(app.tick(sync_acts[t]), app.render_frame(SIZE, SIZE))
                                           for t in range(APP_SYNC_TICKS)])
            cpu_rc = cpu.wait(timeout=600)
            cpu_s = time.perf_counter() - t_cpu
            rate_acts = bench_actions(APP_RATE_TICKS, 1, "cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for t in range(APP_RATE_TICKS):
                app.tick(rate_acts[t])
                last = app.render_frame(SIZE, SIZE)
            torch.cuda.synchronize()
            rate = APP_RATE_TICKS / (time.perf_counter() - t0)
            t0 = time.perf_counter()
            play = subprocess.Popen([sys.executable, "-m", "c_game_engine_tpu_torch.play", "--script", "--seconds",
                                     "5", "--synthetic", "--out", os.devnull], cwd=ROOT, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
            play_out, play_err = play.communicate(timeout=300)
            play_s = time.perf_counter() - t0
        finally:
            for proc in (play, cpu):
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if cpu_rc != 0:
            raise AssertionError(f"app phase: the CPU session exited {cpu_rc}")
        with open(cpu_out + ".json") as f:
            ref = json.load(f)
        with np.load(cpu_out + ".npz") as z:
            cpu_frames = {k: torch.from_numpy(z[k]) for k in z.files}
    if play.returncode != 0:
        raise AssertionError(f"play.py exited {play.returncode}: {play_err[-2000:]}")
    viewer = json.loads(play_out.strip().splitlines()[-1])
    if viewer["frames"] < 1 or not viewer["device"].startswith("cuda"):
        raise AssertionError(f"play.py: {viewer}")
    if syncs != 0:
        raise AssertionError(f"app phase: {syncs} host syncs over {APP_SYNC_TICKS} in-game tick + render_frame")
    if not bool(torch.isfinite(last).all()):
        raise AssertionError("app phase: the timed frames are not finite")
    check_session(rec)
    if rec["screens"] != ref["screens"] or rec["events"] != ref["events"] or rec["ticks"] != ref["ticks"]:
        raise AssertionError(f"app phase: card screens {rec['screens']} events {rec['events']}, CPU "
                             f"{ref['screens']} {ref['events']}")
    frames = rec["frames"]
    if sorted(frames) != sorted(cpu_frames):
        raise AssertionError(f"app phase: card frames {sorted(frames)}, CPU frames {sorted(cpu_frames)}")
    for label, f in frames.items():
        if f.shape != (SIZE, SIZE, 3) or not bool(torch.isfinite(f).all()) or f.device.type != "cuda":
            raise AssertionError(f"app phase: frame {label} {tuple(f.shape)} on {f.device}, or not finite")
    world = ("in_game", "in_game_again")
    off = {k: float(((frames[k].cpu() - cpu_frames[k]).abs().amax(-1) > 1 / 255).float().mean()) for k in frames}
    covs = {k: coverage(frames[k]) for k in world}
    if max(off.values()) > FRAME_BAR or min(covs.values()) < 0.03:
        raise AssertionError(f"app phase: frames off the CPU's {off}, in-game coverage {covs}")
    dim = draw_rect(frames["in_game"], 0, 0, SIZE, SIZE, (0.0, 0.0, 0.0, 0.5))
    contrast = {}
    for label, screen, bg in (("menu", Screen.MENU, torch.zeros_like(dim)), ("paused", Screen.PAUSED, dim),
                              ("options", Screen.OPTIONS, dim), ("video_options_fov", Screen.VIDEO_OPTIONS, dim)):
        contrast[label] = _widget_contrast(frames[label], bg, app._ui[screen][0])
    if min(contrast.values()) < 0.01:
        raise AssertionError(f"app phase: a widget screen left a control's rect as its background: {contrast}")
    expect = {"capsule_resolve": 2 * APP_TICKS + 1, "ray_tris": 2 * APP_TICKS + 1}
    if (any(counts[k] < n for k, n in expect.items()) or counts["raster_tiles"] < 2 * len(world)
            or counts["body_contacts"] or counts["raster_tiles_big"]):
        raise AssertionError(f"app phase: launches {counts} over {rec['ticks']} ticks and {len(frames)} frames")

    print(f"app session on {card}: {len(rec['screens'])} steps, screens and events equal the CPU port's "
          f"(fired {[e for e in rec['events'] if e]}); {rec['ticks']} ticks, {len(frames)} frames of "
          f"{SIZE}x{SIZE} in {session_s:.2f} s (beside the CPU session, {cpu_s:.1f} s with start-up); share of "
          f"pixels off the CPU's {off}; in-game non-sky coverage {covs}; least share of a control's rect drawn "
          f"over the background {contrast}; launches {counts}", flush=True)
    print(f"app in game: {rate:.1f} ticks + frames/s ({APP_RATE_TICKS} x tick + render_frame, batch 1, "
          f"{SIZE}x{SIZE}, after the CPU session ended), {syncs} host syncs over {APP_SYNC_TICKS} pairs", flush=True)
    print(f"play.py --script --seconds 5: {viewer['frames']} frames, median {viewer['median_ms']:.2f} ms, "
          f"{viewer['fps_uncapped']:.1f} frames/s uncapped (view {viewer['view']} of {viewer['size']}^2), "
          f"{play_s:.1f} s with start-up", flush=True)
    return {"steps": len(rec["screens"]), "events": [e for e in rec["events"] if e], "ticks": rec["ticks"],
            "frames": len(frames), "session_s": session_s, "cpu_session_s": cpu_s, "off_share": off, "coverage": covs,
            "widget_contrast": contrast, "ticks_frames_per_s": rate, "host_syncs_per_pair": syncs / APP_SYNC_TICKS,
            "viewer": viewer, "viewer_process_s": play_s}, counts



def compiler_phase():
    """Write the maps' sources, compile them with the port on the card (and
    on the CPU for the reference checks), build the bundles, and hold the
    four maps and two bundles to the committed files. Returns ({name:
    {"cuda": (cmap, bundle), "cpu": (cmap, bundle)}}, figures); rooms.json
    is among the maps, compiled on each device with its own bake."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT / "tests"))
    import torch_map_sources as S

    from c_game_engine_tpu_torch.assets.gmap import decode_gmap
    from c_game_engine_tpu_torch.compiler import sectors
    from c_game_engine_tpu_torch.compiler.compile import compile_map
    from c_game_engine_tpu_torch.core.state import map_to_numpy
    from c_game_engine_tpu_torch.render.bundle import build_render_bundle, bundle_to_numpy

    t0 = time.perf_counter()
    src = S.write_sources(ROOT / "build" / "map_sources")
    sp = [src["assets"]]
    figures = {"write_sources_s": time.perf_counter() - t0}
    maps_dir = ROOT / "c_game_engine_tpu_torch" / "maps"

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def held(label, got, stem, float16):
        with np.load(maps_dir / f"{stem}.npz") as z:
            want = {k: z[k] for k in z.files}
        if sorted(got) != sorted(want):
            raise AssertionError(f"compiler phase {label}: leaves {sorted(got)} != {sorted(want)}")
        for k, w in want.items():
            g = got[k]
            if k in float16:
                w = w.astype(np.float16).astype(w.dtype)
            if g.dtype != w.dtype or g.shape != w.shape or g.tobytes() != w.tobytes():
                raise AssertionError(f"compiler phase {label}: leaf {k} differs from {stem}.npz")
        return len(want)

    out, leaves = {}, 0
    for name in S.MAPS:
        gm = decode_gmap(src[name])
        cmap, c_s = timed(lambda: compile_map(gm, name=name, search_paths=sp, device="cuda"))
        bundle, b_s = timed(lambda: build_render_bundle(cmap))
        figures[name] = {"compile_map_s": c_s, "build_render_bundle_s": b_s}
        got, aux = map_to_numpy(cmap)
        leaves += held(name, got, name, {k for m, k in S.FLOAT16_LEAVES if m == name})
        with open(maps_dir / f"{name}.json") as f:
            if json.loads(json.dumps(aux)) != json.load(f):
                raise AssertionError(f"compiler phase {name}: aux differs from {name}.json")
        if name in S.RENDER_MAPS:
            b_leaves, static = bundle_to_numpy(bundle)
            leaves += held(f"{name} bundle", b_leaves, f"{name}_bundle",
                           {k for m, k in S.FLOAT16_LEAVES if m == f"{name}_bundle"})
            with open(maps_dir / f"{name}_bundle.json") as f:
                if json.loads(json.dumps(static)) != json.load(f):
                    raise AssertionError(f"compiler phase {name}: bundle static fields differ")
        cpu_map = compile_map(gm, name=name, search_paths=sp, device="cpu")
        out[name] = {"cuda": (cmap, bundle), "cpu": (cpu_map, build_render_bundle(cpu_map))}
        print(f"compiler {name}: compile_map {c_s:.4f} s, build_render_bundle {b_s:.4f} s on the card; "
              f"{aux['num_real_tris']} triangles, {len(aux['actor_names'])} actors, bundle "
              f"{bundle.live_tri_bound} live rows", flush=True)
    print(f"compiler phase: {leaves} leaves of the four maps and the two bundles compiled on the card equal the "
          f"committed files (the lightmap as the .gmap's float16)", flush=True)

    # the editor-JSON map, its lightmap baked on each device
    bakes = []
    real_bake = sectors.bake_lightmap

    def timed_bake(surfaces, atlas_size, *a, **k):
        lm, dt = timed(lambda: real_bake(surfaces, atlas_size, *a, **k))
        bakes.append({"device": str(k["device"]), "s": dt, "args": (surfaces, atlas_size, *a),
                      "luxels": int(sum(sf.lm_size_luxels[0] * sf.lm_size_luxels[1] for sf in surfaces)),
                      "lightmap": lm})
        return lm

    sectors.bake_lightmap = timed_bake
    try:
        path = str(src["rooms"])
        rooms, rooms_s = timed(lambda: compile_map(path, search_paths=sp, device="cuda"))
        rooms_cpu, rooms_cpu_s = timed(lambda: compile_map(path, search_paths=sp, device="cpu"))
        halls_s = timed(lambda: sectors.compile_map_source(str(src["halls"]), device="cuda"))[1]
    finally:
        sectors.bake_lightmap = real_bake
    card_bake, cpu_bake, halls_bake = bakes
    diff = np.abs(card_bake["lightmap"] - cpu_bake["lightmap"]).max(-1)
    share = float((diff <= 1e-4).mean())
    if not share >= 0.999 or not np.array_equal(rooms.lightmap.cpu().numpy(), card_bake["lightmap"]):
        raise AssertionError(f"compiler phase rooms.json: {share:.6f} of luxels within 1e-4 of the CPU bake")
    figures["rooms"] = {
        "compile_map_s": rooms_s, "compile_map_cpu_s": rooms_cpu_s, "luxels": card_bake["luxels"],
        "bake_s": card_bake["s"], "bake_cpu_s": cpu_bake["s"],
        "luxel_share_within_1e-4": share, "luxel_max_abs_diff": float(diff.max()),
        "occluders": int(rooms.aux["num_real_tris"]), "lights": int(rooms.point_lights.shape[0])}
    out["rooms"] = {"cuda": (rooms, build_render_bundle(rooms)), "cpu": (rooms_cpu, build_render_bundle(rooms_cpu))}

    # halls.json, the full-size editor map: its whole bake on the card, held
    # to the CPU port's bake of every HALLS_EVERY-th surface alone (a
    # luxel's value depends on its own sample points only)
    surfaces, atlas_size, lights, tris = halls_bake["args"]
    sub = surfaces[::HALLS_EVERY]
    cpu_lm, sub_s = timed(lambda: real_bake(sub, atlas_size, lights, tris, device="cpu"))
    mask = np.zeros(cpu_lm.shape[:2], bool)
    for sf in sub:
        (x0, y0), (w, h) = sf.lm_rect, sf.lm_size_luxels
        mask[y0 : y0 + h, x0 : x0 + w] = True
    h_diff = np.abs(halls_bake["lightmap"] - cpu_lm).max(-1)[mask]
    h_share = float((h_diff <= 1e-4).mean())
    lit = float((halls_bake["lightmap"][mask][:, :3].max(-1) > 0).mean())
    if not h_share >= 0.999 or not lit > 0.1:
        raise AssertionError(f"compiler phase halls.json: {h_share:.6f} of {int(mask.sum())} luxels within 1e-4 "
                             f"of the CPU bake, {lit:.3f} lit")
    figures["halls"] = {
        "compile_map_source_s": halls_s, "surfaces": len(surfaces), "luxels": halls_bake["luxels"],
        "occluders": len(tris), "lights": len(lights), "bake_s": halls_bake["s"],
        "luxels_per_s": halls_bake["luxels"] / halls_bake["s"],
        "cpu_surfaces": len(sub), "cpu_luxels": int(mask.sum()), "cpu_bake_s": sub_s,
        "cpu_luxels_per_s": int(mask.sum()) / sub_s, "luxel_share_within_1e-4": h_share,
        "luxel_max_abs_diff": float(h_diff.max()), "lit_share": lit}

    # the compile cache, cold and hit, in a directory of this run's own;
    # then make_sim of a .gmap and a .json path through it: the tick graph
    # on the card, equal to the same rollout on the phase's maps
    from c_game_engine_tpu_torch.compiler import cache
    from c_game_engine_tpu_torch.core.state import tree_leaves
    from c_game_engine_tpu_torch.models.sim import bench_actions, make_sim, reset_batch, rollout

    cache.CACHE_DIR = ROOT / "build" / "map_cache"
    shutil.rmtree(cache.CACHE_DIR, ignore_errors=True)
    for key in ("arena_lit", "rooms"):
        cold = timed(lambda: cache.load_compiled(src[key], sp, device="cuda"))[1]
        hit = timed(lambda: cache.load_compiled(src[key], sp, device="cuda"))[1]
        figures[key]["load_compiled_cold_s"], figures[key]["load_compiled_hit_s"] = cold, hit
        print(f"compiler cache {key}: load_compiled with its bundle {cold:.4f} s cold, {hit:.4f} s from the cache",
              flush=True)
    for key, ref in (("arena", out["arena"]["cuda"][0]), ("rooms", rooms)):
        sim = make_sim(str(src[key]), batch=256, search_paths=sp)
        acts = bench_actions(30, 256, "cuda")
        got, want = sim.rollout(sim.reset(), acts), rollout(ref, reset_batch(ref, 256), acts)
        differ = [k for (k, a), (_, b) in zip(tree_leaves(got), tree_leaves(want)) if not torch.equal(a, b)]
        if differ or int(got.tick[0]) != 30:
            raise AssertionError(f"compiler phase make_sim({key}): differs from the compiled map's rollout in {differ}")
    print("compiler make_sim: arena.gmap and rooms.json through the compile cache, 30 ticks x 256 envs through the "
          "tick graph, equal to the phase's maps bit for bit", flush=True)
    f = figures["rooms"]
    print(f"compiler rooms.json: {f['luxels']} luxels x 4 samples, {f['lights']} lights, {f['occluders']} occluders; "
          f"bake {f['bake_s']:.4f} s on the card, {f['bake_cpu_s']:.4f} s on the CPU; {share:.6f} of luxels within "
          f"1e-4 of the CPU bake (largest difference {f['luxel_max_abs_diff']:.3g})", flush=True)
    f = figures["halls"]
    print(f"compiler halls.json: compile_map_source {f['compile_map_source_s']:.4f} s on the card; {f['surfaces']} "
          f"surfaces, {f['luxels']} luxels x 4 samples, {f['lights']} lights, {f['occluders']} occluders: bake "
          f"{f['bake_s']:.4f} s on the card, {f['luxels_per_s']:.1f} luxels/s; the CPU's bake of {f['cpu_surfaces']} "
          f"of its surfaces ({f['cpu_luxels']} luxels) {f['cpu_bake_s']:.4f} s, {f['cpu_luxels_per_s']:.1f} "
          f"luxels/s; {h_share:.6f} of those luxels within 1e-4 (largest difference "
          f"{f['luxel_max_abs_diff']:.3g}), {lit:.3f} of them lit", flush=True)
    jax_like = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "c_game_engine_tpu"))
    if jax_like:
        raise AssertionError(f"compiler phase loaded {jax_like[:5]}")
    return out, figures, src

def bench_walk(cmap, start, yaw0, ticks, device):
    """Single-env update_character (physics/character.py) for `ticks` ticks
    of the bench stream (hold W at 6 m/s, turn 0.01 rad a tick, gravity
    while airborne) from `start`, all on `device` (no host read). Returns
    (positions [ticks, 3], on_ground [ticks])."""
    import torch

    from c_game_engine_tpu_torch.core.state import reset
    from c_game_engine_tpu_torch.physics.character import update_character

    actors = reset(cmap).actors
    pos = torch.tensor(start, dtype=torch.float32, device=device)
    vy = torch.zeros((), device=device)
    grounded = torch.zeros((), dtype=torch.bool, device=device)
    yaws = yaw0 + 0.01 * torch.arange(1, ticks + 1, dtype=torch.float32, device=device)
    out_p, out_g = [], []
    for t in range(ticks):
        vy = torch.where(grounded, 0.0, vy + WALK_GRAVITY / 60.0)
        vel = torch.stack([-torch.sin(yaws[t]) * WALK_SPEED, vy, -torch.cos(yaws[t]) * WALK_SPEED])
        pos, v, grounded, _ = update_character(cmap, actors, pos, vel, 1.0 / 60.0, grounded, False, False)
        vy = v[1]
        out_p.append(pos)
        out_g.append(grounded)
    return torch.stack(out_p), torch.stack(out_g)


def closing_phase(compiled, src, card):
    """The single-env reference modules and the rest of the JAX package's
    surface on the card: compute_laser_rays (one K2 launch for every env's
    actors), single-env update_character and cast_ray against the CPU, the
    grid-candidate resolve against K1 on a per-env-stream state (ROADMAP
    fault f: a measurement, not a gate), the dual atlas against the two-tap
    path, the bake's bounce term, and the native host library where this
    machine can build it. Returns its figures."""
    import tempfile

    import numpy as np
    import torch

    from c_game_engine_tpu_torch import native
    from c_game_engine_tpu_torch.actors.behaviors import compute_laser_rays
    from c_game_engine_tpu_torch.actors.defs import ActorFlags
    from c_game_engine_tpu_torch.compiler import baker, sectors
    from c_game_engine_tpu_torch.core.actions_io import load_actions, save_actions
    from c_game_engine_tpu_torch.core.state import reset, tree_map
    from c_game_engine_tpu_torch.long_run import walk_and_turn
    from c_game_engine_tpu_torch.models.graph_check import kernel_counts
    from c_game_engine_tpu_torch.models.sim import bench_actions, reset_batch, rollout
    from c_game_engine_tpu_torch.physics import batched
    from c_game_engine_tpu_torch.physics.character import update_character
    from c_game_engine_tpu_torch.physics.raycast import cast_ray, forward_vector
    from c_game_engine_tpu_torch.render.textures import build_atlas, sample
    from c_game_engine_tpu_torch.utils import counters
    from c_game_engine_tpu_torch.utils.mathx import const, quat_rotate

    t_phase = time.perf_counter()
    arena, arena_cpu = compiled["arena"]["cuda"][0], compiled["arena"]["cpu"][0]
    cpu = lambda st: tree_map(lambda x: x.cpu(), st)
    fig = {}

    # ---- compute_laser_rays: every env's actors in one K2 launch
    state = rollout(arena, reset_batch(arena, BATCH), bench_actions(CLOSING_TICKS, BATCH, "cuda"))
    torch.cuda.synchronize()
    counters.reset()
    hit, beam = compute_laser_rays(arena, state.actors)
    torch.cuda.synchronize()
    counts = kernel_counts()
    if counts["ray_tris"] != 1 or sum(counts.values()) != 1:
        raise AssertionError(f"closing compute_laser_rays: launches {counts}, want one ray_tris")
    n_rays = BATCH * arena.num_actors
    # the same rays with their actor ids (compute_laser_rays returns hit and
    # length), on the card and, for the first LASER_CPU_ENVS envs, the CPU
    head = lambda st: tree_map(lambda x: x[:LASER_CPU_ENVS].cpu(), st)
    hit_c, beam_c = compute_laser_rays(arena_cpu, head(state).actors)

    def cast(cm, actors):
        b = actors.pos.shape[0]
        d = quat_rotate(actors.quat, const((0.0, 0.0, -1.0), actors.pos.device).expand_as(actors.pos))
        return batched.cast_rays_batched(
            cm, actors, actors.pos.reshape(-1, 3), d.reshape(-1, 3), 50.0, exclude=cm.siparams[:, 1].repeat(b),
            require_flags=int(ActorFlags.CAN_BLOCK_LASERS), B_env=b, layout="interleaved")

    h, f, a = (x.reshape(BATCH, -1)[:LASER_CPU_ENVS].cpu() for x in cast(arena, state.actors))
    hc, fc, ac = (x.reshape(LASER_CPU_ENVS, -1) for x in cast(arena_cpu, head(state).actors))
    frac_err = float((f - fc).abs().max())
    beam_err = float((beam[:LASER_CPU_ENVS].cpu() - beam_c).abs().max())
    if not (torch.equal(hit[:LASER_CPU_ENVS].cpu(), hit_c) and torch.equal(h, hc) and torch.equal(a, ac)
            and frac_err <= 1e-5 and beam_err <= 50.0 * 1e-5):
        raise AssertionError(f"closing compute_laser_rays: differs from the CPU (fraction {frac_err:.3g})")
    laser_ms = cuda_time(lambda: compute_laser_rays(arena, state.actors))
    fig["laser_rays"] = {"envs": BATCH, "rays": n_rays, "launches": counts, "ms": laser_ms,
                         "hits": int(hit.sum()), "max_abs_err_fraction": frac_err}
    print(f"closing compute_laser_rays: {BATCH} envs x {arena.num_actors} actors = {n_rays} rays after "
          f"{CLOSING_TICKS} ticks of the bench stream, launches {counts} (one K2 launch); the first "
          f"{LASER_CPU_ENVS} envs' hits and actor ids equal to the CPU's, fraction within {frac_err:.3g}; "
          f"{laser_ms:.4f} ms a call on {card}", flush=True)

    # ---- single-env update_character and cast_ray, card against CPU
    walk = lambda cm, dev: bench_walk(cm, SPAWN_ARENA, 0.0, CLOSING_TICKS, dev)
    walk(arena, "cuda")  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pos_g, on_g = walk(arena, "cuda")
    torch.cuda.synchronize()
    walk_ms = (time.perf_counter() - t0) * 1e3 / CLOSING_TICKS
    pos_c, on_c = walk(arena_cpu, "cpu")
    walk_err = float((pos_g.cpu() - pos_c).abs().max())
    if walk_err > 2e-3 or not torch.equal(on_g.cpu(), on_c):
        raise AssertionError(f"closing update_character: {walk_err:.3g} from the CPU, on_ground equal "
                             f"{torch.equal(on_g.cpu(), on_c)}")
    fig["update_character"] = {"ticks": CLOSING_TICKS, "ms_per_tick": walk_ms, "max_abs_err_pos": walk_err,
                               "on_ground_ticks": int(on_g.sum())}
    print(f"closing update_character: one env, {CLOSING_TICKS} ticks of the bench stream on arena, positions "
          f"within {walk_err:.3g} of the CPU's, on_ground equal; {walk_ms:.3f} ms a tick on {card} (one env: "
          f"launch-bound, each tick many small ops)", flush=True)

    env0 = lambda st: tree_map(lambda x: x[0], st)
    p0 = env0(state)
    eye = p0.player.pos + const((0.0, 0.5, 0.0), "cuda")
    fwd = forward_vector(p0.player.yaw, p0.player.pitch)
    laser = 5  # tests/torch_export_map.py::arena_actors' laser row
    l_dir = quat_rotate(p0.actors.quat[laser], const((0.0, 0.0, -1.0), "cuda"))
    ray_args = [(eye, fwd, 10.0, -1, 0), (p0.actors.pos[laser], l_dir, 50.0, laser, int(ActorFlags.CAN_BLOCK_LASERS))]
    got = []
    for o, d, mx, ex, fl in ray_args:
        hg, fg, ag = cast_ray(arena, p0.actors, o, d, mx, ex, fl)
        hc_, fc_, ac_ = cast_ray(arena_cpu, cpu(p0).actors, o.cpu(), d.cpu(), mx, ex, fl)
        if bool(hg) != bool(hc_) or int(ag) != int(ac_) or abs(float(fg) - float(fc_)) > 1e-5:
            raise AssertionError(f"closing cast_ray: card ({bool(hg)}, {float(fg)}, {int(ag)}) != CPU "
                                 f"({bool(hc_)}, {float(fc_)}, {int(ac_)})")
        got.append((bool(hg), float(fg), int(ag)))
    fig["cast_ray"] = {"interact": got[0], "laser": got[1]}
    print(f"closing cast_ray: the interact ray (hit, fraction, actor) {got[0]} and the laser {got[1]}, equal on "
          f"the card and the CPU", flush=True)

    # ---- fault f: per-lane grid candidates against K1's per-block set
    walked = rollout(arena, reset_batch(arena, BATCH), walk_and_turn(FAULT_F_TICKS, BATCH, "cuda"))
    solid = batched._solid_actor_soa(arena, walked.actors)
    box8, boxh = batched._make_kernel_ctx(solid)
    pos, vel = walked.player.pos + walked.player.vel / 60.0, walked.player.vel
    k1 = lambda: batched._resolve_dispatch(arena, pos, vel, box8, boxh)
    grid = lambda: batched.resolve_capsule_batched(arena, pos, vel, solid)
    (pk, vk, gk), (pg_, vg_, gg_) = k1(), grid()
    d = (pk - pg_).abs().max(-1).values
    lanes = int((d > 1e-3).sum())
    k1_ms, grid_ms = cuda_time(k1), cuda_time(grid)
    differ = torch.nonzero(d > 1e-3).squeeze(1)[:8].tolist()
    fig["fault_f"] = {"envs": BATCH, "ticks": FAULT_F_TICKS, "lanes_over_1e-3": lanes,
                      "max_abs_diff_pos": float(d.max()), "grounded_differ": int((gk != gg_).sum()),
                      "mean_player_y": float(walked.player.pos[:, 1].mean()),
                      "lanes_below_the_floor": int((walked.player.pos[:, 1] < 0.0).sum()), "k1_ms": k1_ms,
                      "grid_ms": grid_ms,
                      "differing_lanes": [{"lane": i, "pos": pos[i].tolist(), "k1": pk[i].tolist(),
                                           "grid": pg_[i].tolist()} for i in differ]}
    print(f"closing fault f: {BATCH} lanes of long_run's per-env stream after {FAULT_F_TICKS} ticks (mean player "
          f"y {fig['fault_f']['mean_player_y']:.3f}, {fig['fault_f']['lanes_below_the_floor']} lanes below the "
          f"floor): one resolve through K1 and through the per-lane grid "
          f"candidates: {lanes} lanes differ by more than 1e-3 in position (largest {float(d.max()):.4g}), "
          f"grounded differs on {fig['fault_f']['grounded_differ']}; K1 path {k1_ms:.4f} ms, grid path "
          f"{grid_ms:.4f} ms a call on {card}; lanes (position, after K1, after the grid path): "
          f"{[(x['lane'], [round(v, 3) for v in x['pos']], [round(v, 3) for v in x['k1']], [round(v, 3) for v in x['grid']]) for x in fig['fault_f']['differing_lanes']]}",
          flush=True)

    # ---- the dual atlas on arena_lit's textures
    lit, lit_bundle = compiled["arena_lit"]["cuda"]
    textures = [lit.aux["resolver"].texture(n) for n in lit_bundle.tex_names]
    dual = build_atlas(textures, dual=True, device="cuda")
    if not torch.equal(dual.blocked, lit_bundle.atlas.blocked):
        raise AssertionError("closing dual atlas: its blocked rows differ from the bundle's atlas")
    g = torch.Generator(device="cuda").manual_seed(0)
    taps = RENDER_BATCH * SIZE * SIZE
    tid = torch.randint(0, len(textures), (taps,), generator=g, device="cuda", dtype=torch.int32)
    uv = torch.rand((taps, 2), generator=g, device="cuda") * 4.0 - 1.5
    lod = torch.rand((taps,), generator=g, device="cuda") * 7.0
    one, two = sample(dual, tid, uv, lod=lod), sample(lit_bundle.atlas, tid, uv, lod=lod)
    if not torch.equal(one.view(torch.int32), two.view(torch.int32)):
        raise AssertionError(f"closing dual atlas: {int((one != two).any(-1).sum())} taps differ from the two-tap path")
    dual_ms = cuda_time(lambda: sample(dual, tid, uv, lod=lod), reps=5)
    two_ms = cuda_time(lambda: sample(lit_bundle.atlas, tid, uv, lod=lod), reps=5)
    fig["dual_atlas"] = {"taps": taps, "textures": len(textures), "atlas": list(dual.dual.shape), "dual_ms": dual_ms,
                         "two_tap_ms": two_ms}
    print(f"closing dual atlas: arena_lit's {len(textures)} textures, atlas {list(dual.dual.shape)}; {taps} trilinear "
          f"taps through the dual rows equal the two-tap path bit for bit; dual {dual_ms:.4f} ms, two-tap "
          f"{two_ms:.4f} ms a call on {card}", flush=True)

    # ---- the bake's bounce term
    def bake_args(path):
        """The arguments the compile of `path` hands bake_lightmap (its own
        bake left out)."""
        seen = {}
        real = sectors.bake_lightmap

        def capture(*a, **k):
            seen["args"] = a
            return np.zeros((a[1][1], a[1][0], 4), np.float32)

        sectors.bake_lightmap = capture
        try:
            sectors.compile_map_source(str(path), device="cuda")
        finally:
            sectors.bake_lightmap = real
        return seen["args"]

    def timed_bake(args, device):
        torch.cuda.synchronize()
        t = time.perf_counter()
        lm = sectors.bake_lightmap(*args, bounces=1, device=device)
        torch.cuda.synchronize()
        return lm, time.perf_counter() - t

    rooms = bake_args(src["rooms"])
    timed_bake(rooms, "cuda")  # each op's first launch
    lm_g, rooms_s = timed_bake(rooms, "cuda")
    lm_c, rooms_cpu_s = timed_bake(rooms, "cpu")
    mask = np.zeros(lm_g.shape[:2], bool)
    for sf in rooms[0]:
        (x0, y0), (w, h) = sf.lm_rect, sf.lm_size_luxels
        mask[y0 : y0 + h, x0 : x0 + w] = True
    diff = np.abs(lm_g - lm_c).max(-1)[mask]
    within = float((diff <= 1e-4).mean())
    if within < 0.99 or diff.max() >= 0.02:
        raise AssertionError(f"closing bounce bake rooms.json: {within:.6f} of luxels within 1e-4 of the CPU, "
                             f"largest {diff.max():.3g}")
    surfaces, atlas_size, lights, tris = bake_args(src["halls"])
    sub = (surfaces[::HALLS_EVERY], atlas_size, lights, tris)
    lm_h, halls_s = timed_bake(sub, "cuda")
    luxels = int(sum(sf.lm_size_luxels[0] * sf.lm_size_luxels[1] for sf in sub[0]))
    if not np.isfinite(lm_h).all():
        raise AssertionError("closing bounce bake halls.json: non-finite luxels")
    fig["bounce_bake"] = {"rooms_luxels": int(diff.size), "rooms_s": rooms_s, "rooms_cpu_s": rooms_cpu_s,
                          "rooms_share_within_1e-4": within, "rooms_max_abs_diff": float(diff.max()),
                          "rooms_luxels_over_1e-4": int((diff > 1e-4).sum()), "halls_surfaces": len(sub[0]),
                          "halls_luxels": luxels, "halls_s": halls_s, "halls_occluders": len(tris)}
    print(f"closing bounce bake: rooms.json with bounces=1, {rooms_s:.4f} s on the card, {rooms_cpu_s:.4f} s on the "
          f"CPU, {within:.6f} of {diff.size} luxels within 1e-4 ({int((diff > 1e-4).sum())} beyond, largest "
          f"{diff.max():.3g}); one in every {HALLS_EVERY} of halls.json's surfaces ({len(sub[0])}, {luxels} luxels, "
          f"{len(tris)} occluders) {halls_s:.4f} s on the card", flush=True)

    # ---- the native host library, where this machine can build it
    if native.have_toolchain():
        t0 = time.perf_counter()
        native.lib()
        build_s = time.perf_counter() - t0
        tris = arena.tris[arena.tri_valid].cpu().numpy()
        actors = reset(arena).actors
        vel = torch.tensor([2.0, -1.0, -3.0], device="cuda")
        pos_t, g_t = torch.tensor(NATIVE_START, device="cuda"), torch.zeros((), dtype=torch.bool, device="cuda")
        pos_o, g_o, worst = np.array(NATIVE_START, np.float64), False, 0.0
        for i in range(90):
            pos_t, _, g_t, _ = update_character(arena, actors, pos_t, vel, 1.0 / 60.0, g_t, False, False)
            pos_o, _, g_o = native.character_step_oracle(tris, pos_o, vel.cpu().numpy(), 1 / 60, g_o)
            worst = max(worst, float(np.abs(pos_t.cpu().numpy() - pos_o).max()))
        if worst > 0.06 or not (bool(g_t) and g_o):
            raise AssertionError(f"closing native oracle: {worst:.3g} from the port's update_character, grounded "
                                 f"{bool(g_t)} / {g_o}")
        stream = walk_and_turn(TICKS, BATCH, "cuda")
        with tempfile.TemporaryDirectory() as tmp:
            paths = {c: Path(tmp) / f"{c}.cgas" for c in (True, False)}
            codec_s = {}
            for c, path in paths.items():
                t0 = time.perf_counter()
                save_actions(path, stream, native=c)
                codec_s[c] = time.perf_counter() - t0
            data = {c: path.read_bytes() for c, path in paths.items()}
            back = load_actions(paths[False], native=True, device="cuda")
        if data[True] != data[False] or not all(torch.equal(getattr(back, k), getattr(stream, k))
                                                for k in ("move", "look", "buttons")):
            raise AssertionError("closing native CGAS: the two codecs' bytes or the read-back differ")
        fig["native"] = {"build_s": build_s, "oracle_ticks": 90, "oracle_max_abs_diff": worst, "cgas_bytes": len(data[True]),
                         "cgas_native_s": codec_s[True], "cgas_python_s": codec_s[False]}
        print(f"closing native: built in {build_s:.2f} s (g++, zlib); the oracle over 90 ticks within {worst:.3g} of "
              f"the port's update_character on the card; CGAS {TICKS} x {BATCH} equal bytes from both codecs "
              f"({len(data[True]):,} bytes; C {codec_s[True]:.3f} s, Python {codec_s[False]:.3f} s)", flush=True)
    else:
        fig["native"] = None
        print("closing native: this machine has no g++ with zlib's header; the native phase is left out", flush=True)
    fig["phase_s"] = time.perf_counter() - t_phase
    print(f"closing phase: {fig['phase_s']:.1f} s", flush=True)
    return fig

# ---------------------------------------------------------------- oracles


def oracle_row(state):
    """The oracle rollouts' collected row per env: player position and
    on_ground, then the actors' positions, quaternions, velocities and
    sleep counters, [B, 4 + 11 N] float32."""
    import torch

    p, a = state.player, state.actors
    return torch.cat([p.pos, p.on_ground[:, None].float(), a.pos.flatten(1), a.quat.flatten(1), a.vel.flatten(1),
                      a.sleep.float()], 1)


def oracle_fields(rows, n):
    """oracle_row's [T, B, W] rows as named numpy arrays."""
    r = rows.cpu().numpy()
    t, b = r.shape[:2]
    cut = lambda lo, k: r[..., lo:lo + n * k].reshape(t, b, n, k)
    return {"pos": r[..., :3], "on_ground": r[..., 3] > 0.5, "actors.pos": cut(4, 3), "actors.quat": cut(4 + 3 * n, 4),
            "actors.vel": cut(4 + 7 * n, 3), "actors.sleep": r[..., 4 + 10 * n:]}


def oracle_conditions(lanes, seed=0):
    """Each lane's initial condition, from `seed`: the drop height above
    rest, the kick's speed and heading, the player's yaw and the ramp
    body's start height."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return {"drop": rng.uniform(0.5, 2.0, lanes), "v0": rng.uniform(1.0, 4.0, lanes),
            "heading": rng.uniform(0.0, 2 * np.pi, lanes), "yaw": rng.uniform(0.0, 2 * np.pi, lanes),
            "ramp_y": rng.uniform(0.5, 1.5, lanes)}


def oracle_actions(ticks, lanes, device, w=(), jump=()):
    """[T, B] actions: W held on the ticks in `w`, JUMP on those in `jump`."""
    import torch

    from c_game_engine_tpu_torch.core.actions import NUM_BUTTONS, Actions

    move = torch.zeros((ticks, lanes, 2), device=device)
    buttons = torch.zeros((ticks, lanes, NUM_BUTTONS), dtype=torch.bool, device=device)
    for t in w:
        move[t, :, 1] = -1.0
    for t in jump:
        buttons[t, :, 0] = True
    return Actions(move=move, look=torch.zeros_like(move), buttons=buttons)


def oracle_runs(paths, device, cond):
    """The three oracle maps, compiled on `device`, each lane from its own
    initial condition (cond's arrays), rolled out through rollout_collect
    (the tick graph on a card). Returns {oracle map: (fields, ticks, ms a
    tick, {kernel: launches})}, the rows' actor indices and the launches of
    the whole phase; every count is reset just before the rollouts."""
    import torch

    from c_game_engine_tpu_torch.models.graph_check import kernel_counts
    from c_game_engine_tpu_torch.models.sim import load_named_map, reset_batch, rollout_collect
    from c_game_engine_tpu_torch.utils import counters

    lanes = len(cond["drop"])
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    cms = {name: load_named_map(str(paths[name]), device, [paths["assets"]]) for name in ORACLE_MAPS}
    rows_of = {name: {c: i for i, c in enumerate(cm.aux["actor_classes"])} for name, cm in cms.items()}
    for cm in cms.values():  # capture each map's collect graph before the counts start
        rollout_collect(cm, reset_batch(cm, lanes), oracle_actions(2, lanes, device), oracle_row)

    def timed(cm, state, acts):
        if device != "cpu":
            torch.cuda.synchronize()
        before = kernel_counts()
        t0 = time.perf_counter()
        state, rows = rollout_collect(cm, state, acts, oracle_row)
        if device != "cpu":
            torch.cuda.synchronize()
        return state, rows, time.perf_counter() - t0, {k: v - before[k] for k, v in kernel_counts().items()}

    out = {}
    counters.reset()
    # flat: the drop from tick 0, the kick on tick FLAT_SETTLE
    cm = cms["flat"]
    john, box = rows_of["flat"]["NPC_JOHN"], rows_of["flat"]["PHYSBOX"]
    st = reset_batch(cm, lanes)
    st.actors.pos[:, box, 1] = -0.8 + f32(cond["drop"])
    st, rows1, dt1, k1 = timed(cm, st, oracle_actions(FLAT_SETTLE, lanes, device))
    head = f32(cond["heading"])
    st.actors.vel[:, john] = f32(cond["v0"])[:, None] * torch.stack([torch.cos(head), torch.zeros_like(head),
                                                                      torch.sin(head)], 1)
    st.actors.sleep[:, john] = 0
    st, rows2, dt2, k2 = timed(cm, st, oracle_actions(FLAT_KICK, lanes, device))
    ticks = FLAT_SETTLE + FLAT_KICK
    out["flat"] = (oracle_fields(torch.cat([rows1, rows2]), st.actors.pos.shape[1]), ticks, 1e3 * (dt1 + dt2) / ticks,
                   {k: k1[k] + k2[k] for k in k1})
    # room: settle, walk, jump, walk into a wall, at each lane's yaw
    cm = cms["room"]
    st = reset_batch(cm, lanes)
    st.player.yaw[:] = f32(cond["yaw"])
    acts = oracle_actions(ROOM_TICKS, lanes, device, w=[*range(30, 60), *range(WALL_FROM, ROOM_TICKS)], jump=[60])
    st, rows, dt, k = timed(cm, st, acts)
    out["room"] = (oracle_fields(rows, st.actors.pos.shape[1]), ROOM_TICKS, 1e3 * dt / ROOM_TICKS, k)
    # ramp55: the slide from each lane's start height
    cm = cms["ramp55"]
    st = reset_batch(cm, lanes)
    st.actors.pos[:, rows_of["ramp55"]["NPC_JOHN"], 1] = f32(cond["ramp_y"])
    st, rows, dt, k = timed(cm, st, oracle_actions(RAMP_TICKS, lanes, device))
    out["ramp55"] = (oracle_fields(rows, st.actors.pos.shape[1]), RAMP_TICKS, 1e3 * dt / RAMP_TICKS, k)
    return out, rows_of, kernel_counts()


def oracle_bars(runs, rows_of, cond):
    """{oracle: {bar: lanes outside it}} of the closed forms the JAX
    package's tests set (tests/test_physics.py, tests/test_solver_oracle.py),
    each lane from its own initial condition."""
    import numpy as np

    g, h = 9.81, 1.0 / 120.0
    mu_g = float(np.sqrt(0.2 * 4.25)) * g
    lanes = len(cond["drop"])
    out = {}
    f = runs["flat"][0]
    john, box = rows_of["flat"]["NPC_JOHN"], rows_of["flat"]["PHYSBOX"]
    rest = -0.8
    y = f["actors.pos"][:, :, box, 1]
    n = 2 * (np.arange(len(y)) + 1.0)
    expect = (rest + cond["drop"])[None] - g * h * h * (n * (n + 1) / 2)[:, None]
    airborne = expect > rest + 0.35  # well before the box can touch
    touched = y < rest + 0.02
    first = np.where(touched.any(0), touched.argmax(0), len(y))
    after = np.where(np.arange(len(y))[:, None] >= first[None], y, -np.inf)
    out["drop"] = {"freefall within 1e-3": int((airborne & (np.abs(y - expect) >= 1e-3)).any(0).sum()),
                   "touches the floor": int((first == len(y)).sum()),
                   "no rebound above rest + 0.05": int((after.max(0) >= rest + 0.05).sum()),
                   "ends within 0.05 of rest": int((np.abs(y[-1] - rest) >= 0.05).sum())}
    vel = f["actors.vel"][:, :, john]
    head = np.stack([np.cos(cond["heading"]), np.zeros(lanes), np.sin(cond["heading"])], 1)
    a = (cond["v0"] - (vel[FLAT_SETTLE + 9] * head).sum(-1)) * 60.0 / 10
    moving = np.linalg.norm(vel[FLAT_SETTLE + 39], axis=-1) >= 0.15
    out["kinetic friction"] = {
        "settled below 0.05 m/s": int((np.linalg.norm(vel[FLAT_SETTLE - 1], axis=-1) >= 0.05).sum()),
        "deceleration in [0.5, 1.5] mu g": int(((a <= 0.5 * mu_g) | (a >= 1.5 * mu_g)).sum()),
        "at rest below 0.15 m/s 30 ticks later": int(moving.sum()),
        FAULT_R: int((moving & diagonal_creep(f["actors.pos"][-1, :, john], vel[-1])).sum())}
    r = runs["room"][0]
    pos, grounded = r["pos"], r["on_ground"]
    fwd = np.stack([-np.sin(cond["yaw"]), np.zeros(lanes), -np.cos(cond["yaw"])], 1)
    d = pos[59] - pos[29]
    along = (d * fwd).sum(-1)
    d[:, 1] = 0.0
    y0 = pos[59, :, 1]
    peak = np.maximum(y0, pos[60:121, :, 1].max(0))
    wall = np.abs(pos[WALL_FROM:, :, [0, 2]]).max(-1)
    out["player"] = {
        "rests at y -0.55 within 0.02, grounded": int(((np.abs(pos[29, :, 1] + 0.55) >= 0.02) | ~grounded[29]).sum()),
        "walk 3.0 +- 0.1 m along forward": int((np.abs(along - 3.0) >= 0.1).sum()),
        "walk direction within 0.99 of forward": int(((d * fwd).sum(-1) / np.maximum(np.linalg.norm(d, axis=-1), 1e-9)
                                                      <= 0.99).sum()),
        "jump apex 0.921 +- 0.06": int((np.abs(peak - y0 - 0.921) >= 0.06).sum()),
        "lands within 0.02": int((np.abs(pos[150, :, 1] - y0) >= 0.02).sum()),
        "wall holds (|x|, |z| < 8)": int((wall >= 8.0).any(0).sum()),
        "reaches a wall (> 7)": int((wall[-1] <= 7.0).sum())}
    v = runs["ramp55"][0]["actors.vel"][:, :, rows_of["ramp55"]["NPC_JOHN"]]
    dv = v[89] - v[59]
    a = np.linalg.norm(dv, axis=-1) * 60.0 / 30
    tr = np.radians(55.0)
    a_pred = g * (np.sin(tr) - np.sqrt(0.2 * 4.25) * np.cos(tr))
    dn = dv / np.maximum(np.linalg.norm(dv, axis=-1, keepdims=True), 1e-12)
    out["55-degree slide"] = {
        "acceleration in [0.5, 1.5] g (sin - mu cos)": int(((a <= 0.5 * a_pred) | (a >= 1.5 * a_pred)).sum()),
        "downhill, no sideways drift": int(((dn[:, 0] <= 0.5) | (dn[:, 1] >= 0.0) | (np.abs(dn[:, 2]) >= 0.2)).sum())}
    return out


def diagonal_creep(pos, vel):
    """ROADMAP fault r's signature, per lane: a body within 0.3 m (the
    cylinder's radius and 5 cm) of the box room floor's diagonal edge x = z
    that moves along it (its horizontal velocity within 10 degrees of the
    edge; the creep may chatter up and down as well)."""
    import numpy as np

    along = np.abs(vel[:, 0] + vel[:, 2]) / np.sqrt(2.0) / np.maximum(np.linalg.norm(vel[:, [0, 2]], axis=-1), 1e-9)
    return (np.abs(pos[:, 0] - pos[:, 2]) / np.sqrt(2.0) < 0.3) & (along > np.cos(np.radians(10.0)))


def oracle_outside(bars):
    """The lanes outside a bar that fail the phase: every count but those
    of the kinetic friction's at-rest bar that fault r accounts for, lane
    for lane (a creeping lane outside that bar is fault r's; any other
    lane outside it fails)."""
    bad = {o: {b: n for b, n in v.items() if n and b != FAULT_R} for o, v in bars.items()}
    k = bars["kinetic friction"]
    if k["at rest below 0.15 m/s 30 ticks later"] == k[FAULT_R]:
        bad["kinetic friction"].pop("at rest below 0.15 m/s 30 ticks later", None)
    return {o: v for o, v in bad.items() if v}


def wall_contact(pos):
    """Each lane's first tick of the room rollout with the capsule at a
    wall (|x| or |z| at least 7.79: radius 0.2 from the wall at 8), from
    WALL_FROM on; the rollout's length where it never gets there."""
    import numpy as np

    at = np.abs(pos[WALL_FROM:][..., [0, 2]]).max(-1) >= 7.79
    return np.where(at.any(0), WALL_FROM + at.argmax(0), len(pos))


def oracle_parity(card, cpu, lanes):
    """The first `lanes` lanes of each card rollout against the CPU port's:
    player position 2e-3, on_ground equal, actor position and quaternion
    5e-3, on every tick, but in the room on a lane's ticks from its first
    wall contact on: pressed into a wall, the capsule meets a step-up test
    that float rounding decides (ROADMAP fault o), and both sides are then
    held to the oracle's bars instead (oracle_bars on each). Returns
    ({oracle map: largest differences}, lanes of the room that part after
    their wall contact)."""
    import numpy as np

    out, parted = {}, 0
    for name, (fc, *_rest) in card.items():
        fp = cpu[name][0]
        t = np.arange(len(fp["pos"]))[:, None]
        held = t < (np.minimum(wall_contact(fc["pos"][:, :lanes]), wall_contact(fp["pos"]))[None]
                    if name == "room" else len(t))
        worst = {}
        for leaf, tol in (("pos", 2e-3), ("actors.pos", 5e-3), ("actors.quat", 5e-3)):
            dif = np.abs(fc[leaf][:, :lanes] - fp[leaf]).reshape(len(t), lanes, -1).max(-1, initial=0.0)
            if name == "room" and leaf == "pos":
                parted = int(((dif > tol) & ~held).any(0).sum())
            dif = np.where(held, dif, 0.0)
            worst[leaf] = float(dif.max())
            if worst[leaf] > tol:
                tick, lane = np.unravel_index(dif.argmax(), dif.shape)
                raise AssertionError(f"oracle {name}: {leaf} card vs CPU {worst[leaf]:.3g} > {tol} (tick {tick}, "
                                     f"lane {lane})")
        off = (fc["on_ground"][:, :lanes] != fp["on_ground"]) & held
        if off.any():
            tick, lane = np.argwhere(off)[0]
            raise AssertionError(f"oracle {name}: on_ground card vs CPU differs (tick {tick}, lane {lane})")
        out[name] = worst
    return out, parted


def cull_mode_phase(maps):
    """arena_lit (K4) and arena_orb (K5) under render/raster.py's CULL_MODE
    neg, pos, none and neg again, through the render graph: each frame
    batch equals render_batch_eager under the same mode bit for bit, the
    route's kernel launches twice a frame batch, both passes of the kernel
    equal its plain version, and the live rows that reach the kernel are
    counted; the last neg frames equal the first. Returns {map: {mode:
    live rows per env (mean, max), T}}."""
    import torch

    from c_game_engine_tpu_torch.models.graph_check import kernel_counts
    from c_game_engine_tpu_torch.ops import raster_tiles as K4
    from c_game_engine_tpu_torch.ops import raster_tiles_big as K5
    from c_game_engine_tpu_torch.profile_render import render_calls
    from c_game_engine_tpu_torch.render import raster as R
    from c_game_engine_tpu_torch.utils import counters

    out = {}
    try:
        for name, cm, rb, st in maps:
            big = name == "arena_orb"
            module, fn, plain, kernel, other = (
                (K5, "raster_tiles_big", K5.raster_tiles_big_plain, "raster_tiles_big", "raster_tiles") if big else
                (K4, "raster_tiles_binned", K4.raster_tiles_binned_plain, "raster_tiles", "raster_tiles_big"))
            frames, out[name] = [], {}
            for mode in ("neg", "pos", "none", "neg"):
                R.CULL_MODE = mode
                counters.reset()
                got = R.render_batch(rb, cm, st, SIZE, SIZE)
                torch.cuda.synchronize()
                counts = kernel_counts()
                if counts[kernel] != 2 or counts[other]:
                    raise AssertionError(f"cull mode {mode} {name}: launches {counts}")
                if not torch.equal(got, R.render_batch_eager(rb, cm, st, SIZE, SIZE)):
                    raise AssertionError(f"cull mode {mode} {name}: graph frames differ from render_batch_eager")
                frames.append(got)
                seen = render_calls(module, fn, rb, cm, st, SIZE)
                for label, (a, k) in zip(("pass1", "reveal"), seen):
                    for g, p in zip(getattr(module, fn)(*a, **k), plain(*a, **k)):
                        if not torch.equal(g, p):
                            raise AssertionError(f"cull mode {mode} {name} {label}: {fn} differs from its plain "
                                                 f"version at {int((g != p).sum())} pixels")
                a = seen[0][0]
                live = (a[0][:, 10] <= a[0][:, 11]).sum(-1) if big else a[1].sum(-1)
                out[name][mode] = {"live_rows_mean": float(live.float().mean()), "live_rows_max": int(live.max()),
                                   "T": int(a[0].shape[-1] if big else a[0].shape[1])}
                print(f"cull mode {mode} {name}: graph equals render_batch_eager bit for bit, {fn} equals its "
                      f"plain version on both passes, live rows an env {out[name][mode]['live_rows_mean']:.1f} "
                      f"(max {out[name][mode]['live_rows_max']}, T {out[name][mode]['T']}); launches {counts}",
                      flush=True)
            if not torch.equal(frames[0], frames[3]):
                raise AssertionError(f"cull mode {name}: neg frames after the round trip differ from the first")
            if torch.equal(frames[0], frames[1]):
                raise AssertionError(f"cull mode {name}: pos frames equal neg frames")
            out[name]["graphs"] = len(rb.graphs)
    finally:
        R.CULL_MODE = "neg"
    return out


def oracle_phase(card, render_maps):
    """The JAX package's closed-form oracles at full width through the tick
    graph (ORACLE_LANES lanes, each from its own initial condition; maps
    from tests/torch_oracle_maps.py compiled by the port on the card), the
    lanes outside each bar (all must be 0), ms a tick and K1/K3 launches a
    tick of each rollout; ORACLE_CPU_LANES of them against the CPU port
    under the parity bars; then the cull modes (cull_mode_phase). Returns
    (figures, launches of the oracle rollouts)."""
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_oracle_maps as M

    t0 = time.perf_counter()
    paths = M.write_oracle_sources(ROOT / "build" / "oracle_sources")
    cond = oracle_conditions(ORACLE_LANES)
    runs, rows_of, counts = oracle_runs(paths, "cuda", cond)
    ticks = sum(r[1] for r in runs.values())
    if min(counts["capsule_resolve"], counts["ray_tris"]) < ticks or not all(
            r[3]["body_contacts"] for name, r in runs.items() if name != "room"):
        raise AssertionError(f"oracle rollouts of {ticks} ticks: launches {counts}")
    bars = oracle_bars(runs, rows_of, cond)
    figures = {"lanes": ORACLE_LANES, "outside": bars, "rollouts": {}}
    for name, (_, ticks, ms, k) in runs.items():
        per = {kn: k[kn] / ticks for kn in ("capsule_resolve", "ray_tris", "body_contacts")}
        figures["rollouts"][name] = {"ticks": ticks, "ms_per_tick": ms, "launches_per_tick": per}
        print(f"oracle rollout {name}: {ticks} ticks x {ORACLE_LANES} lanes, {ms:.3f} ms a tick (graph, "
              f"collecting every tick) on {card}; launches a tick K1 {per['capsule_resolve']:.2f}, "
              f"K2 {per['ray_tris']:.2f}, K3 {per['body_contacts']:.2f}", flush=True)
    bad = oracle_outside(bars)
    for oracle, v in bars.items():
        print(f"oracle {oracle}: lanes outside each bar {v}", flush=True)
    cpu_cond = {k: v[:ORACLE_CPU_LANES] for k, v in cond.items()}
    t1 = time.perf_counter()
    cpu_runs, cpu_rows, _ = oracle_runs(paths, "cpu", cpu_cond)
    if cpu_rows != rows_of:
        raise AssertionError(f"oracle maps: actor rows differ between the card and the CPU: {rows_of} {cpu_rows}")
    cpu_bars = oracle_bars(cpu_runs, rows_of, cpu_cond)
    figures["cpu_outside"] = {o: {b: n for b, n in v.items() if n} for o, v in cpu_bars.items()}
    if oracle_outside(cpu_bars):
        raise AssertionError(f"oracle lanes outside their bars on the CPU: {oracle_outside(cpu_bars)}")
    figures["parity"], figures["room_lanes_parted_after_wall_contact"] = oracle_parity(runs, cpu_runs,
                                                                                       ORACLE_CPU_LANES)
    figures["cpu_s"] = time.perf_counter() - t1
    print(f"oracle parity: {ORACLE_CPU_LANES} lanes of each rollout on the card match the CPU port on every tick, "
          f"the room's up to each lane's wall contact ({figures['room_lanes_parted_after_wall_contact']} lanes part "
          f"after it, ROADMAP fault o; both sides within every bar); largest differences {figures['parity']}; "
          f"CPU {figures['cpu_s']:.1f} s", flush=True)
    if bad:
        raise AssertionError(f"oracle lanes outside their bars: {bad}")
    figures["cull_modes"] = cull_mode_phase(render_maps)
    figures["phase_s"] = time.perf_counter() - t0
    return figures, counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from c_game_engine_tpu_torch.bench import card_line
    from c_game_engine_tpu_torch.models.graph_check import check_collect, check_gate_state, gate_states
    from c_game_engine_tpu_torch.models.sim import bench_actions, reset_batch, rollout
    from c_game_engine_tpu_torch.ops import build

    card = card_line()
    print(f"card: {card}", flush=True)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS) + 1) as pool:
        list(pool.map(build.build, KERNELS + ("graph_cond",)))
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(KERNELS)} kernels and the graph's if-node "
          f"helper in parallel (nvcc {' '.join(build.NVCC_FLAGS)})", flush=True)

    compiled, compiler, sources = compiler_phase()
    arena, bodies_map = compiled["arena"]["cuda"][0], compiled["arena_bodies"]["cuda"][0]
    lit, lit_bundle = compiled["arena_lit"]["cuda"]
    orb, orb_bundle = compiled["arena_orb"]["cuda"]

    # kernel phases on real states: a few ticks of the bench stream first
    state = rollout(arena, reset_batch(arena, BATCH), bench_actions(8, BATCH, "cuda"))
    report = kernel_phase(arena, state, bench_actions(1, BATCH, "cuda")[0])
    report.append(body_kernel_phase(bodies_map, reset_batch(bodies_map, BATCH),
                                    bench_actions(1, BATCH, "cuda")[0]))
    lit_state = rollout(lit, reset_batch(lit, RENDER_BATCH), bench_actions(RENDER_TICKS, RENDER_BATCH, "cuda"))
    report.append(render_kernel_phase(lit, lit_bundle, lit_state))
    orb_state = rollout(orb, reset_batch(orb, RENDER_BATCH), bench_actions(RENDER_TICKS, RENDER_BATCH, "cuda"))
    report.append(render_big_kernel_phase(orb, orb_bundle, orb_state))

    reference_phase("arena", arena, compiled["arena"]["cpu"][0])
    reference_phase("arena_bodies", bodies_map, compiled["arena_bodies"]["cpu"][0])
    render_reference_phase("arena_lit", lit, lit_bundle, compiled["arena_lit"]["cpu"])
    render_reference_phase("arena_orb", orb, orb_bundle, compiled["arena_orb"]["cpu"])
    options_off = options_reference_phase(lit, lit_bundle, compiled["arena_lit"]["cpu"])
    # the editor-JSON map compiled and baked on the card: the tick and one
    # sweep against the CPU, with K4 launching
    from c_game_engine_tpu_torch.models.graph_check import kernel_counts
    from c_game_engine_tpu_torch.utils import counters

    rooms, rooms_bundle = compiled["rooms"]["cuda"]
    reference_phase("rooms.json", rooms, compiled["rooms"]["cpu"][0])
    counters.reset()
    render_reference_phase("rooms.json", rooms, rooms_bundle, compiled["rooms"]["cpu"])
    compiler["rooms"]["launches"] = kernel_counts()
    if compiler["rooms"]["launches"]["raster_tiles"] < 2 or compiler["rooms"]["launches"]["raster_tiles_big"]:
        raise AssertionError(f"rooms.json render: launches {compiler['rooms']['launches']}")

    # the tick graph against the eager loop, on the bench stream and on
    # states that open and close each gate
    graphs = {"arena": graph_phase("arena", arena, TICKS),
              "arena_bodies": graph_phase("arena_bodies", bodies_map, BODIES_EAGER_TICKS)}
    for kind, (cm, st, acts) in gate_states(arena, bodies_map, BATCH).items():
        opened, counts = check_gate_state(kind, cm, st, acts)
        print(f"gate state {kind}: {acts.move.shape[0]} ticks x {BATCH} envs, graph equals the eager loop "
              f"bit for bit; gates {opened}, launches {counts}", flush=True)
    chunks = check_collect(arena, COLLECT_BATCH, COLLECT_TICKS)
    print(f"rollout_collect arena: {COLLECT_TICKS} ticks x {COLLECT_BATCH} envs of player.pos through the "
          f"collect graph in {chunks} chunks of the action stream equal the eager loop bit for bit, the "
          f"final state and every row", flush=True)

    # main paths, through the tick graph
    by_path = {}
    state, counts, dt, _ = main_path(arena, "arena")
    for name in ("capsule_resolve", "ray_tris"):
        if counts[name] < TICKS:
            raise AssertionError(f"arena: {name} launched {counts[name]} times in {TICKS} ticks")
    steps = BATCH * TICKS / dt
    by_path["arena"] = {"counts": counts, "steps_per_s": steps}
    print(f"main path arena: {TICKS} ticks x {BATCH} envs in {dt:.3f} s = {steps:.1f} steps/s "
          f"(graph; eager {graphs['arena']['eager_steps_per_s']:.1f}) on {card}; launches {counts}; "
          f"final player pos {state.player.pos[0].tolist()}", flush=True)

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
          f"(graph; eager {graphs['arena_bodies']['eager_steps_per_s']:.1f}) on {card}; launches {counts}; "
          f"body gate open on {gate} ticks; final player pos {state.player.pos[0].tolist()}", flush=True)
    profiles = {"arena": profile_phase("arena", arena, PROFILE_ARENA_TICKS),
                "arena_bodies": profile_phase("arena_bodies", bodies_map, PROFILE_BODIES_TICKS)}

    render_graphs = {}
    for path, name, cm, rb, st, kernel in (("render", "arena_lit", lit, lit_bundle, lit_state, "raster_tiles"),
                                           ("render_orb", "arena_orb", orb, orb_bundle, orb_state,
                                            "raster_tiles_big")):
        render_graphs[name] = render_graph_phase(name, cm, rb, st, kernel)
        counts, dt, dt_eager, covs = render_main_path(cm, rb, st, kernel)
        fps, fps_eager = RENDER_BATCH * HEADINGS / dt, RENDER_BATCH * HEADINGS / dt_eager
        by_path[path] = {"counts": counts, "frames_per_s": fps, "eager_frames_per_s": fps_eager, "coverage": covs}
        print(f"main path render {name}: {HEADINGS} frame batches x {RENDER_BATCH} envs x {SIZE}x{SIZE} "
              f"in {dt:.4f} s = {fps:.1f} frames/s through the graph (eager {dt_eager:.4f} s = {fps_eager:.1f}) "
              f"on {card}; non-sky coverage by heading {[round(c, 4) for c in covs]}; launches {counts}", flush=True)
    counts, dt, dt_eager = hud_main_path(lit, lit_bundle, lit_state)
    by_path["render_hud"] = {"counts": counts, "frames_per_s": RENDER_BATCH / dt,
                             "eager_frames_per_s": RENDER_BATCH / dt_eager}
    print(f"main path render_with_hud arena_lit: {RENDER_BATCH} envs x {SIZE}x{SIZE} in {dt:.4f} s = "
          f"{RENDER_BATCH / dt:.1f} frames/s through the graph (eager {dt_eager:.4f} s = "
          f"{RENDER_BATCH / dt_eager:.1f}); launches {counts}", flush=True)

    audio = audio_phase(arena, card)
    mesh, mesh_paths = mesh_phase({"arena": arena, "arena_bodies": bodies_map}, card)
    by_path.update(mesh_paths)
    multiprocess, mp_paths = multiprocess_phase(card)
    by_path.update(mp_paths)
    actions, counts = action_stream_phase(arena)
    by_path["action_replay"] = {"counts": counts}
    extras, counts = entry_points_phase(card)
    by_path["demo"] = {"counts": counts}
    extras["app"], counts = app_phase(card)
    by_path["app"] = {"counts": counts}
    extras["closing"] = closing_phase(compiled, sources, card)
    extras["oracles"], counts = oracle_phase(card, (("arena_lit", lit, lit_bundle, lit_state),
                                                    ("arena_orb", orb, orb_bundle, orb_state)))
    by_path["oracles"] = {"counts": counts}
    for cm, name in ((arena, "arena"), (bodies_map, "arena_bodies")):
        for (batch, collects), g in cm.graphs.items():
            print(f"graph {name} x {batch}{' (collect)' if collects else ''}: capture {g.capture_s:.2f} s, "
                  f"pool {g.pool_bytes / 2**20:.1f} MiB", flush=True)
    graph_list = []
    for rb, name in ((lit_bundle, "arena_lit"), (orb_bundle, "arena_orb")):
        for key, g in rb.graphs.items():
            graph_list.append({"map": name, "key": list(key), "capture_s": g.capture_s, "pool_bytes": g.pool_bytes,
                               "state_leaves_read": len(g.reads)})
            print(f"render graph {name} {key}: capture {g.capture_s:.2f} s, pool {g.pool_bytes / 2**20:.1f} MiB, "
                  f"{len(g.reads)} state leaves copied in", flush=True)

    home = {"body_contacts": "arena_bodies", "raster_tiles": "render", "raster_tiles_big": "render_orb"}
    for k in report:
        k["launches"] = by_path[home.get(k["name"], "arena")]["counts"][k["name"]]
        k["launches_by_path"] = {p: v["counts"][k["name"]] for p, v in by_path.items()}
        k["launches_in_trace"] = {p: v["trace_launches"][k["name"]] for p, v in profiles.items()
                                  if k["name"] in v["trace_launches"]}
    print(card)
    print(json.dumps({"kernels": report,
                      "steps_per_s": {p: v["steps_per_s"] for p, v in by_path.items() if "steps_per_s" in v},
                      "eager_steps_per_s": {p: v["eager_steps_per_s"] for p, v in graphs.items()},
                      "frames_per_s": {p: v["frames_per_s"] for p, v in by_path.items() if "frames_per_s" in v},
                      "eager_frames_per_s": {p: v["eager_frames_per_s"] for p, v in by_path.items()
                                             if "eager_frames_per_s" in v},
                      "render_graphs": graph_list, "render_options_off_share": options_off,
                      "per_frame_batch": {n: {m: {k: p[k] for k in (
                          "wall_ms_per_frame_batch", "device_ms_per_frame_batch", "busy_share",
                          "launches_per_frame_batch", "host_per_frame_batch", "host_syncs_per_frame_batch",
                          "memcpy_htod_per_frame_batch", "memcpy_dtoh_per_frame_batch")} for m, p in v["profile"].items()}
                          for n, v in render_graphs.items()},
                      "gate_open_by_heading": {n: v["gate_open_by_heading"] for n, v in render_graphs.items()},
                      "graphs": graphs, "per_replayed_tick": {
                          p: {k: v[k] for k in ("host_syncs_per_tick", "memcpy_htod_per_tick", "memcpy_dtoh_per_tick",
                                                "device_ms_per_tick", "wall_ms_per_tick", "busy_share",
                                                "host_per_tick")} for p, v in profiles.items()},
                      "audio": audio, "mesh": mesh, "multiprocess": multiprocess, "action_stream": actions,
                      "compiler": compiler, **extras}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
