"""Where the hand kernels' time goes on one GPU: K1 (capsule resolve), K2
(ray vs triangles), K3 (body contacts) and K5 (streamed raster), each as
built and as variants of its source that change the launch shape or leave
one part of the work out, timed on main-path inputs.

    python3 -m c_game_engine_tpu_torch.profile_kernels [kernel ...]

(default: all four; names as in csrc/). Captures the arguments one
4096-env tick of arena hands K1 (its 8192-lane main launch, after 8 ticks)
and K2 (the merged ray launch's 8192 rays), the first 4096-env tick of
arena_bodies hands K3 (every body awake), as chip_smoke.py's kernel phase
does, and pass 1 of one 64-env 256 x 256 render_batch of arena_orb after
60 ticks hands K5, as its render phase does. For each
variant it edits a copy of csrc/<kernel>.cu, builds it with the package's
nvcc flags, and prints one JSON line: ptxas's registers and spill bytes,
whether the output still equals the plain PyTorch version bit for bit
(the variants that leave work out do not: they time what remains), and
the mean of 100 back-to-back launches between CUDA events, after 3
warm-up launches. A run without a CUDA device fails.
"""

from __future__ import annotations

import ctypes
import functools
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

MAPS = Path(__file__).resolve().parent / "maps"
REPS = 100

# (kernel, variant) -> text substitutions on csrc/<kernel>.cu
REGS64 = ("__launch_bounds__(WARPS * 32)", "__launch_bounds__(WARPS * 32, 8)")
VARIANTS = {
    "capsule_resolve": {
        "as built": [],
        "64 registers": [REGS64],
        "2 warps a block": [("constexpr int WARPS = 4;", "constexpr int WARPS = 2;")],
        "8 warps a block": [("constexpr int WARPS = 4;", "constexpr int WARPS = 8;")],
        "no boxes": [("for (int n = t; n < n_box; n += 32) {", "for (int n = t; n < 0; n += 32) {"),
                     ("if (n_box > 0) {", "if (false) {")],
        "1 projection, not 3": [("  for (int k = 0; k < 2; ++k) {\n    const float spy = clipf(qy, sy0, sy1);\n"
                                 "    closest_on_tri",
                                 "  for (int k = 0; k < 0; ++k) {\n    const float spy = clipf(qy, sy0, sy1);\n"
                                 "    closest_on_tri")],
        "rows read, no triangle arithmetic": [
            ("tri_contact(px, py, pz, sy0, sy1, row, d, nx, ny, nz);",
             "d = row[0] + row[1] * px + row[5] * row[15]; nx = row[9] + row[2] + row[3] + row[4]; "
             "ny = row[10] + row[6] + row[7] + row[8]; nz = row[11] + row[12] + row[13] + row[14];")],
    },
    "body_contacts": {
        "as built": [],
        "64 registers": [REGS64],
        "8 warps a block": [("constexpr int WARPS = 4;", "constexpr int WARPS = 8;")],
        "every body a box (no cloud loop)": [("const bool box = is_box[d] != 0;", "const bool box = true;")],
        "top-4 rounds cut to one empty check": [
            ("float w = depth > NEG_BIG ? depth : NEG_BIG;  // NaN never enters\n",
             "mine = fmaxf(mine, depth + nx + ny + nz + qtx + qty + qtz);\n      float w = NEG_BIG;\n")],
        "no closest point": [("float qtx, qty, qtz;\n      closest_on_tri(ccx, ccy, ccz, t, qtx, qty, qtz);",
                              "float qtx = t[0] + t[3] * t[6], qty = t[1] + t[4] * t[7], "
                              "qtz = t[2] + t[5] * t[8];")],
    },
    "ray_tris": {
        "as built": [],
        "no register cap": [("__launch_bounds__(NTHREADS, 2)", "__launch_bounds__(NTHREADS)")],
        "8 warps a block": [("constexpr int WARPS = 16;", "constexpr int WARPS = 8;")],
        "32 warps a block": [("constexpr int WARPS = 16;", "constexpr int WARPS = 32;"),
                             ("__launch_bounds__(NTHREADS, 2)", "__launch_bounds__(NTHREADS)")],
        "batches of 4 chunks": [("constexpr int BATCH = 8;", "constexpr int BATCH = 4;")],
        "lists and staging only, no rows tested": [("for (int j = 0; j < nb; ++j) {", "for (int j = 0; j < 0; ++j) {")],
        "rows read, no ray arithmetic": [
            ("const float ax = ta.x, ay = ta.y, az = ta.z;",
             "tbest = fminf(tbest, ta.x + ta.y + ta.z + ta.w + tb.x + tb.y + tb.z + tb.w + tc.x + valid);"
             " continue;\n        const float ax = ta.x, ay = ta.y, az = ta.z;")],
    },
    "raster_tiles_big": {
        "as built": [],
        "128 threads, 8 pixels a thread": [("constexpr int NTHREADS = 256;", "constexpr int NTHREADS = 128;")],
        "512 threads, 2 pixels a thread": [("constexpr int NTHREADS = 256;", "constexpr int NTHREADS = 512;")],
        "subchunks listed 4 hit chunks at a time": [("constexpr int S_CHUNKS = 16;", "constexpr int S_CHUNKS = 4;")],
        "z and the division on every pair": [("if (!__any_sync(FULL, any)) continue;", ""),
                                             ("if (!in[p]) continue;", ""),
                                             ("if (z > 0.f && z < 1.f", "if (in[p] && z > 0.f && z < 1.f")],
        "lists and staging only, no rows walked": [("while (mask != 0ull) {", "while (false) {")],
    },
}


def capture(cmap, batch, ticks):
    """Run `ticks` ticks, then one more, and return the argument tuples that
    last tick hands K1, K2 and K3."""
    from c_game_engine_tpu_torch.models.sim import bench_actions, reset_batch, rollout
    from c_game_engine_tpu_torch.profile_tick import tick_calls

    dev = cmap.tri16.device
    state = reset_batch(cmap, batch)
    if ticks:
        state = rollout(cmap, state, bench_actions(ticks, batch, dev))
    return tick_calls(cmap, state, bench_actions(1, batch, dev)[0])[1]


def build_variant(name, subs, out_dir):
    """Compile an edited copy of csrc/<name>.cu; (library, registers, spill bytes)."""
    from c_game_engine_tpu_torch.ops import build

    src = (build.CSRC / f"{name}.cu").read_text()
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"{name}: variant text not found: {old!r}")
        src = src.replace(old, new)
    tag = f"{name}_{len(list(out_dir.iterdir()))}"
    cu, so = out_dir / f"{tag}.cu", out_dir / f"{tag}.so"
    cu.write_text(src)
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(build.CSRC), "-o", str(so), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    regs = int(re.search(r"Used (\d+) registers", proc.stderr).group(1))
    spill = int(re.search(r"(\d+) bytes spill stores", proc.stderr).group(1))
    return ctypes.CDLL(str(so)), regs, spill


def event_ms(fn):
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def k1_runner(args):
    """(launch, equals-plain) for a K1 library on captured arguments."""
    import torch

    from c_game_engine_tpu_torch.ops import capsule_resolve as K1

    tri16, cb, box8, boxh, pos, vel = args
    idx, cnt = K1.chunk_lists(cb, pos)
    b, n = pos.shape[0], box8.shape[1]
    po, vo = torch.empty_like(pos), torch.empty_like(vel)
    gr = torch.empty(b, dtype=torch.bool, device=pos.device)
    want = K1._resolve_plain(tri16, idx, cnt, box8, boxh, pos, vel)

    def bind(lib):
        p, i = ctypes.c_void_p, ctypes.c_int
        f = lib.capsule_resolve_launch
        f.argtypes, f.restype = [p, p, p, i, p, p, i, p, p, p, p, p, i, p], i
        stream = torch.cuda.current_stream().cuda_stream
        launch = lambda: f(tri16.data_ptr(), idx.data_ptr(), cnt.data_ptr(), idx.shape[1], box8.data_ptr(),
                           boxh.data_ptr(), n, pos.data_ptr(), vel.data_ptr(), po.data_ptr(), vo.data_ptr(),
                           gr.data_ptr(), b, stream)
        equal = lambda: all(torch.equal(a, w) for a, w in zip((po, vo, gr), want))
        return launch, equal
    return bind


def k2_runner(args):
    """(launch, equals-plain) for a K2 library on captured arguments."""
    import torch

    from c_game_engine_tpu_torch.ops import ray_tris as K2

    tri16, cb, origin, direction, max_dist = args
    rays = K2._pack(origin, direction, max_dist)
    r = rays.shape[1]
    out = torch.empty(r, device=rays.device)
    want = K2._ray_tris_plain(tri16, *K2.chunk_lists(cb, rays), rays)

    def bind(lib):
        p, i = ctypes.c_void_p, ctypes.c_int
        f = lib.ray_tris_launch
        f.argtypes, f.restype = [p, p, i, p, p, i, p], i
        stream = torch.cuda.current_stream().cuda_stream
        launch = lambda: f(tri16.data_ptr(), cb.data_ptr(), cb.shape[0], rays.data_ptr(), out.data_ptr(), r, stream)
        return launch, lambda: torch.equal(out, want)
    return bind


def k5_runner(call):
    """(launch, equals-plain) for a K5 library on one captured call."""
    import torch

    from c_game_engine_tpu_torch.ops import raster_tiles_big as K5

    (trit, cbox, scb, h, w), kw = call
    exclude, tile_on = kw.get("exclude"), K5._all_on(trit, h, w, kw.get("tile_on"))
    b, _, t = trit.shape
    z = torch.empty((b, h, w), device=trit.device)
    win = torch.empty((b, h, w), dtype=torch.int32, device=trit.device)
    want = K5._plain(trit, exclude, tile_on, h, w)

    def bind(lib):
        p, i = ctypes.c_void_p, ctypes.c_int
        f = lib.raster_tiles_big_launch
        f.argtypes, f.restype = [p, p, p, p, p, p, p, i, i, i, i, p], i
        stream = torch.cuda.current_stream().cuda_stream
        launch = lambda: f(trit.data_ptr(), cbox.data_ptr(), scb.data_ptr(),
                           None if exclude is None else exclude.data_ptr(), tile_on.data_ptr(), z.data_ptr(),
                           win.data_ptr(), b, t // K5.T_CHK, h // K5.TILE_H, w // K5.TILE_W, stream)
        return launch, lambda: torch.equal(z, want[0]) and torch.equal(win, want[1])
    return bind


def render_pass1(name, batch, size, ticks):
    """The (args, kwargs) of K5's pass-1 call in one render_batch of `name`
    after `ticks` ticks of the bench stream."""
    from c_game_engine_tpu_torch.models.sim import bench_actions, reset_batch, rollout
    from c_game_engine_tpu_torch.ops import raster_tiles_big as K5
    from c_game_engine_tpu_torch.profile_render import render_calls
    from c_game_engine_tpu_torch.render.bundle import load_render_map

    cmap, bundle = load_render_map(name, "cuda")
    state = rollout(cmap, reset_batch(cmap, batch), bench_actions(ticks, batch, "cuda"))
    return render_calls(K5, "raster_tiles_big", bundle, cmap, state, size)[0]


def k3_runner(args):
    """(launch, equals-plain) for a K3 library on captured arguments."""
    import torch

    from c_game_engine_tpu_torch.ops import body_contacts as K3

    tri16, cb, body, margin, verts, is_box = args
    idx, cnt = K3.chunk_lists(cb, body, margin)
    _, d, b = body.shape
    out = torch.empty((8, d * K3.K, b), device=body.device)
    flags = is_box.to(torch.int32)
    want = K3._contacts_plain(tri16, idx, cnt, body, verts, is_box)

    def bind(lib):
        p, i = ctypes.c_void_p, ctypes.c_int
        f = lib.body_contacts_launch
        f.argtypes, f.restype = [p, p, p, i, p, p, p, i, i, p, i, p], i
        stream = torch.cuda.current_stream().cuda_stream
        launch = lambda: f(tri16.data_ptr(), idx.data_ptr(), cnt.data_ptr(), idx.shape[-1], body.data_ptr(),
                           verts.data_ptr(), flags.data_ptr(), verts.shape[1], d, out.data_ptr(), b, stream)
        return launch, lambda: torch.equal(out, want)
    return bind


def main(argv) -> int:
    import torch

    from c_game_engine_tpu_torch.core.state import load_map

    if not torch.cuda.is_available():
        print("profile_kernels: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    load = lambda name: load_map(MAPS / f"{name}.npz", MAPS / f"{name}.json", "cuda")
    names = argv or list(VARIANTS)
    arena = functools.cache(lambda: capture(load("arena"), 4096, 8))
    runners = {"capsule_resolve": lambda: k1_runner(arena()["k1"][0]), "ray_tris": lambda: k2_runner(arena()["k2"][0]),
               "body_contacts": lambda: k3_runner(capture(load("arena_bodies"), 4096, 0)["k3"][0]),
               "raster_tiles_big": lambda: k5_runner(render_pass1("arena_orb", 64, 256, 60))}
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            variants, runner = VARIANTS[name], runners[name]()
            for variant, subs in variants.items():
                lib, regs, spill = build_variant(name, subs, Path(tmp))
                launch, equal = runner(lib)
                if launch() != 0:
                    raise RuntimeError(f"{name} ({variant}): launch failed")
                torch.cuda.synchronize()
                print(json.dumps({"card": card, "kernel": name, "variant": variant, "registers": regs,
                                  "spill_bytes": spill, "equals_plain": equal(), "ms": event_ms(launch)}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
