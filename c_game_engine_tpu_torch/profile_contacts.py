"""Where the contact kernels' time goes on one GPU: K1 (capsule resolve) and
K3 (body contacts), each as built and as variants of its source that
change the launch shape or leave one part of the work out, timed on the
inputs of a main-path tick.

    python3 -m c_game_engine_tpu_torch.profile_contacts

Captures the arguments one 4096-env tick of arena hands K1 (its 8192-lane
main launch, after 8 ticks) and the first 4096-env tick of arena_bodies
hands K3 (every body awake), as chip_smoke.py's kernel phase does. For each
variant it edits a copy of csrc/<kernel>.cu, builds it with the package's
nvcc flags, and prints one JSON line: ptxas's registers and spill bytes,
whether the output still equals the plain PyTorch version bit for bit
(the variants that leave work out do not: they time what remains), and
the mean of 100 back-to-back launches between CUDA events, after 3
warm-up launches. A run without a CUDA device fails.
"""

from __future__ import annotations

import ctypes
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
}


def capture(cmap, batch, ticks):
    """Run `ticks` ticks, then one more, and return the argument tuples that
    last tick hands K1 and K3."""
    from c_game_engine_tpu_torch.core.step import step_batch
    from c_game_engine_tpu_torch.models.sim import bench_actions, reset_batch, rollout
    from c_game_engine_tpu_torch.physics import batched, bodies

    dev = cmap.tri16.device
    state = reset_batch(cmap, batch)
    if ticks:
        state = rollout(cmap, state, bench_actions(ticks, batch, dev))
    seen = {"k1": [], "k3": []}
    k1, k3 = batched.resolve_capsule, bodies.body_contacts

    def rec(key, fn):
        def call(*a):
            seen[key].append(tuple(t.clone() if hasattr(t, "clone") else t for t in a))
            return fn(*a)
        return call

    batched.resolve_capsule, bodies.body_contacts = rec("k1", k1), rec("k3", k3)
    try:
        step_batch(cmap, state, bench_actions(1, batch, dev)[0])
    finally:
        batched.resolve_capsule, bodies.body_contacts = k1, k3
    return seen


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


def main() -> int:
    import torch

    from c_game_engine_tpu_torch.core.state import load_map

    if not torch.cuda.is_available():
        print("profile_contacts: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    load = lambda name: load_map(MAPS / f"{name}.npz", MAPS / f"{name}.json", "cuda")
    runners = {"capsule_resolve": k1_runner(capture(load("arena"), 4096, 8)["k1"][0]),
               "body_contacts": k3_runner(capture(load("arena_bodies"), 4096, 0)["k3"][0])}
    with tempfile.TemporaryDirectory() as tmp:
        for name, variants in VARIANTS.items():
            for variant, subs in variants.items():
                lib, regs, spill = build_variant(name, subs, Path(tmp))
                launch, equal = runners[name](lib)
                if launch() != 0:
                    raise RuntimeError(f"{name} ({variant}): launch failed")
                torch.cuda.synchronize()
                print(json.dumps({"card": card, "kernel": name, "variant": variant, "registers": regs,
                                  "spill_bytes": spill, "equals_plain": equal(), "ms": event_ms(launch)}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
