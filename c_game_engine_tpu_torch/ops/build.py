"""Build and load the hand-written CUDA kernels under `csrc/`.

Each `csrc/<name>.cu` has a plain C interface and is compiled at first use
with nvcc for Hopper (`sm_90a`) into `build/torch_kernels/` at the repo
root (listed in .gitignore), then loaded with ctypes. The library file
name carries a hash of the flags, the source and every header it includes
from `csrc/` (`#include "..."`), so an edited source or header is rebuilt.
Nothing here runs at import time.

`--fmad=false` keeps nvcc from contracting a*b+c into one fused
multiply-add: every product and sum then rounds as it does in the plain
PyTorch version of each kernel, so the two can agree to the last bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return found


def sources(name: str) -> list[Path]:
    """csrc/<name>.cu and the csrc headers it includes, directly or not."""
    todo, seen = [CSRC / f"{name}.cu"], []
    while todo:
        path = todo.pop()
        if path not in seen:
            seen.append(path)
            todo += [CSRC / inc for inc in re.findall(r'^#include "([^"]+)"', path.read_text(), re.M)]
    return seen


def library_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sources(name):
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless an up-to-date library exists."""
    out = library_path(name)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


class KernelLibrary:
    """A loaded kernel library: `fn(name, argtypes)` binds one C entry point
    returning a cudaError_t as int."""

    def __init__(self, name: str):
        self.name = name
        self.lib = ctypes.CDLL(str(build(name)))

    def fn(self, symbol: str, argtypes):
        f = getattr(self.lib, symbol)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
        return f


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def check_rows_aligned(tri16) -> None:
    """The contact kernels read a [T, 16] triangle row as four 16-byte loads."""
    if tri16.data_ptr() % 16:
        raise ValueError("tri16 must start on a 16-byte boundary")
