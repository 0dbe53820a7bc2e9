"""ctypes bindings for the native host library (counterpart of
c_game_engine_tpu/native.py).

The source is the port's own `csrc/cge_native.cpp`. It is compiled at first
use with `g++ -O3 -fPIC -std=c++17 -shared ... -lz` (g++ and zlib's header
needed) into `build/torch_native/` at the repo root (listed in
.gitignore); the library name carries a hash of the flags and the source,
as ops/build.py keys the CUDA kernels. `lib()` raises where it cannot
build or load the library; core/actions_io.py then falls back to its
Python codec when asked to (native=None). Nothing here runs at import
time. This is host code: no tensor and no device is involved.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "cge_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
LIBS = ("-lz",)
_lib = None


def library_path() -> Path:
    h = hashlib.sha1(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libcge_native-{h.hexdigest()[:12]}.so"


def have_toolchain() -> bool:
    """Whether this machine can build the library: a g++ that finds zlib's
    header."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return False
    proc = subprocess.run([cxx, "-E", "-x", "c++", "-"], input="#include <zlib.h>\n", capture_output=True, text=True)
    return proc.returncode == 0


def build() -> Path:
    """Compile csrc/cge_native.cpp unless an up-to-date library exists."""
    out = library_path()
    if out.is_file():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("g++ not found: the native library builds only where a C++ compiler is")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE), *LIBS], capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded library, built first where needed."""
    global _lib
    if _lib is not None:
        return _lib
    L = ctypes.CDLL(str(build()))
    L.cge_read_asset.restype = ctypes.c_int
    L.cge_read_asset.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_uint64),
    ]
    L.cge_write_asset.restype = ctypes.c_int
    L.cge_write_asset.argtypes = [
        ctypes.c_char_p,
        ctypes.c_uint8,
        ctypes.c_uint8,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_uint64,
    ]
    L.cge_free.restype = None
    L.cge_free.argtypes = [ctypes.c_void_p]
    L.cge_character_step.restype = ctypes.c_int
    L.cge_character_step.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_double,
        ctypes.c_int,
    ]
    L.cge_actions_write.restype = ctypes.c_int
    L.cge_actions_write.argtypes = [
        ctypes.c_char_p,
        ctypes.c_uint32,
        ctypes.c_uint32,
        ctypes.c_uint8,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    L.cge_actions_read.restype = ctypes.c_int
    L.cge_actions_read.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
    ]
    _lib = L
    return L


def actions_write_native(path: str, move: np.ndarray, look: np.ndarray, buttons: np.ndarray) -> None:
    """Native CGAS stream write. move/look [T, B, 2] f32, buttons [T, B, NB] u8."""
    L = lib()
    mv = np.ascontiguousarray(move, np.float32)
    lk = np.ascontiguousarray(look, np.float32)
    bt = np.ascontiguousarray(buttons, np.uint8)
    if mv.ndim != 3 or mv.shape[2] != 2 or lk.shape != mv.shape or bt.shape[:2] != mv.shape[:2]:
        raise ValueError(f"expected move/look [T, B, 2] and buttons [T, B, NB], got {mv.shape}, {lk.shape}, "
                         f"{bt.shape}")
    t, b = mv.shape[:2]
    rc = L.cge_actions_write(
        str(path).encode(), b, t, bt.shape[-1],
        mv.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        lk.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        bt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc != 0:
        raise IOError(f"cge_actions_write({path}) failed: {rc}")


def actions_read_native(path: str):
    """Native CGAS stream read -> (move [T, B, 2], look [T, B, 2], buttons [T, B, NB])."""
    L = lib()
    b = ctypes.c_uint32()
    t = ctypes.c_uint32()
    nb = ctypes.c_uint8()
    mv = ctypes.POINTER(ctypes.c_float)()
    lk = ctypes.POINTER(ctypes.c_float)()
    bt = ctypes.POINTER(ctypes.c_uint8)()
    rc = L.cge_actions_read(
        str(path).encode(), ctypes.byref(b), ctypes.byref(t), ctypes.byref(nb),
        ctypes.byref(mv), ctypes.byref(lk), ctypes.byref(bt),
    )
    if rc != 0:
        raise IOError(f"cge_actions_read({path}) failed: {rc}")
    try:
        tb = t.value * b.value
        move = np.ctypeslib.as_array(mv, (tb * 2,)).copy().reshape(t.value, b.value, 2)
        look = np.ctypeslib.as_array(lk, (tb * 2,)).copy().reshape(t.value, b.value, 2)
        btns = np.ctypeslib.as_array(bt, (tb * nb.value,)).copy().reshape(t.value, b.value, nb.value)
    finally:
        L.cge_free(mv)
        L.cge_free(lk)
        L.cge_free(bt)
    return move, look, btns


def read_asset_native(path: str):
    """Native .g* decode. Returns (type, type_version, bytes)."""
    L = lib()
    t = ctypes.c_uint8()
    tv = ctypes.c_uint8()
    data = ctypes.POINTER(ctypes.c_uint8)()
    size = ctypes.c_uint64()
    rc = L.cge_read_asset(str(path).encode(), ctypes.byref(t), ctypes.byref(tv), ctypes.byref(data),
                          ctypes.byref(size))
    if rc != 0:
        raise IOError(f"cge_read_asset({path}) failed: {rc}")
    try:
        out = ctypes.string_at(data, size.value)
    finally:
        L.cge_free(data)
    return t.value, tv.value, out


def character_step_oracle(tris: np.ndarray, pos: np.ndarray, vel: np.ndarray, dt: float, was_on_ground: bool):
    """Double-precision C++ collide-and-slide step (a test oracle).
    tris [T, 3, 3]; pos/vel [3] float64. Returns (pos, vel, grounded)."""
    L = lib()
    t = np.ascontiguousarray(tris, np.float64)
    if t.ndim != 3 or t.shape[1:] != (3, 3):
        raise ValueError(f"expected tris [T, 3, 3], got {t.shape}")
    p = np.array(pos, np.float64).reshape(3)
    v = np.array(vel, np.float64).reshape(3)
    g = L.cge_character_step(
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        t.shape[0],
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        float(dt),
        int(bool(was_on_ground)),
    )
    return p, v, bool(g)
