"""Compiled-map disk cache (counterpart of c_game_engine_tpu/compiler/cache.py).

The cache keeps the output of `compile_map` and of `build_render_bundle`
so a later process loads it instead of compiling again (chip_smoke.py
times both on the card). The JAX cache pickles the finished pytrees; the port stores the
committed maps' own format instead, which holds no code: the CompiledMap
leaves as `<key>.npz` with `aux` (minus the asset resolver) as
`<key>.json` (core/state.py::save_map), and the bundle as
`<key>_bundle.npz` and `<key>_bundle.json` (render/bundle.py::save_bundle),
two entries of their own, so a caller that wants no bundle builds none.
A map loaded from the cache gets a fresh AssetResolver over the same
search paths as `aux["resolver"]`, so a bundle can still be built from it.

The files live in `.cache/torch_maps/` (CGE_TORCH_MAP_CACHE_DIR overrides
it), a directory of their own, so the JAX package's `.pkl` entries are
never read.

Invalidation, as the JAX cache keys: a hash of the source file (path,
mtime, size), the search paths, and a fingerprint (names, mtimes and
sizes) of the port's compiler, asset, bundle, texture, HUD, UI, audio,
state and actor sources; and, beyond the JAX key, the path, mtime and
size of every file under the search paths, so an edited model, texture,
material or sound compiles anew. Delete the directory to force a rebuild.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path

_REPO = Path(__file__).resolve().parents[2]
CACHE_DIR = Path(os.environ.get("CGE_TORCH_MAP_CACHE_DIR", _REPO / ".cache" / "torch_maps"))

# package files whose edits must invalidate cached maps
_FINGERPRINT_GLOBS = [
    "c_game_engine_tpu_torch/compiler/*.py",
    "c_game_engine_tpu_torch/assets/*.py",
    "c_game_engine_tpu_torch/render/bundle.py",
    "c_game_engine_tpu_torch/render/textures.py",
    "c_game_engine_tpu_torch/render/hud.py",
    "c_game_engine_tpu_torch/ui/stack.py",
    "c_game_engine_tpu_torch/audio/*.py",
    "c_game_engine_tpu_torch/core/state.py",
    "c_game_engine_tpu_torch/actors/*.py",
]

_pkg_fp_cache: str | None = None


def _package_fingerprint() -> str:
    global _pkg_fp_cache
    if _pkg_fp_cache is None:
        h = hashlib.sha1()
        for pat in _FINGERPRINT_GLOBS:
            for p in sorted(_REPO.glob(pat)):
                if p.name == "cache.py":  # this module doesn't affect content
                    continue
                st = p.stat()
                h.update(f"{p.name}:{st.st_mtime_ns}:{st.st_size};".encode())
        _pkg_fp_cache = h.hexdigest()[:16]
    return _pkg_fp_cache


def _key(source, search_paths) -> str:
    h = hashlib.sha1()
    h.update(_package_fingerprint().encode())
    p = Path(source)
    st = p.stat()
    h.update(f"{p.resolve()}:{st.st_mtime_ns}:{st.st_size}".encode())
    for sp in search_paths:
        h.update(str(sp).encode())
        for f in sorted(Path(sp).rglob("*")):
            if f.is_file():
                fs = f.stat()
                h.update(f"{f}:{fs.st_mtime_ns}:{fs.st_size};".encode())
    return f"{p.stem}-{h.hexdigest()[:16]}"


def _paths(source, search_paths) -> dict:
    """The four files of a source's cache entry: map and bundle, .npz and
    .json."""
    stem = str(CACHE_DIR / _key(source, search_paths))
    return {"map": (Path(f"{stem}.npz"), Path(f"{stem}.json")),
            "bundle": (Path(f"{stem}_bundle.npz"), Path(f"{stem}_bundle.json"))}


def _cached(pair, load):
    """The entry `pair` (.npz, .json) loaded, or None when it is absent; a
    corrupt or stale entry is removed and gives None."""
    if not all(p.is_file() for p in pair):
        return None
    try:
        return load(*pair)
    except Exception:  # noqa: BLE001 - rebuilt by the caller
        for p in pair:
            p.unlink(missing_ok=True)
        return None


def _store(save, obj, pair) -> None:
    npz, js = pair
    tmp_npz, tmp_js = Path(f"{npz}.tmp.npz"), Path(f"{js}.tmp.json")
    save(obj, tmp_npz, tmp_js)
    os.replace(tmp_js, js)
    os.replace(tmp_npz, npz)


def load_compiled(source, search_paths=None, with_bundle: bool = True, device="cuda"):
    """(cmap, bundle) of a `.gmap` or editor-JSON path on `device`, each from
    the cache when its entry is fresh, else compiled (a JSON source's
    lightmap baked on `device`) or built, and cached. `with_bundle=False`
    returns (cmap, None) and neither builds nor caches a bundle."""
    from c_game_engine_tpu_torch.compiler.compile import compile_map
    from c_game_engine_tpu_torch.compiler.models import DEFAULT_SEARCH_PATHS, AssetResolver
    from c_game_engine_tpu_torch.core.state import load_map, save_map
    from c_game_engine_tpu_torch.render.bundle import build_render_bundle, load_bundle, save_bundle

    sp = DEFAULT_SEARCH_PATHS if search_paths is None else search_paths
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    files = _paths(source, sp)
    cmap = _cached(files["map"], lambda npz, js: load_map(npz, js, device))
    if cmap is None:
        cmap = compile_map(str(source), search_paths=sp, device=device)
        _store(save_map, cmap, files["map"])
    else:
        cmap.aux["resolver"] = AssetResolver(sp)
    if not with_bundle:
        return cmap, None
    bundle = _cached(files["bundle"], lambda npz, js: load_bundle(npz, js, cmap))
    if bundle is None:
        bundle = build_render_bundle(cmap)
        _store(save_bundle, bundle, files["bundle"])
    return cmap, bundle
