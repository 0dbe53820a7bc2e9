"""Compile-time model registry (counterpart of
c_game_engine_tpu/compiler/models.py): resolves model, texture and
material asset paths through the game's search paths and extracts physics
shapes and render data, host side, numpy (scipy's ConvexHull for the hull
clouds and their mass properties).

Search-path semantics follow game.gkvl: the 'game' directory, then
'assets/engine' (the reference's AssetReader.c:37-75). The defaults are
`assets/game` and `assets/engine` at the repository's root: the reference
engine's asset tree, put there by whoever has it. The repository does not
ship it; where it is absent every asset resolves to None, a texture to the
checkerboard and a material to None (the compiler's fallback material).
A model that resolves nowhere falls back to `model/error.gmdl`, as the
reference does (ModelLoader.c:29-32,240-249).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from c_game_engine_tpu_torch.assets.codecs import (
    CollisionModelType,
    Model,
    Texture,
    checkerboard_fallback,
    decode_gmdl,
    decode_gmtl,
    decode_gtex,
)

_REFERENCE_ASSETS = Path(__file__).resolve().parents[2] / "assets"
DEFAULT_SEARCH_PATHS = (_REFERENCE_ASSETS / "game", _REFERENCE_ASSETS / "engine")


# Fixed support-direction set used to reduce .gmdl hull point clouds to a
# small vert cloud: the 26 unit directions of the {-1, 0, 1}^3 grid. The
# reduced cloud's support function is EXACT along these directions (so exact
# everywhere for axis-aligned boxes: all 8 corners are corner-direction
# argmaxes) and underestimates by <= 1 - cos(max gap/2) ~ 4% in between.
# The reference passes the raw cloud to Jolt which convexifies internally
# (engine/src/assets/ModelLoader.c:323-351 ConvexHullShape).
_SUPPORT_DIRS = np.array(
    [
        (x, y, z)
        for x in (-1.0, 0.0, 1.0)
        for y in (-1.0, 0.0, 1.0)
        for z in (-1.0, 0.0, 1.0)
        if (x, y, z) != (0.0, 0.0, 0.0)
    ],
    np.float32,
)
_SUPPORT_DIRS /= np.linalg.norm(_SUPPORT_DIRS, axis=1, keepdims=True)


def support_cloud(points: np.ndarray, dirs: np.ndarray = _SUPPORT_DIRS) -> np.ndarray:
    """Reduce a point cloud to its convex-hull vertices, then (if still
    over the direction-set budget) to its support points over the fixed
    direction set. Returns [V, 3] float32, V <= max(len(dirs), 8)."""
    pts = np.asarray(points, np.float64)
    try:
        from scipy.spatial import ConvexHull

        pts = pts[np.unique(ConvexHull(pts).vertices)]
    except Exception:
        pass  # degenerate/flat clouds: fall through to direction sampling
    if pts.shape[0] <= len(dirs):
        return np.unique(pts.astype(np.float32), axis=0)
    idx = np.argmax(pts @ dirs.T.astype(np.float64), axis=0)  # [ndirs]
    return np.unique(pts[idx].astype(np.float32), axis=0)


def hull_mass_properties(point_sets) -> tuple[float, np.ndarray, np.ndarray]:
    """Unit-density mass properties of a compound of convex hulls.

    Each entry of `point_sets` is a [K, 3] point cloud convexified
    independently — the compound's volume/inertia is the SUM over
    sub-hulls, matching Jolt's StaticCompoundShape mass properties
    (the reference creates bodies with OverrideMassProperties =
    CalculateInertia, which scales the shape tensor to the override mass:
    engine/src/actor/prop/PhysicsModel.c:45-52, ModelLoader.c:323-351).

    Returns (volume, com[3], I[3, 3]) with the inertia about the compound
    center of mass at unit density; scale by mass/volume for a body mass.
    Signed-tetra integrals over the hull faces (Mirtich-style covariance
    form), validated against analytic box/sphere/cylinder tensors in
    tests/test_hulls.py.
    """
    vol = 0.0
    first = np.zeros(3)  # integral of x dV
    cov = np.zeros((3, 3))  # integral of x x^T dV about the origin
    from scipy.spatial import ConvexHull

    for pts in point_sets:
        pts = np.asarray(pts, np.float64)
        hull = ConvexHull(pts)
        interior = pts[hull.vertices].mean(axis=0)
        for simplex in hull.simplices:
            a, b, c = pts[simplex]
            n = np.cross(b - a, c - a)
            if np.dot(n, a - interior) < 0.0:  # orient faces outward
                b, c = c, b
            det = float(np.dot(a, np.cross(b, c)))  # 6 x signed tetra volume
            vol += det / 6.0
            first += (det / 6.0) * (a + b + c) / 4.0
            s = a + b + c
            cov += (det / 120.0) * (
                np.outer(a, a) + np.outer(b, b) + np.outer(c, c) + np.outer(s, s)
            )
    com = first / max(vol, 1e-12)
    cov_com = cov - vol * np.outer(com, com)
    inertia = np.eye(3) * np.trace(cov_com) - cov_com
    return float(vol), com.astype(np.float32), inertia


def box_corners(halfext: np.ndarray) -> np.ndarray:
    """The 8 corners of an origin-centered box — the box's exact support
    cloud."""
    h = np.asarray(halfext, np.float32)
    s = np.array(
        [(x, y, z) for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)], np.float32
    )
    return s * h[None, :]


def cylinder_cloud(radius: float, half_height: float, n_sides: int = 12) -> np.ndarray:
    """Support cloud for a Y-axis cylinder: two n-gon rings (inscribed, so
    the radius is underestimated by 1 - cos(pi/n) ~ 3.4% at n=12)."""
    a = np.arange(n_sides) * (2 * np.pi / n_sides)
    ring = np.stack([radius * np.cos(a), np.zeros(n_sides), radius * np.sin(a)], -1)
    top = ring + np.array([0.0, half_height, 0.0])
    bot = ring - np.array([0.0, half_height, 0.0])
    return np.concatenate([top, bot]).astype(np.float32)


@dataclass
class ModelInfo:
    name: str
    model: Model
    # Oriented-box bound of the collision shape (inertia, broadphase
    # margins, sleeping radius).
    box_halfext: np.ndarray  # [3]
    box_center: np.ndarray  # [3] box center in the body's local frame
    mass_default: float  # Jolt density-based default (1000 kg/m^3 * volume)
    # Support vert cloud of the collision shape RELATIVE TO box_center
    # (narrowphase support function input; box corners when the model has
    # no hulls). Compound hulls are merged into one convex cloud
    # (PARITY.md #3 note).
    hull_verts: np.ndarray | None = None  # [V, 3]
    # Diagonal of the exact compound-hull inertia tensor about the hull
    # COM at unit MASS (multiply by body mass for the body tensor) — what
    # Jolt's CalculateInertia override produces for these shapes
    # (PhysicsModel.c:45-52). None -> solid-box tensor from box_halfext.
    # Off-diagonals of the shipped hulls are < 1% of the diagonal (all are
    # near-symmetric) and our solver keeps a diagonal body-frame tensor,
    # so only the diagonal is carried.
    inertia_per_mass: np.ndarray | None = None  # [3]


class AssetResolver:
    def __init__(self, search_paths=DEFAULT_SEARCH_PATHS):
        self.search_paths = [Path(p) for p in search_paths]
        self._models: dict[str, ModelInfo] = {}
        self._textures: dict[str, Texture] = {}
        self._materials: dict[str, object] = {}

    def resolve(self, rel: str) -> Path | None:
        """The first search path's file `rel`, or None."""
        if not rel:
            return None
        for base in self.search_paths:
            p = base / rel
            if p.is_file():
                return p
        return None

    def model(self, rel: str) -> ModelInfo:
        if rel in self._models:
            return self._models[rel]
        path = self.resolve(rel)
        if path is None:
            # error-model fallback (ModelLoader.c:29-32,240-249)
            path = self.resolve("model/error.gmdl")
        m = decode_gmdl(path)
        verts = None
        ipm = None
        if m.collision_type == CollisionModelType.DYNAMIC and m.hulls:
            pts = np.concatenate([h["points"] + h["offset"][None] for h in m.hulls], axis=0)
            lo, hi = pts.min(0), pts.max(0)
            halfext = (hi - lo) * 0.5
            center = ((hi + lo) * 0.5).astype(np.float32)
            verts = support_cloud(pts) - center[None, :]
            # Exact shape mass properties: volume from the SUM of sub-hulls
            # (Jolt compound semantics, not the hull of their union) and
            # the unit-mass inertia diagonal about the hull COM.
            volume, _com, inertia_unit = hull_mass_properties(
                [h["points"] + h["offset"][None] for h in m.hulls]
            )
            ipm = (np.diag(inertia_unit) / max(volume, 1e-12)).astype(np.float32)
        else:
            # JPH_BoxShape_Create(extents) is centered at the body origin
            # (ModelLoader.c:149 boundingBoxShape)
            halfext = m.aabb_extents.copy()
            center = np.zeros(3, np.float32)
            he = np.maximum(halfext.astype(np.float64), 1e-3)
            volume = float(8.0 * he[0] * he[1] * he[2])
        halfext = np.maximum(halfext.astype(np.float32), 1e-3)
        # Jolt's density default is 1000 kg/m^3 x the SHAPE volume (the
        # real hull volume for dynamic models, the box volume otherwise)
        info = ModelInfo(rel, m, halfext, center, 1000.0 * volume, verts, ipm)
        self._models[rel] = info
        return info

    def texture(self, rel: str) -> Texture:
        if rel in self._textures:
            return self._textures[rel]
        path = self.resolve(rel)
        tex = decode_gtex(path) if path is not None else checkerboard_fallback()
        self._textures[rel] = tex
        return tex

    def material(self, rel: str):
        if rel in self._materials:
            return self._materials[rel]
        path = self.resolve(rel)
        mat = decode_gmtl(path) if path is not None else None
        self._materials[rel] = mat
        return mat
