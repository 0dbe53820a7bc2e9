"""Lightmap radiance model — the editor's bake formula, recovered by fit
(counterpart of c_game_engine_tpu/compiler/baker.py).

The reference's baker lives in its external editor (SURVEY.md §2.6 — the
repo ships only compiled .gmap lightmaps), so the model was recovered by
regressing the shipped bakes on candidate basis functions
(benchmarks/baker_fit.py, nonnegative least squares over per-light
falloff/cosine/visibility variants on shapes.gmap + too_many_lights.gmap,
the two shipped maps with point lights):

  L(p) = sum_l color_l * brightness_l * visible(p, l)
         * max(1/d^att_l - 1/range_l^att_l, 0)

i.e. a shifted inverse-power falloff that reaches exactly zero at
`range` (algebraically (1/d^a)*(1-(d/r)^a)), hard shadow rays, and —
notably — NO surface-cosine (Lambert) term, no ambient, no indirect
bounce, with unit gain in the editor's output units. Fit quality at
gain 1.0 (benchmarks/baker_fit.py):

  shapes.gmap          R^2 = 0.977, median rel. err 0.013  (1370 samples)
  too_many_lights.gmap R^2 = 0.958, median rel. err 0.088  (48 samples;
                       range=2/att=2 lights -> steep luxel gradients, so
                       point-sampling noise dominates)

Every alternative with a cosine term fits far worse (R^2 <= 0.58), as
does any model without shadow rays (R^2 <= 0.52) — both terms are
decisively identified, not assumed. Light params per Light.h:12-24
(position, color, brightness, range, attenuation).

The JAX shader is plain XLA under `jax.jit` (no Pallas kernel); this one is
PyTorch ops on the bake's device, float32 throughout (the JAX einsums run
at Precision.HIGHEST; here the contractions are elementwise products and
sums, which TF32 never touches). Shadow rays are Möller–Trumbore against
every occluder that can block them, one light at a time as `jax.lax.map`
takes them, over every sample point of the map in one call: points in
blocks of `POINT_BLOCK` and occluders in chunks, so the [B, T, 3]
intermediates stay under `MAX_PAIRS` (point, occluder) pairs for any map. On a grazing ray
the visibility test (|det| > 1e-9, 1e-4 < t < 1 - 1e-4) can flip between
two float32 implementations, so a bake is held to the JAX one luxel by
luxel at a bar, not bit for bit. The JAX module's optional bounce term
(`bounces`, `albedo`) is not ported: no bake of either package uses it.
"""

from __future__ import annotations

import numpy as np
import torch

# The fitted output gain is 1.0 (0.98-1.01 on both calibration maps): the
# editor writes radiance in these natural units directly.
GAIN = 1.0
# (point, occluder) pairs per chunk of the shadow-ray test: three
# [B, T, 3] float32 intermediates of 48 MB each at this size
MAX_PAIRS = 1 << 22
# sample points per block; the occluder chunk is MAX_PAIRS // POINT_BLOCK
POINT_BLOCK = 1 << 16


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def make_shader(point_lights, occluder_tris, device="cuda"):
    """Returns shade(pts [B,3]) -> [B,3] radiance (host float32 arrays in
    and out), computed on `device` over the map's light set and occluder
    soup with the recovered editor model above. A point's radiance does
    not depend on the others, so any set of points may share a call."""
    dev = torch.device(device)
    occluder_tris = np.asarray(occluder_tris, np.float32).reshape(-1, 3, 3)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    tri_a = as_t(occluder_tris[:, 0])
    tri_e1 = as_t(occluder_tris[:, 1] - occluder_tris[:, 0])
    tri_e2 = as_t(occluder_tris[:, 2] - occluder_tris[:, 0])
    lights = as_t(np.asarray(point_lights, np.float32).reshape(-1, 9))
    tri_lo = torch.minimum(tri_a, torch.minimum(tri_a + tri_e1, tri_a + tri_e2))
    tri_hi = torch.maximum(tri_a, torch.maximum(tri_a + tri_e1, tri_a + tri_e2))

    def visible(pts, delta, tris):
        """Shadow rays pts + t * delta, 0 < t < 1, against the occluders
        `tris` (indices): [B] bool, True where none lies between."""
        step = max(1, MAX_PAIRS // max(pts.shape[0], 1))
        vis = torch.ones(pts.shape[0], dtype=torch.bool, device=dev)
        for t0 in range(0, tris.shape[0], step):
            sl = tris[t0 : t0 + step]
            e1, e2, a = tri_e1[sl], tri_e2[sl], tri_a[sl]
            h = _cross(delta[:, None, :], e2[None])
            det = _dot(e1[None], h)
            ok = det.abs() > 1e-9
            inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
            s = pts[:, None, :] - a[None]
            u = _dot(s, h) * inv
            qv = _cross(s, e1[None])
            v = _dot(delta[:, None, :], qv) * inv
            t = _dot(e2[None], qv) * inv
            hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-4) & (t < 1.0 - 1e-4)
            vis &= ~hit.any(1)
        return vis

    def shade(pts):
        """pts [B,3] -> radiance [B,3] (numpy float32); the editor's term is
        cosine-free, so the surface normal plays no part.

        Shadow rays are cast only where they can matter: from the points
        the light reaches (falloff > 0; elsewhere the weight is 0 either
        way) and against the occluders whose boxes come within the
        farthest such point's distance of the light (a segment from a
        point to the light lies in that ball, so no other occluder can
        block it; 1e-3 m of margin). The radiance is what testing every
        pair gives."""
        pts = as_t(pts)
        out = torch.zeros_like(pts)
        for L in lights:
            lp, lc = L[:3], L[3:6]
            brightness, rng, att = L[6], L[7], L[8]
            att = att.clamp_min(1e-6)
            delta = lp[None] - pts
            dist = torch.linalg.vector_norm(delta, dim=-1).clamp_min(1e-4)
            falloff = (dist ** -att - rng.clamp_min(1e-6) ** -att).clamp_min(0.0)
            lit = torch.nonzero(falloff > 0).squeeze(1)
            if lit.numel() == 0:
                continue
            reach = dist[lit].max() * (1.0 + 1e-4) + 1e-3
            gap = torch.maximum(tri_lo - lp[None], lp[None] - tri_hi).clamp_min(0.0)
            tris = torch.nonzero(torch.linalg.vector_norm(gap, dim=-1) <= reach).squeeze(1)
            w = torch.zeros_like(falloff)
            for p0 in range(0, lit.shape[0], POINT_BLOCK):
                idx = lit[p0 : p0 + POINT_BLOCK]
                w[idx] = torch.where(visible(pts[idx], delta[idx], tris), brightness * falloff[idx], 0.0)
            out += lc[None] * w[:, None]
        return out.cpu().numpy()

    return shade
