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
luxel at a bar, not bit for bit.

`make_shader(bounces > 0)` adds the JAX module's one-bounce estimate (not
part of the editor's model, kept for lighting experiments): from each
point, N_BOUNCE cosine-weighted directions about its surface normal find
their nearest occluder, whose direct radiance, times `albedo`, is averaged
in. Any bounces > 0 adds one bounce, as in the JAX module.
"""

from __future__ import annotations

import numpy as np
import torch

# The fitted output gain is 1.0 (0.98-1.01 on both calibration maps): the
# editor writes radiance in these natural units directly.
GAIN = 1.0
# Kept for API compatibility with experiments; the recovered editor model
# has no indirect term, so bakes default to direct-only.
ALBEDO = 0.35
N_BOUNCE = 16
# (point, occluder) pairs per chunk of the shadow-ray test: three
# [B, T, 3] float32 intermediates of 48 MB each at this size
MAX_PAIRS = 1 << 22
# sample points per block; the occluder chunk is MAX_PAIRS // POINT_BLOCK
POINT_BLOCK = 1 << 16


def _hammersley(n: int) -> np.ndarray:
    """[n, 2] deterministic low-discrepancy points (van der Corput base 2)."""
    u = (np.arange(n) + 0.5) / n
    v = np.zeros(n)
    for i in range(n):
        x, f, r = i, 0.5, 0.0
        while x:
            r += f * (x & 1)
            x >>= 1
            f *= 0.5
        v[i] = r
    return np.stack([u, v], -1)


def _cosine_dirs(n: int) -> np.ndarray:
    """[n, 3] cosine-weighted hemisphere dirs around +Z (pdf = cos/pi)."""
    uv = _hammersley(n)
    r = np.sqrt(uv[:, 0])
    phi = 2.0 * np.pi * uv[:, 1]
    return np.stack(
        [r * np.cos(phi), r * np.sin(phi), np.sqrt(np.maximum(1.0 - uv[:, 0], 0.0))], -1
    ).astype(np.float32)


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def make_shader(point_lights, occluder_tris, bounces: int = 0, albedo: float = ALBEDO, device="cuda"):
    """Returns shade(pts [B,3], normals [B,3] or None) -> [B,3] radiance
    (host float32 arrays in and out), computed on `device` over the map's
    light set and occluder soup with the recovered editor model above. A
    point's radiance does not depend on the others, so any set of points
    may share a call. bounces > 0 adds the one-bounce estimate, which needs
    each point's surface normal; the direct term ignores it."""
    dev = torch.device(device)
    occluder_tris = np.asarray(occluder_tris, np.float32).reshape(-1, 3, 3)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    tri_a = as_t(occluder_tris[:, 0])
    tri_e1 = as_t(occluder_tris[:, 1] - occluder_tris[:, 0])
    tri_e2 = as_t(occluder_tris[:, 2] - occluder_tris[:, 0])
    lights = as_t(np.asarray(point_lights, np.float32).reshape(-1, 9))
    tri_lo = torch.minimum(tri_a, torch.minimum(tri_a + tri_e1, tri_a + tri_e2))
    tri_hi = torch.maximum(tri_a, torch.maximum(tri_a + tri_e1, tri_a + tri_e2))
    tri_n = as_t(np.cross(occluder_tris[:, 1] - occluder_tris[:, 0], occluder_tris[:, 2] - occluder_tris[:, 0]))
    tri_n = tri_n / torch.linalg.vector_norm(tri_n, dim=-1, keepdim=True).clamp_min(1e-12)
    bdirs = as_t(_cosine_dirs(N_BOUNCE))

    def moller_trumbore(origins, dirs, sl):
        """(ok, u, v, t) [R, T] of rays origins + t * dirs against the
        occluders `sl` (indices or a slice)."""
        e1, e2, a = tri_e1[sl], tri_e2[sl], tri_a[sl]
        h = _cross(dirs[:, None, :], e2[None])
        det = _dot(e1[None], h)
        ok = det.abs() > 1e-9
        inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
        s = origins[:, None, :] - a[None]
        u = _dot(s, h) * inv
        qv = _cross(s, e1[None])
        v = _dot(dirs[:, None, :], qv) * inv
        t = _dot(e2[None], qv) * inv
        return ok, u, v, t

    def visible(pts, delta, tris):
        """Shadow rays pts + t * delta, 0 < t < 1, against the occluders
        `tris` (indices): [B] bool, True where none lies between."""
        step = max(1, MAX_PAIRS // max(pts.shape[0], 1))
        vis = torch.ones(pts.shape[0], dtype=torch.bool, device=dev)
        for t0 in range(0, tris.shape[0], step):
            ok, u, v, t = moller_trumbore(pts, delta, tris[t0 : t0 + step])
            hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-4) & (t < 1.0 - 1e-4)
            vis &= ~hit.any(1)
        return vis

    def direct(pts):
        """pts [B,3] on the device -> the editor's direct radiance [B,3].

        Shadow rays are cast only where they can matter: from the points
        the light reaches (falloff > 0; elsewhere the weight is 0 either
        way) and against the occluders whose boxes come within the
        farthest such point's distance of it (a segment from a point to the
        light lies in that ball, so no other occluder can block it; 1e-3 m
        of margin). The radiance is what testing every pair gives."""
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
        return out

    def nearest_hit(origins, dirs):
        """origins/dirs [R,3] -> (hit [R], point [R,3], normal [R,3] turned
        toward the ray's origin) of each ray's nearest occluder (the first
        of equal ones, as jnp.argmin takes it)."""
        step = max(1, MAX_PAIRS // POINT_BLOCK)
        tb = torch.full((origins.shape[0],), torch.inf, device=dev)
        best = torch.zeros(origins.shape[0], dtype=torch.long, device=dev)
        for r0 in range(0, origins.shape[0], POINT_BLOCK):
            rs = slice(r0, r0 + POINT_BLOCK)
            for t0 in range(0, tri_a.shape[0], step):
                ok, u, v, t = moller_trumbore(origins[rs], dirs[rs], slice(t0, t0 + step))
                good = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-3)
                t_min, k = torch.where(good, t, torch.inf).min(1)
                closer = t_min < tb[rs]
                tb[rs] = torch.where(closer, t_min, tb[rs])
                best[rs] = torch.where(closer, k + t0, best[rs])
        hit = torch.isfinite(tb)
        ph = origins + dirs * torch.where(hit, tb, 0.0)[:, None]
        nh = tri_n[best]
        flip = torch.sign(-torch.sum(nh * dirs, -1))
        nh = nh * torch.where(flip == 0, 1.0, flip)[:, None]
        return hit, ph, nh

    def shade(pts, normals=None):
        """pts [B,3] (normals [B,3] with bounces) -> radiance [B,3], numpy
        float32."""
        pts = as_t(pts)
        out = direct(pts)
        if bounces > 0 and tri_a.shape[0] > 0:
            b = pts.shape[0]
            normal = as_t(normals).reshape(b, 3)
            # orthonormal basis around each normal
            up = torch.where((normal[:, 1].abs() < 0.9)[:, None], as_t([0.0, 1.0, 0.0]), as_t([1.0, 0.0, 0.0]))
            tx = _cross(up, normal)
            tx = tx / torch.linalg.vector_norm(tx, dim=-1, keepdim=True).clamp_min(1e-9)
            ty = _cross(normal, tx)
            # every point's N_BOUNCE directions as one ray set [K * B]
            world_dirs = (bdirs[:, None, 0:1] * tx[None] + bdirs[:, None, 1:2] * ty[None]
                          + bdirs[:, None, 2:3] * normal[None]).reshape(-1, 3)
            origins = (pts + normal * 1e-3).repeat(N_BOUNCE, 1)
            hit, ph, nh = nearest_hit(origins, world_dirs)
            li = torch.where(hit[:, None], direct(ph + nh * 1e-3), 0.0)
            out = out + albedo * li.reshape(N_BOUNCE, b, 3).mean(0)
        return out.cpu().numpy()

    return shade
