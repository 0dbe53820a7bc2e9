"""Shared helpers of the port's frame tests (tests/test_torch_render*.py,
tests/test_torch_hud.py): arena_lit in the JAX package, states with a
chosen camera on both sides, and the comparison of a port frame with the
JAX frame of the same state.

The JAX side renders on its XLA route (the CPU's), whose pass 1 XLA's CPU
code compiles with fused multiply-adds; the port's ops and kernels do not
fuse (tests/test_torch_render.py::test_xla_cpu_fuses_the_edge_function).
So a pixel centre on a triangle edge may go to the other triangle, and a
lightmap uv, or the uv of a nearest-filtered texture, on a texel boundary
to the other texel. `check_frames` reads
both sides' z passes and pass-1 attributes and excuses a pixel only after
checking that it lies on such a boundary.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np

# a free-camera view (actor, eye offset from its position, yaw, pitch):
# the third coin 0.6 m ahead, its alpha-0 texels give the reveal work
# (render/graph_check.py::CLOSE_COIN, 0.12 m from it, overflows it)
COIN_VIEW = (2, (0.0, 0.0, 0.6), 0.0, 0.0)


@functools.cache
def jax_arena_lit():
    """(JAX CompiledMap, JAX RenderBundle) of arena_lit, built once per process."""
    from c_game_engine_tpu.render.bundle import build_render_bundle
    from tests.torch_export_map import compile_arena_lit

    jc = compile_arena_lit()
    return jc, build_render_bundle(jc)


def view_states(jc, cm, views):
    """(JAX state, port state) of len(views) envs after reset; env e looks
    through its free camera placed by views[e] = (actor, eye offset, yaw,
    pitch), or from the spawn where views[e] is None."""
    import jax
    import jax.numpy as jnp

    from c_game_engine_tpu.models.sim import reset_batch
    from c_game_engine_tpu_torch.core.state import state_from_numpy

    js = reset_batch(jc, len(views))
    p = js.player
    freecam, eye = np.asarray(p.freecam).copy(), np.asarray(p.freecam_pos).copy()
    yaw, pitch = np.asarray(p.yaw).copy(), np.asarray(p.pitch).copy()
    for e, v in enumerate(views):
        if v is not None:
            actor, off, yaw[e], pitch[e] = v
            freecam[e], eye[e] = True, np.asarray(js.actors.pos[e, actor]) + off
    js = js.replace(player=p.replace(freecam=jnp.asarray(freecam), freecam_pos=jnp.asarray(eye),
                                     yaw=jnp.asarray(yaw), pitch=jnp.asarray(pitch)))
    return js, state_from_numpy(jax.tree.map(np.asarray, js), cm)


def jax_env(js, e):
    """Env e of a batched JAX state, without its batch axis."""
    import jax

    return jax.tree.map(lambda x: x[e], js)


def edge_distance(tris, gx, gy):
    """Distance in pixels from each pixel centre to the nearest edge line of
    its triangle: tris [..., 3, 2] screen vertices per pixel, float64."""
    d = np.full(gx.shape, np.inf)
    for i, j in ((0, 1), (1, 2), (2, 0)):
        a, b = tris[..., i, :], tris[..., j, :]
        e = (b[..., 0] - a[..., 0]) * (gy - a[..., 1]) - (b[..., 1] - a[..., 1]) * (gx - a[..., 0])
        d = np.minimum(d, np.abs(e) / np.maximum(np.hypot(b[..., 0] - a[..., 0], b[..., 1] - a[..., 1]), 1e-30))
    return d


class PortRecorder:
    """Records, for the port's render path, each z pass (screen x, y of the
    rows, the exclude image, the winner image; the xla route's _pass1_xla
    and K4's calls) and each full-frame shade's pass data."""

    def __init__(self, monkeypatch):
        from c_game_engine_tpu_torch.ops import raster_tiles as K4
        from c_game_engine_tpu_torch.render import raster as R

        self.z, self.shade = [], []
        p1, k4, sg = R._pass1_xla, K4.raster_tiles_binned, R._shade_generic

        def rec_p1(sx, sy, sz, tri_ok, gx, gy, exclude=None):
            win = p1(sx, sy, sz, tri_ok, gx, gy, exclude)
            self.z.append((sx, sy, exclude, win))
            return win

        def rec_k4(tri48, tri_ok, h, w, exclude=None, tile_on=None):
            out = k4(tri48, tri_ok, h, w, exclude=exclude, tile_on=tile_on)
            xy = tri48[..., :6].reshape(*tri48.shape[:2], 3, 2)
            self.z.append((xy[..., 0], xy[..., 1], exclude, out[1]))
            return out

        def rec_shade(bundle, state, pass_data, gxx, *rest):
            if gxx.ndim == 3:  # a full frame [B, H, W], not packed tiles
                self.shade.append(pass_data)
            return sg(bundle, state, pass_data, gxx, *rest)

        monkeypatch.setattr(R, "_pass1_xla", rec_p1)
        monkeypatch.setattr(K4, "raster_tiles_binned", rec_k4)
        monkeypatch.setattr(R, "_shade_generic", rec_shade)

    def env(self, e=0):
        """(z passes, full-frame shades) of env e as numpy."""
        z = [(sx[e].numpy(), sy[e].numpy(), None if ex is None else ex[e].numpy(), win[e].numpy())
             for sx, sy, ex, win in self.z]
        return z, [tuple(x[e].numpy() for x in pd) for pd in self.shade]


class JaxRecorder:
    """The JAX side's records of one env (the render function vmapped over
    a batch of 1): _pass1_xla's calls and the full-frame shades, through
    debug callbacks tagged with their trace order."""

    def __init__(self, monkeypatch):
        import jax
        import jax.numpy as jnp

        from c_game_engine_tpu.render import raster as JR

        self.z, self.shade = [], []
        p1, sg = JR._pass1_xla, JR._shade_generic
        z_order, shade_order = itertools.count(), itertools.count()

        def rec_p1(sx, sy, sz, tri_ok, gx, gy, height, width, exclude=None):
            win = p1(sx, sy, sz, tri_ok, gx, gy, height, width, exclude=exclude)
            ex = jnp.full((height, width), -1, jnp.int32) if exclude is None else exclude
            k = next(z_order)
            jax.debug.callback(lambda *a: self.z.append((k, *map(np.asarray, a))), sx, sy, ex, win)
            return win

        def rec_shade(bundle, state, pass_data, gxx, *rest):
            if gxx.ndim == 2:  # a full frame [H, W], not packed tiles
                k = next(shade_order)
                jax.debug.callback(lambda *a: self.shade.append((k, *map(np.asarray, a))), *pass_data)
            return sg(bundle, state, pass_data, gxx, *rest)

        monkeypatch.setattr(JR, "_pass1_xla", rec_p1)
        monkeypatch.setattr(JR, "_shade_generic", rec_shade)

    def env(self):
        """(z passes, full-frame shades) in trace order."""
        return [r[1:] for r in sorted(self.z, key=lambda r: r[0])], [r[1:] for r in sorted(self.shade,
                                                                                            key=lambda r: r[0])]


def _nearest_texels(atlas, enc, uv):
    """The texel (x, y) a nearest-filtered lookup of each pixel takes (its
    texture and level from the enc word), and its distance in texels from
    the texel's boundary, the fraction 0.5 (-1 and inf on pixels of
    bilinear textures)."""
    tex = np.clip((enc & 0xFFF) - 1, 0, None)
    level = np.round(((enc >> 15) & 63) * 0.25).astype(np.int64)
    rect = atlas.mip_pairs.numpy().reshape(-1, 8)[tex * atlas.mips.shape[1] + level][..., :4]
    repeat = ((enc >> 21) & 1 == 1)[..., None]
    u = np.where(repeat, uv - np.floor(uv), np.clip(uv, 0.0, 1.0))
    f = u * rect[..., 2:4] - 0.5
    f = np.where(repeat, f, np.minimum(np.maximum(f, 0.0), np.maximum(rect[..., 2:4] - 1.0, 0.0)))
    frac = f - np.floor(f)
    nearest = ((enc >> 22) & 1 == 0)[..., None]
    return (np.where(nearest, np.floor(f) + (frac > 0.5), -1), np.where(nearest, np.abs(frac - 0.5), np.inf))


def check_frames(got, want, port, jax_, bundle, ssaa=1, bar=2e-4):
    """Hold one env's port frame `got` [H, W, 3] to the JAX frame `want`
    with the records of both sides ((z passes, shades) of PortRecorder.env
    and JaxRecorder.env, at the rendered size: ssaa times the frame's) and
    the port's bundle:
      1. a pixel's winner (pass 1; the reveal pass where either side uses
         it) differs only within 1e-3 px of an edge of one side's winner
         (the triangle whose coverage flips wins on the side that covers
         the pixel with it), and on at most 0.2% of pixels;
      2. where the winners agree: the pass-1 enc word exactly, uv,
         lightmap uv, colour and depth within 1e-4 of max(1, |x|);
      3. a lightmap texel, or the texel of a nearest-filtered texture,
         differs only where both sides' uv lie within 1e-3 texel of that
         texel's boundary;
      4. every other pixel (with ssaa, every pixel whose samples are all
         such pixels) within `bar`.
    Returns the number of pixels excused."""
    (pz, pshade), (jz, jshade) = port, jax_
    assert len(pz) == len(jz) >= 1, (len(pz), len(jz))
    h, w = pz[0][3].shape
    gy, gx = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5, indexing="ij")
    differ = []
    for k, ((psx, psy, pex, pwin), (jsx, jsy, jex, jwin)) in enumerate(zip(pz, jz)):
        d = pwin != jwin
        if k:
            d &= ((pex if pex is not None else -1) >= 0) | (jex >= 0)
        # the triangle whose coverage flips is the winner of the side that
        # covers the pixel with it: the pixel lies on an edge of one winner
        near = np.zeros_like(d)
        for win, sx, sy in ((pwin, psx, psy), (jwin, jsx, jsy)):
            xy = np.stack([sx, sy], -1).astype(np.float64)
            near |= (win >= 0) & (edge_distance(xy[np.maximum(win, 0)], gx, gy) <= 1e-3)
        off = d & ~near
        assert not off.any(), f"pass {k + 1}: {int(off.sum())} pixels change winner off an edge of either winner"
        differ.append(d)
    same = ~np.any(differ, 0)
    assert (~same).mean() <= 0.002, f"{int((~same).sum())} pixels change winner"

    _, pwin1, puv, plm, pcol, pdep, penc = pshade[0]
    _, _, juv, jlm, jcol, jdep, jenc = jshade[0]
    m = same & (pwin1 >= 0)
    np.testing.assert_array_equal(penc[m], jenc[m])
    for name, g, j in (("uv", puv, juv), ("lmuv", plm, jlm), ("color", pcol, jcol), ("depth", pdep, jdep)):
        assert (np.abs(g[m] - j[m]) <= 1e-4 * np.maximum(1.0, np.abs(j[m]))).all(), name

    lh, lw = bundle.lightmap.shape[:2]
    lit_px = ((penc >> 12) & 3 == 0) & ((penc >> 14) & 1 == 1) & m
    cells = [np.clip(plm * [lw, lh], 0, None), np.clip(jlm * [lw, lh], 0, None)]
    lm_differ = lit_px & (cells[0].astype(np.int32) != cells[1].astype(np.int32)).any(-1)
    on_line = lambda c: (np.abs(c - np.round(c)) <= 1e-3).any(-1)
    assert (on_line(cells[0]) & on_line(cells[1]))[lm_differ].all()
    (pt, pd), (jt, jd) = _nearest_texels(bundle.atlas, penc, puv), _nearest_texels(bundle.atlas, penc, juv)
    texel_differ = m & (pt != jt).any(-1)
    assert ((pd <= 1e-3) & (jd <= 1e-3)).any(-1)[texel_differ].all()

    held = same & ~lm_differ & ~texel_differ
    if ssaa > 1:
        held = held.reshape(h // ssaa, ssaa, w // ssaa, ssaa).all((1, 3))
    err = np.abs(np.asarray(got) - np.asarray(want)).max(-1)
    assert err[held].max() <= bar, f"{int((err[held] > bar).sum())} pixels off by more than {bar}"
    return int((~held).sum())
