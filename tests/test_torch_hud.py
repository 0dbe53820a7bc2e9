"""The HUD and the viewmodel against the JAX package on the CPU:
render/hud.py's blit, draw_number, draw_text and render_hud, an asset-free
HUD (the committed bundles'), render_viewmodel, and render_with_hud.

The committed maps have no HUD textures, font or viewmodel model (the
shipped files are not in this checkout), so both sides get the synthetic
assets of c_game_engine_tpu_torch/render/synthetic_hud.py, built from
numpy, with procedural textures of arena_lit's atlas. Inputs are made from
numpy seeds; states are a reset of arena_lit with the HUD values of
`synthetic_hud.hud_values` (no ticks).

Tolerances: the HUD within 1e-6 of max(1, |x|). The viewmodel within 2e-4
at every pixel but those within 1e-3 px of an edge of a viewmodel
triangle (XLA's CPU code fuses its edge functions, the port does not:
tests/test_torch_render.py::test_xla_cpu_fuses_the_edge_function).
render_with_hud equals the port's render, viewmodel and HUD in sequence
bit for bit, and the JAX frame within ROADMAP's frame bar (under 0.2% of
pixels off by more than 1/255).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.torch_frames import COIN_VIEW, PortRecorder, edge_distance, jax_arena_lit, jax_env, view_states


@pytest.fixture(scope="module")
def hud_maps():
    """(port map, port bundle, JAX map, JAX bundle), both bundles with the
    synthetic HUD and viewmodel."""
    import jax.numpy as jnp

    from c_game_engine_tpu.render.hud import HudAssets
    from c_game_engine_tpu_torch.render.bundle import load_render_map
    from c_game_engine_tpu_torch.render.synthetic_hud import synthetic_arrays, with_synthetic_hud

    cm, rb = load_render_map("arena_lit", "cpu")
    jc, jb = jax_arena_lit()
    arrays = {k: jnp.asarray(v) for k, v in synthetic_arrays(rb.tex_names).items()}
    jb = jb.replace(hud=HudAssets(**{k[4:]: v for k, v in arrays.items() if k.startswith("hud.")}),
                    **{k: v for k, v in arrays.items() if k.startswith("vm_")})
    return cm, with_synthetic_hud(rb), jc, jb


def _hud_states(jc, cm, views):
    """(JAX, port) states of len(views) envs with the synthetic HUD values;
    the last env's camera is an actor's (the HUD and viewmodel hide)."""
    import jax.numpy as jnp

    from c_game_engine_tpu_torch.render.synthetic_hud import hud_states, hud_values

    js, ps = view_states(jc, cm, views)
    v = hud_values(len(views))
    cam = np.full(len(views), -1, np.int32)
    cam[-1] = 4
    js = js.replace(save=js.save.replace(coins=jnp.asarray(v["coins"]), blue_coins=jnp.asarray(v["blue_coins"]),
                                         current_item=jnp.asarray(v["current_item"])),
                    player=js.player.replace(crosshair=jnp.asarray(v["crosshair"])), camera_actor=jnp.asarray(cam))
    ps = hud_states(ps)
    return js, ps.replace(camera_actor=torch.tensor(cam))


def _close(got, want, tol=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert (np.abs(got - want) <= tol * np.maximum(1.0, np.abs(want))).all(), float(np.abs(got - want).max())


def test_hud_pieces_match_jax(hud_maps):
    """Three random frames of 112 x 320 (the HUD's rects are placed for
    frames at least 260 wide): a blit with a per-env tint and a rect off
    the frame's edge, numbers (0, a negative count shown as 0, 7 digits),
    left and centred text with skipped (-1) and absent (< 32) codes, and
    render_hud (coins, blue coins 0-2, each crosshair state, the last env
    behind an actor camera), each against the JAX function per env."""
    import jax
    import jax.numpy as jnp

    from c_game_engine_tpu.render import hud as JH
    from c_game_engine_tpu_torch.render import hud as H

    cm, rb, jc, jb = hud_maps
    rng = np.random.default_rng(21)
    frames = rng.random((3, 112, 320, 3)).astype(np.float32)
    tint = rng.uniform(0.2, 1.0, (3, 4)).astype(np.float32)
    values = np.array([0, -5, 1234567], np.int32)
    codes = np.array([[72, 105, -1, 50, 10, 126], [48, 49, 50, 51, 52, 53], [-1, -1, 88, 32, 33, 127]], np.int32)
    js, ps = _hud_states(jc, cm, [None, None, None])
    f = torch.tensor(frames)
    got = {
        "blit": H.blit(f, rb.atlas, rb.hud.ycoin_tex, 290.5, 10.0, 40, 33, torch.tensor(tint)),
        "number": H.draw_number(f, rb.atlas, rb.hud, torch.tensor(values), 30.0, 60.0, 40.0,
                                torch.tensor([0.9, 0.8, 0.3, 0.75])),
        "text_left": H.draw_text(f, rb.atlas, rb.hud, torch.tensor(codes), 12.0, 8.0, 24.0, (1.0, 0.5, 1.0, 1.0)),
        "text_center": H.draw_text(f, rb.atlas, rb.hud, torch.tensor(codes), 160.0, 70.0, 32.0, (1.0, 1.0, 1.0, 0.6),
                                   halign="center"),
        "hud": H.render_hud(rb.atlas, rb.hud, ps, f),
    }
    ja, jh = jb.atlas, jb.hud
    want_fns = {
        "blit": jax.jit(lambda fr, m: JH.blit(fr, ja, jh.ycoin_tex, 290.5, 10.0, 40, 33, m)),
        "number": jax.jit(lambda fr, v: JH.draw_number(fr, ja, jh, v, 30.0, 60.0, 40.0,
                                                       jnp.array([0.9, 0.8, 0.3, 0.75]))),
        "text_left": jax.jit(lambda fr, c: JH.draw_text(fr, ja, jh, c, 12.0, 8.0, 24.0, jnp.array([1.0, 0.5, 1.0, 1.0]))),
        "text_center": jax.jit(lambda fr, c: JH.draw_text(fr, ja, jh, c, 160.0, 70.0, 32.0,
                                                          jnp.array([1.0, 1.0, 1.0, 0.6]), halign="center")),
        "hud": jax.jit(lambda fr, s: JH.render_hud(ja, jh, s, fr)),
    }
    args = {"blit": tint, "number": values, "text_left": codes, "text_center": codes}
    for name, fn in want_fns.items():
        for e in range(3):
            extra = jax_env(js, e) if name == "hud" else args[name][e]
            want = np.asarray(fn(frames[e], extra))
            _close(got[name][e].numpy(), want)
            changed = (np.abs(want - frames[e]).max(-1) > 1e-3).sum()
            if name != "hud" or e < 2:
                assert changed > 50, (name, e)
            else:
                assert changed == 0
    assert torch.equal(got["hud"][2], f[2])


def test_asset_free_hud_leaves_frames_as_they_are():
    """The committed arena_lit bundle has HUD ids of -1 and no viewmodel
    rows, as the JAX bundle built without the shipped files: the HUD and
    the viewmodel sample texture 0 and mask it, so the frames come back
    unchanged, on both sides."""
    import jax

    from c_game_engine_tpu.render import hud as JH
    from c_game_engine_tpu.render.raster import render_viewmodel as j_viewmodel
    from c_game_engine_tpu_torch.render.bundle import load_render_map
    from c_game_engine_tpu_torch.render.hud import render_hud
    from c_game_engine_tpu_torch.render.raster import render_viewmodel_batch

    cm, rb = load_render_map("arena_lit", "cpu")
    jc, jb = jax_arena_lit()
    assert int(rb.hud.font_tex) == int(rb.hud.ycoin_tex) == -1 and rb.vm_pos.shape[0] == 0
    js, ps = _hud_states(jc, cm, [None, None])
    frames = np.random.default_rng(22).random((2, 64, 288, 3)).astype(np.float32)
    f = torch.tensor(frames)
    assert torch.equal(render_hud(rb.atlas, rb.hud, ps, render_viewmodel_batch(rb, ps, f)), f)
    want = jax.jit(lambda fr, s: JH.render_hud(jb.atlas, jb.hud, s, j_viewmodel(jb, s, fr)))(frames[0], jax_env(js, 0))
    np.testing.assert_array_equal(np.asarray(want), frames[0])


def test_viewmodel_matches_jax(hud_maps, monkeypatch):
    """The synthetic viewmodel over three random 96 x 128 frames: env 0
    with the eraser selected and a view bob, env 1 with no item selected,
    env 2 behind an actor camera; against the JAX render_viewmodel per
    env: within 2e-4 except within 1e-3 px of an edge of a viewmodel
    triangle; shown on env 0 only."""
    import jax
    import jax.numpy as jnp

    from c_game_engine_tpu.render.raster import render_viewmodel as j_viewmodel
    from c_game_engine_tpu_torch.render.raster import render_viewmodel_batch

    cm, rb, jc, jb = hud_maps
    js, ps = _hud_states(jc, cm, [None, None, None])
    item = np.array([0, -1, 0], np.int32)
    bob = np.array([0.4, 0.0, 0.0], np.float32)
    js = js.replace(save=js.save.replace(current_item=jnp.asarray(item)),
                    player=js.player.replace(view_bob=jnp.asarray(bob)))
    ps = ps.replace(save=ps.save.replace(current_item=torch.tensor(item)),
                    player=ps.player.replace(view_bob=torch.tensor(bob)))
    frames = np.random.default_rng(23).random((3, 96, 128, 3)).astype(np.float32)
    rec = PortRecorder(monkeypatch)
    got = render_viewmodel_batch(rb, ps, torch.tensor(frames)).numpy()
    (sx, sy, _, _), = rec.z
    run = jax.jit(lambda s, fr: j_viewmodel(jb, s, fr))
    gy, gx = np.meshgrid(np.arange(96) + 0.5, np.arange(128) + 0.5, indexing="ij")
    for e in range(3):
        want = np.asarray(run(jax_env(js, e), frames[e]))
        xy = np.stack([sx[e].numpy(), sy[e].numpy()], -1).astype(np.float64)[:12]
        on_edge = np.min([edge_distance(np.broadcast_to(t, (96, 128, 3, 2)), gx, gy) for t in xy], 0) <= 1e-3
        err = np.abs(got[e] - want).max(-1)
        assert err[~on_edge].max() <= 2e-4, int((err[~on_edge] > 2e-4).sum())
        shown = (np.abs(want - frames[e]).max(-1) > 0).sum()
        assert (shown > 200) if e == 0 else (shown == 0 and np.array_equal(got[e], frames[e]))


def test_render_with_hud_matches_jax(hud_maps):
    """One env at 128 x 256 facing a coin, the eraser selected: the port's
    render_with_hud is its render, viewmodel and HUD in sequence, bit for
    bit, and the batched call's env; against the JAX render_with_hud
    within the frame bar; the crosshair and the viewmodel show."""
    import jax

    from c_game_engine_tpu.render.raster import render_with_hud as j_with_hud
    from c_game_engine_tpu_torch.core.state import tree_map
    from c_game_engine_tpu_torch.render import raster as R
    from c_game_engine_tpu_torch.render.hud import render_hud

    cm, rb, jc, jb = hud_maps
    js, ps = _hud_states(jc, cm, [COIN_VIEW, None])
    one, first = tree_map(lambda x: x[0], ps), tree_map(lambda x: x[:1], ps)
    got = R.render_with_hud(rb, cm, one, 128, 256)
    world = R.render(rb, cm, one, 128, 256)
    assert torch.equal(got, render_hud(rb.atlas, rb.hud, first, R.render_viewmodel_batch(rb, first, world[None]))[0])
    assert torch.equal(R.render_with_hud_batch(rb, cm, first, 128, 256)[0], got)
    want = np.asarray(jax.jit(lambda s: j_with_hud(jb, jc, s, 128, 256, backend="xla"))(jax_env(js, 0)))
    off = np.abs(got.numpy() - want).max(-1) > 1 / 255
    assert off.mean() < 0.002, int(off.sum())
    changed = (got - world).abs().amax(-1) > 1 / 255
    assert changed[56:72, 116:140].float().mean() > 0.3  # the crosshair
    assert changed.float().mean() > 0.02  # the viewmodel, the coin counter and icons
