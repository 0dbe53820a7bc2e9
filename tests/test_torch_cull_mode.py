"""render/raster.py's CULL_MODE switch in both packages, on the CPU: with
the JAX module's CULL_MODE and the port's set alike ("pos": the other
winding; "none": every valid row), arena_lit's frames from the port's tile,
xla and big routes (backend "pallas", "xla", "pallas_big") are held to
the JAX frames (its XLA route, the CPU's) under ROADMAP's frame bar (under
0.2% of pixels off by more than 1/255), and each mode shows in the port's
frames: "pos" changes the frame, "none" (a closed arena's back faces lie
behind its front faces) lets more rows reach K4's plain version. BACKEND is what backend=None means in both packages. The switch
on the card's render graph: tests/test_torch_cuda.py::
test_render_graph_follows_cull_mode.
"""

from __future__ import annotations

import numpy as np
import pytest

import tests.torch_parity  # noqa: F401 - one torch thread a process
from tests.torch_frames import COIN_VIEW, jax_arena_lit, view_states

H, W = 64, 128
ROUTES = {"tiles": "pallas", "xla": "xla", "big": "pallas_big"}


@pytest.fixture(scope="module")
def lit():
    from c_game_engine_tpu_torch.render.bundle import load_render_map

    cm, rb = load_render_map("arena_lit", "cpu")
    jc, jb = jax_arena_lit()
    js, ps = view_states(jc, cm, [COIN_VIEW, None])
    return cm, rb, jc, jb, js, ps


def _off(a, b):
    return float((np.abs(a - b).max(-1) > 1 / 255).mean())


@pytest.mark.parametrize("mode", ["neg", "pos", "none"])
def test_cull_mode_reaches_both_packages(lit, monkeypatch, mode):
    import jax

    from c_game_engine_tpu.render import raster as JR
    from c_game_engine_tpu_torch.render import raster as R

    cm, rb, jc, jb, js, ps = lit
    live = []
    binned = R.K4.raster_tiles_binned
    monkeypatch.setattr(R.K4, "raster_tiles_binned",
                        lambda tri48, tri_ok, *a, **k: live.append(int(tri_ok.sum())) or binned(tri48, tri_ok, *a, **k))
    neg = {route: R.render_batch(rb, cm, ps, H, W, backend=b).numpy() for route, b in ROUTES.items()}
    monkeypatch.setattr(JR, "CULL_MODE", mode)
    monkeypatch.setattr(R, "CULL_MODE", mode)
    live_neg, live[:] = live[0], []
    want = np.asarray(jax.jit(lambda s: JR.render_batch(jb, jc, s, H, W, backend="xla"))(js))
    for route, backend in ROUTES.items():
        assert R._resolve_backend(backend, H, W, rb) == route
        got = R.render_batch(rb, cm, ps, H, W, backend=backend).numpy()
        assert got.shape == want.shape
        assert _off(got, want) < 0.002, (route, _off(got, want))
        if mode == "pos":
            assert _off(got, neg[route]) > 0.01, (route, _off(got, neg[route]))
    if mode == "none":
        assert live[0] > live_neg, (live[0], live_neg)


def test_backend_is_what_none_means(lit, monkeypatch):
    """backend=None renders the route of the module's BACKEND ("auto" by
    default, as in the JAX module)."""
    from c_game_engine_tpu.render import raster as JR
    from c_game_engine_tpu_torch.render import raster as R

    cm, rb, *_ , ps = lit
    assert R.BACKEND == JR.BACKEND == "auto"
    assert R.CULL_MODE == JR.CULL_MODE == "neg"
    assert R._resolve_backend(None, H, W, rb) == "tiles"
    for backend, route in (("xla", "xla"), ("pallas_big", "big")):
        monkeypatch.setattr(R, "BACKEND", backend)
        assert R._resolve_backend(None, H, W, rb) == route
        np.testing.assert_array_equal(R.render_batch(rb, cm, ps, H, W).numpy(),
                                      R.render_batch(rb, cm, ps, H, W, backend=backend).numpy())
