"""The port's dual-level atlas (render/textures.py: build_atlas(dual=True),
_sample_dual and sample's dual branch), held to the JAX package on the CPU
on the textures and taps of tests/test_render.py::
test_dual_atlas_sampling_matches_two_tap: the dual rows equal JAX's bit for
bit, and sampling through them equals the two-tap path bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests import torch_parity  # noqa: F401  (one torch thread a process)


class _Tex:
    """tests/test_render.py's texture: seeded random texels and flags."""

    def __init__(self, w, h, repeat, filt, mips):
        rng = np.random.RandomState((w * 31 + h * 7 + repeat * 3 + filt) % 2**31)
        self.pixels = rng.rand(h, w, 4).astype(np.float32)
        self.repeat, self.filter, self.mipmaps = repeat, filt, mips


TEXTURES = [
    _Tex(64, 64, True, True, True),
    _Tex(32, 16, False, True, True),
    _Tex(128, 128, True, False, True),
    _Tex(8, 8, False, False, True),
    _Tex(16, 16, True, True, False),
]


def _taps(n=4096):
    rng = np.random.RandomState(0)
    tid = rng.randint(0, len(TEXTURES), n)
    uv = rng.uniform(-1.5, 2.5, (n, 2)).astype(np.float32)
    lod = rng.uniform(0, 7, n).astype(np.float32)
    return tid, uv, lod


def _bits(t):
    """A bfloat16 or float32 tensor's bit patterns."""
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32).numpy()


@pytest.mark.parametrize("blocked_dtype", ["bfloat16", "float32"])
def test_dual_rows_equal_jax(blocked_dtype):
    import jax.numpy as jnp

    from c_game_engine_tpu.render.textures import build_atlas as j_build
    from c_game_engine_tpu_torch.render.textures import build_atlas

    want = j_build(TEXTURES, dual=True, blocked_dtype=getattr(jnp, blocked_dtype))
    got = build_atlas(TEXTURES, dual=True, blocked_dtype=getattr(torch, blocked_dtype), device="cpu")
    assert got.dual.dtype == got.blocked.dtype == getattr(torch, blocked_dtype)
    for name in ("dual", "blocked"):
        w = np.asarray(getattr(want, name))
        g = getattr(got, name)
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(_bits(g), w.view(np.int16 if blocked_dtype == "bfloat16" else np.int32))
    for name in ("table", "mips", "n_mips", "mip_pairs", "flag_words"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    assert build_atlas(TEXTURES, device="cpu").dual is None


@pytest.mark.parametrize("blocked_dtype", ["bfloat16", "float32"])
def test_dual_sampling_equals_two_tap(blocked_dtype):
    """Across repeat and clamp, filter and nearest, power-of-two chains, a
    texture without a chain and out-of-range uv and lod."""
    from c_game_engine_tpu_torch.render.textures import build_atlas, sample

    dt = getattr(torch, blocked_dtype)
    a_dual = build_atlas(TEXTURES, dual=True, blocked_dtype=dt, device="cpu")
    a_ref = build_atlas(TEXTURES, blocked_dtype=dt, device="cpu")
    tid, uv, lod = (torch.as_tensor(x) for x in _taps())
    got = sample(a_dual, tid, uv, lod=lod)
    want = sample(a_ref, tid, uv, lod=lod)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # the dual rows served the trilinear taps: a dual atlas without its
    # blocked rows samples the same
    bare = build_atlas(TEXTURES, dual=True, blocked_dtype=dt, device="cpu")
    bare.blocked = torch.full_like(bare.blocked, float("nan"))
    np.testing.assert_array_equal(_bits(sample(bare, tid, uv, lod=lod)), _bits(want))


def test_dual_sampling_matches_jax():
    """The port's dual branch against the JAX one on the same taps (XLA may
    fuse the blend's a + (b - a) * t into an FMA: within 1e-6)."""
    import jax.numpy as jnp

    from c_game_engine_tpu.render.textures import build_atlas as j_build, sample as j_sample
    from c_game_engine_tpu_torch.render.textures import build_atlas, sample

    tid, uv, lod = _taps()
    want = np.asarray(j_sample(j_build(TEXTURES, dual=True), jnp.asarray(tid), jnp.asarray(uv),
                               lod=jnp.asarray(lod)))
    got = sample(build_atlas(TEXTURES, dual=True, device="cpu"), torch.as_tensor(tid), torch.as_tensor(uv),
                 lod=torch.as_tensor(lod)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
