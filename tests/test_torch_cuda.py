"""The port's CUDA kernels on the card (marker `cuda`; each test skips
where no CUDA device is present). Run them on a GPU machine with

    python -m pytest tests/test_torch_cuda.py -q

Each kernel is held against its plain PyTorch version on the same device:
positions, velocities, ray t and contacts within 1e-5 (the kernels are
built with --fmad=false, so they round as the plain version does),
`grounded`, hit/miss and the contact kernel's tie order exactly; a short
rollout on the card is held to the CPU plain path with the slice bars of
tests/test_torch_slice.py. The helpers are imported as top-level modules
of tests/ (pytest puts the directory on sys.path): where an installed
package named `tests` exists, it hides the directory as a package.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

MAPS = "c_game_engine_tpu_torch/maps"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def arena():
    from pathlib import Path

    from c_game_engine_tpu_torch.core.state import load_map

    root = Path(__file__).resolve().parents[1] / MAPS
    return lambda dev: load_map(root / "arena.npz", root / "arena.json", dev)


@pytest.mark.parametrize("layout", ["clustered", "scattered"])
def test_capsule_resolve_kernel_matches_plain(cuda, arena, layout):
    from c_game_engine_tpu_torch.ops import capsule_resolve as k1
    from torch_inputs import capsule_inputs

    args = [torch.as_tensor(a, device=cuda) for a in capsule_inputs(arena("cpu"), layout, seed=7)]
    before = k1.launches
    pk, vk, gk = k1.resolve_capsule(*args)
    assert k1.launches == before + 1
    pp, vp, gp = k1.resolve_capsule_plain(*args)
    torch.cuda.synchronize()
    assert float((pk - pp).abs().max()) <= 1e-5
    assert float((vk - vp).abs().max()) <= 1e-5
    assert torch.equal(gk, gp)


def test_ray_tris_kernel_matches_plain(cuda, arena):
    from c_game_engine_tpu_torch.ops import ray_tris as k2

    cm = arena(cuda)
    rng = np.random.default_rng(8)
    r = 1000
    o = torch.as_tensor(np.stack([rng.uniform(-20, 20, r), rng.uniform(0.1, 2.5, r),
                                  rng.uniform(-20, 20, r)], 1), dtype=torch.float32, device=cuda)
    d = torch.nn.functional.normalize(torch.as_tensor(rng.normal(size=(r, 3)), dtype=torch.float32,
                                                      device=cuda), dim=-1)
    m = torch.as_tensor(rng.uniform(1, 50, r), dtype=torch.float32, device=cuda)
    tk = k2.ray_tris(cm.tri16, cm.chunk_bounds, o, d, m)
    tp = k2.ray_tris_plain(cm.tri16, cm.chunk_bounds, o, d, m)
    torch.cuda.synchronize()
    assert torch.equal(tk < 1e29, tp < 1e29)
    assert float((tk - tp).abs().max()) <= 1e-5


def test_body_contacts_kernel_matches_plain(cuda, arena):
    """K3 on the card against its plain version: box and hull bodies, off
    and padded lanes and the built tie of tests/test_torch_bodies.py,
    bit for bit (the tie order included)."""
    from c_game_engine_tpu_torch.ops import body_contacts as k3
    from torch_inputs import k3_inputs

    *args, is_box = k3_inputs(arena("cpu"))
    args = [torch.as_tensor(a, device=cuda) for a in args] + [torch.tensor(is_box, device=cuda)]
    before = k3.launches
    ok = k3.body_contacts(*args)
    assert k3.launches == before + 1
    op = k3.body_contacts_plain(*args)
    torch.cuda.synchronize()
    assert float((ok - op).abs().max()) <= 1e-5
    assert torch.equal(ok, op)


def test_rollout_on_card_matches_cpu(cuda, arena):
    from c_game_engine_tpu_torch.models.sim import reset_batch, rollout
    from torch_parity import assert_leaves_match, stream_batch, torch_actions, torch_leaves

    streams = stream_batch(30, 256, seed=0)
    g = rollout(arena(cuda), reset_batch(arena(cuda), 256), torch_actions(*streams, device=cuda))
    c = rollout(arena("cpu"), reset_batch(arena("cpu"), 256), torch_actions(*streams))
    assert_leaves_match(torch_leaves(c), torch_leaves(g), {"player.pos": 2e-3})
