"""The port's CUDA kernels on the card (marker `cuda`; each test skips
where no CUDA device is present). Run them on a GPU machine with

    python -m pytest tests/test_torch_cuda.py -q

Each kernel is held against its plain PyTorch version on the same device,
bit for bit (the kernels are built with --fmad=false, so they round as the
plain versions do): K1's positions, velocities and `grounded`, K2's t,
K3's contacts with their tie order, K4's 12 planes and K5's, on random
inputs and on tables of exact ties and edges (K2's edge table, K4's
binning edge table, K5's sub-pixel table); a short rollout on
the card is held to the CPU plain path with the slice bars of
tests/test_torch_slice.py, and a render to the CPU's with the frame bar;
the captured tick graph is held to the eager loop bit for bit, on the
scripted streams, on the gate states and through rollout_collect
(models/graph_check.py); the render graphs to the eager render bit for
bit with the reveal overflow gate closed and open
(render/graph_check.py), and each render option on the card to the CPU;
the PCM mix on the card to the CPU plain path on the same inputs (1e-5),
and two mesh shards on the one card to the unsharded rollout, bit for bit.
The helpers are imported as top-level modules of tests/ (pytest puts the
directory on sys.path): where an installed package named `tests` exists,
it hides the directory as a package.
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


@pytest.mark.parametrize("layout", ["clustered", "scattered", "tie"])
def test_capsule_resolve_kernel_matches_plain(cuda, arena, layout):
    """K1 on the card against its plain version, bit for bit; "tie" is the
    table of exact ties (first deepest triangle in list order, across a
    warp's threads and across chunks; a box only when strictly deeper;
    the first of two equal boxes)."""
    from c_game_engine_tpu_torch.ops import capsule_resolve as k1
    from torch_inputs import capsule_inputs

    args = [torch.as_tensor(a, device=cuda) for a in capsule_inputs(arena("cpu"), layout, seed=7)]
    before = k1.launches
    pk, vk, gk = k1.resolve_capsule(*args)
    assert k1.launches == before + 1
    pp, vp, gp = k1.resolve_capsule_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(pk, pp) and torch.equal(vk, vp) and torch.equal(gk, gp)


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
    before = k2.launches
    tk = k2.ray_tris(cm.tri16, cm.chunk_bounds, o, d, m)
    assert k2.launches == before + 1
    tp = k2.ray_tris_plain(cm.tri16, cm.chunk_bounds, o, d, m)
    torch.cuda.synchronize()
    assert torch.equal(tk, tp)
    assert 0 < int((tk < 1e29).sum()) < tk.numel()


def test_ray_tris_edge_table_kernel_matches_plain(cuda):
    """K2 on the card against its plain version on the edge table of
    tests/torch_inputs.py::k2_edge_inputs (rays on shared edges and
    vertices; hits at exactly max_dist; parallel rays; blocks whose box
    touches a chunk bound exactly or stops one float short of one; a NaN
    origin; 704 rays), bit for bit, and both equal the table's exact t."""
    from c_game_engine_tpu_torch.ops import ray_tris as k2
    from torch_inputs import k2_edge_inputs

    *args, expect = (torch.as_tensor(a, device=cuda) for a in k2_edge_inputs())
    before = k2.launches
    tk = k2.ray_tris(*args)
    assert k2.launches == before + 1
    tp = k2.ray_tris_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(tk, tp)
    built = ~torch.isnan(expect)
    assert torch.equal(tk[built], expect[built])


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


def test_body_contacts_tie_kernel_matches_plain(cuda):
    """K3 on the card against its plain version on the table of exact ties
    (eight equal rows over one chunk's rows, an invalid one among them; an
    equal pair across chunks; an all-invalid chunk; off lanes), bit for
    bit."""
    from c_game_engine_tpu_torch.ops import body_contacts as k3
    from torch_inputs import k3_tie_inputs

    *args, is_box = k3_tie_inputs()
    args = [torch.as_tensor(a, device=cuda) for a in args] + [torch.tensor(is_box, device=cuda)]
    before = k3.launches
    ok = k3.body_contacts(*args)
    assert k3.launches == before + 1
    op = k3.body_contacts_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(ok, op)


def test_rollout_on_card_matches_cpu(cuda, arena):
    from c_game_engine_tpu_torch.models.sim import reset_batch, rollout
    from torch_parity import assert_leaves_match, stream_batch, torch_actions, torch_leaves

    streams = stream_batch(30, 256, seed=0)
    g = rollout(arena(cuda), reset_batch(arena(cuda), 256), torch_actions(*streams, device=cuda))
    c = rollout(arena("cpu"), reset_batch(arena("cpu"), 256), torch_actions(*streams))
    assert_leaves_match(torch_leaves(c), torch_leaves(g), {"player.pos": 2e-3})


@pytest.mark.parametrize("name", ["arena", "arena_bodies"])
def test_graph_matches_eager(cuda, name):
    """The captured tick graph (models/graph.py) against the eager loop on
    the card: 30 ticks x 256 envs of both scripted streams, every leaf
    bit for bit, the same kernel launches and gate counts."""
    from pathlib import Path

    from c_game_engine_tpu_torch.core.state import load_map
    from c_game_engine_tpu_torch.models.graph_check import graph_and_eager, same_leaves
    from c_game_engine_tpu_torch.models.sim import reset_batch
    from torch_parity import stream_batch, torch_actions

    root = Path(__file__).resolve().parents[1] / MAPS
    cmap = load_map(root / f"{name}.npz", root / f"{name}.json", cuda)
    runs = graph_and_eager(cmap, reset_batch(cmap, 256), torch_actions(*stream_batch(30, 256, seed=0), device=cuda))
    (g, gk, gg, _), (e, ek, eg, _) = runs["graph"], runs["eager"]
    same_leaves(name, g, e)
    assert (gk, gg) == (ek, eg) and gk["capsule_resolve"] >= 30 and gk["ray_tris"] == 30


@pytest.mark.parametrize("kind", ["stick", "audio", "bodies"])
def test_gate_state_graph_matches_eager(cuda, kind):
    """The gate states of models/graph_check.py (chip_smoke.py's) at 256
    envs: each gate open on some ticks and closed on others, graph against
    eager bit for bit."""
    from pathlib import Path

    from c_game_engine_tpu_torch.core.state import load_map
    from c_game_engine_tpu_torch.models.graph_check import check_gate_state, gate_states

    root = Path(__file__).resolve().parents[1] / MAPS
    arena, bodies = (load_map(root / f"{n}.npz", root / f"{n}.json", cuda) for n in ("arena", "arena_bodies"))
    check_gate_state(kind, *gate_states(arena, bodies, 256)[kind])


def test_rollout_collect_graph_matches_eager(cuda, arena):
    """rollout_collect of player.pos through the collect graph over 250
    ticks x 256 envs (two chunks of its 240-tick action stream, a different
    turn on every tick) against the eager loop: the final state and every
    row bit for bit. A second collect_fn replaces the first's graph."""
    from c_game_engine_tpu_torch.models.graph_check import check_collect
    from c_game_engine_tpu_torch.models.sim import bench_actions, reset_batch, rollout_collect

    cmap = arena(cuda)
    assert check_collect(cmap, 256, 250) == 2
    first = cmap.graphs[(256, True)]
    _, yaw = rollout_collect(cmap, reset_batch(cmap, 256), bench_actions(3, 256, "cuda"), lambda st: st.player.yaw)
    assert cmap.graphs[(256, True)] is not first and yaw.shape == (3, 256)
    assert sum(collects for (_, collects) in cmap.graphs) == 1


def test_raster_tiles_kernel_matches_plain(cuda):
    """K4 (binning included) on the card against its plain version on
    random tables (equal-z twins, degenerate and off-frame rows, an
    exclude image, a gated-off tile): all 12 planes bit for bit."""
    from c_game_engine_tpu_torch.ops import raster_tiles as k4
    from torch_inputs import k4_inputs

    h, w = 64, 256
    tri48, _, _, ok, excl = (torch.as_tensor(a, device=cuda)
                             for a in k4_inputs(seed=9, batch=4, height=h, width=w, t=400))
    tile_on = torch.ones((4, (h // 8) * (w // 128)), dtype=torch.int32, device=cuda)
    tile_on[1, 5] = 0
    before = k4.launches
    got = k4.raster_tiles_binned(tri48, ok, h, w, exclude=excl, tile_on=tile_on)
    assert k4.launches == before + 1
    want = k4.raster_tiles_binned_plain(tri48, ok, h, w, exclude=excl, tile_on=tile_on)
    torch.cuda.synchronize()
    for k, (g, p) in enumerate(zip(got, want)):
        assert torch.equal(g, p), f"plane {k}"
    assert (got[1][1, 16:24, 128:] == -1).all() and float((got[1] >= 0).float().mean()) > 0.5


@pytest.mark.parametrize("kind", ["crowded", "small"])
@pytest.mark.parametrize("exclude", [True, False])
def test_raster_tiles_edge_table_kernel_matches_plain(cuda, kind, exclude):
    """K4 on the card against its plain version on the binning edge table
    of tests/torch_inputs.py::k4_bin_edge_inputs (tri_ok false, NaN and
    infinite coordinates, boxes on and one float off the tile bounds, a
    tile of more than 512 rows, T < 512, a gated-off tile), with and
    without an exclude image: all 12 planes bit for bit."""
    from c_game_engine_tpu_torch.ops import raster_tiles as k4
    from torch_inputs import k4_bin_edge_inputs

    tri48, ok, excl, tile_on = (torch.as_tensor(a, device=cuda) for a in k4_bin_edge_inputs(kind))
    excl = excl if exclude else None
    before = k4.launches
    got = k4.raster_tiles_binned(tri48, ok, 16, 256, exclude=excl, tile_on=tile_on)
    assert k4.launches == before + 1
    want = k4.raster_tiles_binned_plain(tri48, ok, 16, 256, exclude=excl, tile_on=tile_on)
    torch.cuda.synchronize()
    for k, (g, p) in enumerate(zip(got, want)):
        assert torch.equal(g, p), f"plane {k}"


def test_raster_tiles_wrapper_raises(cuda):
    """The K4 wrapper raises for a CPU tensor among CUDA ones, a table
    that does not start on a 16-byte boundary and a non-contiguous one, and
    the list-taking `raster_tiles` for CUDA tensors; nothing launches."""
    from c_game_engine_tpu_torch.ops import raster_tiles as k4
    from torch_inputs import k4_bin_edge_inputs

    tri48, ok, excl, tile_on = (torch.as_tensor(a, device=cuda) for a in k4_bin_edge_inputs("small"))
    before = k4.launches
    with pytest.raises(ValueError, match="one device"):
        k4.raster_tiles_binned(tri48, ok.cpu(), 16, 256)
    shifted = torch.zeros(tri48.numel() + 1, device=cuda)
    shifted[1:] = tri48.reshape(-1)
    with pytest.raises(ValueError, match="16-byte"):
        k4.raster_tiles_binned(shifted[1:].view(tri48.shape), ok, 16, 256)
    wide = torch.zeros((*tri48.shape[:2], 96), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        k4.raster_tiles_binned(wide[..., ::2], ok, 16, 256)
    idx, cnt = k4.bin_triangles(tri48[..., 0:6:2], tri48[..., 1:6:2], ok, 16, 256)
    with pytest.raises(ValueError, match="CPU tensors"):
        k4.raster_tiles(tri48, idx, cnt, 16, 256)
    assert k4.launches == before


def test_render_on_card_matches_cpu(cuda):
    """A 2-env 256 x 256 render_batch of arena_lit on the card against the
    plain path on the CPU, held to the frame bar of ROADMAP.md (at most
    0.2% of pixels off by more than 1/255: CPU and card log2 can round a
    mip level to the other quarter). K4 runs twice: pass 1 and the reveal
    pass."""
    from c_game_engine_tpu_torch.models.sim import reset_batch
    from c_game_engine_tpu_torch.ops import raster_tiles as k4
    from c_game_engine_tpu_torch.render.bundle import load_render_map
    from c_game_engine_tpu_torch.render.raster import render_batch

    frames = []
    for dev in (cuda, torch.device("cpu")):
        cm, rb = load_render_map("arena_lit", dev)
        st = reset_batch(cm, 2)
        st = st.replace(player=st.player.replace(yaw=st.player.yaw + torch.tensor([0.0, 2.0], device=dev)))
        before = k4.launches
        frames.append(render_batch(rb, cm, st, 256, 256).cpu())
        assert k4.launches == before + (2 if dev.type == "cuda" else 0)
    err = (frames[0] - frames[1]).abs().amax(-1)
    assert float((err > 1 / 255).float().mean()) <= 0.002


def _k5_args(cuda, seed, batch, h, t, w=128, kind="random"):
    from c_game_engine_tpu_torch.ops import raster_tiles_big as k5
    from torch_inputs import k5_inputs

    trit, excl = (torch.as_tensor(a, device=cuda)
                  for a in k5_inputs(seed=seed, batch=batch, height=h, width=w, t=t, kind=kind))
    bb = [trit[:, k] for k in (10, 11, 12, 13)]
    return trit, k5.level_bboxes(*bb, k5.T_CHK), k5.level_bboxes(*bb, k5.SUB), excl


@pytest.mark.parametrize("case", ["one_chunk", "two_chunks_gated", "no_exclude", "subpixel"])
def test_raster_tiles_big_kernel_matches_plain(cuda, case):
    """K5 on the card against its plain version on the inputs of the CPU
    tests (b) and (c) of tests/test_torch_render_big.py (sparse live rows,
    equal-z twins, degenerate and off-frame rows, an exclude image; the
    second with two chunks, two envs and a gated tile; the third as the
    second with no exclude image, as pass 1 calls it; the fourth the
    sub-pixel table of (c), 8 x 256: clustered sub-pixel triangles with
    equal-z twins, hit subchunks interleaved with dead and missing ones in
    both chunks): winner and z planes equal."""
    from c_game_engine_tpu_torch.ops import raster_tiles_big as k5

    seed, batch, h, w, t, kind = {
        "one_chunk": (3, 1, 8, 128, 4096, "random"),
        "subpixel": (5, 2, 8, 256, 8192, "subpixel"),
    }.get(case, (4, 2, 32, 128, 8192, "random"))
    trit, cbox, scb, excl = _k5_args(cuda, seed, batch, h, t, w, kind)
    tile_on = torch.ones((batch, (h // 8) * (w // 128)), dtype=torch.int32, device=cuda)
    if case != "one_chunk":
        tile_on[-1, -2] = 0
    if case == "no_exclude":
        excl = None
    before = k5.launches
    z, win = k5.raster_tiles_big(trit, cbox, scb, h, w, exclude=excl, tile_on=tile_on)
    assert k5.launches == before + 1
    zp, wp = k5.raster_tiles_big_plain(trit, cbox, scb, h, w, exclude=excl, tile_on=tile_on)
    torch.cuda.synchronize()
    assert torch.equal(win, wp) and torch.equal(z, zp)
    assert float((win >= 0).float().mean()) > (0.1 if case == "subpixel" else 0.3)


def test_raster_tiles_big_wrapper_raises(cuda):
    """The K5 wrapper raises for a CPU tensor among CUDA ones, a wrong
    dtype and a non-contiguous table, and launches nothing."""
    from c_game_engine_tpu_torch.ops import raster_tiles_big as k5

    trit, cbox, scb, excl = _k5_args(cuda, 3, 1, 8, 4096)
    before = k5.launches
    with pytest.raises(ValueError, match="one device"):
        k5.raster_tiles_big(trit, cbox.cpu(), scb, 8, 128, exclude=excl)
    with pytest.raises(TypeError):
        k5.raster_tiles_big(trit.double(), cbox, scb, 8, 128, exclude=excl)
    wide = torch.zeros((1, 16, 2 * trit.shape[2]), device=cuda)
    wide[..., ::2] = trit
    with pytest.raises(ValueError, match="contiguous"):
        k5.raster_tiles_big(wide[..., ::2], cbox, scb, 8, 128, exclude=excl)
    assert k5.launches == before


@pytest.mark.parametrize("name", ["arena_lit", "arena_orb"])
def test_render_graph_matches_eager(cuda, name):
    """render_batch through the bundle's captured graph against
    render_batch_eager on the card, bit for bit (render/graph_check.py,
    as chip_smoke.py checks it): 8 envs x 256 x 256 after 60 ticks, one frame
    batch at a heading where the reveal overflow gate stays closed and one
    with two envs 0.12 m from a coin, where it opens; one graph serves
    both, and each replay launches the route's raster kernel twice."""
    from c_game_engine_tpu_torch.models.sim import bench_actions, reset_batch, rollout
    from c_game_engine_tpu_torch.render.bundle import load_render_map
    from c_game_engine_tpu_torch.render.graph_check import graph_against_eager, overflow_states
    from c_game_engine_tpu_torch.utils import counters

    cm, rb = load_render_map(name, cuda)
    st = rollout(cm, reset_batch(cm, 8), bench_actions(60, 8, "cuda"))
    _, opened = graph_against_eager(rb, cm, st, 256, 256)
    assert not opened
    _, opened = graph_against_eager(rb, cm, overflow_states(st, [1, 5]), 256, 256)
    assert opened and len(rb.graphs) == 1
    kernel = "raster_tiles" if name == "arena_lit" else "raster_tiles_big"
    before = counters.read(kernel)
    from c_game_engine_tpu_torch.render.raster import render_batch

    render_batch(rb, cm, st, 256, 256)
    assert counters.read(kernel) == before + 2


@pytest.mark.parametrize("name", ["arena_lit", "arena_orb"])
def test_render_graph_follows_cull_mode(cuda, name, monkeypatch):
    """render/raster.py's CULL_MODE switched between calls (neg, pos, none,
    neg): each frame batch through the render graph equals
    render_batch_eager under the same mode bit for bit, so no call replays
    a capture taken under another mode; the bundle keeps one graph a mode,
    "pos" changes the frames and the last "neg" frames equal the first."""
    from c_game_engine_tpu_torch.models.sim import bench_actions, reset_batch, rollout
    from c_game_engine_tpu_torch.render import raster as R
    from c_game_engine_tpu_torch.render.bundle import load_render_map

    cm, rb = load_render_map(name, cuda)
    st = rollout(cm, reset_batch(cm, 8), bench_actions(30, 8, "cuda"))
    frames = []
    for mode in ("neg", "pos", "none", "neg"):
        monkeypatch.setattr(R, "CULL_MODE", mode)
        got = R.render_batch(rb, cm, st, 256, 256)
        assert torch.equal(got, R.render_batch_eager(rb, cm, st, 256, 256)), mode
        frames.append(got)
    assert len(rb.graphs) == 3
    assert torch.equal(frames[0], frames[3])
    assert not torch.equal(frames[0], frames[1])


@pytest.mark.parametrize("label", ["xla_100x128", "ssaa2", "aniso4", "wireframe", "hud"])
def test_render_options_on_card_match_cpu(cuda, label):
    """Each render option on the card (through its graph, itself bit-equal
    to the eager render on the card) against the plain path on the CPU, 2
    envs of arena_lit after 30 ticks at different headings: under 0.2% of
    pixels off by more than 1/255. "hud" is render_with_hud_batch at 256 x
    256 with the synthetic HUD and viewmodel (render/synthetic_hud.py)."""
    from c_game_engine_tpu_torch.core.state import tree_map
    from c_game_engine_tpu_torch.models.sim import bench_actions, reset_batch, rollout
    from c_game_engine_tpu_torch.render import raster as R
    from c_game_engine_tpu_torch.render.bundle import load_render_map
    from c_game_engine_tpu_torch.render.graph_check import OPTIONS, graph_against_eager
    from c_game_engine_tpu_torch.render.synthetic_hud import hud_states, with_synthetic_hud

    frames = []
    for dev in (cuda, torch.device("cpu")):
        cm, rb = load_render_map("arena_lit", dev)
        st = rollout(cm, reset_batch(cm, 2), bench_actions(30, 2, dev))
        st = st.replace(player=st.player.replace(yaw=st.player.yaw + torch.tensor([0.0, 2.5], device=dev)))
        if label == "hud":
            rb, st = with_synthetic_hud(rb), hud_states(st)
            out = R.render_with_hud_batch(rb, cm, st, 256, 256)
            if dev.type == "cuda":
                assert torch.equal(out, R.render_with_hud_batch(rb, cm, tree_map(torch.clone, st), 256, 256))
        else:
            _, h, w, kw = next(o for o in OPTIONS if o[0] == label)
            if dev.type == "cuda":
                out, _ = graph_against_eager(rb, cm, st, h, w, **kw)
            else:
                out = R.render_batch(rb, cm, st, h, w, **kw)
        frames.append(out.cpu())
    err = (frames[0] - frames[1]).abs().amax(-1)
    assert float((err > 1 / 255).float().mean()) <= 0.002


def test_mix_frame_on_card_matches_cpu(cuda, arena, tmp_path):
    """mix_frame of 256 envs x 800 samples on the card, the channel tables
    filled by `audio_states` after 30 graphed ticks with the synthetic
    sounds, against the CPU plain path on the same inputs: abs and rel
    1e-5 (the channel sum reduces in another order)."""
    from c_game_engine_tpu_torch.audio.mixer import listener_from_state, mix_frame
    from c_game_engine_tpu_torch.audio.synthetic_sounds import audio_states, with_synthetic_sounds
    from c_game_engine_tpu_torch.core.state import tree_map
    from c_game_engine_tpu_torch.models.sim import bench_actions, reset_batch, rollout

    cm, bank = with_synthetic_sounds(arena(cuda), tmp_path)
    st = audio_states(rollout(cm, reset_batch(cm, 256), bench_actions(30, 256, cuda)), seed=1)
    vols = torch.tensor([0.8, 0.6, 1.0, 0.5])
    pos, quat = listener_from_state(st)
    card = mix_frame(bank, st.audio, pos, quat, vols.to(cuda)).cpu()
    cpu_bank = tree_map(lambda x: x.cpu(), bank)
    plain = mix_frame(cpu_bank, tree_map(lambda x: x.cpu(), st.audio), pos.cpu(), quat.cpu(), vols)
    assert card.shape == (256, 800, 2) and float(card.abs().max()) > 0.1
    torch.testing.assert_close(card, plain, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["arena", "arena_bodies"])
def test_two_shard_mesh_on_card_matches_unsharded(cuda, name):
    """Two 128-env shards on the one card (parallel/mesh.py) against the
    unsharded 256-env rollout, both through the tick graph, 30 ticks of a
    per-env stream: every leaf bit for bit. arena_bodies starts with the
    back half's bodies asleep, so the second shard's body gate stays
    closed while the whole batch's opens."""
    from c_game_engine_tpu_torch.models.graph_check import same_leaves
    from c_game_engine_tpu_torch.models.sim import load_named_map, reset_batch, rollout
    from c_game_engine_tpu_torch.parallel.mesh import gather_states, make_mesh, rollout_shards, split
    from torch_mesh_inputs import half_asleep, per_env_stream

    cm = load_named_map(name, cuda)
    state = reset_batch(cm, 256) if name == "arena" else half_asleep(cm, 256)
    acts = per_env_stream(30, 256, seed=7, device=cuda)
    whole = rollout(cm, state, acts)
    mesh = make_mesh(devices=[cuda, cuda])
    parts = gather_states(rollout_shards([cm, cm], split(state, mesh), split(acts, mesh, axis=1)))
    same_leaves(f"{name} over 2 shards", whole, parts)
