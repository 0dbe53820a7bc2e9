"""The plain reference (refsim) against the port's eager path at a tiny
size, the frozen bounds against chip_smoke.py's, and what the reference
imports."""

import subprocess
import sys

import pytest
import torch

from harness.reference import Reference, leaves
from harness.spec import BENCH_DIR, load_cell, metric_module
from harness.traffic import Pool
from pb_small import small_cell

FORBIDDEN = {"jax", "jaxlib", "flax", "c_game_engine_tpu", "c_game_engine_tpu_torch"}


def port_side(cell, envs):
    from harness.program import Program

    return Program(cell.config, envs, torch.device("cpu"), "frame" in cell.config)


def test_reference_steps_like_the_port():
    """arena_bodies, 8 envs x 8 ticks of the agent's own actions: every
    leaf of every tick equal."""
    cell = small_cell("bodies_agent_4096", envs=8, ticks=8)
    prog, ref = port_side(cell, 8), Reference(cell.config, 8, torch.device("cpu"), False)
    pool = Pool(cell.traffic, 2**31 + 3, torch.device("cpu"))
    p, r = prog.reset(), ref.reset()
    for t in range(8):
        row = pool.tick(0, t)
        p, r = prog.step(p, prog.actions(row)), ref.step(r, ref.actions(row))
        got = dict(leaves(p))
        for name, v in leaves(r):
            assert torch.equal(got[name], v), (t, name)
    assert float(p.actors.vel.abs().sum()) > 0  # the bodies moved


def test_reference_renders_like_the_port():
    """A 2-env 128 x 128 arena_lit frame after 6 ticks of the agent."""
    from c_game_engine_tpu_torch.render.raster import render_batch_eager

    cell = small_cell("lit_pixels_64", envs=2, frame=(128, 128))
    prog, ref = port_side(cell, 2), Reference(cell.config, 2, torch.device("cpu"), True)
    pool = Pool(cell.traffic, 99, torch.device("cpu"))
    p = prog.reset()
    for t in range(6):
        p = prog.step(p, prog.actions(pool.tick(0, t)))
    mine = render_batch_eager(prog.bundle, prog.cmap, p, 128, 128, 90.0)
    theirs = ref.render(p)
    assert mine.shape == (2, 128, 128, 3)
    assert torch.equal(mine, theirs)


def test_reference_imports_nothing_of_jax_or_the_port():
    code = ("import sys; sys.path.insert(0, %r); import refsim.core.step, refsim.render.raster, refsim.sim, "
            "refsim.render.bundle, harness.reference, harness.bounds, harness.check; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))" % str(BENCH_DIR))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True).stdout.split()
    assert "refsim" in out and not FORBIDDEN & set(out), sorted(FORBIDDEN & set(out))
    # names are compared whole: the port's name begins with the JAX package's
    from run import forbidden_modules

    assert "c_game_engine_tpu_torch" not in forbidden_modules()


def test_frozen_bounds_equal_chip_smokes():
    import chip_smoke
    from harness import bounds

    cell = small_cell("lit_pixels_64", envs=2)
    prog = port_side(cell, 2)
    pool = Pool(cell.traffic, 5, torch.device("cpu"))
    st = prog.reset()
    for t in range(3):
        st = prog.step(st, prog.actions(pool.tick(0, t)))
    acts = prog.actions(pool.tick(0, 3))
    k1 = prog.capture(*metric_module("k1_roofline").CAPTURE, st, acts)
    k4 = prog.capture(*metric_module("k4_roofline").CAPTURE, st, acts)
    assert len(k1) == 2 and len(k4) == 2  # main and stick launches; pass 1 and the reveal
    for args, _, _ in k1:
        assert bounds.k1_bound(args) == chip_smoke.k1_bound(args)
    for args, kw, planes in k4:
        assert bounds.k4_bound(args, kw, planes) == chip_smoke.k4_bound(args, kw, planes)[:2]
