"""Hold the render graphs (render/graph.py) to the eager render on the
same card, bit for bit, with the reveal overflow gate closed and open: the
checks that chip_smoke.py and tests/test_torch_cuda.py run.

    overflow_states(states, envs)           states whose listed envs overflow
    graph_against_eager(bundle, cmap, st)   one frame batch both ways
    OPTIONS                                 the option sets the checks cover
"""

from __future__ import annotations

import torch

from c_game_engine_tpu_torch.render import raster as R

# a free camera 0.12 m in front of the third coin (the actor row 2 of
# arena_lit and arena_orb), a little off its axis (head-on, the coin's
# diagonal runs through a line of pixel centres): the coin fills the
# frame, and its screen-door pixels lie on more tiles than the budget
CLOSE_COIN = (2, (0.011, 0.007, 0.12), 0.05, 0.03)
# option sets of render_batch that the card checks hold to the CPU:
# (label, height, width, keyword arguments)
OPTIONS = (
    ("xla_100x128", 100, 128, {}),
    ("ssaa2", 256, 256, {"ssaa": 2}),
    ("aniso4", 256, 256, {"aniso": 4}),
    ("wireframe", 256, 256, {"debug_wireframe": True}),
)


def overflow_states(states, envs):
    """`states` with the listed envs looking through CLOSE_COIN."""
    actor, offset, yaw, pitch = CLOSE_COIN
    p = states.player
    dev = p.pos.device
    idx = torch.as_tensor(envs, device=dev)
    eye = states.actors.pos[idx, actor] + torch.tensor(offset, device=dev)
    put = lambda x, v: x.index_put((idx,), torch.as_tensor(v, dtype=x.dtype, device=dev).expand(len(envs),
                                                                                                  *x.shape[1:]))
    player = p.replace(freecam=put(p.freecam, True), freecam_pos=put(p.freecam_pos, eye), yaw=put(p.yaw, yaw),
                       pitch=put(p.pitch, pitch))
    return states.replace(player=player)


def reveal_overflows(bundle, cmap, states, height, width, **options):
    """Whether some env's screen-door pixels take more tiles than the
    budget, so the gate opens (one eager pass, read on the host)."""
    _, overflow, ctx = R._render_envs(bundle, cmap, states, height, width, options.get("fov_deg", 90.0),
                                      options.get("mipmaps", True), options.get("backend"), options.get("aniso", 0),
                                      options.get("debug_wireframe", False))
    return ctx is not None and bool(overflow.any())


def graph_against_eager(bundle, cmap, states, height, width, **options):
    """render_batch on the card (the bundle's graph for these options) and
    render_batch_eager on the same states: raise unless the frames are
    equal bit for bit and finite. Returns (frames, whether the gate
    opened)."""
    opened = reveal_overflows(bundle, cmap, states, height * options.get("ssaa", 1),
                              width * options.get("ssaa", 1), **options)
    graph = R.render_batch(bundle, cmap, states, height, width, **options)
    eager = R.render_batch_eager(bundle, cmap, states, height, width, **options)
    if not torch.equal(graph, eager) or not bool(torch.isfinite(graph).all()):
        bad = (graph != eager).any(-1)
        raise AssertionError(f"render graph {options} differs from the eager render at {int(bad.sum())} pixels "
                             f"(gate {'open' if opened else 'closed'})")
    return graph, opened
