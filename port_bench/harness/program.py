"""The system under test: the port (`c_game_engine_tpu_torch`), reached
only through its public entry points (models/sim.py's BatchedSim and
rollout_collect, render/raster.py's render_batch, the render bundle's
loader), its device counts (utils/counters.py) and, for a kernel's bound,
what one eager tick or frame batch hands a function of it (`capture`)."""

from __future__ import annotations

import contextlib
import gc

import torch


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x


class Program:
    def __init__(self, config: dict, batch: int, device: torch.device, render: bool):
        from c_game_engine_tpu_torch.core.actions import Actions
        from c_game_engine_tpu_torch.models import sim

        self._sim_mod, self._actions = sim, Actions
        self.sim = sim.make_sim(config["map"], batch, jit=device.type == "cuda", device=device)
        self.cmap = self.sim.cmap
        self.frame = config.get("frame")
        self.bundle = None
        if render:
            from c_game_engine_tpu_torch.render import bundle as rb

            name = config["map"]
            self.bundle = rb.load_bundle(rb.MAP_DIR / f"{name}_bundle.npz", rb.MAP_DIR / f"{name}_bundle.json",
                                         self.cmap)

    def reset(self):
        return self.sim.reset()

    def actions(self, flat: torch.Tensor):
        return self._actions.from_flat(flat)

    def step(self, state, actions):
        return self.sim.step(state, actions)

    def render(self, state):
        from c_game_engine_tpu_torch.render.raster import render_batch

        f = self.frame
        return render_batch(self.bundle, self.cmap, state, f["height"], f["width"], f["fov_deg"])

    def collect(self, state, actions, observer):
        return self._sim_mod.rollout_collect(self.cmap, state, actions, observer)

    def counter(self, name: str) -> int:
        from c_game_engine_tpu_torch.utils import counters

        return counters.read(name)

    def capture(self, module: str, attr: str, call: str, state, actions) -> list:
        """Wrap the function that the port's `module` looks up as `attr`,
        run `call` once eagerly ("tick": one tick with every gated branch
        on both sides; "frame": one frame batch), and return (args, kwargs,
        outputs) of each call the wrapper saw, every tensor cloned."""
        import importlib

        mod = importlib.import_module(module)
        fn = getattr(mod, attr)
        seen = []

        def rec(*a, **kw):
            out = fn(*a, **kw)
            seen.append((_clone(a), _clone(kw), _clone(out)))
            return out

        setattr(mod, attr, rec)
        try:
            self._eager(call, state, actions)
        finally:
            setattr(mod, attr, fn)
        return seen

    def _eager(self, call: str, state, actions):
        if call == "tick":
            from c_game_engine_tpu_torch.core import gates
            from c_game_engine_tpu_torch.core.step import step_batch

            with getattr(gates, "warm_up", contextlib.nullcontext)():
                step_batch(self.cmap, state, actions)
        elif call == "frame":
            from c_game_engine_tpu_torch.render.raster import render_batch_eager

            f = self.frame
            render_batch_eager(self.bundle, self.cmap, state, f["height"], f["width"], f["fov_deg"])
        else:
            raise ValueError(f"no eager call {call!r}")

    def close(self):
        """Free the program's graphs, maps and pools."""
        self.cmap.graphs.clear()
        if self.bundle is not None:
            self.bundle.graphs.clear()
        self.sim = self.cmap = self.bundle = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
