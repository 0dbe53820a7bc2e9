"""The plain reference (refsim: a frozen copy of the port's eager tick
and frame batch with the kernels' plain versions; it imports nothing of
the port). It loads the committed map files itself, works out the reset
state itself and takes the program's states only to step them and to
judge the program's outputs.

`Control` puts the reference in the program's place in a lower
precision than the configuration states (float32 with TF32 off):
"tf32" lets float32 matrix products run in TF32, "bf16" keeps the state
in bfloat16 between ticks (every float32 leaf rounded to bfloat16 before
and after each tick, and before each frame batch)."""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from harness.spec import ROOT

MAPS = ROOT / "c_game_engine_tpu_torch" / "maps"


def full_float32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def tf32():
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def leaves(obj, prefix=""):
    """[(dotted name, tensor)] of a nested dataclass of tensors."""
    if isinstance(obj, torch.Tensor):
        return [(prefix, obj)]
    out = []
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            out += leaves(getattr(obj, f.name), f"{prefix}.{f.name}" if prefix else f.name)
    return out


def rebuild(template, values: dict, prefix=""):
    """`template` (a nested dataclass) with each tensor leaf replaced by
    values[dotted name]."""
    if isinstance(template, torch.Tensor):
        return values[prefix]
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: rebuild(getattr(template, f.name), values, f"{prefix}.{f.name}" if prefix else f.name)
            for f in dataclasses.fields(template)})
    return template


def to_bf16(state):
    return rebuild(state, {k: v.to(torch.bfloat16).to(torch.float32) if v.dtype == torch.float32 else v
                           for k, v in leaves(state)})


class Reference:
    def __init__(self, config: dict, batch: int, device: torch.device, render: bool):
        from refsim.core import state as rs
        from refsim.core.actions import Actions
        from refsim.core.step import step_batch
        from refsim.sim import reset_batch

        full_float32()
        self._step, self._reset, self._actions = step_batch, reset_batch, Actions
        name = config["map"]
        self.batch, self.frame = batch, config.get("frame")
        self.cmap = rs.load_map(MAPS / f"{name}.npz", MAPS / f"{name}.json", device)
        self.bundle = None
        if render:
            from refsim.render.bundle import load_bundle

            self.bundle = load_bundle(MAPS / f"{name}_bundle.npz", MAPS / f"{name}_bundle.json", self.cmap)
        self._template = reset_batch(self.cmap, batch)

    def reset(self):
        return self._reset(self.cmap, self.batch)

    def adopt(self, state):
        """The reference's state type with the leaves of `state`."""
        return rebuild(self._template, dict(leaves(state)))

    def actions(self, flat):
        return self._actions.from_flat(flat)

    def step(self, state, actions):
        return self._step(self.cmap, self.adopt(state), actions)

    def render(self, state):
        from refsim.render.raster import render_batch_eager

        f = self.frame
        return render_batch_eager(self.bundle, self.cmap, self.adopt(state), f["height"], f["width"], f["fov_deg"])


class Control(Reference):
    """The reference in the program's place, in a lower precision."""

    def __init__(self, config, batch, device, render, precision: str):
        super().__init__(config, batch, device, render)
        if precision not in ("tf32", "bf16"):
            raise SystemExit(f"unknown control precision {precision!r}")
        self.precision = precision

    def _in(self, state):
        return to_bf16(self.adopt(state)) if self.precision == "bf16" else state

    def _ctx(self):
        return tf32() if self.precision == "tf32" else contextlib.nullcontext()

    def step(self, state, actions):
        with self._ctx():
            out = super().step(self._in(state), actions)
        return self._in(out)

    def render(self, state):
        with self._ctx():
            return super().render(self._in(state))

    def collect(self, state, actions, observer):
        rows = []
        for t in range(actions.move.shape[0]):
            state = self.step(state, actions[t])
            rows.append(observer(state))
        return state, torch.stack(rows)

    def counter(self, name):
        return 0

    def close(self):
        pass
