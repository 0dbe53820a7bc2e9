"""Action-stream recording and replay: the CGAS container (counterpart of
c_game_engine_tpu/core/actions_io.py).

A [T, B] action stream (core/actions.py) is saved as a compact gzip
container, so a long multi-thousand-env session replays exactly. Two
codecs write the same bytes: the C one of the native host library
(native.py, csrc/cge_native.cpp cge_actions_*) and a pure-Python one.
`native=None` tries the C codec and falls back to Python where the library
cannot be built or loaded, True raises then, False takes Python. Format:

  header (32 B LE): magic 'CGAS' | version u8 | n_buttons u8 | pad u16 |
    batch u32 | n_ticks u32 | raw_size u64 | comp_size u64
  gzip payload (level 6, mtime 0): move [T*B*2] f32, look [T*B*2] f32,
    buttons [T*B] u16 bitmask
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path

import numpy as np
import torch

from c_game_engine_tpu_torch.core.actions import NUM_BUTTONS, Actions

MAGIC = 0x53414743  # "CGAS"
_HEADER = struct.Struct("<IBBHIIQQ")


def _to_numpy(actions: Actions):
    move = actions.move.detach().cpu().numpy().astype(np.float32, copy=False)
    look = actions.look.detach().cpu().numpy().astype(np.float32, copy=False)
    buttons = actions.buttons.detach().cpu().numpy().astype(np.uint8, copy=False)
    if move.ndim != 3:
        raise ValueError("expected a [T, B] action stream")
    return move, look, buttons


def save_actions(path: str | Path, actions: Actions, native: bool | None = None) -> None:
    """Write a [T, B] action stream (tensors on any device). native=None
    tries the C codec first."""
    move, look, buttons = _to_numpy(actions)
    t, b = move.shape[:2]
    if native is not False:
        try:
            from c_game_engine_tpu_torch.native import actions_write_native

            actions_write_native(str(path), move, look, buttons)
            return
        except (OSError, RuntimeError):
            if native:
                raise
    mask = np.zeros((t * b,), np.uint16)
    flat_b = buttons.reshape(t * b, NUM_BUTTONS)
    for i in range(NUM_BUTTONS):
        mask |= (flat_b[:, i].astype(np.uint16)) << i
    raw = move.tobytes() + look.tobytes() + mask.tobytes()
    comp = gzip.compress(raw, 6, mtime=0)
    header = _HEADER.pack(MAGIC, 1, NUM_BUTTONS, 0, b, t, len(raw), len(comp))
    Path(path).write_bytes(header + comp)


def load_actions(path: str | Path, native: bool | None = None, device="cuda") -> Actions:
    """Read a CGAS stream back as [T, B] Actions on `device`. A stream
    written with another button count keeps the buttons both sets share
    and leaves the rest unpressed. native=None tries the C codec first."""
    if native is not False:
        try:
            from c_game_engine_tpu_torch.native import actions_read_native

            move, look, buttons = actions_read_native(str(path))
            return _actions(move, look, buttons > 0, buttons.shape[-1], device)
        except (OSError, RuntimeError):
            if native:
                raise
    data = Path(path).read_bytes()
    if len(data) < _HEADER.size:
        raise ValueError(f"{path}: truncated stream")
    magic, version, nb, _pad, b, t, raw_size, comp_size = _HEADER.unpack_from(data, 0)
    if magic != MAGIC or version != 1:
        raise ValueError(f"{path}: not a CGAS v1 stream")
    if len(data) - _HEADER.size != comp_size:
        raise ValueError(f"{path}: truncated stream")
    raw = gzip.decompress(data[_HEADER.size:])
    if len(raw) != raw_size or raw_size != t * b * 18:
        raise ValueError(f"{path}: bad payload size")
    tb = t * b
    move = np.frombuffer(raw, np.float32, tb * 2, 0).reshape(t, b, 2)
    look = np.frombuffer(raw, np.float32, tb * 2, tb * 8).reshape(t, b, 2)
    mask = np.frombuffer(raw, np.uint16, tb, tb * 16)
    buttons = ((mask[:, None] >> np.arange(nb)[None, :]) & 1).astype(bool)
    return _actions(move, look, buttons.reshape(t, b, nb), nb, device)


def _actions(move, look, buttons, nb, device) -> Actions:
    """[T, B] Actions on `device` from the decoded arrays; a stream of
    another button count keeps the buttons both sets share."""
    if nb != NUM_BUTTONS:  # forward/backward compatible button sets
        t, b = move.shape[:2]
        out = np.zeros((t, b, NUM_BUTTONS), bool)
        out[..., : min(nb, NUM_BUTTONS)] = buttons[..., : min(nb, NUM_BUTTONS)]
        buttons = out
    return Actions(*(torch.from_numpy(a.copy()).to(device) for a in (move, look, buttons)))


class ActionRecorder:
    """Accumulate per-tick [B] actions from a live loop, then save()."""

    def __init__(self):
        self._ticks: list[Actions] = []

    def record(self, actions: Actions):
        self._ticks.append(actions)

    def __len__(self):
        return len(self._ticks)

    def stream(self) -> Actions:
        """The recorded ticks as one [T, B] stream."""
        if not self._ticks:
            raise ValueError("nothing recorded")
        return Actions(*(torch.stack([getattr(a, f) for a in self._ticks]) for f in ("move", "look", "buttons")))

    def save(self, path: str | Path, native: bool | None = None):
        save_actions(path, self.stream(), native=native)
