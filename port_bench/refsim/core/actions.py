"""Per-tick action encoding (counterpart of c_game_engine_tpu/core/actions.py).

A dense per-env action vector; buttons carry the edge/hold semantics the
consuming code wants (see the JAX module for the reference citations).
"""

from __future__ import annotations

import dataclasses
import enum

import torch


class Button(enum.IntEnum):
    # copied from c_game_engine_tpu/core/actions.py:18-28
    JUMP = 0
    INTERACT = 1
    SLOW = 2
    SPRINT = 3
    NOCLIP = 4
    FREECAM = 5
    ITEM_NEXT = 6
    ITEM_PREV = 7
    FIRE = 8
    ALT_FIRE = 9


NUM_BUTTONS = len(Button)
# flat action vector: move_x, move_z, look_dx, look_dy, buttons...
ACTION_DIM = 4 + NUM_BUTTONS


@dataclasses.dataclass
class Actions:
    move: torch.Tensor  # [..., 2] x (strafe, +right), z (+backward; W = -1)
    look: torch.Tensor  # [..., 2] yaw delta, pitch delta (radians this tick)
    buttons: torch.Tensor  # [..., NUM_BUTTONS] bool

    @staticmethod
    def zeros(batch_shape=(), device="cuda") -> "Actions":
        return Actions(
            move=torch.zeros((*batch_shape, 2), dtype=torch.float32, device=device),
            look=torch.zeros((*batch_shape, 2), dtype=torch.float32, device=device),
            buttons=torch.zeros((*batch_shape, NUM_BUTTONS), dtype=torch.bool, device=device),
        )

    @staticmethod
    def from_flat(flat: torch.Tensor) -> "Actions":
        """[..., ACTION_DIM] -> Actions; a button is down where its entry
        is above 0.5."""
        return Actions(
            move=flat[..., 0:2].to(torch.float32),
            look=flat[..., 2:4].to(torch.float32),
            buttons=flat[..., 4 : 4 + NUM_BUTTONS] > 0.5,
        )

    def to_flat(self) -> torch.Tensor:
        """[..., ACTION_DIM] float32: move, look, buttons as 0/1."""
        return torch.cat([self.move, self.look, self.buttons.to(torch.float32)], dim=-1)

    def __getitem__(self, t) -> "Actions":
        """Index the leading (time) axis of a [T, B, ...] stream."""
        return Actions(move=self.move[t], look=self.look[t], buttons=self.buttons[t])

    def replace(self, **kw) -> "Actions":
        return dataclasses.replace(self, **kw)
