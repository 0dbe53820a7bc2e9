"""The HUD's and the widget stack's asset tables a render bundle
holds (the frame batch reads neither)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from refsim.core.state import Struct

NUM_UITEX = 14


@dataclasses.dataclass
class HudAssets:
    ycoin_tex: torch.Tensor  # [] i32 atlas ids (-1 = missing)
    bcoin_tex: torch.Tensor
    crosshair_tex: torch.Tensor
    font_tex: torch.Tensor
    font_start_u: torch.Tensor  # [128] start U per ASCII code (-1 = absent)
    font_end_u: torch.Tensor  # [128]
    font_widths: torch.Tensor  # [128] glyph widths in texture pixels
    font_height: torch.Tensor  # [] texture height in pixels
    font_spacing: torch.Tensor  # [] spacing in pixels


HUD_FIELDS = tuple(f.name for f in dataclasses.fields(HudAssets))


@dataclass
class UiAssets(Struct):
    tex: torch.Tensor  # [NUM_UITEX] i32 atlas ids (-1 = missing)
    tex_size: torch.Tensor  # [NUM_UITEX, 2] f32 texture pixel dims
    # small font (font/small_font.gfon; the reference's widget font), the
    # font_* fields render/hud.py::draw_text reads
    font_tex: torch.Tensor
    font_start_u: torch.Tensor  # [128]
    font_end_u: torch.Tensor  # [128]
    font_widths: torch.Tensor  # [128]
    font_height: torch.Tensor
    font_spacing: torch.Tensor


UI_FIELDS = tuple(f.name for f in dataclasses.fields(UiAssets))
