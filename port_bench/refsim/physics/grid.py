"""Runtime queries against the compile-time uniform grid
(compiler/broadphase.py; counterpart of c_game_engine_tpu/physics/grid.py)."""

from __future__ import annotations

import torch


def cell_of(cmap, x, z):
    """Flat index of the grid cell holding world (x, z), clamped to the
    grid: [...] int64."""
    gx, gz = cmap.aux["grid_shape"]
    cx = torch.clamp(((x - cmap.grid_lo[0]) * cmap.grid_inv_cell).to(torch.int32), 0, gx - 1)
    cz = torch.clamp(((z - cmap.grid_lo[1]) * cmap.grid_inv_cell).to(torch.int32), 0, gz - 1)
    return (cx * gz + cz).long()


def query_cell(cmap, pos):
    """Candidate static-triangle indices near `pos`.
    pos: [..., 3] -> [..., L] int32 (-1 padded)."""
    return cmap.grid_cells[cell_of(cmap, pos[..., 0], pos[..., 2])]
