"""Static-world broadphase: uniform XZ grid over the collision triangles
(counterpart of c_game_engine_tpu/compiler/broadphase.py).

Replaces Jolt's quadtree broadphase for the static map (the map never
changes after load — PhysicsSystem_OptimizeBroadPhase, MapLoader.c:273).
Each cell stores the indices of triangles whose inflated AABB overlaps the
cell's 3x3 neighborhood, padded to the map-wide max occupancy so a single
gather per query yields a fixed-shape candidate list. Query = one cell
lookup for any shape whose extent + per-tick travel stays under the
inflation margin (cell 2 m, margin 1.2 m: capsule 0.45 + travel 0.1 and
props up to ~0.9 half-extent all qualify).
"""

from __future__ import annotations

import numpy as np

CELL_SIZE = 2.0
INFLATE = 1.2  # minimum query margin: capsule 0.45 + travel budget


def build_grid(tris: np.ndarray, tri_valid: np.ndarray, inflate: float = INFLATE):
    """tris: [T,3,3]. `inflate` is the query margin — it must cover the
    largest query shape's support radius + contact slack + per-tick travel;
    compile_map computes it from the map's actual dynamic bodies instead of
    trusting the default (ADVICE r1: a hard-coded margin silently drops
    contacts for oversized bodies). Returns dict with grid arrays (numpy):
    lo [2], inv_cell, shape (gx, gz), cells [gx*gz, L] i32 (pad -1)."""
    inflate = max(float(inflate), INFLATE)
    valid_idx = np.where(tri_valid)[0]
    if len(valid_idx) == 0:
        return {
            "lo": np.zeros(2, np.float32),
            "inv_cell": np.float32(1.0 / CELL_SIZE),
            "shape": (1, 1),
            "cells": np.full((1, 1), -1, np.int32),
        }
    v = tris[valid_idx]  # [T,3,3]
    t_lo = v.min(axis=1)[:, [0, 2]] - inflate
    t_hi = v.max(axis=1)[:, [0, 2]] + inflate
    lo = t_lo.min(axis=0)
    hi = t_hi.max(axis=0)
    gx = max(int(np.ceil((hi[0] - lo[0]) / CELL_SIZE)), 1)
    gz = max(int(np.ceil((hi[1] - lo[1]) / CELL_SIZE)), 1)

    buckets = [[] for _ in range(gx * gz)]
    c_lo = np.clip(((t_lo - lo) / CELL_SIZE).astype(np.int64), 0, [gx - 1, gz - 1])
    c_hi = np.clip(((t_hi - lo) / CELL_SIZE).astype(np.int64), 0, [gx - 1, gz - 1])
    for k, ti in enumerate(valid_idx):
        for cx in range(c_lo[k, 0], c_hi[k, 0] + 1):
            for cz in range(c_lo[k, 1], c_hi[k, 1] + 1):
                buckets[cx * gz + cz].append(ti)
    max_len = max((len(b) for b in buckets), default=1)
    # round up to the lane multiple for clean VPU tiling
    L = max(((max_len + 7) // 8) * 8, 8)
    cells = np.full((gx * gz, L), -1, np.int32)
    for i, b in enumerate(buckets):
        cells[i, : len(b)] = b
    return {
        "lo": lo.astype(np.float32),
        "inv_cell": np.float32(1.0 / CELL_SIZE),
        "shape": (gx, gz),
        "cells": cells,
    }
