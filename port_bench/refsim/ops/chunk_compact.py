"""Compacted triangle-chunk lists for the physics kernels (counterpart of
c_game_engine_tpu/ops/chunk_compact.py).

For each (env block, query) the XZ AABB overlap test against every
32-triangle chunk runs once per kernel call as plain tensor ops; the kernel
then loops over exactly the overlapping chunks. Contract the kernels rely
on: overlapping chunk ids packed first in increasing order, the rest of
the row 0, and `cnt` 0 for an empty query (min +inf, max -inf).
"""

from __future__ import annotations

import torch


def compact_chunk_lists(chunk_bounds, xmin, xmax, zmin, zmax, margin):
    """chunk_bounds [NC, 4] (minx minz maxx maxz); xmin/xmax/zmin/zmax [...]
    per-query XZ extents; margin a float, or a tensor over the leading
    query axes (e.g. [D] per body for [D, G] queries).

    Returns (idx [..., NC] i32, cnt [...] i32)."""
    cb = chunk_bounds
    if isinstance(margin, torch.Tensor) and margin.ndim:
        margin = margin.reshape(*margin.shape, *(1,) * (xmin.ndim + 1 - margin.ndim))
    ov = (
        (cb[:, 0] <= xmax[..., None] + margin)
        & (cb[:, 2] >= xmin[..., None] - margin)
        & (cb[:, 1] <= zmax[..., None] + margin)
        & (cb[:, 3] >= zmin[..., None] - margin)
    )  # [..., NC]
    cnt = ov.sum(dim=-1, dtype=torch.int32)
    nc = cb.shape[0]
    # a stable sort on "not overlapping" keeps overlapping ids in order
    order = torch.argsort((~ov).to(torch.uint8), dim=-1, stable=True)
    slot = torch.arange(nc, device=cb.device)
    idx = torch.where(slot < cnt[..., None], order, 0)
    return idx.to(torch.int32), cnt


def block_minmax(comp, blk, mask=None):
    """Per-env-block min/max of a [..., B] component. Returns ([..., G] min,
    [..., G] max) with G = B // blk. Lanes where `mask` is False are left
    out; an all-masked block yields (+inf, -inf), an empty query."""
    g = comp.reshape(*comp.shape[:-1], comp.shape[-1] // blk, blk)
    if mask is None:
        return g.amin(dim=-1), g.amax(dim=-1)
    m = mask.reshape(g.shape)
    return torch.where(m, g, torch.inf).amin(dim=-1), torch.where(m, g, -torch.inf).amax(dim=-1)


def gather_listed_chunks(tri16, idx, cnt, t_chunk):
    """Triangles of each block's chunk list in the kernels' visiting order,
    for the plain versions: ([G, K, 16] rows, [G, K] valid) with
    K = t_chunk * max(cnt); rows past a block's count are invalid. Reads
    max(cnt) on the host."""
    c = int(cnt.max()) if cnt.numel() else 0
    ids = idx[:, :c].long()
    rows = (ids[..., None] * t_chunk + torch.arange(t_chunk, device=idx.device)).flatten(1)
    tri = tri16[rows]  # [G, K, 16]
    listed = (torch.arange(c, device=idx.device) < cnt[:, None]).repeat_interleave(t_chunk, 1)
    valid = torch.where(listed, tri[..., 12], 0.0)
    return tri, valid
