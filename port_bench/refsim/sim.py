"""The batch around the tick: a fresh state broadcast over B envs."""

from __future__ import annotations

from refsim.core.state import reset, tree_map


def reset_batch(cmap, batch: int):
    """reset(cmap) with a leading batch axis of `batch` on every leaf."""
    single = reset(cmap)
    return tree_map(lambda x: x.unsqueeze(0).expand(batch, *x.shape).contiguous(), single)
