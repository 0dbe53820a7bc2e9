"""The tick's batch-global gates, eagerly: a gate runs its branch only
when a predicate over the whole batch holds (a host read of the
predicate), and otherwise hands on its inputs unchanged."""

from __future__ import annotations

import torch


def read(pred: torch.Tensor) -> bool:
    return bool(pred)


def gate(pred: bool, fn, passthrough):
    return fn() if pred else passthrough()


def branch(pred: bool, if_true, if_false):
    return if_true() if pred else if_false()
