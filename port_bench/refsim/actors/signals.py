"""Runtime signal (I/O) system, batched over envs (counterpart of
c_game_engine_tpu/actors/signals.py).

Outputs fired during a tick accumulate in a dense [B, N, NUM_OUTPUTS]
matrix, expand through the compiled edge table into a bounded per-env
event queue, and apply in bounded rounds (breadth-first; chains deeper
than the round count carry into the next tick's queue).
"""

from __future__ import annotations

import functools

import torch

from refsim.actors.defs import Output, ParamType
from refsim.core.state import EVENT_CAPACITY, EventQueue, empty_events

NUM_OUTPUTS = len(Output)


@functools.cache
def _output_ptype(device):
    """Default param type carried by each output when fired (built once
    per device)."""
    t = torch.zeros(NUM_OUTPUTS, dtype=torch.int32, device=device)
    t[int(Output.EXECUTION_RESULT)] = int(ParamType.BOOL)
    t[int(Output.COUNTER_CHANGED)] = int(ParamType.INTEGER)
    return t


def empty_fired(batch: int, n: int, device):
    return (
        torch.zeros((batch, n, NUM_OUTPUTS), dtype=torch.bool, device=device),
        torch.zeros((batch, n, NUM_OUTPUTS), dtype=torch.int32, device=device),
    )


def fire(fired, fired_pi, mask, output: Output, pi=None):
    """Mark `output` fired where mask [B, N] is set. Updates fired /
    fired_pi in place (they are per-tick scratch nobody else holds) and
    returns them."""
    o = int(output)
    fired[..., o] |= mask
    if pi is not None:
        fired_pi[..., o] = torch.where(mask, pi, fired_pi[..., o])
    return fired, fired_pi


def expand_outputs(cmap, fired, fired_pi, prev_queue: EventQueue) -> EventQueue:
    """Fired outputs -> queued events through the edge table, appended after
    what prev_queue already holds."""
    b = fired.shape[0]
    n_out = fired.shape[-1]
    valid_edge = cmap.edge_src >= 0
    src = torch.clamp_min(cmap.edge_src, 0)
    out = cmap.edge_out
    # each edge reads exactly one (src, out) cell: a gather of the
    # JAX module's one-hot [N*O, E] contraction
    cell = (src * n_out + out).long()
    triggered = valid_edge & fired.reshape(b, -1)[:, cell]  # [B, E]

    has_override = cmap.edge_ptype != int(ParamType.NONE)
    ptype = torch.where(has_override, cmap.edge_ptype, _output_ptype(fired.device)[out.long()])
    default_pi = fired_pi.reshape(b, -1)[:, cell]  # [B, E]
    pi = torch.where(has_override, cmap.edge_pi, default_pi)
    first = (torch.arange(4, device=fired.device) == 0).float()
    pf = torch.where(has_override[:, None], cmap.edge_pf, default_pi[..., None].float() * first)

    base = prev_queue.count  # [B]
    slot = torch.cumsum(triggered.int(), dim=-1) - 1 + base[:, None]
    ok = triggered & (slot < EVENT_CAPACITY)
    slot_w = torch.where(ok, slot, EVENT_CAPACITY)

    # dense placement: each queue slot matches at most one edge
    q_match = torch.arange(EVENT_CAPACITY, device=fired.device)[None, :, None] == slot_w[:, None, :]
    q_any = q_match.any(dim=-1)  # [B, Q]

    n_new = ok.sum(dim=-1, dtype=torch.int32)
    n_drop = (triggered & ~ok).sum(dim=-1, dtype=torch.int32)
    return EventQueue(
        target=_scatter(q_match, q_any, prev_queue.target, cmap.edge_dst),
        input=_scatter(q_match, q_any, prev_queue.input, cmap.edge_in),
        ptype=_scatter(q_match, q_any, prev_queue.ptype, ptype),
        pf=_scatter(q_match, q_any, prev_queue.pf, pf),
        pi=_scatter(q_match, q_any, prev_queue.pi, pi),
        count=torch.clamp_max(base + n_new, EVENT_CAPACITY),
        dropped=prev_queue.dropped + n_drop,
    )


def _scatter(q_match, q_any, buf, vals):
    """Place per-edge vals ([E, ...] shared or [B, E, ...] per env) into
    their matched queue slots of buf [B, Q, ...]."""
    b, q, e = q_match.shape
    tail = buf.shape[2:]
    if vals.dim() == 1 + len(tail):  # shared by every env
        vals = vals.expand(b, *vals.shape)
    m = q_match.reshape(b, q, e, *(1,) * len(tail))
    zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
    placed = torch.where(m, vals[:, None], zero).sum(dim=2).to(buf.dtype)
    keep = q_any.reshape(b, q, *(1,) * len(tail))
    return torch.where(keep, placed, buf)


def apply_events(cmap, state, fired, fired_pi):
    """Consume the event queue in one vectorized pass
    (handlers.apply_round); newly fired outputs accumulate into fired /
    fired_pi. Returns (state, fired, fired_pi) with an emptied queue."""
    from refsim.actors import handlers

    q = state.events
    state, fired, fired_pi = handlers.apply_round(cmap, state, fired, fired_pi, q)
    b = q.count.shape[0]
    state = state.replace(events=empty_events(q.count.device, (b,)).replace(dropped=q.dropped))
    return state, fired, fired_pi


def process_signals(cmap, state, fired, fired_pi, rounds: int):
    """Seed the queue with the tick's fired outputs, then alternate
    apply/expand for `rounds` rounds."""
    b, n = fired.shape[:2]
    state = state.replace(events=expand_outputs(cmap, fired, fired_pi, state.events))
    for _ in range(rounds):
        state, new_fired, new_pi = apply_events(cmap, state, *empty_fired(b, n, fired.device))
        state = state.replace(events=expand_outputs(cmap, new_fired, new_pi, state.events))
    return state
