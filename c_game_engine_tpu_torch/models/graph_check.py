"""Hold the captured tick graph (models/graph.py) to the eager loop on the
same card, bit for bit: the checks that chip_smoke.py and
tests/test_torch_cuda.py run.

    graph_and_eager(cmap, state, acts)   one rollout both ways, with counts
    gate_states(arena, bodies_map, B)    states that open and close each gate
    check_gate_state(kind, ...)          graph against eager on one of them
    check_collect(cmap, batch, ticks)    rollout_collect both ways
    half_asleep(cmap, batch)             a batch whose body gate a shard splits

Counts are the device counts of utils/counters.py: each kernel's launches
and the body and stick gates' open ticks.
"""

from __future__ import annotations

import time

import torch

from c_game_engine_tpu_torch.core.state import tree_leaves
from c_game_engine_tpu_torch.models.graph import CAP, tick_graph
from c_game_engine_tpu_torch.models.sim import (
    bench_actions,
    reset_batch,
    rollout,
    rollout_collect,
    rollout_collect_eager,
    rollout_eager,
)
from c_game_engine_tpu_torch.utils import counters

KERNELS = ("capsule_resolve", "ray_tris", "body_contacts", "raster_tiles", "raster_tiles_big")


def kernel_counts() -> dict:
    """{kernel name: launches} since the last counters.reset()."""
    return {k: counters.read(k) for k in KERNELS}


def gate_counts() -> dict:
    return {k: counters.read(k) for k in ("body_gate", "stick_gate")}


def same_leaves(label, a, b) -> int:
    """Raise unless the two states (of two runs: the graph and the eager
    loop, or a sharded and an unsharded run) are equal leaf by leaf, bit
    for bit; returns the number of leaves."""
    pairs = list(zip(tree_leaves(a), tree_leaves(b)))
    differ = [(k, float((x.double() - y.double()).abs().max()) if x.is_floating_point() else int((x != y).sum()))
              for (k, x), (_, y) in pairs if not torch.equal(x, y)]
    if differ:
        raise AssertionError(f"{label}: the two runs differ in {differ}")
    return len(pairs)


def graph_and_eager(cmap, state, acts):
    """The same rollout through the map's tick graph (captured first, not
    timed) and through the eager loop, each with every count reset just
    before and read just after. Returns {"graph"/"eager": (final state,
    kernel counts, gate counts, seconds)}."""
    tick_graph(cmap, state)
    out = {}
    for mode, roll in (("graph", rollout), ("eager", rollout_eager)):
        torch.cuda.synchronize()
        counters.reset()
        t0 = time.perf_counter()
        final = roll(cmap, state, acts)
        torch.cuda.synchronize()
        out[mode] = (final, kernel_counts(), gate_counts(), time.perf_counter() - t0)
    return out


def gate_states(arena, bodies_map, batch):
    """{kind: (cmap, state, actions)}: states on the committed maps on which
    a gate of the tick opens on some ticks and stays closed on others.
    stick: arena after 10 ticks of the stream, lanes 0::2 lifted 5 cm with
    on_ground set (the stick gate opens on the first tick); audio: arena
    at reset with the SOUND_PLAYER's play bit in lanes 0::3 and actor 0's
    coin-cling bit in lanes 1::3 (both audio gates open on the first tick);
    bodies: arena_bodies at reset with every sleep counter at SLEEP_AFTER
    and zero velocities (the body gate stays closed until the walking
    player reaches the box 1.7 m ahead, about tick 12)."""
    from c_game_engine_tpu_torch.physics.bodies import SLEEP_AFTER

    lanes = torch.arange(batch, device="cuda")
    st = rollout(arena, reset_batch(arena, batch), bench_actions(10, batch, "cuda"))
    lift = (lanes % 2 == 0)
    p = st.player
    stick = st.replace(player=p.replace(pos=p.pos + lift[:, None] * torch.tensor([0.0, 0.05, 0.0], device="cuda"),
                                        on_ground=p.on_ground | lift))
    st = reset_batch(arena, batch)
    ops = st.sound_ops.clone()
    ops[lanes % 3 == 0, arena.aux["actor_classes"].index("SOUND_PLAYER")] = 1
    ops[lanes % 3 == 1, 0] = 16
    audio = st.replace(sound_ops=ops)
    st = reset_batch(bodies_map, batch)
    sleep = st.actors.sleep.clone()
    sleep[:, bodies_map.dyn_slots[bodies_map.dyn_slots >= 0].long()] = SLEEP_AFTER
    asleep = st.replace(actors=st.actors.replace(sleep=sleep, vel=torch.zeros_like(st.actors.vel),
                                                 omega=torch.zeros_like(st.actors.omega)))
    return {"stick": (arena, stick, bench_actions(12, batch, "cuda")),
            "audio": (arena, audio, bench_actions(12, batch, "cuda")),
            "bodies": (bodies_map, asleep, bench_actions(24, batch, "cuda"))}


def half_asleep(cmap, batch):
    """arena_bodies at reset for `batch` envs, every body of the back half
    asleep (sleep counter at SLEEP_AFTER, no velocity): the front half's
    settling bodies open the body gate for the whole batch, while a shard
    of the back half keeps it closed until a player wakes a body. On
    `cmap`'s device."""
    from c_game_engine_tpu_torch.physics.bodies import SLEEP_AFTER

    st = reset_batch(cmap, batch)
    a = st.actors
    dev = a.sleep.device
    rows = cmap.dyn_slots[cmap.dyn_slots >= 0].long()
    back = torch.arange(batch, device=dev) >= batch // 2
    body = torch.isin(torch.arange(a.sleep.shape[1], device=dev), rows)
    sleep = torch.where(back[:, None] & body[None, :], SLEEP_AFTER, a.sleep).int()
    still = back[:, None, None]
    return st.replace(actors=a.replace(sleep=sleep, vel=torch.where(still, 0.0, a.vel),
                                       omega=torch.where(still, 0.0, a.omega)))


def check_gate_state(kind, cmap, state, acts):
    """Graph against eager on one gate state, bit for bit, with the same
    counts, and the gate open on some ticks and closed on others. Returns
    (gate counts, kernel counts) of the graph's run."""
    runs = graph_and_eager(cmap, state, acts)
    (g, gk, gg, _), (e, ek, eg, _) = runs["graph"], runs["eager"]
    same_leaves(f"gate state {kind}", g, e)
    if (gk, gg) != (ek, eg):
        raise AssertionError(f"gate state {kind}: graph counts {gk} {gg}, eager {ek} {eg}")
    t = acts.move.shape[0]
    if kind == "stick" and not (0 < gg["stick_gate"] < t and gk["capsule_resolve"] == t + gg["stick_gate"]):
        raise AssertionError(f"gate state stick: stick gate open on {gg['stick_gate']} of {t} ticks, "
                             f"K1 launched {gk['capsule_resolve']} times")
    if kind == "audio" and not (bool((state.sound_ops != 0).any()) and bool((g.sound_ops == 0).all())):
        raise AssertionError("gate state audio: the sound ops were not drained")
    if kind == "bodies" and not (0 < gg["body_gate"] < t and gk["body_contacts"] == gg["body_gate"]):
        raise AssertionError(f"gate state bodies: body gate open on {gg['body_gate']} of {t} ticks, "
                             f"K3 launched {gk['body_contacts']} times")
    return gg, gk


def check_collect(cmap, batch, ticks):
    """rollout_collect of player.pos from reset through the map's collect
    graph and through the eager loop on the card: the final state and every
    stacked row bit for bit. The stream holds W and turns a different angle
    on every tick, so a stale or shifted action or collect row shows; with
    `ticks` > CAP the graph runs it in chunks. Returns the number of
    chunks."""
    collect = lambda st: st.player.pos
    acts = bench_actions(ticks, batch, "cuda")
    acts.look[..., 0] = 0.001 * torch.arange(ticks, device="cuda")[:, None]
    state = reset_batch(cmap, batch)
    g, grows = rollout_collect(cmap, state, acts, collect)
    if cmap.graphs[(batch, True)].collect_fn is not collect:
        raise AssertionError("rollout_collect did not run the collect graph")
    e, erows = rollout_collect_eager(cmap, state, acts, collect)
    same_leaves("rollout_collect", g, e)
    if grows.shape != (ticks, batch, 3):
        raise AssertionError(f"rollout_collect: graph rows {tuple(grows.shape)}, expected {(ticks, batch, 3)}")
    if not torch.equal(grows, erows):
        bad = [t for t in range(ticks) if not torch.equal(grows[t], erows[t])]
        raise AssertionError(f"rollout_collect: the graph's rows differ from the eager loop's in ticks {bad[:10]}")
    if not torch.equal(grows[-1], g.player.pos):
        raise AssertionError("rollout_collect: the last row is not the final state's")
    return -(-ticks // CAP)
