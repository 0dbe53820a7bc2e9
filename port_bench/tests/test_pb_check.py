"""`correct` against broken programs: a run of the harness on the CPU at a
tiny size (the look for a card skipped), with the timed path broken
underneath, and with the reference put in the program's place in a lower
precision (the control)."""

import dataclasses
import json
import time

import pytest
import torch

import run
from harness.program import Program
from pb_small import small_cell

CPU = torch.device("cpu")
CELLS = ("bodies_agent_4096", "lit_pixels_64", "lit_agent_4096", "lit_stream_4096")


def run_small(name, fault=None, control=None, trace=0, envs=None):
    envs = envs or (2 if name == "lit_pixels_64" else 8)
    cell = small_cell(name, envs=envs)
    return run.run_cell(cell, 2**31 + 101, 0.5, trace, CPU, control=control, fault=fault,
                        t_process=time.perf_counter())


class Broken:
    """The program with one fault planted where its answer is produced."""

    def __init__(self, prog: Program, kind: str):
        self.prog, self.kind = prog, kind

    def __getattr__(self, name):
        return getattr(self.prog, name)

    def _break(self, state, new):
        if self.kind == "unchanged":  # a step that returns its state unchanged
            return dataclasses.replace(state)
        if self.kind == "half":  # half of the batch left out: those envs keep their state
            from harness.reference import leaves, rebuild

            old, b = dict(leaves(state)), state.tick.shape[0]
            return rebuild(new, {k: torch.cat([v[: b // 2], old[k][b // 2:]]) for k, v in leaves(new)})
        pos = new.player.pos.clone()  # one env's answer altered
        pos[0, 0] += 1e-2
        return new.replace(player=new.player.replace(pos=pos))

    def step(self, state, actions):
        return self._break(state, self.prog.step(state, actions))

    def render(self, state):
        frames = self.prog.render(state)
        if self.kind == "altered":  # one env's frame altered
            frames = frames.clone()
            frames[0] *= 0.9
        return frames

    def collect(self, state, actions, observer):
        if self.kind == "unchanged":
            obs = observer(state)
            return state, obs.expand(actions.move.shape[0], *obs.shape).clone()
        final, traj = self.prog.collect(state, actions, observer)
        traj = traj.clone()
        if self.kind == "half":
            half = traj.shape[1] // 2
            traj[:, half:] = observer(state)[half:]
        else:
            traj[1, 0, 0] += 1e-2
        return final, traj


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = run_small(name)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    for k, v in res["checks"].items():
        assert v["value"] <= v["limit"], k


@pytest.mark.parametrize("kind", ("unchanged", "half", "altered"))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_program_is_not_correct(name, kind):
    res = run_small(name, fault=lambda prog: Broken(prog, kind))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", ("lit_agent_4096", "lit_pixels_64", "lit_stream_4096", "bodies_agent_4096"))
def test_bf16_control_is_not_correct(name):
    res = run_small(name, control="bf16")
    assert not res["correct"], res["checks"]


def test_traced_run_reports_its_per_layer_metrics_and_the_breakdown():
    res = run_small("lit_agent_4096", trace=1)
    assert {"entry_host_ms.steps", "tick_ms.steps"} <= set(res["metrics"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["device"]["window_s"] > 0
    # the CPU launches no kernel: the one metric listed for the cell that reads nothing
    assert res["missing"] == ["k1_roofline"]


def test_a_listed_metric_that_reads_nothing_fails_the_run(monkeypatch, capsys):
    res = run_small("lit_agent_4096", trace=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "card_query", lambda: None)
    monkeypatch.setattr(run, "card_line", lambda query: "no card")
    monkeypatch.setattr(run, "run_cell", lambda *a, **kw: dict(res))
    argv = ["--workload", "lit_agent_4096", "--seed", "1", "--seconds", "1", "--trace", "1"]
    assert run.main(argv) == 1
    out = capsys.readouterr()
    assert out.out == "" and "k1_roofline" in out.err
    res["missing"] = []
    assert run.main(argv) == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_card_run_is_correct(cuda, name):
    envs = 64 if name == "lit_pixels_64" else 256
    res = run.run_cell(small_cell(name, envs=envs, ticks=24), 2**31 + 7, 2.0, 1, cuda,
                       t_process=time.perf_counter())
    assert res["correct"], res["checks"]


@pytest.mark.cuda
def test_tf32_control_is_not_correct_on_the_rigid_bodies(cuda):
    res = run.run_cell(small_cell("bodies_agent_4096", envs=256, ticks=24), 2**31 + 9, 2.0, 0, cuda,
                       control="tf32", t_process=time.perf_counter())
    assert not res["correct"], res["checks"]
