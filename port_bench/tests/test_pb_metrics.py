"""The metric readers' arithmetic on made-up windows and timelines."""

import math
from types import SimpleNamespace

import pytest

from harness import trace
from harness.loop import Calls
from harness.spec import metric_module, reader


def rec(**kw):
    base = {"pixels": False, "loop": "closed", "envs": 4, "counts": {}, "timeline": None, "captured": {},
            "traced_ticks": 0, "setup_s": 1.5}
    return {**base, **kw}


def test_rate_is_all_the_work_over_all_the_time():
    w = Calls(calls=10, ticks=10, seconds=2.0, step_ms=[1.0] * 9 + [1000.0])
    assert reader("steps_per_s")(rec(window=w)) == 4 * 10 / 2.0
    assert reader("frames_per_s")(rec(window=w)) is None
    assert reader("frames_per_s")(rec(window=w, pixels=True)) == 4 * 10 / 2.0
    assert reader("steps_per_s")(rec(window=w, pixels=True)) is None
    s = Calls(calls=3, ticks=720, seconds=4.0)
    assert reader("steps_per_s")(rec(window=s, loop="stream")) == 4 * 720 / 4.0


def test_p95_is_over_every_sample():
    ms = list(range(1, 101))  # 1..100 ms
    w = Calls(calls=100, ticks=100, seconds=1.0, step_ms=ms[::-1])
    assert reader("step_ms_p95")(rec(window=w)) == 95
    w = Calls(calls=20, ticks=20, seconds=1.0, step_ms=[5.0] * 19 + [50.0])
    assert reader("step_ms_p95")(rec(window=w)) == 5.0  # nearest rank: the 19th of 20
    w = Calls(calls=21, ticks=21, seconds=1.0, step_ms=[5.0] * 19 + [50.0, 60.0])
    assert reader("step_ms_p95")(rec(window=w)) == 50.0
    assert reader("step_ms_p95")(rec(window=w, loop="stream")) is None


def test_means_and_shares():
    w = Calls(calls=4, ticks=4, seconds=1.0, tick_ms=[1.0, 2.0, 3.0, 6.0], entry_host_ms=[1.0, 1.0, 1.0, 5.0],
              render_ms=[2.0, 4.0])
    assert reader("tick_ms.steps")(rec(window=w)) == 3.0
    assert reader("tick_ms.frames")(rec(window=w)) is None
    assert reader("tick_ms.frames")(rec(window=w, pixels=True)) == 3.0
    assert reader("entry_host_ms.steps")(rec(window=w)) == 2.0
    assert reader("render_ms")(rec(window=w)) == 3.0
    assert reader("body_gate_share")(rec(window=w, counts={"body_gate": 3})) == 0.75
    s = Calls(calls=1, ticks=240, seconds=1.0, tick_ms=[480.0])
    assert reader("tick_ms.steps")(rec(window=s, loop="stream")) == 2.0


def timeline():
    dev = [("k_a", 1.0, 2.0), ("k_b", 1.5, 3.0), ("Memcpy DtoH", 5.0, 5.5), ("k_a", 8.0, 9.0), ("k_late", 11.0, 12.0)]
    host = [("port_bench.window", 0.0, 10.0), ("port_bench.step", 0.5, 4.0), ("port_bench.wait", 4.0, 10.0),
            ("aten::copy_", 3.2, 4.5), ("cudaStreamSynchronize", 5.6, 7.9)]
    return trace.Timeline((0.0, 10.0), dev, host)


def test_idle_is_the_union_of_device_intervals():
    tl = timeline()
    # busy: [1, 3] + [5, 5.5] + [8, 9], the late kernel outside the window
    assert trace.busy_s(tl) == pytest.approx(3.5)
    assert reader("device_idle.steps")(rec(timeline=tl)) == pytest.approx(1 - 3.5 / 10.0)
    assert reader("device_idle.frames")(rec(timeline=tl)) is None
    assert reader("device_idle.frames")(rec(timeline=tl, pixels=True)) == pytest.approx(0.65)
    assert trace.union([(0, 2), (1, 3), (4, 5)], 0.5, 4.5) == [[0.5, 3], [4, 4.5]]


def test_breakdown_names_ops_and_gaps():
    tl = timeline()
    ops = dict(trace.device_ops(tl))
    assert ops == {"k_a": 2.0, "k_b": 1.5, "Memcpy DtoH": 0.5}
    gaps = trace.idle_gaps(tl)
    assert [g for _, g in gaps] == pytest.approx([2.5, 2.0, 1.0, 1.0])
    assert gaps[0][0] == "wait / cudaStreamSynchronize"  # the gap 5.5-8
    assert gaps[1][0] == "wait / aten::copy_"  # the gap 3-5, at its middle 4.0
    assert trace.kernel(tl, "k_a") == (2.0, 2)


def test_roofline_is_bound_over_kernel_time(monkeypatch):
    from harness import bounds

    tl = trace.Timeline((0.0, 1.0), [("capsule_resolve_kernel(float const*)", 0.1, 0.1 + 4e-4)] * 3, [])
    monkeypatch.setattr(bounds, "k1_bound", lambda args: (args[0], "operations"))
    # two ticks: two main launches (0.1 ms bound) and one stick launch (0.05 ms)
    cap = metric_module("k1_roofline").CAPTURE
    r = rec(timeline=tl, traced_ticks=2, captured={cap: [((0.1,), {}, None), ((0.05,), {}, None)]})
    assert reader("k1_roofline")(r) == pytest.approx(100 * (2 * 0.1 + 0.05) / 1.2)
    assert reader("k1_roofline")(rec(timeline=tl, traced_ticks=2)) is None


def test_the_profilers_stalls_leave_the_window():
    tl = timeline()
    tl.host.append(("Buffer Flush", 5.9, 7.0))  # inside the idle stretch 5.5-8
    tl.host.append(("Activity Buffer Request", 8.2, 8.5))  # the device is busy then: no idle time to take out
    assert trace.busy_s(tl) == pytest.approx(3.5)
    assert tl.window_s == pytest.approx(10.0 - 1.1)
    assert reader("device_idle.steps")(rec(timeline=tl)) == pytest.approx(1 - 3.5 / 8.9)
    gaps = dict((round(g, 6), n) for n, g in trace.idle_gaps(tl))
    assert set(gaps) == {2.0, 1.0, 0.4}  # 3-5, 0-1 and 9-10; 5.5-5.9 and 7-8 are 0.4 and 1.0
    assert trace.short_name("void ns::k<1, (x)2>(float const*, int)") == "ns::k<1, (x)2>"
    assert trace.short_name("void at::native::(anonymous namespace)::f<2>(int)") == "at::native::f<2>"
