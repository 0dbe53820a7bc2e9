"""A cell of BENCHMARK.json with the data files it names, found by name:
configs/<file> (from the configuration's entry), traffic/<mix>.json,
checks/<cell>.json and a reader metrics/<metric>.py for each metric.

A reader module has `read(rec)`, which returns the metric's value from
what the run recorded, or None where it finds nothing to read. It may
also declare what the run has to record for it:
  COUNTERS  names of the program's device counts (utils/counters.py),
            read before and after the window: rec["counts"][name] is the
            window's difference;
  CAPTURE   (module, attribute, call): the function that the port's
            `module` looks up as `attribute` is wrapped while the program
            runs `call` ("tick" or "frame") once eagerly after the traced
            window; rec["captured"][CAPTURE] lists (args, kwargs, outputs)
            of each call it saw, cloned.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    checks: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


def _for_cell(metrics, name):
    return [m for m in metrics if "workloads" not in m or name in m["workloads"]]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return Cell(
        name=name,
        chips=cell["chips"],
        config=json.loads((root / entry["file"]).read_text()),
        traffic=json.loads((BENCH_DIR / "traffic" / f"{cell['traffic']}.json").read_text()),
        checks=json.loads((BENCH_DIR / "checks" / f"{name}.json").read_text()),
        end_to_end=_for_cell(bench["end_to_end"], name),
        per_layer=_for_cell(bench["per_layer"], name),
    )


def metric_module(metric: str):
    """metrics/<metric>.py, loaded."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str):
    """The `read(rec)` function of metrics/<metric>.py."""
    return metric_module(metric).read
