"""The benchmark's own tests (run from the repo root with
`python -m pytest port_bench/tests -q`). Tests marked `cuda` need a CUDA
card and skip elsewhere."""

import sys
from pathlib import Path

import pytest
import torch

BENCH_DIR = Path(__file__).resolve().parents[1]
for p in (str(BENCH_DIR.parent), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)
torch.set_num_threads(2)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips elsewhere")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
