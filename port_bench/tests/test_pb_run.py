"""run.py's refusals: no card, a checkout without the port."""

import shutil
import subprocess
import sys

from harness.spec import BENCH_DIR, ROOT


def test_no_card_exits_1_and_prints_no_result():
    proc = subprocess.run([sys.executable, str(BENCH_DIR / "run.py"), "--workload", "lit_agent_4096", "--seed",
                           str(2**31 + 1), "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"}, cwd=ROOT)
    assert proc.returncode == 1
    assert proc.stdout == ""
    assert "CUDA card" in proc.stderr


def test_without_the_port_the_program_cannot_load(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH_DIR, tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path[:0] = ['port_bench', '.']; import torch; from harness.spec import load_cell; "
            "from harness.program import Program; c = load_cell('lit_agent_4096'); "
            "Program(c.config, 8, torch.device('cpu'), False)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=tmp_path)
    assert proc.returncode != 0 and "No module named 'c_game_engine_tpu_torch'" in proc.stderr
