"""The multi-process tier on the CPU (parallel/distributed.py,
parallel/worker.py): two `gloo` processes on 127.0.0.1 step arena's 256
global envs (128 a process) for 8 ticks of long_run.walk_and_turn's
per-env stream and save a distributed checkpoint; a fresh group of two
restores it and steps 8 more, as tests/test_multihost.py runs the JAX
package's recipe.

  * both halves equal the port's one-process 256-env rollout of the same
    stream bit for bit, every leaf, and the start phase's sharded_rollout
    metrics equal the one-process ones;
  * the gathered positions are within tests/test_tpu_parity.py's bars of
    the JAX package's parallel/mesh.py::shard_sim run here on the 8 fake
    CPU devices of tests/conftest.py (player 2e-3; on_ground and coins
    equal);
  * the checkpoint is written once, by process 0;
  * a process whose peer never joins exits non-zero, with a message,
    within its timeout.

Every wait on a process has a limit (LAUNCH_S), and the workers' group
timeout (GROUP_S) bounds every collective, so no test here can hang.
"""

from __future__ import annotations

import json
import os
import re
import signal
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from c_game_engine_tpu_torch.long_run import walk_and_turn
from c_game_engine_tpu_torch.models.graph_check import same_leaves
from c_game_engine_tpu_torch.models.sim import load_named_map, reset_batch, rollout
from c_game_engine_tpu_torch.parallel import distributed
from c_game_engine_tpu_torch.parallel.mesh import make_mesh, sharded_rollout
from c_game_engine_tpu_torch.utils.checkpoint import load_checkpoint
from tests.torch_mesh_inputs import per_env_stream  # noqa: F401 - one torch thread a process

ROOT = Path(__file__).resolve().parents[1]
B, TICKS = 256, 8
GROUP_S = 60.0  # the workers' group timeout
LONE_S = 5.0  # the group timeout of a process left alone
LAUNCH_S = 120.0  # the longest wait on a launch


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _popen(cmd, env=None):
    # a session of its own, so that a kill reaches torchrun's workers too
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)


def _spawn(phase, outdir, ranks, timeout_s):
    port = _free_port()
    return [_popen([sys.executable, "-m", "c_game_engine_tpu_torch.parallel.worker", phase, str(outdir),
                    "--coordinator", f"127.0.0.1:{port}", "--processes", "2", "--rank", str(r), "--batch", str(B),
                    "--ticks", str(TICKS), "--cpu", "--timeout", str(timeout_s)]) for r in ranks]


def _wait(procs, limit=LAUNCH_S):
    """[(rc, stdout, stderr)] of every process; any still running after
    `limit` seconds is killed and fails the test."""
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=limit)
            out.append((p.returncode, o, e))
    finally:
        _kill(procs)
    return out


def _kill(procs):
    for p in procs:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        p.communicate()


def _two_phases(out):
    """The start and the resume phase, each in a fresh group of two:
    {(phase, rank): the rank's figures}."""
    for phase in ("start", "resume"):
        for r, (rc, o, e) in enumerate(_wait(_spawn(phase, out, (0, 1), GROUP_S))):
            assert rc == 0 and o.strip().endswith("WORKER_OK"), f"{phase} rank {r} rc {rc}:\n{o[-2000:]}\n{e[-4000:]}"
    return {(p, r): json.loads((out / f"rank{r}_{p}.json").read_text()) for p in ("start", "resume") for r in (0, 1)}


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Everything this file launches, started at once: the two phases (a
    thread waits on them while the tests compute their references) and
    each rank of a group of two alone, and long_run under torchrun.
    Returns (output directory, the phases' future, the lone processes,
    (torchrun's process, its checkpoint directory))."""
    out = tmp_path_factory.mktemp("multihost")
    lone = [_spawn("start", tmp_path_factory.mktemp(f"lone{r}"), [r], LONE_S)[0] for r in (0, 1)]
    ckdir = tmp_path_factory.mktemp("long_run")
    torchrun = _popen([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
                       "-m", "c_game_engine_tpu_torch.long_run", "--cpu", "arena", str(TICKS), str(TICKS // 2)],
                      dict(os.environ, CGE_BATCH=str(B), CGE_CKDIR=str(ckdir)))
    try:
        with ThreadPoolExecutor(1) as pool:
            yield out, pool.submit(_two_phases, out), lone, (torchrun, ckdir)
    finally:
        _kill([*lone, torchrun])


@pytest.fixture(scope="module")
def runs(launched):
    out, phases = launched[:2]
    return out, phases.result(timeout=2 * LAUNCH_S)


@pytest.fixture(scope="module")
def one_process():
    """The same stream in one process: (map, the state after 8 ticks, after 16)."""
    cmap = load_named_map("arena", "cpu")
    acts = walk_and_turn(TICKS, B, "cpu")
    half = rollout(cmap, reset_batch(cmap, B), acts)
    return cmap, half, rollout(cmap, half, acts)


def test_gathered_positions_within_the_jax_bars(launched):
    """First in the file: the JAX side compiles while the workers run."""
    import jax

    from c_game_engine_tpu.parallel.mesh import make_mesh as jax_mesh
    from c_game_engine_tpu.parallel.mesh import shard_sim
    from tests.torch_export_map import compile_arena
    from tests.torch_parity import jax_actions

    mesh = jax_mesh()
    assert mesh.devices.size == 8
    _, state, step_fn = shard_sim(compile_arena(), B, mesh)
    a = walk_and_turn(1, B, "cpu")[0]
    acts = jax_actions(a.move.numpy(), a.look.numpy(), a.buttons.numpy())
    states = []
    for _ in ("start", "resume"):
        for _ in range(TICKS):
            state = step_fn(state, acts)
        states.append(jax.device_get(state))
    out, phases = launched[:2]
    phases.result(timeout=2 * LAUNCH_S)
    for phase, name, st in zip(("start", "resume"), ("ckpt.npz", "final.npz"), states):
        pos = np.load(out / f"pos_{phase}.npy")
        np.testing.assert_allclose(pos, np.asarray(st.player.pos), atol=2e-3, rtol=0)
        with np.load(out / name) as z:
            np.testing.assert_array_equal(z["player.on_ground"], np.asarray(st.player.on_ground))
            np.testing.assert_array_equal(z["save.coins"], np.asarray(st.save.coins))
            assert z["save.coins"].sum() > 0


def test_two_processes_equal_one_process_bit_for_bit(runs, one_process):
    out, recs = runs
    cmap, half, whole = one_process
    for name, want in (("ckpt.npz", half), ("final.npz", whole)):
        got = load_checkpoint(out / name, reset_batch(cmap, B))
        assert same_leaves(f"two processes, {name}", want, got) > 60
    np.testing.assert_array_equal(np.load(out / "pos_start.npy"), half.player.pos.numpy())
    np.testing.assert_array_equal(np.load(out / "pos_resume.npy"), whole.player.pos.numpy())
    # the envs went different ways, and each process stepped its own half
    assert whole.player.pos.std(0).min() > 0.01 and int(whole.tick[0]) == 2 * TICKS
    assert [recs["start", r]["envs"] for r in (0, 1)] == [[0, B // 2], [B // 2, B]]
    # sharded_rollout's metrics are reduced over the gathered columns as in
    # one process: the same bits
    _, metrics = sharded_rollout(cmap, make_mesh(devices=["cpu"]), B, TICKS, walk_and_turn(1, B, "cpu")[0])
    want = {k: float(v) for k, v in metrics.items()}
    assert recs["start", 0]["metrics"] == recs["start", 1]["metrics"] == want and want["mean_coins"] > 0


def test_checkpoint_is_written_once_by_process_0(runs):
    out, recs = runs
    for phase, name in (("start", "ckpt.npz"), ("resume", "final.npz")):
        w0, w1 = recs[phase, 0]["writes"], recs[phase, 1]["writes"]
        assert w1 == [], f"rank 1 wrote {w1}"
        assert w0 == sorted([name, f"{name}.tmp", f"pos_{phase}.npy"]), w0
        # the file every process saw after the barrier is the one on disk
        mtime = (out / name).stat().st_mtime_ns
        assert recs[phase, 0]["checkpoint_mtime_ns"] == recs[phase, 1]["checkpoint_mtime_ns"] == mtime
    with np.load(out / "ckpt.npz") as z:
        assert z["tick"].shape == (B,) and (z["tick"] == TICKS).all()


def test_a_lone_process_fails_within_its_timeout(launched):
    for r, (rc, o, e) in enumerate(_wait(launched[2])):
        assert rc != 0 and "WORKER_OK" not in o, (r, rc, o, e[-2000:])
        m = re.search(rf"worker rank {r}: start failed after ([0-9.]+) s: ", e)
        assert m, e[-2000:]
        # the group's timeout and the store's last retry
        assert float(m.group(1)) < LONE_S + 10, m.group(0)


def test_long_run_under_torchrun(launched, one_process):
    """long_run unchanged under `torch.distributed.run --nproc_per_node 2`:
    the group from torchrun's environment, process 0's log, checkpoints
    of the gathered state (the last one equal to one process's state),
    the resume proof in every process."""
    torchrun, ckdir = launched[3]
    ((rc, o, e),) = _wait([torchrun])
    assert rc == 0, f"{o[-2000:]}\n{e[-4000:]}"
    lines = o.strip().splitlines()
    assert lines[0] == "mesh: 1 device(s) (cpu) in each of 2 processes", lines
    assert sum("BITWISE equal" in line for line in lines) == 1, lines
    assert sorted(p.name for p in ckdir.iterdir()) == [f"ck_{TICKS // 2:08d}.npz", f"ck_{TICKS:08d}.npz"]
    cmap, half, _ = one_process
    same_leaves("long_run under torchrun", half, load_checkpoint(ckdir / f"ck_{TICKS:08d}.npz", half))


def test_distributed_without_a_group():
    assert distributed.process_count() == 1 and distributed.process_index() == 0
    assert distributed.env_range(B) == range(B)
    x = torch.arange(6).reshape(3, 2)
    assert torch.equal(distributed.process_allgather(x), x)
    assert torch.equal(distributed.process_allgather(x, tiled=False), x[None])
    with pytest.raises(ValueError, match="0-d"):
        distributed.process_allgather(torch.tensor(1.0))
    distributed.sync_global_devices("no group")
    with pytest.raises(RuntimeError, match="no process group"):
        distributed.local_device()
    env = {k: os.environ.pop(k) for k in distributed.TORCHRUN_ENV if k in os.environ}
    try:
        with pytest.raises(ValueError, match="torchrun"):
            distributed.initialize()
    finally:
        os.environ.update(env)
    with pytest.raises(ValueError, match="not one of"):
        distributed.initialize("127.0.0.1:1", 2, 2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            distributed.initialize("127.0.0.1:1", 2, 0)
    assert distributed.process_count() == 1
