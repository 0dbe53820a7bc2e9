"""The multi-process tier: one process per card (or per host), joined in
one process group. The port's counterpart of what the JAX package uses
from `jax.distributed` and `jax.experimental.multihost_utils`, under the
same names:

    initialize(coordinator_address, num_processes, process_id)
    process_count(), process_index()
    process_allgather(tree, tiled=True)
    sync_global_devices(name)
    shutdown()

and `local_device()` (this process's device), `env_range(batch)` (the
envs this process owns of a global batch) and `broadcast_str(s)`.

The group is `gloo`, and its collectives carry host tensors only: the
metric columns, the checkpoint's gather and the barriers. Per-env state
never crosses processes while stepping (docs/MULTIHOST.md), so no NCCL
communicator is needed; and two ranks on one card could not share one
(NCCL refuses two ranks on the same GPU), which is how a one-card machine
checks the tier. The group is created with a finite timeout (TIMEOUT_S):
a peer that never joins, or is gone, makes the start-up and every
collective raise after it, never wait without end.

A process's device is `cuda:(LOCAL_RANK % device_count)`: one rank a card
under `torchrun --nproc_per_node <cards>`, and every rank on `cuda:0` on a
one-card machine. Without a card and without `device="cpu"`,
`initialize` raises.
"""

from __future__ import annotations

import datetime
import hashlib
import os

import torch
import torch.distributed as dist

from c_game_engine_tpu_torch.core.state import tree_leaves, tree_map

BACKEND = "gloo"
TIMEOUT_S = 120.0
TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")

# this process's device while a group is up (set by initialize, cleared by
# shutdown): the group itself is process-global, as jax.distributed's is
_local: dict = {}


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device=None, timeout_s: float = TIMEOUT_S) -> torch.device:
    """Join the process group; returns this process's device.

    With no arguments the group is torchrun's (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK, LOCAL_RANK), as `jax.distributed.initialize()` reads
    a pod's. Otherwise process 0 serves the group at `coordinator_address`
    ("host:port") and the others connect to it. `device`: "cpu" puts this
    process on the CPU; None (the default) takes its card,
    cuda:(LOCAL_RANK % device_count), LOCAL_RANK defaulting to
    `process_id`. Raises if a group is up already, if there is no card and
    the CPU was not asked for, and if the other processes have not all
    joined within `timeout_s` seconds, which also bounds every collective
    after."""
    if dist.is_initialized():
        raise RuntimeError("initialize(): a process group is up already (call shutdown() first)")
    if coordinator_address is None:
        missing = [k for k in TORCHRUN_ENV if k not in os.environ]
        if missing:
            raise ValueError(f"initialize() without arguments reads torchrun's environment, and {missing} are not "
                             "set: launch with `python -m torch.distributed.run`, or pass coordinator_address, "
                             "num_processes and process_id")
        num_processes, process_id = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        init_method = "env://"
    else:
        if num_processes is None or process_id is None:
            raise ValueError("initialize(coordinator_address=...) needs num_processes and process_id")
        init_method = f"tcp://{coordinator_address}"
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} is not one of {num_processes} processes")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("initialize(): no CUDA device (pass device='cpu' for a group on the CPU)")
        local_rank = int(os.environ.get("LOCAL_RANK", process_id))
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(BACKEND, init_method=init_method, world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _local["device"] = torch.device(device)
    return _local["device"]


def shutdown() -> None:
    """Leave the process group (nothing without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _local.clear()


def process_count() -> int:
    """The number of processes in the group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank; 0 without a group."""
    return dist.get_rank() if dist.is_initialized() else 0


def local_device() -> torch.device:
    """The device `initialize` gave this process."""
    if "device" not in _local:
        raise RuntimeError("local_device(): no process group (call initialize() first)")
    return _local["device"]


def env_range(batch: int) -> range:
    """The envs this process owns of a global batch of `batch`: the
    process_index()-th of process_count() equal contiguous ranges."""
    n = process_count()
    if batch % n:
        raise ValueError(f"a global batch of {batch} envs does not divide over {n} processes")
    k = batch // n
    return range(process_index() * k, (process_index() + 1) * k)


def _digest(text: str) -> int:
    return int.from_bytes(hashlib.sha1(text.encode()).digest()[:7], "little")


def _all_equal(value: int, what: str) -> None:
    """Gather one integer from every process and raise unless all are
    `value` (a barrier too: it returns once every process has sent)."""
    mine = torch.tensor([value], dtype=torch.int64)
    got = [torch.empty_like(mine) for _ in range(process_count())]
    dist.all_gather(got, mine)
    if any(int(g) != value for g in got):
        raise RuntimeError(f"{what}: the processes disagree")


def process_allgather(tree, tiled: bool = True):
    """Every tensor leaf of `tree` (a tensor or a Struct tree of them)
    from every process, on the host: concatenated along axis 0 (the env
    axis) in rank order when `tiled`, else stacked on a new axis 0. In one
    process the leaves come back on the host unchanged. The leaves travel
    as one byte buffer a process; the processes must hold the same shapes
    and dtypes, else every one of them raises."""
    named = tree_leaves(tree)
    host = [t.detach().to("cpu").contiguous() for _, t in named]
    if tiled and any(t.dim() == 0 for t in host):
        raise ValueError("process_allgather(tiled=True): a 0-d leaf has no axis to concatenate along")
    n = process_count()
    if n == 1:
        parts = [[t] for t in host]
    else:
        sig = repr([(name, tuple(t.shape), t.dtype) for (name, _), t in zip(named, host)])
        _all_equal(_digest(sig), "process_allgather: leaf names, shapes and dtypes")
        flat = torch.cat([t.reshape(-1).view(torch.uint8) for t in host] or [torch.empty(0, dtype=torch.uint8)])
        bufs = [torch.empty_like(flat) for _ in range(n)]
        dist.all_gather(bufs, flat)
        parts, at = [], 0
        for t in host:
            nb = t.numel() * t.element_size()
            parts.append([b[at:at + nb].clone().view(t.dtype).reshape(t.shape) for b in bufs])
            at += nb
    joined = iter([torch.cat(p) if tiled else torch.stack(p) for p in parts])
    return tree_map(lambda _: next(joined), tree)


def sync_global_devices(name: str) -> None:
    """A barrier: returns once every process has called it with the same
    `name`; raises if one called it with another name."""
    if process_count() > 1:
        _all_equal(_digest(name), f"sync_global_devices({name!r})")


def broadcast_str(s: str | None) -> str:
    """Process 0's `s`, in every process (the others pass anything)."""
    if process_count() == 1:
        return s
    data = torch.tensor(list(s.encode()) if process_index() == 0 else [], dtype=torch.uint8)
    size = torch.tensor([data.numel()], dtype=torch.int64)
    dist.broadcast(size, 0)
    if process_index() != 0:
        data = torch.empty(int(size), dtype=torch.uint8)
    dist.broadcast(data, 0)
    return bytes(data.tolist()).decode()
