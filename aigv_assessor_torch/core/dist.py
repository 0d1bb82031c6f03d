"""Multi-process start-up (`aigv_assessor_tpu/core/dist.py`) on
`torch.distributed`, one process per card.

`init_dist` reads what the launcher set: torchrun's `RANK`, `WORLD_SIZE`,
`LOCAL_RANK` and `MASTER_ADDR` / `MASTER_PORT`, or JAX's
`JAX_COORDINATOR_ADDRESS` (host:port), `JAX_NUM_PROCESSES` and
`JAX_PROCESS_ID`, so that a JAX launch line means the same here; its
arguments win over both. As in JAX, a run with no coordinator and at most
one process is a single-process run: no process group is built and nothing
is wrapped. A coordinator (torchrun always sets one) builds the group even
for one process. The backend is NCCL on `--device cuda`, after
`torch.cuda.set_device(LOCAL_RANK)`, and gloo on the CPU.

    python -m torch.distributed.run --nproc_per_node 2 \
        -m aigv_assessor_torch.cli.stage2_train ... --mesh_fsdp 2

`is_primary`, `process_index` and `process_count` are 0-based rank and
world size, 0 / 1 without a group. `all_reduce_sum_`, `all_ranks_true`,
`broadcast_object` and `barrier` do nothing without a group.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Any, Mapping, Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

_INITIALIZED = False


@dataclass(frozen=True)
class DistEnv:
    """Where the group meets and who this process is in it."""

    address: str  # host:port
    world: int
    rank: int
    local_rank: Optional[int]


def dist_env(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    environ: Optional[Mapping[str, str]] = None,
) -> Optional[DistEnv]:
    """The group this process joins, or None for a single-process run (no
    coordinator and at most one process)."""
    env = os.environ if environ is None else environ
    if coordinator_address is None:
        coordinator_address = env.get("JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    for key in ("JAX_NUM_PROCESSES", "WORLD_SIZE"):
        if num_processes is None and env.get(key) is not None:
            num_processes = int(env[key])
    for key in ("JAX_PROCESS_ID", "RANK"):
        if process_id is None and env.get(key) is not None:
            process_id = int(env[key])
    if coordinator_address is None and num_processes in (None, 1):
        return None
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-process run needs a coordinator address, a process count and a process "
            f"id; got {coordinator_address!r}, {num_processes!r}, {process_id!r}")
    local = env.get("LOCAL_RANK")
    return DistEnv(coordinator_address, num_processes, process_id,
                   int(local) if local is not None else None)


def init_dist(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: str = "cuda",
) -> None:
    """Join the process group the launcher describes; a no-op for a
    single-process run, when a group exists already, and on a second call."""
    global _INITIALIZED
    if _INITIALIZED or dist.is_initialized():
        _INITIALIZED = True
        return
    env = dist_env(coordinator_address, num_processes, process_id)
    if env is None:
        logger.info("single-process run; no process group")
        _INITIALIZED = True
        return
    backend = "gloo"
    if torch.device(device).type == "cuda":
        local = env.local_rank
        if local is None:  # a JAX launch line: one process per card of a host
            local = env.rank % max(torch.cuda.device_count(), 1)
        torch.cuda.set_device(local)
        backend = "nccl"
    dist.init_process_group(backend, init_method=f"tcp://{env.address}",
                            world_size=env.world, rank=env.rank)
    _INITIALIZED = True
    logger.info("torch.distributed initialized: process %d/%d over %s",
                env.rank, env.world, backend)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    return process_index() == 0


def all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """`t` summed over the group's ranks, in place."""
    if dist.is_initialized():
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_ranks_true(flag: torch.Tensor) -> bool:
    """True when `flag` (a bool scalar on this rank's device) holds on every
    rank: the one decision that keeps the ranks' collectives in step."""
    t = flag.to(torch.int32).reshape(1)
    if dist.is_initialized():
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """The primary's `obj` on every rank."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()
