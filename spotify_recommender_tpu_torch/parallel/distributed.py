"""Multi-process bootstrap and the mesh over every process's devices.

The port of the JAX package's `parallel/distributed.py`.  The reference
has no distributed backend (its only data movement is cudaMemcpy inside
one process).  `initialize_multihost` joins the processes of a job into
one `torch.distributed` group, NCCL for CUDA devices and gloo for the
CPU, with the fail-fast diagnostic of the JAX package: a missing process
is a configuration error, reported at once, not retried.

Torch discovers no cluster by itself: the coordinator address
(``host:port`` of rank 0's store), the process count and this process's
rank come from the arguments, else from the JAX package's environment
variables JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID.
"""

from __future__ import annotations

import datetime
import os
import warnings
from typing import Optional, Sequence, Union

import numpy as np
import torch

from spotify_recommender_tpu_torch.core.device import resolve_device
from spotify_recommender_tpu_torch.core.logging import get_logger
from spotify_recommender_tpu_torch.core.mesh import Mesh

log = get_logger(__name__)

# the device kind the group was initialized for (its backend's)
_group_device: Optional[torch.device] = None


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    timeout_s: int = 120,
    device: Union[str, torch.device] = "cuda",
) -> None:
    """Join this process to the job's `torch.distributed` group
    (idempotent): NCCL where `device` is CUDA (raises without a card),
    gloo on the CPU.  Any failure, a missing coordinator address included,
    raises RuntimeError with the diagnostic; a process that waits longer
    than `timeout_s` for the others fails."""
    global _group_device
    import torch.distributed as dist

    device = resolve_device(device)
    if _group_device is not None or dist.is_initialized():
        _group_device = _group_device or device
        return
    try:
        address = (coordinator_address
                   or os.environ.get("JAX_COORDINATOR_ADDRESS"))
        if not address:
            raise ValueError("no coordinator address (pass "
                             "coordinator_address or set "
                             "JAX_COORDINATOR_ADDRESS)")
        world = int(num_processes or os.environ.get("JAX_NUM_PROCESSES", 1))
        rank = int(process_id if process_id is not None
                   else os.environ.get("JAX_PROCESS_ID", 0))
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=f"tcp://{address}", world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
    except Exception as e:
        raise RuntimeError(
            "multi-host initialization failed — check that every host in "
            "the slice is running, the coordinator address is reachable, "
            f"and process ids are unique. Underlying error: {e}"
        ) from e
    _group_device = device
    log.info("multi-host ready: process %d/%d (%s)", dist.get_rank(),
             dist.get_world_size(), dist.get_backend())


def local_devices() -> list:
    """This process's devices in the group: one card per process (the
    rank's, modulo the cards it sees) under NCCL, the CPU under gloo."""
    import torch.distributed as dist

    if _group_device is None or _group_device.type != "cuda":
        return [torch.device("cpu")]
    return [torch.device("cuda", dist.get_rank() % torch.cuda.device_count())]


def global_mesh(
    axis_names: Sequence[str] = ("data", "catalog"),
    axis_sizes: Optional[Sequence[int]] = None,
    devices_per_process: Optional[Sequence] = None,
) -> Mesh:
    """A mesh over the devices of every process of the group, rank-major.

    Default layout: all devices on "catalog" (the row-sharded catalog);
    pass axis_sizes to split, e.g. (num_hosts, devices_per_host), so the
    catalog axis stays inside a host and data parallelism crosses hosts.
    `devices_per_process` lists this process's devices (every process the
    same count; a device may repeat, as in core/mesh.make_mesh), by
    default `local_devices()`."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("global_mesh needs initialize_multihost first")
    world, rank = dist.get_world_size(), dist.get_rank()
    mine = [torch.device(d) for d in (devices_per_process or local_devices())]
    total = world * len(mine)
    if axis_sizes is None:
        axis_sizes = (1, total)
    if int(np.prod(axis_sizes)) != total:
        raise ValueError(
            f"axis_sizes {tuple(axis_sizes)} does not cover {total} devices"
        )
    grid = np.empty(total, dtype=object)
    # other processes' cells keep this process's device names: only the
    # owner of a cell ever uses its device
    grid[:] = mine * world
    return Mesh(
        devices=grid.reshape(tuple(axis_sizes)),
        axis_names=tuple(axis_names),
        process_ids=np.repeat(np.arange(world), len(mine)).reshape(
            tuple(axis_sizes)),
        process_index=rank,
    )


def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This process's rows of a mesh-wide tensor in, every process's out,
    concatenated along dim 0 in rank order (`all_gather_into_tensor`); the
    tensor itself where the mesh lives in one process."""
    if not mesh.spans_processes:
        return t
    import torch.distributed as dist

    full = t.new_empty((dist.get_world_size() * t.shape[0], *t.shape[1:]))
    with warnings.catch_warnings():   # renamed all_gather_single in 2.13
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(full, t.contiguous())
    return full


def all_reduce(t: torch.Tensor, mesh: Mesh, op: str = "SUM") -> torch.Tensor:
    """`t` reduced in place over the mesh's processes (itself in one
    process)."""
    if not mesh.spans_processes:
        return t
    import torch.distributed as dist

    dist.all_reduce(t, op=getattr(dist.ReduceOp, op))
    return t
