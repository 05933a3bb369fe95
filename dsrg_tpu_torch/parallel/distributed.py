"""Multi-process initialization (``dsrg_tpu/parallel/distributed.py``).

The reference is single-process, single-GPU (``SURVEY.md`` §2.4).  The port
runs data parallelism as one process per device: call :func:`initialize`
once per process, before any collective, with the same coordinator and
process count on every rank and a distinct ``process_id``.  On the card the
ranks talk over NCCL (NVLink between the cards of one host, the network
across hosts; NCCL chooses); with ``device="cpu"`` over gloo.  Nothing on a
host tells a process of its cluster: the caller passes all three values.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from dsrg_tpu_torch._device import resolve_device
from dsrg_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, make_mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> None:
    """:func:`init_group`, or nothing for a single process (as JAX's
    ``initialize`` does nothing then)."""
    if num_processes is None or num_processes <= 1:
        return
    init_group(coordinator_address, num_processes, process_id, device)


def init_group(coordinator_address: Optional[str], num_processes: int, process_id: Optional[int],
               device=None) -> None:
    """``torch.distributed.init_process_group`` at ``tcp://<coordinator>``
    (``host:port``, rank 0's address), at any world size.  ``device``: the
    card by default (backend NCCL, rank ``r`` on ``cuda:r % cards``), or
    ``"cpu"`` (gloo).  Raises where NCCL is asked for and missing: the card
    never falls back to gloo."""
    if not coordinator_address or process_id is None:
        raise ValueError("a process group needs the coordinator's host:port and this process's id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is outside 0..{num_processes - 1}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("this PyTorch has no NCCL: data parallelism on the card needs it")
        torch.cuda.set_device(process_id % torch.cuda.device_count())
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def make_global_mesh(axis: str = DATA_AXIS) -> Mesh:
    """The mesh over every rank of the job, in rank order (in a process
    without a group: every card of the host)."""
    return make_mesh(axis=axis)


def local_batch_slice(global_batch: int) -> slice:
    """This process's shard of a global batch (per-process loaders)."""
    n_proc = dist.get_world_size() if dist.is_initialized() else 1
    if global_batch % n_proc:
        raise ValueError(f"a global batch of {global_batch} does not split over {n_proc} processes")
    per = global_batch // n_proc
    i = dist.get_rank() if dist.is_initialized() else 0
    return slice(i * per, (i + 1) * per)
