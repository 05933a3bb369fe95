"""Device mesh and data-parallel step wrapping (``dsrg_tpu/parallel/mesh.py``).

The JAX package shards the batch over a 1-axis ``Mesh`` inside a
``shard_map``-wrapped step and reduces with ``psum``.  The port runs one
process per device, as NCCL requires (two ranks of one communicator may not
share a card; on the CPU the backend is gloo): a :class:`Mesh` is this
process's devices plus the process group that joins the ranks
(``parallel/distributed.py``).  A train step built with ``axis_name=mesh``
adds its gradients and metric sums over the group with one
:func:`all_reduce_sum` before it divides by the global valid count, as
JAX's ``psum``; per-image work (CRF, growing, inference) stays local.

JAX's ``batch_sharding`` and ``replicated_sharding`` have no counterpart:
a torch tensor lives on one device and carries no sharding.  Their callers
only place rows and replicated state, which :func:`shard_batch`,
:func:`shard_global_batch` and :func:`replicate_to_mesh` do.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from dsrg_tpu_torch._device import resolve_device

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-axis data mesh: ``devices`` are this process's, in mesh order;
    ``group`` is the ranks' process group (None in a process without one)."""

    devices: tuple
    axis: str = DATA_AXIS
    group: Optional[object] = None
    rank: int = 0
    world_size: int = 1

    @property
    def size(self) -> int:
        """Devices on the whole mesh (JAX's ``mesh.size``)."""
        return len(self.devices) * self.world_size

    @property
    def device(self) -> torch.device:
        """This rank's device: a train step runs one process per device."""
        if len(self.devices) != 1:
            raise ValueError(f"a data-parallel step runs one process per device, this mesh has "
                             f"{len(self.devices)} in one process: launch one process per device "
                             "(tools/train.py --num-processes)")
        return self.devices[0]


def _rank_device() -> torch.device:
    """The device ``distributed.initialize`` gave this rank."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(devices: Optional[Sequence] = None, axis: str = DATA_AXIS) -> Mesh:
    """In a process group: this rank's device (or ``devices``) and the
    world group.  Otherwise ``devices`` (names or ``torch.device``s; a
    device may repeat, as the CPU does in tests), by default every card of
    the host; raises where there is none."""
    if dist.is_available() and dist.is_initialized():
        devs = [_rank_device()] if devices is None else [torch.device(d) for d in devices]
        return Mesh(tuple(devs), axis, dist.group.WORLD, dist.get_rank(), dist.get_world_size())
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return Mesh(tuple(resolve_device(d) for d in devices), axis)


def pad_batch_to_multiple(batch: dict, multiple: int) -> dict:
    """Pad the leading (batch) dim to a multiple; append a {1,0} ``pad_mask``.

    Makes uneven global batches — the reference's stage-1 batch 20 and
    stage-2 batch 10 (train-s.prototxt:17-19, train-f.prototxt:11) — shard
    over any number of ranks.  Pad rows replicate the last real sample
    (realistic values keep the CRF/grow numerics healthy); the mask removes
    their contribution from losses, gradients, and metrics exactly (the
    train steps reduce with weighted sums and summed valid counts), so the
    padded step reproduces the unpadded numbers.
    """
    b = int(np.shape(next(iter(batch.values())))[0])
    pad = (-b) % multiple
    out = dict(batch)
    if "pad_mask" not in out:
        out["pad_mask"] = np.ones((b,), np.float32)
    if pad == 0:
        return out
    padded = {}
    for k, v in out.items():
        v = np.asarray(v)
        tail = (
            np.zeros((pad,), v.dtype)
            if k == "pad_mask"
            else np.repeat(v[-1:], pad, axis=0)
        )
        padded[k] = np.concatenate([v, tail], axis=0)
    return padded


def pad_batch_to_rows(batch: dict, rows: int, n_valid: Optional[int] = None) -> dict:
    """Pad the leading dim to EXACTLY ``rows``; mark the first ``n_valid``
    rows valid in ``pad_mask`` and everything after them padding.

    The process-level analogue of :func:`pad_batch_to_multiple`: each
    process contributes exactly ``global_padded_batch / num_processes``
    rows, and with an uneven global batch (the reference's batch 20 over
    e.g. 8 processes) later processes carry fewer real samples — possibly
    zero, in which case every row is a masked replica of the one realistic
    sample the loader drew.
    """
    b = int(np.shape(next(iter(batch.values())))[0])
    if not 0 < b <= rows:
        raise ValueError(f"a batch of {b} rows cannot pad to {rows}")
    n_valid = b if n_valid is None else min(n_valid, b)
    mask = np.zeros((rows,), np.float32)
    mask[:n_valid] = 1.0
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        if rows > b:
            v = np.concatenate([v, np.repeat(v[-1:], rows - b, axis=0)], axis=0)
        out[k] = v
    out["pad_mask"] = mask
    return out


def _to(v, device: torch.device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.from_numpy(np.ascontiguousarray(v)).to(device)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's contiguous rows of a global batch that every rank holds,
    on its device.  The rows must split evenly (pad first)."""
    out = {}
    for k, v in batch.items():
        b = int(np.shape(v)[0])
        if b % mesh.world_size:
            raise ValueError(f"{k}: {b} rows do not split over {mesh.world_size} ranks; pad the batch "
                             "(pad_batch_to_multiple)")
        per = b // mesh.world_size
        out[k] = _to(v[mesh.rank * per:(mesh.rank + 1) * per], mesh.device)
    return out


def shard_global_batch(local_batch: dict, mesh: Mesh) -> dict:
    """This process's rows of the global batch (what its loader read, see
    ``distributed.local_batch_slice``), on its device: JAX's
    ``make_array_from_process_local_data``."""
    return {k: _to(v, mesh.device) for k, v in local_batch.items()}


def all_reduce_sum(tensors: Sequence[torch.Tensor], mesh: Mesh) -> list:
    """JAX's ``psum`` over the mesh: the tensors summed over the ranks with
    one coalesced ``all_reduce`` (one fp32 buffer), each returned in its
    shape and dtype.  Without a group the tensors come back as they are."""
    if mesh.group is None:
        return list(tensors)
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out


def replicate_to_mesh(state, mesh: Mesh):
    """Place a (restored) ``TrainState`` on this rank's device and make
    every rank hold rank 0's copy: parameters and buffers, velocities, step
    and random stream are broadcast from rank 0.  A snapshot written at any
    world size thus resumes at any other (JAX's topology-portable restore).
    Returns ``state``, changed in place; a generator that lives on another
    device is replaced by one on this rank's device with its state."""
    dev = mesh.device
    state.model.to(dev)
    opt = state.optimizer
    opt.velocity = {k: v.to(dev) for k, v in opt.velocity.items()}
    if state.generator.device != dev:
        if state.generator.device.type != dev.type:
            raise ValueError(f"a {state.generator.device.type} random stream cannot move to {dev}")
        moved = torch.Generator(device=dev)
        moved.set_state(state.generator.get_state())
        state.generator = moved
    if mesh.group is not None:
        for t in [*state.model.state_dict().values(), *opt.velocity.values()]:
            dist.broadcast(t, src=0, group=mesh.group)
        gen = state.generator.get_state().to(dev)
        step = torch.tensor([opt.step_count], dtype=torch.int64, device=dev)
        dist.broadcast(gen, src=0, group=mesh.group)
        dist.broadcast(step, src=0, group=mesh.group)
        state.generator.set_state(gen.cpu())
        opt.step_count = int(step.item())
    return state


def data_parallel_step(step_fn, mesh: Mesh):
    """Wrap a ``step(batch) -> metrics`` built with ``axis_name=mesh``: the
    wrapper takes this process's rows (:func:`shard_batch` of a global
    batch, or a loader's local batch), places them on its device and runs
    the step, whose metrics are then the same on every rank.  Raises when
    the step was built for no mesh or another one: such a step would train
    each rank on its own rows."""
    if getattr(step_fn, "axis_name", None) is not mesh:
        raise ValueError("data_parallel_step needs a step built with axis_name=mesh")
    mesh.device  # raises now, not at the first step, unless one device per process

    def step(batch: dict) -> dict:
        return step_fn(shard_global_batch(batch, mesh))

    return step
