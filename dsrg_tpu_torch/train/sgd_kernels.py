"""The Caffe SGD update of every leaf in one CUDA kernel pair
(``csrc/caffe_sgd.cu``, which says what bounds it and how it is built).

:func:`caffe_sgd` is the card's path of :meth:`CaffeSGD.step
<dsrg_tpu_torch.train.optimizer.CaffeSGD.step>`: the 1 / n_valid scale,
the global gradient norm, the clip, weight decay, the per-leaf rates,
momentum and the apply, in ``sgd_sqnorm_kernel`` then ``sgd_apply_kernel``,
with no host sync and no copy of the leaf table to the device (it travels
as a kernel parameter).  The plain version is ``CaffeSGD``'s loop, which
CPU tensors take.  ``caffe_sgd.launches`` counts both kernels' launches.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from dsrg_tpu_torch import _build


class _Entry(NamedTuple):
    fn: Callable[..., int]
    max_leaves: int  # the leaves one update takes (the kernels' table)
    blocks_per_sm: int


@functools.lru_cache(maxsize=1)
def _entry() -> _Entry:
    lib = _build.load("caffe_sgd")
    fn = lib.caffe_sgd
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, p, i, p, p, p, i, f, f, p]
    fn.restype = ctypes.c_int
    max_leaves, blocks = ctypes.c_int(), ctypes.c_int()
    lib.caffe_sgd_limits(ctypes.byref(max_leaves), ctypes.byref(blocks))
    return _Entry(fn, max_leaves.value, blocks.value)


@functools.lru_cache(maxsize=None)
def _grid(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count * _entry().blocks_per_sm


def _check(grads: Sequence[torch.Tensor], params: Sequence[torch.Tensor], velocity: Sequence[torch.Tensor],
           device: torch.device) -> None:
    if not len(grads) == len(params) == len(velocity) > 0:
        raise ValueError(f"caffe_sgd needs as many gradients, parameters and velocities, and at least one: "
                         f"{len(grads)}, {len(params)}, {len(velocity)}")
    f32 = torch.float32
    for i, (g, w, v) in enumerate(zip(grads, params, velocity)):
        if not (g.dtype == w.dtype == v.dtype == f32):
            raise ValueError(f"caffe_sgd takes float32 leaves; leaf {i}: {g.dtype}, {w.dtype}, {v.dtype}")
        if not (g.device == w.device == v.device == device):
            raise ValueError(f"caffe_sgd takes leaves on {device}; leaf {i}: {g.device}, {w.device}, {v.device}")
        if not (g.shape == w.shape == v.shape):
            raise ValueError(f"leaf {i}: shapes {tuple(g.shape)}, {tuple(w.shape)}, {tuple(v.shape)} differ")
        if not (g.is_contiguous() and w.is_contiguous() and v.is_contiguous()):
            raise ValueError(f"caffe_sgd takes contiguous leaves; leaf {i} is not")


def caffe_sgd(grads: Sequence[torch.Tensor], params: Sequence[torch.Tensor], velocity: Sequence[torch.Tensor],
              inv: Optional[torch.Tensor], wd: Sequence[float], lr: Sequence[float], momentum: float,
              clip: float) -> torch.Tensor:
    """One Caffe SGD update of every leaf on the card, in place, in two
    launches on the current stream.

    ``grads`` / ``params`` / ``velocity``: the leaves in one order, float32,
    contiguous, on one CUDA device; ``inv``: a 0-d float32 on that device
    that scales every gradient first, or None; ``wd`` / ``lr``: each leaf's
    ``weight_decay * decay_mult`` and ``lr(step) * lr_mult`` as Python
    floats, rounded to float32 here once; ``clip`` > 0 scales the scaled
    gradients to at most that global norm.  Returns the 0-d global norm of
    ``grads * inv`` (before the clip).  Raises on anything else, and on more
    leaves than the kernels' table holds (512; ResNet-101 has 320).
    """
    device = params[0].device if params else None
    _check(grads, params, velocity, device)
    if device.type != "cuda":
        raise ValueError(f"caffe_sgd runs on a CUDA device, got {device}")
    if inv is not None and (inv.dtype != torch.float32 or inv.device != device or inv.numel() != 1):
        raise ValueError(f"inv must be one float32 on {device}, got {inv.dtype} {tuple(inv.shape)} on {inv.device}")
    leaves = len(params)
    if len(wd) != leaves or len(lr) != leaves:
        raise ValueError(f"wd and lr need {leaves} values each, got {len(wd)} and {len(lr)}")
    entry = _entry()
    if leaves > entry.max_leaves:
        raise ValueError(f"caffe_sgd takes at most {entry.max_leaves} leaves, got {leaves}")
    ptrs = np.fromiter((t.data_ptr() for t in itertools.chain(grads, params, velocity)), np.uint64, 3 * leaves)
    numel = np.fromiter((w.numel() for w in params), np.int64, leaves)
    coef = np.array([*wd, *lr], np.float32)
    grid = _grid(device.index)
    partials = torch.empty(grid, dtype=torch.float64, device=device)
    norm = torch.empty((), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = entry.fn(ptrs.ctypes.data, numel.ctypes.data, coef.ctypes.data, leaves,
                None if inv is None else inv.data_ptr(), partials.data_ptr(), norm.data_ptr(), grid,
                momentum, clip, stream)
    if rc != 0:
        raise RuntimeError(f"caffe_sgd launch failed with CUDA error {rc}")
    caffe_sgd.launches += 2
    return norm


caffe_sgd.launches = 0
