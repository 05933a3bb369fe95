"""The mmgrid CRF's splat and slice: CUDA kernels and their plain versions.

``splat`` replaces ``dsrg_tpu/ops/crf/pallas_mmgrid.py::splat_fused`` and
``slice`` replaces ``slice_fused``.  Their CUDA sources are
``csrc/mmgrid_splat.cu`` and ``csrc/mmgrid_slice.cu``; each source says what
bounds it on the H100 and what its design does about it.  Both are tiled
GEMMs (B = gc^2 grid rows, px pixels, Q = gc*C wide columns) with a fused
prologue (splat: build u = r-weights x values in shared memory) or epilogue
(slice: r-weighted sum), so the (T, px, Q) intermediates never reach device
memory.  The 0/1 ``tile_mat`` / ``expand`` / ``sum_mat`` operands of the
TPU kernels are index arithmetic here (q = r*C + c).

A wrapper runs the plain PyTorch version only for tensors on the CPU; a CUDA
tensor launches the kernel, and anything else raises.  ``splat.launches`` /
``slice.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from dsrg_tpu_torch import _build

_BF16 = torch.bfloat16
_F32 = torch.float32


def splat_plain(wbg: torch.Tensor, values: torch.Tensor, wr_t: torch.Tensor) -> torch.Tensor:
    """(T, px, B) bf16, (T, C, px) f32, (T, gc, px) bf16 -> (T, B, gc*C) f32.

    ``u[t, p, r*C+c] = bf16(bf16(values[t,c,p]) * wr_t[t,r,p])`` (the product
    of two bf16 numbers is exact in fp32), then ``wbg[t]^T @ u[t]`` in fp32.
    """
    t, c, px = values.shape
    gc = wr_t.shape[1]
    v = values.to(_BF16).to(_F32)
    u = (wr_t.to(_F32)[:, :, None, :] * v[:, None, :, :]).to(_BF16)  # (T, gc, C, px)
    u = u.reshape(t, gc * c, px).to(_F32)
    return torch.bmm(wbg.to(_F32).transpose(1, 2), u.transpose(1, 2))


def slice_plain(wbg: torch.Tensor, slab: torch.Tensor, wr_t: torch.Tensor) -> torch.Tensor:
    """(T, px, B) bf16, (T, B, gc*C) bf16, (T, gc, px) bf16 -> (T, C, px) f32.

    ``out[t, c, p] = sum_r wr_t[t,r,p] * (wbg[t] @ slab[t])[p, r*C+c]``, fp32.
    """
    t, px, _ = wbg.shape
    gc = wr_t.shape[1]
    tt = torch.bmm(wbg.to(_F32), slab.to(_F32))  # (T, px, Q)
    tt = tt.reshape(t, px, gc, -1) * wr_t.to(_F32).transpose(1, 2)[..., None]
    return tt.sum(2).transpose(1, 2).contiguous()


def _check(name: str, x: torch.Tensor, dtype, shape, device) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")


def padded_empty(shape, dtype, device) -> torch.Tensor:
    """An uninitialised tensor whose rows start 16 bytes apart: a view of
    the first ``shape[-1]`` columns of a buffer padded to a multiple of 8
    columns.  The kernels move such rows in 16-byte loads."""
    full = torch.empty((*shape[:-1], -(-shape[-1] // 8) * 8), dtype=dtype, device=device)
    return full[..., : shape[-1]]


def _rows16(x: torch.Tensor) -> torch.Tensor:
    """``x`` (T, R, K) bf16 in the kernels' row layout (row stride a multiple
    of 8 elements, 16-byte aligned start), copied only if it is not."""
    t, rows, _ = x.shape
    ld = x.stride(1)
    if (x.stride(2) == 1 and ld % 8 == 0 and ld >= x.shape[2] and x.stride(0) == rows * ld
            and x.data_ptr() % 16 == 0):
        return x
    out = padded_empty(x.shape, x.dtype, x.device)
    out.copy_(x)
    return out


def _dense16(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous with a 16-byte aligned start, copied only if needed."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(lib_name: str, out: torch.Tensor, args) -> None:
    """``args``: the kernel's arguments before the output, then after it,
    as (tensors and ints before, ints after)."""
    lib = _build.load(lib_name)
    fn = getattr(lib, lib_name)
    before, after = args
    fn.argtypes = ([ctypes.c_void_p if isinstance(a, torch.Tensor) else ctypes.c_int for a in before]
                   + [ctypes.c_void_p] + [ctypes.c_int] * len(after) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in before),
                out.data_ptr(), *after, stream)
    if rc != 0:
        raise RuntimeError(f"{lib_name} launch failed with CUDA error {rc}")


def _check_tiles(t: int) -> None:
    if t > 65535:  # one grid row of blocks per tile
        raise ValueError(f"{t} tiles in one launch; the kernels take at most 65535")


def _kernel_device(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"mmgrid kernels take CPU or CUDA tensors, got {x.device}")


def splat(wbg: torch.Tensor, values: torch.Tensor, wr_t: torch.Tensor) -> torch.Tensor:
    """Splat values into per-tile grid slabs; see :func:`splat_plain`."""
    t, px, nb = wbg.shape
    c = values.shape[1]
    gc = wr_t.shape[1]
    _check("wbg", wbg, _BF16, (t, px, nb), wbg.device)
    _check("values", values, _F32, (t, c, px), wbg.device)
    _check("wr_t", wr_t, _BF16, (t, gc, px), wbg.device)
    if not _kernel_device(wbg):
        return splat_plain(wbg, values, wr_t)
    _check_tiles(t)
    wbg = _rows16(wbg)
    out = torch.empty((t, nb, gc * c), dtype=_F32, device=wbg.device)
    _launch("mmgrid_splat", out, ((wbg, wbg.stride(1), _dense16(values), _dense16(wr_t)),
                                  (t, px, nb, c, gc)))
    splat.launches += 1
    return out


def slice(wbg: torch.Tensor, slab: torch.Tensor, wr_t: torch.Tensor) -> torch.Tensor:  # noqa: A001
    """Slice per-tile grid slabs back to pixels; see :func:`slice_plain`."""
    t, px, nb = wbg.shape
    gc = wr_t.shape[1]
    q = slab.shape[2]
    if q % gc:
        raise ValueError(f"slab width {q} is not a multiple of gc={gc}")
    c = q // gc
    _check("wbg", wbg, _BF16, (t, px, nb), wbg.device)
    _check("slab", slab, _BF16, (t, nb, q), wbg.device)
    _check("wr_t", wr_t, _BF16, (t, gc, px), wbg.device)
    if not _kernel_device(wbg):
        return slice_plain(wbg, slab, wr_t)
    _check_tiles(t)
    wbg, slab = _rows16(wbg), _rows16(slab)
    out = torch.empty((t, c, px), dtype=_F32, device=wbg.device)
    _launch("mmgrid_slice", out, ((wbg, wbg.stride(1), slab, slab.stride(1), _dense16(wr_t)),
                                  (t, px, nb, c, gc)))
    slice.launches += 1
    return out


splat.launches = 0
slice.launches = 0
KERNELS = ("mmgrid_splat", "mmgrid_slice")
