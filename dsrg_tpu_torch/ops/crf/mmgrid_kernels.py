"""The mmgrid CRF's splat and slice: CUDA kernels and their plain versions.

``splat`` replaces ``dsrg_tpu/ops/crf/pallas_mmgrid.py::splat_fused`` and
``slice`` replaces ``slice_fused``.  The TPU kernels are per-tile GEMMs
against a dense (px, gc^2) interpolation matrix ``wbg`` and a dense
(gc, px) r-weight matrix ``wr_t`` that are almost all zeros: a row of
``wbg`` has 4 non-zeros (the bilinear corners of the pixel's (b, g) colour)
and a column of ``wr_t`` has 2 (its r bins).  Here the operands come in
that sparse form, per tile and pixel, pixel dimension minor:

* ``idx`` (T, px) int32: ``lo_b*gc + lo_g`` in the low 16 bits (the four
  ``wbg`` columns are that, +1, +gc, +gc+1) and ``lo_r`` in the high 16;
* ``wbg4`` (T, 4, px) bf16: the four corner weights, in that column order;
* ``wr2`` (T, 2, px) bf16: the weights of r bins ``lo_r`` and ``lo_r + 1``;
* ``perm`` (T, px) int32, for the splat only: each tile's pixels ordered by
  index word (:func:`sort_pixels`), so that pixels with the same 8 cells
  follow each other.

and the kernels are a scatter (``csrc/mmgrid_splat.cu``) and a gather
(``csrc/mmgrid_slice.cu``) that multiply only the non-zeros; each source
says what bounds it on the H100 and what its design does about it.  The
function is unchanged: every weight is the bf16 number the dense operand
holds, and :func:`dense_operands` turns the sparse form back into the dense
operands for the plain versions.

Both are ``torch.library`` custom ops, ``dsrg_tpu_torch::mmgrid_splat`` and
``dsrg_tpu_torch::mmgrid_slice``, so that ``torch.export`` traces them into
a served program (``serving.py``): the CUDA kernel of an op launches the
CUDA kernel, its CPU kernel runs the plain PyTorch version, and its fake
implementation gives the output's shape and dtype.  The wrappers
:func:`splat` / :func:`slice` check dtypes and shapes and call the ops; a
tensor on another device than the CPU or a card raises.
``splat.launches`` / ``slice.launches`` count kernel launches (the ops'
CUDA kernels count them, in an exported program too),
``dense_operands.calls`` the densifications (none on the card's main path).
"""

from __future__ import annotations

import torch

from dsrg_tpu_torch._build import launch
from dsrg_tpu_torch._device import kernel_device

_BF16 = torch.bfloat16
_F32 = torch.float32
_I32 = torch.int32
GC_MAX = 255  # lo_b*gc + lo_g must fit the low 16 bits of an index word
PX_MAX = 0xFFFF  # the splat kernel keeps a position in a tile in 16 bits


def splat_staged(px: int, c: int) -> bool:
    """Whether the splat kernel stages a tile's (px, C) values in shared
    memory beside its other arrays, or reads them from device memory (the
    unstaged template): ``smem_bytes`` against ``SMEM_MAX`` of
    ``csrc/mmgrid_splat.cu``.  A 1600-pixel tile stages at C = 21 and not
    at COCO's C = 81."""
    smem = px * 16 + 16 * 8 * c * 4 + (px + 1) * 4 + (px + (px & 1)) * 2 + px * (c | 1) * 2
    return smem <= 227 * 1024 - 64


def pack_index(lo_b: torch.Tensor, lo_g: torch.Tensor, lo_r: torch.Tensor, gc: int) -> torch.Tensor:
    """The kernels' index word of integer bins ``lo_*`` in [0, gc - 2]."""
    if not 2 <= gc <= GC_MAX:
        raise ValueError(f"gc={gc}: the index word takes 2 <= gc <= {GC_MAX}")
    return ((lo_b * gc + lo_g) | (lo_r << 16)).to(_I32)


def sort_pixels(idx: torch.Tensor) -> torch.Tensor:
    """``perm`` (T, px) int32: each tile's pixels in ascending order of index
    word, pixels of one word in ascending order (a stable sort)."""
    return torch.sort(idx, dim=1, stable=True).indices.to(_I32)


def dense_operands(idx: torch.Tensor, wbg4: torch.Tensor, wr2: torch.Tensor, gc: int):
    """The sparse form as the TPU kernels' dense operands: ``wbg``
    (T, px, gc^2) bf16 and ``wr_t`` (T, gc, px) bf16, zeros elsewhere."""
    dense_operands.calls += 1
    t, px = idx.shape
    idx = idx.to(torch.int64)
    corner = (idx & 0xFFFF)[:, :, None] + torch.tensor([0, 1, gc, gc + 1], device=idx.device)
    wbg = torch.zeros((t, px, gc * gc), dtype=_BF16, device=idx.device)
    wbg.scatter_(2, corner, wbg4.transpose(1, 2))
    lo_r = (idx >> 16)[:, None, :]
    wr_t = torch.zeros((t, gc, px), dtype=_BF16, device=idx.device)
    wr_t.scatter_(1, torch.cat([lo_r, lo_r + 1], 1), wr2)
    return wbg, wr_t


def splat_plain(idx: torch.Tensor, wbg4: torch.Tensor, wr2: torch.Tensor, values: torch.Tensor,
                gc: int) -> torch.Tensor:
    """Sparse weights and (T, C, px) f32 values -> (T, gc^2, gc*C) f32.

    ``u[t, p, r*C+c] = bf16(bf16(values[t,c,p]) * wr_t[t,r,p])`` (the product
    of two bf16 numbers is exact in fp32), then ``wbg[t]^T @ u[t]`` in fp32,
    on the dense operands.
    """
    wbg, wr_t = dense_operands(idx, wbg4, wr2, gc)
    t, c, px = values.shape
    v = values.to(_BF16).to(_F32)
    u = (wr_t.to(_F32)[:, :, None, :] * v[:, None, :, :]).to(_BF16)  # (T, gc, C, px)
    u = u.reshape(t, gc * c, px).to(_F32)
    return torch.bmm(wbg.to(_F32).transpose(1, 2), u.transpose(1, 2))


def slice_plain(idx: torch.Tensor, wbg4: torch.Tensor, wr2: torch.Tensor, slab: torch.Tensor,
                gc: int) -> torch.Tensor:
    """Sparse weights and a (T, gc^2, gc*C) bf16 slab -> (T, C, px) f32.

    ``out[t, c, p] = sum_r wr_t[t,r,p] * (wbg[t] @ slab[t])[p, r*C+c]``, fp32,
    on the dense operands.
    """
    wbg, wr_t = dense_operands(idx, wbg4, wr2, gc)
    t, px, _ = wbg.shape
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


def _check_sparse(idx: torch.Tensor, wbg4: torch.Tensor, wr2: torch.Tensor, gc: int) -> None:
    if idx.dim() != 2:
        raise ValueError(f"idx: expected (T, px), got {tuple(idx.shape)}")
    if not 2 <= gc <= GC_MAX:
        raise ValueError(f"gc={gc}: the index word takes 2 <= gc <= {GC_MAX}")
    t, px = idx.shape
    _check("idx", idx, _I32, (t, px), idx.device)
    _check("wbg4", wbg4, _BF16, (t, 4, px), idx.device)
    _check("wr2", wr2, _BF16, (t, 2, px), idx.device)


def _check_bins(idx: torch.Tensor, gc: int) -> None:
    """The bins' range, read from the data: only the ops' CPU kernels check
    it (on the card reading it would cost a synchronisation, and a traced
    program cannot read data), and the card's kernels leave a pixel with a
    bin out of range out."""
    if idx.numel():
        lo = torch.stack([(idx & 0xFFFF) // gc, (idx & 0xFFFF) % gc, idx >> 16])
        if int(lo.min()) < 0 or int(lo.max()) > gc - 2:
            raise ValueError(f"idx: a bin lies outside [0, {gc - 2}]")


@torch.library.custom_op("dsrg_tpu_torch::mmgrid_splat", mutates_args=(), device_types="cpu")
def _splat_op(idx: torch.Tensor, perm: torch.Tensor, wbg4: torch.Tensor, wr2: torch.Tensor,
              values: torch.Tensor, gc: int) -> torch.Tensor:
    """CPU kernel: the plain version (``perm`` is only the card's)."""
    _check_bins(idx, gc)
    return splat_plain(idx, wbg4, wr2, values, gc)


@_splat_op.register_kernel("cuda")
def _(idx, perm, wbg4, wr2, values, gc):
    t, px = idx.shape
    c = values.shape[1]
    out = torch.empty((t, gc * gc, gc * c), dtype=_F32, device=idx.device)
    launch("mmgrid_splat", out, ((idx.contiguous(), perm.contiguous(), wbg4.contiguous(),
                                  wr2.contiguous(), values.contiguous()), (t, px, gc, c)))
    splat.launches += 1
    return out


@_splat_op.register_fake
def _(idx, perm, wbg4, wr2, values, gc):
    return idx.new_empty((idx.shape[0], gc * gc, gc * values.shape[1]), dtype=_F32)


@torch.library.custom_op("dsrg_tpu_torch::mmgrid_slice", mutates_args=(), device_types="cpu")
def _slice_op(idx: torch.Tensor, wbg4: torch.Tensor, wr2: torch.Tensor, slab: torch.Tensor,
              gc: int) -> torch.Tensor:
    """CPU kernel: the plain version."""
    _check_bins(idx, gc)
    return slice_plain(idx, wbg4, wr2, slab, gc)


@_slice_op.register_kernel("cuda")
def _(idx, wbg4, wr2, slab, gc):
    t, px = idx.shape
    c = slab.shape[2] // gc
    out = torch.empty((t, c, px), dtype=_F32, device=idx.device)
    launch("mmgrid_slice", out, ((idx.contiguous(), wbg4.contiguous(), wr2.contiguous(),
                                  slab.contiguous()), (t, px, gc, c)))
    slice.launches += 1
    return out


@_slice_op.register_fake
def _(idx, wbg4, wr2, slab, gc):
    return idx.new_empty((idx.shape[0], slab.shape[2] // gc, idx.shape[1]), dtype=_F32)


def splat(idx: torch.Tensor, wbg4: torch.Tensor, wr2: torch.Tensor, values: torch.Tensor,
          gc: int, perm: torch.Tensor | None = None) -> torch.Tensor:
    """Splat values into per-tile grid slabs; see :func:`splat_plain`.

    ``perm`` is :func:`sort_pixels` of ``idx``, which a plan computes once
    for all its launches; left out, it is computed here.  Only the kernel
    reads it, and it trusts it: another order of the pixels gives a wrong
    slab.  A bin outside [0, gc - 2] raises on the CPU; the card, where
    reading the range would cost a synchronisation, leaves such a pixel out.
    """
    _check_sparse(idx, wbg4, wr2, gc)
    t, px = idx.shape
    if perm is None:
        perm = sort_pixels(idx)
    _check("perm", perm, _I32, (t, px), idx.device)
    if px > PX_MAX:
        raise ValueError(f"{px} pixels in a tile; the splat takes at most {PX_MAX}")
    if values.dim() != 3:
        raise ValueError(f"values: expected (T, C, px), got {tuple(values.shape)}")
    c = values.shape[1]
    _check("values", values, _F32, (t, c, px), idx.device)
    kernel_device(idx, "mmgrid kernels")  # raises off the CPU and the card
    return _splat_op(idx, perm, wbg4, wr2, values, gc)


def slice(idx: torch.Tensor, wbg4: torch.Tensor, wr2: torch.Tensor, slab: torch.Tensor,  # noqa: A001
          gc: int) -> torch.Tensor:
    """Slice per-tile grid slabs back to pixels; see :func:`slice_plain`.
    A bin outside [0, gc - 2] raises on the CPU; on the card such a pixel's
    output is zero (reading the range there would cost a synchronisation)."""
    _check_sparse(idx, wbg4, wr2, gc)
    t = idx.shape[0]
    if slab.dim() != 3:
        raise ValueError(f"slab: expected (T, gc^2, gc*C), got {tuple(slab.shape)}")
    q = slab.shape[2]
    if q % gc:
        raise ValueError(f"slab width {q} is not a multiple of gc={gc}")
    _check("slab", slab, _BF16, (t, gc * gc, q), idx.device)
    kernel_device(idx, "mmgrid kernels")  # raises off the CPU and the card
    return _slice_op(idx, wbg4, wr2, slab, gc)


splat.launches = 0
slice.launches = 0
dense_operands.calls = 0
KERNELS = ("mmgrid_splat", "mmgrid_slice")
