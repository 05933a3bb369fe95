"""Caffe-semantics pooling on NCHW and NHWC tensors.

Caffe sizes a pooled axis as ``ceil((H + 2*pad - k) / stride) + 1`` and drops
the last window when it would start at or beyond ``H + pad``.  MAX pooling
ignores the pad (-inf); AVE pooling sums real pixels and divides by the
window's intersection with the padded extent ``[-pad, H + pad)``.
``F.max_pool2d(..., padding=pad, ceil_mode=True)`` sizes an axis the same
way, last-window drop included, and reads only real pixels, so the MAX
pools pad implicitly.  ATen applies the drop at pad 0 too, where Caffe does
not: the two differ only for a window smaller than its stride (k < s) at
pad 0, and there, or where ATen refuses a pad above k / 2, the geometry is
padded explicitly with -inf and the library pool runs unpadded.

:func:`caffe_max_pool_train` is the differentiable MAX pool of the train
step, the counterpart of ``_max_pool_sep_pallas``
(``dsrg_tpu/ops/pooling.py:239-263``): a W pass then an H pass, whose
backward routes every window's cotangent to its first maximum in scan order
on the ``pool_bwd_h`` / ``pool_bwd_w`` kernels (``ops/pool_kernels.py``).
Both passes and their backward keep the input's dtype (float32 or
bfloat16): a bfloat16 cotangent runs the kernels' bfloat16 versions.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from dsrg_tpu_torch.ops.pool_kernels import pool_bwd_h, pool_bwd_w
from dsrg_tpu_torch.utils.profiling import span


def _caffe_pool_geometry(size: int, k: int, s: int, p: int):
    out = int(np.ceil((size + 2 * p - k) / s)) + 1
    if p > 0 and (out - 1) * s >= size + p:
        out -= 1
    pad_high = max((out - 1) * s + k - p - size, 0)
    return out, (p, pad_high)


def _pad_hw(x_nchw: torch.Tensor, ph, pw, value: float) -> torch.Tensor:
    return F.pad(x_nchw, (pw[0], pw[1], ph[0], ph[1]), value=value)


def _implicit_pad(k: int, s: int, p: int) -> bool:
    """True where ATen's ceil-mode geometry is Caffe's (module docstring)."""
    return (p > 0 or k >= s) and 2 * p <= k


def caffe_max_pool_nchw(x: torch.Tensor, k: int = 3, stride: int = 2,
                        pad: int = 1) -> torch.Tensor:
    """(B, C, H, W) Caffe MAX pool."""
    if _implicit_pad(k, stride, pad):
        return F.max_pool2d(x, k, stride, pad, ceil_mode=True)
    oh, ph = _caffe_pool_geometry(x.shape[2], k, stride, pad)
    ow, pw = _caffe_pool_geometry(x.shape[3], k, stride, pad)
    y = F.max_pool2d(_pad_hw(x, ph, pw, float("-inf")), k, stride)
    return y[:, :, :oh, :ow]


def _max_pool_pass(x: torch.Tensor, axis: int, k: int, s: int, p: int) -> torch.Tensor:
    """One 1-D Caffe MAX pool pass of NCHW ``x`` along ``axis`` (2 or 3)."""
    kernel, stride = ((k, 1), (s, 1)) if axis == 2 else ((1, k), (1, s))
    if _implicit_pad(k, s, p):
        return F.max_pool2d(x, kernel, stride, (p, 0) if axis == 2 else (0, p), ceil_mode=True)
    out, pads = _caffe_pool_geometry(x.shape[axis], k, s, p)
    xp = _pad_hw(x, pads, (0, 0), float("-inf")) if axis == 2 else _pad_hw(x, (0, 0), pads, float("-inf"))
    return F.max_pool2d(xp, kernel, stride).narrow(axis, 0, out)


class _CaffeMaxPool(torch.autograd.Function):
    """Separable Caffe MAX pool with first-max routed backward (NCHW)."""

    @staticmethod
    def forward(ctx, x, k: int, s: int, p: int):
        yw = _max_pool_pass(x, 3, k, s, p)
        y = _max_pool_pass(yw, 2, k, s, p)
        ctx.save_for_backward(x, yw)
        ctx.geom = (k, s, p)
        return y

    @staticmethod
    @span("dsrg.pool_bwd")
    def backward(ctx, g):
        x, yw = ctx.saved_tensors
        k, s, p = ctx.geom
        gw = pool_bwd_h(yw.contiguous(), g.contiguous(), k, s, p)
        return pool_bwd_w(x.contiguous(), gw, k, s, p), None, None, None


def caffe_max_pool_train(x: torch.Tensor, k: int = 3, stride: int = 2,
                         pad: int = 1) -> torch.Tensor:
    """(B, C, H, W) Caffe MAX pool with the kernels' routed backward; the
    same values as :func:`caffe_max_pool_nchw`."""
    return _CaffeMaxPool.apply(x, k, stride, pad)


def _caffe_avg_divisor(size: int, out: int, k: int, s: int, p: int) -> np.ndarray:
    starts = np.arange(out) * s - p
    ends = np.minimum(starts + k, size + p)
    return (ends - starts).astype(np.float32)


def caffe_avg_pool_nchw(x: torch.Tensor, k: int = 3, stride: int = 1,
                        pad: int = 1) -> torch.Tensor:
    """(B, C, H, W) Caffe AVE pool with the clipped-window divisor map."""
    h, w = x.shape[2], x.shape[3]
    oh, ph = _caffe_pool_geometry(h, k, stride, pad)
    ow, pw = _caffe_pool_geometry(w, k, stride, pad)
    summed = F.avg_pool2d(_pad_hw(x, ph, pw, 0.0), k, stride,
                          divisor_override=1)[:, :, :oh, :ow]
    div = np.outer(_caffe_avg_divisor(h, oh, k, stride, pad),
                   _caffe_avg_divisor(w, ow, k, stride, pad))
    return summed / torch.as_tensor(div, dtype=x.dtype, device=x.device)


def caffe_max_pool(x: torch.Tensor, k: int = 3, stride: int = 2,
                   pad: int = 1) -> torch.Tensor:
    """(B, H, W, C) Caffe MAX pool, the JAX package's layout."""
    return caffe_max_pool_nchw(x.permute(0, 3, 1, 2), k, stride, pad).permute(0, 2, 3, 1)


def caffe_avg_pool(x: torch.Tensor, k: int = 3, stride: int = 1,
                   pad: int = 1) -> torch.Tensor:
    """(B, H, W, C) Caffe AVE pool, the JAX package's layout."""
    return caffe_avg_pool_nchw(x.permute(0, 3, 1, 2), k, stride, pad).permute(0, 2, 3, 1)
