"""Caffe-semantics pooling on NHWC tensors (forward only).

Caffe sizes a pooled axis as ``ceil((H + 2*pad - k) / stride) + 1`` and drops
the last window when it would start beyond ``H + pad``.  MAX pooling ignores
the pad (-inf); AVE pooling sums real pixels and divides by the window's
intersection with the padded extent ``[-pad, H + pad)``.  ``ceil_mode`` of
``F.max_pool2d`` has no last-window clip, so the geometry is padded
explicitly and the library pool runs unpadded.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _caffe_pool_geometry(size: int, k: int, s: int, p: int):
    out = int(np.ceil((size + 2 * p - k) / s)) + 1
    if p > 0 and (out - 1) * s >= size + p:
        out -= 1
    pad_high = max((out - 1) * s + k - p - size, 0)
    return out, (p, pad_high)


def _pad_hw(x_nchw: torch.Tensor, ph, pw, value: float) -> torch.Tensor:
    return F.pad(x_nchw, (pw[0], pw[1], ph[0], ph[1]), value=value)


def caffe_max_pool_nchw(x: torch.Tensor, k: int = 3, stride: int = 2,
                        pad: int = 1) -> torch.Tensor:
    """(B, C, H, W) Caffe MAX pool."""
    oh, ph = _caffe_pool_geometry(x.shape[2], k, stride, pad)
    ow, pw = _caffe_pool_geometry(x.shape[3], k, stride, pad)
    y = F.max_pool2d(_pad_hw(x, ph, pw, float("-inf")), k, stride)
    return y[:, :, :oh, :ow]


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
