"""DeepLab-v2 ResNet-101 backbone with summed ASPP heads (output stride 8).

Counterpart of ``dsrg_tpu/models/resnet101_deeplab.py``, with the same
Caffe-DeepLab conventions:

  conv1 7x7/2 (pad 3) + BN + relu -> 161
  pool1 MAX 3x3/2 pad 1 (Caffe window semantics) -> 81
  res2: 3 bottlenecks (256), stride 1
  res3: 4 bottlenecks (512), first stride 2 -> 41
  res4: 23 bottlenecks (1024), stride 1, dilation 2
  res5: 3 bottlenecks (2048), stride 1, dilation 4
  heads fc1_voc12_c{k}: 3x3 convolutions with dilations (6, 12, 18, 24),
        num_classes channels each, summed.

Strides sit on a bottleneck's first 1x1 convolution and on its projection
shortcut (Caffe's placement, not torchvision's).  Convolutions have no bias;
the heads have one.  Module and parameter names follow the flax tree, so a
state_dict maps one to one onto flax's ``params`` + ``batch_stats``
(``models/convert.py``): ``res4_22.bn2.weight`` is ``res4_22/bn2/scale``,
``running_mean`` / ``running_var`` are ``batch_stats`` ``mean`` / ``var``.

Batch norm is frozen (Caffe-DeepLab trains with lr_mult 0 on it): it
normalises with the running statistics in eval and in both train steps.
Only BN calibration (``tools/calibrate_bn.py``) passes ``train_bn=True``,
under ``torch.no_grad()``.  ``compute_dtype`` follows the VGG model's rule:
parameters and buffers stay float32, each convolution casts its weight at the
call, and the scores return as float32.  The public forward takes and
returns NHWC; inside, activations are NCHW.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dsrg_tpu_torch.models.masking import (
    conv_out_extent,
    mask_nchw,
    pool_out_extent,
    split_valid_hw,
)
from dsrg_tpu_torch.ops.pooling import caffe_max_pool_nchw, caffe_max_pool_train
from dsrg_tpu_torch.utils.profiling import span

WIDTHS, STRIDES, DILATIONS = (64, 128, 256, 512), (1, 2, 1, 1), (1, 1, 2, 4)


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


class _FrozenNorm(torch.autograd.Function):
    """``y = (x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32, cast
    to x's dtype: flax's ``_normalize`` order.  Statistics are constants;
    the backward gives x, scale and bias their gradients, and the function
    saves x in its own dtype (not the float32 centred copy).  A bfloat16 x
    or cotangent meets the float32 statistics in type promotion, which
    converts it exactly, without a float32 copy of its own."""

    @staticmethod
    def forward(ctx, x, mean, var, scale, bias, eps: float):
        with span("frozen_batch_norm"):
            inv = torch.rsqrt(var + eps)
            y = (x - _per_channel(mean)) * _per_channel(inv * scale) + _per_channel(bias)
            ctx.save_for_backward(x, mean, inv, scale)
            return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        with span("frozen_batch_norm"):
            x, mean, inv, scale = ctx.saved_tensors
            gx = (g * _per_channel(inv * scale)).to(x.dtype)
            gscale = (g * (x - _per_channel(mean))).sum((0, 2, 3)) * inv
            return gx, None, None, gscale, g.sum((0, 2, 3), dtype=torch.float32), None


class FrozenBatchNorm2d(nn.Module):
    """Scale / offset parameters (``weight`` / ``bias``) and running
    ``running_mean`` / ``running_var`` buffers, with no
    ``num_batches_tracked``: flax ``nn.BatchNorm(momentum=0.95,
    epsilon=1e-5)``.

    ``train_bn=True`` normalises by the batch's statistics (flax's
    ``_compute_stats``: float32, biased variance ``E[x^2] - E[x]^2`` clipped
    at 0) and moves the buffers ``ra = momentum * ra + (1 - momentum) *
    batch``; it is BN calibration and runs without autograd."""

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.95):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train_bn: bool = False) -> torch.Tensor:
        if not train_bn:
            return _FrozenNorm.apply(x, self.running_mean, self.running_var, self.weight, self.bias,
                                     self.eps)
        if torch.is_grad_enabled():
            raise RuntimeError("train_bn is BN calibration: run it under torch.no_grad()")
        xf = x.float()
        mean = xf.mean((0, 2, 3))
        var = torch.clamp_min((xf * xf).mean((0, 2, 3)) - mean * mean, 0.0)
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)
        return _FrozenNorm.apply(x, mean, var, self.weight, self.bias, self.eps)


def _conv(cin: int, cout: int, k: int, stride: int = 1, dilation: int = 1, bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=dilation * (k // 2), dilation=dilation, bias=bias)


class Bottleneck(nn.Module):
    """1x1 (stride) -> 3x3 (dilation) -> 1x1 (4x ``features``), each with
    frozen BN, plus the identity or a 1x1 projection (stride) with BN."""

    def __init__(self, cin: int, features: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        self.stride = stride
        if cin != features * 4 or stride != 1:
            self.shortcut = _conv(cin, features * 4, 1, stride)
            self.shortcut_bn = FrozenBatchNorm2d(features * 4)
        else:
            self.shortcut = self.shortcut_bn = None
        self.conv1 = _conv(cin, features, 1, stride)
        self.bn1 = FrozenBatchNorm2d(features)
        self.conv2 = _conv(features, features, 3, dilation=dilation)
        self.bn2 = FrozenBatchNorm2d(features)
        self.conv3 = _conv(features, features * 4, 1)
        self.bn3 = FrozenBatchNorm2d(features * 4)

    def forward(self, x, dtype, train_bn=False, vh=None, vw=None):
        """``vh`` / ``vw``: the valid extents of ``x`` on a shared canvas.
        Only the 3x3 mixes positions, so one mask before it (at the extent
        after the stride) keeps the canvas forward exact."""
        def conv(layer, t):
            return F.conv2d(t, layer.weight.to(dtype), None, layer.stride, layer.padding, layer.dilation)

        shortcut = x
        if self.shortcut is not None:
            shortcut = self.shortcut_bn(conv(self.shortcut, x), train_bn)
        y = F.relu(self.bn1(conv(self.conv1, x), train_bn))
        if vh is not None and self.stride == 2:
            vh, vw = conv_out_extent(vh, 1, 2, 0), conv_out_extent(vw, 1, 2, 0)
        y = F.relu(self.bn2(conv(self.conv2, mask_nchw(y, vh, vw)), train_bn))
        y = self.bn3(conv(self.conv3, y), train_bn)
        return F.relu(y + shortcut)


class ResNet101DeepLab(nn.Module):
    def __init__(self, num_classes: int = 21, head_dilations: Sequence[int] = (6, 12, 18, 24),
                 stage_blocks: Sequence[int] = (3, 4, 23, 3), compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.head_dilations = tuple(head_dilations)
        self.stage_blocks = tuple(stage_blocks)
        self.compute_dtype = compute_dtype
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = FrozenBatchNorm2d(64)
        cin = 64
        for s, (n_blocks, w, st, dil) in enumerate(zip(self.stage_blocks, WIDTHS, STRIDES, DILATIONS), start=2):
            for b in range(n_blocks):
                self.add_module(f"res{s}_{b}", Bottleneck(cin, w, st if b == 0 else 1, dil))
                cin = w * 4
        for k, dil in enumerate(self.head_dilations):
            self.add_module(f"fc1_voc12_c{k}", _conv(cin, num_classes, 3, dilation=dil, bias=True))

    def blocks(self):
        """The bottlenecks in order, with their stage number."""
        for s, n_blocks in enumerate(self.stage_blocks, start=2):
            for b in range(n_blocks):
                yield getattr(self, f"res{s}_{b}")

    def forward(self, x: torch.Tensor, valid_hw: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None, train_bn: bool = False) -> torch.Tensor:
        """x: (B, H, W, 3) mean-subtracted BGR.  Returns (B, H', W', C) f32
        scores, computed in ``compute_dtype``.

        ``valid_hw``: optional (B, 2) per-image valid extents on a shared
        canvas (``models/masking.py``): the input is masked before conv1,
        the pool's input before pool1, each bottleneck before its 3x3 and
        the heads' shared input.  ``train``: pool1 differentiable through
        the pool backward kernels.  The net has no dropout, so
        ``generator`` goes unused (the VGG model's signature).
        ``train_bn``: BN calibration (:class:`FrozenBatchNorm2d`).
        """
        dt = self.compute_dtype
        x = x.permute(0, 3, 1, 2).to(dt).contiguous()
        vh, vw = split_valid_hw(valid_hw)
        c1 = self.conv1
        x = F.conv2d(mask_nchw(x, vh, vw), c1.weight.to(dt), None, c1.stride, c1.padding)
        x = F.relu(self.bn1(x, train_bn))
        if vh is not None:
            vh, vw = conv_out_extent(vh, 7, 2, 3), conv_out_extent(vw, 7, 2, 3)
        max_pool = caffe_max_pool_train if train else caffe_max_pool_nchw
        x = max_pool(mask_nchw(x, vh, vw), 3, 2, 1)  # post-ReLU: masked zeros never win a max
        if vh is not None:
            vh, vw = pool_out_extent(vh), pool_out_extent(vw)
        for block in self.blocks():
            x = block(x, dt, train_bn, vh, vw)
            if vh is not None and block.stride == 2:
                vh, vw = conv_out_extent(vh, 1, 2, 0), conv_out_extent(vw, 1, 2, 0)
        x = mask_nchw(x, vh, vw)  # the shared input of the dilated heads
        scores = None
        for k in range(len(self.head_dilations)):
            head = getattr(self, f"fc1_voc12_c{k}")
            h = F.conv2d(x, head.weight.to(dt), head.bias.to(dt), 1, head.padding, head.dilation)
            scores = h if scores is None else scores + h
        return scores.permute(0, 2, 3, 1).float()
