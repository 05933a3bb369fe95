"""DeepLab-LargeFOV VGG16 backbone with multi-dilation heads.

Counterpart of ``dsrg_tpu/models/vgg16_largefov.py``: the same stages,
Caffe pools and summed heads, with parameter names taken from the prototxt
(``conv1_1`` ... ``fc8-SEC_4``).  The public forward takes and returns NHWC
like the flax module; inside, activations are NCHW for cuDNN.

  conv1_x(64) pool 3/2, conv2_x(128) pool 3/2, conv3_x(256) pool 3/2,
  conv4_x(512) pool 3/1, conv5_x(512, dil 2) pool 3/1, pool5a AVE 3/1,
  heads k: fc6_k 3x3x1024 (dil d_k) relu, fc7_k 1x1 relu, fc8-SEC_k 1x1,
  summed.  Dropout (``drop6``/``drop7``, 8-bit masks) follows each fc6/fc7
  ReLU at train time and is the identity at eval.

The train forward's MAX pools are the autograd pool whose backward runs the
``pool_bwd_h`` / ``pool_bwd_w`` kernels; the eval forward keeps the library
pool (the same values).

``compute_dtype`` follows flax's ``dtype=`` rule, not ``torch.autocast``: the
parameters stay float32, each convolution casts its weight and bias to
``compute_dtype`` at the call (gradients reach the float32 parameters
through the cast), activations, masks, dropout and pools run in
``compute_dtype``, and the summed heads are returned as float32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dsrg_tpu_torch.models.masking import mask_nchw, pool_out_extent, split_valid_hw
from dsrg_tpu_torch.ops.dropout import CaffeDropout
from dsrg_tpu_torch.ops.pooling import (
    caffe_avg_pool_nchw,
    caffe_max_pool_nchw,
    caffe_max_pool_train,
)

# name prefix, n convs, channels, dilation
_STAGES = (
    ("conv1", 2, 64, 1),
    ("conv2", 2, 128, 1),
    ("conv3", 3, 256, 1),
    ("conv4", 3, 512, 1),
    ("conv5", 3, 512, 2),
)
_POOL_STRIDE = (2, 2, 2, 1, 1)


class DeepLabLargeFOV(nn.Module):
    def __init__(self, num_classes: int = 21,
                 head_dilations: Sequence[int] = (6, 12, 18, 24), dropout_rate: float = 0.5,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.head_dilations = tuple(head_dilations)
        self.compute_dtype = compute_dtype
        self.dropout = CaffeDropout(dropout_rate)
        cin = 3
        for name, n_convs, ch, dil in _STAGES:
            for i in range(1, n_convs + 1):
                self.add_module(f"{name}_{i}", nn.Conv2d(cin, ch, 3, padding=dil, dilation=dil))
                cin = ch
        for k, dil in enumerate(self.head_dilations, start=1):
            self.add_module(f"fc6_{k}", nn.Conv2d(512, 1024, 3, padding=dil, dilation=dil))
            self.add_module(f"fc7_{k}", nn.Conv2d(1024, 1024, 1))
            self.add_module(f"fc8-SEC_{k}", nn.Conv2d(1024, num_classes, 1))

    @property
    def dropout_rate(self) -> float:
        return self.dropout.rate

    def _conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """The convolution ``name`` in ``compute_dtype`` (a no-op cast in float32)."""
        conv, dt = getattr(self, name), self.compute_dtype
        return F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), conv.stride, conv.padding,
                        conv.dilation)

    def forward(self, x: torch.Tensor, valid_hw: Optional[torch.Tensor] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (B, H, W, 3) mean-subtracted BGR.  Returns (B, H', W', C) f32
        scores, computed in ``compute_dtype``.

        ``valid_hw``: optional (B, 2) per-image valid extents on a shared
        canvas; the dead region is zeroed before every spatial op, which
        makes the canvas forward exact (``models/masking.py``).
        ``train``: dropout on, drawing its bytes from ``generator``, and the
        MAX pools differentiable through the pool backward kernels.
        """
        max_pool = caffe_max_pool_train if train else caffe_max_pool_nchw
        # a permuted NHWC tensor would carry its channels-last strides through
        # every convolution; the pool kernels take contiguous NCHW
        x = x.permute(0, 3, 1, 2).to(self.compute_dtype).contiguous()
        vh, vw = split_valid_hw(valid_hw)

        def mask(t):
            return mask_nchw(t, vh, vw)

        for (name, n_convs, _, _), pstride in zip(_STAGES, _POOL_STRIDE):
            for i in range(1, n_convs + 1):
                x = F.relu(self._conv(f"{name}_{i}", mask(x)))
            x = max_pool(mask(x), 3, pstride, 1)
            if pstride == 2 and vh is not None:
                vh, vw = pool_out_extent(vh), pool_out_extent(vw)
        x = mask(caffe_avg_pool_nchw(mask(x), 3, 1, 1))  # pool5a, shared head input

        scores = None
        for k in range(1, len(self.head_dilations) + 1):
            h = self.dropout(F.relu(self._conv(f"fc6_{k}", x)), train, generator)
            h = self.dropout(F.relu(self._conv(f"fc7_{k}", h)), train, generator)
            h = self._conv(f"fc8-SEC_{k}", h)
            scores = h if scores is None else scores + h
        return scores.permute(0, 2, 3, 1).float()
