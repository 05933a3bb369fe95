"""DeepLab-LargeFOV VGG16 backbone with multi-dilation heads (eval forward).

Counterpart of ``dsrg_tpu/models/vgg16_largefov.py``: the same stages,
Caffe pools and summed heads, with parameter names taken from the prototxt
(``conv1_1`` ... ``fc8-SEC_4``).  The public forward takes and returns NHWC
like the flax module; inside, activations are NCHW for cuDNN.

  conv1_x(64) pool 3/2, conv2_x(128) pool 3/2, conv3_x(256) pool 3/2,
  conv4_x(512) pool 3/1, conv5_x(512, dil 2) pool 3/1, pool5a AVE 3/1,
  heads k: fc6_k 3x3x1024 (dil d_k) relu, fc7_k 1x1 relu, fc8-SEC_k 1x1,
  summed.  Dropout is the identity at eval.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dsrg_tpu_torch.models.masking import pool_out_extent, valid_mask
from dsrg_tpu_torch.ops.pooling import caffe_avg_pool_nchw, caffe_max_pool_nchw

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
                 head_dilations: Sequence[int] = (6, 12, 18, 24)):
        super().__init__()
        self.num_classes = num_classes
        self.head_dilations = tuple(head_dilations)
        cin = 3
        for name, n_convs, ch, dil in _STAGES:
            for i in range(1, n_convs + 1):
                self.add_module(f"{name}_{i}", nn.Conv2d(cin, ch, 3, padding=dil, dilation=dil))
                cin = ch
        for k, dil in enumerate(self.head_dilations, start=1):
            self.add_module(f"fc6_{k}", nn.Conv2d(512, 1024, 3, padding=dil, dilation=dil))
            self.add_module(f"fc7_{k}", nn.Conv2d(1024, 1024, 1))
            self.add_module(f"fc8-SEC_{k}", nn.Conv2d(1024, num_classes, 1))

    def forward(self, x: torch.Tensor, valid_hw: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        """x: (B, H, W, 3) mean-subtracted BGR.  Returns (B, H', W', C) f32.

        ``valid_hw``: optional (B, 2) per-image valid extents on a shared
        canvas; the dead region is zeroed before every spatial op, which
        makes the canvas forward exact (``models/masking.py``).
        """
        if train:
            raise NotImplementedError(
                "the port's DeepLabLargeFOV has the eval forward only; the "
                "train-time forward (dropout, pool backward kernels) is the "
                "next slice of the port"
            )
        x = x.permute(0, 3, 1, 2).float()
        if valid_hw is None:
            vh = vw = None
        else:
            v = valid_hw.to(torch.float32)
            vh, vw = v[:, 0], v[:, 1]

        def mask(t):
            if vh is None:
                return t
            return t * valid_mask(t.shape[2], t.shape[3], vh, vw).permute(0, 3, 1, 2).to(t.dtype)

        for (name, n_convs, _, _), pstride in zip(_STAGES, _POOL_STRIDE):
            for i in range(1, n_convs + 1):
                x = F.relu(getattr(self, f"{name}_{i}")(mask(x)))
            x = caffe_max_pool_nchw(mask(x), 3, pstride, 1)
            if pstride == 2 and vh is not None:
                vh, vw = pool_out_extent(vh), pool_out_extent(vw)
        x = mask(caffe_avg_pool_nchw(mask(x), 3, 1, 1))  # pool5a, shared head input

        scores = None
        for k in range(1, len(self.head_dilations) + 1):
            h = F.relu(getattr(self, f"fc6_{k}")(x))
            h = F.relu(getattr(self, f"fc7_{k}")(h))
            h = getattr(self, f"fc8-SEC_{k}")(h)
            scores = h if scores is None else scores + h
        return scores.permute(0, 2, 3, 1).float()
