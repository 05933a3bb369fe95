"""Inverted dropout with 8-bit random masks (``dsrg_tpu/ops/dropout.py``).

One random byte per element: keep where ``byte >= round(rate * 256)`` and
scale kept units by ``1 / (1 - thresh / 256)``, an exact Bernoulli(rate)
draw whenever ``rate * 256`` is integral (it is for the reference's 0.5).
The bytes come from the caller's ``torch.Generator`` (Philox on the card),
so the masks differ from the JAX package's draws; the rule and the
distribution are the same.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def apply_dropout_bytes(x: torch.Tensor, bytes_: torch.Tensor, rate: float) -> torch.Tensor:
    """The 8-bit rule on given uint8 ``bytes_`` of ``x``'s shape."""
    thresh = int(round(rate * 256))
    scale = 1.0 / (1.0 - thresh / 256.0)
    return torch.where(bytes_ >= thresh, x * scale, torch.zeros((), dtype=x.dtype, device=x.device))


class CaffeDropout(nn.Module):
    """Inverted dropout (Caffe semantics: identity at test time)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, train: bool,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not train or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        bytes_ = torch.randint(0, 256, x.shape, dtype=torch.uint8, device=x.device,
                               generator=generator)
        return apply_dropout_bytes(x, bytes_, self.rate)
