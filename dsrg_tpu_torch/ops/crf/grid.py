"""Spatial Gaussian filter of the dense CRF (the theta_gamma kernel).

Counterpart of ``dsrg_tpu/ops/crf/grid.py:38-80``: an exact truncated
separable Gaussian over the image plane as two banded fp32 matrix products.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _axis_blur_matrix(length: int, sigma: float, truncate: float = 3.0) -> np.ndarray:
    """(length, length) banded Gaussian blur matrix exp(-0.5 (d/sigma)^2)."""
    r = max(int(math.ceil(truncate * sigma)), 1)
    i = np.arange(length)
    d = i[:, None] - i[None, :]
    k = np.exp(-0.5 * (d / sigma) ** 2)
    k[np.abs(d) > r] = 0.0
    return k.astype(np.float32)


def separable_gaussian_filter_cf(x: torch.Tensor, sigma: float,
                                 truncate: float = 4.0) -> torch.Tensor:
    """Unnormalized Gaussian filter over the last two (H, W) dims of
    ``(..., C, H, W)``, self term included."""
    h, w = x.shape[-2], x.shape[-1]
    kh = torch.as_tensor(_axis_blur_matrix(h, sigma, truncate), device=x.device)
    kw = torch.as_tensor(_axis_blur_matrix(w, sigma, truncate), device=x.device)
    # both matrices are symmetric: K_h @ x @ K_w
    return torch.matmul(torch.matmul(kh, x), kw)
