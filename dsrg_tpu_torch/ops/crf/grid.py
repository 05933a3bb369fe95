"""Spatial Gaussian filter of the dense CRF (the theta_gamma kernel).

Counterpart of ``dsrg_tpu/ops/crf/grid.py:38-80``: an exact truncated
separable Gaussian over the image plane as two banded fp32 matrix products.
"""

from __future__ import annotations

import math

import torch


def axis_blur_matrix(length: int, sigma: float, truncate: float, device) -> torch.Tensor:
    """(length, length) banded Gaussian blur matrix exp(-0.5 (d/sigma)^2),
    built on ``device`` (fp64, rounded once to fp32 as the reference's numpy
    build does): no host build and no upload per image size."""
    r = max(int(math.ceil(truncate * sigma)), 1)
    i = torch.arange(length, dtype=torch.float64, device=device)
    d = i[:, None] - i[None, :]
    return torch.exp(-0.5 * (d / sigma) ** 2).masked_fill(d.abs() > r, 0.0).float()


def gaussian_axes(h: int, w: int, sigma: float, device, truncate: float = 4.0) -> tuple:
    """The (K_h, K_w) pair of :func:`separable_gaussian_filter_cf`, for a
    caller that filters many times at one size."""
    return axis_blur_matrix(h, sigma, truncate, device), axis_blur_matrix(w, sigma, truncate, device)


def separable_gaussian_filter_cf(x: torch.Tensor, sigma: float,
                                 truncate: float = 4.0, axes: tuple | None = None) -> torch.Tensor:
    """Unnormalized Gaussian filter over the last two (H, W) dims of
    ``(..., C, H, W)``, self term included; ``axes`` from
    :func:`gaussian_axes` when the caller already built them."""
    kh, kw = axes if axes is not None else gaussian_axes(x.shape[-2], x.shape[-1], sigma, x.device, truncate)
    # both matrices are symmetric: K_h @ x @ K_w
    return torch.matmul(torch.matmul(kh, x), kw)
