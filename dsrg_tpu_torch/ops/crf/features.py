"""Gaussian-kernel features of the dense CRF's pairwise potentials
(``dsrg_tpu/ops/crf/features.py``; reference ``densecrf.cpp:61-81``).

Spatial features ``(x/sx, y/sy)`` (x the column, y the row) and bilateral
features ``(x/sx, y/sy, c0/sr, c1/sg, c2/sb)`` in the image's channel order,
pixels in row-major order.
"""

from __future__ import annotations

import torch


def spatial_features(h: int, w: int, sx: float, sy: float, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """(h*w, 2) features (x/sx, y/sy)."""
    ys = torch.arange(h, dtype=dtype, device=device)
    xs = torch.arange(w, dtype=dtype, device=device)
    fx = xs[None, :].expand(h, w) / sx
    fy = ys[:, None].expand(h, w) / sy
    return torch.stack([fx, fy], dim=-1).reshape(h * w, 2)


def bilateral_features(image: torch.Tensor, sx: float, sy: float, sr: float, sg: float,
                       sb: float) -> torch.Tensor:
    """(..., h*w, 5) features from (..., h, w, 3) images in [0, 255]; the
    scales may be numbers or 0-d tensors (CRF learning differentiates them)."""
    h, w, _ = image.shape[-3:]
    sp = spatial_features(h, w, sx, sy, dtype=image.dtype, device=image.device)
    # stacked, not copied into a new tensor: learned scales keep their gradient
    scale = torch.stack([torch.as_tensor(v, dtype=image.dtype, device=image.device) for v in (sr, sg, sb)])
    col = (image / scale).reshape(*image.shape[:-3], h * w, 3)
    return torch.cat([sp.expand(*col.shape[:-1], 2), col], dim=-1)
