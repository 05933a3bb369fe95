"""Align-corners bilinear interpolation as dense matmuls (``dsrg_tpu/ops/interp.py``).

``scipy.ndimage.zoom(..., order=1)``, which the reference's CRFLayer uses to
shrink 321x321 images to the 41x41 score resolution, maps output ``i`` to
input ``i * (in - 1) / (out - 1)``; the Caffe ``Interp`` layer with
``shrink_factor`` samples the same way.  The (out, in) interpolation
matrices are tiny and applied with two matmuls.
"""

from __future__ import annotations

import numpy as np
import torch


def zoom_matrix(in_size: int, out_size: int, dtype=np.float32) -> np.ndarray:
    """Dense (out_size, in_size) align-corners linear interpolation matrix."""
    m = np.zeros((out_size, in_size), dtype=np.float64)
    if out_size == 1 or in_size == 1:
        m[:, 0] = 1.0
        return m.astype(dtype)
    scale = (in_size - 1) / (out_size - 1)
    for i in range(out_size):
        x = i * scale
        lo = min(int(np.floor(x)), in_size - 2)
        frac = x - lo
        m[i, lo] = 1.0 - frac
        m[i, lo + 1] = frac
    return m.astype(dtype)


def zoom_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Align-corners bilinear resize of an (..., H, W, C) tensor."""
    h, w = x.shape[-3], x.shape[-2]
    mh = torch.from_numpy(zoom_matrix(h, out_h)).to(device=x.device, dtype=x.dtype)
    mw = torch.from_numpy(zoom_matrix(w, out_w)).to(device=x.device, dtype=x.dtype)
    y = torch.einsum("oh,...hwc->...owc", mh, x)
    return torch.einsum("pw,...owc->...opc", mw, y)


def caffe_interp_out_size(in_size: int, shrink_factor: int) -> int:
    """Caffe ``Interp`` output size for ``shrink_factor`` (no padding)."""
    return (in_size - 1) // shrink_factor + 1


def caffe_interp_shrink(x: torch.Tensor, shrink_factor: int) -> torch.Tensor:
    """Caffe ``Interp`` shrink of an (..., H, W, C) tensor.  For 321 -> 41
    the align-corners stride is exactly 8: pure subsampling, safe on
    integer label maps."""
    h, w = x.shape[-3], x.shape[-2]
    oh = caffe_interp_out_size(h, shrink_factor)
    ow = caffe_interp_out_size(w, shrink_factor)
    if oh > 1 and ow > 1 and (h - 1) % (oh - 1) == 0 and (w - 1) % (ow - 1) == 0:
        return x[..., :: (h - 1) // (oh - 1), :: (w - 1) // (ow - 1), :]
    return zoom_bilinear(x, oh, ow)
