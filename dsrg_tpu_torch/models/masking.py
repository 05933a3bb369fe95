"""Per-image valid-extent masking: exact variable-size forwards on one canvas.

Zeroing the region beyond each image's true extent before every op that
mixes spatial positions makes a shared-canvas forward equal to running the
net at each image's own size: convolutions then read zeros where the
exact-size forward reads its zero padding, post-ReLU MAX pools never let a
masked zero beat a real activation, and the 3x3/pad-1 AVE pool divides by 9
either way.  Extents shrink through the k3/s2/p1 pools as ``floor(v/2)+1``.
"""

from __future__ import annotations

from typing import Optional

import torch


def valid_mask(h: int, w: int, vh: torch.Tensor, vw: torch.Tensor) -> torch.Tensor:
    """(B, h, w, 1) bool mask of rows < vh and cols < vw (vh/vw: (B,) f32)."""
    rh = torch.arange(h, dtype=torch.float32, device=vh.device)[None, :] < vh[:, None]
    rw = torch.arange(w, dtype=torch.float32, device=vw.device)[None, :] < vw[:, None]
    return (rh[:, :, None] & rw[:, None, :])[..., None]


def apply_valid_mask(x: torch.Tensor, vh: Optional[torch.Tensor],
                     vw: Optional[torch.Tensor]) -> torch.Tensor:
    """Zero NHWC ``x`` beyond the per-image valid extent; identity when vh is None."""
    if vh is None:
        return x
    return x * valid_mask(x.shape[1], x.shape[2], vh, vw).to(x.dtype)


def masked_pool_input(x: torch.Tensor, vh: Optional[torch.Tensor],
                      vw: Optional[torch.Tensor]) -> torch.Tensor:
    """Mask ``x`` as the input of a following Caffe MAX pool.  Exact only
    for non-negative (post-ReLU) inputs, as every pool input of the
    in-tree models is."""
    return apply_valid_mask(x, vh, vw)


def pool_out_extent(v: torch.Tensor) -> torch.Tensor:
    """Caffe 3x3/stride-2/pad-1 pooled extent: floor(v/2)+1."""
    return torch.floor(v / 2.0) + 1.0
