"""The train step's dense CRF, computed exactly (Kraehenbuehl and Koltun's
mean field with Gaussian Potts kernels and symmetric normalisation), as the
reference's ``CRFLayer`` calls it (``pylayers.py:54-92``): the images shrunk
to the score grid by align-corners bilinear sampling with the BGR mean added
back and rounded, the clamped probabilities as the unary, scale factor 12,
colour scale 13, weights 10 (bilateral, position 80 / sf) and 3 (spatial,
3 / sf), 10 iterations, then the marginals clamped at 1e-4 and
renormalised.  Every product is plain fp32."""

from __future__ import annotations

import torch
import torch.nn.functional as F

BGR_MEAN = (104.0, 117.0, 123.0)


def _kernel(feats: torch.Tensor) -> torch.Tensor:
    """exp(-|f_i - f_j|^2 / 2) for (N, d) features."""
    d2 = ((feats[:, None, :] - feats[None, :, :]) ** 2).sum(-1)
    return torch.exp(-0.5 * d2)


def refine(probs: torch.Tensor, images: torch.Tensor, scale_factor: float = 12.0, iters: int = 10,
           min_prob: float = 1e-4, color: float = 13.0) -> torch.Tensor:
    """(B, h, w, M) probabilities, (B, H, W, 3) mean-subtracted BGR ->
    (B, h, w, M) refined marginals."""
    b, h, w, m = probs.shape
    small = F.interpolate(images.permute(0, 3, 1, 2), size=(h, w), mode="bilinear", align_corners=True)
    guides = torch.round(small.permute(0, 2, 3, 1) + torch.tensor(BGR_MEAN, device=images.device,
                                                                  dtype=images.dtype))
    ys, xs = torch.meshgrid(torch.arange(h, device=probs.device, dtype=probs.dtype),
                            torch.arange(w, device=probs.device, dtype=probs.dtype), indexing="ij")
    pos = torch.stack([xs, ys], -1).reshape(h * w, 2)
    k_spatial = _kernel(pos / (3.0 / scale_factor))
    n_spatial = torch.rsqrt(k_spatial.sum(1) + 1e-20)[:, None]
    out = []
    for i in range(b):
        feats = torch.cat([pos / (80.0 / scale_factor), guides[i].reshape(h * w, 3) / color], -1)
        k_bil = _kernel(feats)
        n_bil = torch.rsqrt(k_bil.sum(1) + 1e-20)[:, None]
        unary = torch.clamp_min(probs[i].reshape(h * w, m), min_prob)
        q = torch.softmax(unary, -1)
        for _ in range(iters):
            msg = 10.0 * n_bil * (k_bil @ (n_bil * q)) + 3.0 * n_spatial * (k_spatial @ (n_spatial * q))
            q = torch.softmax(unary + msg, -1)
        q = torch.clamp_min(q, min_prob)
        out.append((q / q.sum(-1, keepdim=True)).reshape(h, w, m))
    return torch.stack(out)
