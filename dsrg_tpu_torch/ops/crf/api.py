"""Train-step CRF refinement (the train half of ``dsrg_tpu/ops/crf/api.py``).

The batched equivalents of the reference's Caffe ``CRFLayer`` and
``DSRGLayer.refinement`` (``pylayers.py:54-92,310-331``): shrink the
mean-subtracted images to the score resolution, run the exact dense CRF per
image with the probabilities as unaries, clamp and renormalise.  The
``CRFLayer``'s backward is the reference's heuristic ``(1 - Q) * g``,
reproduced on purpose rather than replaced by the CRF's Jacobian.
"""

from __future__ import annotations

import torch

from dsrg_tpu_torch.data.voc import BGR_MEAN
from dsrg_tpu_torch.ops.crf.exact import mean_field_exact
from dsrg_tpu_torch.ops.crf.features import bilateral_features, spatial_features
from dsrg_tpu_torch.ops.interp import zoom_bilinear
from dsrg_tpu_torch.ops.softmax import MIN_PROB

COLOR_FACTOR = 13.0  # the reference CRF's colour scale (pylayers.py:82,335)


def prepare_crf_images(images: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Mean-subtracted (B, H, W, 3) BGR images -> (B, out_h, out_w, 3) guides:
    bilinear zoom, re-add the BGR mean, round (``pylayers.py:70-75``)."""
    small = zoom_bilinear(images.float(), out_h, out_w)
    return torch.round(small + torch.as_tensor(BGR_MEAN, device=small.device))


def _crf_core(guides: torch.Tensor, unary: torch.Tensor, maxiter: int, scale_factor: float,
              color_factor: float, fast: bool = False) -> torch.Tensor:
    """The reference ``CRF()`` call, batched: guides (B, h, w, 3), unary
    (B, h, w, M) -> (B, h, w, M) marginals."""
    b, h, w, m = unary.shape
    img = torch.round(guides).float()
    bila = bilateral_features(img, 80.0 / scale_factor, 80.0 / scale_factor,
                              color_factor, color_factor, color_factor)
    spat = spatial_features(h, w, 3.0 / scale_factor, 3.0 / scale_factor, device=unary.device)
    q = mean_field_exact(unary.reshape(b, h * w, m).float(), (bila, spat), (10.0, 3.0),
                         n_iters=maxiter, fast=fast)
    return q.reshape(b, h, w, m)


def crf_refine_probs(probs: torch.Tensor, images: torch.Tensor, scale_factor: float = 12.0,
                     maxiter: int = 10, min_prob: float = MIN_PROB,
                     fast: bool = False) -> torch.Tensor:
    """Refine (B, h, w, M) probabilities with the dense CRF guided by the
    mean-subtracted (B, H, W, 3) images: clamp to ``min_prob``, mean field,
    clamp the marginals and renormalise.  ``torch.maximum`` splits the
    gradient at ties as ``jnp.maximum`` does, which matters for
    :func:`crf_refine_with_log_truegrad`: after the CRFLayer's clamp many
    probabilities equal ``min_prob`` exactly."""
    b, h, w, _ = probs.shape
    floor = torch.tensor(min_prob, dtype=probs.dtype, device=probs.device)
    guides = prepare_crf_images(images, h, w)
    q = _crf_core(guides, torch.maximum(probs, floor), maxiter, scale_factor, COLOR_FACTOR,
                  fast=fast)
    q = torch.maximum(q, floor)
    return q / q.sum(-1, keepdim=True)


class _RefineWithLog(torch.autograd.Function):
    @staticmethod
    def forward(ctx, probs, images, scale_factor, maxiter, fast):
        q = crf_refine_probs(probs, images, scale_factor=scale_factor, maxiter=maxiter, fast=fast)
        ctx.save_for_backward(q)
        ctx.mark_non_differentiable(q)
        return torch.log(q), q

    @staticmethod
    def backward(ctx, g_log, _g_q):
        (q,) = ctx.saved_tensors
        return (1.0 - q) * g_log, None, None, None, None


def crf_refine_with_log(probs: torch.Tensor, images: torch.Tensor, scale_factor: float = 12.0,
                        maxiter: int = 10, fast: bool = False):
    """One CRF evaluation returning ``(log Q, Q)`` for the train step.

    ``log Q`` carries the CRFLayer's heuristic backward ``(1 - Q) * g`` to
    ``probs``; no gradient reaches the images (``propagate_down: 0``) and
    ``Q``, the region grower's input, is detached.
    """
    return _RefineWithLog.apply(probs, images, scale_factor, maxiter, fast)


def crf_refine_with_log_truegrad(probs: torch.Tensor, images: torch.Tensor,
                                 scale_factor: float = 12.0, maxiter: int = 10,
                                 fast: bool = False):
    """``crf_refine_with_log`` with autograd through the mean-field loop
    (CRF-as-RNN) instead of the heuristic backward; ``Q`` stays detached."""
    q = crf_refine_probs(probs, images, scale_factor=scale_factor, maxiter=maxiter, fast=fast)
    return torch.log(q), q.detach()
