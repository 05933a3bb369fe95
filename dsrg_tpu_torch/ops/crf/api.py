"""The dense-CRF API: the public ``CRF()`` and the train step's refinement
(``dsrg_tpu/ops/crf/api.py``).

:func:`CRF` mirrors the reference's ``krahenbuhl2013.CRF``: one image, the
parameterization ``(10, 80/sf, 80/sf, cf, cf, cf, 3, 3/sf, 3/sf)``, and an
engine rule: the exact N^2 engine up to ``EXACT_MAX_PIXELS`` pixels, the
matmul bilateral grid (``mean_field_mmgrid``, the splat / slice kernels)
above.  The pseudo ground truth of a VOC image (500x375) takes the grid.

The rest are the batched equivalents of the reference's Caffe ``CRFLayer``
and ``DSRGLayer.refinement`` (``pylayers.py:54-92,310-331``): shrink the
mean-subtracted images to the score resolution, run the exact dense CRF per
image with the probabilities as unaries, clamp and renormalise.  The
``CRFLayer``'s backward is the reference's heuristic ``(1 - Q) * g``,
reproduced on purpose rather than replaced by the CRF's Jacobian.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from dsrg_tpu_torch._device import resolve_device
from dsrg_tpu_torch.data.voc import BGR_MEAN
from dsrg_tpu_torch.ops.crf.exact import mean_field_exact
from dsrg_tpu_torch.ops.crf.features import bilateral_features, spatial_features
from dsrg_tpu_torch.ops.crf.mmgrid import mean_field_mmgrid
from dsrg_tpu_torch.ops.interp import zoom_bilinear
from dsrg_tpu_torch.ops.softmax import MIN_PROB

COLOR_FACTOR = 13.0  # the reference CRF's colour scale (pylayers.py:82,335)
# above this pixel count "auto" leaves the exact engine for the grid: the
# exact engine's two (N, N) fp32 kernel matrices are 268 MB each at 8192 px
EXACT_MAX_PIXELS = 8192
ENGINES = ("auto", "exact", "mmgrid", "grid", "lattice", "native")

_log = logging.getLogger("dsrg_tpu_torch.crf")
_logged_engines: set = set()


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


def resolve_engine(engine: str, h: int, w: int) -> str:
    """The engine ``CRF(engine=...)`` runs for an (h, w) image: "exact" or
    "mmgrid".  Raises for an unknown name and for an engine the port does
    not have; it never substitutes one engine for another."""
    if engine not in ENGINES:
        raise ValueError(f"unknown CRF engine {engine!r}; expected one of {'/'.join(ENGINES)}")
    if engine in ("grid", "lattice", "native"):
        raise NotImplementedError(
            f"CRF engine {engine!r} is not ported yet (ROADMAP.md Queue 1 item 4); "
            "use 'exact', 'mmgrid' or 'auto'")
    if engine != "auto":
        return engine
    resolved = "exact" if h * w <= EXACT_MAX_PIXELS else "mmgrid"
    if (resolved, h, w) not in _logged_engines:
        # an approximate engine can move masks a little: say once per
        # geometry which one "auto" took, so a parity run knows to ask for "exact"
        _logged_engines.add((resolved, h, w))
        _log.info("CRF engine=auto resolved to '%s' for %dx%d (%d px; exact<=%d px)",
                  resolved, h, w, h * w, EXACT_MAX_PIXELS)
    return resolved


def CRF(image, unary, maxiter: int = 10, scale_factor: float = 1.0,
        color_factor: float = 13, engine: str = "auto", device=None) -> torch.Tensor:
    """Fully connected CRF inference with Gaussian potentials, as the
    reference's ``CRF()``: ``image`` (H, W, 3) in [0, 256) (uint8 or float,
    rounded), ``unary`` (H, W, M) scores (probabilities or log-probabilities,
    as callers passed them to the reference).  Returns the (H, W, M)
    marginals as an f32 tensor on the unary's device.

    ``engine``: "exact" (N^2 kernel matrices), "mmgrid" (matmul bilateral
    grid on the splat / slice kernels) or "auto" (exact up to
    ``EXACT_MAX_PIXELS`` pixels, mmgrid above).  ``device``: where numpy
    inputs go (the card by default); a tensor ``unary`` stays on its device.
    """
    if not isinstance(unary, torch.Tensor):
        unary = torch.as_tensor(np.asarray(unary), device=resolve_device(device))
    image = torch.as_tensor(image if isinstance(image, torch.Tensor) else np.asarray(image),
                            device=unary.device)
    h, w = unary.shape[:2]
    if tuple(image.shape) != (h, w, 3):
        raise ValueError(f"image {tuple(image.shape)} does not match unary {tuple(unary.shape)}")
    unary = unary.float()
    if resolve_engine(engine, h, w) == "exact":
        return _crf_core(image[None].float(), unary[None], maxiter, float(scale_factor),
                         float(color_factor))[0]
    return mean_field_mmgrid(unary, image, n_iters=maxiter, scale_factor=float(scale_factor),
                             color_factor=float(color_factor))


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
