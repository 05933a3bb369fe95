"""Exact dense-kernel mean-field inference (``dsrg_tpu/ops/crf/exact.py``).

Per mean-field iteration (reference ``densecrf.cpp:115-131``)

    Q <- expAndNormalize(unary + sum_k w_k * norm_k * (K_k @ (norm_k * Q)))

with ``K = exp(-||f_i - f_j||^2 / 2)`` materialised once per call and the
symmetric normalisation ``norm = 1 / sqrt(K @ 1 + 1e-20)``
(``pairwise.cpp:40-62``).  At the train step's 41x41 score map N = 1681, so
K is small and the loop is plain fp32 matmuls, batched over a leading image
dimension.  The JAX package computes them at ``Precision.HIGHEST``: on the
card TF32 must be off (``torch.backends.cuda.matmul.allow_tf32 = False``,
PyTorch's default).
"""

from __future__ import annotations

from typing import Sequence

import torch


def gaussian_kernel_matrix(feats: torch.Tensor) -> torch.Tensor:
    """K[..., i, j] = exp(-||f_i - f_j||^2 / 2) for (..., N, d) features."""
    sq = (feats * feats).sum(-1)
    cross = feats @ feats.transpose(-1, -2)
    d2 = sq[..., :, None] + sq[..., None, :] - 2.0 * cross
    return torch.exp(-0.5 * torch.clamp_min(d2, 0.0))


def symmetric_norm(k: torch.Tensor) -> torch.Tensor:
    """NORMALIZE_SYMMETRIC weights 1/sqrt(K @ 1 + 1e-20), (..., N)."""
    ones = torch.ones(k.shape[-1], 1, dtype=k.dtype, device=k.device)
    return torch.rsqrt((k @ ones)[..., 0] + 1e-20)


def _softmax_cols(x: torch.Tensor) -> torch.Tensor:
    """expAndNormalize over the class axis (``densecrf.cpp:98-106``)."""
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def mean_field_exact(unary: torch.Tensor, feats_list: Sequence[torch.Tensor],
                     weights: Sequence[float], n_iters: int = 10,
                     fast: bool = False) -> torch.Tensor:
    """Exact mean field with Potts kernels.

    ``unary``: (..., N, M) negated unary costs (what callers hand the
    reference ``CRF()``); ``feats_list``: one (..., N, d_k) array per kernel;
    ``weights``: the Potts weight of each.  Returns (..., N, M) marginals.

    ``fast=True`` reproduces the JAX package's bf16 option: the kernel
    matrices and each message's operand are rounded to bf16 and multiplied
    with fp32 sums.  Here the rounded values are kept in fp32 and multiplied
    in fp32, which gives the same numbers up to summation order; it is not
    faster than the default.
    """
    kernels = [gaussian_kernel_matrix(f.float()) for f in feats_list]
    if fast:
        kernels = [k.to(torch.bfloat16).float() for k in kernels]
    norms = [symmetric_norm(k)[..., None] for k in kernels]

    def message(q):
        msg = torch.zeros_like(q)
        for k, nrm, w in zip(kernels, norms, weights):
            x = nrm * q
            if fast:
                x = x.to(torch.bfloat16).float()
            msg = msg + w * (nrm * (k @ x))
        return msg

    q = _softmax_cols(unary)
    for _ in range(n_iters):
        q = _softmax_cols(unary + message(q))
    return q
