"""Exact dense-kernel mean-field inference (``dsrg_tpu/ops/crf/exact.py``).

Per mean-field iteration (reference ``densecrf.cpp:115-131``)

    Q <- expAndNormalize(unary + sum_k w_k * norm_k * (K_k @ (norm_k * Q)))

with ``K = exp(-||f_i - f_j||^2 / 2)`` materialised once per call and the
symmetric normalisation ``norm = 1 / sqrt(K @ 1 + 1e-20)``
(``pairwise.cpp:40-62``).  At the train step's 41x41 score map N = 1681, so
K is small and the loop is plain fp32 matmuls, batched over a leading image
dimension.  The JAX package computes them at ``Precision.HIGHEST``: on the
card TF32 must be off (``torch.backends.cuda.matmul.allow_tf32 = False``,
PyTorch's default).  ``fast=True`` multiplies in bfloat16 instead.

:func:`mean_field_general` is the object API's engine (``DenseCRF``):
arbitrary label compatibilities and the reference's four kernel
normalisations (:func:`kernel_norm_weights`); it runs its products in full
fp32 whatever TF32 allows, and autograd differentiates it (CRF learning,
``objectives.py``).
"""

from __future__ import annotations

from typing import Sequence

import torch

from dsrg_tpu_torch._device import full_fp32


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


def kernel_norm_weights(k: torch.Tensor, ntype: str):
    """(pre, post) per-pixel weights of the forward filter, after the
    reference ``DenseKernel``'s normalisations (``pairwise.cpp:40-80``),
    with deg = K @ 1:

      - ``"no"``: K @ q, no weights;
      - ``"before"``: K @ (q / (deg + 1e-20));
      - ``"after"``: (K @ q) / (deg + 1e-20) (NIPS'11);
      - ``"symmetric"``: rsqrt(deg + 1e-20) on both sides (ICML'13, the
        default and the only mode DSRG runs).
    None for a side without weights."""
    with full_fp32():
        deg = (k @ torch.ones(k.shape[-1], 1, dtype=k.dtype, device=k.device))[..., 0]
    if ntype == "symmetric":
        nrm = torch.rsqrt(deg + 1e-20)
        return nrm, nrm
    if ntype == "before":
        return 1.0 / (deg + 1e-20), None
    if ntype == "after":
        return None, 1.0 / (deg + 1e-20)
    if ntype == "no":
        return None, None
    raise ValueError(f"unknown normalization type: {ntype!r}")


def normalized_filter(k: torch.Tensor, q: torch.Tensor, pre, post) -> torch.Tensor:
    """``post * (K @ (pre * q))`` for (N, M) q, either side optional."""
    x = q if pre is None else pre[..., None] * q
    with full_fp32():
        out = k @ x
    return out if post is None else post[..., None] * out


def _softmax_cols(x: torch.Tensor) -> torch.Tensor:
    """expAndNormalize over the class axis (``densecrf.cpp:98-106``)."""
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def _bf16_product(k: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``k @ x`` of bfloat16 (..., N, N) and (..., N, M) with float32 sums and
    result, as JAX's ``jnp.dot(..., preferred_element_type=jnp.float32)``.
    On the card bfloat16 GEMMs (``torch.bmm(..., out_dtype=float32)``): one
    per image, or one over all images' columns where ``k`` is one matrix
    (the spatial kernel); ``x``'s batch is ``k``'s otherwise.  On the CPU,
    whose torch has no such product, the float32 product of the same
    bfloat16 values: the same numbers up to summation order."""
    if not k.is_cuda:
        return k.float() @ x.float()
    n, m = x.shape[-2:]
    if k[..., 0, 0].numel() == 1:
        cols = x.reshape(-1, n, m).transpose(0, 1).reshape(1, n, -1)
        out = torch.bmm(k.reshape(1, n, n), cols, out_dtype=torch.float32)
        return out.reshape(n, -1, m).transpose(0, 1).reshape(*x.shape[:-2], n, m)
    out = torch.bmm(k.reshape(-1, n, n), x.reshape(-1, n, m), out_dtype=torch.float32)
    return out.reshape(*k.shape[:-2], n, m)


def mean_field_exact(unary: torch.Tensor, feats_list: Sequence[torch.Tensor],
                     weights: Sequence[float], n_iters: int = 10,
                     fast: bool = False) -> torch.Tensor:
    """Exact mean field with Potts kernels.

    ``unary``: (..., N, M) negated unary costs (what callers hand the
    reference ``CRF()``); ``feats_list``: one (..., N, d_k) array per kernel;
    ``weights``: the Potts weight of each.  Returns (..., N, M) marginals.

    ``fast=True`` is the JAX package's bfloat16 option
    (``dsrg_tpu/ops/crf/exact.py:126-141``): the kernel matrices are kept in
    bfloat16 between iterations (half the bytes), each message's operand is
    rounded to bfloat16, and the products sum in float32 into a float32
    result (:func:`_bf16_product`); the norms stay float32, from the rounded
    matrices.
    """
    kernels = [gaussian_kernel_matrix(f.float()) for f in feats_list]
    if fast:
        kernels = [k.to(torch.bfloat16) for k in kernels]
        norms = [torch.rsqrt(_bf16_product(k, torch.ones_like(k[..., :1]))[..., 0] + 1e-20)[..., None]
                 for k in kernels]
    else:
        norms = [symmetric_norm(k)[..., None] for k in kernels]

    def message(q):
        msg = torch.zeros_like(q)
        for k, nrm, w in zip(kernels, norms, weights):
            x = nrm * q
            prod = _bf16_product(k, x.to(torch.bfloat16)) if fast else k @ x
            msg = msg + w * (nrm * prod)
        return msg

    q = _softmax_cols(unary)
    for _ in range(n_iters):
        q = _softmax_cols(unary + message(q))
    return q


def mean_field_general(unary: torch.Tensor, feats_list: Sequence[torch.Tensor], compat_fns: Sequence,
                       n_iters: int = 10, norm_types: Sequence[str] | None = None) -> torch.Tensor:
    """Mean field with arbitrary label compatibilities.

    ``unary``: (N, M) negated unary costs; ``feats_list``: one (N, d_k)
    array per kernel; ``compat_fns[k]`` maps the filtered (N, M) messages to
    the compatibility's output (Potts ``-w * m``, Diagonal ``m * v``, Matrix
    ``m @ W.T``; signs per ``labelcompatibility.cpp:45-85``), which the
    update subtracts (``densecrf.cpp:122-129``); ``norm_types[k]`` is the
    kernel's normalisation (:func:`kernel_norm_weights`, symmetric by
    default).  Returns (N, M) marginals.
    """
    with full_fp32():
        kernels = [gaussian_kernel_matrix(f.float()) for f in feats_list]
    if norm_types is None:
        norm_types = ["symmetric"] * len(kernels)
    norms = [kernel_norm_weights(k, nt) for k, nt in zip(kernels, norm_types)]
    q = _softmax_cols(unary)
    for _ in range(n_iters):
        tmp = unary
        for k, (pre, post), compat in zip(kernels, norms, compat_fns):
            tmp = tmp - compat(normalized_filter(k, q, pre, post))
        q = _softmax_cols(tmp)
    return q
