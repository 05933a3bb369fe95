"""CRF parameter-learning objectives and an L-BFGS minimiser
(``dsrg_tpu/ops/crf/objectives.py``).

The reference's CRF-learning side (``CRF/src/objective.cpp:37-109``,
``CRF/src/optimization.cpp``): an objective maps (N, M) marginals Q and the
ground truth to a scalar, and its gradient comes from autograd instead of
the hand-written "value + d*Q" forms.  :func:`minimize_lbfgs` replaces the
liblbfgs loop with ``torch.optim.LBFGS`` and a strong-Wolfe line search.
Its iterates differ from the JAX package's (``optax.lbfgs``); the tests hold
its minima and final objective values to JAX's.
"""

from __future__ import annotations

from typing import Callable

import torch


def log_likelihood(q: torch.Tensor, gt: torch.Tensor, robust: float = 0.0) -> torch.Tensor:
    """Mean log-likelihood of the ground-truth labels (N,) under Q; negative
    labels are ignored (``objective.cpp:37-56``).  ``robust`` is a floor
    inside the log, as the reference's robust variant adds."""
    valid = gt >= 0
    picked = torch.gather(q, 1, torch.where(valid, gt, 0).long()[:, None])[:, 0]
    ll = torch.where(valid, torch.log(picked + robust), 0.0)
    return ll.sum() / torch.clamp_min(valid.sum(), 1)


def hamming(q: torch.Tensor, gt: torch.Tensor, class_weight_pow: float = 1.0) -> torch.Tensor:
    """Class-weighted expected Hamming score (``objective.cpp:58-87``):
    ``sum_i w[gt_i] * Q_i[gt_i]``, with weights the inverse class
    frequencies to ``class_weight_pow``, normalised."""
    m = q.shape[1]
    valid = gt >= 0
    safe = torch.where(valid, gt, 0).long()
    counts = torch.zeros(m, dtype=q.dtype, device=q.device).index_add_(0, safe, valid.to(q.dtype))
    w = torch.where(counts > 0, counts ** (-class_weight_pow), 0.0)
    w = w / torch.clamp_min((w * counts).sum(), 1e-20)
    picked = torch.gather(q, 1, safe[:, None])[:, 0]
    return torch.where(valid, w[safe] * picked, 0.0).sum()


def intersection_over_union(q: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Soft IoU (``objective.cpp:89-109``): the mean over classes of
    intersection / union with Q as the soft assignment."""
    m = q.shape[1]
    valid = (gt >= 0).to(q.dtype)[:, None]
    onehot = torch.nn.functional.one_hot(torch.where(gt >= 0, gt, 0).long(), m).to(q.dtype) * valid
    inter = (q * onehot).sum(0)
    union = (q * valid + onehot - q * onehot).sum(0)
    return (inter / (union + 1e-20)).mean()


def minimize_lbfgs(fn: Callable[[torch.Tensor], torch.Tensor], x0: torch.Tensor,
                   max_iters: int = 100, tol: float = 1e-6) -> torch.Tensor:
    """Minimise ``fn`` from ``x0`` with L-BFGS (``optimization.cpp:28-101``):
    ``torch.optim.LBFGS`` with a strong-Wolfe line search on a leaf copy of
    ``x0``, on ``x0``'s device.  At most ``max_iters`` iterations; stops
    after the one whose starting gradient norm is below ``tol``, as the JAX
    package's loop does.  Returns the minimiser, detached."""
    x = x0.detach().clone().requires_grad_(True)
    opt = torch.optim.LBFGS([x], max_iter=1, line_search_fn="strong_wolfe")
    norms = []

    def closure():
        opt.zero_grad()
        value = fn(x)
        value.backward()
        norms.append(float(torch.linalg.vector_norm(x.grad)))
        return value

    for _ in range(max_iters):
        first = len(norms)
        opt.step(closure)
        if norms[first] < tol:  # the norm at the iteration's starting point
            break
    return x.detach()


def numeric_gradient(fn: Callable, x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Central-difference gradient (``optimization.cpp:103-114``'s gradCheck)."""
    flat = x.detach().reshape(-1)
    grads = []
    for i in range(flat.shape[0]):
        step = torch.zeros_like(flat)
        step[i] = eps
        grads.append((fn((flat + step).reshape(x.shape)) - fn((flat - step).reshape(x.shape))) / (2 * eps))
    return torch.stack([torch.as_tensor(g) for g in grads]).reshape(x.shape)
