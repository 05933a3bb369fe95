"""Constrain-to-boundary loss (``dsrg_tpu/losses/constrain.py``; reference
``ConstrainLossLayer``, ``pylayers.py:154-180``): the clipped KL
``mean over pixels of sum_c Q_crf * log(clip(Q_crf / Q_net, 0.05, 20))``.
Gradients reach both inputs; ``torch.clamp`` passes them inside the interval
and zeroes them outside, as Theano's clip does.
"""

from __future__ import annotations

import torch


def constrain_loss_per_sample(probs: torch.Tensor, probs_smooth_log: torch.Tensor) -> torch.Tensor:
    """Per-sample clipped KL, (B,): the mean over each sample's pixels."""
    probs_smooth = torch.exp(probs_smooth_log)
    ratio = torch.clamp(probs_smooth / probs, 0.05, 20.0)
    return (probs_smooth * torch.log(ratio)).sum(-1).mean(dim=(1, 2))


def constrain_loss(probs: torch.Tensor, probs_smooth_log: torch.Tensor) -> torch.Tensor:
    """probs: (B, h, w, M) network marginals; probs_smooth_log: log CRF marginals."""
    return constrain_loss_per_sample(probs, probs_smooth_log).mean()
