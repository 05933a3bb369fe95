"""Seeding losses (``dsrg_tpu/losses/seed.py``; reference ``pylayers.py:95-152``).

NHWC (B, h, w, M) with the class axis last; gradients by autograd, as the
reference differentiates the same expressions with Theano.
"""

from __future__ import annotations

import torch

from dsrg_tpu_torch.ops.softmax import MIN_PROB


def seed_loss(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """SEC seeding loss (``SeedLossLayer``): ``-mean_b(sum(labels * log p) /
    count_b)``, with ``count_b`` floored at ``MIN_PROB`` as in the JAX
    package (a cue-less sample contributes 0 instead of NaN)."""
    count = labels.sum(dim=(1, 2, 3))
    per = (labels * torch.log(probs)).sum(dim=(1, 2, 3)) / torch.clamp_min(count, MIN_PROB)
    return -per.mean()


def balanced_seed_loss_per_sample(probs: torch.Tensor, labels: torch.Tensor,
                                  min_prob: float = MIN_PROB) -> torch.Tensor:
    """Per-sample stage-1 seed loss, (B,): background and foreground
    cross-entropies, each over its own floored seed count, summed."""
    count_bg = labels[..., 0].sum(dim=(1, 2))
    count_fg = labels[..., 1:].sum(dim=(1, 2, 3))
    loss_bg = -((labels[..., 0] * torch.log(probs[..., 0])).sum(dim=(1, 2))
                / torch.clamp_min(count_bg, min_prob))
    loss_fg = -((labels[..., 1:] * torch.log(probs[..., 1:])).sum(dim=(1, 2, 3))
                / torch.clamp_min(count_fg, min_prob))
    return loss_bg + loss_fg


def balanced_seed_loss(probs: torch.Tensor, labels: torch.Tensor,
                       min_prob: float = MIN_PROB) -> torch.Tensor:
    """The stage-1 seed loss (``BalancedSeedLossLayer``): the batch mean."""
    return balanced_seed_loss_per_sample(probs, labels, min_prob).mean()
