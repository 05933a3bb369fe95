"""Probability-floored softmax (reference: ``pylayers.py:23-51``) and the
CRFLayer's in-place clamp of it."""

from __future__ import annotations

import torch

MIN_PROB = 1e-4


def floored_softmax(logits: torch.Tensor, dim: int = -1,
                    min_prob: float = MIN_PROB) -> torch.Tensor:
    """``p = softmax(logits) + min_prob; p /= p.sum(dim)``."""
    p = torch.softmax(logits, dim=dim) + min_prob
    return p / p.sum(dim=dim, keepdim=True)


def clamp_straight_through(x: torch.Tensor, min_value: float) -> torch.Tensor:
    """``max(x, min_value)`` in value with an identity gradient.

    The reference clamps the shared softmax blob in place
    (``pylayers.py:67``): downstream losses see the clamped values, but the
    gradient passes to the softmax untouched.  ``torch.clamp`` would zero
    it wherever the clamp is active, which it is for every suppressed class.
    """
    return x + (x.clamp_min(min_value) - x).detach()
