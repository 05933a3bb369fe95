"""Probability-floored softmax (reference: ``pylayers.py:23-51``)."""

from __future__ import annotations

import torch

MIN_PROB = 1e-4


def floored_softmax(logits: torch.Tensor, dim: int = -1,
                    min_prob: float = MIN_PROB) -> torch.Tensor:
    """``p = softmax(logits) + min_prob; p /= p.sum(dim)``."""
    p = torch.softmax(logits, dim=dim) + min_prob
    return p / p.sum(dim=dim, keepdim=True)
