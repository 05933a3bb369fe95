"""SEC expand loss via global weighted rank pooling (``dsrg_tpu/losses/expand.py``).

Reference: ``ExpandLossLayer`` (pylayers.py:183-233), which hardcodes 41x41
score maps, 20 foreground classes and decays q_fg=0.996 / q_bg=0.999.  As in
the JAX package the input's actual spatial size and class count are used
(the hardcoded values fall out naturally) with the same formula:

  * per foreground class, sort pixel probabilities ascending and take the
    weighted mean with weights q^(n-1-rank) (largest probability gets q^0);
  * classes present in the image pull their rank-pooled mean up (loss_1),
    absent classes push their max down (loss_2), and the background's
    rank-pooled mean is pulled up unconditionally (loss_3).

Both per-sample class-count divisors are floored, as in the JAX package
(the reference's bare divisions, pylayers.py:216-217, give NaN for an image
with no foreground class or with all of them).  No train step uses this
loss; the JAX package exports it, and so does the port.
"""

from __future__ import annotations

import torch

from dsrg_tpu_torch.ops.softmax import MIN_PROB


def _rank_pool(x_flat: torch.Tensor, q: float) -> torch.Tensor:
    """Weighted rank pooling over the last axis of (..., n) probabilities."""
    n = x_flat.shape[-1]
    x_sorted = torch.sort(x_flat, dim=-1).values  # ascending
    weights = q ** torch.arange(n - 1, -1, -1, dtype=x_flat.dtype, device=x_flat.device)
    return (x_sorted * weights).sum(-1) / weights.sum()


def expand_loss(probs: torch.Tensor, stat: torch.Tensor, q_fg: float = 0.996,
                q_bg: float = 0.999) -> torch.Tensor:
    """probs: (B, h, w, M); stat: (B, M) multi-hot image labels (bit 0 = bg)."""
    b, h, w, m = probs.shape
    probs_bg = probs[..., 0].reshape(b, h * w)
    probs_fg = torch.movedim(probs[..., 1:], -1, 1).reshape(b, m - 1, h * w)

    stat_fg = (stat[:, 1:] > 0.5).to(probs.dtype)  # (B, M-1)

    probs_max = probs_fg.amax(-1)  # (B, M-1)
    probs_mean = _rank_pool(probs_fg, q_fg)  # (B, M-1)
    probs_bg_mean = _rank_pool(probs_bg, q_bg)  # (B,)

    loss_1 = -(stat_fg * torch.log(probs_mean)
               / torch.clamp_min(stat_fg.sum(1, keepdim=True), MIN_PROB)).sum(1).mean()
    loss_2 = -((1.0 - stat_fg) * torch.log(1.0 - probs_max)
               / torch.clamp_min((1.0 - stat_fg).sum(1, keepdim=True), MIN_PROB)).sum(1).mean()
    loss_3 = -torch.log(probs_bg_mean).mean()
    return loss_1 + loss_2 + loss_3
