"""Stage-2 loss: softmax cross entropy with an ignore label
(``dsrg_tpu/losses/softmax_ce.py``).

Caffe's ``SoftmaxWithLoss`` with ``ignore_label: 255``
(``train-f.prototxt:732-744``): per-pixel cross entropy over valid pixels,
normalised by the valid pixel count, and the ``SegAccuracy`` pixel accuracy
(``train-f.prototxt:745-754``).  Logits are NHWC (B, h, w, M) as in the JAX
package.
"""

from __future__ import annotations

from typing import Tuple

import torch


def softmax_cross_entropy_ignore_sums(
    logits: torch.Tensor, labels: torch.Tensor, ignore_label: int = 255
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unnormalised (loss_sum, acc_sum, n_valid) over valid pixels, so that a
    caller can add the three over shards or pads and divide once.

    The predicted class is ``torch.argmax``'s, the first maximum, as
    ``jnp.argmax`` takes it: logits tied after a ReLU count alike in both.
    """
    valid = labels != ignore_label
    safe = torch.where(valid, labels, torch.zeros_like(labels)).to(torch.int64)
    logp = torch.log_softmax(logits.float(), dim=-1)
    picked = torch.gather(logp, -1, safe[..., None])[..., 0]
    zero = torch.zeros((), dtype=logp.dtype, device=logp.device)
    loss_sum = -torch.where(valid, picked, zero).sum()
    pred = torch.argmax(logits, dim=-1)
    acc_sum = torch.where(valid, (pred == safe).to(logp.dtype), zero).sum()
    return loss_sum, acc_sum, valid.sum().to(logp.dtype)


def softmax_cross_entropy_ignore(
    logits: torch.Tensor, labels: torch.Tensor, ignore_label: int = 255
) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (B, h, w, M), labels (B, h, w) int -> (loss, accuracy)."""
    loss_sum, acc_sum, n_valid = softmax_cross_entropy_ignore_sums(logits, labels, ignore_label)
    n_valid = torch.clamp_min(n_valid, 1.0)
    return loss_sum / n_valid, acc_sum / n_valid
