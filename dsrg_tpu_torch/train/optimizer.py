"""Caffe-exact SGD with per-parameter multipliers (``dsrg_tpu/train/optimizer.py``).

Caffe's ``SGDSolver`` order (clip -> regularise -> scale by the local rate ->
momentum -> apply):

    g <- g + weight_decay * decay_mult * w
    g <- lr(step) * lr_mult * g
    v <- momentum * v + g
    w <- w - v

The learning rate scales the gradient before momentum, unlike
``torch.optim.SGD``, so the two differ at every ``lr_step`` boundary; the
rate is read at the step count before the increment.  Multipliers from the
prototxt ``param {}`` blocks: weights 1/1, biases 2/0, the heads 10/1 and
20/0, batch norm 0/0.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping

import torch


def lr_step(base_lr: float, gamma: float, stepsize: int) -> Callable[[int], float]:
    """``base * gamma ** floor(step / stepsize)``."""
    return lambda step: base_lr * gamma ** math.floor(step / stepsize)


def lr_poly(base_lr: float, power: float, max_iter: int) -> Callable[[int], float]:
    """``base * (1 - step / max_iter) ** power``."""
    return lambda step: base_lr * (1.0 - step / max_iter) ** power


def vgg_param_mults(names) -> tuple:
    """({name: lr_mult}, {name: decay_mult}) for state_dict names, JAX's
    rule for both families: the heads (``fc8*``, ``fc1_voc12*``) 10
    (weights) / 20 (biases), other biases 2, weights 1; biases never decay;
    batch norm (a path part containing ``bn``) 0 / 0, frozen as
    Caffe-DeepLab freezes it."""
    lr, dec = {}, {}
    for name in names:
        *path, kind = name.split(".")
        if any("bn" in part for part in path):
            lr[name] = dec[name] = 0.0
            continue
        is_bias = kind == "bias"
        is_head = any(part.startswith(("fc8", "fc1_voc12")) for part in path)
        lr[name] = (20.0 if is_bias else 10.0) if is_head else (2.0 if is_bias else 1.0)
        dec[name] = 0.0 if is_bias else 1.0
    return lr, dec


def global_norm(tensors) -> torch.Tensor:
    """L2 norm over every element of every tensor (``optax.global_norm``)."""
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors))


class CaffeSGD:
    """The Caffe SGD update over a module's named parameters.

    ``clip_gradients`` > 0 scales the raw gradients to at most that global
    L2 norm first (``SGDSolver::ClipGradients``).  Velocities and
    parameters are updated in place.
    """

    def __init__(self, params: Mapping[str, torch.Tensor], lr_fn: Callable[[int], float],
                 momentum: float = 0.9, weight_decay: float = 5e-4,
                 clip_gradients: float = 0.0):
        self.params = dict(params)
        self.lr_fn = lr_fn
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.clip_gradients = clip_gradients
        self.lr_mults, self.decay_mults = vgg_param_mults(self.params)
        self.velocity = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.step_count = 0

    @torch.no_grad()
    def step(self, grads: Mapping[str, torch.Tensor]) -> None:
        """One update from ``{name: gradient}``."""
        scale = None
        if self.clip_gradients and self.clip_gradients > 0:
            gnorm = global_norm(grads.values())
            scale = torch.clamp(self.clip_gradients / torch.clamp_min(gnorm, 1e-12), max=1.0)
        lr = self.lr_fn(self.step_count)
        for name, w in self.params.items():
            g = grads[name] if scale is None else grads[name] * scale
            g = g + (self.weight_decay * self.decay_mults[name]) * w
            g = (lr * self.lr_mults[name]) * g
            v = self.velocity[name]
            v.mul_(self.momentum).add_(g)
            w.sub_(v)
        self.step_count += 1

    def load_state_dict(self, state: Mapping) -> None:
        for name, v in state["velocity"].items():
            self.velocity[name].copy_(v)
        self.step_count = int(state["step"])
