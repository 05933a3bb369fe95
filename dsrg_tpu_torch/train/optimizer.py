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

On the card the whole update, with the train steps' 1 / n_valid scale and
the gradient norm, is one CUDA kernel pair (``train/sgd_kernels.py``); on
the CPU it is the plain loop of ATen ops, which the kernels round as.
"""

from __future__ import annotations

import math
from typing import Callable, Iterator, Mapping, Optional

import torch

from dsrg_tpu_torch._device import kernel_device
from dsrg_tpu_torch.train.sgd_kernels import caffe_sgd


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


class ScaledGrads(Mapping):
    """``{name: raw[name] * inv}``, the gradients a train step hands to
    :meth:`CaffeSGD.step`: the summed gradients and the 0-d ``inv`` (one over
    the valid count), scaled where they are read.  The kernel pair scales
    inside its pass and never reads them; the plain loop reads each once,
    made on first read.  :meth:`norm` is their global norm, taken once a
    step: by the update that computed it, or here on the first call."""

    def __init__(self, raw: Mapping[str, torch.Tensor], inv: torch.Tensor):
        self.raw, self.inv = raw, inv
        self._scaled: dict = {}
        self._norm: Optional[torch.Tensor] = None

    def __getitem__(self, name: str) -> torch.Tensor:
        g = self._scaled.get(name)
        if g is None:
            g = self._scaled[name] = self.raw[name] * self.inv
        return g

    def __iter__(self) -> Iterator[str]:
        return iter(self.raw)

    def __len__(self) -> int:
        return len(self.raw)

    def norm(self) -> torch.Tensor:
        if self._norm is None:
            self._norm = global_norm(self.values())
        return self._norm


class CaffeSGD:
    """The Caffe SGD update over a module's named parameters.

    ``clip_gradients`` > 0 scales the raw gradients to at most that global
    L2 norm first (``SGDSolver::ClipGradients``).  Velocities and
    parameters are updated in place.  Leaves on the card take the kernel
    pair (float32 only; anything else raises), CPU leaves the plain loop.
    ``params`` and ``velocity`` stay dicts of per-leaf tensors, read anew
    at every step: a caller may replace either's tensors.
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
        """One update from ``{name: gradient}`` (a :class:`ScaledGrads`
        from the train steps, which then holds the gradient norm)."""
        if kernel_device(next(iter(self.params.values())), "CaffeSGD"):
            self._step_kernels(grads)
        else:
            self._step_plain(grads)
        self.step_count += 1

    def _step_kernels(self, grads: Mapping[str, torch.Tensor]) -> None:
        names = list(self.params)
        scaled = isinstance(grads, ScaledGrads)
        raw = grads.raw if scaled else grads
        lr = self.lr_fn(self.step_count)
        norm = caffe_sgd([raw[n] for n in names], [self.params[n] for n in names],
                         [self.velocity[n] for n in names], grads.inv if scaled else None,
                         [self.weight_decay * self.decay_mults[n] for n in names],
                         [lr * self.lr_mults[n] for n in names], self.momentum, self._clip())
        if scaled:
            grads._norm = norm

    def _clip(self) -> float:
        return self.clip_gradients if self.clip_gradients and self.clip_gradients > 0 else 0.0

    def _step_plain(self, grads: Mapping[str, torch.Tensor]) -> None:
        scale = None
        if self._clip():
            gnorm = grads.norm() if isinstance(grads, ScaledGrads) else global_norm(grads.values())
            scale = torch.clamp(self.clip_gradients / torch.clamp_min(gnorm, 1e-12), max=1.0)
        lr = self.lr_fn(self.step_count)
        for name, w in self.params.items():
            g = grads[name] if scale is None else grads[name] * scale
            g = g + (self.weight_decay * self.decay_mults[name]) * w
            g = (lr * self.lr_mults[name]) * g
            v = self.velocity[name]
            v.mul_(self.momentum).add_(g)
            w.sub_(v)

    def load_state_dict(self, state: Mapping) -> None:
        for name, v in state["velocity"].items():
            self.velocity[name].copy_(v)
        self.step_count = int(state["step"])
