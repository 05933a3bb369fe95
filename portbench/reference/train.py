"""The DSRG train steps in plain PyTorch, with Caffe's SGD.

Stage 1 (``train-s.prototxt``): a joint random mirror of images and cues
(one uniform draw per image, flipped below 0.5), the backbone's train
forward, the floored softmax ``(softmax + 1e-4) / sum`` clamped at 1e-4
with an identity gradient (the CRFLayer's in-place clamp), the CRF (no
gradient to the images; the backward of log Q is the reference's
``(1 - Q) * g``), region growing on the refined marginals, the balanced seed
loss (background and foreground cross-entropies over their own seed counts)
plus the constrain loss (the mean over pixels of
``sum_c Q log clip(Q / P, 0.05, 20)``), averaged over the batch.
Stage 2 (``train-f.prototxt``): the mirror, the forward, the labels
subsampled by 8 (Caffe's ``Interp`` shrink at 321 -> 41), softmax
cross-entropy over the pixels not labelled 255, divided by their count.
SGD (Caffe's order): clip the raw gradient's global norm when set, add
``decay * decay_mult * w``, scale by ``lr * lr_mult``, ``v = 0.9 v + g``,
``w -= v``.  The random draws (mirror, then dropout) come from a generator
seeded as the program's, in the program's order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import crf, models
from portbench.reference.grow import grow

MIN_PROB = 1e-4


class _HeuristicLog(torch.autograd.Function):
    """log Q in value; the backward to the probabilities is (1 - Q) * g."""

    @staticmethod
    def forward(ctx, probs, q):
        ctx.save_for_backward(q)
        return torch.log(q)

    @staticmethod
    def backward(ctx, g):
        (q,) = ctx.saved_tensors
        return (1.0 - q) * g, None


def _mirror(gen, dev, *tensors):
    flip = torch.rand(tensors[0].shape[0], generator=gen, device=dev) < 0.5
    return [torch.where(flip.view(-1, *([1] * (t.dim() - 1))), t.flip(2), t) for t in tensors]


def stage1_losses(p: dict, cfg: dict, traffic: dict, batch: dict, gen, dev, dtype=torch.float32) -> torch.Tensor:
    """Per-sample stage-1 losses, (B,)."""
    images, labels, cues = (torch.as_tensor(batch[k], device=dev).to(dtype) for k in ("images", "labels", "cues"))
    images, cues = _mirror(gen, dev, images, cues)
    scores = models.forward(p, cfg, images, train=True, gen=gen)
    soft = torch.softmax(scores, -1) + MIN_PROB
    soft = soft / soft.sum(-1, keepdim=True)
    probs = soft + (soft.clamp_min(MIN_PROB) - soft).detach()
    q = crf.refine(probs.detach(), images, traffic["crf_scale_factor"], traffic["crf_iters"])
    log_q = _HeuristicLog.apply(probs, q)
    grown = torch.as_tensor(grow(labels.cpu().numpy(), cues.cpu().numpy(), q.cpu().numpy(), traffic["th1"],
                                 traffic["th2"]), device=dev)
    count_bg = torch.clamp_min(grown[..., 0].sum((1, 2)), MIN_PROB)
    count_fg = torch.clamp_min(grown[..., 1:].sum((1, 2, 3)), MIN_PROB)
    seed = (-(grown[..., 0] * torch.log(probs[..., 0])).sum((1, 2)) / count_bg
            - (grown[..., 1:] * torch.log(probs[..., 1:])).sum((1, 2, 3)) / count_fg)
    q_s = torch.exp(log_q)
    constrain = (q_s * torch.log(torch.clamp(q_s / probs, 0.05, 20.0))).sum(-1).mean((1, 2))
    return seed + constrain


def stage2_loss_sums(p: dict, cfg: dict, traffic: dict, batch: dict, gen, dev, dtype=torch.float32):
    """(cross-entropy sum, valid pixel count) over the batch."""
    images = torch.as_tensor(batch["images"], device=dev).to(dtype)
    labels = torch.as_tensor(batch["labels"], device=dev)
    images, labels = _mirror(gen, dev, images, labels)
    small = labels[:, ::8, ::8]
    scores = models.forward(p, cfg, images, train=True, gen=gen)
    valid = small != traffic["ignore_label"]
    logp = torch.log_softmax(scores, -1)
    picked = torch.gather(logp, -1, torch.where(valid, small, 0)[..., None])[..., 0]
    return -(picked * valid).sum(), valid.sum()


def learning_rate(solver: dict, step: int) -> float:
    if solver["policy"] == "step":
        return solver["base_lr"] * solver["gamma"] ** math.floor(step / solver["stepsize"])
    return solver["base_lr"] * (1.0 - step / solver["max_iter"]) ** solver["power"]


class SGD:
    def __init__(self, params: dict, solver: dict):
        self.params, self.solver = params, solver
        self.velocity = {n: torch.zeros_like(w) for n, w in params.items()}
        self.step_count = 0

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        s = self.solver
        clip = s.get("clip_gradients", 0.0)
        scale = 1.0
        if clip > 0:
            norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
            scale = torch.clamp(clip / torch.clamp_min(norm, 1e-12), max=1.0)
        lr = learning_rate(s, self.step_count)
        for n, w in self.params.items():
            lr_mult, decay_mult = models.lr_decay_mults(n)
            g = grads[n] * scale + (s["weight_decay"] * decay_mult) * w
            self.velocity[n].mul_(s["momentum"]).add_((lr * lr_mult) * g)
            w.sub_(self.velocity[n])
        self.step_count += 1


def applied_gradient_norms(velocity: dict, w0: dict, solver: dict) -> dict:
    """Per trained leaf, the norm of the gradient that the first SGD step
    applied, worked out from the velocity after it: ``v / (lr * lr_mult) -
    decay * decay_mult * w0``.  Used alike for the program and here."""
    lr = learning_rate(solver, 0)
    out = {}
    for n, v in velocity.items():
        lr_mult, decay_mult = models.lr_decay_mults(n)
        if lr_mult == 0:
            continue
        w = w0[n].to(v.device)
        out[n] = float(torch.linalg.vector_norm(v / (lr * lr_mult) - (solver["weight_decay"] * decay_mult) * w))
    return out


def change_norms(params: dict, w0: dict) -> dict:
    """Per trained leaf, ``|w - w0|``."""
    return {n: float(torch.linalg.vector_norm(w.detach() - w0[n].to(w.device)))
            for n, w in params.items() if models.lr_decay_mults(n)[0] > 0}


def run_steps(cfg: dict, traffic: dict, solver: dict, w0: dict, batches, gen_seed: int, dev,
              half_batch: bool = False, steps: int = 3, dtype=torch.float32) -> dict:
    """The first ``steps`` steps from ``w0`` on ``batches`` (a function of the
    step index).  ``half_batch``: a planted fault, the loss the mean over
    the first half of each batch only; ``dtype``: float64 gives a second
    witness of how far rounding alone moves the numbers.  Returns the
    losses, the applied first gradients' norms and the changes' norms per
    leaf."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        params = {n: t.to(dev, dtype).clone() for n, t in w0.items()}
        trained = {n: w for n, w in params.items() if n in _leaves(cfg)}
        for w in trained.values():
            w.requires_grad_(True)
        gen = torch.Generator(device=dev).manual_seed(gen_seed)
        opt = SGD(trained, solver)
        losses, grad_norms = [], None
        for t in range(steps):
            batch = batches(t)
            if traffic["stage"] == "s":
                per = stage1_losses(params, cfg, traffic, batch, gen, dev, dtype)
                n = per.shape[0] // 2 if half_batch else per.shape[0]
                loss = per[:n].sum() / n
            else:
                total, count = stage2_loss_sums(params, cfg, traffic, _half(batch) if half_batch else batch, gen,
                                                dev, dtype)
                loss = total / torch.clamp_min(count.to(dtype), 1.0)
            grads = dict(zip(trained, torch.autograd.grad(loss, list(trained.values()))))
            opt.step(grads)
            losses.append(float(loss.detach()))
            if t == 0:
                grad_norms = applied_gradient_norms(opt.velocity, w0, solver)
        return {"losses": losses, "grad_norms": grad_norms, "change_norms": change_norms(trained, w0)}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _half(batch: dict) -> dict:
    """Stage 2's half-batch fault: the second half's labels all ignored."""
    labels = np.array(batch["labels"])
    labels[labels.shape[0] // 2:] = 255
    return {**batch, "labels": labels}


def _leaves(cfg: dict) -> set:
    """The parameters (not the BN statistics)."""
    names = set()
    for c in models.convs(cfg):
        names.add(c.name + ".weight")
        if c.bias:
            names.add(c.name + ".bias")
    if cfg["family"] == "resnet101":
        for n in models.resnet_norms(cfg):
            names.update({n + ".weight", n + ".bias"})
    return names


def compare(prog: dict, ref: dict, names) -> dict:
    """The numbers of ``names`` (a cell's limits file names those it holds):
    the widest relative gap of a step's loss (``loss_gap``) or the first
    step's (``loss_gap_1``); and, by the worst leaf, the gap between the
    program's and the reference's norm of the applied first gradient
    (``grad_gap``) or of the change after the steps (``change_gap``), over
    the larger of that leaf's and the median leaf's reference norm.  Leaves
    whose reference gradient is under a thousandth of the median leaf's are
    left out (their updates are round-off)."""
    g_med = float(np.median(list(ref["grad_norms"].values())))
    leaves = [n for n, g in ref["grad_norms"].items() if g >= 1e-3 * g_med]

    def loss_gaps():
        return [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]

    def worst_leaf(key):
        med = float(np.median([ref[key][n] for n in leaves]))
        return max(abs(prog[key][n] - ref[key][n]) / max(ref[key][n], med) for n in leaves)

    numbers = {"loss_gap": lambda: max(loss_gaps()), "loss_gap_1": lambda: loss_gaps()[0],
               "grad_gap": lambda: worst_leaf("grad_norms"), "change_gap": lambda: worst_leaf("change_norms")}
    return {name: numbers[name]() for name in names}
