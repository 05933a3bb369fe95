"""Weights from the seed, made on the device in a few large calls.

Convolutions are He-normal (std sqrt(2 / fan_in)), the first one also
divided by the images' spread, so that activations are of order one as in a
pretrained net, and biases are zero; a ResNet's
batch norms start at scale 1, offset 0 and have their statistics calibrated
on a batch of the cell's own images (one forward on batch statistics, as
``chip_smoke.py`` phase 12 warm-starts the family); then the summed heads
are rescaled so that the scores on that batch have the configuration's
stated spread (``assumed.score_std``), so that the CRF and the grower see
probabilities that are neither flat nor saturated.  Scores are linear in the
heads, so the rescale is exact.  Both the program and the reference are
given these tensors.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import models


def make_weights(cfg: dict, seed: int, device, calib: torch.Tensor) -> dict:
    """``{state_dict name: fp32 tensor on device}``; ``calib``: (B, H, W, 3)
    mean-subtracted BGR images on ``device``."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    # fp32, and no cuDNN algorithm search for the calibration batch: the cell never runs its shapes
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False, allow_tf32=False):
        try:
            return _make(cfg, seed, device, calib)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev


def _make(cfg: dict, seed: int, device, calib: torch.Tensor) -> dict:
    gen = torch.Generator(device=device).manual_seed(seed)
    layers = models.convs(cfg)
    sizes = [c.cout * c.cin * c.k * c.k for c in layers]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    input_std = float(calib.std())
    for i, (c, part) in enumerate(zip(layers, torch.split(flat, sizes))):
        std = math.sqrt(2.0 / (c.cin * c.k * c.k)) / (input_std if i == 0 else 1.0)
        out[c.name + ".weight"] = part.view(c.cout, c.cin, c.k, c.k) * std
        if c.bias:
            out[c.name + ".bias"] = torch.zeros(c.cout, device=device)
    if cfg["family"] == "resnet101":
        for name, ch in models.resnet_norms(cfg).items():
            out.update({name + ".weight": torch.ones(ch, device=device),
                        name + ".bias": torch.zeros(ch, device=device),
                        name + ".running_mean": torch.zeros(ch, device=device),
                        name + ".running_var": torch.ones(ch, device=device)})
        stats: dict = {}
        with torch.no_grad():
            models.resnet_forward(out, cfg, calib, batch_stats=stats)
        for name, (mean, var) in stats.items():
            out[name + ".running_mean"], out[name + ".running_var"] = mean, var
    with torch.no_grad():
        std = float(models.forward(out, cfg, calib).std())
    scale = cfg["assumed"]["score_std"] / std
    for name in models.head_names(cfg):
        out[name + ".weight"] = out[name + ".weight"] * scale
    return {k: v.contiguous() for k, v in out.items()}
