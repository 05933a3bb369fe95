"""Plain PyTorch forwards of the two DeepLab families, from their published
descriptions, with the parameter names of the prototxt / flax trees.

* VGG16-LargeFOV as DSRG trains it (``train-s.prototxt``): conv1-conv5 with
  Caffe MAX pools 3x3 (stride 2, 2, 2, 1, 1; pad 1; ceil), conv5 dilated 2,
  pool5a AVE 3x3/1; four heads fc6 (3x3, 1024, dilation 6 / 12 / 18 / 24),
  fc7 (1x1, 1024), fc8-SEC (1x1, classes), summed; dropout 0.5 after each
  fc6 / fc7 ReLU in training.
* DeepLab-v2 ResNet-101 (arXiv:1606.00915): conv1 7x7/2 + BN + ReLU, MAX
  pool 3x3/2, bottlenecks (3, 4, 23, 3) with the stride on the first 1x1
  (Caffe's placement), res4 dilated 2 and res5 dilated 4 (output stride 8),
  frozen BN, four 3x3 ASPP heads (dilation 6 / 12 / 18 / 24), summed.

Tensors are NCHW inside; the forwards take and return NHWC.  Nothing here
imports the program.  Dropout draws its bytes from the caller's generator
in the order the heads run (fc6_1, fc7_1, fc6_2, ...): a byte below 128 drops
the unit, a kept unit is doubled.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class Conv:
    name: str
    cin: int
    cout: int
    k: int
    stride: int = 1
    dilation: int = 1
    bias: bool = True

    @property
    def pad(self) -> int:
        return self.dilation * (self.k // 2)


VGG_STAGES = (("conv1", 2, 64, 1), ("conv2", 2, 128, 1), ("conv3", 3, 256, 1), ("conv4", 3, 512, 1),
              ("conv5", 3, 512, 2))
VGG_POOL_STRIDES = (2, 2, 2, 1, 1)
RESNET_WIDTHS, RESNET_STRIDES, RESNET_DILATIONS = (64, 128, 256, 512), (1, 2, 1, 1), (1, 1, 2, 4)


def vgg_convs(cfg: dict) -> List[Conv]:
    out, cin = [], 3
    for name, n, ch, dil in VGG_STAGES:
        for i in range(1, n + 1):
            out.append(Conv(f"{name}_{i}", cin, ch, 3, 1, dil))
            cin = ch
    for k, dil in enumerate(cfg["head_dilations"], start=1):
        out.append(Conv(f"fc6_{k}", 512, cfg["fc6_channels"], 3, 1, dil))
        out.append(Conv(f"fc7_{k}", cfg["fc6_channels"], cfg["fc7_channels"], 1))
        out.append(Conv(f"fc8-SEC_{k}", cfg["fc7_channels"], cfg["num_classes"], 1))
    return out


def resnet_blocks(cfg: dict):
    """(block name, cin, width, stride, dilation) in order."""
    cin = 64
    for s, (n, w, st, dil) in enumerate(zip(cfg["blocks"], RESNET_WIDTHS, RESNET_STRIDES, RESNET_DILATIONS),
                                        start=2):
        for b in range(n):
            yield f"res{s}_{b}", cin, w, st if b == 0 else 1, dil
            cin = w * 4


def resnet_convs(cfg: dict) -> List[Conv]:
    out = [Conv("conv1", 3, 64, 7, 2, 1, False)]
    for name, cin, w, st, dil in resnet_blocks(cfg):
        if cin != 4 * w or st != 1:
            out.append(Conv(f"{name}.shortcut", cin, 4 * w, 1, st, 1, False))
        out += [Conv(f"{name}.conv1", cin, w, 1, st, 1, False), Conv(f"{name}.conv2", w, w, 3, 1, dil, False),
                Conv(f"{name}.conv3", w, 4 * w, 1, 1, 1, False)]
    for k, dil in enumerate(cfg["head_dilations"]):
        out.append(Conv(f"fc1_voc12_c{k}", 2048, cfg["num_classes"], 3, 1, dil, True))
    return out


def resnet_norms(cfg: dict) -> Dict[str, int]:
    """Batch-norm name -> channels."""
    out = {"bn1": 64}
    for name, cin, w, st, _ in resnet_blocks(cfg):
        if cin != 4 * w or st != 1:
            out[f"{name}.shortcut_bn"] = 4 * w
        out.update({f"{name}.bn1": w, f"{name}.bn2": w, f"{name}.bn3": 4 * w})
    return out


def convs(cfg: dict) -> List[Conv]:
    return vgg_convs(cfg) if cfg["family"] == "vgg16" else resnet_convs(cfg)


def head_names(cfg: dict) -> List[str]:
    """The convolutions whose outputs are summed into the scores."""
    return [c.name for c in convs(cfg) if c.name.startswith(("fc8", "fc1_voc12"))]


def _conv(p: dict, c: Conv, x: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, p[c.name + ".weight"], p.get(c.name + ".bias") if c.bias else None, c.stride, c.pad,
                    c.dilation)


def _dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator]) -> torch.Tensor:
    keep_from = int(round(rate * 256))
    b = torch.randint(0, 256, x.shape, dtype=torch.uint8, device=x.device, generator=gen)
    return torch.where(b >= keep_from, x * (1.0 / (1.0 - keep_from / 256.0)), torch.zeros_like(x))


def max_pool(x: torch.Tensor, stride: int) -> torch.Tensor:
    """Caffe's 3x3 pad-1 MAX pool (ceil geometry, padding never wins)."""
    return F.max_pool2d(x, 3, stride, 1, ceil_mode=True)


def vgg_forward(p: dict, cfg: dict, x: torch.Tensor, train: bool = False,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
    layers = {c.name: c for c in vgg_convs(cfg)}
    x = x.permute(0, 3, 1, 2).contiguous()
    for (name, n, _, _), ps in zip(VGG_STAGES, VGG_POOL_STRIDES):
        for i in range(1, n + 1):
            x = F.relu(_conv(p, layers[f"{name}_{i}"], x))
        x = max_pool(x, ps)
    x = F.avg_pool2d(x, 3, 1, 1)  # pool5a: a 3x3 pad-1 window always divides by 9
    scores = 0.0
    for k in range(1, len(cfg["head_dilations"]) + 1):
        h = F.relu(_conv(p, layers[f"fc6_{k}"], x))
        if train:
            h = _dropout(h, cfg["dropout_rate"], gen)
        h = F.relu(_conv(p, layers[f"fc7_{k}"], h))
        if train:
            h = _dropout(h, cfg["dropout_rate"], gen)
        scores = scores + _conv(p, layers[f"fc8-SEC_{k}"], h)
    return scores.permute(0, 2, 3, 1)


def _bn(p: dict, name: str, x: torch.Tensor, batch_stats: Optional[dict] = None) -> torch.Tensor:
    """Frozen BN; with ``batch_stats`` (calibration) the batch's statistics
    are used and recorded under ``name``."""
    if batch_stats is not None:
        mean = x.mean((0, 2, 3))
        var = torch.clamp_min((x * x).mean((0, 2, 3)) - mean * mean, 0.0)
        batch_stats[name] = (mean, var)
    else:
        mean, var = p[name + ".running_mean"], p[name + ".running_var"]
    scale = torch.rsqrt(var + 1e-5) * p[name + ".weight"]
    return (x - mean[:, None, None]) * scale[:, None, None] + p[name + ".bias"][:, None, None]


def resnet_forward(p: dict, cfg: dict, x: torch.Tensor, batch_stats: Optional[dict] = None) -> torch.Tensor:
    layers = {c.name: c for c in resnet_convs(cfg)}
    x = x.permute(0, 3, 1, 2).contiguous()
    x = max_pool(F.relu(_bn(p, "bn1", _conv(p, layers["conv1"], x), batch_stats)), 2)
    for name, cin, w, st, _ in resnet_blocks(cfg):
        short = x
        if cin != 4 * w or st != 1:
            short = _bn(p, f"{name}.shortcut_bn", _conv(p, layers[f"{name}.shortcut"], x), batch_stats)
        y = F.relu(_bn(p, f"{name}.bn1", _conv(p, layers[f"{name}.conv1"], x), batch_stats))
        y = F.relu(_bn(p, f"{name}.bn2", _conv(p, layers[f"{name}.conv2"], y), batch_stats))
        y = _bn(p, f"{name}.bn3", _conv(p, layers[f"{name}.conv3"], y), batch_stats)
        x = F.relu(y + short)
    scores = 0.0
    for k in range(len(cfg["head_dilations"])):
        scores = scores + _conv(p, layers[f"fc1_voc12_c{k}"], x)
    return scores.permute(0, 2, 3, 1)


def forward(p: dict, cfg: dict, x: torch.Tensor, train: bool = False,
            gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """(B, H, W, 3) mean-subtracted BGR -> (B, h, w, classes) scores."""
    if cfg["family"] == "vgg16":
        return vgg_forward(p, cfg, x, train, gen)
    return resnet_forward(p, cfg, x)


def lr_decay_mults(name: str):
    """Caffe's (lr_mult, decay_mult) of a parameter: the heads 10 / 20 on
    weights / biases, other biases 2, other weights 1, biases never decay,
    batch norm 0 / 0 (frozen)."""
    *path, kind = name.split(".")
    if any("bn" in part for part in path):
        return 0.0, 0.0
    is_bias = kind == "bias"
    if any(part.startswith(("fc8", "fc1_voc12")) for part in path):
        return (20.0, 0.0) if is_bias else (10.0, 1.0)
    return (2.0, 0.0) if is_bias else (1.0, 1.0)
