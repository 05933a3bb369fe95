"""The yardstick's arithmetic: model FLOPs from shapes, the bytes that bound
the pool backward and the mmgrid splat / slice, and the card's peaks.

Peaks (NVIDIA's H100 SXM data sheet, at its 700 W limit): 67 TFLOP/s in
float32 outside the tensor cores, 3.35 TB/s of HBM.  A multiply-add is two
FLOPs.  Training counts each convolution's forward, its weight gradient, and
its data gradient except the first layer's (the images need none).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from portbench.reference import models

PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def _out(size: int, k: int, s: int, p: int, dil: int = 1, ceil: bool = False) -> int:
    eff = dil * (k - 1) + 1
    if not ceil:
        return (size + 2 * p - eff) // s + 1
    out = math.ceil((size + 2 * p - eff) / s) + 1
    if p > 0 and (out - 1) * s >= size + p:  # Caffe drops a window that starts in the padding
        out -= 1
    return out


def conv_shapes(cfg: dict, size: int) -> List[Tuple[models.Conv, int, int]]:
    """(conv, output height, output width) of every convolution for a
    ``size`` x ``size`` input."""
    out = []
    if cfg["family"] == "vgg16":
        layers = {c.name: c for c in models.vgg_convs(cfg)}
        s = size
        for (name, n, _, _), ps in zip(models.VGG_STAGES, models.VGG_POOL_STRIDES):
            for i in range(1, n + 1):
                out.append((layers[f"{name}_{i}"], s, s))
            s = _out(s, 3, ps, 1, ceil=True)
        for c in layers.values():
            if c.name.startswith("fc"):
                out.append((c, s, s))
        return out
    layers = {c.name: c for c in models.resnet_convs(cfg)}
    s = _out(size, 7, 2, 3)
    out.append((layers["conv1"], s, s))
    s = _out(s, 3, 2, 1, ceil=True)
    for name, cin, w, st, _ in models.resnet_blocks(cfg):
        so = _out(s, 1, st, 0)
        if f"{name}.shortcut" in layers:
            out.append((layers[f"{name}.shortcut"], so, so))
        out += [(layers[f"{name}.conv1"], so, so), (layers[f"{name}.conv2"], so, so),
                (layers[f"{name}.conv3"], so, so)]
        s = so
    out += [(c, s, s) for c in layers.values() if c.name.startswith("fc1_voc12")]
    return out


def forward_flops(cfg: dict, size: int) -> float:
    """Convolution FLOPs of one image's forward at ``size`` x ``size``."""
    return sum(2.0 * c.cin * c.k * c.k * c.cout * h * w for c, h, w in conv_shapes(cfg, size))


def train_flops(cfg: dict, size: int) -> float:
    """Forward, weight gradient and data gradient of one image."""
    shapes = conv_shapes(cfg, size)
    fwd = [2.0 * c.cin * c.k * c.k * c.cout * h * w for c, h, w in shapes]
    return 3.0 * sum(fwd) - fwd[0]


def max_pool_shapes(cfg: dict, size: int, batch: int) -> List[Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    """(input shape, output shape) NCHW of every MAX pool of the forward."""
    out = []
    if cfg["family"] == "vgg16":
        s, ch = size, 3
        for (_, _, c, _), ps in zip(models.VGG_STAGES, models.VGG_POOL_STRIDES):
            o = _out(s, 3, ps, 1, ceil=True)
            out.append(((batch, c, s, s), (batch, c, o, o)))
            s = o
        return out
    s = _out(size, 7, 2, 3)
    return [((batch, 64, s, s), (batch, 64, _out(s, 3, 2, 1, ceil=True), _out(s, 3, 2, 1, ceil=True)))]


def pool_backward_bytes(cfg: dict, size: int, batch: int, itemsize: int = 4) -> float:
    """Bytes of the MAX pools' backward: x and dy read once, dx written once."""
    return float(sum(itemsize * (2 * np.prod(x) + np.prod(y)) for x, y in max_pool_shapes(cfg, size, batch)))


def mmgrid_geometry(h: int, w: int, sigma_xy: float = 80.0, sigma_rgb: float = 13.0) -> Dict[str, int]:
    """The grid CRF's tiling of an h x w canvas: half-cell tiles of s / 2
    pixels (s the spatial cell), gc colour bins per axis."""
    s = max(int(round(sigma_xy)), 1)
    ts = s if s % 2 else s // 2
    return {"ts": ts, "nty": -(-h // ts), "ntx": -(-w // ts), "gc": int(math.floor(255.0 / sigma_rgb)) + 2}


def mmgrid_bytes(canvas: np.ndarray, channels: int, sigma_rgb: float = 13.0) -> Tuple[float, float]:
    """(splat, slice) bytes of one filtering of ``channels`` values over a
    (N, H, W, 3) uint8 canvas: per pixel its index word, four (b, g) and
    two r weights (16 bytes), the splat's pixel order (4), its values (4 C)
    and the whole fp32 slab out; the slice's weights, the bf16 slab cells
    that some pixel of the tile reaches (2 C each) and its values out."""
    n, h, w, _ = canvas.shape
    g = mmgrid_geometry(h, w, sigma_rgb=sigma_rgb)
    ts, nty, ntx, gc = g["ts"], g["nty"], g["ntx"], g["gc"]
    img = np.zeros((n, nty * ts, ntx * ts, 3), np.float32)
    img[:, :h, :w] = canvas
    lo = np.clip(np.floor(img / np.float32(sigma_rgb)), 0, gc - 2).astype(np.int64)
    tiles = lo.reshape(n, nty, ts, ntx, ts, 3).transpose(0, 1, 3, 2, 4, 5).reshape(n * nty * ntx, ts * ts, 3)
    t, px = tiles.shape[:2]
    # the eight (b, g, r) cells around each pixel; a tile's distinct ones are what the slice reads
    cells =((tiles[..., 0][..., None] + np.array([0, 0, 0, 0, 1, 1, 1, 1])) * gc
             + tiles[..., 1][..., None] + np.array([0, 0, 1, 1, 0, 0, 1, 1])) * gc \
        + tiles[..., 2][..., None] + np.array([0, 1, 0, 1, 0, 1, 0, 1])
    keyed = cells.reshape(t, -1) + (np.arange(t, dtype=np.int64) * gc ** 3)[:, None]
    reached = len(np.unique(keyed))
    weights = 16.0 * t * px
    splat = weights + 4.0 * t * px + 4.0 * t * channels * px + 4.0 * t * gc ** 3 * channels
    slice_ = weights + 2.0 * reached * channels + 4.0 * t * channels * px
    return splat, slice_
