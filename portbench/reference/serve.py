"""The multi-scale dump (``test-ms.py`` with ``--smooth``) of one image, in
plain PyTorch.

Per size s of (241, 321, 401): the mean-subtracted BGR image resized to s x s
(align-corners bilinear), the eval forward, its scores resized back to the
image (align-corners bilinear) and summed; the softmax floored at 1e-5
(not renormalised); then the dense CRF as the serving path defines it, a
bilateral grid (Adams et al.; the port's "mmgrid"): unary log P, 10
mean-field iterations, a bilateral term of weight 10 (position 80 px,
colour 13) on the grid and a spatial term of weight 3 (3 px) filtered
exactly and separably, both with symmetric normalisation.

The grid: pixels tile by half-cells of 40 px; each pixel's colour
(channel values / 13) falls between bins ``lo`` and ``lo + 1`` of 21 per
channel, with weights ``1 - f`` and ``f``; a tile's values are splatted to
the 8 colour corners with the (b, g) weights' products and the r weights,
each rounded to bfloat16, and the values and their products with the r
weights rounded to bfloat16 too; the tiles are resampled to the 80 px
nodes at half-cell positions with a radius-2 Gaussian (exp(-d^2 / 2)) folded
in, the colour axes blurred with the same Gaussian, resampled back to the
tiles, rounded to bfloat16, and sliced back at the same corners.  Sums are
fp32.  Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import models

BGR_MEAN = (104.0, 117.0, 123.0)
EPS = 1e-5
_BF16 = torch.bfloat16


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(_BF16).float()


def _resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, h, w, C), align-corners bilinear."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear", align_corners=True)
    return y.permute(0, 2, 3, 1)


def fused_probs(p: dict, cfg: dict, image_rgb: np.ndarray, sizes, dev) -> torch.Tensor:
    """(h, w, C) floored softmax of the summed multi-scale scores."""
    img = torch.as_tensor(np.ascontiguousarray(image_rgb), device=dev).float()
    bgr = img.flip(-1) - torch.tensor(BGR_MEAN, device=dev)
    h, w = img.shape[:2]
    total = 0.0
    with torch.no_grad():
        for s in sizes:
            scores = models.forward(p, cfg, _resize(bgr[None], s, s))
            total = total + _resize(scores, h, w)[0]
    return torch.clamp(torch.softmax(total, -1), min=EPS)


def _band(n: int, dev, radius: int = 2) -> torch.Tensor:
    i = torch.arange(n, device=dev)
    d = (i[:, None] - i[None, :]).abs()
    return torch.exp(-0.5 * d.double() ** 2).masked_fill(d > radius, 0.0).float()


def _half_cells(n_nodes: int, n_half: int, dev) -> torch.Tensor:
    """(n_half, n_nodes): linear sampling at (j + 0.5) / 2 node spacings."""
    b = torch.zeros(n_half, n_nodes, device=dev)
    for j in range(n_half):
        pos = (j + 0.5) / 2.0
        lo = min(int(math.floor(pos)), n_nodes - 2)
        b[j, lo], b[j, lo + 1] = 1.0 - (pos - lo), pos - lo
    return b


class Grid:
    """The bilateral grid of one (H, W, 3) guide."""

    def __init__(self, guide: torch.Tensor, sigma_xy: float = 80.0, sigma_rgb: float = 13.0):
        dev = guide.device
        self.h, self.w = guide.shape[:2]
        s = int(round(sigma_xy))
        self.ts = ts = s // 2
        self.nty, self.ntx = -(-self.h // ts), -(-self.w // ts)
        hp, wp = self.nty * ts, self.ntx * ts
        gy, gx = -(-hp // s) + 1, -(-wp // s) + 1
        self.gc = gc = int(math.floor(255.0 / sigma_rgb)) + 2
        img = torch.zeros(hp, wp, 3, device=dev)
        img[: self.h, : self.w] = torch.round(guide.float())
        cs = img / torch.tensor(sigma_rgb, device=dev)
        lo = torch.clamp(torch.floor(cs), 0, gc - 2)
        f = torch.clamp(cs - lo, 0.0, 1.0)
        self.lo = lo.long().reshape(-1, 3)                       # (P, 3) over the padded image
        fb, fg, fr = f.reshape(-1, 3).unbind(-1)
        self.wbg = _bf16(torch.stack([(1 - fb) * (1 - fg), (1 - fb) * fg, fb * (1 - fg), fb * fg], -1))
        self.wr = _bf16(torch.stack([1 - fr, fr], -1))           # (P, 2)
        ys, xs = torch.meshgrid(torch.arange(hp, device=dev), torch.arange(wp, device=dev), indexing="ij")
        self.tile = ((ys // ts) * self.ntx + xs // ts).reshape(-1)
        self.hp, self.wp = hp, wp
        by, bx = _half_cells(gy, self.nty, dev), _half_cells(gx, self.ntx, dev)
        self.by, self.bx = by, bx
        self.dy, self.dx = _band(gy, dev) @ by.T, _band(gx, dev) @ bx.T
        self.kc = _band(gc, dev)
        corners = [(i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1)]
        # each pixel's 8 cells as flat indices into (tiles, gc, gc, gc) and their weights
        self.cells = torch.stack([((self.tile * gc + self.lo[:, 0] + i) * gc + self.lo[:, 1] + j) * gc
                                  + self.lo[:, 2] + k for i, j, k in corners], -1)
        self.cw = torch.stack([self.wbg[:, 2 * i + j] for i, j, _ in corners], -1)   # (P, 8) (b, g) weight
        self.rw = torch.stack([self.wr[:, k] for _, _, k in corners], -1)             # (P, 8) r weight

    def filter(self, values: torch.Tensor) -> torch.Tensor:
        """Approximately K @ values for (C, H, W) values -> (C, H, W)."""
        c = values.shape[0]
        gc, nt = self.gc, self.nty * self.ntx
        v = torch.zeros(c, self.hp, self.wp, device=values.device)
        v[:, : self.h, : self.w] = values
        v = _bf16(v.reshape(c, -1).T)                               # (P, C)
        grid = torch.zeros(nt * gc ** 3, c, device=values.device)
        for n in range(8):
            grid.index_add_(0, self.cells[:, n], self.cw[:, n, None] * _bf16(v * self.rw[:, n, None]))
        g = grid.reshape(self.nty, self.ntx, gc, gc, gc, c)
        g = torch.einsum("yt,xu,tubgrc->yxbgrc", self.dy, self.dx, g)
        g = torch.einsum("ab,yxbgrc->yxagrc", self.kc, g)
        g = torch.einsum("ag,yxbgrc->yxbarc", self.kc, g)
        g = torch.einsum("ar,yxbgrc->yxbgac", self.kc, g)
        g = _bf16(torch.einsum("ty,ux,yxbgrc->tubgrc", self.by, self.bx, g)).reshape(nt * gc ** 3, c)
        out = (g[self.cells] * (self.cw * self.rw)[..., None]).sum(1)  # (P, C)
        return out.T.reshape(c, self.hp, self.wp)[:, : self.h, : self.w]


def _axis_blur(n: int, sigma: float, dev, truncate: float = 4.0) -> torch.Tensor:
    r = max(int(math.ceil(truncate * sigma)), 1)
    i = torch.arange(n, dtype=torch.float64, device=dev)
    d = i[:, None] - i[None, :]
    return torch.exp(-0.5 * (d / sigma) ** 2).masked_fill(d.abs() > r, 0.0).float()


def crf_marginals(log_probs: torch.Tensor, image_rgb: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """(h, w, C) unary log P and the (h, w, 3) image -> (h, w, C) marginals."""
    h, w, _ = log_probs.shape
    dev = log_probs.device
    grid = Grid(image_rgb)
    kh, kw = _axis_blur(h, 3.0, dev), _axis_blur(w, 3.0, dev)

    def spatial(x):
        return kh @ x @ kw

    unary = log_probs.permute(2, 0, 1)
    ones = torch.ones(1, h, w, device=dev)
    norm_b = torch.rsqrt(grid.filter(ones) + 1e-20)
    norm_s = torch.rsqrt(spatial(ones) + 1e-20)
    q = torch.softmax(unary, 0)
    for _ in range(iters):
        msg = 10.0 * norm_b * grid.filter(norm_b * q) + 3.0 * norm_s * spatial(norm_s * q)
        q = torch.softmax(unary + msg, 0)
    return q.permute(1, 2, 0)


def label_gap(p: dict, cfg: dict, image_rgb: np.ndarray, mask: np.ndarray, sizes, dev) -> float:
    """The widest gap, over the image's pixels, by which the served label's
    reference marginal lies below the reference's best."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            probs = fused_probs(p, cfg, image_rgb, sizes, dev)
            q = crf_marginals(torch.log(probs), torch.as_tensor(np.ascontiguousarray(image_rgb), device=dev))
            served = torch.as_tensor(mask.astype(np.int64), device=dev)
            if served.max() >= q.shape[-1]:
                return float("inf")
            gap = q.max(-1).values - torch.gather(q, -1, served[..., None])[..., 0]
            return float(gap.max())
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
