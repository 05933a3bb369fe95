"""Matmul bilateral grid: full-resolution dense-CRF filtering.

Counterpart of ``dsrg_tpu/ops/crf/mmgrid.py``.  Pixels are tiled by spatial
cell.  There the (b, g) colour interpolation of each pixel is a row of a
dense weight matrix ``wbg`` (tile_px x gc^2) with 4 non-zeros, and the r
axis a dense ``wr_t`` (gc x tile_px) with 2 per column, so that splat and
slice are per-tile GEMMs.  Here the plan keeps the non-zeros only (``idx``,
``wbg4``, ``wr2`` and the pixels' order ``perm``: the layout is in
``mmgrid_kernels``) and splat and slice
are a scatter and a gather over them; ``MMGridPlan.dense_operands`` gives
``wbg`` / ``wr_t`` back, for tests and yardsticks.  The fast path resamples
the grid's spatial axes once per filter to half-cell nodes (spatial blur
folded into the down-resample matrix); ``spatial_exact`` (or an odd cell)
takes the per-pixel 4-corner bilinear path on the same two kernels with
corner-scaled r-weights.  Colour blur is three radius-2 banded products.

The JAX function filters one image and is vmapped over a batch; here the
batch is a leading dimension and the image batch folds into the kernels'
tile dimension, so one launch of each kernel serves a whole chunk.  Values
stay channel-first: (N, C, H, W) outside, (N*T, C, px) at the kernels.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dsrg_tpu_torch.ops.crf import mmgrid_kernels as mk
from dsrg_tpu_torch.ops.crf.grid import gaussian_axes, separable_gaussian_filter_cf
from dsrg_tpu_torch.utils.profiling import span

_F32 = torch.float32
_BF16 = torch.bfloat16
_CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))
_BLUR_RADIUS = 2  # of the discrete Gaussian in cell units (cell size == sigma)


def _shift_blur(g: torch.Tensor, dim: int, step: int = 1, band: torch.Tensor | None = None) -> torch.Tensor:
    """Radius-2 Gaussian along ``dim`` in strides of ``step`` elements, zero
    boundary.  ``step > 1`` blurs an axis folded inside ``dim`` (the r axis
    inside the trailing gc*C dim).  One banded matrix product per axis: a
    single pass over the grid, where the shift-add form takes a dozen.
    ``band``: the axis's :func:`_blur_band`, when the caller holds it."""
    shape = g.shape
    d = shape[dim] // step
    x = g.reshape(math.prod(shape[:dim]), d, step * math.prod(shape[dim + 1:]))
    if band is None:
        band = _blur_band(d, g.device)
    return torch.matmul(band, x).reshape(shape)


def _half_cell_matrix(n_nodes: int, n_half: int) -> np.ndarray:
    """(n_half, n_nodes) bilinear sampling at positions (j + 0.5) / 2 cells."""
    b = np.zeros((n_half, n_nodes), np.float32)
    for j in range(n_half):
        pos = (j + 0.5) / 2.0
        lo = min(int(math.floor(pos)), n_nodes - 2)
        f = pos - lo
        b[j, lo] = 1.0 - f
        b[j, lo + 1] = f
    return b


def _blur_band(n: int, device) -> torch.Tensor:
    """(n, n) banded matrix form of ``_shift_blur`` (zero boundary), built on
    ``device``: weights exp(-0.5 d^2) in fp64, rounded once to fp32."""
    i = torch.arange(n, device=device)
    d = (i[:, None] - i[None, :]).abs()
    return torch.exp(-0.5 * d.double() ** 2).masked_fill(d > _BLUR_RADIUS, 0.0).float()


class MMGridPlan:
    """Image-dependent interpolation weights for a batch of equally sized
    images; build once, filter many times."""

    def __init__(self, guide: torch.Tensor, sigma_xy: float, sigma_rgb: float,
                 spatial_exact: bool = False):
        """``guide``: (N, H, W, 3) colour images (any float/uint8 dtype)."""
        n, h, w, _ = guide.shape
        dev = guide.device
        self.n, self.h, self.w = n, h, w
        s = max(int(round(sigma_xy)), 1)  # spatial cell size in pixels
        self.s = s
        # fast path: pixels tile by half-cells (s/2 px); exact path: by cells
        self.exact = bool(spatial_exact or (s % 2 != 0))
        self.ts = ts = s if self.exact else s // 2
        nty, ntx = -(-h // ts), -(-w // ts)
        hp, wp = nty * ts, ntx * ts
        gy = -(-hp // s) + 1
        gx = -(-wp // s) + 1
        gc = int(math.floor(255.0 / sigma_rgb)) + 2
        self.nty, self.ntx, self.gy, self.gx, self.gc = nty, ntx, gy, gx, gc
        self.hp, self.wp = hp, wp
        self.n_tiles = nty * ntx
        # every axis the grid blurs, by length: built once per plan on the device
        self.bands = {d: _blur_band(d, dev) for d in {gy, gx, gc}}
        self.tile_px = ts * ts

        img = torch.round(guide.to(_F32))
        img = torch.nn.functional.pad(img, (0, 0, 0, wp - w, 0, hp - h))
        # a tensor divisor: by a Python number the card multiplies by the
        # reciprocal, an ulp away from the CPU's and the reference's quotient
        cs = self._tile(img) / torch.tensor(float(sigma_rgb), device=dev)  # (N*T, px, 3)
        lo_c = torch.clamp(torch.floor(cs), 0, gc - 2)
        fc = torch.clamp(cs - lo_c, 0.0, 1.0)  # (N*T, px, 3)
        lo_c = lo_c.to(torch.int32)
        # the sparse counterpart of the dense (N*T, px, gc^2) wbg and
        # (N*T, gc, px) wr_t: per pixel one index word, the four (b, g) corner
        # weights (fp32 product rounded once to bf16) and the two r weights
        self.idx = mk.pack_index(lo_c[..., 0], lo_c[..., 1], lo_c[..., 2], gc)  # (N*T, px)
        self.perm = mk.sort_pixels(self.idx)  # the splat walks a tile's pixels by index word
        fb, fg, fr = fc.unbind(-1)
        self.wbg4 = torch.stack(
            [(1.0 - fb) * (1.0 - fg), (1.0 - fb) * fg, fb * (1.0 - fg), fb * fg], 1).to(_BF16)
        self.wr2 = torch.stack([1.0 - fr, fr], 1)  # (N*T, 2, px) f32
        self.wr2_bf16 = self.wr2.to(_BF16)

        if self.exact:
            cell = torch.tensor(float(s), device=dev)
            ys = (torch.arange(hp, dtype=_F32, device=dev)[:, None] / cell).expand(hp, wp)
            xs = (torch.arange(wp, dtype=_F32, device=dev)[None, :] / cell).expand(hp, wp)
            fy, fx = ys - torch.floor(ys), xs - torch.floor(xs)
            sw = torch.stack([(1 - fy) * (1 - fx), (1 - fy) * fx, fy * (1 - fx), fy * fx], -1)
            self.sw = self._tile(sw.expand(n, hp, wp, 4))  # (N*T, px, 4)
        else:
            by = _half_cell_matrix(gy, nty)
            bx = _half_cell_matrix(gx, ntx)
            self.by = torch.as_tensor(by, device=dev)  # (nty, gy) slice-side up-resample
            self.bx = torch.as_tensor(bx, device=dev)
            # splat-side down-resample with the spatial blur folded in
            self.dy = self.bands[gy] @ self.by.T  # (gy, nty)
            self.dx = self.bands[gx] @ self.bx.T  # (gx, ntx)

    def dense_operands(self, wr2: torch.Tensor | None = None):
        """The dense ``wbg`` (N*T, px, gc^2) and ``wr_t`` (N*T, gc, px) bf16
        operands of the TPU kernels, ``wr_t`` from ``wr2`` (bf16) if given."""
        return mk.dense_operands(self.idx, self.wbg4, self.wr2_bf16 if wr2 is None else wr2, self.gc)

    def corner_wr2(self) -> list:
        """``spatial_exact`` path: the r weights scaled by each spatial
        corner's bilinear weight, four (N*T, 2, px) bf16 tensors."""
        return [(self.wr2 * self.sw[:, None, :, ci]).to(_BF16) for ci in range(4)]

    def _tile(self, arr: torch.Tensor) -> torch.Tensor:
        """(N, hp, wp, X) -> (N*T, tile_px, X)."""
        n, x = arr.shape[0], arr.shape[-1]
        a = arr.reshape(n, self.nty, self.ts, self.ntx, self.ts, x)
        return a.permute(0, 1, 3, 2, 4, 5).reshape(n * self.n_tiles, self.tile_px, x)

    def _tile_cf(self, arr: torch.Tensor) -> torch.Tensor:
        """(N, C, hp, wp) -> (N*T, C, tile_px)."""
        n, c = arr.shape[:2]
        a = arr.reshape(n, c, self.nty, self.ts, self.ntx, self.ts)
        return a.permute(0, 2, 4, 1, 3, 5).reshape(n * self.n_tiles, c, self.tile_px)

    def _untile_cf(self, arr: torch.Tensor) -> torch.Tensor:
        """(N*T, C, tile_px) -> (N, C, hp, wp)."""
        c = arr.shape[1]
        a = arr.reshape(self.n, self.nty, self.ntx, c, self.ts, self.ts)
        return a.permute(0, 3, 1, 4, 2, 5).reshape(self.n, c, self.hp, self.wp)

    def pad_cf(self, values: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.pad(values, (0, self.wp - self.w, 0, self.hp - self.h))

    def _color_blur(self, g: torch.Tensor, c: int, first_dim: int) -> torch.Tensor:
        """Blur (N, gy, gx, gc, gc, gc*C) along dims first_dim..4, then r."""
        for dim in range(first_dim, 5):
            g = _shift_blur(g, dim, band=self.bands[g.shape[dim]])
        return _shift_blur(g, 5, step=c, band=self.bands[self.gc])

    def filter_cf(self, values: torch.Tensor) -> torch.Tensor:
        """Approximate K @ values: (N, C, H, W) f32 -> (N, C, H, W) f32."""
        if self.exact:
            return self._filter_exact_cf(values)
        c = values.shape[1]
        n, gy, gx, gc = self.n, self.gy, self.gx, self.gc
        v = self._tile_cf(self.pad_cf(values.to(_F32))).contiguous()
        g2 = mk.splat(self.idx, self.wbg4, self.wr2_bf16, v, gc, self.perm)  # (N*T, gc^2, gc*C)
        f = gc * gc * gc * c
        g2 = g2.reshape(n, self.nty, self.ntx * f)
        grid = torch.matmul(self.dy, g2).reshape(n * gy, self.ntx, f)
        grid = torch.matmul(self.dx, grid)  # (N*gy, gx, f)
        g6 = grid.reshape(n, gy, gx, gc, gc, gc * c)
        gf = self._color_blur(g6, c, first_dim=3).reshape(n, gy, gx * f)
        up = torch.matmul(self.by, gf).reshape(n * self.nty, gx, f)
        up = torch.matmul(self.bx, up)  # (N*nty, ntx, f)
        slab = up.reshape(n * self.n_tiles, gc * gc, gc * c).to(_BF16)
        out = mk.slice(self.idx, self.wbg4, self.wr2_bf16, slab, gc)
        return self._untile_cf(out)[:, :, : self.h, : self.w]

    def _filter_exact_cf(self, values: torch.Tensor) -> torch.Tensor:
        """Per-pixel 4-corner spatial bilinear path: each corner's spatial
        weight folds into the r-weights, so the same two kernels serve it."""
        c = values.shape[1]
        n, gy, gx, gc, nty, ntx = self.n, self.gy, self.gx, self.gc, self.nty, self.ntx
        v = self._tile_cf(self.pad_cf(values.to(_F32))).contiguous()
        wr_corner = self.corner_wr2()

        grid = torch.zeros((n, gy, gx, gc * gc, gc * c), dtype=_F32, device=values.device)
        for ci, (dy, dx) in enumerate(_CORNERS):
            g2 = mk.splat(self.idx, self.wbg4, wr_corner[ci], v, gc, self.perm).reshape(n, nty, ntx, gc * gc, gc * c)
            grid[:, dy: dy + nty, dx: dx + ntx] += g2
        g6 = grid.reshape(n, gy, gx, gc, gc, gc * c)
        gf = self._color_blur(g6, c, first_dim=1).reshape(n, gy, gx, gc * gc, gc * c).to(_BF16)

        out = torch.zeros((n * self.n_tiles, c, self.tile_px), dtype=_F32, device=values.device)
        for ci, (dy, dx) in enumerate(_CORNERS):
            slab = gf[:, dy: dy + nty, dx: dx + ntx].reshape(n * self.n_tiles, gc * gc, gc * c)
            out = out + mk.slice(self.idx, self.wbg4, wr_corner[ci], slab, gc)
        return self._untile_cf(out)[:, :, : self.h, : self.w]


@span("dsrg.crf")
def mean_field_mmgrid(
    unary: torch.Tensor,
    image: torch.Tensor,
    n_iters: int = 10,
    scale_factor: float = 1.0,
    color_factor: float = 13.0,
    w_bilateral: float = 10.0,
    w_spatial: float = 3.0,
    valid_mask: torch.Tensor | None = None,
    spatial_exact: bool = False,
) -> torch.Tensor:
    """Matmul-grid mean field with the reference CRF() parameterization.

    ``unary`` (H, W, M) or (N, H, W, M) log-probabilities, ``image`` (…, H,
    W, 3), optional ``valid_mask`` (…, H, W) {0,1}: masked splat and masked
    symmetric normalization make a shared padded canvas exact for each
    image's valid region.  Returns marginals in ``unary``'s layout.
    """
    single = unary.dim() == 3
    if single:
        unary, image = unary[None], image[None]
        valid_mask = None if valid_mask is None else valid_mask[None]
    n, h, w, _ = unary.shape
    plan = MMGridPlan(image, 80.0 / scale_factor, color_factor, spatial_exact)
    s_g = 3.0 / scale_factor
    spatial = gaussian_axes(h, w, s_g, unary.device)

    unary_cf = unary.to(_F32).permute(0, 3, 1, 2)
    if valid_mask is None:
        mask = torch.ones((n, 1, h, w), dtype=_F32, device=unary.device)
    else:
        mask = valid_mask.to(_F32)[:, None]
    norm_b = torch.rsqrt(plan.filter_cf(mask) + 1e-20)
    norm_s = torch.rsqrt(separable_gaussian_filter_cf(mask, s_g, axes=spatial) + 1e-20)

    q = torch.softmax(unary_cf, dim=1)
    for _ in range(n_iters):
        qm = q * mask
        mb = norm_b * plan.filter_cf(norm_b * qm)
        ms = norm_s * separable_gaussian_filter_cf(norm_s * qm, s_g, axes=spatial)
        q = torch.softmax(unary_cf + (w_bilateral * mb + w_spatial * ms) * mask, dim=1)
    q = q.permute(0, 2, 3, 1)
    return q[0] if single else q
