"""The dense bilateral grid CRF engine and the spatial Gaussian filter
(``dsrg_tpu/ops/crf/grid.py``).

The spatial ("Gaussian", theta_gamma) kernel needs no grid: it is an exact
truncated separable Gaussian over the image plane, two banded fp32 matrix
products (:func:`separable_gaussian_filter`, channel-last, and
:func:`separable_gaussian_filter_cf`, channel-first, which the mmgrid engine
uses).

The bilateral kernel of the ``grid`` engine (:func:`mean_field_grid`) is a
dense bilateral grid (Chen et al. 2007): splat the pixels into a coarse 5-D
(y, x, b, g, r) grid, blur each axis with a small Gaussian (five
``tensordot``s) and slice back with multilinear interpolation over the 32
corners of each pixel's cell.  :class:`GridPlan` computes the geometry once
per image.  JAX sorts the pixels by cell and takes a sorted
``segment_sum``; here the splat is an ``index_add_`` over the same sorted
order, whose sums the card makes with atomics in no fixed order (see
``tests/test_torch_port_cuda.py`` for the card-vs-CPU tolerance).  The
grid's blurs run in full fp32, as JAX's ``Precision.HIGHEST`` asks, also
when the caller allows TF32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dsrg_tpu_torch._device import full_fp32

_F32 = torch.float32


def axis_blur_matrix(length: int, sigma: float, truncate: float, device) -> torch.Tensor:
    """(length, length) banded Gaussian blur matrix exp(-0.5 (d/sigma)^2),
    built on ``device`` (fp64, rounded once to fp32 as the reference's numpy
    build does): no host build and no upload per image size."""
    r = max(int(math.ceil(truncate * sigma)), 1)
    i = torch.arange(length, dtype=torch.float64, device=device)
    d = i[:, None] - i[None, :]
    return torch.exp(-0.5 * (d / sigma) ** 2).masked_fill(d.abs() > r, 0.0).float()


def gaussian_axes(h: int, w: int, sigma: float, device, truncate: float = 4.0) -> tuple:
    """The (K_h, K_w) pair of :func:`separable_gaussian_filter_cf`, for a
    caller that filters many times at one size."""
    return axis_blur_matrix(h, sigma, truncate, device), axis_blur_matrix(w, sigma, truncate, device)


def separable_gaussian_filter_cf(x: torch.Tensor, sigma: float,
                                 truncate: float = 4.0, axes: tuple | None = None) -> torch.Tensor:
    """Unnormalized Gaussian filter over the last two (H, W) dims of
    ``(..., C, H, W)``, self term included; ``axes`` from
    :func:`gaussian_axes` when the caller already built them."""
    kh, kw = axes if axes is not None else gaussian_axes(x.shape[-2], x.shape[-1], sigma, x.device, truncate)
    # both matrices are symmetric: K_h @ x @ K_w
    return torch.matmul(torch.matmul(kh, x), kw)


def separable_gaussian_filter(x: torch.Tensor, sigma: float, truncate: float = 4.0,
                              axes: tuple | None = None) -> torch.Tensor:
    """The same filter over the (H, W) plane of a channel-last (H, W, C)."""
    kh, kw = axes if axes is not None else gaussian_axes(x.shape[0], x.shape[1], sigma, x.device, truncate)
    y = torch.tensordot(kh, x, dims=1)  # (H, W, C)
    return torch.einsum("wv,hvc->hwc", kw, y)


def _grid_geometry(h: int, w: int, sigma_xy: float, sigma_rgb: float, pad: int = 2):
    gy = int(math.ceil((h - 1) / sigma_xy)) + 1 + 2 * pad
    gx = int(math.ceil((w - 1) / sigma_xy)) + 1 + 2 * pad
    gc = int(math.ceil(255.0 / sigma_rgb)) + 1 + 2 * pad
    return gy, gx, gc, pad


def grid_coords(guide: torch.Tensor, sigma_xy: float, sigma_rgb: float, pad: int) -> torch.Tensor:
    """(H*W, 5) continuous (y, x, b, g, r) grid coordinates of a (H, W, 3)
    f32 guide.  Divides by 0-dim tensors: the card multiplies by the
    reciprocal of a Python number, an ulp away from JAX's quotient."""
    h, w, _ = guide.shape
    dev = guide.device
    s_xy = torch.tensor(sigma_xy, dtype=_F32, device=dev)
    s_rgb = torch.tensor(sigma_rgb, dtype=_F32, device=dev)
    ys = torch.arange(h, dtype=_F32, device=dev)[:, None] / s_xy + pad
    xs = torch.arange(w, dtype=_F32, device=dev)[None, :] / s_xy + pad
    return torch.stack([ys.expand(h, w), xs.expand(h, w), guide[..., 0] / s_rgb + pad,
                        guide[..., 1] / s_rgb + pad, guide[..., 2] / s_rgb + pad], -1).reshape(h * w, 5)


def grid_strides(dims) -> torch.Tensor:
    return torch.tensor([int(np.prod(dims[i + 1:])) for i in range(5)], dtype=torch.int64)


def corners(coords: torch.Tensor, dims, strides: torch.Tensor) -> tuple:
    """The 32 multilinear corners of each pixel's cell: flat cell ids
    (32, N) int64 and weights (32, N) f32."""
    dims_t = torch.tensor(dims, dtype=torch.int64, device=coords.device)
    lo = torch.minimum(torch.clamp(torch.floor(coords).long(), min=0), dims_t - 2)
    frac = coords - lo.to(_F32)
    ids, wgt = [], []
    for corner in range(32):
        bits = torch.tensor([(corner >> d) & 1 for d in range(5)], device=coords.device)
        ids.append(((lo + bits) * strides.to(coords.device)).sum(-1))
        wgt.append(torch.prod(torch.where(bits == 1, frac, 1.0 - frac), dim=-1))
    return torch.stack(ids), torch.stack(wgt)


def nearest_cells(coords: torch.Tensor, dims, strides: torch.Tensor) -> torch.Tensor:
    """(N,) int64 flat id of the cell nearest each pixel."""
    dims_t = torch.tensor(dims, dtype=torch.int64, device=coords.device)
    nearest = torch.minimum(torch.clamp(torch.round(coords).long(), min=0), dims_t - 1)
    return (nearest * strides.to(coords.device)).sum(-1)


class GridPlan:
    """Image-dependent, iteration-independent splat/slice geometry."""

    def __init__(self, guide: torch.Tensor, sigma_xy: float, sigma_rgb: float):
        h, w, _ = guide.shape
        self.h, self.w = h, w
        gy, gx, gc, pad = _grid_geometry(h, w, sigma_xy, sigma_rgb)
        self.dims = (gy, gx, gc, gc, gc)
        self.n_cells = int(np.prod(self.dims))
        coords = grid_coords(guide.to(_F32), sigma_xy, sigma_rgb, pad)
        strides = grid_strides(self.dims)
        flat_idx = nearest_cells(coords, self.dims, strides)
        # pixels sorted by cell once (stable: pixel order within a cell), as JAX's
        self.perm = torch.sort(flat_idx, stable=True).indices
        self.sorted_idx = flat_idx[self.perm]
        self.corner_idx, self.corner_w = corners(coords, self.dims, strides)  # (32, N) each
        self.blurs = [axis_blur_matrix(d, 1.0, 2.0, guide.device) for d in self.dims]

    def filter(self, values: torch.Tensor) -> torch.Tensor:
        """Approximate K @ values for (H, W, C) values."""
        h, w, c = values.shape
        flat = values.reshape(h * w, c)
        grid = torch.zeros((self.n_cells, c), dtype=flat.dtype, device=flat.device)
        grid.index_add_(0, self.sorted_idx, flat[self.perm])
        grid = grid.reshape(*self.dims, c)
        with full_fp32():
            for axis, b in enumerate(self.blurs):
                grid = torch.tensordot(b, grid.movedim(axis, 0), dims=1).movedim(0, axis)
        gathered = grid.reshape(self.n_cells, c)[self.corner_idx.reshape(-1)].reshape(32, h * w, c)
        return (gathered * self.corner_w[:, :, None]).sum(0).reshape(h, w, c)


def bilateral_grid_filter(values: torch.Tensor, guide: torch.Tensor, sigma_xy: float,
                          sigma_rgb: float) -> torch.Tensor:
    """One-shot filter (builds a fresh plan; prefer GridPlan for loops)."""
    return GridPlan(guide, sigma_xy, sigma_rgb).filter(values)


def mean_field_grid(unary: torch.Tensor, image: torch.Tensor, n_iters: int = 10,
                    scale_factor: float = 1.0, color_factor: float = 13.0,
                    w_bilateral: float = 10.0, w_spatial: float = 3.0) -> torch.Tensor:
    """Grid-approximated mean field with the reference CRF() parameterization.

    ``unary`` (H, W, M) scores; ``image`` (H, W, 3) in [0, 255], rounded.
    Returns (H, W, M) marginals.
    """
    h, w, _ = unary.shape
    unary = unary.to(_F32)
    img = torch.round(image.to(_F32))
    s_g = 3.0 / scale_factor
    plan = GridPlan(img, 80.0 / scale_factor, color_factor)
    spatial = gaussian_axes(h, w, s_g, unary.device)

    with full_fp32():
        ones = torch.ones((h, w, 1), dtype=_F32, device=unary.device)
        norm_b = torch.rsqrt(plan.filter(ones) + 1e-20)
        norm_s = torch.rsqrt(separable_gaussian_filter(ones, s_g, axes=spatial) + 1e-20)
        q = torch.softmax(unary, -1)
        for _ in range(n_iters):
            mb = norm_b * plan.filter(norm_b * q)
            ms = norm_s * separable_gaussian_filter(norm_s * q, s_g, axes=spatial)
            q = torch.softmax(unary + (w_bilateral * mb + w_spatial * ms), -1)
    return q
