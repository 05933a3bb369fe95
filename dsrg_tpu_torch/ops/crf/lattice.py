"""The compact sparse bilateral lattice CRF engine (``dsrg_tpu/ops/crf/lattice.py``).

The dense grid (``grid.py``) holds every cell of the 5-D (y, x, b, g, r)
volume.  This engine keeps only the occupied ones, the truncation the
reference's permutohedral lattice makes (``CRF/src/permutohedral.cpp``),
found through sorted arrays instead of a hash table:

* cell ids: the flat nearest-cell id of every pixel, sorted, duplicates
  replaced by a sentinel (the product of the dims + 10) and sorted again, so
  that the N slots hold the unique cells first;
* every lookup (the 20 blur neighbours of each slot, the 32 slice corners of
  each pixel and each pixel's own slot) is one ``torch.searchsorted(...,
  right=True)`` over those ids; JAX merges and argsorts instead
  (``_positions_in_sorted``, a TPU workaround) and gets the same integers;
* splat: ``index_add_`` of the pixel values into their slots;
* blur: five axes in turn, each adding the +-1 / +-2 neighbours found
  (a missing neighbour adds zero);
* slice: multilinear over the 32 corners, a missing corner weighted zero.
"""

from __future__ import annotations

import numpy as np
import torch

from dsrg_tpu_torch.ops.crf.grid import (_fp32_matmul, _grid_geometry, corners, gaussian_axes, grid_coords,
                                         grid_strides, nearest_cells, separable_gaussian_filter)

_F32 = torch.float32
_BLUR_R = 2
_BLUR_W = np.exp(-0.5 * np.arange(-_BLUR_R, _BLUR_R + 1) ** 2).astype(np.float32)
_OFFSETS = [o for o in range(-_BLUR_R, _BLUR_R + 1) if o != 0]


class CompactLatticePlan:
    """Image-dependent splat/blur/slice geometry over occupied cells only."""

    def __init__(self, guide: torch.Tensor, sigma_xy: float, sigma_rgb: float):
        h, w, _ = guide.shape
        self.h, self.w = h, w
        n = self.n = h * w
        gy, gx, gc, pad = _grid_geometry(h, w, sigma_xy, sigma_rgb)
        dims = (gy, gx, gc, gc, gc)
        strides = grid_strides(dims)
        coords = grid_coords(guide.to(_F32), sigma_xy, sigma_rgb, pad)
        flat = nearest_cells(coords, dims, strides)

        sentinel = int(np.prod(dims)) + 10
        sorted_flat = torch.sort(flat).values
        is_first = torch.cat([torch.ones(1, dtype=torch.bool, device=flat.device),
                              sorted_flat[1:] != sorted_flat[:-1]])
        # unique cell ids packed to the front, the sentinel tail (second sort)
        self.cells = torch.sort(torch.where(is_first, sorted_flat, sentinel)).values  # (N,)

        neighbour_ids = [self.cells + off * int(strides[axis]) for axis in range(5) for off in _OFFSETS]
        corner_ids, corner_wgt = corners(coords, dims, strides)
        queries = torch.cat(neighbour_ids + [corner_ids.reshape(-1), flat])
        pos_right = torch.searchsorted(self.cells, queries, right=True)
        slot = torch.clamp(pos_right - 1, 0, n - 1)
        valid = (pos_right > 0) & (self.cells[slot] == queries)

        k = 4 * 5 * n
        self.nb_slots = slot[:k].reshape(20, n)
        self.nb_valid = valid[:k].reshape(20, n)
        self.corner_slots = slot[k: k + 32 * n].reshape(32, n)
        self.corner_w = torch.where(valid[k: k + 32 * n].reshape(32, n), corner_wgt, 0.0)
        self.pixel_slot = slot[k + 32 * n:]
        self.blur_w = torch.from_numpy(_BLUR_W).to(guide.device)
        self.w_off = torch.from_numpy(np.asarray([_BLUR_W[o + _BLUR_R] for o in _OFFSETS],
                                                 np.float32)).to(guide.device)

    def filter(self, values: torch.Tensor) -> torch.Tensor:
        """Approximate K @ values for (H, W, C) values."""
        h, w, c = values.shape
        table = torch.zeros((self.n, c), dtype=values.dtype, device=values.device)
        table.index_add_(0, self.pixel_slot, values.reshape(self.n, c))
        n_off = len(_OFFSETS)
        with _fp32_matmul():
            for axis in range(5):
                sl = self.nb_slots[axis * n_off: (axis + 1) * n_off]
                ok = self.nb_valid[axis * n_off: (axis + 1) * n_off]
                contrib = table[sl.reshape(-1)].reshape(n_off, self.n, c)
                contrib = torch.where(ok[:, :, None], contrib, 0.0)
                table = self.blur_w[_BLUR_R] * table + torch.einsum("o,onc->nc", self.w_off, contrib)
        gathered = table[self.corner_slots.reshape(-1)].reshape(32, self.n, c)
        return (gathered * self.corner_w[:, :, None]).sum(0).reshape(h, w, c)


def mean_field_lattice(unary: torch.Tensor, image: torch.Tensor, n_iters: int = 10,
                       scale_factor: float = 1.0, color_factor: float = 13.0,
                       w_bilateral: float = 10.0, w_spatial: float = 3.0,
                       valid_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Compact-lattice mean field with the reference CRF() parameterization.

    ``valid_mask``: optional (H, W) {0, 1} mask of a padded batch member;
    invalid pixels leave both kernels (masked splat, masked symmetric
    normalisation), so a shared padded canvas is exact on the valid region.
    """
    h, w, _ = unary.shape
    unary = unary.to(_F32)
    img = torch.round(image.to(_F32))
    plan = CompactLatticePlan(img, 80.0 / scale_factor, color_factor)
    s_g = 3.0 / scale_factor
    spatial = gaussian_axes(h, w, s_g, unary.device)

    with _fp32_matmul():
        mask = (torch.ones((h, w, 1), dtype=_F32, device=unary.device) if valid_mask is None
                else valid_mask.to(_F32)[..., None])
        norm_b = torch.rsqrt(plan.filter(mask) + 1e-20)
        norm_s = torch.rsqrt(separable_gaussian_filter(mask, s_g, axes=spatial) + 1e-20)
        q = torch.softmax(unary, -1)
        for _ in range(n_iters):
            qm = q * mask
            mb = norm_b * plan.filter(norm_b * qm)
            ms = norm_s * separable_gaussian_filter(norm_s * qm, s_g, axes=spatial)
            q = torch.softmax(unary + (w_bilateral * mb + w_spatial * ms) * mask, -1)
    return q
