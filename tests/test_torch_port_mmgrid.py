"""The port's mmgrid CRF (dsrg_tpu_torch.ops.crf) held against the JAX package.

Inputs are made with numpy from a seed and fed to both.  The JAX side runs
its Pallas kernels in interpret mode on the CPU, as its own tests do, on the
dense operands that ``dense_operands`` makes of the port's sparse ones; the
port's wrappers take their plain versions for CPU tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsrg_tpu.ops.crf import mmgrid as jmm
from dsrg_tpu.ops.crf.grid import separable_gaussian_filter_cf as j_sep_cf
from dsrg_tpu.ops.crf.pallas_mmgrid import slice_fused, splat_fused
from dsrg_tpu_torch.ops.crf import mmgrid as tmm
from dsrg_tpu_torch.ops.crf import mmgrid_kernels as mk
from dsrg_tpu_torch.ops.crf.grid import separable_gaussian_filter_cf


def _sparse_inputs(seed, t, px, gc, c, edge=None, corner_scaled=False):
    """A plan's sparse operands (``mmgrid_kernels``' layout) with values and
    a slab.  ``edge`` pins every pixel to a clamped end of the colour axes:
    "top_f1" is lo = gc - 2 with f = 1 (colour 255 and above), "top_f0" is
    lo = gc - 2 with f = 0, "bottom_f0" is lo = 0 with f = 0.
    ``corner_scaled`` scales the r weights by a spatial corner weight before
    they round to bf16, as the ``spatial_exact`` path does."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, gc - 1, (3, t, px))
    f = rng.random((3, t, px)).astype(np.float32)
    if edge is not None:
        lo[:] = 0 if edge == "bottom_f0" else gc - 2
        f[:] = 1.0 if edge == "top_f1" else 0.0
    fb, fg, fr = f
    wbg4 = np.stack([(1 - fb) * (1 - fg), (1 - fb) * fg, fb * (1 - fg), fb * fg], 1)
    wr2 = np.stack([1 - fr, fr], 1)
    if corner_scaled:
        wr2 = wr2 * rng.random((t, 1, px)).astype(np.float32)
    lo_t = [torch.from_numpy(a) for a in lo]
    sparse = (mk.pack_index(*lo_t, gc), _bf16_t(wbg4), _bf16_t(wr2))
    values = rng.normal(size=(t, c, px)).astype(np.float32)
    slab = rng.normal(size=(t, gc * gc, gc * c)).astype(np.float32)
    return sparse, values, slab


def _mats(gc, c):
    tile_mat = np.tile(np.eye(c, dtype=np.float32), (1, gc))
    sum_mat = np.tile(np.eye(c, dtype=np.float32), (gc, 1))
    expand = np.zeros((gc, gc * c), np.float32)
    for r in range(gc):
        expand[r, r * c: (r + 1) * c] = 1.0
    return tile_mat, sum_mat, expand


def _bf16_t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)


def _bf16_j(a):
    """A torch bf16 tensor or a numpy array as a JAX bf16 array (exactly)."""
    if isinstance(a, torch.Tensor):
        a = a.float().numpy()
    return jnp.asarray(a, jnp.bfloat16)


def _check_splat(sparse, values, gc, c):
    """The port's splat on the sparse form against JAX's on the dense one."""
    tile_mat, _, expand = _mats(gc, c)
    wbg, wr_t = mk.dense_operands(*sparse, gc)
    ref = np.asarray(splat_fused(_bf16_j(wbg), jnp.asarray(values), _bf16_j(wr_t),
                                 _bf16_j(expand), _bf16_j(tile_mat)))
    got = mk.splat(*sparse, torch.from_numpy(values), gc, mk.sort_pixels(sparse[0])).numpy()
    assert got.shape == ref.shape == (values.shape[0], gc * gc, gc * c)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def _check_slice(sparse, slab, gc, c):
    _, sum_mat, expand = _mats(gc, c)
    wbg, wr_t = mk.dense_operands(*sparse, gc)
    ref = np.asarray(slice_fused(_bf16_j(wbg), _bf16_j(slab), _bf16_j(wr_t),
                                 _bf16_j(expand), _bf16_j(sum_mat)))
    got = mk.slice(*sparse, _bf16_t(slab), gc).numpy()
    assert got.shape == ref.shape == (slab.shape[0], c, sparse[0].shape[1])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


# tolerances: 1e-5 x max|ref|, the two sides sum in fp32 in different orders
@pytest.mark.parametrize("c", [1, 21])
def test_splat_plain_matches_pallas(c):
    t, px, gc = 3, 48, 5
    sparse, values, _ = _sparse_inputs(c, t, px, gc, c)
    _check_splat(sparse, values, gc, c)


@pytest.mark.parametrize("c", [1, 21])
def test_slice_plain_matches_pallas(c):
    t, px, gc = 3, 48, 5
    sparse, _, slab = _sparse_inputs(10 + c, t, px, gc, c)
    _check_slice(sparse, slab, gc, c)


@pytest.mark.parametrize("edge", ["top_f1", "top_f0", "bottom_f0"])
def test_kernels_at_clamped_edges_match_pallas(edge):
    t, px, gc, c = 2, 32, 5, 3
    sparse, values, slab = _sparse_inputs(20, t, px, gc, c, edge=edge)
    _check_splat(sparse, values, gc, c)
    _check_slice(sparse, slab, gc, c)


@pytest.mark.parametrize("c", [1, 21])
def test_kernels_corner_scaled_match_pallas(c):
    """The ``spatial_exact`` path's operands: r weights scaled by a spatial
    corner weight, rounded to bf16 after the product."""
    t, px, gc = 2, 48, 5
    sparse, values, slab = _sparse_inputs(30 + c, t, px, gc, c, corner_scaled=True)
    _check_splat(sparse, values, gc, c)
    _check_slice(sparse, slab, gc, c)


def test_dense_operands_layout():
    """One pixel by hand: bins (b, g, r) = (1, 2, 0) of gc = 4."""
    idx = mk.pack_index(torch.tensor([[1]]), torch.tensor([[2]]), torch.tensor([[0]]), 4)
    wbg4 = torch.tensor([[[0.5], [0.25], [0.125], [0.0625]]], dtype=torch.bfloat16)
    wr2 = torch.tensor([[[0.75], [0.25]]], dtype=torch.bfloat16)
    wbg, wr_t = mk.dense_operands(idx, wbg4, wr2, 4)
    want = np.zeros(16, np.float32)
    want[[1 * 4 + 2, 1 * 4 + 3, 2 * 4 + 2, 2 * 4 + 3]] = [0.5, 0.25, 0.125, 0.0625]
    np.testing.assert_array_equal(wbg.float().numpy()[0, 0], want)
    np.testing.assert_array_equal(wr_t.float().numpy()[0, :, 0], [0.75, 0.25, 0.0, 0.0])


def test_kernel_wrappers_check_inputs():
    (idx, wbg4, wr2), values, slab = _sparse_inputs(0, 2, 16, 3, 2)
    values, slab, perm = torch.from_numpy(values), _bf16_t(slab), mk.sort_pixels(idx)
    with pytest.raises(TypeError):
        mk.splat(idx, wbg4, wr2, values, 3, perm.long())
    with pytest.raises(TypeError):
        mk.splat(idx, wbg4.float(), wr2, values, 3, perm)
    with pytest.raises(TypeError):
        mk.slice(idx.long(), wbg4, wr2, slab, 3)
    with pytest.raises(ValueError):
        mk.slice(idx, wbg4, wr2, slab[:, :, :5], 3)
    with pytest.raises(ValueError):
        mk.splat(idx, wbg4, wr2, values[:1], 3, perm)
    with pytest.raises(ValueError):  # bins up to gc - 2 = 1 do not fit gc = 2
        mk.splat(idx, wbg4, wr2, values, 2, perm)
    with pytest.raises(ValueError):
        mk.pack_index(idx, idx, idx, 256)


def test_kernel_wrappers_cpu_path_does_not_count():
    s0, l0 = mk.splat.launches, mk.slice.launches
    sparse, values, slab = _sparse_inputs(1, 2, 16, 3, 2)
    mk.splat(*sparse, torch.from_numpy(values), 3, mk.sort_pixels(sparse[0]))
    mk.slice(*sparse, _bf16_t(slab), 3)
    assert (mk.splat.launches, mk.slice.launches) == (s0, l0)


@pytest.mark.parametrize("axis_step", [(0, 1), (2, 1), (2, 3)])
def test_shift_blur_matches_jax(axis_step):
    axis, step = axis_step
    g = np.random.default_rng(axis + step).normal(size=(5, 4, 12)).astype(np.float32)
    ref = np.asarray(jmm._shift_blur(jnp.asarray(g), axis, step))
    got = tmm._shift_blur(torch.from_numpy(g), axis, step).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("hw", [(23, 31), (40, 17)])
def test_separable_gaussian_matches_jax(hw):
    x = np.random.default_rng(hw[0]).random((3, *hw)).astype(np.float32)
    ref = np.asarray(j_sep_cf(jnp.asarray(x), 3.0))
    got = separable_gaussian_filter_cf(torch.from_numpy(x), 3.0).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def _crf_inputs(seed, h, w, m=4):
    rng = np.random.default_rng(seed)
    image = np.zeros((h, w, 3), np.float32)
    image[:, : w // 2] = [200, 60, 50]
    image[:, w // 2:] = [30, 180, 190]
    image = np.clip(image + rng.integers(-20, 20, image.shape), 0, 255).astype(np.float32)
    probs = rng.dirichlet(np.ones(m), size=(h, w)).astype(np.float32)
    probs[:, : w // 2, 0] += 1.0
    probs /= probs.sum(-1, keepdims=True)
    return np.log(probs).astype(np.float32), image


def _compare_crf(q_port, q_ref):
    assert q_port.shape == q_ref.shape
    assert np.abs(q_port - q_ref).max() <= 1e-4
    assert (q_port.argmax(-1) == q_ref.argmax(-1)).mean() == 1.0


def test_mean_field_fast_path_matches_jax():
    """sf 1 (40-px tiles, gc 21): a 96x96 image has 3x3 tiles and a ragged edge."""
    unary, image = _crf_inputs(0, 96, 96)
    ref = np.asarray(jmm.mean_field_mmgrid(jnp.asarray(unary), jnp.asarray(image), 10))
    got = tmm.mean_field_mmgrid(torch.from_numpy(unary), torch.from_numpy(image), 10).numpy()
    _compare_crf(got, ref)


def test_mean_field_spatial_exact_matches_jax():
    unary, image = _crf_inputs(1, 40, 36)
    ref = np.asarray(jmm.mean_field_mmgrid(
        jnp.asarray(unary), jnp.asarray(image), 10, scale_factor=5.0, spatial_exact=True))
    got = tmm.mean_field_mmgrid(torch.from_numpy(unary), torch.from_numpy(image), 10,
                                scale_factor=5.0, spatial_exact=True).numpy()
    _compare_crf(got, ref)


def test_mean_field_valid_mask_batch_matches_jax():
    """Two images on one padded canvas, batched in the port and one by one
    in JAX, each with its own valid-region mask."""
    h, w = 56, 64
    unaries, images, masks = [], [], []
    for i, (vh, vw) in enumerate([(56, 41), (37, 64)]):
        unary, image = _crf_inputs(5 + i, h, w)
        mask = np.zeros((h, w), np.float32)
        mask[:vh, :vw] = 1.0
        unaries.append(unary)
        images.append(image * mask[..., None])
        masks.append(mask)
    got = tmm.mean_field_mmgrid(torch.from_numpy(np.stack(unaries)),
                                torch.from_numpy(np.stack(images)), 10,
                                valid_mask=torch.from_numpy(np.stack(masks))).numpy()
    for i in range(2):
        ref = np.asarray(jmm.mean_field_mmgrid(
            jnp.asarray(unaries[i]), jnp.asarray(images[i]), 10,
            valid_mask=jnp.asarray(masks[i])))
        valid = masks[i] > 0
        _compare_crf(got[i][valid], ref[valid])


def test_plan_geometry_matches_jax():
    image = np.random.default_rng(3).integers(0, 255, (70, 90, 3)).astype(np.float32)
    jp = jmm.MMGridPlan(jnp.asarray(image), 80.0, 13.0)
    tp = tmm.MMGridPlan(torch.from_numpy(image)[None], 80.0, 13.0)
    for name in ("s", "ts", "nty", "ntx", "gy", "gx", "gc", "hp", "wp", "n_tiles", "tile_px"):
        assert getattr(tp, name) == getattr(jp, name), name
    assert tp.idx.shape == (tp.n_tiles, tp.tile_px) and tp.wbg4.shape == (tp.n_tiles, 4, tp.tile_px)
    wbg, wr_t = tp.dense_operands()
    np.testing.assert_array_equal(wbg.float().numpy(), np.asarray(jp.wbg.astype(jnp.float32)))
    np.testing.assert_array_equal(wr_t.float().numpy(),
                                  np.asarray(jp.wr_t.astype(jnp.bfloat16).astype(jnp.float32)))
    np.testing.assert_allclose(tp.dy.numpy(), np.asarray(jp.dy), atol=1e-7)


def test_plan_spatial_exact_operands_match_jax():
    """An odd cell takes the 4-corner path: the corner-scaled r weights,
    densified, are the operands the JAX plan hands its kernels."""
    image = np.random.default_rng(4).integers(0, 255, (30, 41, 3)).astype(np.float32)
    jp = jmm.MMGridPlan(jnp.asarray(image), 15.0, 13.0)
    tp = tmm.MMGridPlan(torch.from_numpy(image)[None], 15.0, 13.0)
    assert tp.exact and jp.exact
    for ci, wr2 in enumerate(tp.corner_wr2()):
        wbg, wr_t = tp.dense_operands(wr2)
        ref = (jp.wr_t * jp.sw[:, None, :, ci]).astype(jnp.bfloat16).astype(jnp.float32)
        np.testing.assert_array_equal(wr_t.float().numpy(), np.asarray(ref))
    np.testing.assert_array_equal(wbg.float().numpy(), np.asarray(jp.wbg.astype(jnp.float32)))
