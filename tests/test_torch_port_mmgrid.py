"""The port's mmgrid CRF (dsrg_tpu_torch.ops.crf) held against the JAX package.

Inputs are made with numpy from a seed and fed to both.  The JAX side runs
its Pallas kernels in interpret mode on the CPU, as its own tests do; the
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


def _kernel_inputs(seed, t, px, gc, c):
    """bf16-representable one-hot-ish weights like a real plan's."""
    rng = np.random.default_rng(seed)
    wbg = (rng.random((t, px, gc * gc)) * (rng.random((t, px, gc * gc)) < 0.2)).astype(np.float32)
    values = rng.normal(size=(t, c, px)).astype(np.float32)
    wr = rng.random((t, gc, px)).astype(np.float32)
    slab = rng.normal(size=(t, gc * gc, gc * c)).astype(np.float32)
    return wbg, values, wr, slab


def _mats(gc, c):
    tile_mat = np.tile(np.eye(c, dtype=np.float32), (1, gc))
    sum_mat = np.tile(np.eye(c, dtype=np.float32), (gc, 1))
    expand = np.zeros((gc, gc * c), np.float32)
    for r in range(gc):
        expand[r, r * c: (r + 1) * c] = 1.0
    return tile_mat, sum_mat, expand


def _bf16_t(a):
    return torch.from_numpy(a).to(torch.bfloat16)


@pytest.mark.parametrize("c", [1, 21])
def test_splat_plain_matches_pallas(c):
    t, px, gc = 3, 48, 5
    wbg, values, wr, _ = _kernel_inputs(c, t, px, gc, c)
    tile_mat, _, expand = _mats(gc, c)
    bf = jnp.bfloat16
    ref = np.asarray(splat_fused(
        jnp.asarray(wbg, bf), jnp.asarray(values), jnp.asarray(wr, bf),
        jnp.asarray(expand, bf), jnp.asarray(tile_mat, bf)))
    got = mk.splat(_bf16_t(wbg), torch.from_numpy(values), _bf16_t(wr)).numpy()
    assert got.shape == ref.shape == (t, gc * gc, gc * c)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("c", [1, 21])
def test_slice_plain_matches_pallas(c):
    t, px, gc = 3, 48, 5
    wbg, _, wr, slab = _kernel_inputs(10 + c, t, px, gc, c)
    _, sum_mat, expand = _mats(gc, c)
    bf = jnp.bfloat16
    ref = np.asarray(slice_fused(
        jnp.asarray(wbg, bf), jnp.asarray(slab, bf), jnp.asarray(wr, bf),
        jnp.asarray(expand, bf), jnp.asarray(sum_mat, bf)))
    got = mk.slice(_bf16_t(wbg), _bf16_t(slab), _bf16_t(wr)).numpy()
    assert got.shape == ref.shape == (t, c, px)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_kernel_wrappers_check_inputs():
    wbg, values, wr, slab = _kernel_inputs(0, 2, 16, 3, 2)
    with pytest.raises(TypeError):
        mk.splat(torch.from_numpy(wbg), torch.from_numpy(values), _bf16_t(wr))
    with pytest.raises(ValueError):
        mk.slice(_bf16_t(wbg), _bf16_t(slab[:, :, :5]), _bf16_t(wr))
    with pytest.raises(ValueError):
        mk.splat(_bf16_t(wbg), torch.from_numpy(values[:1]), _bf16_t(wr))


def test_kernel_wrappers_cpu_path_does_not_count():
    s0, l0 = mk.splat.launches, mk.slice.launches
    wbg, values, wr, slab = _kernel_inputs(1, 2, 16, 3, 2)
    mk.splat(_bf16_t(wbg), torch.from_numpy(values), _bf16_t(wr))
    mk.slice(_bf16_t(wbg), _bf16_t(slab), _bf16_t(wr))
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
    np.testing.assert_array_equal(tp.wbg.float().numpy(), np.asarray(jp.wbg.astype(jnp.float32)))
    np.testing.assert_allclose(tp.wr_t.numpy(), np.asarray(jp.wr_t), atol=1e-6)
    np.testing.assert_allclose(tp.dy.numpy(), np.asarray(jp.dy), atol=1e-7)
