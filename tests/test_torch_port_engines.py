"""The port's grid, lattice and native CRF engines held against the JAX
package on the CPU.

* ``GridPlan.filter`` / ``mean_field_grid`` and ``CompactLatticePlan.filter``
  / ``mean_field_lattice`` (also with ``valid_mask``) on region-coherent
  images: marginals within 1e-4, filter outputs within 1e-4 of the largest
  output (a filter sums hundreds of pixels per cell: the packages add them
  in other orders), the lattice's lookups equal integer for integer;
* the port's native library (``dsrg_tpu_torch/native.py``, built into
  ``dsrg_tpu_torch/_build/``) gives the JAX wrapper's results bit for bit:
  the same sources and the same flags.  JAX's library is built here by
  ``native/Makefile`` in a temporary copy of ``native/``
  (:func:`jax_native_in`), so that no test writes into ``native/``.
"""

import os.path as osp
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from dsrg_tpu import native as jnative
from dsrg_tpu.ops.crf import grid as jgrid
from dsrg_tpu.ops.crf import lattice as jlat
from dsrg_tpu_torch import native as tnative
from dsrg_tpu_torch.ops.crf import grid as tgrid
from dsrg_tpu_torch.ops.crf import lattice as tlat

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def jax_native_in(tmp_dir, monkeypatch=None):
    """Build the JAX wrapper's library with ``native/Makefile`` in a copy of
    ``native/`` under ``tmp_dir`` and point ``dsrg_tpu.native`` at it (with
    ``monkeypatch``, for one test; else until the process ends)."""
    src = osp.join(str(tmp_dir), "native")
    shutil.copytree(osp.join(REPO, "native"), src, ignore=shutil.ignore_patterns("*.so"))
    subprocess.run(["make", "-C", src], check=True, capture_output=True)
    so = osp.join(src, "libdsrg_native.so")
    if monkeypatch is None:
        jnative._SO_PATH, jnative._lib = so, None
    else:
        monkeypatch.setattr(jnative, "_SO_PATH", so)
        monkeypatch.setattr(jnative, "_lib", None)
    return jnative


def _case(seed, h, w, m):
    """A three-region image with noise and unaries that favour one class per
    region, as a network's do."""
    rng = np.random.default_rng(seed)
    image = np.zeros((h, w, 3), np.float32)
    image[:, : w // 2] = [200, 60, 50]
    image[:, w // 2:] = [30, 180, 190]
    image[: h // 3, :] = [120, 120, 120]
    image = np.clip(image + rng.normal(size=image.shape) * 8, 0, 255).astype(np.float32)
    prefer = np.zeros((h, w, m))
    prefer[:, : w // 2, 1] = prefer[:, w // 2:, 2] = prefer[: h // 3, :, 3 % m] = 1.0
    probs = 0.65 * rng.dirichlet(np.ones(m), size=(h, w)) + 0.35 * prefer / prefer.sum(-1, keepdims=True)
    return image, np.log(probs).astype(np.float32)


def _assert_filter_close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("h,w", [(24, 31), (48, 40)])
def test_grid_plan_filter_matches_jax(h, w):
    image, _ = _case(0, h, w, 4)
    values = np.random.default_rng(1).random((h, w, 3)).astype(np.float32)
    jplan = jgrid.GridPlan(jax.numpy.asarray(image), 80.0, 13.0)
    tplan = tgrid.GridPlan(torch.from_numpy(image), 80.0, 13.0)
    assert tplan.dims == jplan.dims and tplan.n_cells == jplan.n_cells
    np.testing.assert_array_equal(tplan.sorted_idx.numpy(), np.asarray(jplan.sorted_idx))
    np.testing.assert_array_equal(tplan.corner_idx.numpy(), np.asarray(jplan.corner_idx))
    np.testing.assert_allclose(tplan.corner_w.numpy(), np.asarray(jplan.corner_w), rtol=0, atol=1e-6)
    _assert_filter_close(tplan.filter(torch.from_numpy(values)).numpy(), np.asarray(jplan.filter(values)))
    _assert_filter_close(tgrid.bilateral_grid_filter(torch.from_numpy(values), torch.from_numpy(image), 8.0,
                                                     20.0).numpy(),
                         np.asarray(jgrid.bilateral_grid_filter(values, image, 8.0, 20.0)))


def test_separable_gaussian_filter_matches_jax():
    x = np.random.default_rng(2).normal(size=(13, 17, 3)).astype(np.float32)
    for sigma, truncate in ((3.0, 4.0), (2.0, 5.0)):
        np.testing.assert_allclose(tgrid.separable_gaussian_filter(torch.from_numpy(x), sigma, truncate).numpy(),
                                   np.asarray(jgrid.separable_gaussian_filter(x, sigma, truncate)),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("engine", ["grid", "lattice"])
@pytest.mark.parametrize("h,w,sf", [(40, 50, 1.0), (33, 45, 2.0)])
def test_mean_field_matches_jax(engine, h, w, sf):
    image, unary = _case(3, h, w, 5)
    jfn = {"grid": jgrid.mean_field_grid, "lattice": jlat.mean_field_lattice}[engine]
    tfn = {"grid": tgrid.mean_field_grid, "lattice": tlat.mean_field_lattice}[engine]
    ref = np.asarray(jax.jit(lambda u, i: jfn(u, i, n_iters=5, scale_factor=sf))(unary, image))
    got = tfn(torch.from_numpy(unary), torch.from_numpy(image), n_iters=5, scale_factor=sf)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("h,w", [(24, 31), (48, 40)])
def test_lattice_plan_matches_jax(h, w):
    image, _ = _case(4, h, w, 4)
    values = np.random.default_rng(5).random((h, w, 3)).astype(np.float32)
    jplan = jlat.CompactLatticePlan(jax.numpy.asarray(image), 80.0, 13.0)
    tplan = tlat.CompactLatticePlan(torch.from_numpy(image), 80.0, 13.0)
    # searchsorted(right=True) gives the merge-argsort's integers
    for name in ("cells", "nb_slots", "nb_valid", "corner_slots", "pixel_slot"):
        np.testing.assert_array_equal(getattr(tplan, name).numpy(), np.asarray(getattr(jplan, name)), err_msg=name)
    np.testing.assert_allclose(tplan.corner_w.numpy(), np.asarray(jplan.corner_w), rtol=0, atol=1e-6)
    _assert_filter_close(tplan.filter(torch.from_numpy(values)).numpy(), np.asarray(jplan.filter(values)))


def test_mean_field_lattice_valid_mask_matches_jax():
    """A padded canvas with a valid region: the masked engine agrees with
    JAX on the whole canvas and, on the region, with the image alone."""
    image, unary = _case(6, 40, 48, 4)
    mask = np.zeros((40, 48), np.float32)
    mask[:29, :37] = 1.0
    ref = np.asarray(jlat.mean_field_lattice(unary, image, n_iters=5, valid_mask=mask))
    got = tlat.mean_field_lattice(torch.from_numpy(unary), torch.from_numpy(image), n_iters=5,
                                  valid_mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    alone = tlat.mean_field_lattice(torch.from_numpy(unary[:29, :37]).contiguous(),
                                    torch.from_numpy(image[:29, :37]).contiguous(), n_iters=5).numpy()
    assert (alone.argmax(-1) == got[:29, :37].argmax(-1)).mean() > 0.99


def test_engines_keep_tf32_off_for_their_products(monkeypatch):
    """The grid's and the lattice's products run in full fp32 (JAX asks for
    HIGHEST) whatever the caller allows, and the caller's setting comes back."""
    seen = []
    real = torch.tensordot

    def spy(*a, **k):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(*a, **k)

    monkeypatch.setattr(torch, "tensordot", spy)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        image, unary = _case(7, 20, 24, 3)
        tgrid.mean_field_grid(torch.from_numpy(unary), torch.from_numpy(image), n_iters=1)
        assert seen and not any(seen)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


# ---------------------------------------------------------------- native


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    yield jax_native_in(tmp_path_factory.mktemp("jax_native"), mp)
    mp.undo()


def test_native_library_builds_into_the_ports_build_dir():
    path = tnative.build()
    assert path.parent == tnative.BUILD_DIR and path.name.startswith("libdsrg_native-")
    assert path == tnative.library_path(tnative.flags(tnative._cxx())) and path.exists()


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A failed compile raises with the compiler's words; nothing falls back."""
    (tmp_path / "crf_cpu.cpp").write_text("this is not C++\n")
    for name in ("region_grow.cpp", "permutohedral_cpu.cpp"):
        shutil.copy(osp.join(REPO, "native", name), tmp_path / name)
    monkeypatch.setattr(tnative, "SOURCE_DIR", tmp_path)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="native build failed"):
        tnative.build()
    assert not list((tmp_path / "_build").glob("*.so"))


def test_native_serial_build_equals_the_openmp_build(tmp_path, monkeypatch):
    """Where the compiler has no OpenMP the library builds without it (as
    ``make OMPFLAGS=`` does), under another name, and gives the same bits."""
    image, unary = _case(9, 17, 23, 4)
    ref = tnative.crf_cpu(image, unary, maxiter=3)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tnative, "_has_openmp", lambda cxx: False)
    monkeypatch.setattr(tnative, "_lib", None)
    flags = tnative.flags(tnative._cxx())
    assert "-fopenmp" not in flags and (tmp_path / "_build" / "serial_include" / "omp.h").exists()
    assert tnative.build() == tnative.library_path(flags) != tnative.library_path(tnative.CXX_FLAGS +
                                                                                 tnative.OMP_FLAGS)
    assert np.array_equal(tnative.crf_cpu(image, unary, maxiter=3), ref)


def test_native_functions_equal_jax_bit_for_bit(jax_native):
    rng = np.random.default_rng(8)
    image, unary = _case(8, 21, 26, 5)
    for sf in (1.0, 12.0):
        for fn in ("crf_cpu", "crf_permutohedral"):
            got = getattr(tnative, fn)(image, unary, maxiter=4, scale_factor=sf)
            ref = getattr(jax_native, fn)(image, unary, maxiter=4, scale_factor=sf)
            assert got.dtype == np.float32 and np.array_equal(got, ref), (fn, sf)
    feats = rng.random((300, 5)).astype(np.float32) * 4
    values = rng.random((300, 3)).astype(np.float32)
    assert np.array_equal(tnative.permutohedral_filter(feats, values), jax_native.permutohedral_filter(feats, values))
    m, h, w = 5, 9, 11
    labels = np.array([1, 0, 1, 1, 0], np.float32)
    cues = (rng.random((m, h, w)) < 0.1).astype(np.float32)
    probs = rng.dirichlet(np.ones(m), size=(h, w)).transpose(2, 0, 1).astype(np.float32)
    for th in ((0.99, 0.85), (0.5, 0.3)):
        assert np.array_equal(tnative.region_grow_cpu(labels, cues, probs, *th),
                              jax_native.region_grow_cpu(labels, cues, probs, *th))
