"""The rest of the port's CRF surface held against the JAX package on the
CPU: the DenseCRF object API and its compatibilities and unary energies,
mean_field_general's four normalisations, crf_log_refine, the learning
objectives and L-BFGS, the pydensecrf shim, grow_seeds_single, and the
packages' re-exports."""

import ast
import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsrg_tpu.ops.crf import api as japi
from dsrg_tpu.ops.crf import exact as jexact
from dsrg_tpu.ops.crf import objectives as jobj
from dsrg_tpu.ops.crf.features import bilateral_features as jbilateral
from dsrg_tpu.ops.crf.features import spatial_features as jspatial
from dsrg_tpu.ops.grow.region_grow import grow_seeds_single as jgrow
from dsrg_tpu.utils.pydensecrf_compat import dense_crf as jdense_crf
from dsrg_tpu_torch.ops.crf import api as tapi
from dsrg_tpu_torch.ops.crf import exact as texact
from dsrg_tpu_torch.ops.crf import objectives as tobj
from dsrg_tpu_torch.ops.crf.features import bilateral_features as tbilateral
from dsrg_tpu_torch.ops.crf.features import spatial_features as tspatial
from dsrg_tpu_torch.ops.grow.region_grow import grow_seeds_single as tgrow
from dsrg_tpu_torch.utils.pydensecrf_compat import dense_crf as tdense_crf

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5  # relative and absolute: the object API, mean field, crf_log_refine, the shim (fp32 sums in other orders)


def _case(seed, h=5, w=6, m=4):
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, size=(h, w, 3)).astype(np.float32)
    probs = rng.dirichlet(np.ones(m), size=h * w).astype(np.float32)
    return image, probs


def _both(w, h, m):
    return japi.DenseCRF(w, h, m), tapi.DenseCRF(w, h, m, device="cpu")


def test_dense_crf_object_api_matches_jax():
    """tests/test_crf_extended.py's CRF: every method of the object API."""
    h, w, m = 5, 6, 4
    image, probs = _case(0, h, w, m)
    crfs = _both(w, h, m)
    for crf in crfs:
        assert crf.npixels() == h * w and crf.nlabels() == m
        crf.set_unary_energy(-probs.ravel())
        crf.add_pairwise_energy(10, 8, 8, 13, 13, 13, 3, 3, 3, image.ravel().astype(np.uint8))
    jc, tc = crfs
    got = tc.inference(10)
    assert got.dtype == np.float32 and got.shape == (h * w * m,)
    np.testing.assert_allclose(got, jc.inference(10), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tc.map(10), jc.map(10))
    assert tc.map(10).dtype == np.int32

    qj, qt = jc.start_inference(), tc.start_inference()
    np.testing.assert_allclose(qt, qj, rtol=TOL, atol=TOL)
    for _ in range(3):
        qj, qt = jc.step_inference(qj), tc.step_inference(qt)
        np.testing.assert_allclose(qt, qj, rtol=TOL, atol=TOL)
        assert abs(tc.kl_divergence(qt) - jc.kl_divergence(qj)) <= TOL * max(1.0, abs(jc.kl_divergence(qj)))
    labels = probs.argmax(-1)
    labels[:3] = -1  # unlabelled pixels contribute nothing
    np.testing.assert_allclose(tc.unary_energy(labels), jc.unary_energy(labels), rtol=TOL, atol=TOL)
    for term in (-1, 0, 1):
        np.testing.assert_allclose(tc.pairwise_energy(labels, term), jc.pairwise_energy(labels, term), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("compat", ["potts", "diagonal", "matrix"])
def test_compatibilities_match_jax(compat):
    h, w, m = 4, 4, 3
    image, probs = _case(3, h, w, m)
    mat = np.random.default_rng(4).normal(size=(m, m)).astype(np.float32)
    make = {"potts": lambda mod: mod.PottsCompatibility(2.0),
            "diagonal": lambda mod: mod.DiagonalCompatibility(-np.arange(1, m + 1, dtype=np.float32)),
            "matrix": lambda mod: mod.MatrixCompatibility(mat)}[compat]
    out = []
    for mod, crf in zip((japi, tapi), _both(w, h, m)):
        crf.set_unary_energy(-probs.ravel())
        crf.add_pairwise_gaussian(3, 3, make(mod))
        crf.add_pairwise_bilateral(8, 8, 13, 13, 13, image, make(mod))
        out.append(crf.inference(3))
    np.testing.assert_allclose(out[1], out[0], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("ntype", ["no", "before", "after", "symmetric"])
def test_mean_field_general_normalizations_match_jax(ntype):
    """mean_field_general directly and through DenseCRF's
    ``normalization``, with kernel_norm_weights' (pre, post) sides."""
    h, w, m = 6, 5, 4
    image, probs = _case(5, h, w, m)
    unary = np.log(probs)
    jf = [jspatial(h, w, 3.0, 3.0), jbilateral(jnp.asarray(image), 8.0, 8.0, 13.0, 13.0, 13.0)]
    tf = [tspatial(h, w, 3.0, 3.0), tbilateral(torch.from_numpy(image), 8.0, 8.0, 13.0, 13.0, 13.0)]
    ref = jexact.mean_field_general(jnp.asarray(unary), jf, [lambda x: -3.0 * x, lambda x: -10.0 * x],
                                    n_iters=5, norm_types=[ntype, ntype])
    got = texact.mean_field_general(torch.from_numpy(unary), tf, [lambda x: -3.0 * x, lambda x: -10.0 * x],
                                    n_iters=5, norm_types=[ntype, ntype])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    # one kernel matrix for both: its diagonal's d2 = |f|^2 + |f|^2 - 2 f.f
    # cancels to an ulp of |f|^2 that the two packages round differently
    k = texact.gaussian_kernel_matrix(tf[1])
    for a, b in zip(texact.kernel_norm_weights(k, ntype), jexact.kernel_norm_weights(jnp.asarray(k.numpy()), ntype)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL)

    out = []
    for mod, crf in zip((japi, tapi), _both(w, h, m)):
        crf.set_unary_energy(-unary.ravel())
        crf.add_pairwise_gaussian(3, 3, mod.PottsCompatibility(3), normalization=ntype)
        crf.add_pairwise_bilateral(8, 8, 13, 13, 13, image, mod.PottsCompatibility(10), normalization=ntype)
        out.append(crf.inference(5))
    np.testing.assert_allclose(out[1], out[0], rtol=TOL, atol=TOL)
    with pytest.raises(ValueError):
        texact.kernel_norm_weights(k, "sideways")


def test_unary_energy_classes_match_jax():
    rng = np.random.default_rng(3)
    m, fdim, n = 4, 5, 7
    L = rng.normal(size=(m, fdim)).astype(np.float32)
    f = rng.normal(size=(fdim, n)).astype(np.float32)
    b = rng.normal(size=(m, n)).astype(np.float32)
    je, te = japi.LogisticUnaryEnergy(L, f), tapi.LogisticUnaryEnergy(L, f)
    np.testing.assert_array_equal(te.get(), je.get())
    np.testing.assert_array_equal(te.parameters(), je.parameters())
    np.testing.assert_array_equal(te.gradient(b), je.gradient(b))
    te2 = tapi.LogisticUnaryEnergy(np.zeros_like(L), f)
    te2.set_parameters(je.parameters())
    np.testing.assert_array_equal(te2.L, L)
    c = tapi.ConstUnaryEnergy(L @ f)
    np.testing.assert_array_equal(c.get(), japi.ConstUnaryEnergy(L @ f).get())
    assert c.parameters().size == 0 and c.gradient(b).size == 0
    out = []
    for mod, crf in zip((japi, tapi), _both(n, 1, m)):
        crf.set_unary(mod.LogisticUnaryEnergy(L, f))
        crf.add_pairwise_gaussian(2, 2, mod.PottsCompatibility(1.0))
        out.append(crf.inference(4))
    np.testing.assert_allclose(out[1], out[0], rtol=TOL, atol=TOL)


def test_crf_log_refine_matches_jax():
    """Forward: log of the refined marginals; backward: the reference's
    (1 - Q) * g to the probabilities and nothing to the images."""
    rng = np.random.default_rng(4)
    b, h, w, m = 2, 4, 4, 3
    images = rng.uniform(-100, 100, size=(b, 8 * h + 1, 8 * w + 1, 3)).astype(np.float32)
    logits = rng.normal(size=(b, h, w, m)).astype(np.float32)
    g = rng.normal(size=(b, h, w, m)).astype(np.float32)
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    ref, vjp = jax.vjp(lambda p: japi.crf_log_refine(p, jnp.asarray(images)), probs)
    (ref_grad,) = vjp(jnp.asarray(g))

    p = torch.tensor(np.asarray(probs), requires_grad=True)
    im = torch.from_numpy(images).requires_grad_(True)
    out = tapi.crf_log_refine(p, im)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_grad), rtol=TOL, atol=TOL)
    assert im.grad is None


def _objective_case(seed, n=60, m=5):
    rng = np.random.default_rng(seed)
    q = rng.dirichlet(np.ones(m), size=n).astype(np.float32)
    gt = rng.integers(0, m - 1, n).astype(np.int32)  # the last class never occurs
    gt[:7] = -1  # ignored
    return q, gt


@pytest.mark.parametrize("name,kwargs", [("log_likelihood", {}), ("log_likelihood", {"robust": 0.1}),
                                         ("hamming", {}), ("hamming", {"class_weight_pow": 0.5}),
                                         ("intersection_over_union", {})])
def test_objectives_and_gradients_match_jax(name, kwargs):
    q, gt = _objective_case(6)
    jfn, tfn = getattr(jobj, name), getattr(tobj, name)
    ref, ref_grad = jax.value_and_grad(lambda x: jfn(x, jnp.asarray(gt), **kwargs))(jnp.asarray(q))
    qt = torch.from_numpy(q).requires_grad_(True)
    got = tfn(qt, torch.from_numpy(gt), **kwargs)
    got.backward()
    assert got.dim() == 0
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(ref_grad), rtol=1e-4, atol=1e-4)


def test_numeric_gradient_matches_jax():
    target = np.array([0.5, -1.0, 2.0, 0.25], np.float32)
    x = np.array([0.1, 0.2, -0.3, 0.4], np.float32)
    ref = jobj.numeric_gradient(lambda v: jnp.sum(jnp.sin(v) * (v - target) ** 2), jnp.asarray(x))
    got = tobj.numeric_gradient(lambda v: torch.sum(torch.sin(v) * (v - torch.from_numpy(target)) ** 2),
                                torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_minimize_lbfgs_quadratic():
    target = torch.tensor([1.0, -2.0, 3.0])
    x0 = torch.zeros(3)
    x = tobj.minimize_lbfgs(lambda v: torch.sum((v - target) ** 2), x0, max_iters=50)
    np.testing.assert_allclose(x.numpy(), target.numpy(), atol=1e-4)
    assert not x.requires_grad and x0.abs().sum() == 0  # a copy; x0 is left alone


# tests/test_crf_learning.py's problem: Diagonal compatibility with learned
# feature scales, and a Matrix compatibility, 3 mean-field iterations
H = W = 10
M = 4
N = H * W


def _learning_problem():
    rng = np.random.default_rng(0)
    image = np.zeros((H, W, 3), np.float32)
    image[:, : W // 2] = (60, 120, 200)
    image[:, W // 2:] = (200, 80, 40)
    image += rng.normal(size=image.shape).astype(np.float32) * 6
    image = np.round(image.clip(0, 255))
    gt = np.broadcast_to(np.where(np.arange(W)[None, :] < W // 2, 1, 3), (H, W)).reshape(N).astype(np.int32)
    unary = rng.normal(size=(N, M)).astype(np.float32) * 0.5
    unary[np.arange(N), gt] += 1.0
    unary[: N // 4] = rng.normal(size=(N // 4, M)) * 0.5
    return image, unary, gt


def _jax_loss(kind, image, unary, gt):
    image, unary, gt = jnp.asarray(image), jnp.asarray(unary), jnp.asarray(gt)

    def loss(p):
        if kind == "diag":
            s_xy, s_rgb = jnp.exp(p[M]), jnp.exp(p[M + 1])
            feats = jbilateral(image, s_xy, s_xy, s_rgb, s_rgb, s_rgb)
            q = jexact.mean_field_general(unary, [feats], [lambda x: x * p[:M][None, :]], n_iters=3)
        else:
            mat = p.reshape(M, M)
            sym = 0.5 * (mat + mat.T)
            q = jexact.mean_field_general(unary, [jspatial(H, W, 2.0, 2.0)], [lambda x: jnp.dot(x, sym.T)],
                                          n_iters=3)
        return -jobj.log_likelihood(q, gt)

    return loss


def _torch_loss(kind, image, unary, gt):
    image, unary, gt = torch.from_numpy(image), torch.from_numpy(unary), torch.from_numpy(gt)

    def loss(p):
        if kind == "diag":
            s_xy, s_rgb = torch.exp(p[M]), torch.exp(p[M + 1])
            feats = tbilateral(image, s_xy, s_xy, s_rgb, s_rgb, s_rgb)
            q = texact.mean_field_general(unary, [feats], [tapi.DiagonalCompatibility(p[:M])], n_iters=3)
        else:
            q = texact.mean_field_general(unary, [tspatial(H, W, 2.0, 2.0)],
                                          [tapi.MatrixCompatibility(p.reshape(M, M))], n_iters=3)
        return -tobj.log_likelihood(q, gt)

    return loss


@pytest.mark.parametrize("kind", ["diag", "matrix"])
def test_lbfgs_learning_matches_jax(kind):
    """tests/test_crf_learning.py's two problems, 40 iterations each: the
    objective and its autograd gradient agree with JAX's at the start and
    at a point where every parameter has a gradient, and the port's final
    objective is within a tenth of JAX's gain of JAX's."""
    problem = _learning_problem()
    jloss, tloss = _jax_loss(kind, *problem), _torch_loss(kind, *problem)
    if kind == "diag":
        p0 = np.concatenate([np.zeros(M), np.log([5.0, 30.0])]).astype(np.float32)
        p1 = np.concatenate([[-0.4, 0.3, -0.2, 0.1], np.log([3.0, 20.0])]).astype(np.float32)
    else:
        p0 = np.zeros(M * M, np.float32)
        p1 = np.random.default_rng(1).normal(size=M * M).astype(np.float32) * 0.3
    for p in (p0, p1):  # at p1 the compatibility is on, and the scales have gradients
        ref, ref_grad = jax.value_and_grad(jloss)(jnp.asarray(p))
        pt = torch.tensor(p, requires_grad=True)
        got = tloss(pt)
        got.backward()
        np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(pt.grad.numpy(), np.asarray(ref_grad), rtol=1e-4, atol=1e-4)
    l0 = jloss(jnp.asarray(p0))

    j_final = float(jloss(jobj.minimize_lbfgs(jax.jit(jloss), jnp.asarray(p0), max_iters=40)))
    p_star = tobj.minimize_lbfgs(tloss, torch.from_numpy(p0), max_iters=40)
    t_final = float(tloss(p_star))
    assert j_final < float(l0) - 1e-3
    assert t_final <= j_final + 0.1 * (float(l0) - j_final), (float(l0), j_final, t_final)


@pytest.mark.parametrize("faithful_bug", [False, True])
@pytest.mark.parametrize("with_image", [True, False])
def test_pydensecrf_shim_matches_jax(faithful_bug, with_image):
    rng = np.random.default_rng(5)
    h, w, m = 6, 7, 4
    probs = rng.dirichlet(np.ones(m), size=h * w).astype(np.float32).reshape(h, w, m)
    img = rng.integers(0, 256, (h, w, 3)).astype(np.float32) if with_image else None
    ref = jdense_crf(probs, img, n_iters=3, faithful_bug=faithful_bug)
    got = tdense_crf(probs, img, n_iters=3, faithful_bug=faithful_bug, device="cpu")
    assert got.shape == (h, w, m)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=TOL, atol=TOL)
    if faithful_bug:
        assert got is probs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grow_seeds_single_matches_jax_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    h, w, m = 17, 19, 6
    labels = np.zeros(m, np.float32)
    labels[0] = 1.0
    labels[rng.choice(np.arange(1, m), 2, replace=False)] = 1.0
    cues = (rng.random((h, w, m)) < 0.04).astype(np.float32)
    logits = rng.normal(size=(h, w, m)).astype(np.float32) * 3
    logits[:, : w // 2, 0] += 4.0  # confident regions to grow through
    e = np.exp(logits - logits.max(-1, keepdims=True))
    probs = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    ref = np.asarray(jgrow(jnp.asarray(labels), jnp.asarray(cues), jnp.asarray(probs), 0.99, 0.85))
    got = tgrow(torch.from_numpy(labels), torch.from_numpy(cues), torch.from_numpy(probs), 0.99, 0.85)
    assert got.shape == (h, w, m)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (got.numpy() > cues).any()  # it grew


# every package whose JAX __init__ exports names.  The one rename: JAX's
# caffe_sgd is an optax transformation, the port's counterpart the class
# CaffeSGD.  JAX's shardings have no torch counterpart (parallel/mesh.py says
# why): the port must not export a stand-in for them.
PACKAGES = ("", "ops", "ops.crf", "ops.grow", "data", "utils", "train", "losses", "models", "parallel")
RENAMES = {("train", "caffe_sgd"): "CaffeSGD"}
NO_COUNTERPART = {("parallel", "batch_sharding"), ("parallel", "replicated_sharding")}


def _exported_names(package: str) -> list:
    path = REPO / "dsrg_tpu" / Path(*package.split(".")) / "__init__.py"
    return [a.asname or a.name for node in ast.parse(path.read_text()).body
            if isinstance(node, ast.ImportFrom) for a in node.names]


def test_port_reexports_every_name_jax_exports():
    seen = 0
    for package in PACKAGES:
        jmod = importlib.import_module("dsrg_tpu" + ("." + package if package else ""))
        tmod = importlib.import_module("dsrg_tpu_torch" + ("." + package if package else ""))
        for name in _exported_names(package):
            assert hasattr(jmod, name)
            if (package, name) in NO_COUNTERPART:
                assert not hasattr(tmod, name) and name in tmod.mesh.__doc__, (package, name)
                continue
            assert hasattr(tmod, RENAMES.get((package, name), name)), (package, name)
            seen += 1
    assert seen >= 46
    from dsrg_tpu_torch.ops.crf import CRF, DenseCRF, crf_log_refine  # noqa: F401


def test_reexports_stay_light():
    """Importing the packages builds nothing and starts no CUDA."""
    code = ("import importlib, torch\n"
            f"for p in {PACKAGES!r}: importlib.import_module('dsrg_tpu_torch' + ('.' + p if p else ''))\n"
            "from dsrg_tpu_torch import _build\n"
            "print(torch.cuda.is_initialized(), _build._libs)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "False {}", out.stdout + out.stderr
