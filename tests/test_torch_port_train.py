"""The port's stage-1 train step, module by module and as a whole, held
against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  The
JAX package's Pallas pool kernels run in interpret mode here.  Random
streams cannot match (threefry vs Philox), so the step parity runs with
``mirror=False`` and dropout off in both, and dropout is tested on its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsrg_tpu.config import Stage1Config as JaxStage1Config
from dsrg_tpu.data.coco import COCO_MEAN
from dsrg_tpu.losses import balanced_seed_loss as j_balanced_seed_loss
from dsrg_tpu.losses import constrain_loss as j_constrain_loss
from dsrg_tpu.losses import seed_loss as j_seed_loss
from dsrg_tpu.models import DeepLabLargeFOV as JaxLargeFOV
from dsrg_tpu.ops import interp as jinterp
from dsrg_tpu.ops import pallas_pool as jpp
from dsrg_tpu.ops import pooling as jpool
from dsrg_tpu.ops.crf import api as japi
from dsrg_tpu.ops.crf import exact as jexact
from dsrg_tpu.ops.crf import features as jfeat
from dsrg_tpu.ops.grow import dsrg_grow as j_dsrg_grow
from dsrg_tpu.ops.softmax import clamp_straight_through as j_clamp_st
from dsrg_tpu.train.optimizer import caffe_sgd, lr_poly as j_lr_poly, lr_step as j_lr_step
from dsrg_tpu.train.stage1 import make_optimizer as j_make_optimizer
from dsrg_tpu.train.stage1 import make_stage1_step as j_make_stage1_step
from dsrg_tpu.train.train_state import TrainState as JaxTrainState
from dsrg_tpu_torch.config import Stage1Config
from dsrg_tpu_torch.losses import balanced_seed_loss, constrain_loss, seed_loss
from dsrg_tpu_torch.models import DeepLabLargeFOV
from dsrg_tpu_torch.models.convert import flax_from_params, params_from_flax, state_from_flax
from dsrg_tpu_torch.ops import interp as tinterp
from dsrg_tpu_torch.ops import pool_kernels as pk
from dsrg_tpu_torch.ops import pooling as tpool
from dsrg_tpu_torch.ops.crf import api as tapi
from dsrg_tpu_torch.ops.crf import exact as texact
from dsrg_tpu_torch.ops.crf import features as tfeat
from dsrg_tpu_torch.ops.dropout import CaffeDropout, apply_dropout_bytes
from dsrg_tpu_torch.ops.grow import dsrg_grow
from dsrg_tpu_torch.ops.softmax import MIN_PROB, clamp_straight_through, floored_softmax
from dsrg_tpu_torch.train.optimizer import CaffeSGD, lr_poly, lr_step, vgg_param_mults
from dsrg_tpu_torch.train.stage1 import init_stage1, make_stage1_step
from tests.oracles.grow_oracle import grow_oracle


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nchw(a):
    return _t(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


# ---------------------------------------------------------------- pool backward

# odd and even sizes at s=2 (the Caffe last window overhangs by one at odd
# sizes), and s=1; integer data 0..2 puts several equal maxima in most windows
@pytest.mark.parametrize("shape,s", [((2, 11, 9, 5), 2), ((2, 12, 13, 5), 2), ((2, 7, 8, 5), 1),
                                     ((1, 10, 6, 3), 1)])
def test_pool_bwd_plain_matches_pallas(shape, s):
    b, h, w, c = shape
    rng = np.random.default_rng(h * w + s)
    ho, _ = jpool._caffe_pool_geometry(h, 3, s, 1)
    wo, _ = jpool._caffe_pool_geometry(w, 3, s, 1)
    x = rng.integers(0, 3, (b, h, w, c)).astype(np.float32)
    yw = rng.integers(0, 3, (b, h, wo, c)).astype(np.float32)
    g = rng.normal(size=(b, ho, wo, c)).astype(np.float32)
    gw = rng.normal(size=(b, h, wo, c)).astype(np.float32)
    ref_h = np.asarray(jpp.pool_bwd_h(jnp.asarray(yw), jnp.asarray(g), 3, s, 1))
    ref_w = np.asarray(jpp.pool_bwd_w(jnp.asarray(x), jnp.asarray(gw), 3, s, 1))
    np.testing.assert_array_equal(_nhwc(pk.pool_bwd_h(_nchw(yw), _nchw(g), 3, s, 1)), ref_h)
    np.testing.assert_array_equal(_nhwc(pk.pool_bwd_w(_nchw(x), _nchw(gw), 3, s, 1)), ref_w)


# "sas" (XLA's SelectAndScatter, the JAX default) adds a position's windows in
# another order than the kernels (t = 0..k-1): bit-equal on integer
# cotangents; "pallas" sums in the kernels' order: bit-equal on any floats
@pytest.mark.parametrize("grad_mode", ["sas", "pallas"])
@pytest.mark.parametrize("shape,s", [((2, 11, 9, 4), 2), ((1, 12, 12, 3), 2), ((2, 9, 7, 3), 1)])
def test_max_pool_train_matches_jax_vjp(shape, s, grad_mode):
    rng = np.random.default_rng(sum(shape) + s)
    x = rng.integers(0, 3, shape).astype(np.float32)
    y_ref, vjp = jax.vjp(lambda a: jpool.caffe_max_pool(a, 3, s, 1, grad_mode=grad_mode),
                         jnp.asarray(x))
    if grad_mode == "sas":
        g = rng.integers(-8, 9, y_ref.shape).astype(np.float32)
    else:
        g = rng.normal(size=y_ref.shape).astype(np.float32)
    (gx_ref,) = vjp(jnp.asarray(g))
    xt = _nchw(x).requires_grad_(True)
    y = tpool.caffe_max_pool_train(xt, 3, s, 1)
    np.testing.assert_array_equal(_nhwc(y.detach()), np.asarray(y_ref))
    np.testing.assert_array_equal(_nhwc(tpool.caffe_max_pool_nchw(_nchw(x), 3, s, 1)),
                                  np.asarray(y_ref))
    y.backward(_nchw(g))
    np.testing.assert_array_equal(_nhwc(xt.grad), np.asarray(gx_ref))


def test_pool_kernel_wrappers_check_inputs():
    yw, g = torch.zeros(1, 2, 5, 3), torch.zeros(1, 2, 3, 3)
    with pytest.raises(TypeError):
        pk.pool_bwd_h(yw.double(), g, 3, 2, 1)
    with pytest.raises(ValueError):
        pk.pool_bwd_h(yw, torch.zeros(1, 2, 3, 4), 3, 2, 1)
    with pytest.raises(ValueError):
        pk.pool_bwd_w(torch.zeros(1, 2, 5, 5), g.transpose(2, 3), 3, 2, 3)


# ---------------------------------------------------------------- small ops

def test_clamp_straight_through_value_and_grad():
    x = np.random.default_rng(0).uniform(0, 3e-4, (4, 7)).astype(np.float32)
    w = np.random.default_rng(1).normal(size=(4, 7)).astype(np.float32)
    ref, vjp = jax.vjp(lambda a: j_clamp_st(a, 1e-4), jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    got = clamp_straight_through(xt, 1e-4)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))
    got.backward(_t(w))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(w))[0]))
    np.testing.assert_array_equal(xt.grad.numpy(), w)  # identity, clamp active or not


@pytest.mark.parametrize("shape,out", [((2, 321, 321, 3), (41, 41)), ((1, 20, 13, 2), (7, 9)),
                                       ((3, 5, 1, 1), (4, 3))])
def test_zoom_bilinear_matches_jax(shape, out):
    np.testing.assert_array_equal(tinterp.zoom_matrix(shape[1], out[0]),
                                  jinterp.zoom_matrix(shape[1], out[0]))
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32) * 40
    ref = np.asarray(jinterp.zoom_bilinear(jnp.asarray(x), *out))
    got = tinterp.zoom_bilinear(_t(x), *out).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("shape,sf", [((1, 321, 321, 2), 8), ((2, 17, 25, 3), 8), ((1, 20, 20, 1), 3)])
def test_caffe_interp_shrink_matches_jax(shape, sf):
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    ref = np.asarray(jinterp.caffe_interp_shrink(jnp.asarray(x), sf))
    got = tinterp.caffe_interp_shrink(_t(x), sf).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_crf_features_match_jax():
    img = np.random.default_rng(4).integers(0, 256, (9, 11, 3)).astype(np.float32)
    np.testing.assert_allclose(tfeat.spatial_features(9, 11, 0.25, 0.25).numpy(),
                               np.asarray(jfeat.spatial_features(9, 11, 0.25, 0.25)), rtol=1e-6)
    ref = np.asarray(jfeat.bilateral_features(jnp.asarray(img), 80 / 12, 80 / 12, 13.0, 13.0, 13.0))
    got = tfeat.bilateral_features(_t(img), 80 / 12, 80 / 12, 13.0, 13.0, 13.0).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    batched = tfeat.bilateral_features(_t(np.stack([img, img[::-1]])), 2.0, 2.0, 13.0, 13.0, 13.0)
    np.testing.assert_array_equal(batched[0].numpy(),
                                  tfeat.bilateral_features(_t(img), 2.0, 2.0, 13.0, 13.0, 13.0).numpy())


def _crf_case(seed, b=2, h=12, w=10, m=5):
    """Two-colour images and probabilities that favour one class per colour
    region, as a network's do.  With i.i.d. per-pixel probabilities each
    region's mean is a near-tie between classes, which the weight-10
    bilateral messages break in whichever way fp32 rounding leans: the JAX
    package and the port then each sit up to ~1e-3 from a float64
    evaluation, and from each other."""
    rng = np.random.default_rng(seed)
    img = np.zeros((b, h, w, 3), np.float32)
    img[:, :, : w // 2] = [200, 60, 50]
    img[:, :, w // 2:] = [30, 180, 190]
    img = np.clip(img + rng.integers(-20, 20, img.shape), 0, 255).astype(np.float32)
    prefer = np.zeros((b, h, w, m))
    prefer[:, :, : w // 2, 1] = prefer[:, :, w // 2:, 3] = 1.0
    probs = 0.65 * rng.dirichlet(np.ones(m), size=(b, h, w)) + 0.35 * prefer
    return img, probs.astype(np.float32)


@pytest.mark.parametrize("fast,tol", [(False, 1e-5), (True, 1e-3)])
def test_mean_field_exact_matches_jax(fast, tol):
    img, probs = _crf_case(5)
    b, h, w, m = probs.shape
    sf = 12.0
    ref = np.stack([np.asarray(japi._crf_core(jnp.asarray(img[i]), jnp.asarray(probs[i]), 10, sf, 13.0,
                                              fast=fast)) for i in range(b)])
    got = tapi._crf_core(_t(img), _t(probs), 10, sf, 13.0, fast=fast).numpy()
    np.testing.assert_allclose(got, ref, atol=tol)
    # the kernel matrix and its norm on their own
    f = np.asarray(jfeat.bilateral_features(jnp.asarray(img[0]), 80 / sf, 80 / sf, 13.0, 13.0, 13.0))
    k_ref = np.asarray(jexact.gaussian_kernel_matrix(jnp.asarray(f)))
    k = texact.gaussian_kernel_matrix(_t(f))
    # d2 = |f_i|^2 + |f_j|^2 - 2 f_i.f_j cancels terms up to max|f|^2 (~10^3
    # with colours / 13): two fp32 products of f f^T differ there by an ulp
    # or two of that, which reaches K halved
    np.testing.assert_allclose(k.numpy(), k_ref, atol=2 * np.spacing(np.float32((f * f).sum(-1).max())))
    np.testing.assert_allclose(texact.symmetric_norm(_t(k_ref)).numpy(),
                               np.asarray(jexact.symmetric_norm(jnp.asarray(k_ref))), rtol=1e-5)


def _refine_inputs(seed):
    img, probs = _crf_case(seed, h=24, w=16)
    images = np.stack([np.kron(im, np.ones((2, 2, 1), np.float32)) for im in img])  # 48x32
    images = images - np.array([104.0, 117.0, 123.0], np.float32)
    return images, probs


@pytest.mark.parametrize("true_grad", [False, True])
def test_crf_refine_with_log_matches_jax(true_grad):
    images, probs = _refine_inputs(6)
    g = np.random.default_rng(7).normal(size=probs.shape).astype(np.float32)
    jfn = japi.crf_refine_with_log_truegrad if true_grad else japi.crf_refine_with_log
    tfn = tapi.crf_refine_with_log_truegrad if true_grad else tapi.crf_refine_with_log

    def jloss(p):
        q_log, q = jfn(p, jnp.asarray(images), 12.0, 4, False)
        return jnp.sum(q_log * g) + jnp.sum(q * 3.0), (q_log, q)

    (_, (q_log_ref, q_ref)), gp_ref = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(probs))
    pt = _t(probs).requires_grad_(True)
    q_log, q = tfn(pt, _t(images), 12.0, 4, False)
    assert not q.requires_grad
    np.testing.assert_allclose(q_log.detach().numpy(), np.asarray(q_log_ref), atol=1e-5)
    np.testing.assert_allclose(q.numpy(), np.asarray(q_ref), atol=1e-5)
    (q_log * _t(g)).sum().backward()
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(gp_ref), atol=1e-5)
    if not true_grad:  # the heuristic backward, (1 - Q) * g, whatever Q's cotangent
        np.testing.assert_allclose(pt.grad.numpy(), (1.0 - q.numpy()) * g, atol=1e-6)


def test_prepare_crf_images_matches_jax():
    images, _ = _refine_inputs(8)
    ref = np.asarray(japi.prepare_crf_images(jnp.asarray(images), 24, 16))
    np.testing.assert_array_equal(tapi.prepare_crf_images(_t(images), 24, 16).numpy(), ref)


# ---------------------------------------------------------------- region growing

def _grow_case(rng, b=3, m=7, h=15, w=17, cue_frac=0.05):
    labels = np.zeros((b, m), np.float32)
    labels[:, 0] = 1.0
    for i in range(b):
        labels[i, rng.choice(np.arange(1, m), size=3, replace=False)] = 1.0
    logits = rng.normal(size=(b, h, w, m)).astype(np.float32) * 3.0
    e = np.exp(logits - logits.max(-1, keepdims=True))
    probs = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    cues = (rng.uniform(size=(b, h, w, m)) < cue_frac).astype(np.float32) * labels[:, None, None, :]
    return labels, cues, probs


@pytest.mark.parametrize("seed,th1,th2,cue_frac", [(0, 0.99, 0.85, 0.05), (1, 0.99, 0.85, 0.05),
                                                   (2, 0.3, 0.1, 0.15), (3, 0.2, 0.6, 0.08)])
def test_dsrg_grow_matches_jax_and_oracle(seed, th1, th2, cue_frac):
    labels, cues, probs = _grow_case(np.random.default_rng(seed), cue_frac=cue_frac)
    if seed == 1:
        probs[0, 3, 4] = np.float32(0.85)  # exactly at th2: rounded as float32 in both
        cues[1, :, :, 2] = 1.0 * labels[1, 2]  # a class seeded everywhere: barriers
    got = dsrg_grow(_t(labels), _t(cues), _t(probs), th1=th1, th2=th2).numpy()
    ref = np.asarray(j_dsrg_grow(labels, cues, probs, th1=th1, th2=th2))
    np.testing.assert_array_equal(got, ref)
    for i in range(len(labels)):
        oracle = grow_oracle(labels[i], cues[i].transpose(2, 0, 1), probs[i].transpose(2, 0, 1),
                             th1=th1, th2=th2)
        np.testing.assert_array_equal(got[i].transpose(2, 0, 1), oracle)
    assert (got >= cues).all() and got.sum() > cues.sum()


# ---------------------------------------------------------------- losses

def test_losses_and_grads_match_jax():
    rng = np.random.default_rng(9)
    probs = rng.dirichlet(np.ones(6), size=(3, 5, 4)).astype(np.float32)
    smooth = rng.dirichlet(np.ones(6), size=(3, 5, 4)).astype(np.float32)
    cues = (rng.uniform(size=probs.shape) < 0.3).astype(np.float32)
    cues[2] = 0.0  # a cue-less sample: the floored counts
    for jfn, tfn in ((j_balanced_seed_loss, balanced_seed_loss), (j_seed_loss, seed_loss)):
        ref, gref = jax.value_and_grad(jfn)(jnp.asarray(probs), jnp.asarray(cues))
        pt = _t(probs).requires_grad_(True)
        got = tfn(pt, _t(cues))
        got.backward()
        np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
        np.testing.assert_allclose(pt.grad.numpy(), np.asarray(gref), rtol=1e-6, atol=1e-9)
    log_s = np.log(smooth)
    ref, (gp_ref, gs_ref) = jax.value_and_grad(j_constrain_loss, argnums=(0, 1))(
        jnp.asarray(probs), jnp.asarray(log_s))
    pt, st = _t(probs).requires_grad_(True), _t(log_s).requires_grad_(True)
    got = constrain_loss(pt, st)
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(gp_ref), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(gs_ref), rtol=1e-6, atol=1e-9)


# ---------------------------------------------------------------- optimizer

@pytest.mark.parametrize("clip", [0.0, 0.5])
def test_caffe_sgd_matches_jax_across_lr_boundary(clip):
    rng = np.random.default_rng(10)
    shapes = {"conv1_1": (3, 3, 2, 4), "fc8-SEC_1": (1, 1, 4, 3)}
    params = {n: {"kernel": rng.normal(size=s).astype(np.float32),
                  "bias": rng.normal(size=s[-1:]).astype(np.float32)} for n, s in shapes.items()}
    tx = caffe_sgd(j_lr_step(0.1, 0.33, 2), momentum=0.9, weight_decay=5e-3, clip_gradients=clip)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = tx.init(jparams)
    tparams = {k: v.clone() for k, v in params_from_flax(params).items()}
    opt = CaffeSGD(tparams, lr_step(0.1, 0.33, 2), momentum=0.9, weight_decay=5e-3,
                   clip_gradients=clip)
    for _ in range(5):  # steps 0..4: the rate changes at 2 and 4
        grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), params)
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        opt.step(params_from_flax(grads))
    assert opt.step_count == int(jstate.step) == 5
    for name, t in tparams.items():
        ref = params_from_flax(jax.tree.map(np.asarray, jparams))[name].numpy()
        np.testing.assert_allclose(t.numpy(), ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


def test_lr_schedules_match_jax():
    step_fn, poly_fn = lr_step(5e-4, 0.33, 1000), lr_poly(2.5e-4, 0.9, 8000)
    j_step, j_poly = j_lr_step(5e-4, 0.33, 1000), j_lr_poly(2.5e-4, 0.9, 8000)
    for step in (0, 1, 999, 1000, 1001, 2999, 3000, 7999):
        np.testing.assert_allclose(step_fn(step), float(j_step(jnp.asarray(step))), rtol=1e-6)
        # JAX forms 1 - step / max_iter in float32, the port in float64: an
        # ulp of 1 relative to that difference apart, at most
        rtol = 2 * np.finfo(np.float32).eps / (1 - step / 8000)
        np.testing.assert_allclose(poly_fn(step), float(j_poly(jnp.asarray(step))), rtol=rtol)


def test_vgg_param_mults_by_name():
    lr, dec = vgg_param_mults(["conv1_1.weight", "conv1_1.bias", "fc8-SEC_2.weight",
                               "fc8-SEC_2.bias", "fc7_1.bias"])
    assert lr == {"conv1_1.weight": 1.0, "conv1_1.bias": 2.0, "fc8-SEC_2.weight": 10.0,
                  "fc8-SEC_2.bias": 20.0, "fc7_1.bias": 2.0}
    assert dec == {"conv1_1.weight": 1.0, "conv1_1.bias": 0.0, "fc8-SEC_2.weight": 1.0,
                   "fc8-SEC_2.bias": 0.0, "fc7_1.bias": 0.0}


# ---------------------------------------------------------------- dropout

def test_dropout_rule_on_injected_bytes():
    x = torch.arange(1.0, 9.0)
    bytes_ = torch.tensor([0, 127, 128, 129, 255, 63, 64, 200], dtype=torch.uint8)
    # rate 0.5: keep where byte >= 128, scale 2
    np.testing.assert_array_equal(apply_dropout_bytes(x, bytes_, 0.5).numpy(),
                                  [0, 0, 6, 8, 10, 0, 0, 16])
    # rate 0.25: thresh 64, scale 1 / (1 - 64/256)
    np.testing.assert_allclose(apply_dropout_bytes(x, bytes_, 0.25).numpy(),
                               np.array([0, 2, 3, 4, 5, 0, 7, 8]) / 0.75, rtol=1e-6)
    drop = CaffeDropout(0.5)
    assert drop(x, train=False) is x and CaffeDropout(0.0)(x, train=True) is x
    gen = torch.Generator().manual_seed(0)
    y = drop(torch.ones(1_000_000), train=True, generator=gen)
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}
    assert abs((y > 0).float().mean().item() - 0.5) < 0.005


# ---------------------------------------------------------------- the whole step

NC, HEADS, CROP, CUE = 6, (2, 4), 41, 6
# thresholds and fc8 scale chosen so that region growing converts pixels in
# both steps while no refined marginal lies within 1e-3 of th1 or th2 (the
# test asserts it below): a float-rounding difference between the packages
# can then never flip a growing decision
STEP_CFG = dict(num_classes=NC, batch_size=2, crop_size=CROP, cue_size=CUE, crf_iters=3,
                mirror=False, th1=0.55, th2=0.4, stepsize=2)
FC8_SCALE = 30.0


def _step_batch(rng, b=2):
    labels = np.zeros((b, NC), np.float32)
    labels[:, 0] = 1.0
    labels[0, 2] = labels[1, 4] = labels[1, 1] = 1.0
    cues = (rng.uniform(size=(b, CUE, CUE, NC)) < 0.15).astype(np.float32) * labels[:, None, None, :]
    images = (rng.normal(size=(b, CROP, CROP, 3)) * 40).astype(np.float32)
    images[:, :, : CROP // 2] += 50.0
    return {"images": images, "labels": labels, "cues": cues}


def _jax_state_after_one_step(batch):
    """A mid-training JAX state (non-zero velocities, step 1)."""
    cfg = JaxStage1Config(**STEP_CFG)
    model = JaxLargeFOV(num_classes=NC, head_dilations=HEADS, dropout_rate=0.0)
    params = jax.jit(lambda r: model.init({"params": r}, jnp.zeros((1, CROP, CROP, 3)), train=False))(
        jax.random.PRNGKey(0))["params"]
    params = {k: ({**v, "kernel": v["kernel"] * FC8_SCALE} if k.startswith("fc8") else v)
              for k, v in params.items()}
    tx = j_make_optimizer(cfg)
    state = JaxTrainState.create(params, tx, jax.random.PRNGKey(1))
    step = jax.jit(j_make_stage1_step(model, cfg, tx))
    state, _ = step(state, batch)
    return state, step


def _port_state(jstate):
    model = DeepLabLargeFOV(num_classes=NC, head_dilations=HEADS, dropout_rate=0.0)
    cfg = Stage1Config(**STEP_CFG)
    state = init_stage1(model, cfg, device="cpu")
    state.load_state_dict(state_from_flax(jax.tree.map(np.asarray, jstate.params),
                                          jax.tree.map(np.asarray, jstate.opt_state), jstate.step))
    return state, make_stage1_step(model, cfg, state.optimizer, state.generator)


def _refined(state, batch):
    with torch.no_grad():
        probs = clamp_straight_through(floored_softmax(state.model(_t(batch["images"]))), MIN_PROB)
        return tapi.crf_refine_probs(probs, _t(batch["images"]), 12.0, STEP_CFG["crf_iters"]).numpy()


def test_stage1_two_steps_match_jax():
    batch = _step_batch(np.random.default_rng(11))
    jstate, jstep = _jax_state_after_one_step(batch)
    state, step = _port_state(jstate)
    assert state.step == 1
    seed_pixels = []
    for _ in range(2):
        q = _refined(state, batch)
        for th in (STEP_CFG["th1"], STEP_CFG["th2"]):
            assert np.abs(q - th).min() > 1e-3
        jstate, jm = jstep(jstate, batch)
        m = step(batch)
        for key in ("loss", "loss_seed", "loss_constrain", "grad_norm"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=1e-4, err_msg=key)
        assert m["seed_pixels"].item() == float(jm["seed_pixels"])
        seed_pixels.append(m["seed_pixels"].item())
    assert seed_pixels[0] > batch["cues"].sum()  # the grower converted pixels
    assert state.step == int(jstate.step) == 3
    got = flax_from_params(state.model.state_dict())  # parameters after the second step
    for name, p in jstate.params.items():
        for kind in ("kernel", "bias"):
            r = np.asarray(p[kind])
            np.testing.assert_allclose(got[name][kind], r, rtol=0,
                                       atol=1e-4 * max(np.abs(r).max(), 1e-12), err_msg=name)


def test_stage1_uint8_batch_matches_f32():
    """Raw uint8 BGR images and uint8 cues give the f32 batch's step."""
    batch = _step_batch(np.random.default_rng(13))
    raw = np.random.default_rng(14).integers(0, 256, batch["images"].shape).astype(np.uint8)
    f32 = {**batch, "images": raw.astype(np.float32) - np.array([104.0, 117.0, 123.0], np.float32)}
    u8 = {**batch, "images": raw, "cues": batch["cues"].astype(np.uint8)}
    results = []
    for b in (f32, u8):
        model = DeepLabLargeFOV(num_classes=NC, head_dilations=HEADS, dropout_rate=0.0)
        cfg = Stage1Config(**STEP_CFG)
        state = init_stage1(model, cfg, device="cpu")
        results.append({k: v.item() for k, v in
                        make_stage1_step(model, cfg, state.optimizer, state.generator)(b).items()})
    assert results[0] == results[1]


def test_stage1_uint8_batch_with_another_mean_matches_jax():
    """``input_mean``: raw uint8 BGR minus a non-VOC mean (COCO's), as JAX's
    step subtracts it; the VOC default gives another step."""
    batch = _step_batch(np.random.default_rng(15))
    raw = {**batch, "images": np.random.default_rng(16).integers(0, 256, batch["images"].shape).astype(np.uint8)}
    jstate, _ = _jax_state_after_one_step(batch)
    cfg = JaxStage1Config(**STEP_CFG)
    model = JaxLargeFOV(num_classes=NC, head_dilations=HEADS, dropout_rate=0.0)
    jstep = jax.jit(j_make_stage1_step(model, cfg, j_make_optimizer(cfg), input_mean=COCO_MEAN))
    _, jm = jstep(jstate, raw)
    metrics = []
    for mean in (COCO_MEAN, None):
        state, _ = _port_state(jstate)
        kw = {} if mean is None else {"input_mean": mean}
        metrics.append(make_stage1_step(state.model, Stage1Config(**STEP_CFG), state.optimizer, state.generator,
                                        **kw)(raw))
    for key in ("loss", "loss_seed", "loss_constrain", "grad_norm"):
        np.testing.assert_allclose(metrics[0][key].item(), float(jm[key]), rtol=1e-4, err_msg=key)
    assert metrics[0]["seed_pixels"].item() == float(jm["seed_pixels"])
    assert metrics[1]["loss"].item() != metrics[0]["loss"].item()


def test_stage1_pad_mask_reproduces_unpadded_step():
    """A padded third row (pad_mask 0) changes no metric and no parameter."""
    batch = _step_batch(np.random.default_rng(12))
    padded = {k: np.concatenate([v, v[:1] * 0.5 + 1.0]) for k, v in batch.items()}
    padded["pad_mask"] = np.array([1.0, 1.0, 0.0], np.float32)
    results = []
    for b in (batch, padded):
        model = DeepLabLargeFOV(num_classes=NC, head_dilations=HEADS, dropout_rate=0.0)
        cfg = Stage1Config(**STEP_CFG)
        state = init_stage1(model, cfg, device="cpu")
        m = make_stage1_step(model, cfg, state.optimizer, state.generator)(b)
        results.append(({k: v.item() for k, v in m.items()}, model.state_dict()))
    (m0, p0), (m1, p1) = results
    assert m0["seed_pixels"] == m1["seed_pixels"]
    for key in ("loss", "loss_seed", "loss_constrain", "grad_norm"):
        np.testing.assert_allclose(m1[key], m0[key], rtol=1e-5, err_msg=key)
    for name, t in p0.items():
        np.testing.assert_allclose(p1[name].numpy(), t.numpy(), rtol=0,
                                   atol=1e-5 * max(t.abs().max().item(), 1e-12), err_msg=name)
