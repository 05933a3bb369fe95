"""The port's bfloat16 configuration held against the JAX package on the CPU.

``compute_dtype=bfloat16`` reaches the model (bf16 activations, fp32
parameters, fp32 scores), the max pools' kernels (their plain versions
here, bit for bit against the Pallas kernels in interpret mode), the fast
CRF and both train steps.  Inputs are made with numpy from a seed and handed
to both packages.  Where two packages round to bf16 at different places
(a convolution's bias added inside or after it, a sum's order), the
tolerance is stated beside the test with what it was measured at.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dsrg_tpu.config import Stage1Config as JaxStage1Config
from dsrg_tpu.config import Stage2Config as JaxStage2Config
from dsrg_tpu.models import DeepLabLargeFOV as JaxLargeFOV
from dsrg_tpu.ops import pallas_pool as jpp
from dsrg_tpu.ops import pooling as jpool
from dsrg_tpu.ops.crf import exact as jexact
from dsrg_tpu.ops.crf import features as jfeat
from dsrg_tpu.train import stage2 as jstage2
from dsrg_tpu.train.stage1 import make_optimizer as j_make_optimizer
from dsrg_tpu.train.stage1 import make_stage1_step as j_make_stage1_step
from dsrg_tpu.train.train_state import TrainState as JaxTrainState
from dsrg_tpu_torch.config import Stage1Config, Stage2Config
from dsrg_tpu_torch.models import DeepLabLargeFOV
from dsrg_tpu_torch.models.convert import flax_from_params, params_from_flax, state_from_flax
from dsrg_tpu_torch.ops import pool_kernels as pk
from dsrg_tpu_torch.ops import pooling as tpool
from dsrg_tpu_torch.ops.crf import api as tapi
from dsrg_tpu_torch.ops.crf import exact as texact
from dsrg_tpu_torch.ops.crf import features as tfeat
from dsrg_tpu_torch.ops.softmax import MIN_PROB, clamp_straight_through, floored_softmax
from dsrg_tpu_torch.train.stage1 import init_stage1, make_stage1_step
from dsrg_tpu_torch.train.stage1 import make_optimizer as s1_make_optimizer
from dsrg_tpu_torch.train.stage2 import init_stage2, make_stage2_step
from dsrg_tpu_torch.train.stage2 import make_optimizer as s2_make_optimizer

BF16 = torch.bfloat16


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nchw_bf16(a):
    return _t(a).permute(0, 3, 1, 2).to(BF16)


def _nhwc_f32(t):
    return t.float().permute(0, 2, 3, 1).numpy()


# ---------------------------------------------------------------- pool backward

# odd and even sizes at s = 2, and s = 1, where an element can be the first
# maximum of three windows; integer inputs 0..2 make ties everywhere, normal
# cotangents make the order and the rounding of the sums show
@pytest.mark.parametrize("shape,s", [((2, 11, 9, 5), 2), ((2, 12, 13, 5), 2), ((2, 7, 8, 5), 1),
                                     ((1, 10, 6, 3), 1)])
def test_pool_bwd_plain_bf16_matches_pallas(shape, s):
    b, h, w, c = shape
    rng = np.random.default_rng(h * w + s)
    ho, _ = jpool._caffe_pool_geometry(h, 3, s, 1)
    wo, _ = jpool._caffe_pool_geometry(w, 3, s, 1)
    x = rng.integers(0, 3, (b, h, w, c)).astype(np.float32)
    yw = rng.integers(0, 3, (b, h, wo, c)).astype(np.float32)
    g = rng.normal(size=(b, ho, wo, c)).astype(np.float32)
    gw = rng.normal(size=(b, h, wo, c)).astype(np.float32)
    bf = jnp.bfloat16
    ref_h = jpp.pool_bwd_h(jnp.asarray(yw, bf), jnp.asarray(g, bf), 3, s, 1)
    ref_w = jpp.pool_bwd_w(jnp.asarray(x, bf), jnp.asarray(gw, bf), 3, s, 1)
    assert ref_h.dtype == ref_w.dtype == bf
    got_h = pk.pool_bwd_h(_nchw_bf16(yw), _nchw_bf16(g), 3, s, 1)
    got_w = pk.pool_bwd_w(_nchw_bf16(x), _nchw_bf16(gw), 3, s, 1)
    assert got_h.dtype == got_w.dtype == BF16
    np.testing.assert_array_equal(_nhwc_f32(got_h), np.asarray(ref_h.astype(jnp.float32)))
    np.testing.assert_array_equal(_nhwc_f32(got_w), np.asarray(ref_w.astype(jnp.float32)))
    if s == 1:  # some element takes three windows, and one rounding per add is what matches
        ones = torch.ones((b, c, h, wo), dtype=BF16)
        assert pk.pool_bwd_w(_nchw_bf16(x), ones, 3, s, 1).max().item() == 3.0
        once = pk.pool_bwd_w_plain(_nchw_bf16(x).float(), _nchw_bf16(gw).float(), 3, s, 1).to(BF16)
        assert not torch.equal(once, got_w)


@pytest.mark.parametrize("shape,s", [((2, 11, 9, 4), 2), ((2, 9, 7, 3), 1)])
def test_max_pool_train_bf16_matches_jax_vjp(shape, s):
    rng = np.random.default_rng(sum(shape) + s)
    x = jnp.asarray(rng.integers(0, 3, shape), jnp.bfloat16)
    y_ref, vjp = jax.vjp(lambda a: jpool.caffe_max_pool(a, 3, s, 1, grad_mode="pallas"), x)
    g = rng.normal(size=y_ref.shape).astype(np.float32)
    (gx_ref,) = vjp(jnp.asarray(g, jnp.bfloat16))
    xt = _nchw_bf16(np.asarray(x.astype(jnp.float32))).requires_grad_(True)
    y = tpool.caffe_max_pool_train(xt, 3, s, 1)
    assert y.dtype == BF16
    np.testing.assert_array_equal(_nhwc_f32(y.detach()), np.asarray(y_ref.astype(jnp.float32)))
    y.backward(_nchw_bf16(g))
    assert xt.grad.dtype == BF16
    np.testing.assert_array_equal(_nhwc_f32(xt.grad), np.asarray(gx_ref.astype(jnp.float32)))


def _explicit_max_pool(x, k, s, p):
    """The form the port used before implicit padding: -inf padded copies."""
    oh, ph = tpool._caffe_pool_geometry(x.shape[2], k, s, p)
    ow, pw = tpool._caffe_pool_geometry(x.shape[3], k, s, p)
    return F.max_pool2d(tpool._pad_hw(x, ph, pw, float("-inf")), k, s)[:, :, :oh, :ow]


def _bits(t):
    return t.view(torch.int16 if t.dtype == BF16 else torch.int32)


# every size a pool of the models sees at 321^2 and small ones down to 1,
# with NaN and +-inf in the input; (2, 3, 0) is the one geometry left to
# explicit padding (a window smaller than its stride at pad 0)
@pytest.mark.parametrize("k,s,p", [(3, 1, 1), (3, 2, 1), (2, 3, 0)])
@pytest.mark.parametrize("size", [321, 161, 81, 41, 9, 4, 3, 2, 1])
def test_implicit_pad_forward_matches_jax_and_explicit(size, k, s, p):
    rng = np.random.default_rng(size + 7 * s)
    x = rng.normal(size=(1, size, size + 1, 2)).astype(np.float32)
    u = rng.random(x.shape)
    x[u < 0.05] = np.nan
    x[(u >= 0.05) & (u < 0.1)] = np.inf
    x[(u >= 0.1) & (u < 0.3)] = -np.inf
    for dtype, jdtype in ((torch.float32, jnp.float32), (BF16, jnp.bfloat16)):
        xt = _t(x).permute(0, 3, 1, 2).to(dtype)
        ref = np.asarray(jpool.caffe_max_pool(jnp.asarray(x, jdtype), k, s, p).astype(jnp.float32))
        got = tpool.caffe_max_pool_nchw(xt, k, s, p)
        assert torch.equal(_bits(got), _bits(_explicit_max_pool(xt, k, s, p)))
        np.testing.assert_array_equal(_nhwc_f32(got), ref)
        train = tpool.caffe_max_pool_train(xt, k, s, p)  # the separable form: NaN payloads may differ
        assert train.dtype == dtype
        np.testing.assert_array_equal(_nhwc_f32(train), ref)
        yw = tpool._max_pool_pass(xt, 3, k, s, p)  # the width the W pass saves for pool_bwd_h
        assert yw.shape[3] == tpool._caffe_pool_geometry(xt.shape[3], k, s, p)[0]


# ---------------------------------------------------------------- the model

def _models(m=6, heads=(2, 4), size=41):
    jm = JaxLargeFOV(num_classes=m, head_dilations=heads, compute_dtype=jnp.bfloat16)
    params = jax.jit(lambda r: jm.init({"params": r}, jnp.zeros((1, size, size, 3)), train=False))(
        jax.random.PRNGKey(0))["params"]
    tm = DeepLabLargeFOV(num_classes=m, head_dilations=heads, compute_dtype=BF16)
    tm.load_state_dict(params_from_flax(params))
    return jm, params, tm.eval()


# bf16 keeps 8 significant bits.  Flax adds a convolution's bias after the
# bf16 product and XLA and ATen sum in other orders, so the two packages
# round at other places through the 18 convolutions: each sits ~1% of the
# scores' scale from the fp32 forward and 1.2-1.4% from the other (measured
# at 65x63); the test holds 3% of the scale
@pytest.mark.parametrize("masked", [False, True])
def test_largefov_bf16_forward_matches_flax(masked):
    jm, params, tm = _models()
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(2, 41, 39, 3)) * 40).astype(np.float32)
    valid = np.array([[41, 30], [25, 39]], np.float32) if masked else None
    ref = np.asarray(jax.jit(lambda p, a, v: jm.apply({"params": p}, a, train=False, valid_hw=v))(
        params, jnp.asarray(x), None if valid is None else jnp.asarray(valid)))
    with torch.no_grad():
        got = tm(_t(x), valid_hw=None if valid is None else _t(valid))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=3e-2 * np.abs(ref).max())


def test_largefov_bf16_runs_bf16_convolutions(monkeypatch):
    """Every convolution takes bf16 activations and bf16 copies of the fp32
    parameters; the scores come back fp32, the gradients reach the fp32
    parameters, and the pools' backward runs in bf16."""
    seen, pooled = [], []
    conv2d, route = F.conv2d, pk.pool_bwd_w_plain

    def spy_conv(x, w, b, *args):
        seen.append((x.dtype, w.dtype, b.dtype))
        return conv2d(x, w, b, *args)

    def spy_route(x, gw, *args):
        pooled.append((x.dtype, gw.dtype))
        return route(x, gw, *args)

    monkeypatch.setattr(F, "conv2d", spy_conv)
    monkeypatch.setattr(pk, "pool_bwd_w_plain", spy_route)
    tm = DeepLabLargeFOV(num_classes=3, head_dilations=(2,), dropout_rate=0.5, compute_dtype=BF16)
    x = _t((np.random.default_rng(8).normal(size=(2, 33, 35, 3)) * 40).astype(np.float32))
    scores = tm(x, train=True, generator=torch.Generator().manual_seed(0))
    assert scores.dtype == torch.float32
    assert len(seen) == 16 and set(seen) == {(BF16, BF16, BF16)}
    scores.square().sum().backward()
    assert pooled == [(BF16, BF16)] * 5
    for name, p in tm.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, name
        assert torch.isfinite(p.grad).all(), name


# ---------------------------------------------------------------- the fast CRF

def test_mean_field_exact_fast_matches_jax():
    """bf16 kernel matrices and operands, fp32 sums: against JAX's
    ``fast=True`` to 1e-3 (the bf16 rounding of the same values; fp32 sums
    in another order), and the port's kernels stay bf16 between iterations."""
    rng = np.random.default_rng(3)
    img = np.zeros((2, 9, 11, 3), np.float32)
    img[:, :, :5] = [200, 60, 50]
    img[:, :, 5:] = [30, 180, 190]
    img = np.clip(img + rng.integers(-20, 20, img.shape), 0, 255)
    prefer = np.zeros((2, 9, 11, 5))
    prefer[:, :, :5, 1] = prefer[:, :, 5:, 3] = 1.0
    probs = (0.65 * rng.dirichlet(np.ones(5), size=(2, 9, 11)) + 0.35 * prefer).astype(np.float32)
    unary = np.log(probs).reshape(2, 99, 5)
    ref = []
    for i in range(2):
        bila = jfeat.bilateral_features(jnp.asarray(img[i]), 80 / 12, 80 / 12, 13.0, 13.0, 13.0)
        spat = jfeat.spatial_features(9, 11, 0.25, 0.25)
        ref.append(np.asarray(jexact.mean_field_exact(jnp.asarray(unary[i]), [bila, spat], [10.0, 3.0],
                                                      n_iters=5, fast=True)))
    bila = tfeat.bilateral_features(_t(img), 80 / 12, 80 / 12, 13.0, 13.0, 13.0)
    spat = tfeat.spatial_features(9, 11, 0.25, 0.25).expand(2, -1, -1)
    products = []
    product = texact._bf16_product

    def spy(k, x):
        products.append((k.dtype, x.dtype))
        return product(k, x)

    texact._bf16_product = spy
    try:
        got = texact.mean_field_exact(_t(unary), [bila, spat], [10.0, 3.0], n_iters=5, fast=True)
    finally:
        texact._bf16_product = product
    np.testing.assert_allclose(got.numpy(), np.stack(ref), atol=1e-3)
    assert set(products) == {(BF16, BF16)} and len(products) == 2 + 5 * 2


# ---------------------------------------------------------------- the steps

NC, HEADS, CROP, CUE = 6, (2, 4), 41, 6
S1_CFG = dict(num_classes=NC, batch_size=2, crop_size=CROP, cue_size=CUE, crf_iters=3, mirror=False,
              th1=0.55, th2=0.4, stepsize=2, compute_dtype="bfloat16", crf_fast=True)
FC8_SCALE = 30.0  # confident predictions: refined marginals far from th1 and th2
# No refined marginal within this of th1 or th2 (asserted): bf16 moves the
# marginals between the packages by up to ~1e-2, and then no growing
# decision can flip
MARGIN = 0.05
# Tolerances of one step from the same mid-training state, measured over
# seeds 11-16 of this batch (the test runs 11): loss 0.02-0.22% apart, grad_norm 0.1-1.5%, and
# each parameter's update 3-9% apart in norm (bf16 gradients through 18
# layers rounded at other places; worst in the first convolutions)
LOSS_RTOL, NORM_RTOL, UPDATE_RTOL = 5e-3, 3e-2, 0.1


def _s1_batch(rng, b=2):
    labels = np.zeros((b, NC), np.float32)
    labels[:, 0] = 1.0
    labels[0, 2] = labels[1, 4] = labels[1, 1] = 1.0
    cues = (rng.uniform(size=(b, CUE, CUE, NC)) < 0.15).astype(np.float32) * labels[:, None, None, :]
    images = (rng.normal(size=(b, CROP, CROP, 3)) * 40).astype(np.float32)
    images[:, :, : CROP // 2] += 50.0
    return {"images": images, "labels": labels, "cues": cues}


def _check_updates(before, jparams, model):
    got = flax_from_params(model.state_dict())
    for name, p in jparams.items():
        for kind in ("kernel", "bias"):
            ref = np.asarray(p[kind]) - before[name][kind]
            err = np.linalg.norm(got[name][kind] - before[name][kind] - ref) / np.linalg.norm(ref)
            assert err <= UPDATE_RTOL, (name, kind, err)


def test_stage1_bf16_step_matches_jax():
    batch = _s1_batch(np.random.default_rng(11))
    cfg = JaxStage1Config(**S1_CFG)
    jmodel = JaxLargeFOV(num_classes=NC, head_dilations=HEADS, dropout_rate=0.0, compute_dtype=jnp.bfloat16)
    params = jmodel.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, CROP, CROP, 3)), train=False)["params"]
    params = {k: ({**v, "kernel": v["kernel"] * FC8_SCALE} if k.startswith("fc8") else v)
              for k, v in params.items()}
    tx = j_make_optimizer(cfg)
    jstep = jax.jit(j_make_stage1_step(jmodel, cfg, tx))
    jstate, _ = jstep(JaxTrainState.create(params, tx, jax.random.PRNGKey(1)), batch)
    before = jax.tree.map(np.asarray, jstate.params)

    model = DeepLabLargeFOV(num_classes=NC, head_dilations=HEADS, dropout_rate=0.0, compute_dtype=BF16)
    tcfg = Stage1Config(**S1_CFG)
    state = init_stage1(model, tcfg, device="cpu")
    state.load_state_dict(state_from_flax(before, jax.tree.map(np.asarray, jstate.opt_state), jstate.step))
    with torch.no_grad():
        probs = clamp_straight_through(floored_softmax(model(_t(batch["images"]))), MIN_PROB)
        q = tapi.crf_refine_probs(probs, _t(batch["images"]), 12.0, S1_CFG["crf_iters"], fast=True).numpy()
    assert min(np.abs(q - th).min() for th in (S1_CFG["th1"], S1_CFG["th2"])) > MARGIN

    jstate, jm = jstep(jstate, batch)
    m = make_stage1_step(model, tcfg, state.optimizer, state.generator)(batch)
    for key in ("loss", "loss_seed"):
        np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=LOSS_RTOL, err_msg=key)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=NORM_RTOL)
    assert m["seed_pixels"].item() == float(jm["seed_pixels"]) > batch["cues"].sum()
    _check_updates(before, jstate.params, model)


def test_stage2_bf16_step_matches_jax():
    rng = np.random.default_rng(11)
    images = (rng.normal(size=(2, CROP, CROP, 3)) * 40).astype(np.float32)
    images[:, :, : CROP // 2] += 50.0
    labels = np.zeros((2, CROP, CROP), np.int32)
    labels[0, :, : CROP // 2] = 2
    labels[1, :, : CROP // 2] = 4
    labels[rng.random(labels.shape) < 0.1] = 3
    labels[:, 33:] = 255
    batch = {"images": images, "labels": labels}
    kw = dict(num_classes=NC, batch_size=2, crop_size=CROP, mirror=False, max_iter=10, compute_dtype="bfloat16")
    jmodel = JaxLargeFOV(num_classes=NC, head_dilations=HEADS, dropout_rate=0.0, compute_dtype=jnp.bfloat16)
    jstate, tx, _ = jstage2.init_stage2(jmodel, JaxStage2Config(**kw))
    jstate = jstate.replace(params={k: ({**v, "kernel": v["kernel"] * 3.0} if k.startswith("fc8") else v)
                                    for k, v in jstate.params.items()})
    jstep = jax.jit(jstage2.make_stage2_step(jmodel, JaxStage2Config(**kw), tx))
    jstate, _ = jstep(jstate, batch)
    before = jax.tree.map(np.asarray, jstate.params)

    model = DeepLabLargeFOV(num_classes=NC, head_dilations=HEADS, dropout_rate=0.0, compute_dtype=BF16)
    cfg = Stage2Config(**kw)
    state = init_stage2(model, cfg, device="cpu")
    state.load_state_dict(state_from_flax(before, jax.tree.map(np.asarray, jstate.opt_state), jstate.step))
    jstate, jm = jstep(jstate, batch)
    m = make_stage2_step(model, cfg, state.optimizer, state.generator)(batch)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=NORM_RTOL)
    # bf16 scores can flip the argmax of a pixel whose top two logits are close
    np.testing.assert_allclose(m["accuracy"].item(), float(jm["accuracy"]), atol=0.01)
    _check_updates(before, jstate.params, model)


@pytest.mark.parametrize("stage,model_dtype,cfg_dtype", [
    (1, BF16, "float32"), (1, torch.float32, "bfloat16"), (2, BF16, "float32"),
    (2, torch.float32, "bfloat16"), (1, torch.float32, "float16"), (2, BF16, "bf16")])
def test_make_step_rejects_a_compute_dtype_mismatch(stage, model_dtype, cfg_dtype):
    model = DeepLabLargeFOV(num_classes=NC, head_dilations=(2,), compute_dtype=model_dtype)
    cfg_cls, make_opt, make = ((Stage1Config, s1_make_optimizer, make_stage1_step) if stage == 1
                               else (Stage2Config, s2_make_optimizer, make_stage2_step))
    opt = make_opt(model, cfg_cls(num_classes=NC))
    with pytest.raises(ValueError, match="compute_dtype"):
        make(model, cfg_cls(num_classes=NC, compute_dtype=cfg_dtype), opt)
    make(model, cfg_cls(num_classes=NC, compute_dtype=str(model_dtype).split(".")[1]), opt)


def test_pool_wrappers_take_bf16_on_the_cpu_and_count_no_launch():
    yw, g = torch.zeros(1, 2, 5, 3, dtype=BF16), torch.ones(1, 2, 3, 3, dtype=BF16)
    counts = (pk.pool_bwd_h.launches, pk.pool_bwd_h.launches_bf16)
    assert pk.pool_bwd_h(yw, g, 3, 2, 1).dtype == BF16
    assert (pk.pool_bwd_h.launches, pk.pool_bwd_h.launches_bf16) == counts
    with pytest.raises(TypeError):
        pk.pool_bwd_h(yw.float(), g, 3, 2, 1)  # one dtype for both: no silent cast
    with pytest.raises(TypeError):
        pk.pool_bwd_w(torch.zeros(1, 2, 5, 5, dtype=torch.float16), g.half(), 3, 2, 1)


# ---------------------------------------------------------------- serving

def test_predictor_serves_a_bf16_model():
    """``Predictor`` takes a bf16 model unchanged, as JAX's does: the
    host-zoom ``predict_mask`` (exact CRF, restricted labels) against JAX's
    with the same bf16 model, and the device pipeline against the port's
    fp32 model.  fc8 is scaled x30 so that few pixels are near-ties; bf16
    scores still flip a few near the colour boundary (the test holds 97%;
    measured 99.85-100%)."""
    jm = JaxLargeFOV(num_classes=6, head_dilations=(2, 4), compute_dtype=jnp.bfloat16)
    params = jax.jit(lambda r: jm.init({"params": r}, jnp.zeros((1, 41, 41, 3)), train=False))(
        jax.random.PRNGKey(0))["params"]
    params = {k: ({**v, "kernel": v["kernel"] * 30.0} if k.startswith("fc8") else v) for k, v in params.items()}
    from dsrg_tpu import inference as jinf
    from dsrg_tpu_torch import inference as tinf

    jp = jinf.Predictor(jm, params, num_classes=6)
    tp = {dt: tinf.Predictor(DeepLabLargeFOV(num_classes=6, head_dilations=(2, 4), compute_dtype=dt),
                             params_from_flax(params), num_classes=6, device="cpu")
          for dt in (BF16, torch.float32)}
    rng = np.random.default_rng(4)
    image = np.zeros((48, 56, 3), np.uint8)
    image[:, :28] = [200, 60, 50]
    image[10:40, 28:] = [30, 180, 190]
    image = np.clip(image + rng.integers(-10, 10, image.shape), 0, 255).astype(np.uint8)
    for restrict in (None, [0, 2, 5]):
        got = tp[BF16].predict_mask(image, sizes=[41, 57], restrict_labels=restrict)
        ref = np.asarray(jp.predict_mask(image, sizes=[41, 57], restrict_labels=restrict))
        assert got.shape == image.shape[:2] and got.dtype == np.uint8
        assert (got == ref).mean() >= 0.97
        if restrict is not None:
            assert set(np.unique(got)) <= set(restrict)
    masks = {dt: p.predict_masks_device([image, image[:40, :33]], sizes=(41, 57), canvas_bucket=16)
             for dt, p in tp.items()}
    for a, b in zip(masks[BF16], masks[torch.float32]):
        assert a.shape == b.shape and a.dtype == np.uint8 and (a == b).mean() >= 0.97
