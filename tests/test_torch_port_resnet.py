"""The port's ResNet-101 DeepLab family held against the JAX package on the CPU.

A tiny ResNet (``stage_blocks=(1, 1, 2, 1)``: res4 has blocks a and b1,
heads (2, 4), 6 classes) with random weights and random, non-identity BN
statistics, scale and offset, made with numpy from a seed and handed to both
packages: the eval and masked-canvas forwards, the names and shapes of the
full-depth tree, the optimizer's multipliers, two stage-1 and two stage-2
steps in fp32 and one each in bf16, the pseudo ground truth and the served
masks, BN calibration, and a resumed run.  Scores are compared relative to
their largest magnitude: activations grow through the residual blocks.
The JAX package's max pool backward is its default (XLA's), which sums a
position's windows in another order than the port: the fp32 tolerances hold
that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsrg_tpu import inference as jinf
from dsrg_tpu.config import Stage1Config as JaxStage1Config
from dsrg_tpu.config import Stage2Config as JaxStage2Config
from dsrg_tpu.models import DeepLabLargeFOV as JaxLargeFOV
from dsrg_tpu.models import ResNet101DeepLab as JaxResNet
from dsrg_tpu.train import stage2 as jstage2
from dsrg_tpu.train.optimizer import vgg_param_mults as j_param_mults
from dsrg_tpu.train.stage1 import make_optimizer as j_make_optimizer
from dsrg_tpu.train.stage1 import make_stage1_step as j_make_stage1_step
from dsrg_tpu.train.train_state import TrainState as JaxTrainState
from dsrg_tpu_torch import inference as tinf
from dsrg_tpu_torch.config import Stage1Config, Stage2Config
from dsrg_tpu_torch.models import ResNet101DeepLab
from dsrg_tpu_torch.models.convert import (
    flax_variables_from_state,
    state_from_flax,
    variables_from_flax,
)
from dsrg_tpu_torch.ops.crf import api as tapi
from dsrg_tpu_torch.ops.softmax import MIN_PROB, clamp_straight_through, floored_softmax
from dsrg_tpu_torch.train import checkpoint as ckpt
from dsrg_tpu_torch.train.optimizer import vgg_param_mults
from dsrg_tpu_torch.train.stage1 import init_stage1, make_stage1_step
from dsrg_tpu_torch.train.stage2 import init_stage2, make_stage2_step

NC, HEADS, BLOCKS, CROP, CUE = 6, (2, 4), (1, 1, 2, 1), 41, 6
BF16 = torch.bfloat16


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _shapes(model, size=CROP):
    return jax.eval_shape(lambda r: model.init({"params": r}, jnp.zeros((1, size, size, 3)), train=False),
                          jax.random.PRNGKey(0))


def _variables(seed=0, head_scale=1.0):
    """Numpy variables of the tiny net: lecun-normal convolutions, heads
    N(0, 0.01 * head_scale) with N(0, 0.1) biases, and random BN scale,
    offset, mean and variance."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = jax.tree_util.keystr(path), leaf.shape
        if name.endswith("['kernel']"):
            std = 0.01 * head_scale if "fc1_voc12" in name else 1.0 / np.sqrt(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) * std).astype(np.float32)
        if name.endswith("['mean']") or name.endswith("['bias']"):
            return (rng.standard_normal(shape) * 0.1).astype(np.float32)
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)  # scale, var

    return jax.tree_util.tree_map_with_path(draw, _shapes(_jax_model()))


def _jax_model(dtype=jnp.float32):
    return JaxResNet(num_classes=NC, stage_blocks=BLOCKS, head_dilations=HEADS, compute_dtype=dtype)


def _port_model(dtype=torch.float32):
    return ResNet101DeepLab(num_classes=NC, stage_blocks=BLOCKS, head_dilations=HEADS, compute_dtype=dtype)


def _extra(variables):
    return {"batch_stats": variables["batch_stats"]}


# ---------------------------------------------------------------- the model

# fp32: the two packages sum convolutions in other orders; 1e-5 of the
# scores' scale (measured 0.8-1.3e-6).  bf16 (the VGG model's rule, test_torch_port_bf16.py):
# the packages round at other places, 3% of the scale
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("masked", [False, True])
def test_resnet_forward_matches_flax(masked, dtype, tol):
    variables = _variables()
    jm = _jax_model(getattr(jnp, dtype))
    tm = _port_model(getattr(torch, dtype))
    tm.load_state_dict(variables_from_flax(variables))
    x = (np.random.default_rng(1).normal(size=(2, 41, 39, 3)) * 40).astype(np.float32)
    valid = np.array([[41, 30], [25, 39]], np.float32) if masked else None
    ref = np.asarray(jax.jit(lambda v, a, hw: jm.apply(v, a, train=False, valid_hw=hw))(
        variables, jnp.asarray(x), None if valid is None else jnp.asarray(valid)))
    with torch.no_grad():
        got = tm(_t(x), valid_hw=None if valid is None else _t(valid))
    assert got.dtype == torch.float32 and got.shape == ref.shape == (2, 6, 6, NC)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol * np.abs(ref).max())


def test_masked_canvas_forward_equals_each_image_alone():
    tm = _port_model()
    tm.load_state_dict(variables_from_flax(_variables()))
    rng = np.random.default_rng(2)
    canvas = (rng.normal(size=(2, 41, 41, 3)) * 40).astype(np.float32)
    valid = np.array([[41, 30], [25, 33]], np.int64)
    with torch.no_grad():
        masked = tm(_t(canvas), valid_hw=_t(valid)).numpy()
        for i, (h, w) in enumerate(valid):
            alone = tm(_t(canvas[i: i + 1, :h, :w])).numpy()[0]
            np.testing.assert_allclose(masked[i, : alone.shape[0], : alone.shape[1]], alone, rtol=0,
                                       atol=1e-5 * np.abs(alone).max())


def test_full_depth_tree_converts_name_for_name():
    """The full-depth (3, 4, 23, 3) flax tree, by shape only, against the
    port's state_dict: every name and shape, both directions."""
    shapes = _shapes(JaxResNet(num_classes=21), size=65)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = variables_from_flax(zeros)
    port = ResNet101DeepLab(num_classes=21).state_dict()
    assert sorted(sd) == sorted(port)
    for key, t in port.items():
        assert tuple(sd[key].shape) == tuple(t.shape), key
    assert sum(1 for k in port if k.endswith("running_var")) == 1 + 3 * 33 + 4  # bn1, 3 per block, 4 shortcuts
    back = flax_variables_from_state(sd)
    assert jax.tree.structure(back) == jax.tree.structure(zeros)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(zeros), jax.tree.leaves(back)):
        assert a.shape == b.shape, jax.tree_util.keystr(path)


def _flat_keys(tree):
    """state_dict keys of a flax tree's leaves, in the tree's order."""
    leaf = {"kernel": "weight", "scale": "weight", "bias": "bias"}
    return [".".join([p.key for p in path[:-1]] + [leaf[path[-1].key]])
            for path, _ in jax.tree_util.tree_leaves_with_path(tree)]


@pytest.mark.parametrize("family", ["resnet", "vgg"])
def test_param_mults_match_jax(family):
    if family == "resnet":
        params = _shapes(JaxResNet(num_classes=21), size=65)["params"]
    else:
        params = _shapes(JaxLargeFOV(num_classes=21))["params"]
    j_lr, j_dec = j_param_mults(params)
    keys = _flat_keys(params)
    lr, dec = vgg_param_mults(keys)
    assert [lr[k] for k in keys] == jax.tree.leaves(j_lr)
    assert [dec[k] for k in keys] == jax.tree.leaves(j_dec)
    if family == "resnet":
        assert lr["res4_22.bn2.weight"] == dec["res4_22.bn2.bias"] == 0.0
        assert (lr["fc1_voc12_c3.weight"], lr["fc1_voc12_c3.bias"], lr["res5_2.conv3.weight"]) == (10.0, 20.0, 1.0)


# ---------------------------------------------------------------- stage 1

# the ResNet warm start's solver (dsrg_tpu/tools/synth_check.py: base_lr 1e-4,
# clip 10): at the VGG rate the random net's gradient norms (~10^3, BN
# gradients included) saturate its scores within a step
S1_CFG = dict(num_classes=NC, batch_size=2, crop_size=CROP, cue_size=CUE, crf_iters=3, mirror=False,
              th1=0.55, th2=0.4, stepsize=2, base_lr=1e-4, clip_gradients=10.0)
HEAD_SCALE = 0.5  # heads N(0, 0.005): refined marginals away from th1 and th2 in every step
SERVE_HEAD_SCALE = 30.0  # confident predictions: few near-ties in the served masks
# no refined marginal this close to th1 or th2 (asserted): a rounding
# difference can then never flip a growing decision (bf16: test_torch_port_bf16.py's margin)
MARGIN, BF16_MARGIN = 1e-3, 0.05
# the VGG model's bf16 tolerances (tests/test_torch_port_bf16.py), held by the
# stage-2 step
LOSS_RTOL, NORM_RTOL, UPDATE_RTOL = 5e-3, 3e-2, 0.1
# The stage-1 bf16 step of this net, measured over seeds 11-16 of its batch
# (the test runs 11): loss and seed loss 1e-5 - 5.1e-3 apart, grad_norm
# 1.6-12.7%, each parameter's update 11-38% in norm.  Its gradients sit
# 8-20% from the fp32 step's in either package (random BN statistics and
# scales through the residual blocks), the two packages' bf16 VJPs 1-4%
# from each other (test_resnet_bf16_vjp_matches_flax), and the clip to
# norm 10 carries grad_norm's error into every update
S1_BF16_LOSS_RTOL, S1_BF16_NORM_RTOL, S1_BF16_UPDATE_RTOL = 1e-2, 0.2, 0.5


def _s1_batch(rng, b=2):
    labels = np.zeros((b, NC), np.float32)
    labels[:, 0] = 1.0
    labels[0, 2] = labels[1, 4] = labels[1, 1] = 1.0
    cues = (rng.uniform(size=(b, CUE, CUE, NC)) < 0.15).astype(np.float32) * labels[:, None, None, :]
    images = (rng.normal(size=(b, CROP, CROP, 3)) * 40).astype(np.float32)
    images[:, :, : CROP // 2] += 50.0
    return {"images": images, "labels": labels, "cues": cues}


def _s1_states(batch, dtype="float32", **cfg_extra):
    """A JAX state after one step (non-zero velocities) and the port's state
    loaded from it, with their step functions."""
    kw = dict(S1_CFG, compute_dtype=dtype, **cfg_extra)
    variables = _variables(head_scale=HEAD_SCALE)
    jm, cfg = _jax_model(getattr(jnp, dtype)), JaxStage1Config(**kw)
    tx = j_make_optimizer(cfg)
    jstep = jax.jit(j_make_stage1_step(jm, cfg, tx, extra_vars=_extra(variables)))
    jstate, _ = jstep(JaxTrainState.create(variables["params"], tx, jax.random.PRNGKey(1)), batch)
    model, tcfg = _port_model(getattr(torch, dtype)), Stage1Config(**kw)
    state = init_stage1(model, tcfg, device="cpu")
    state.load_state_dict(state_from_flax(jax.tree.map(np.asarray, jstate.params),
                                          jax.tree.map(np.asarray, jstate.opt_state), jstate.step,
                                          _extra(variables)))
    return jstate, jstep, state, make_stage1_step(model, tcfg, state.optimizer, state.generator), variables


def _margin(model, batch, fast=False):
    with torch.no_grad():
        probs = clamp_straight_through(floored_softmax(model(_t(batch["images"]))), MIN_PROB)
        q = tapi.crf_refine_probs(probs, _t(batch["images"]), 12.0, S1_CFG["crf_iters"], fast=fast).numpy()
    return min(np.abs(q - th).min() for th in (S1_CFG["th1"], S1_CFG["th2"]))


def _check_params(model, jparams, atol_rel):
    got = flax_variables_from_state(model.state_dict())["params"]
    for (path, ref), val in zip(jax.tree_util.tree_leaves_with_path(jparams), jax.tree.leaves(got)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(val, ref, rtol=0, atol=atol_rel * max(np.abs(ref).max(), 1e-12),
                                   err_msg=jax.tree_util.keystr(path))


def _check_stats_unchanged(model, variables):
    stats = flax_variables_from_state(model.state_dict())["batch_stats"]
    for a, b in zip(jax.tree.leaves(stats), jax.tree.leaves(variables["batch_stats"])):
        np.testing.assert_array_equal(a, b)


def test_stage1_two_steps_match_jax():
    batch = _s1_batch(np.random.default_rng(11))
    jstate, jstep, state, step, variables = _s1_states(batch)
    assert state.step == 1
    for _ in range(2):
        assert _margin(state.model, batch) > MARGIN
        jstate, jm = jstep(jstate, batch)
        m = step(batch)
        for key in ("loss", "loss_seed", "loss_constrain", "grad_norm"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=1e-4, err_msg=key)
        assert m["seed_pixels"].item() == float(jm["seed_pixels"]) > batch["cues"].sum()
    assert state.step == int(jstate.step) == 3
    _check_params(state.model, jstate.params, 1e-4)
    _check_stats_unchanged(state.model, variables)
    # batch norm's scale and offset have lr 0 and decay 0: they never move
    got = flax_variables_from_state(state.model.state_dict())["params"]
    np.testing.assert_array_equal(got["res4_1"]["bn2"]["scale"], variables["params"]["res4_1"]["bn2"]["scale"])


def test_stage1_bf16_step_matches_jax():
    batch = _s1_batch(np.random.default_rng(11))
    jstate, jstep, state, step, _ = _s1_states(batch, "bfloat16", crf_fast=True)
    before = jax.tree.map(np.asarray, jstate.params)
    assert _margin(state.model, batch, fast=True) > BF16_MARGIN
    jstate, jm = jstep(jstate, batch)
    m = step(batch)
    for key in ("loss", "loss_seed"):
        np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=S1_BF16_LOSS_RTOL, err_msg=key)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=S1_BF16_NORM_RTOL)
    assert m["seed_pixels"].item() == float(jm["seed_pixels"])
    _check_updates(before, jstate.params, state.model, S1_BF16_UPDATE_RTOL)


def test_resnet_bf16_vjp_matches_flax():
    """The bf16 train forward and its VJP against flax's, op by op: every
    parameter's gradient within 5% of JAX's in norm (measured 0.9-3.7%),
    where either lies 3-21% from the fp32 gradient: the port rounds where
    flax's operations do.  (Under ``jax.jit`` XLA keeps some fused
    intermediates unrounded, and the jitted bf16 gradient moves ~18% from
    the op-by-op one: the step tolerances above hold that.)"""
    variables = _variables(head_scale=HEAD_SCALE)
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, CROP, CROP, 3)) * 40).astype(np.float32)
    g = rng.normal(size=(2, 6, 6, NC)).astype(np.float32)
    jm = _jax_model(jnp.bfloat16)
    _, vjp = jax.vjp(lambda p: jm.apply({"params": p, **_extra(variables)}, jnp.asarray(x), train=True),
                     variables["params"])
    ref = jax.tree.leaves(vjp(jnp.asarray(g))[0])
    tm = _port_model(BF16)
    tm.load_state_dict(variables_from_flax(variables))
    tm(_t(x), train=True).backward(_t(g))
    port = flax_variables_from_state({k: p.grad for k, p in tm.named_parameters()})["params"]
    names = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(variables["params"])]
    for name, got, r in zip(names, jax.tree.leaves(port), ref):
        r = np.asarray(r)
        assert np.linalg.norm(got - r) <= 0.05 * np.linalg.norm(r), name


def _check_updates(before, jparams, model, rtol=UPDATE_RTOL):
    """Each parameter's update within ``rtol`` of JAX's, in norm."""
    got = flax_variables_from_state(model.state_dict())["params"]
    for (path, ref), val, b in zip(jax.tree_util.tree_leaves_with_path(jparams), jax.tree.leaves(got),
                                   jax.tree.leaves(before)):
        upd = np.asarray(ref) - b
        if not upd.any():  # batch norm: frozen in both
            assert not (val - b).any(), jax.tree_util.keystr(path)
            continue
        err = np.linalg.norm(val - b - upd) / np.linalg.norm(upd)
        assert err <= rtol, (jax.tree_util.keystr(path), err)


# ---------------------------------------------------------------- stage 2

S2_CFG = dict(num_classes=NC, batch_size=2, crop_size=CROP, mirror=False, max_iter=10)


def _s2_batch():
    rng = np.random.default_rng(11)
    images = (rng.normal(size=(2, CROP, CROP, 3)) * 40).astype(np.float32)
    images[:, :, : CROP // 2] += 50.0
    labels = np.zeros((2, CROP, CROP), np.int32)
    labels[0, :, : CROP // 2] = 2
    labels[1, :, : CROP // 2] = 4
    labels[rng.random(labels.shape) < 0.1] = 3
    labels[:, 33:] = 255
    return {"images": images, "labels": labels}


def _s2_states(batch, dtype="float32"):
    kw = dict(S2_CFG, compute_dtype=dtype)
    variables = _variables(head_scale=3.0)  # test_torch_port_stage2.py's fc8 scale for stage-2 parity
    jm, cfg = _jax_model(getattr(jnp, dtype)), JaxStage2Config(**kw)
    tx = jstage2.make_optimizer(cfg)
    jstep = jax.jit(jstage2.make_stage2_step(jm, cfg, tx, extra_vars=_extra(variables)))
    jstate, _ = jstep(JaxTrainState.create(variables["params"], tx, jax.random.PRNGKey(1)), batch)
    model, tcfg = _port_model(getattr(torch, dtype)), Stage2Config(**kw)
    state = init_stage2(model, tcfg, device="cpu")
    state.load_state_dict(state_from_flax(jax.tree.map(np.asarray, jstate.params),
                                          jax.tree.map(np.asarray, jstate.opt_state), jstate.step,
                                          _extra(variables)))
    return jstate, jstep, state, make_stage2_step(model, tcfg, state.optimizer, state.generator), variables


def test_stage2_two_steps_match_jax():
    batch = _s2_batch()
    jstate, jstep, state, step, variables = _s2_states(batch)
    for _ in range(2):
        jstate, jm = jstep(jstate, batch)
        m = step(batch)
        for key in ("loss", "accuracy", "grad_norm"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=1e-4, err_msg=key)
    assert 0.0 < m["accuracy"].item() < 1.0
    _check_params(state.model, jstate.params, 1e-4)
    _check_stats_unchanged(state.model, variables)


def test_stage2_bf16_step_matches_jax():
    batch = _s2_batch()
    jstate, jstep, state, step, _ = _s2_states(batch, "bfloat16")
    before = jax.tree.map(np.asarray, jstate.params)
    jstate, jm = jstep(jstate, batch)
    m = step(batch)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=NORM_RTOL)
    # bf16 scores can flip the argmax of a pixel whose top two logits are close
    np.testing.assert_allclose(m["accuracy"].item(), float(jm["accuracy"]), atol=0.01)
    _check_updates(before, jstate.params, state.model)


# ---------------------------------------------------------------- serving and the pseudo ground truth

def _images(rng, n=3):
    out = []
    for i in range(n):
        h, w = 40 + 7 * i, 52 - 5 * i
        img = np.zeros((h, w, 3), np.uint8)
        img[:, : w // 2] = [200, 60, 50]
        img[:, w // 2:] = [30, 180, 190]
        out.append(np.clip(img.astype(np.int32) + rng.integers(-8, 8, img.shape), 0, 255).astype(np.uint8))
    return out


def test_predictor_serves_the_resnet_as_jax_does():
    """``predict_mask(restrict_labels=...)`` (the pseudo ground truth,
    exact CRF) equal to JAX's, and the device pipeline (masked canvas,
    mmgrid CRF) on >= 0.99 of the pixels."""
    variables = _variables(head_scale=SERVE_HEAD_SCALE)
    jp = jinf.Predictor(_jax_model(), variables, num_classes=NC)
    tp = tinf.Predictor(_port_model(), variables_from_flax(variables), num_classes=NC, device="cpu")
    assert tp.exact_canvas
    images = _images(np.random.default_rng(8))
    for im in images:
        for restrict in ([0, 4, 1], None):
            ref = jp.predict_mask(im, sizes=[41], restrict_labels=None if restrict is None else np.asarray(restrict))
            got = tp.predict_mask(im, sizes=[41], restrict_labels=restrict)
            assert got.dtype == np.uint8 and got.shape == im.shape[:2]
            np.testing.assert_array_equal(got, ref)
    ref = jp.predict_masks_device(images, sizes=[41, 57], smooth=True, canvas_bucket=16)
    got = tp.predict_masks_device(images, sizes=[41, 57], smooth=True, canvas_bucket=16)
    for im, r, g in zip(images, ref, got):
        assert g.shape == r.shape == im.shape[:2] and g.dtype == np.uint8
        assert (g == r).mean() >= 0.99


# ---------------------------------------------------------------- BN calibration

def test_train_bn_calibration_matches_flax():
    """Three calibration forwards (batch statistics, flax's running update
    with momentum 0.95 and biased variance) against ``model.apply(...,
    train_bn=True, mutable=["batch_stats"])``: the statistics to 1e-5
    relative to each array's scale, and the scores of the last forward."""
    variables = _variables()
    jm, tm = _jax_model(), _port_model()
    tm.load_state_dict(variables_from_flax(variables))

    @jax.jit
    def calib(v, x):
        return jm.apply(v, x, train=False, train_bn=True, mutable=["batch_stats"])

    rng = np.random.default_rng(3)
    for _ in range(3):
        x = (rng.normal(size=(2, 33, 33, 3)) * 40).astype(np.float32)
        scores, mut = calib(variables, jnp.asarray(x))
        variables = {"params": variables["params"], "batch_stats": mut["batch_stats"]}
        with torch.no_grad():
            got = tm(_t(x), train_bn=True)
    ref = np.asarray(scores)
    stats = flax_variables_from_state(tm.state_dict())["batch_stats"]
    for (path, r), g in zip(jax.tree_util.tree_leaves_with_path(variables["batch_stats"]), jax.tree.leaves(stats)):
        r = np.asarray(r)
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-5 * np.abs(r).max(), err_msg=jax.tree_util.keystr(path))
    # normalised by the last batch's own statistics, whose E[x^2] - E[x]^2
    # cancels and whose sums run in other orders (measured 1.1e-5 of the scale)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    with pytest.raises(RuntimeError, match="no_grad"):
        tm(_t(x), train_bn=True)


# ---------------------------------------------------------------- checkpoints

def test_resumed_resnet_run_equals_the_straight_run(tmp_path):
    """Two steps straight against one step, a snapshot, a restore into a
    fresh state and one step: parameters, BN buffers, velocities, step and
    random stream bit for bit; ``save_params`` / ``copy_from`` carry the
    buffers."""
    batch = _s1_batch(np.random.default_rng(12))
    cfg = Stage1Config(**{**S1_CFG, "mirror": True})
    buffers = {k: v for k, v in variables_from_flax(_variables()).items() if "running" in k}

    def fresh():
        model = _port_model()
        state = init_stage1(model, cfg, device="cpu")
        model.load_state_dict({**model.state_dict(), **buffers})
        return state, make_stage1_step(model, cfg, state.optimizer, state.generator)

    straight, step = fresh()
    step(batch)
    step(batch)
    first, step = fresh()
    step(batch)
    path = ckpt.save_checkpoint(str(tmp_path / "snap"), first, first.step)
    resumed, step = fresh()
    for v in resumed.model.buffers():
        v.zero_()
    ckpt.restore_checkpoint(path, resumed)
    step(batch)
    for (k, a), b in zip(straight.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    for k, v in straight.optimizer.velocity.items():
        assert torch.equal(v, resumed.optimizer.velocity[k]), k
    assert set(straight.optimizer.velocity) == {n for n, _ in straight.model.named_parameters()}
    assert straight.step == resumed.step == 2
    assert torch.equal(straight.generator.get_state(), resumed.generator.get_state())

    ckpt.save_params(str(tmp_path / "p"), straight.model)
    loaded = ckpt.load_params(str(tmp_path / "p"))
    assert torch.equal(loaded["res4_1.bn2.running_var"], straight.model.res4_1.bn2.running_var)
    target = _port_model()
    ckpt.copy_from(target, loaded, verbose=False)
    for (k, a), b in zip(target.state_dict().items(), straight.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_init_params_follows_flax_init():
    """Heads N(0, 0.01), zero biases, BN scale 1 / offset 0 / mean 0 / var 1,
    lecun-normal convolutions (std 1 / sqrt(fan-in))."""
    model = ResNet101DeepLab(num_classes=NC, stage_blocks=BLOCKS)
    init_stage1(model, Stage1Config(num_classes=NC), device="cpu")
    sd = model.state_dict()
    assert (sd["res4_1.bn2.weight"] == 1).all() and (sd["res4_1.bn2.bias"] == 0).all()
    assert (sd["res4_1.bn2.running_mean"] == 0).all() and (sd["res4_1.bn2.running_var"] == 1).all()
    assert (sd["fc1_voc12_c0.bias"] == 0).all()
    assert abs(sd["fc1_voc12_c0.weight"].std().item() - 0.01) < 1e-3
    w = sd["res4_1.conv2.weight"]
    assert abs(w.std().item() * np.sqrt(w[0].numel()) - 1.0) < 0.05
    assert w.abs().max().item() <= 2.0 / 0.87962566103423978 / np.sqrt(w[0].numel()) + 1e-6
