"""The port's stage-2 retrain step, its loss, config and cue database, held
against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  Random
streams cannot match (threefry vs Philox), so the step parity runs with
``mirror=False`` and dropout off in both, and the mirror is tested on its own.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from dsrg_tpu.config import Stage2Config as JaxStage2Config
from dsrg_tpu.data import cues as jcues
from dsrg_tpu.losses import softmax_cross_entropy_ignore as j_ce
from dsrg_tpu.losses import softmax_cross_entropy_ignore_sums as j_ce_sums
from dsrg_tpu.models import DeepLabLargeFOV as JaxLargeFOV
from dsrg_tpu.train import stage2 as jstage2
from dsrg_tpu_torch.config import Stage2Config
from dsrg_tpu_torch.data import cues as tcues
from dsrg_tpu_torch.losses import softmax_cross_entropy_ignore, softmax_cross_entropy_ignore_sums
from dsrg_tpu_torch.models import DeepLabLargeFOV
from dsrg_tpu_torch.models.convert import flax_from_params, state_from_flax
from dsrg_tpu_torch.train.optimizer import CaffeSGD, lr_poly
from dsrg_tpu_torch.train.stage2 import init_stage2, make_optimizer, make_stage2_step

NC, HEADS, CROP = 6, (2, 4), 41
STEP_CFG = dict(num_classes=NC, batch_size=2, crop_size=CROP, mirror=False, max_iter=10)
# fc8 scaled so that predictions are confident enough for a non-trivial
# accuracy, and small enough that one step at the stage-2 rate does not
# magnify the packages' fp32 differences (a ReLU whose input lies within
# rounding of 0 can gate differently) past the 1e-4 the test holds them to
FC8_SCALE = 3.0


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- loss

def _ce_case(seed):
    """Logits with exact ties (the first maximum is the prediction), labels
    with ignore pixels, one all-ignore sample."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(3, 5, 4, NC)).astype(np.float32)
    logits[0, :2] = 0.0  # all classes tied: the prediction is class 0
    logits[1, 1, :, 2] = logits[1, 1, :, 4] = logits[1, 1].max(-1) + 1.0  # two tied maxima
    labels = rng.integers(0, NC, (3, 5, 4)).astype(np.int32)
    labels[1, 1, :2] = 4  # the second of two tied maxima: wrong in both packages
    labels[1, 1, 2:] = 2  # the first: right in both
    labels[0, 4] = 255
    labels[2] = 255
    return logits, labels


def test_softmax_ce_sums_match_jax():
    logits, labels = _ce_case(0)
    (ref, (r_acc, r_n)), g_ref = jax.value_and_grad(
        lambda x: (lambda s: (s[0], (s[1], s[2])))(j_ce_sums(x, jnp.asarray(labels))),
        has_aux=True)(jnp.asarray(logits))
    lt = _t(logits).requires_grad_(True)
    loss, acc, n = softmax_cross_entropy_ignore_sums(lt, _t(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-6)
    assert acc.item() == float(r_acc) and n.item() == float(r_n) == 60 - 4 - 20
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(g_ref), rtol=1e-6, atol=1e-8)
    assert np.all(lt.grad.numpy()[2] == 0.0)  # ignored pixels get no gradient
    # uint8 labels, as the pseudo ground truth comes, give the same sums
    assert [v.item() for v in softmax_cross_entropy_ignore_sums(_t(logits), _t(labels.astype(np.uint8)))] \
        == [loss.item(), acc.item(), n.item()]
    # the normalised form
    got = [v.item() for v in softmax_cross_entropy_ignore(_t(logits), _t(labels))]
    np.testing.assert_allclose(got, [float(v) for v in j_ce(jnp.asarray(logits), jnp.asarray(labels))],
                               rtol=1e-6)
    none = softmax_cross_entropy_ignore(_t(logits), torch.full(labels.shape, 255))
    assert [v.item() for v in none] == [0.0, 0.0]


def test_stage2_config_matches_jax():
    assert dataclasses.asdict(Stage2Config()) == dataclasses.asdict(JaxStage2Config())


def test_stage2_optimizer_is_poly_caffe_sgd():
    cfg = Stage2Config(max_iter=100)
    opt = make_optimizer(DeepLabLargeFOV(num_classes=3, head_dilations=(2,)), cfg)
    assert isinstance(opt, CaffeSGD) and opt.momentum == 0.9 and opt.weight_decay == 5e-4
    for step in (0, 1, 50, 99):
        assert opt.lr_fn(step) == lr_poly(1e-3, 0.9, 100)(step)


# ---------------------------------------------------------------- the step

def _step_batch(rng, b=2):
    """Images with a bright left half; label maps that follow it, with an
    ignore band and a few stray labels."""
    images = (rng.normal(size=(b, CROP, CROP, 3)) * 40).astype(np.float32)
    images[:, :, : CROP // 2] += 50.0
    labels = np.zeros((b, CROP, CROP), np.int32)
    labels[0, :, : CROP // 2] = 2
    labels[1, :, : CROP // 2] = 4
    labels[1, 20:, CROP // 2:] = 1
    labels[rng.random(labels.shape) < 0.1] = 3
    labels[:, 33:] = 255
    return {"images": images, "labels": labels}


def _jax_state_after_one_step(batch):
    """A mid-training JAX state (non-zero velocities, step 1)."""
    cfg = JaxStage2Config(**STEP_CFG)
    model = JaxLargeFOV(num_classes=NC, head_dilations=HEADS, dropout_rate=0.0)
    state, tx, _ = jstage2.init_stage2(model, cfg)
    params = {k: ({**v, "kernel": v["kernel"] * FC8_SCALE} if k.startswith("fc8") else v)
              for k, v in state.params.items()}
    state = state.replace(params=params)
    step = jax.jit(jstage2.make_stage2_step(model, cfg, tx))
    state, _ = step(state, batch)
    return state, step


def _port_step(cfg_kw=None, device="cpu"):
    model = DeepLabLargeFOV(num_classes=NC, head_dilations=HEADS, dropout_rate=0.0)
    cfg = Stage2Config(**{**STEP_CFG, **(cfg_kw or {})})
    state = init_stage2(model, cfg, device=device)
    return state, make_stage2_step(model, cfg, state.optimizer, state.generator)


def test_stage2_two_steps_match_jax():
    batch = _step_batch(np.random.default_rng(11))
    jstate, jstep = _jax_state_after_one_step(batch)
    state, step = _port_step()
    state.load_state_dict(state_from_flax(jax.tree.map(np.asarray, jstate.params),
                                          jax.tree.map(np.asarray, jstate.opt_state), jstate.step))
    assert state.step == 1
    for _ in range(2):
        with torch.no_grad():  # no two logits so close that rounding could flip the accuracy
            top2 = torch.topk(state.model(_t(batch["images"])), 2, -1).values
        assert (top2[..., 0] - top2[..., 1]).min().item() > 1e-3
        jstate, jm = jstep(jstate, batch)
        m = step(batch)
        assert set(m) == set(jm) == {"loss", "accuracy", "grad_norm"}
        for key in m:
            np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=1e-4, err_msg=key)
    assert 0.0 < m["accuracy"].item() < 1.0
    assert state.step == int(jstate.step) == 3
    got = flax_from_params(state.model.state_dict())  # parameters after the second step
    for name, p in jstate.params.items():
        for kind in ("kernel", "bias"):
            r = np.asarray(p[kind])
            np.testing.assert_allclose(got[name][kind], r, rtol=0,
                                       atol=1e-4 * max(np.abs(r).max(), 1e-12), err_msg=name)


def test_stage2_uint8_batch_matches_f32():
    """Raw uint8 BGR images and uint8 label maps give the f32 batch's step."""
    batch = _step_batch(np.random.default_rng(13))
    raw = np.random.default_rng(14).integers(0, 256, batch["images"].shape).astype(np.uint8)
    f32 = {**batch, "images": raw.astype(np.float32) - np.array([104.0, 117.0, 123.0], np.float32)}
    u8 = {"images": raw, "labels": batch["labels"].astype(np.uint8)}
    results = []
    for b in (f32, u8):
        _, step = _port_step()
        results.append({k: v.item() for k, v in step(b).items()})
    assert results[0] == results[1]


def test_stage2_pad_mask_reproduces_unpadded_step():
    """A padded third row (pad_mask 0, labels not ignore) changes no metric
    and no parameter: its labels are forced to the ignore label."""
    batch = _step_batch(np.random.default_rng(12))
    padded = {"images": np.concatenate([batch["images"], batch["images"][:1] * 0.5 + 1.0]),
              "labels": np.concatenate([batch["labels"], np.full((1, CROP, CROP), 2, np.int32)]),
              "pad_mask": np.array([1.0, 1.0, 0.0], np.float32)}
    results = []
    for b in (batch, padded):
        state, step = _port_step()
        m = step(b)
        results.append(({k: v.item() for k, v in m.items()}, state.model.state_dict()))
    (m0, p0), (m1, p1) = results
    for key in m0:
        np.testing.assert_allclose(m1[key], m0[key], rtol=1e-5, err_msg=key)
    for name, t in p0.items():
        np.testing.assert_allclose(p1[name].numpy(), t.numpy(), rtol=0,
                                   atol=1e-5 * max(t.abs().max().item(), 1e-12), err_msg=name)


def test_stage2_all_ignore_batch():
    """Loss and accuracy 0 and zero, finite gradients: only weight decay moves the weights."""
    batch = _step_batch(np.random.default_rng(15))
    batch["labels"][:] = 255
    state, step = _port_step()
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    m = step(batch)
    assert m["loss"].item() == 0.0 and m["accuracy"].item() == 0.0 and m["grad_norm"].item() == 0.0
    after = state.model.state_dict()
    for name, t in before.items():
        assert torch.isfinite(after[name]).all()
        decay = 0.0 if name.endswith(".bias") else 5e-4
        lr = 1e-3 * (10.0 if name.startswith("fc8") else 1.0)
        torch.testing.assert_close(after[name], t - lr * decay * t, rtol=1e-6, atol=1e-9)


class _Probe(nn.Module):
    """A stand-in net: the logits name the class that the image's channel 0
    encodes (10 per class) at each 8th pixel, scaled by one parameter; the
    images it was given are kept."""

    def __init__(self):
        super().__init__()
        self.probe = nn.Conv2d(1, 1, 1, bias=False)
        nn.init.constant_(self.probe.weight, 5.0)
        self.seen = []

    def forward(self, x, train=False, generator=None):
        self.seen.append(x.detach().clone())
        cls = torch.round(x[:, ::8, ::8, 0] / 10.0).long()
        return self.probe.weight.reshape(()) * nn.functional.one_hot(cls, NC).float()


def test_stage2_mirror_flips_image_and_labels_together():
    """One draw per row flips image and label map together: the stand-in
    net, whose logits follow the image, stays right at every pixel, and
    some rows were flipped and some not."""
    rng = np.random.default_rng(16)
    b = 8
    labels = rng.integers(0, NC, (b, CROP, CROP)).astype(np.int32)
    images = np.repeat(labels[..., None].astype(np.float32) * 10.0, 3, axis=-1)
    model = _Probe()
    cfg = Stage2Config(num_classes=NC, batch_size=b, crop_size=CROP, mirror=True)
    opt = make_optimizer(model, cfg)
    step = make_stage2_step(model, cfg, opt, torch.Generator().manual_seed(3))
    flipped = []
    for _ in range(2):
        m = step({"images": images, "labels": labels})
        assert m["accuracy"].item() == 1.0
        seen = model.seen[-1].numpy()
        for i in range(b):
            same = np.array_equal(seen[i], images[i])
            assert same or np.array_equal(seen[i], images[i, :, ::-1])
            flipped.append(not same)
    assert 0 < sum(flipped) < len(flipped)
    # without the mirror nothing is flipped
    step = make_stage2_step(model, Stage2Config(num_classes=NC, mirror=False), opt, None)
    step({"images": images, "labels": labels})
    np.testing.assert_array_equal(model.seen[-1].numpy(), images)


def test_init_stage2_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_stage2(DeepLabLargeFOV(num_classes=3, head_dilations=(2,)), Stage2Config())


# ---------------------------------------------------------------- cue database

def test_cue_db_reads_the_jax_pickle(tmp_path):
    rng = np.random.default_rng(17)
    entries = {}
    for image_id in (3, 2007000032, 11):
        fg = np.sort(rng.choice(np.arange(1, NC), size=2, replace=False))
        c = rng.choice(np.concatenate([[0], fg]), size=9)
        entries[image_id] = (fg, (c, rng.integers(0, 41, 9), rng.integers(0, 41, 9)))
    jpath, tpath = tmp_path / "jax.pickle", tmp_path / "port.pickle"
    jcues.save_cue_db(str(jpath), entries)
    tcues.save_cue_db(str(tpath), entries)
    assert jpath.read_bytes() == tpath.read_bytes()
    ref = jcues.CueDB(str(jpath), num_classes=NC)
    got = tcues.CueDB(str(jpath), num_classes=NC)
    for image_id in entries:
        assert image_id in got
        for a, b in zip(got.get(image_id), ref.get(image_id)):
            np.testing.assert_array_equal(a, b)
        assert got.labels(image_id)[0] == 1.0
    assert 4 not in got
