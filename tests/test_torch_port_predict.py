"""The port's host-zoom inference paths and public ``CRF()`` held against
the JAX package on the CPU, and the recipe's second half as a whole: pseudo
ground truth from ``predict_mask(restrict_labels=...)`` fed to the stage-2
step.

The JAX mmgrid CRF runs its Pallas kernels in interpret mode here, as its
own tests do.  Images stay at a few thousand pixels: the exact engine's
kernel matrices grow with the square of the pixel count.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsrg_tpu import inference as jinf
from dsrg_tpu.config import Stage2Config as JaxStage2Config
from dsrg_tpu.models import DeepLabLargeFOV as JaxLargeFOV
from dsrg_tpu.ops.crf import api as japi
from dsrg_tpu.train import stage2 as jstage2
from dsrg_tpu_torch import inference as tinf
from dsrg_tpu_torch.config import Stage2Config
from dsrg_tpu_torch.models import DeepLabLargeFOV
from dsrg_tpu_torch.models.convert import params_from_flax, state_from_flax
from dsrg_tpu_torch.ops.crf import api as tapi
from dsrg_tpu_torch.ops.crf import mmgrid_kernels as mk
from dsrg_tpu_torch.train.stage2 import init_stage2, make_stage2_step

M = 6


def _params():
    jm = JaxLargeFOV(num_classes=M, head_dilations=(2, 4))
    return jm, jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 41, 41, 3)),
                       train=False)["params"]


def _predictors(bucket=1):
    jm, params = _params()
    jp = jinf.Predictor(jm, params, num_classes=M, bucket=bucket)
    tp = tinf.Predictor(DeepLabLargeFOV(num_classes=M, head_dilations=(2, 4)),
                        params_from_flax(params), num_classes=M, bucket=bucket, device="cpu")
    return jp, tp


def _images(rng, n=3):
    """Small two-colour images of three shapes (those of
    ``tests/test_batched_inference.py``)."""
    out = []
    for i in range(n):
        h, w = 40 + 7 * i, 52 - 5 * i
        img = np.zeros((h, w, 3), np.uint8)
        img[:, : w // 2] = [200, 60, 50]
        img[:, w // 2:] = [30, 180, 190]
        out.append(np.clip(img.astype(np.int32) + rng.integers(-8, 8, img.shape), 0, 255).astype(np.uint8))
    return out


def _crf_case(seed, h, w):
    """A two-colour image and log-probabilities that favour one class per
    colour region, as a network's do."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.float32)
    img[:, : w // 2] = [200, 60, 50]
    img[:, w // 2:] = [30, 180, 190]
    img = np.clip(img + rng.integers(-20, 20, img.shape), 0, 255).astype(np.uint8)
    prefer = np.zeros((h, w, M))
    prefer[:, : w // 2, 1] = prefer[:, w // 2:, 3] = 1.0
    probs = 0.65 * rng.dirichlet(np.ones(M), size=(h, w)) + 0.35 * prefer
    return img, np.log(probs).astype(np.float32)


# ---------------------------------------------------------------- CRF()

def test_crf_engine_resolution(caplog):
    assert tapi.EXACT_MAX_PIXELS == japi.EXACT_MAX_PIXELS == 8192
    assert tapi.resolve_engine("auto", 64, 128) == "exact"  # 8192 px
    assert tapi.resolve_engine("auto", 64, 129) == "mmgrid"
    assert tapi.resolve_engine("exact", 500, 375) == "exact"
    assert tapi.resolve_engine("mmgrid", 4, 4) == "mmgrid"
    with pytest.raises(ValueError, match="unknown CRF engine"):
        tapi.resolve_engine("lattise", 4, 4)
    for engine in ("grid", "lattice", "native"):  # a named engine runs whatever the size
        assert tapi.resolve_engine(engine, 4, 4) == tapi.resolve_engine(engine, 500, 375) == engine
    with pytest.raises(ValueError):  # the JAX package refuses the same name
        japi.CRF(np.zeros((4, 4, 3)), np.zeros((4, 4, 2)), engine="lattise")
    # "auto" says once per geometry which engine it took
    with caplog.at_level(logging.INFO, logger="dsrg_tpu_torch.crf"):
        for _ in range(2):
            tapi.resolve_engine("auto", 13, 17)
    assert [r.getMessage() for r in caplog.records].count(
        "CRF engine=auto resolved to 'exact' for 13x17 (221 px; exact<=8192 px)") == 1
    # CRF() runs the engine that the rule names: small images the exact one, large the grid
    for (h, w), engine in (((30, 40), "exact"), ((91, 91), "mmgrid")):
        img, unary = _crf_case(0, h, w)
        got = tapi.CRF(img, torch.from_numpy(unary))
        assert got.shape == (h, w, M) and got.dtype == torch.float32
        assert torch.equal(got, tapi.CRF(img, torch.from_numpy(unary), engine=engine))


@pytest.fixture
def _jax_native(tmp_path, monkeypatch):
    """JAX's native engine built in a temporary copy of native/."""
    from tests.test_torch_port_engines import jax_native_in

    jax_native_in(tmp_path, monkeypatch)


@pytest.mark.parametrize("engine,h,w", [("exact", 40, 50), ("mmgrid", 60, 90), ("grid", 40, 50),
                                        ("lattice", 60, 90), ("native", 30, 40)])
def test_crf_matches_jax(engine, h, w, request):
    if engine == "native":
        request.getfixturevalue("_jax_native")
    img, unary = _crf_case(1, h, w)
    ref = np.asarray(japi.CRF(img, unary, scale_factor=1.0, engine=engine))
    s0, l0 = mk.splat.launches, mk.slice.launches
    got = tapi.CRF(img, torch.from_numpy(unary), scale_factor=1.0, engine=engine)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
    assert (mk.splat.launches, mk.slice.launches) == (s0, l0)  # CPU tensors: plain versions
    # a float image gives the uint8 image's marginals: the engines round it
    again = tapi.CRF(img.astype(np.float32) + 0.3, torch.from_numpy(unary), engine=engine)
    assert torch.equal(again, got)


@pytest.mark.parametrize("engine", ["grid", "lattice", "native"])
def test_crf_engine_resolution_names_each_engine(engine):
    """``CRF(engine=...)`` runs the named engine at any size, returns f32
    marginals on the unary's device, and the native engine (the host's C++
    exact mean field) gives the exact engine's marginals."""
    img, unary = _crf_case(3, 24, 30)
    got = tapi.CRF(img, torch.from_numpy(unary), maxiter=5, engine=engine)
    assert got.shape == (24, 30, M) and got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)
    exact = tapi.CRF(img, torch.from_numpy(unary), maxiter=5, engine="exact")
    if engine == "native":
        np.testing.assert_allclose(got.numpy(), exact.numpy(), atol=1e-4)
    else:
        assert (got.argmax(-1) == exact.argmax(-1)).float().mean() > 0.95


def test_crf_numpy_inputs_need_a_device():
    img, unary = _crf_case(2, 8, 9)
    got = tapi.CRF(img, unary, engine="exact", device="cpu")
    assert torch.equal(got, tapi.CRF(torch.from_numpy(img), torch.from_numpy(unary), engine="exact"))
    with pytest.raises(ValueError):
        tapi.CRF(img[:, :5], unary, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tapi.CRF(img, unary)


# ---------------------------------------------------------------- probabilities

@pytest.mark.parametrize("mode", [{"sizes": [41, 57]}, {"scales": [0.75, 1.0]}, {}])
def test_predict_probs_matches_jax(mode):
    jp, tp = _predictors()
    for im in _images(np.random.default_rng(3), n=2):
        ref = jp.predict_probs(im, **mode)
        got = tp.predict_probs(im, **mode)
        assert got.shape == im.shape[:2] + (M,) and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_predict_probs_batch_matches_jax_and_per_image():
    jp, tp = _predictors()
    images = _images(np.random.default_rng(4))
    ref = jp.predict_probs_batch(images, sizes=[41])
    got = tp.predict_probs_batch(images, sizes=[41])
    for im, r, g in zip(images, ref, got):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(g, tp.predict_probs(im, sizes=[41]), rtol=1e-4, atol=1e-5)
    for r, g in zip(jp.predict_probs_batch(images, scales=[1.0]), tp.predict_probs_batch(images, scales=[1.0])):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-5)


def test_bucketed_forward_is_masked_and_exact():
    """bucket > 1 pads to 8k+1 shapes and masks the forward: the same
    probabilities as the per-shape forward, and as the JAX bucketed path."""
    jp, tp = _predictors(bucket=8)
    _, tp1 = _predictors(bucket=1)
    assert tp.exact_canvas and tp._pad_size(41) == 41 + 8 and tp._pad_size(40) == 41
    assert tp1._pad_size(41) == 41
    images = _images(np.random.default_rng(5))
    for im in images:
        got = tp.predict_probs(im, scales=[1.0])
        np.testing.assert_allclose(got, jp.predict_probs(im, scales=[1.0]), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got, tp1.predict_probs(im, scales=[1.0]), rtol=1e-4, atol=1e-5)
    for g, r in zip(tp.predict_probs_batch(images, scales=[1.0]), tp1.predict_probs_batch(images, scales=[1.0])):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-5)


def test_model_without_valid_hw_forwards_the_padded_canvas_unmasked():
    """A model that takes no ``valid_hw`` gets the zero-padded bucket as it is."""
    class NoMask(torch.nn.Module):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, x):
            return self.inner(x)

    _, tp = _predictors(bucket=8)
    plain = tinf.Predictor(NoMask(tp.model), num_classes=M, bucket=8, device="cpu")
    assert not plain.exact_canvas
    im = np.random.default_rng(7).normal(size=(40, 45, 3)).astype(np.float32)
    x = np.zeros((1, 41, 49, 3), np.float32)
    x[0, :40, :45] = im
    with torch.inference_mode():
        ref = tp.model(torch.from_numpy(x))[0, :5, :6].numpy()
    np.testing.assert_array_equal(plain.scores_at_size(im), ref)


def test_sizes_and_scales_together_are_rejected():
    _, tp = _predictors()
    im = _images(np.random.default_rng(6), n=1)[0]
    for call in (lambda: tp.predict_probs(im, sizes=[41], scales=[1.0]),
                 lambda: tp.predict_probs_batch([im], sizes=[41], scales=[1.0]),
                 lambda: tp.predict_masks([im], sizes=[41], scales=[1.0]),
                 lambda: tp.predict_mask(im, sizes=[41], scales=[1.0])):
        with pytest.raises(ValueError, match="sizes/scales"):
            call()


# ---------------------------------------------------------------- masks

@pytest.mark.parametrize("smooth", [False, True])
def test_predict_masks_matches_jax(smooth):
    jp, tp = _predictors()
    images = _images(np.random.default_rng(7))
    ref = jp.predict_masks(images, sizes=[41], smooth=smooth, canvas_bucket=16, crf_batch=2)
    got = tp.predict_masks(images, sizes=[41], smooth=smooth, canvas_bucket=16, crf_batch=2)
    for im, r, g in zip(images, ref, got):
        assert g.shape == im.shape[:2] and g.dtype == np.uint8
        if smooth:
            assert (g == r).mean() > 0.99
        else:
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("engine", ["auto", "mmgrid"])
def test_predict_mask_restrict_labels_matches_jax(engine):
    jp, tp = _predictors()
    restrict = [0, 4, 1]  # not in class order: the argmax maps back through the list
    for im in _images(np.random.default_rng(8)):
        ref = jp.predict_mask(im, sizes=[41], restrict_labels=np.asarray(restrict), crf_engine=engine)
        got = tp.predict_mask(im, sizes=[41], restrict_labels=restrict, crf_engine=engine)
        assert got.dtype == np.uint8 and set(np.unique(got)) <= set(restrict)
        np.testing.assert_array_equal(got, ref)
        free = tp.predict_mask(im, sizes=[41], crf_engine=engine)
        np.testing.assert_array_equal(free, jp.predict_mask(im, sizes=[41], crf_engine=engine))


def test_restrict_labels_ties_go_to_the_first_listed(monkeypatch):
    jp, tp = _predictors()
    im = _images(np.random.default_rng(9), n=1)[0]
    tied = np.full(im.shape[:2] + (M,), 1.0 / M, np.float32)
    tied[:5, :, 2] = 0.5  # a clear winner in a band, outside the list
    for p in (jp, tp):
        monkeypatch.setattr(p, "predict_probs", lambda *a, **k: tied)
    for restrict in ([3, 0, 1], [1, 3, 0], [2, 5]):
        got = tp.predict_mask(im, smooth=False, restrict_labels=restrict)
        np.testing.assert_array_equal(got, jp.predict_mask(im, smooth=False, restrict_labels=np.asarray(restrict)))
        expect = 2 if 2 in restrict else restrict[0]
        assert (got[:5] == expect).all() and (got[5:] == restrict[0]).all()


# ---------------------------------------------------------------- the slice as a whole

def _stage2_batch(images, masks, crop=41):
    """Images and label maps cropped or padded to ``crop``², pads ignored,
    as the data layer builds a stage-2 batch."""
    b = len(images)
    x = np.zeros((b, crop, crop, 3), np.float32)
    y = np.full((b, crop, crop), 255, np.int32)
    for i, (im, mask) in enumerate(zip(images, masks)):
        h, w = min(im.shape[0], crop), min(im.shape[1], crop)
        x[i, :h, :w] = im[:h, :w, ::-1].astype(np.float32) - np.array([104.0, 117.0, 123.0], np.float32)
        y[i, :h, :w] = mask[:h, :w]
    return {"images": x, "labels": y}


def test_pseudo_gt_then_stage2_matches_jax():
    """Stage 1's predictor makes pseudo ground truth restricted to each
    image's labels; stage 2 trains on it.  The port's masks agree with the
    JAX package's, and the JAX masks give both stage-2 steps the same
    metrics."""
    jp, tp = _predictors()
    images = _images(np.random.default_rng(10))
    label_sets = [[0, 1, 3], [0, 2], [0, 3, 5]]
    jmasks, tmasks = [], []
    for im, labels in zip(images, label_sets):
        jmasks.append(jp.predict_mask(im, sizes=[41], restrict_labels=np.asarray(labels)))
        tmasks.append(tp.predict_mask(im, sizes=[41], restrict_labels=labels))
        assert set(np.unique(tmasks[-1])) <= set(labels)
        assert (tmasks[-1] == jmasks[-1]).mean() > 0.99
    assert len(set(np.concatenate([m.ravel() for m in jmasks]).tolist())) > 1

    batch = _stage2_batch(images, jmasks)
    kw = dict(num_classes=M, batch_size=3, crop_size=41, mirror=False)
    jmodel = JaxLargeFOV(num_classes=M, head_dilations=(2, 4), dropout_rate=0.0)
    jstate, tx, _ = jstage2.init_stage2(jmodel, JaxStage2Config(**kw))
    jstep = jax.jit(jstage2.make_stage2_step(jmodel, JaxStage2Config(**kw), tx))
    model = DeepLabLargeFOV(num_classes=M, head_dilations=(2, 4), dropout_rate=0.0)
    state = init_stage2(model, Stage2Config(**kw), device="cpu")
    state.load_state_dict(state_from_flax(jax.tree.map(np.asarray, jstate.params),
                                          jax.tree.map(np.asarray, jstate.opt_state), jstate.step))
    step = make_stage2_step(model, Stage2Config(**kw), state.optimizer, state.generator)
    for _ in range(2):
        jstate, jm = jstep(jstate, batch)
        m = step(batch)
        for key in ("loss", "accuracy", "grad_norm"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=1e-4, err_msg=key)


def test_close_shuts_the_zoom_pool_down():
    _, tp = _predictors()
    images = _images(np.random.default_rng(11), n=2)
    first = tp.predict_probs_batch(images, sizes=[41])
    pool = tp._pool
    assert pool is not None
    tp.close()
    assert tp._pool is None and pool._shutdown
    tp.close()  # a second close is a no-op
    for a, b in zip(tp.predict_probs_batch(images, sizes=[41]), first):  # a new pool on next use
        np.testing.assert_array_equal(a, b)
    tp.close()
