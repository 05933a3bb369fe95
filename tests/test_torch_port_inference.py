"""The port's serving pipeline (dsrg_tpu_torch.inference) held against the
JAX package's device pipeline on the CPU, end to end."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsrg_tpu import inference as jinf
from dsrg_tpu.models import DeepLabLargeFOV as JaxLargeFOV
from dsrg_tpu_torch import inference as tinf
from dsrg_tpu_torch import resolve_device
from dsrg_tpu_torch.models import DeepLabLargeFOV
from dsrg_tpu_torch.models.convert import params_from_flax


def _predictors(m=6):
    jm = JaxLargeFOV(num_classes=m, head_dilations=(2, 4))
    params = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 41, 41, 3)),
                     train=False)["params"]
    jp = jinf.Predictor(jm, params, num_classes=m, bucket=1)
    tp = tinf.Predictor(DeepLabLargeFOV(num_classes=m, head_dilations=(2, 4)),
                        params_from_flax(params), num_classes=m, device="cpu")
    return jp, tp


def _images(rng, n=3):
    """The three small two-colour images of tests/test_batched_inference.py."""
    out = []
    for i in range(n):
        h, w = 40 + 7 * i, 52 - 5 * i
        img = np.zeros((h, w, 3), np.uint8)
        img[:, : w // 2] = [200, 60, 50]
        img[:, w // 2:] = [30, 180, 190]
        img = np.clip(img.astype(np.int32) + rng.integers(-8, 8, img.shape), 0, 255).astype(np.uint8)
        out.append(img)
    return out


@pytest.mark.parametrize("mode", [{"sizes": [41, 57]}, {"scales": [0.75, 1.0, 1.25]}])
def test_predict_masks_device_matches_jax(mode):
    jp, tp = _predictors()
    images = _images(np.random.default_rng(4))
    ref = jp.predict_masks_device(images, smooth=True, canvas_bucket=16, **mode)
    got = tp.predict_masks_device(images, smooth=True, canvas_bucket=16, **mode)
    for im, r, g in zip(images, ref, got):
        assert g.shape == r.shape == im.shape[:2]
        assert g.dtype == np.uint8
        agree = (g == r).mean()
        assert agree > 0.99, agree


def test_iter_masks_device_matches_chunked_predict():
    _, tp = _predictors()
    images = _images(np.random.default_rng(9), n=3)
    streamed = list(tp.iter_masks_device(iter(images), sizes=[33], chunk=2, smooth=False,
                                         canvas_bucket=16))
    assert [im is s for im, (s, _) in zip(images, streamed)] == [True] * 3
    direct = tp.predict_masks_device(images[:2], sizes=[33], smooth=False, canvas_bucket=16)
    direct += tp.predict_masks_device(images[2:], sizes=[33], smooth=False, canvas_bucket=16)
    for (_, mk), d in zip(streamed, direct):
        np.testing.assert_array_equal(mk, d)


@pytest.mark.parametrize("caps", [(20, 41, 41.0, 20.0), (57, 41, 30.0, 57.0), (9, 16, 1.0, 1.0),
                                  (33, 12, 12.0, 25.0)])
def test_dyn_interp_rows_matches_jax(caps):
    out_cap, in_cap, iv, ov = caps
    ref = np.asarray(jinf._dyn_interp_rows(out_cap, in_cap, jnp.float32(iv), jnp.float32(ov)))
    got = tinf._dyn_interp_rows(out_cap, in_cap, torch.tensor([iv]), torch.tensor([ov])).numpy()[0]
    np.testing.assert_array_equal(got, ref)


def test_pack_canvas_matches_jax():
    images = _images(np.random.default_rng(2))
    for a, b in zip(tinf.pack_canvas(images, 4, 64, 64), jinf.pack_canvas(images, 4, 64, 64)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tinf.pack_canvas(images, 3, 32, 48)


def test_predict_masks_device_needs_one_mode():
    _, tp = _predictors()
    images = _images(np.random.default_rng(0), n=1)
    with pytest.raises(ValueError):
        tp.predict_masks_device(images, sizes=[41], scales=[1.0])
    with pytest.raises(ValueError):
        tp.predict_masks_device(images)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    with pytest.raises(RuntimeError, match="CUDA"):
        tinf.Predictor(DeepLabLargeFOV(num_classes=3, head_dilations=(2,)))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
