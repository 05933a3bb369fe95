"""The port's backbone and Caffe ops held against the JAX package on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsrg_tpu.models import DeepLabLargeFOV as JaxLargeFOV
from dsrg_tpu.models import masking as jmask
from dsrg_tpu.ops import pooling as jpool
from dsrg_tpu.ops.softmax import floored_softmax as j_floored_softmax
from dsrg_tpu_torch.models import DeepLabLargeFOV
from dsrg_tpu_torch.models import masking as tmask
from dsrg_tpu_torch.models.convert import flax_from_params, params_from_flax
from dsrg_tpu_torch.ops import pooling as tpool
from dsrg_tpu_torch.ops.softmax import floored_softmax


@pytest.mark.parametrize("size,k,s,p", [(41, 3, 2, 1), (40, 3, 2, 1), (8, 3, 2, 1),
                                        (17, 3, 1, 1), (10, 2, 2, 0), (6, 3, 3, 1)])
def test_pool_geometry_matches_jax(size, k, s, p):
    assert tpool._caffe_pool_geometry(size, k, s, p) == jpool._caffe_pool_geometry(size, k, s, p)


@pytest.mark.parametrize("shape,k,s,p", [((2, 13, 10, 3), 3, 2, 1), ((1, 9, 16, 2), 3, 1, 1),
                                         ((1, 7, 7, 2), 3, 3, 1)])
def test_caffe_max_pool_matches_jax(shape, k, s, p):
    # small integers: many ties, so window placement errors cannot hide
    x = np.random.default_rng(sum(shape)).integers(-5, 5, shape).astype(np.float32)
    ref = np.asarray(jpool.caffe_max_pool(jnp.asarray(x), k, s, p))
    got = tpool.caffe_max_pool(torch.from_numpy(x), k, s, p).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape,k,s,p", [((2, 11, 8, 3), 3, 1, 1), ((1, 10, 13, 2), 3, 2, 1),
                                         ((1, 7, 7, 2), 3, 3, 1)])
def test_caffe_avg_pool_matches_jax(shape, k, s, p):
    x = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32)
    ref = np.asarray(jpool.caffe_avg_pool(jnp.asarray(x), k, s, p))
    got = tpool.caffe_avg_pool(torch.from_numpy(x), k, s, p).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_floored_softmax_matches_jax():
    x = np.random.default_rng(0).normal(size=(4, 5, 21)).astype(np.float32) * 5
    ref = np.asarray(j_floored_softmax(jnp.asarray(x)))
    got = floored_softmax(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_masking_matches_jax():
    vh, vw = np.array([5.0, 9.0], np.float32), np.array([7.0, 3.0], np.float32)
    ref = np.asarray(jmask.valid_mask(9, 8, jnp.asarray(vh), jnp.asarray(vw)))
    got = tmask.valid_mask(9, 8, torch.from_numpy(vh), torch.from_numpy(vw)).numpy()
    np.testing.assert_array_equal(got, ref)
    x = np.random.default_rng(1).normal(size=(2, 9, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tmask.masked_pool_input(torch.from_numpy(x), torch.from_numpy(vh), torch.from_numpy(vw)).numpy(),
        np.asarray(jmask.masked_pool_input(jnp.asarray(x), jnp.asarray(vh), jnp.asarray(vw))))
    v = np.array([1.0, 8.0, 41.0, 321.0], np.float32)
    np.testing.assert_array_equal(tmask.pool_out_extent(torch.from_numpy(v)).numpy(),
                                  np.asarray(jmask.pool_out_extent(jnp.asarray(v))))


def _models(m=6, heads=(2, 4), size=65):
    jm = JaxLargeFOV(num_classes=m, head_dilations=heads)
    params = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, size, size, 3)),
                     train=False)["params"]
    tm = DeepLabLargeFOV(num_classes=m, head_dilations=heads)
    tm.load_state_dict(params_from_flax(params))
    return jm, params, tm.eval()


def test_convert_round_trip_and_names():
    _, params, tm = _models()
    sd = params_from_flax(params)
    assert set(sd) == set(tm.state_dict())
    assert "fc8-SEC_2.weight" in sd and "conv5_3.bias" in sd
    back = flax_from_params(sd)
    for name, p in params.items():
        np.testing.assert_array_equal(back[name]["kernel"], np.asarray(p["kernel"]))
        np.testing.assert_array_equal(back[name]["bias"], np.asarray(p["bias"]))


@pytest.mark.parametrize("masked", [False, True])
def test_largefov_forward_matches_flax(masked):
    jm, params, tm = _models()
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(2, 65, 63, 3)) * 40).astype(np.float32)
    valid = np.array([[65, 50], [41, 63]], np.float32) if masked else None
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x), train=False,
                              valid_hw=None if valid is None else jnp.asarray(valid)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), valid_hw=None if valid is None else torch.from_numpy(valid)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def test_largefov_train_forward_is_not_ported():
    tm = DeepLabLargeFOV(num_classes=3, head_dilations=(2,))
    with pytest.raises(NotImplementedError):
        tm(torch.zeros(1, 17, 17, 3), train=True)
