"""The fp32 ``DenseCRF`` of the JAX package and of the port against a
float64 reference (``_crf_f64.py``) on the CPU: the witness for the card
tests' two tolerances on the object API."""

import numpy as np
import pytest

import _crf_f64
from dsrg_tpu.ops.crf import api as japi
from dsrg_tpu_torch.ops.crf import api as tapi


@pytest.mark.parametrize("ntype", _crf_f64.NTYPES)
def test_dense_crf_fp32_spread_around_float64(ntype):
    """Why the card tests hold ``DenseCRF`` to the CPU on region-coherent
    inputs at 1e-4 but on i.i.d. ones only to the float64 answer.  On a
    two-colour image with probabilities that favour one class per region,
    the JAX package and the port (both fp32) sit within 1e-5 of a float64
    reference.  On a pixel-noise image with i.i.d. probabilities both sit
    up to ~1e-3 from it (fp32 rounding decides near-ties), the JAX package
    itself above 1e-4 on some seed: no two fp32 engines can agree to 1e-4
    there.  Every fp32 result stays within ``_crf_f64.IID_TOL``."""
    errs = {"jax": [], "port": []}
    cases = [("coherent", _crf_f64.coherent_case(8))] + [("iid", _crf_f64.iid_case(s)) for s in _crf_f64.IID_SEEDS]
    for kind, (image, probs) in cases:
        ref = _crf_f64.mean_field_f64(image, probs, ntype)
        for name, mod, kw in (("jax", japi, {}), ("port", tapi, {"device": "cpu"})):
            crf = mod.DenseCRF(_crf_f64.W, _crf_f64.H, _crf_f64.M, **kw)
            q = np.asarray(_crf_f64.set_up(crf, mod.PottsCompatibility, image, probs, ntype).inference(10))
            err = float(np.abs(q.reshape(ref.shape) - ref).max())
            if kind == "coherent":
                assert err <= 1e-5, (name, err)
            else:
                errs[name].append(err)
    for name, each in errs.items():
        assert max(each) <= _crf_f64.IID_TOL, (name, each)
    assert max(errs["jax"]) > 1e-4, errs
