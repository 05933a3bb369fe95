"""The port's serving export (dsrg_tpu_torch.serving, tools/export.py, the
mmgrid custom ops) held against the port's eager pipeline and the JAX
package on the CPU, at tests/test_serving.py's size."""

import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsrg_tpu import inference as jinf
from dsrg_tpu.models import DeepLabLargeFOV as JaxLargeFOV
from dsrg_tpu.ops.softmax import floored_softmax as jax_floored_softmax
from dsrg_tpu_torch import serving
from dsrg_tpu_torch.inference import Predictor
from dsrg_tpu_torch.models import DeepLabLargeFOV
from dsrg_tpu_torch.models.convert import flax_from_params
from dsrg_tpu_torch.ops.crf import mmgrid_kernels as mk
from dsrg_tpu_torch.tools import export as export_tool
from dsrg_tpu_torch.train.checkpoint import save_params

REPO = Path(__file__).resolve().parents[1]
M = 5
AGREE = 0.999  # tests/test_serving.py's bound on masks per image


@pytest.fixture(scope="module")
def models():
    """(flax module, its params, the port's module) on the same weights: a
    seeded torch init, converted (flax's own init costs ~10 s here)."""
    torch.manual_seed(0)
    tm = DeepLabLargeFOV(num_classes=M, head_dilations=(2, 4))
    return JaxLargeFOV(num_classes=M, head_dilations=(2, 4)), flax_from_params(tm.state_dict()), tm


def _images():
    """tests/test_serving.py's three two-colour images."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(3):
        h, w = 40 + 5 * i, 52 - 4 * i
        img = np.zeros((h, w, 3), np.uint8)
        img[:, : w // 2] = [200, 60, 50]
        img[:, w // 2:] = [30, 180, 190]
        out.append(np.clip(img.astype(np.int32) + rng.integers(-8, 8, img.shape), 0, 255).astype(np.uint8))
    return out


@pytest.mark.parametrize("mode", [{"sizes": (41,)}, {"sizes": None, "scales": (0.75, 1.0)}])
def test_pipeline_artifact_matches_eager_and_jax(tmp_path, models, mode):
    """Canvas 64x64, batch 2, CRF on: three images through the exported
    batch of two (the last chunk padded), against the port's and the JAX
    package's predict_masks_device on the same canvas (one chunk of three:
    an image's mask does not depend on its chunk); the program holds the
    CRF's 11 + 11 custom-op calls."""
    jm, params, tm = models
    images = _images()
    path = serving.export_pipeline(tm, str(tmp_path / "pipe.pt2"), canvas_hw=(64, 64), batch=2,
                                   smooth=True, num_classes=M, device="cpu", **mode)
    served = serving.ServingPipeline(path)
    calls = Counter(str(n.target) for n in served._program.graph.nodes if n.op == "call_function")
    assert (calls["dsrg_tpu_torch.mmgrid_splat.default"], calls["dsrg_tpu_torch.mmgrid_slice.default"]) == (11, 11)
    assert (served.batch, served.ph, served.pw) == (2, 64, 64)
    got = served(images)
    kw = {k: v for k, v in mode.items() if v is not None}
    eager = Predictor(tm, num_classes=M, device="cpu").predict_masks_device(images, smooth=True,
                                                                             canvas_bucket=64, **kw)
    ref = jinf.Predictor(jm, params, num_classes=M).predict_masks_device(images, smooth=True,
                                                                         canvas_bucket=64, **kw)
    for g, e, r in zip(got, eager, ref):
        assert g.shape == e.shape == r.shape and g.dtype == np.uint8
        assert (g == e).mean() >= AGREE, (g == e).mean()
        assert (g == r).mean() >= AGREE, (g == r).mean()


def test_deploy_artifact_matches_jax(tmp_path, models):
    jm, params, tm = models
    x = np.random.default_rng(1).normal(size=(1, 41, 41, 3)).astype(np.float32) * 40
    path = serving.export_deploy(tm, str(tmp_path / "deploy.pt2"), input_shape=(1, 41, 41, 3), device="cpu")
    served = serving.ServingModel(path)
    assert served.input_shape == (1, 41, 41, 3)
    ref = np.asarray(jax_floored_softmax(jm.apply({"params": params}, jnp.asarray(x), train=False)))
    np.testing.assert_allclose(served(x), ref, rtol=1e-4, atol=1e-5)
    fn, example = serving.make_deploy_fn(tm, (1, 41, 41, 3), with_softmax=False)
    assert example.shape == (1, 41, 41, 3) and example.dtype == torch.float32
    with torch.no_grad():
        scores = fn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(scores, np.asarray(jm.apply({"params": params}, jnp.asarray(x), train=False)),
                               rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def cli_artifacts(tmp_path_factory):
    """tools/export.py in both modes on a 21-class snapshot, on the CPU."""
    tmp = tmp_path_factory.mktemp("export_cli")
    params = str(tmp / "params")
    torch.manual_seed(0)
    save_params(params, DeepLabLargeFOV(num_classes=21))
    out = {}
    for mode, extra in (("pipeline", ["--canvas", "64", "64", "--sizes", "41", "--no-smooth"]),
                        ("deploy", ["--input-size", "41"])):
        out[mode] = str(tmp / f"{mode}.pt2")
        export_tool.main(["--model", params, "--output", out[mode], "--mode", mode, "--batch", "2",
                          "--device", "cpu", *extra])
    return out


def test_export_cli_both_modes(cli_artifacts):
    masks = serving.ServingPipeline(cli_artifacts["pipeline"])([np.zeros((48, 60, 3), np.uint8)])
    assert masks[0].shape == (48, 60) and masks[0].dtype == np.uint8 and masks[0].max() < 21
    deploy = serving.ServingModel(cli_artifacts["deploy"])
    assert deploy.input_shape == (2, 41, 41, 3)
    probs = deploy(np.zeros((2, 41, 41, 3), np.float32))
    assert probs.shape == (2, 6, 6, 21)
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)


def test_export_cli_refuses_platforms(tmp_path):
    with pytest.raises(SystemExit, match="jax.export lowering list and has no meaning for torch.export"):
        export_tool.main(["--model", str(tmp_path / "none"), "--output", str(tmp_path / "a.pt2"),
                          "--platforms", "cpu"])


def test_artifacts_load_in_a_process_without_jax(cli_artifacts):
    code = ("import sys\nimport numpy as np\n"
            "from dsrg_tpu_torch.serving import ServingModel, ServingPipeline\n"
            f"m = ServingPipeline({cli_artifacts['pipeline']!r})([np.zeros((30, 40, 3), np.uint8)])[0]\n"
            f"p = ServingModel({cli_artifacts['deploy']!r})(np.zeros((2, 41, 41, 3), np.float32))\n"
            "print(m.shape, p.shape, 'jax' in sys.modules)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "(30, 40) (2, 6, 6, 21) False", out.stdout + out.stderr


def _op_inputs(seed, t=3, px=20, gc=5, c=4):
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, gc - 1, (3, t, px))
    idx = mk.pack_index(*(torch.from_numpy(a) for a in lo), gc)
    fb, fg, fr = torch.from_numpy(rng.random((3, t, px)).astype(np.float32))
    wbg4 = torch.stack([(1 - fb) * (1 - fg), (1 - fb) * fg, fb * (1 - fg), fb * fg], 1).bfloat16()
    wr2 = torch.stack([1 - fr, fr], 1).bfloat16()
    values = torch.from_numpy(rng.normal(size=(t, c, px)).astype(np.float32))
    slab = torch.from_numpy(rng.normal(size=(t, gc * gc, gc * c)).astype(np.float32)).bfloat16()
    return idx, wbg4, wr2, values, slab, gc


@pytest.mark.parametrize("op", ["splat", "slice"])
def test_custom_ops_pass_opcheck(op):
    """Schema, fake implementation against the CPU kernel, and export's
    dynamic-shape dispatch of the two custom ops; the CPU kernels count no
    launch."""
    idx, wbg4, wr2, values, slab, gc = _op_inputs(3)
    if op == "splat":
        fn, args = mk._splat_op, (idx, mk.sort_pixels(idx), wbg4, wr2, values, gc)
    else:
        fn, args = mk._slice_op, (idx, wbg4, wr2, slab, gc)
    launches = (mk.splat.launches, mk.slice.launches)
    torch.library.opcheck(fn, args)
    assert (mk.splat.launches, mk.slice.launches) == launches
    want = mk.splat_plain(idx, wbg4, wr2, values, gc) if op == "splat" else mk.slice_plain(idx, wbg4, wr2, slab, gc)
    np.testing.assert_array_equal(fn(*args).numpy(), want.numpy())
