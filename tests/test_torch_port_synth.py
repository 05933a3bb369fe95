"""The port's synthetic data and evaluation held against the JAX package on
the CPU: ``data/synth.py`` gives the same arrays for a seed, and
``utils/confusion.py`` the same matrices and scores.  Also: no module of the
port imports JAX or the JAX package."""

import dataclasses
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dsrg_tpu_torch
from dsrg_tpu.data import synth as jsynth
from dsrg_tpu.utils import confusion as jconf
from dsrg_tpu_torch.data import synth as tsynth
from dsrg_tpu_torch.utils import confusion as tconf

REPO = Path(__file__).resolve().parents[1]


def test_specs_and_palette_match_jax():
    assert set(tsynth.PROFILES) == set(jsynth.PROFILES)
    for name, spec in tsynth.PROFILES.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(jsynth.PROFILES[name])
    np.testing.assert_array_equal(tsynth.PALETTE, jsynth.PALETTE)
    for a, b in zip(tsynth.signature_margins(), jsynth.signature_margins()):
        np.testing.assert_array_equal(a, b)
    for cls in range(1, 25):
        ta, tb = tsynth.class_signature(cls), jsynth.class_signature(cls)
        np.testing.assert_array_equal(ta[0], tb[0])
        assert ta[1:] == tb[1:]


# both profiles, and the easy one cut to a small crop as synth_check does it
@pytest.mark.parametrize("profile,size", [("easy", None), ("easy", 65), ("voc", None), ("voc", 161)])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_make_image_and_cues_match_jax(profile, size, seed):
    """Three images and their cues from one generator: the same arrays, and
    the generators end in the same state (the same draws in the same order)."""
    spec = tsynth.PROFILES[profile]
    if size is not None:
        spec = dataclasses.replace(spec, crop_size=size, cue_grid=(size - 1) // 8 + 1,
                                   **({"size_min": size, "size_max": size} if spec.square else {}))
    jspec = jsynth.SynthSpec(**dataclasses.asdict(spec))
    trng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):
        img, gt = tsynth.make_image(trng, spec)
        jimg, jgt = jsynth.make_image(jrng, jspec)
        np.testing.assert_array_equal(img, jimg)
        np.testing.assert_array_equal(gt, jgt)
        assert img.dtype == np.uint8 and gt.dtype == np.uint8 and img.shape[:2] == gt.shape
        for a, b in zip(tsynth.cues_from_gt(trng, gt, spec), jsynth.cues_from_gt(jrng, jgt, jspec)):
            np.testing.assert_array_equal(a, b)
    assert trng.integers(0, 2**62) == jrng.integers(0, 2**62)


def _masks(seed, n=4, h=13, w=11, nclass=6):
    rng = np.random.default_rng(seed)
    gt = rng.integers(0, nclass, (n, h, w)).astype(np.uint8)
    pred = np.where(rng.random(gt.shape) < 0.7, gt, rng.integers(0, nclass, gt.shape)).astype(np.uint8)
    gt[0, :2] = 255  # VOC's boundary label: ignored
    pred[1, :, :3] = 255  # an unseeded marker: ignored
    pred[2] = np.where(pred[2] == 4, 0, pred[2])  # class 4 never hit in image 2
    return gt, pred


@pytest.mark.parametrize("seed", [0, 1])
def test_confusion_matrix_and_scores_match_jax(seed):
    gt, pred = _masks(seed)
    np.testing.assert_array_equal(tconf.confusion_matrix_np(gt, pred, 6), jconf.confusion_matrix_np(gt, pred, 6))
    got = tconf.confusion_matrix_torch(torch.from_numpy(gt), torch.from_numpy(pred), 6)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jconf.confusion_matrix_jax(jnp.asarray(gt),
                                                                                      jnp.asarray(pred), 6)))
    np.testing.assert_array_equal(got.numpy(), jconf.confusion_matrix_np(gt, pred, 6))
    ours, ref = tconf.ConfusionMatrix(6), jconf.ConfusionMatrix(6)
    for g, p in zip(gt, pred):
        ours.add(g, p)
        ref.add(g, p)
    ours.addM(tconf.confusion_matrix_torch(torch.from_numpy(gt[:1]), torch.from_numpy(pred[:1]), 6))
    ref.addM(ref.generateM((gt[0], pred[0])))
    np.testing.assert_array_equal(ours.M, ref.M)
    mean, per, m = ours.jaccard()
    rmean, rper, _ = ref.jaccard()
    assert mean == rmean and per == rper and m is ours.M
    assert ours.recall() == ref.recall() and ours.accuracy() == ref.accuracy()


def test_jaccard_keeps_the_references_quirk():
    """A class never predicted right drops out of the mean (evaluate.py:52-59):
    an all-background prediction scores background's IoU alone."""
    gt = np.zeros((10, 10), np.uint8)
    gt[:3] = 1
    conf = tconf.ConfusionMatrix(3)
    conf.add(gt, np.zeros_like(gt))
    mean, per, _ = conf.jaccard()
    assert per == [0.7] and mean == 0.7
    with pytest.raises(ValueError):
        conf.addM(np.zeros((2, 2)))


def test_no_port_module_imports_jax():
    """Every module of the port imported in a fresh interpreter loads neither
    jax nor the JAX package (the card's machine has no JAX)."""
    names = [m.name for m in pkgutil.walk_packages(dsrg_tpu_torch.__path__, "dsrg_tpu_torch.")]
    assert "dsrg_tpu_torch.data.synth" in names and "dsrg_tpu_torch.utils.confusion" in names
    assert {"dsrg_tpu_torch.native", "dsrg_tpu_torch.data.coco", "dsrg_tpu_torch.ops.crf.lattice",
            "dsrg_tpu_torch.tools.test_coco", "dsrg_tpu_torch.tools.test_coco_f", "dsrg_tpu_torch.tools.dump_cues",
            "dsrg_tpu_torch.tools.ap", "dsrg_tpu_torch.tools.show_result",
            "dsrg_tpu_torch.tools.neutrality_study"} <= set(names)
    code = ("import sys, importlib; before = set(sys.modules)\n"
            f"for n in {names!r}: importlib.import_module(n)\n"
            "print(sorted(m for m in set(sys.modules) - before if m.split('.')[0] in ('jax', 'jaxlib', 'flax', "
            "'optax', 'dsrg_tpu')))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout
