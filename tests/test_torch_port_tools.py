"""The port's seed-quality and visual CLIs and the neutrality study held
against the JAX package on the CPU: ``ap``'s report file equals JAX's text,
``dump_cues`` writes JAX's masks with and without ``--grow``,
``show_result`` JAX's prediction and panel, ``make_photo_like`` JAX's
arrays for a seed, and ``engine_neutrality`` at 60x80 reports JAX's keys
with agreements within 1e-3 (each package's engines against its own
build of the native oracle, which are bit-equal: see
``tests/test_torch_port_engines.py``)."""

import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dsrg_tpu.data.cues import save_cue_db
from dsrg_tpu.models import DeepLabLargeFOV as JaxLargeFOV
from dsrg_tpu.tools import _infer_common as jcommon
from dsrg_tpu.tools import ap as jap
from dsrg_tpu.tools import dump_cues as jdump
from dsrg_tpu.tools import neutrality_study as jns
from dsrg_tpu.tools import show_result as jshow
from dsrg_tpu_torch.models.convert import params_from_flax
from dsrg_tpu_torch.tools import ap, dump_cues, neutrality_study, show_result
from dsrg_tpu_torch.train import checkpoint as ckpt
from tests.test_torch_port_engines import jax_native_in

M = 6


@pytest.fixture(autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def voc_tree(tmp_path_factory):
    """Three two-colour images with ground truth, a cue pickle and the same
    weights (flax init, 6 classes, the CLIs' default heads) for both
    packages."""
    root = tmp_path_factory.mktemp("voc")
    (root / "JPEGImages").mkdir()
    (root / "gt").mkdir()  # at the cues' 41x41, for ap
    (root / "SegmentationClass").mkdir()  # at the images' sizes, for show_result
    rng = np.random.default_rng(0)
    entries, rows = {}, []
    for i in range(3):
        img_id = f"2007_{i:06d}"
        h, w = 45 + 4 * i, 50
        img = np.zeros((h, w, 3), np.int32)
        img[:, : w // 2] = [200, 60, 50]
        img[:, w // 2:] = [30, 180, 190]
        img = np.clip(img + rng.integers(-10, 10, img.shape), 0, 255).astype(np.uint8)
        Image.fromarray(img).save(root / "JPEGImages" / f"{img_id}.jpg")
        gt = np.zeros((41, 41), np.uint8)
        gt[:, 20:] = 2 + i % 2
        gt[:2] = 255
        Image.fromarray(gt).save(root / "gt" / f"{img_id}.png")
        full = np.zeros((h, w), np.uint8)
        full[:, w // 2:] = 2 + i % 2
        Image.fromarray(full).save(root / "SegmentationClass" / f"{img_id}.png")
        entries[i] = (np.array([2 + i % 2]),
                      (rng.integers(0, M, 9), rng.integers(0, 41, 9), rng.integers(0, 41, 9)))
        rows.append(f"{img_id}.jpg {i}")
    save_cue_db(str(root / "cues.pickle"), entries)
    (root / "input_list.txt").write_text("\n".join(rows) + "\n")
    (root / "ids.txt").write_text("\n".join(r.split()[0][:-4] for r in rows) + "\n")
    jm = JaxLargeFOV(num_classes=M)
    params = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 41, 41, 3)), train=False)["params"]
    params = jax.tree.map(np.asarray, params)
    ckpt.save_params(str(root / "params"), params_from_flax(params))
    return root, params


def _read(path):
    return np.asarray(Image.open(path))


@pytest.mark.parametrize("grow", [False, True])
def test_dump_cues_matches_jax(voc_tree, tmp_path, monkeypatch, grow):
    """With --grow the weights favour class 2 (fc8 biases), so that its
    refined probabilities pass th2 and the seeds grow."""
    root, params = voc_tree
    params = jax.tree.map(np.array, params)
    for k, v in params.items():
        if k.startswith("fc8"):
            v["bias"][2] += 1.0
    ckpt.save_params(str(tmp_path / "params"), params_from_flax(params))
    monkeypatch.setattr(jcommon, "load_params", lambda path, template=None: params)
    common = ["--images", str(root / "input_list.txt"), "--dir", str(root), "--cues", str(root / "cues.pickle"),
              "--num-classes", str(M)] + (["--grow"] if grow else [])
    jdump.main(common + ["--output", str(tmp_path / "jax")] + (["--model", "unused"] if grow else []))
    dump_cues.main(common + ["--output", str(tmp_path / "torch"), "--device", "cpu"]
                   + (["--model", str(tmp_path / "params")] if grow else []))
    grown = 0
    for i in range(3):
        a, b = (_read(tmp_path / d / f"2007_{i:06d}_cue.png") for d in ("jax", "torch"))
        assert b.shape == (41, 41) and b.dtype == np.uint8
        np.testing.assert_array_equal(b, a)
        grown += int((b != 255).sum())
    assert (grown > 27) == grow  # 9 seeds an image; --grow adds pixels


def test_ap_report_equals_jax(voc_tree, tmp_path):
    """Cue masks from ``dump_cues`` (255 where unseeded) scored by both
    reports: the same file, character for character."""
    root, _ = voc_tree
    dump_cues.main(["--images", str(root / "input_list.txt"), "--dir", str(root), "--cues",
                    str(root / "cues.pickle"), "--output", str(tmp_path / "cues"), "--num-classes", str(M)])
    argv = ["--pred", str(tmp_path / "cues"), "--gt", str(root / "gt"), "--test_ids", str(root / "ids.txt"),
            "--class_num", str(M), "--save_path"]
    jap.main(argv + [str(tmp_path / "j.txt")])
    miou = ap.main(argv + [str(tmp_path / "t.txt")])
    text = (tmp_path / "t.txt").read_text()
    assert text == (tmp_path / "j.txt").read_text()
    assert text.startswith("accuracy per class: ") and f"meanIOU: {miou}\n" in text


def test_show_result_matches_jax(voc_tree, tmp_path, monkeypatch):
    """One image: the palette mask, the (image | prediction | ground truth)
    panel and the saved probabilities."""
    root, params = voc_tree
    monkeypatch.setattr(jcommon, "load_params", lambda path, template=None: params)
    (tmp_path / "one.txt").write_text("2007_000001\n")
    common = ["--images", str(tmp_path / "one.txt"), "--dir", str(root), "--num-classes", str(M), "--gt",
              str(root / "SegmentationClass"), "--save-probs"]
    jshow.main(common + ["--model", "unused", "--output", str(tmp_path / "jax")])
    show_result.main(common + ["--model", str(root / "params"), "--output", str(tmp_path / "torch"), "--device",
                               "cpu"])
    a, b = (_read(tmp_path / d / "2007_000001.png") for d in ("jax", "torch"))
    assert Image.open(tmp_path / "torch" / "2007_000001.png").mode == "P"
    assert b.shape == (49, 50) and (a == b).mean() >= 0.99
    va, vb = (_read(tmp_path / d / "2007_000001_vis.png") for d in ("jax", "torch"))
    assert vb.shape == va.shape == (49, 150, 3) and (va == vb).all(-1).mean() >= 0.99
    pa, pb = (np.load(tmp_path / d / "2007_000001.npy") for d in ("jax", "torch"))
    np.testing.assert_allclose(pb, pa, rtol=0, atol=1e-4)


@pytest.mark.parametrize("seed,h,w,regions,classes", [(0, 60, 80, 8, 21), (3, 41, 41, 4, 5)])
def test_make_photo_like_matches_jax(seed, h, w, regions, classes):
    ours = neutrality_study.make_photo_like(np.random.default_rng(seed), h, w, regions, classes)
    theirs = jns.make_photo_like(np.random.default_rng(seed), h, w, regions, classes)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_engine_neutrality_matches_jax(tmp_path, monkeypatch):
    jax_native_in(tmp_path, monkeypatch)
    ref = jns.engine_neutrality(n_images=2, h=60, w=80)
    got = neutrality_study.engine_neutrality(n_images=2, h=60, w=80, device="cpu")
    assert got.keys() == ref.keys()
    assert got["geometry"] == ref["geometry"] and got["n_images"] == ref["n_images"] == 2
    for engine in ("mmgrid", "lattice", "grid"):
        assert got[engine].keys() == ref[engine].keys()
        key = "argmax_agreement_vs_reference_algo"
        assert abs(got[engine][key] - ref[engine][key]) <= 1e-3, engine
        assert got[engine][key] > 0.95
        assert abs(got[engine]["mean_abs_marginal_diff"] - ref[engine]["mean_abs_marginal_diff"]) <= 1e-3
