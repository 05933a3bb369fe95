"""The port's 81-class COCO path held against the JAX package on the CPU:
``data/coco.py``'s batches (float, uint8, and from the decoded cache on a
second epoch) array for array, an 81-class stage-1 step on a COCO batch
with ``COCO_MEAN``, and ``tools/test_coco.run_coco`` through its three
pipelines (masks >= 0.99 equal to JAX's, final mIoU within 1e-3; the
non-RGB skip; ``--skip-existing`` folding the written masks back in).

The trees are tiny: images of a few thousand pixels, written as JPEGs by
PIL (the JAX package's reader), labels as PNGs with an ignore strip.
"""

import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dsrg_tpu.config import Stage1Config as JaxStage1Config
from dsrg_tpu.data import coco as jcoco
from dsrg_tpu.models import DeepLabLargeFOV as JaxLargeFOV
from dsrg_tpu.tools import _infer_common as jcommon
from dsrg_tpu.tools import test_coco as jtest_coco
from dsrg_tpu.train.stage1 import make_optimizer as j_make_optimizer
from dsrg_tpu.train.stage1 import make_stage1_step as j_make_stage1_step
from dsrg_tpu.train.train_state import TrainState as JaxTrainState
from dsrg_tpu_torch.config import Stage1Config
from dsrg_tpu_torch.data import coco as tcoco
from dsrg_tpu_torch.models import DeepLabLargeFOV
from dsrg_tpu_torch.models.convert import params_from_flax, state_from_flax
from dsrg_tpu_torch.tools import _infer_common as tcommon
from dsrg_tpu_torch.tools import test_coco, test_coco_f
from dsrg_tpu_torch.train import checkpoint as ckpt
from dsrg_tpu_torch.train.stage1 import init_stage1, make_stage1_step

M = 81
BG_BIAS = 0.02


@pytest.fixture(autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _blocky_label(rng, h, w, classes):
    """A label png's content: a few rectangles of classes on background,
    an ignore strip on top."""
    lbl = np.zeros((h, w), np.uint8)
    for c in classes:
        y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
        lbl[y0: y0 + rng.integers(h // 4, h // 2), x0: x0 + rng.integers(w // 4, w // 2)] = c
    lbl[0, :] = 255
    return lbl


def _coco_tree(root, n=3, seed=0, grey=()):
    """``n`` (image, label) pairs under ``root`` and their pair lists: one
    with leading slashes for the dataset (root + path), one without for
    ``test_coco`` (joined to the root).  Images in ``grey`` are mode L."""
    (root / "images").mkdir(exist_ok=True)
    (root / "labels").mkdir(exist_ok=True)
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        h, w = 50 + 5 * i, 60
        lbl = _blocky_label(rng, h, w, rng.choice(np.arange(1, M), 2, replace=False))
        img = np.stack([np.where(lbl == 0, 90, (lbl.astype(np.int32) * 37) % 256)] * 3, -1)
        img = np.clip(img + rng.integers(-10, 10, img.shape), 0, 255).astype(np.uint8)
        Image.fromarray(img[..., 0] if i in grey else img).save(root / "images" / f"{i}.jpg")
        Image.fromarray(lbl).save(root / "labels" / f"{i}.png")
        rows.append(f"images/{i}.jpg labels/{i}.png")
    (root / "list.txt").write_text("\n".join(rows) + "\n")
    (root / "pair_list.txt").write_text("\n".join("/" + r.replace(" ", " /") for r in rows) + "\n")
    return root


# ---------------------------------------------------------------- data/coco.py


def test_coco_mean_matches_jax():
    assert tcoco.COCO_MEAN.dtype == np.float32
    np.testing.assert_array_equal(tcoco.COCO_MEAN, jcoco.COCO_MEAN)


@pytest.mark.parametrize("ship_uint8", [False, True])
def test_coco_batches_match_jax(tmp_path, ship_uint8):
    """Four batches of 2 from 3 pairs (three epochs, reshuffled): the same
    arrays, dtypes and order."""
    root = _coco_tree(tmp_path)
    kw = dict(batch_size=2, new_size=(41, 49), num_classes=M, seed=3, ship_uint8=ship_uint8)
    ours = tcoco.COCOCueDataset(str(root), str(root / "pair_list.txt"), **kw)
    theirs = jcoco.COCOCueDataset(str(root), str(root / "pair_list.txt"), **kw)
    assert (ours.cue_h, ours.cue_w) == (theirs.cue_h, theirs.cue_w) == (6, 7)
    for _ in range(4):
        a, b = ours.next_batch(), theirs.next_batch()
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_coco_cache_matches_jax_on_a_second_epoch(tmp_path):
    """The decoded cache: the first epoch fills it, the second and a fresh
    instance read it back; every batch equals JAX's, and the port's cache
    files hold JAX's bytes under JAX's tag."""
    root = _coco_tree(tmp_path)
    kw = dict(batch_size=3, new_size=(41, 41), num_classes=M, seed=1, ship_uint8=True)
    ours = tcoco.COCOCueDataset(str(root), str(root / "pair_list.txt"), cache_dir=str(tmp_path / "tc"), **kw)
    theirs = jcoco.COCOCueDataset(str(root), str(root / "pair_list.txt"), cache_dir=str(tmp_path / "jc"), **kw)
    for _ in range(2):
        a, b = ours.next_batch(), theirs.next_batch()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert ours._cache_flags.all()
    tfiles = sorted(p.name for p in (tmp_path / "tc").iterdir())
    assert tfiles == sorted(p.name for p in (tmp_path / "jc").iterdir())
    for name in tfiles:
        assert (tmp_path / "tc" / name).read_bytes() == (tmp_path / "jc" / name).read_bytes(), name
    fresh = tcoco.COCOCueDataset(str(root), str(root / "pair_list.txt"), cache_dir=str(tmp_path / "tc"), **kw)
    assert fresh._cache_flags.all()
    again = jcoco.COCOCueDataset(str(root), str(root / "pair_list.txt"), **kw)
    for _ in range(2):
        a, b = fresh.next_batch(), again.next_batch()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with pytest.raises(ValueError, match="ship_uint8"):
        tcoco.COCOCueDataset(str(root), str(root / "pair_list.txt"), cache_dir=str(tmp_path / "x"))


# ---------------------------------------------------------------- the 81-class step

CROP, HEADS = 41, (2, 4)
STEP_CFG = dict(num_classes=M, batch_size=2, crop_size=CROP, cue_size=6, crf_iters=3, mirror=False,
                th1=0.55, th2=0.4)


def test_coco_stage1_step_matches_jax(tmp_path):
    """One 81-class step on a uint8 COCO batch with COCO_MEAN, from the same
    weights: the metrics within 1e-4 (as tests/test_torch_port_train.py),
    the parameters after it within 1e-4 of each tensor's largest entry."""
    root = _coco_tree(tmp_path)
    batch = tcoco.COCOCueDataset(str(root), str(root / "pair_list.txt"), batch_size=2, new_size=(CROP, CROP),
                                 num_classes=M, ship_uint8=True).next_batch()
    assert batch["labels"][:, 0].all() and batch["labels"].sum() > 2
    cfg = JaxStage1Config(**STEP_CFG)
    jm = JaxLargeFOV(num_classes=M, head_dilations=HEADS, dropout_rate=0.0)
    params = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, CROP, CROP, 3)), train=False)["params"]
    params = {k: ({**v, "kernel": v["kernel"] * 30.0} if k.startswith("fc8") else v) for k, v in params.items()}
    tx = j_make_optimizer(cfg)
    jstate = JaxTrainState.create(params, tx, jax.random.PRNGKey(1))
    jstate2, jmetrics = jax.jit(j_make_stage1_step(jm, cfg, tx, input_mean=jcoco.COCO_MEAN))(jstate, batch)

    model = DeepLabLargeFOV(num_classes=M, head_dilations=HEADS, dropout_rate=0.0)
    tcfg = Stage1Config(**STEP_CFG)
    state = init_stage1(model, tcfg, device="cpu")
    state.load_state_dict(state_from_flax(jax.tree.map(np.asarray, jstate.params),
                                          jax.tree.map(np.asarray, jstate.opt_state), jstate.step))
    metrics = make_stage1_step(model, tcfg, state.optimizer, state.generator, input_mean=tcoco.COCO_MEAN)(batch)
    for key in ("loss", "loss_seed", "loss_constrain", "grad_norm"):
        np.testing.assert_allclose(metrics[key].item(), float(jmetrics[key]), rtol=1e-4, err_msg=key)
    # COCO's cues are dense: every pixel but the ignored ones is a seed already
    assert metrics["seed_pixels"].item() == float(jmetrics["seed_pixels"]) >= batch["cues"].sum()
    got = params_from_flax(jax.tree.map(np.asarray, jstate2.params))
    for name, t in model.state_dict().items():
        ref = got[name].numpy() if isinstance(got[name], torch.Tensor) else np.asarray(got[name])
        np.testing.assert_allclose(t.numpy(), ref, rtol=0, atol=1e-4 * max(np.abs(ref).max(), 1e-12),
                                   err_msg=name)


# ---------------------------------------------------------------- run_coco


@pytest.fixture(scope="module")
def coco_setup(tmp_path_factory):
    """A tree of 4 pairs (the third image grey: both packages skip it) and
    the same 81-class weights for both packages."""
    root = _coco_tree(tmp_path_factory.mktemp("coco"), n=4, seed=5, grey=(2,))
    jm = JaxLargeFOV(num_classes=M)
    params = jm.init({"params": jax.random.PRNGKey(2)}, jnp.zeros((1, 41, 41, 3)), train=False)["params"]
    params = jax.tree.map(np.array, params)
    for k, v in params.items():  # background wins most pixels: a finite mIoU
        if k.startswith("fc8"):
            v["bias"][0] += BG_BIAS
    ckpt.save_params(str(root / "params"), params_from_flax(params))
    return root, params


def _argv(root, out, extra):
    return ["--images", str(root / "list.txt"), "--dir", str(root), "--output", str(out),
            "--num-classes", str(M)] + list(extra)


@pytest.mark.parametrize("extra", [
    ["--batch", "2"],  # the device stream
    ["--batch", "2", "--pipeline", "host"],  # the batched host path
    ["--batch", "1", "--smooth", "--engine", "exact"],  # per image, CRF()
])
def test_run_coco_matches_jax(coco_setup, tmp_path, monkeypatch, capsys, extra):
    root, params = coco_setup
    monkeypatch.setattr(jcommon, "load_params", lambda path, template=None: params)
    jmiou = jtest_coco.run_coco(jcommon.build_arg_parser("").parse_args(
        _argv(root, tmp_path / "jax", extra + ["--model", "unused"])), sizes=[41])
    capsys.readouterr()
    args = tcommon.build_arg_parser("").parse_args(
        _argv(root, tmp_path / "torch", extra + ["--model", str(root / "params"), "--device", "cpu"]))
    miou = test_coco.run_coco(args, sizes=[41])
    out = capsys.readouterr().out
    assert "skip non-RGB images/2.jpg" in out and "final meanIOU:" in out and "kernel launches:" in out
    assert not (tmp_path / "torch" / "2.png").exists() and not (tmp_path / "jax" / "2.png").exists()
    for i in (0, 1, 3):
        a = np.asarray(Image.open(tmp_path / "jax" / f"{i}.png"))
        b = np.asarray(Image.open(tmp_path / "torch" / f"{i}.png"))
        assert a.shape == b.shape and b.dtype == np.uint8
        assert (a == b).mean() >= 0.99
    assert np.isfinite(miou) and abs(miou - jmiou) <= 1e-3


def test_run_coco_skip_existing_folds_written_masks_back(coco_setup, tmp_path, capsys):
    """A resumed run (one mask removed) writes only that mask and reports the
    uninterrupted run's mIoU; a relaunch over a complete dump writes nothing."""
    root, _ = coco_setup
    argv = _argv(root, tmp_path / "o", ["--model", str(root / "params"), "--device", "cpu", "--batch", "2"])
    full = test_coco.run_coco(tcommon.build_arg_parser("").parse_args(argv), sizes=[41])
    (tmp_path / "o" / "1.png").unlink()
    kept = {i: osp.getmtime(tmp_path / "o" / f"{i}.png") for i in (0, 3)}
    capsys.readouterr()
    resumed = test_coco.run_coco(tcommon.build_arg_parser("").parse_args(argv + ["--skip-existing"]), sizes=[41])
    assert "skip-existing: 2 done, 2 to go" in capsys.readouterr().out
    assert resumed == pytest.approx(full, abs=1e-12)
    assert (tmp_path / "o" / "1.png").exists()
    assert all(osp.getmtime(tmp_path / "o" / f"{i}.png") == t for i, t in kept.items())
    again = test_coco.run_coco(tcommon.build_arg_parser("").parse_args(argv + ["--skip-existing"]), sizes=[41])
    assert again == pytest.approx(full, abs=1e-12)


def test_test_coco_f_scales_mode(coco_setup, tmp_path):
    root, _ = coco_setup
    test_coco_f.main(_argv(root, tmp_path / "f", ["--model", str(root / "params"), "--device", "cpu",
                                                  "--batch", "2", "--pipeline", "device"]))
    for i in (0, 1, 3):
        m = np.asarray(Image.open(tmp_path / "f" / f"{i}.png"))
        assert m.shape == (50 + 5 * i, 60) and m.max() < M


def test_image_mode_matches_pil(tmp_path):
    """``utils/imageio.image_mode`` (what test_coco's non-RGB skip reads)
    gives PIL's mode from the header: PNGs of every colour type, as PIL and
    as the port writes them, and JPEGs through PIL."""
    from dsrg_tpu_torch.utils import imageio

    rng = np.random.default_rng(0)
    arrays = {"L": rng.integers(0, 256, (5, 7)), "RGB": rng.integers(0, 256, (5, 7, 3)),
              "RGBA": rng.integers(0, 256, (5, 7, 4)), "LA": rng.integers(0, 256, (5, 7, 2))}
    for mode, a in arrays.items():
        Image.fromarray(a.astype(np.uint8), mode).save(tmp_path / f"{mode}.png")
        assert imageio.image_mode(str(tmp_path / f"{mode}.png")) == Image.open(tmp_path / f"{mode}.png").mode == mode
    Image.fromarray(arrays["L"].astype(np.uint8)).convert("P").save(tmp_path / "P.png")
    imageio.write_png(arrays["RGB"].astype(np.uint8), str(tmp_path / "ours.png"))
    imageio.write_png(arrays["L"].astype(np.uint8), str(tmp_path / "pal.png"), palette=[(0, 0, 0)] * 256)
    for name, mode in (("P.png", "P"), ("ours.png", "RGB"), ("pal.png", "P")):
        assert imageio.image_mode(str(tmp_path / name)) == Image.open(tmp_path / name).mode == mode
    for mode in ("RGB", "L"):
        Image.fromarray(arrays[mode].astype(np.uint8)).save(tmp_path / f"{mode}.jpg")
        assert imageio.image_mode(str(tmp_path / f"{mode}.jpg")) == mode


def test_coco_tiles_take_the_unstaged_splat_template():
    """``mmgrid_kernels.splat_staged`` mirrors the splat's shared-memory sum
    (``smem_bytes`` against ``SMEM_MAX`` in ``csrc/mmgrid_splat.cu``): a
    served 1600-pixel tile stages its values at 21 classes, not at 81."""
    from dsrg_tpu_torch.ops.crf import mmgrid_kernels as mk

    src = open(osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "dsrg_tpu_torch", "csrc",
                        "mmgrid_splat.cu")).read()
    for line in ("constexpr int SLOTS = 16;", "constexpr int SMEM_MAX = 227 * 1024 - 64;",
                 "return (long)px * sizeof(int4) + (long)SLOTS * 8 * c * sizeof(float) + (long)(px + 1) * sizeof(int) +",
                 "(long)(px + (px & 1)) * sizeof(unsigned short) +",
                 "(staged ? (long)px * (c | 1) * sizeof(__nv_bfloat16) : 0);"):
        assert line in src, line
    assert mk.splat_staged(1600, 21) and mk.splat_staged(256, 81) and mk.splat_staged(1600, 1)
    assert not mk.splat_staged(1600, 81) and not mk.splat_staged(6400, 21)
