"""The port's CLIs (``dsrg_tpu_torch/tools``) held against the JAX package's
on the CPU, at tiny sizes: ``train._override`` gives the JAX configs, a
resumed training run equals an uninterrupted one bit for bit, the inference
CLIs and ``generate_train_gt`` write the JAX CLIs' masks (>= 0.99 of the
pixels) from the same weights, ``evaluate`` gives JAX's numbers, and
``run_recipe`` / ``synth_check`` run end to end (in-process, and supervised
with a relaunch).  Every CLI takes ``--help``; the flags of ROADMAP.md
items 4 (``--dataset coco``) and 8 (``--num-processes``, ``--mesh``) run;
``--device cuda`` without a card raises."""

import dataclasses
import importlib
import json
import os
import os.path as osp
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dsrg_tpu.config import Stage1Config as JStage1Config, Stage2Config as JStage2Config
from dsrg_tpu.models import DeepLabLargeFOV as JaxLargeFOV
from dsrg_tpu.tools import _infer_common as jcommon
from dsrg_tpu.tools import evaluate as jevaluate
from dsrg_tpu.tools import generate_train_gt as jgen
from dsrg_tpu.tools import test_ms as jtest_ms
from dsrg_tpu.tools import test_ms_f as jtest_ms_f
from dsrg_tpu.tools import train as jtrain
from dsrg_tpu_torch.config import Stage1Config, Stage2Config
from dsrg_tpu_torch.data import synth as tsynth
from dsrg_tpu_torch.models.convert import params_from_flax
from dsrg_tpu_torch.tools import evaluate, generate_train_gt, run_recipe, synth_check, test_ms, test_ms_f, train
from dsrg_tpu_torch.train import checkpoint as ckpt
from dsrg_tpu_torch.utils import watchdog

TOOLS = ("train", "test", "test_ms", "test_ms_f", "evaluate", "generate_train_gt", "run_recipe", "synth_check",
         "calibrate_bn", "test_coco", "test_coco_f", "dump_cues", "ap", "show_result", "neutrality_study")


@pytest.fixture(autouse=True)
def _few_threads(monkeypatch):
    """The CLIs build the full-width model: with several test workers on one
    host, two intra-op threads each (and in their child processes) keep the
    host from oversubscribing."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The easy synthetic tree at 41 (6 train + 3 val images, PIL JPEG)."""
    spec = dataclasses.replace(tsynth.PROFILES["easy"], crop_size=41, cue_grid=6, size_min=41, size_max=41)
    return tsynth.make_dataset(str(tmp_path_factory.mktemp("tree") / "data"), 6, 3, spec, seed=0)


def _stage_args(tree, stage, snap, iters, extra=()):
    if stage == "s":
        data = ["--image-dir", osp.join(tree, "JPEGImages"), "--input-list", osp.join(tree, "input_list.txt"),
                "--cues", osp.join(tree, "cues.pickle")]
    else:
        pairs = osp.join(tree, "gt_pairs.txt")
        ids = open(osp.join(tree, "train_aug_id.txt")).read().split()
        with open(pairs, "w") as f:
            f.writelines(f"/JPEGImages/{i}.jpg /SegmentationClass/{i}.png\n" for i in ids)
        data = ["--root", tree, "--pair-list", pairs]
    return (["--stage", stage, "--snapshot-dir", str(snap), "--max-iter", str(iters), "--batch-size", "2",
             "--crop-size", "41", "--snapshot-every", str(iters), "--display", "2", "--dtype", "float32",
             "--device", "cpu", "--stall-limit-min", "0"] + data + list(extra))


# -- flags ----------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["--stage", "s"],
    ["--stage", "f"],
    ["--stage", "s", "--max-iter", "7", "--base-lr", "0.01", "--batch-size", "3", "--crop-size", "65",
     "--snapshot-every", "4", "--num-classes", "5", "--dtype", "bfloat16", "--crf-fast", "--crf-true-grad",
     "--clip-gradients", "2.5"],
    ["--stage", "f", "--max-iter", "9", "--crop-size", "33", "--dtype", "bfloat16", "--crf-fast"],
])
def test_override_matches_jax(argv):
    stage = argv[1]
    ours = train._override(Stage1Config() if stage == "s" else Stage2Config(), train.parse_args(argv))
    theirs = jtrain._override(JStage1Config() if stage == "s" else JStage2Config(), jtrain.parse_args(argv))
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


@pytest.mark.parametrize("name", TOOLS)
def test_every_cli_takes_help(name, capsys):
    mod = importlib.import_module(f"dsrg_tpu_torch.tools.{name}")
    with pytest.raises(SystemExit) as exc:
        mod.main(["--help"])
    assert exc.value.code == 0
    assert "usage" in capsys.readouterr().out


@pytest.mark.parametrize("tool,argv,item", [
    (train, ["--stage", "s", "--dataset", "coco"], 4),
    (train, ["--stage", "s", "--num-processes", "2"], 8),
    (train, ["--stage", "f", "--num-processes", "2"], 8),
    (test_ms, ["--sizes", "41", "57", "--smooth", "--batch", "2", "--mesh"], 8),
    (generate_train_gt, ["--smooth", "--cues", "CUES", "--mesh"], 8),
    (synth_check, ["--work-dir", "w", "--dataset", "coco"], 4),
])
def test_later_slice_flags_exit_naming_their_item(tool, argv, item, tree, infer_setup, tmp_path, monkeypatch):
    """The flags of ROADMAP.md items 4 (``--dataset coco``) and 8 (several
    processes, ``--mesh``) are ported and run: the 81-class path at crop 41,
    a two-process trainer against one process on the same global batch, and
    the inference CLIs' masks with and without ``--mesh``."""
    if item == 8:
        if tool is train:
            _two_process_train(tree, argv[1], tmp_path, monkeypatch)
        else:
            _mesh_dump(tool, argv, infer_setup, tmp_path)
        return
    if tool is synth_check:
        miou3 = synth_check.main(["--work-dir", str(tmp_path / "w"), "--dataset", "coco", "--iters", "1",
                                  "--n-train", "4", "--n-val", "2", "--size", "41", "--batch-size", "2",
                                  "--batch", "2", "--image-format", "png", "--device", "cpu"])
        assert np.isfinite(miou3) and 0.0 <= miou3 <= 1.0
        assert len(os.listdir(tmp_path / "w" / "coco_preds")) == 2
        return
    pairs = tmp_path / "pairs.txt"
    pairs.write_text("".join(f"/JPEGImages/{i}.jpg /SegmentationClass/{i}.png\n"
                             for i in open(osp.join(tree, "train_aug_id.txt")).read().split()))
    train.main(argv + ["--root", tree, "--pair-list", str(pairs), "--snapshot-dir", str(tmp_path / "m"),
                       "--max-iter", "1", "--batch-size", "2", "--crop-size", "41", "--snapshot-every", "1",
                       "--display", "1", "--ship-uint8", "--device", "cpu", "--stall-limit-min", "0"])
    params = ckpt.load_params(str(tmp_path / "m" / "step_1_params"))
    assert params["fc8-SEC_1.weight"].shape[0] == 81  # --num-classes 21 becomes 81


def _losses(path):
    rows = [json.loads(ln) for ln in open(path)]
    assert [r["step"] for r in rows] == [1, 2]  # one line per step: rank 0 alone logs
    return [r["loss"] for r in rows]


def _two_process_train(tree, stage, tmp_path, monkeypatch):
    """``train --num-processes 2`` as two gloo ranks (child processes) for 2
    iterations at global batch 2, mirroring and dropout off in both runs
    (``tests/_torch_dist_worker.py cli``): both exit 0, rank 0 alone prints,
    logs and snapshots, and its losses equal a one-process run's."""
    from tests._torch_dist_worker import CLI_PATCHES, free_port

    for name, value in CLI_PATCHES.items():
        monkeypatch.setattr(train, name, value)
    train.main(_stage_args(tree, stage, tmp_path / "one", 2, ["--display", "1", "--metrics-log",
                                                                str(tmp_path / "one.jsonl")]))
    argv = _stage_args(tree, stage, tmp_path / "two", 2, ["--display", "1", "--metrics-log",
                                                          str(tmp_path / "two.jsonl"), "--sync-snapshots",
                                                          "--num-processes", "2", "--coordinator",
                                                          f"127.0.0.1:{free_port()}"])
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    worker = osp.join(osp.dirname(osp.abspath(__file__)), "_torch_dist_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, "cli", *argv, "--process-id", str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(2)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    assert "data-parallel over 2 devices across 2 processes, 1 images/device" in outs[0]
    assert "snapshot ->" in outs[0] and "iter 2: loss" in outs[0]
    assert "data-parallel" not in outs[1] and "snapshot ->" not in outs[1] and "iter " not in outs[1]
    assert sorted(os.listdir(tmp_path / "two")) == ["step_2", "step_2_params"]
    np.testing.assert_allclose(_losses(tmp_path / "two.jsonl"), _losses(tmp_path / "one.jsonl"), rtol=1e-5)


def _mesh_dump(tool, argv, infer_setup, tmp_path):
    """``--mesh --device cpu`` writes the masks of the run without it."""
    base, _ = infer_setup
    gen = tool is generate_train_gt
    argv = [str(base / "cues.pickle") if a == "CUES" else a for a in argv]
    common = ["--images", str(base / ("input_list.txt" if gen else "ids.txt")), "--dir", str(base),
              "--num-classes", "6", "--model", str(base / "params"), "--device", "cpu"]
    tool.main(common + argv + ["--output", str(tmp_path / "mesh")])
    tool.main(common + [a for a in argv if a != "--mesh"] + ["--output", str(tmp_path / "plain")])
    assert _agreement(tmp_path / "mesh", tmp_path / "plain", ["img_a", "img_b"]) == 1.0


def test_device_cuda_without_a_card_raises(tree, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _stage_args(tree, "s", tmp_path / "m", 1)
    argv[argv.index("--device") + 1] = "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(argv)
    ckpt.save_params(str(tmp_path / "p"), {})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        test_ms.main(["--images", osp.join(tree, "val_id.txt"), "--dir", tree, "--model", str(tmp_path / "p")])
    assert not os.path.exists(tmp_path / "m")


# -- training: snapshots and a lossless resume --------------------------------------------


def test_watchdog_exit_and_resume_equal_a_straight_run(tree, tmp_path, capsys):
    """2 iterations straight, against 1 that ends in the RSS watchdog's exit
    75 with a snapshot and an --auto-resume for the other: the same
    parameters bit for bit (restored weights, velocities, step and random
    stream, and the data order after seek()).  Then --weights copies the
    result into a stage-f run by name and shape (base_lr 0 keeps it), whose
    metrics log holds one line per step."""
    train.main(_stage_args(tree, "s", tmp_path / "straight", 2, ["--rss-limit-gb", "0", "--display", "1"]))
    argv = _stage_args(tree, "s", tmp_path / "resumed", 2, ["--display", "1"])
    with pytest.raises(SystemExit) as exc:
        train.main(argv + ["--rss-limit-gb", "0.001"])
    assert exc.value.code == watchdog.RESTART_EXIT_CODE
    assert ckpt.latest_checkpoint(str(tmp_path / "resumed")).endswith("step_1")
    train.main(argv + ["--rss-limit-gb", "0", "--auto-resume", "--sync-snapshots"])
    a = ckpt.load_params(str(tmp_path / "straight" / "step_2_params"))
    b = ckpt.load_params(str(tmp_path / "resumed" / "step_2_params"))
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    full = torch.load(str(tmp_path / "resumed" / "step_2"), weights_only=True)
    assert full["step"] == full["optimizer"]["step"] == 2

    capsys.readouterr()
    log = tmp_path / "f.jsonl"
    train.main(_stage_args(tree, "f", tmp_path / "f", 1, ["--weights", str(tmp_path / "straight" / "step_2_params"),
                                                            "--base-lr", "0", "--metrics-log", str(log)]))
    out = capsys.readouterr().out
    assert "copy_from" not in out and "kernel launches:" in out
    got = ckpt.load_params(str(tmp_path / "f" / "step_1_params"))
    for k in a:
        assert torch.equal(got[k], a[k]), k
    assert [set(json.loads(ln)) for ln in open(log)] == [{"step", "loss", "accuracy", "grad_norm"}]


# -- inference CLIs against the JAX package's -------------------------------------------


def _two_colour(rng, h, w):
    img = np.zeros((h, w, 3), np.uint8)
    img[:, : w // 2] = [200, 60, 50]
    img[:, w // 2:] = [30, 180, 190]
    return np.clip(img.astype(np.int32) + rng.integers(-8, 8, img.shape), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def infer_setup(tmp_path_factory):
    """Two images (1681 px: the exact CRF; 9600 px: the grid), the same
    weights for both packages (flax init, carried by models/convert.py),
    label sets in a cue pickle and an input list for generate_train_gt."""
    base = tmp_path_factory.mktemp("infer")
    (base / "JPEGImages").mkdir()
    rng = np.random.default_rng(4)
    ids = ["img_a", "img_b"]
    for img_id, (h, w) in zip(ids, [(41, 41), (96, 100)]):
        Image.fromarray(_two_colour(rng, h, w)).save(base / "JPEGImages" / f"{img_id}.jpg", format="PNG")
    (base / "ids.txt").write_text("\n".join(ids) + "\n")
    (base / "input_list.txt").write_text("img_a.jpg 0\nimg_b.jpg 1\n")
    with open(base / "cues.pickle", "wb") as f:
        pickle.dump({"0_labels": np.array([3, 5]), "1_labels": np.array([1]),
                     "0_cues": (np.zeros(0, int),) * 3, "1_cues": (np.zeros(0, int),) * 3}, f, protocol=2)
    jm = JaxLargeFOV(num_classes=6)
    params = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 41, 41, 3)), train=False)["params"]
    params = jax.tree.map(np.asarray, params)
    ckpt.save_params(str(base / "params"), params_from_flax(params))
    return base, params


def _agreement(dir_a, dir_b, ids):
    out = []
    for i in ids:
        a = np.asarray(Image.open(osp.join(dir_a, i + ".png")))
        b = np.asarray(Image.open(osp.join(dir_b, i + ".png")))
        assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
        out.append(float((a == b).mean()))
    return min(out)


@pytest.mark.parametrize("tool,jtool,extra", [
    (test_ms, jtest_ms, ["--sizes", "41", "57", "--smooth", "--batch", "2"]),  # the device pipeline, grid CRF
    (test_ms_f, jtest_ms_f, ["--scales", "0.75", "1.0", "--batch", "2"]),  # the device pipeline, masked canvas
    (test_ms, jtest_ms, ["--sizes", "41", "--smooth", "--batch", "1", "--pipeline", "host"]),  # CRF() auto
    (generate_train_gt, jgen, ["--smooth", "--cues", "CUES"]),  # forward at 321, restricted labels
])
def test_inference_clis_match_jax(infer_setup, tmp_path, monkeypatch, tool, jtool, extra):
    base, params = infer_setup
    monkeypatch.setattr(jcommon, "load_params", lambda path, template=None: params)
    import dsrg_tpu.utils.cache as jcache
    monkeypatch.setattr(jcache, "enable_compile_cache", lambda: None)
    gen = tool is generate_train_gt
    extra = [str(base / "cues.pickle") if a == "CUES" else a for a in extra]
    common = ["--images", str(base / ("input_list.txt" if gen else "ids.txt")), "--dir", str(base),
              "--num-classes", "6"] + extra
    jtool.main(common + ["--model", "unused", "--output", str(tmp_path / "jax")])
    tool.main(common + ["--model", str(base / "params"), "--output", str(tmp_path / "torch"), "--device", "cpu"])
    agree = _agreement(tmp_path / "jax", tmp_path / "torch", ["img_a", "img_b"])
    assert agree >= 0.99, agree
    if gen:  # every pixel in the image's label set, background inserted
        for i, allowed in (("img_a", {0, 3, 5}), ("img_b", {0, 1})):
            assert set(np.unique(np.asarray(Image.open(tmp_path / "torch" / f"{i}.png")))) <= allowed


def test_evaluate_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    ids = [f"m{i}" for i in range(3)]
    for d in ("pred", "gt"):
        (tmp_path / d).mkdir()
        for i in ids:
            m = rng.integers(0, 4, (20, 30)).astype(np.uint8)
            if d == "gt":
                m[:2] = 255
            Image.fromarray(m).save(tmp_path / d / f"{i}.png")
    (tmp_path / "ids.txt").write_text("\n".join(ids) + "\n")
    argv = ["--pred", str(tmp_path / "pred"), "--gt", str(tmp_path / "gt"), "--test_ids", str(tmp_path / "ids.txt"),
            "--class_num", "21", "--save_path"]
    ours = evaluate.main(argv + [str(tmp_path / "t.txt")])
    theirs = jevaluate.main(argv + [str(tmp_path / "j.txt")])
    assert ours == theirs
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()


def test_test_ms_refuses_an_engine_of_a_later_slice(infer_setup, tmp_path, monkeypatch):
    """The engines of Queue 1 item 6 are ported: ``--engine lattice`` with
    ``--smooth`` runs per image through ``CRF()`` and writes JAX's masks."""
    base, params = infer_setup
    monkeypatch.setattr(jcommon, "load_params", lambda path, template=None: params)
    common = ["--images", str(base / "ids.txt"), "--dir", str(base), "--num-classes", "6", "--sizes", "41",
              "--smooth", "--engine", "lattice"]
    jtest_ms.main(common + ["--model", "unused", "--output", str(tmp_path / "jax")])
    test_ms.main(common + ["--model", str(base / "params"), "--output", str(tmp_path / "o"), "--device", "cpu"])
    assert _agreement(tmp_path / "jax", tmp_path / "o", ["img_a", "img_b"]) >= 0.99
    with pytest.raises(SystemExit, match="--pipeline device smooths with the mmgrid engine"):
        test_ms.main(common + ["--model", str(base / "params"), "--output", str(tmp_path / "d"), "--device", "cpu",
                               "--pipeline", "device"])


# -- the recipe and the learning check --------------------------------------------------


def _recipe_argv(tree, work, extra=()):
    return ["--pascal-dir", tree, "--list-dir", tree, "--cues", osp.join(tree, "cues.pickle"), "--work-dir",
            str(work), "--stage1-iters", "1", "--stage2-iters", "1", "--batch-size", "2", "--crop-size", "41",
            "--test-sizes", "41", "--test-scales", "1.0", "--dtype", "float32", "--device", "cpu",
            "--stall-limit-min", "0"] + list(extra)


def _assert_recipe_outputs(tree, work):
    assert (work / "DSRG_result_final.txt").read_text().startswith("meanIOU: ")
    for name, ids in (("DSRGOutput", "train_aug_id.txt"), ("DSRG_final_output", "val_id.txt")):
        for i in open(osp.join(tree, ids)).read().split():
            m = np.asarray(Image.open(work / name / f"{i}.png"))
            assert m.shape == (41, 41) and m.max() < 21


def test_run_recipe_supervised_relaunches_to_completion(tree, tmp_path, capfd):
    """Every phase a `python -m dsrg_tpu_torch.tools.*` child: with an RSS
    limit below any process, test_ms exits 75 after its first chunk of 4
    and the supervisor relaunches it with --skip-existing once (the trainers
    run 1 iteration = max_iter and the other dump one chunk, where the
    watchdog never fires)."""
    work = tmp_path / "work"
    run_recipe.main(_recipe_argv(tree, work, ["--no-smooth", "--test-batch", "4", "--auto-resume",
                                              "--rss-limit-gb", "0.001"]))
    _assert_recipe_outputs(tree, work)
    out = capfd.readouterr().out
    assert out.count("relaunching with resume") == 1
    assert "dsrg_tpu_torch.tools.test_ms exited 75" in out
    assert "skip-existing: 4 done, 2 to go" in out


def test_synth_check_two_stage_in_process(tmp_path):
    """--two-stage --in-process: run_recipe's five phases in this process,
    the CRF on, on synth_check's own tree."""
    miou3 = synth_check.main(["--work-dir", str(tmp_path / "synth2"), "--iters", "2", "--n-train", "6",
                              "--n-val", "3", "--size", "41", "--batch-size", "2", "--batch", "2", "--smooth",
                              "--two-stage", "--in-process", "--device", "cpu"])
    assert np.isfinite(miou3) and 0.0 <= miou3 <= 1.0
    _assert_recipe_outputs(str(tmp_path / "synth2" / "data"), tmp_path / "synth2" / "recipe")


def test_synth_check_single_stage(tmp_path):
    miou3 = synth_check.main(["--work-dir", str(tmp_path / "synth"), "--iters", "2", "--n-train", "6",
                              "--n-val", "3", "--size", "41", "--batch-size", "2", "--batch", "2",
                              "--device", "cpu"])
    assert np.isfinite(miou3) and 0.0 <= miou3 <= 1.0
    assert (tmp_path / "synth" / "result.txt").read_text().startswith("meanIOU: ")
