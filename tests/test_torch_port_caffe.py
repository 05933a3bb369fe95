"""Caffe interop of the port (``models/import_caffe.py``,
``models/export_caffe.py``, ``tools/calibrate_bn.py``) and the ResNet-101
family through the CLIs, held against the JAX package on the CPU.

``.caffemodel`` files cross between the packages: files the JAX writer (V2
layers) or the JAX tests' wire encoder (V1 layers) writes read back in the
port to the arrays JAX's importer gives, for both families; the port's
writer gives the JAX writer's bytes from the same arrays; the full-depth
DeepLab-v2 names match.  Then the warm start through the CLIs, as a user
runs it: ``calibrate_bn`` on a tiny tree writes a full-depth calibrated
``.caffemodel``, ``train --model resnet101 --weights`` imports it and trains
(crop 41, batch 2, one snapshot: a full-depth snapshot with velocities is
~350 MB), and ``test_ms`` / ``test_ms_f --model-name resnet101`` serve the
snapshot.
"""

import dataclasses
import json
import os.path as osp
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsrg_tpu.models import DeepLabLargeFOV as JaxLargeFOV
from dsrg_tpu.models import ResNet101DeepLab as JaxResNet
from dsrg_tpu.models import export_caffe as jexport
from dsrg_tpu.models import import_caffe as jimport
from dsrg_tpu_torch.data import synth as tsynth
from dsrg_tpu_torch.models import DeepLabLargeFOV, ResNet101DeepLab
from dsrg_tpu_torch.models import export_caffe as texport
from dsrg_tpu_torch.models import import_caffe as timport
from dsrg_tpu_torch.models.convert import params_from_flax, variables_from_flax
from dsrg_tpu_torch.tools import calibrate_bn, generate_train_gt, test_ms, test_ms_f, train
from dsrg_tpu_torch.train import checkpoint as ckpt
from tests.test_import_caffe import _layer_v1, _layer_v2, _len_field

BLOCKS, HEADS = (1, 1, 2, 1), (2, 4)


def _random(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32), tree)


def _resnet_vars(seed, blocks=BLOCKS, classes=4, heads=HEADS):
    model = JaxResNet(num_classes=classes, stage_blocks=blocks, head_dilations=heads)
    shapes = jax.eval_shape(lambda r: model.init({"params": r}, jnp.zeros((1, 33, 33, 3)), train=False),
                            jax.random.PRNGKey(0))
    return _random(shapes, seed)


def _vgg_params(seed):
    model = JaxLargeFOV(num_classes=4, head_dilations=HEADS)
    shapes = jax.eval_shape(lambda r: model.init({"params": r}, jnp.zeros((1, 41, 41, 3)), train=False),
                            jax.random.PRNGKey(0))
    return _random(shapes["params"], seed)


def _tiny_resnet():
    return ResNet101DeepLab(num_classes=4, stage_blocks=BLOCKS, head_dilations=HEADS)


def _assert_state_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(torch.as_tensor(got[k]), v), k


@pytest.mark.parametrize("layers", ["v2", "v1"])
def test_resnet_caffemodel_from_jax_reads_as_jax_imports_it(tmp_path, layers):
    """Blobs with a BN scale factor sf != 1, V2 layers through the JAX
    writer or V1 layers through the JAX tests' encoder: the port's reader
    gives JAX's arrays, and its import JAX's variables (buffers included)."""
    blobs = jexport.resnet_variables_to_blobs(_resnet_vars(1), BLOCKS)
    for name, bl in blobs.items():
        if name.startswith("bn"):  # Caffe stores mean * sf, var * sf, [sf]
            sf = np.float32(0.999)
            blobs[name] = [bl[0] * sf, bl[1] * sf, np.asarray([sf], np.float32)]
    path = str(tmp_path / "net.caffemodel")
    if layers == "v2":
        jexport.write_caffemodel(path, blobs)
    else:
        with open(path, "wb") as f:
            f.write(_len_field(1, b"net") + b"".join(_layer_v1(n, [np.asarray(b) for b in bl])
                                                    for n, bl in blobs.items()))
    got, ref = timport.load_caffemodel(path), jimport.load_caffemodel(path)
    assert list(got) == list(ref)
    for name in ref:
        for a, b in zip(got[name], ref[name]):
            np.testing.assert_array_equal(a, b)
    template = _resnet_vars(2)
    want = variables_from_flax(jimport.resnet_blobs_to_flax(ref, template, BLOCKS))
    port_template = variables_from_flax(template)
    _assert_state_equal(timport.resnet_blobs_to_torch(got, port_template, BLOCKS), want)
    model = _tiny_resnet()
    model.load_state_dict(timport.resnet_blobs_to_torch(got, model.state_dict(), BLOCKS))
    np.testing.assert_array_equal(model.res4_1.bn2.running_var.numpy(), want["res4_1.bn2.running_var"].numpy())


def test_vgg_caffemodel_from_jax_reads_as_jax_imports_it(tmp_path):
    params = _vgg_params(3)
    blobs = jexport.vgg_params_to_blobs(params)
    path = str(tmp_path / "vgg.caffemodel")
    with open(path, "wb") as f:  # V1 and V2 layers in one file, as old snapshots mix them
        f.write(_len_field(1, b"vgg") + b"".join((_layer_v1 if i % 2 else _layer_v2)(n, bl)
                                                for i, (n, bl) in enumerate(blobs.items())))
    template = _vgg_params(4)
    want = params_from_flax(jimport.caffe_blobs_to_flax(jimport.load_caffemodel(path), template))
    got = timport.caffe_blobs_to_torch(timport.load_caffemodel(path), params_from_flax(template))
    _assert_state_equal(got, {k: want[k] for k in got})
    assert torch.equal(got["conv3_2.weight"], params_from_flax(params)["conv3_2.weight"])


def test_missing_layers_keep_the_template_and_mismatches_skip(tmp_path, capsys):
    full = jexport.resnet_variables_to_blobs(_resnet_vars(1), BLOCKS)
    blobs = {k: full[k] for k in ("conv1", "bn_conv1", "scale_conv1", "res4b_branch2b", "fc1_voc12_c1")}
    blobs["res4b_branch2b"] = [blobs["res4b_branch2b"][0][:, :5]]  # a wrong shape
    template = variables_from_flax(_resnet_vars(2))
    got = timport.resnet_blobs_to_torch(blobs, template, BLOCKS)
    assert "import_caffe: res4_1.conv2 kernel shape (256, 5, 3, 3) != (256, 256, 3, 3), skipping" \
        in capsys.readouterr().out
    assert torch.equal(got["res4_1.conv2.weight"], template["res4_1.conv2.weight"])
    assert torch.equal(got["res2_0.conv1.weight"], template["res2_0.conv1.weight"])
    np.testing.assert_array_equal(got["conv1.weight"].numpy(), full["conv1"][0])
    np.testing.assert_array_equal(got["bn1.running_mean"].numpy(), full["bn_conv1"][0])
    np.testing.assert_array_equal(got["fc1_voc12_c1.bias"].numpy(), full["fc1_voc12_c1"][1])


@pytest.mark.parametrize("family", ["resnet", "vgg"])
def test_port_writer_bytes_equal_the_jax_writer(tmp_path, family):
    if family == "resnet":
        variables = _resnet_vars(5)
        jblobs = jexport.resnet_variables_to_blobs(variables, BLOCKS)
        tblobs = texport.resnet_variables_to_blobs(variables_from_flax(variables), BLOCKS)
    else:
        params = _vgg_params(5)
        jblobs = jexport.vgg_params_to_blobs(params)
        tblobs = texport.vgg_params_to_blobs(params_from_flax(params))
    jexport.write_caffemodel(str(tmp_path / "j.caffemodel"), jblobs)
    texport.write_caffemodel(str(tmp_path / "t.caffemodel"), tblobs)
    data = open(tmp_path / "t.caffemodel", "rb").read()
    assert data == open(tmp_path / "j.caffemodel", "rb").read() and len(data) > 100_000


def test_full_depth_caffe_names_match_jax():
    """The DeepLab-v2 layer names and blob shapes of the full-depth net
    (res3a..res3b3, res4a..res4b22), from the port's model and the JAX tree."""
    shapes = jax.eval_shape(lambda r: JaxResNet(num_classes=21).init(
        {"params": r}, jnp.zeros((1, 65, 65, 3)), train=False), jax.random.PRNGKey(0))
    ref = jexport.resnet_variables_to_blobs(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    got = texport.resnet_variables_to_blobs(ResNet101DeepLab(num_classes=21).state_dict())
    assert list(got) == list(ref)
    assert "res4b22_branch2c" in got and "res3b3_branch2a" in got and "res5c_branch2b" in got
    for name, bl in ref.items():
        assert [b.shape for b in got[name]] == [b.shape for b in bl], name


def test_export_import_round_trip_is_exact(tmp_path):
    model = _tiny_resnet()
    sd = variables_from_flax(_resnet_vars(6))
    model.load_state_dict(sd)
    path = str(tmp_path / "m.caffemodel")
    texport.write_caffemodel(path, texport.resnet_variables_to_blobs(model.state_dict(), BLOCKS))
    back = timport.resnet_blobs_to_torch(timport.load_caffemodel(path), _tiny_resnet().state_dict(), BLOCKS)
    _assert_state_equal(back, sd)


# ---------------------------------------------------------------- the CLIs


@pytest.fixture(autouse=True)
def _few_threads(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def warm_start(tmp_path_factory):
    """The easy tree at 41 and the calibrated full-depth caffemodel of it."""
    base = tmp_path_factory.mktemp("resnet")
    spec = dataclasses.replace(tsynth.PROFILES["easy"], crop_size=41, cue_grid=6, size_min=41, size_max=41)
    tree = tsynth.make_dataset(str(base / "data"), 6, 3, spec, seed=0)
    out = str(base / "calib.caffemodel")
    args = ["--image-dir", osp.join(tree, "JPEGImages"), "--input-list", osp.join(tree, "input_list.txt"),
            "--cues", osp.join(tree, "cues.pickle"), "--out", out, "--batches", "2", "--batch-size", "2",
            "--crop-size", "41", "--device", "cpu"]
    torch.set_num_threads(2)
    assert calibrate_bn.main(args) == out
    return tree, out


def test_calibrate_bn_writes_a_calibrated_full_depth_caffemodel(warm_start, capsys):
    _, path = warm_start
    blobs = timport.load_caffemodel(path)
    assert len(blobs) == 1 + 2 * 1 + (3 + 4 + 23 + 3) * (3 + 2 * 3) + 4 * 3 + 4  # convs, bn + scale, heads
    assert np.abs(blobs["bn_conv1"][0]).mean() > 0 and not np.allclose(blobs["bn4b22_branch2b"][1], 1.0)
    assert blobs["bn_conv1"][2].tolist() == [1.0]


def test_train_resnet_from_the_caffemodel_then_serve_it(warm_start, tmp_path, capsys):
    """``train --model resnet101 --weights x.caffemodel`` on the CPU: the
    import gives the file's arrays (frozen BN: statistics, scale and offset
    leave the steps bit for bit as the file has them), finite losses, the
    pool kernels' launch line; then ``test_ms``, ``test_ms_f`` and
    ``generate_train_gt`` with ``--model-name resnet101``."""
    tree, path = warm_start
    snap = tmp_path / "snap"
    train.main(["--stage", "s", "--model", "resnet101", "--weights", path, "--snapshot-dir", str(snap),
                "--max-iter", "2", "--batch-size", "2", "--crop-size", "41", "--snapshot-every", "2",
                "--display", "1", "--base-lr", "1e-4", "--clip-gradients", "10", "--device", "cpu",
                "--stall-limit-min", "0", "--sync-snapshots", "--image-dir", osp.join(tree, "JPEGImages"),
                "--input-list", osp.join(tree, "input_list.txt"), "--cues", osp.join(tree, "cues.pickle")])
    out = capsys.readouterr().out
    losses = [float(line.split("loss = ")[1].split()[0]) for line in out.splitlines() if line.startswith("iter ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "trained steps 0 to 2" in out
    assert json.loads(out.split("kernel launches:")[1].splitlines()[0]) == {
        "mmgrid_splat": 0, "mmgrid_slice": 0, "pool_bwd_h": 0, "pool_bwd_w": 0, "pool_bwd_h_bf16": 0,
        "pool_bwd_w_bf16": 0, "caffe_sgd": 0}  # the CPU runs the plain versions
    params = ckpt.load_params(str(snap / "step_2_params"))
    want = timport.resnet_blobs_to_torch(timport.load_caffemodel(path), ResNet101DeepLab().state_dict())
    for key in ("bn1.running_mean", "res4_22.bn3.running_var", "res5_2.bn2.weight", "res3_0.shortcut_bn.bias"):
        assert torch.equal(params[key], want[key]), key
    assert not torch.equal(params["fc1_voc12_c0.weight"], want["fc1_voc12_c0.weight"])  # trained

    from dsrg_tpu_torch.utils.palette import read_mask_png

    ids = open(osp.join(tree, "val_id.txt")).read().split()
    for tool in (test_ms, test_ms_f):  # absolute sizes, and scales
        out_dir = tmp_path / tool.__name__.rsplit(".", 1)[1]
        tool.main(["--images", osp.join(tree, "val_id.txt"), "--dir", tree, "--model", str(snap / "step_2_params"),
                   "--model-name", "resnet101", "--output", str(out_dir), "--smooth", "--device", "cpu"])
        for i in ids:
            mask = read_mask_png(str(out_dir / f"{i}.png"))
            assert mask.shape == (41, 41) and mask.max() < 21
    # the pseudo ground truth of the ResNet (forward at 321, labels restricted to each image's)
    generate_train_gt.main(["--images", osp.join(tree, "input_list.txt"), "--dir", tree, "--model",
                            str(snap / "step_2_params"), "--model-name", "resnet101", "--cues",
                            osp.join(tree, "cues.pickle"), "--output", str(tmp_path / "gt"), "--smooth",
                            "--device", "cpu"])
    with open(osp.join(tree, "cues.pickle"), "rb") as f:
        cues = pickle.load(f)
    with open(osp.join(tree, "input_list.txt")) as f:
        rows = [ln.split() for ln in f if ln.strip()]
    for fname, image_id in rows:
        mask = read_mask_png(str(tmp_path / "gt" / (osp.splitext(fname)[0] + ".png")))
        assert mask.shape == (41, 41)
        assert set(np.unique(mask)) <= {0} | set(np.ravel(cues[f"{int(image_id)}_labels"]).tolist())


def test_train_vgg_from_a_caffemodel(tmp_path, capsys):
    """A partial VGG caffemodel (two layers) through ``--weights``: at base
    lr 0 the step leaves the weights, so the snapshot holds the file's
    arrays where it has them and the seeded init elsewhere."""
    spec = dataclasses.replace(tsynth.PROFILES["easy"], crop_size=41, cue_grid=6, size_min=41, size_max=41)
    tree = tsynth.make_dataset(str(tmp_path / "data"), 2, 1, spec, seed=0)
    rng = np.random.default_rng(0)
    blobs = {"conv1_1": [rng.normal(size=(64, 3, 3, 3)).astype(np.float32), rng.normal(size=64).astype(np.float32)],
             "fc8-SEC_2": [rng.normal(size=(21, 1024, 1, 1)).astype(np.float32), np.zeros(21, np.float32)]}
    path = str(tmp_path / "vgg.caffemodel")
    texport.write_caffemodel(path, blobs)
    snap = tmp_path / "snap"
    train.main(["--stage", "s", "--weights", path, "--snapshot-dir", str(snap), "--max-iter", "1",
                "--batch-size", "2", "--crop-size", "41", "--base-lr", "0", "--device", "cpu",
                "--stall-limit-min", "0", "--sync-snapshots", "--image-dir", osp.join(tree, "JPEGImages"),
                "--input-list", osp.join(tree, "input_list.txt"), "--cues", osp.join(tree, "cues.pickle")])
    params = ckpt.load_params(str(snap / "step_1_params"))
    np.testing.assert_array_equal(params["conv1_1.weight"].numpy(), blobs["conv1_1"][0])
    np.testing.assert_array_equal(params["conv1_1.bias"].numpy(), blobs["conv1_1"][1])
    np.testing.assert_array_equal(params["fc8-SEC_2.weight"].numpy(), blobs["fc8-SEC_2"][0])
    init = DeepLabLargeFOV()
    from dsrg_tpu_torch.train.stage1 import init_params

    init_params(init, 0)
    assert torch.equal(params["conv2_1.weight"], init.conv2_1.weight.detach())
