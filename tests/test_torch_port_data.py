"""The port's data modules held against the JAX package and PIL on the CPU:
the PNG codec (``utils/imageio.py``) and ``utils/palette.py`` against PIL,
``data/voc.py``'s datasets and ``data/synth.make_dataset`` against the JAX
package's on the same tree (equal batches), ``data/loader.py``,
``train/checkpoint.py`` (bit-equal round trips, ``copy_from`` against the
JAX package's), ``losses/expand.py`` against JAX's (1e-5 relative), and the
copies of ``utils/watchdog.py`` and ``utils/profiling.py``."""

import dataclasses
import json
import os
import pickle
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dsrg_tpu.data import synth as jsynth
from dsrg_tpu.data import voc as jvoc
from dsrg_tpu.data.cues import CueDB as JCueDB
from dsrg_tpu.losses.expand import expand_loss as jexpand_loss
from dsrg_tpu.train import checkpoint as jckpt
from dsrg_tpu.utils import palette as jpalette
from dsrg_tpu.utils import watchdog as jwatchdog
from dsrg_tpu_torch.data import synth as tsynth
from dsrg_tpu_torch.data import voc as tvoc
from dsrg_tpu_torch.data.cues import CueDB
from dsrg_tpu_torch.data.loader import PrefetchLoader
from dsrg_tpu_torch.losses import expand_loss
from dsrg_tpu_torch.models.convert import params_from_flax
from dsrg_tpu_torch.train import checkpoint as ckpt
from dsrg_tpu_torch.utils import imageio, palette, profiling, watchdog

# -- the PNG codec against PIL ------------------------------------------------


def _smooth_image(rng, h, w, c):
    """Gradients plus noise: PIL's adaptive filter choice varies per row."""
    yy, xx = np.mgrid[:h, :w]
    chans = [((yy * (3 + k) + xx * (5 - k)) % 256 + rng.integers(0, 9, (h, w))) % 256 for k in range(c)]
    return np.stack(chans, -1).astype(np.uint8)[..., 0] if c == 1 else np.stack(chans, -1).astype(np.uint8)


@pytest.mark.parametrize("mode,c", [("L", 1), ("LA", 2), ("RGB", 3), ("RGBA", 4)])
def test_pil_png_decodes_to_pils_arrays(tmp_path, mode, c):
    arr = _smooth_image(np.random.default_rng(c), 37, 53, c)
    path = str(tmp_path / "x.png")
    Image.fromarray(arr, mode).save(path)
    with Image.open(path) as im:
        np.testing.assert_array_equal(imageio.read_raw(path), np.asarray(im))
        np.testing.assert_array_equal(imageio.read_image_rgb(path), np.asarray(im.convert("RGB")))
        assert imageio.image_size(path) == (im.size[1], im.size[0])
    np.testing.assert_array_equal(imageio.read_mask(path), jpalette.read_mask_png(path))
    np.testing.assert_array_equal(palette.read_mask_png(path), jpalette.read_mask_png(path))


def test_pil_palette_png_decodes_to_pils_arrays(tmp_path):
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 30, (29, 41)).astype(np.uint8)
    idx[0, :4] = 200  # an index past the file's 30 palette entries: black, as in PIL
    im = Image.fromarray(idx, "P")
    im.putpalette(rng.integers(0, 256, 90).astype(np.uint8).tolist())
    path = str(tmp_path / "p.png")
    im.save(path)
    with Image.open(path) as im:
        np.testing.assert_array_equal(imageio.read_raw(path), np.asarray(im))
        np.testing.assert_array_equal(imageio.read_image_rgb(path), np.asarray(im.convert("RGB")))
    np.testing.assert_array_equal(imageio.read_mask(path), jpalette.read_mask_png(path))


def _png_with_filters(arr: np.ndarray, ctype: int, filters) -> bytes:
    """An 8-bit PNG whose row y uses filter ``filters[y % len(filters)]``."""
    h, w = arr.shape[:2]
    bpp = 1 if arr.ndim == 2 else arr.shape[2]
    rows = arr.reshape(h, w * bpp).astype(np.int32)
    out = bytearray()
    prior = np.zeros(w * bpp, np.int32)
    for y in range(h):
        kind = filters[y % len(filters)]
        row = rows[y]
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(row)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        out.append(kind)
        out += ((row - pred) % 256).astype(np.uint8).tobytes()
        prior = row

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    return (imageio.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)])
@pytest.mark.parametrize("ctype,c", [(0, 1), (2, 3), (6, 4)])
def test_every_row_filter_decodes_as_pil(tmp_path, filters, ctype, c):
    arr = np.random.default_rng(len(filters) * 10 + c).integers(0, 256, (13, 17, c)).astype(np.uint8)
    arr = arr[..., 0] if c == 1 else arr
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_png_with_filters(arr, ctype, filters))
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im), arr)
    np.testing.assert_array_equal(imageio.read_raw(path), arr)


@pytest.mark.parametrize("shape,pal", [((23, 31), None), ((23, 31, 3), None), ((23, 31, 4), None),
                                       ((23, 31), "voc")])
def test_port_png_reads_back_through_pil(tmp_path, shape, pal):
    arr = np.random.default_rng(3).integers(0, 256 if pal is None else 21, shape).astype(np.uint8)
    path = str(tmp_path / "w.png")
    colours = list(palette.VOC_PALETTE) + [(255, 255, 255)] * 235 if pal else None
    imageio.write_png(arr, path, palette=colours)
    with Image.open(path) as im:
        assert im.mode == ("P" if pal else "L" if len(shape) == 2 else {3: "RGB", 4: "RGBA"}[shape[2]])
        np.testing.assert_array_equal(np.asarray(im), arr)
        if pal:
            assert im.getpalette()[: 3 * 256] == [v for rgb in colours for v in rgb]
    np.testing.assert_array_equal(imageio.read_raw(path), arr)


def test_palette_module_matches_jax(tmp_path):
    assert palette.VOC_PALETTE == jpalette.VOC_PALETTE
    assert palette.VOC_CLASSES == jpalette.VOC_CLASSES
    mask = np.random.default_rng(5).integers(0, 21, (19, 27)).astype(np.uint8)
    mask[3, :5] = 255
    for write in ("write_png", "write_palette_png"):
        ours, theirs = str(tmp_path / f"t_{write}.png"), str(tmp_path / f"j_{write}.png")
        getattr(palette, write)(mask, ours)
        getattr(jpalette, write)(mask, theirs)
        with Image.open(ours) as a, Image.open(theirs) as b:
            assert a.mode == b.mode
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            np.testing.assert_array_equal(np.asarray(a.convert("RGB")), np.asarray(b.convert("RGB")))
        np.testing.assert_array_equal(palette.read_mask_png(theirs), jpalette.read_mask_png(theirs))
        np.testing.assert_array_equal(palette.read_mask_png(ours), mask)


def test_decode_by_content_not_extension(tmp_path):
    arr = _smooth_image(np.random.default_rng(1), 24, 30, 3)
    png_as_jpg = str(tmp_path / "a.jpg")
    imageio.write_png(arr, png_as_jpg)
    np.testing.assert_array_equal(imageio.read_image_rgb(png_as_jpg), arr)
    with Image.open(png_as_jpg) as im:
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), arr)
    jpeg_as_png = str(tmp_path / "b.png")
    Image.fromarray(arr).save(jpeg_as_png, format="JPEG")
    with Image.open(jpeg_as_png) as im:
        np.testing.assert_array_equal(imageio.read_image_rgb(jpeg_as_png), np.asarray(im.convert("RGB")))
        np.testing.assert_array_equal(imageio.read_mask(jpeg_as_png), np.asarray(im.convert("L")))
    assert imageio.image_size(jpeg_as_png) == (24, 30)


def test_non_png_without_pil_names_file_and_format(tmp_path, monkeypatch):
    path = str(tmp_path / "c.jpg")
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(path)
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    with pytest.raises(ImportError, match=r"c\.jpg is a JPEG file"):
        imageio.read_image_rgb(path)


def test_sixteen_bit_and_interlaced_png_raise(tmp_path):
    deep = str(tmp_path / "d16.png")
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000).save(deep)
    with Image.open(deep) as im:
        assert "16" in im.mode  # PIL reads it; the port refuses rather than return other values
    with pytest.raises(NotImplementedError, match="16-bit"):
        imageio.read_raw(deep)
    laced = bytearray(_png_with_filters(np.zeros((4, 4), np.uint8), 0, (0,)))
    laced[28] = 1  # IHDR's interlace byte (its CRC is not checked before the refusal)
    path = str(tmp_path / "adam7.png")
    with open(path, "wb") as f:
        f.write(bytes(laced))
    for read in (imageio.read_raw, imageio.read_image_rgb, imageio.read_mask):
        with pytest.raises(NotImplementedError, match="interlaced"):
            read(path)


# -- datasets and make_dataset against the JAX package -------------------------


def _spec(size=41):
    return dataclasses.replace(tsynth.PROFILES["easy"], crop_size=size, cue_grid=(size - 1) // 8 + 1,
                               size_min=size, size_max=size)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The same seed's tree written by both packages (PIL JPEG images)."""
    base = tmp_path_factory.mktemp("trees")
    spec = _spec()
    troot = tsynth.make_dataset(str(base / "torch"), 6, 3, spec, seed=0)
    jroot = jsynth.make_dataset(str(base / "jax"), 6, 3, jsynth.SynthSpec(**dataclasses.asdict(spec)), seed=0)
    return troot, jroot


def test_make_dataset_matches_jax(trees):
    troot, jroot = trees
    for name in ("input_list.txt", "train_aug_id.txt", "val_id.txt"):
        assert open(os.path.join(troot, name)).read() == open(os.path.join(jroot, name)).read()
    with open(os.path.join(troot, "cues.pickle"), "rb") as f:
        tcues = pickle.load(f)
    with open(os.path.join(jroot, "cues.pickle"), "rb") as f:
        jcues = pickle.load(f)
    assert tcues.keys() == jcues.keys()
    for k in tcues:
        for a, b in zip(np.atleast_1d(tcues[k]) if k.endswith("labels") else tcues[k],
                        np.atleast_1d(jcues[k]) if k.endswith("labels") else jcues[k]):
            np.testing.assert_array_equal(a, b)
    for img_id in open(os.path.join(troot, "train_aug_id.txt")).read().split() + \
            open(os.path.join(troot, "val_id.txt")).read().split():
        tj, jj = (os.path.join(r, "JPEGImages", img_id + ".jpg") for r in (troot, jroot))
        assert open(tj, "rb").read() == open(jj, "rb").read()  # the same PIL JPEG
        np.testing.assert_array_equal(tvoc.load_image_bgr(tj), jvoc.load_image_bgr(jj))
        tg, jg = (os.path.join(r, "SegmentationClass", img_id + ".png") for r in (troot, jroot))
        np.testing.assert_array_equal(palette.read_mask_png(tg), jpalette.read_mask_png(jg))


def test_make_dataset_png_tree_holds_the_arrays(tmp_path):
    """encode_image=write_png: the files are PNG under their .jpg names and
    decode to the generated arrays exactly; the rest of the tree is as with
    the default encoder."""
    spec = _spec()
    root = tsynth.make_dataset(str(tmp_path / "png"), 4, 2, spec, seed=3, encode_image=imageio.write_png)
    ref = tsynth.make_dataset(str(tmp_path / "jpg"), 4, 2, spec, seed=3)
    rng = np.random.default_rng(3)
    for i in range(6):
        img, gt = tsynth.make_image(rng, spec)
        if i < 4:
            tsynth.cues_from_gt(rng, gt, spec)
        path = os.path.join(root, "JPEGImages", f"synth_{i:05d}.jpg")
        assert open(path, "rb").read(8) == imageio.PNG_SIGNATURE
        np.testing.assert_array_equal(imageio.read_image_rgb(path), img)
        np.testing.assert_array_equal(palette.read_mask_png(os.path.join(root, "SegmentationClass",
                                                                          f"synth_{i:05d}.png")), gt)
    for name in ("input_list.txt", "cues.pickle"):
        assert open(os.path.join(root, name), "rb").read() == open(os.path.join(ref, name), "rb").read()


def _batches(ds, n=3):
    return [ds.next_batch() for _ in range(n)]


def _assert_batches_equal(a, b):
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("ship_uint8,cache", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("seek", [0, 2])
def test_stage1_dataset_matches_jax(trees, tmp_path, ship_uint8, cache, seek):
    root = trees[1]
    out = []
    for voc, db in ((tvoc, CueDB), (jvoc, JCueDB)):
        cues = db(os.path.join(root, "cues.pickle"), cue_size=6)
        ds = voc.Stage1Dataset(os.path.join(root, "JPEGImages"), os.path.join(root, "input_list.txt"), cues,
                               crop_size=37, batch_size=4, seed=1, ship_uint8=ship_uint8,
                               cache_dir=str(tmp_path / voc.__name__) if cache else None)
        ds.seek(seek)
        out.append(_batches(ds) + (_batches(ds, 2) if cache else []))  # the cache's second epoch too
    _assert_batches_equal(*out)


@pytest.mark.parametrize("crop", [33, 49])
@pytest.mark.parametrize("ship_uint8,cache", [(False, False), (True, False), (True, True)])
def test_stage2_dataset_matches_jax(trees, tmp_path, crop, ship_uint8, cache):
    """Pairs of JPEG image and PNG label as the recipe writes them; crop 49
    pads the 41-pixel images (image with the mean, label with 255), crop 33
    crops at random offsets.  Then seek(2) on fresh datasets."""
    root = trees[1]
    ids = open(os.path.join(root, "train_aug_id.txt")).read().split()
    pairs = tmp_path / "pairs.txt"
    pairs.write_text("".join(f"/JPEGImages/{i}.jpg /SegmentationClass/{i}.png\n" for i in ids))
    for seek in (0, 2):
        out = []
        for voc in (tvoc, jvoc):
            ds = voc.Stage2Dataset(root, str(pairs), crop_size=crop, batch_size=4, seed=2, ship_uint8=ship_uint8,
                                   cache_dir=str(tmp_path / f"{voc.__name__}{seek}") if cache else None)
            ds.seek(seek)
            out.append(_batches(ds))
        _assert_batches_equal(*out)


def test_preprocess_and_lists_match_jax(trees):
    root = trees[1]
    img = tvoc.load_image_bgr(os.path.join(root, "JPEGImages", "synth_00000.jpg"))
    np.testing.assert_array_equal(tvoc.preprocess_image(img, 29), jvoc.preprocess_image(img, 29))
    for name in ("input_list.txt",):
        assert tvoc.read_pair_list(os.path.join(root, name)) == jvoc.read_pair_list(os.path.join(root, name))
    assert tvoc.read_id_list(os.path.join(root, "val_id.txt")) == jvoc.read_id_list(os.path.join(root, "val_id.txt"))
    np.testing.assert_array_equal(tvoc.BGR_MEAN, jvoc.BGR_MEAN)


# -- the prefetch loader (tests/test_loader_and_validation.py's cases) ------------


class _FiniteDataset:
    def __init__(self, n):
        self.n = n

    def __iter__(self):
        for i in range(self.n):
            yield {"x": np.full((2, 3), i, np.float32)}


def test_prefetch_loader_order_and_termination():
    loader = PrefetchLoader(_FiniteDataset(5), device="cpu", prefetch=2)
    seen = [int(b["x"][0, 0]) for b in loader]
    assert seen == [0, 1, 2, 3, 4]


def test_prefetch_loader_close_midstream():
    loader = PrefetchLoader(_FiniteDataset(100), device="cpu", prefetch=2)
    next(loader)
    next(loader)
    loader.close()
    loader._thread.join(timeout=10)
    assert not loader._thread.is_alive()


class _PoisonDataset:
    def __iter__(self):
        yield {"x": np.zeros((2, 2), np.float32)}
        raise OSError("decode failed")


def test_prefetch_loader_surfaces_dataset_exception():
    loader = PrefetchLoader(_PoisonDataset(), device="cpu", prefetch=2)
    next(loader)
    with pytest.raises(OSError, match="decode failed"):
        next(loader)


@pytest.mark.parametrize("in_worker", [True, False])
def test_prefetch_loader_tensors_and_half_images(in_worker):
    batch = {"images": np.full((2, 3, 3, 3), 1.25, np.float32), "raw": np.arange(6, dtype=np.uint8)}
    got = next(PrefetchLoader([batch], device="cpu", device_in_worker=in_worker))
    assert got["images"].dtype == torch.float16 and got["raw"].dtype == torch.uint8
    np.testing.assert_array_equal(got["images"].float().numpy(), batch["images"])
    np.testing.assert_array_equal(got["raw"].numpy(), batch["raw"])
    assert got["images"].device.type == "cpu"


def test_prefetch_loader_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PrefetchLoader(_FiniteDataset(1))  # the card by default, no fallback


# -- checkpoints ----------------------------------------------------------------


class _Tiny(torch.nn.Module):
    """Two layers named as the model's (the optimizer's multipliers go by name)."""

    def __init__(self):
        super().__init__()
        self.conv1_1 = torch.nn.Conv2d(3, 4, 3)
        self.add_module("fc8-SEC_1", torch.nn.Conv2d(4, 2, 1))


def _state(seed=0):
    from dsrg_tpu_torch.config import Stage1Config
    from dsrg_tpu_torch.train.stage1 import init_params, make_optimizer
    from dsrg_tpu_torch.train.train_state import TrainState

    model = _Tiny()
    init_params(model, seed)
    state = TrainState(model, make_optimizer(model, Stage1Config(seed=seed)), torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 100)
    for v in state.optimizer.velocity.values():
        v.copy_(torch.randn(v.shape, generator=gen))
    state.optimizer.step_count = 7 + seed
    torch.rand(5, generator=state.generator)
    return state


def _snap(state):
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            {k: v.clone() for k, v in state.optimizer.velocity.items()},
            state.step, state.generator.get_state().clone())


def _assert_same(a, b):
    for x, y in zip(a[:2], b[:2]):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k]), k
    assert a[2] == b[2]
    assert torch.equal(a[3], b[3])


def test_checkpoint_round_trip_is_bit_equal(tmp_path):
    saved = _state(0)
    want = _snap(saved)
    path = ckpt.save_checkpoint(str(tmp_path / "snaps"), saved, saved.step)
    assert path.endswith("step_7") and not os.path.exists(path + ".tmp")
    assert ckpt.latest_checkpoint(str(tmp_path / "snaps")) == path
    restored = ckpt.restore_checkpoint(path, _state(1))
    _assert_same(_snap(restored), want)
    # the random stream continues where the saved one would have
    assert torch.equal(torch.rand(4, generator=restored.generator), torch.rand(4, generator=saved.generator))
    ckpt.save_params(str(tmp_path / "p"), saved.model)
    params = ckpt.load_params(str(tmp_path / "p"))
    for k, v in saved.model.state_dict().items():
        assert torch.equal(params[k], v)


def test_latest_checkpoint_ignores_params_and_partial_files(tmp_path):
    for name in ("step_3", "step_12_params", "step_40.tmp", "other"):
        (tmp_path / name).write_bytes(b"")
    assert ckpt.latest_checkpoint(str(tmp_path)) == str(tmp_path / "step_3")
    assert jckpt.latest_checkpoint(str(tmp_path)) == ckpt.latest_checkpoint(str(tmp_path))
    assert ckpt.latest_checkpoint(str(tmp_path / "none")) is None


def test_async_writer_keeps_the_state_at_save(tmp_path):
    state = _state(2)
    want = _snap(state)
    writer = ckpt.AsyncCheckpointWriter()
    path = writer.save(str(tmp_path), state, state.step)
    ppath = writer.save_params(path + "_params", state.model)
    with torch.no_grad():  # what the next step does, in place, while a write may be in flight
        for p in state.model.parameters():
            p.add_(1.0)
        for v in state.optimizer.velocity.values():
            v.mul_(2.0)
    state.optimizer.step_count += 1
    writer.close()
    _assert_same(_snap(ckpt.restore_checkpoint(path, _state(3))), want)
    for k, v in ckpt.load_params(ppath).items():
        assert torch.equal(v, want[0][k])


def _flax_tree(rng, layers):
    return {name: {"kernel": rng.normal(size=shape).astype(np.float32),
                   "bias": rng.normal(size=shape[-1]).astype(np.float32)} for name, shape in layers.items()}


def test_copy_from_matches_jax(capsys):
    """Name and shape match -> the source's values; a shape mismatch or a
    missing name keeps the target's, with the JAX package's two messages."""
    rng = np.random.default_rng(0)
    target = _flax_tree(rng, {"conv1_1": (3, 3, 3, 8), "fc7_1": (1, 1, 8, 8), "fc8-SEC_1": (1, 1, 8, 21)})
    source = _flax_tree(rng, {"conv1_1": (3, 3, 3, 8), "fc8-SEC_1": (1, 1, 8, 6), "extra": (1, 1, 2, 2)})
    merged_jax = jckpt.copy_from(target, source)
    jax_out = capsys.readouterr().out
    merged = ckpt.copy_from(params_from_flax(target), params_from_flax(source))
    out = capsys.readouterr().out
    want = params_from_flax({k: {n: np.asarray(v) for n, v in d.items()} for k, d in merged_jax.items()})
    assert merged.keys() == want.keys()
    for k in want:
        assert torch.equal(merged[k], want[k]), k
    # one message per entry: JAX names the layer once where a whole layer is missing
    assert out.count("shape mismatch") == jax_out.count("shape mismatch") == 2
    assert out.count("not in source") == 2 and jax_out.count("not in source") == 1
    assert "copy_from: fc7_1.weight not in source, keeping init" in out
    assert "copy_from: shape mismatch at fc8-SEC_1.weight, keeping init" in out


def test_copy_from_loads_a_module():
    model = _Tiny()
    source = {k: torch.full_like(v, 0.5) for k, v in model.state_dict().items() if not k.startswith("fc8")}
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ckpt.copy_from(model, source, verbose=False)
    for k, v in model.state_dict().items():
        assert torch.equal(v, source[k] if k in source else before[k]), k


# -- the expand loss, the watchdog and profiling copies ------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_expand_loss_matches_jax(seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(3, 9, 11, 6)).astype(np.float32) * 3
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    stat = (rng.random((3, 6)) < 0.5).astype(np.float32)
    stat[:, 0] = 1.0
    stat[0, 1:] = 0.0  # no foreground class: the floored divisor
    ref = float(jexpand_loss(jnp.asarray(probs), jnp.asarray(stat)))
    got = float(expand_loss(torch.from_numpy(probs), torch.from_numpy(stat)))
    assert np.isfinite(got)
    assert got == pytest.approx(ref, rel=1e-5)


def test_watchdog_copy_matches_jax(tmp_path, capsys):
    assert watchdog.RESTART_EXIT_CODE == jwatchdog.RESTART_EXIT_CODE == 75
    for flag in (0.0, -1.0, 3.5):
        assert watchdog.resolve_limit(flag) == jwatchdog.resolve_limit(flag)
    (tmp_path / "a.png").write_bytes(b"")
    items = ["a", "b"]
    assert watchdog.split_existing(items, lambda i: str(tmp_path / f"{i}.png")) == \
        jwatchdog.split_existing(items, lambda i: str(tmp_path / f"{i}.png"))
    with pytest.raises(SystemExit) as exc:
        watchdog.maybe_restart(1e-6, 1, 2)
    assert exc.value.code == 75
    watchdog.maybe_restart(1e-6, 2, 2)  # finishing beats restarting
    watchdog.maybe_restart(1e-6, 0, 2)  # each launch banks some progress first
    fired = []
    dog = watchdog.StallWatchdog(0.05, on_stall=fired.append)
    dog._thread.join(timeout=10)
    assert fired and fired[0] > 0.05
    capsys.readouterr()


def test_profiling_copies_and_trace(tmp_path):
    logger = profiling.MetricLogger(str(tmp_path / "m.jsonl"), average_window=2)
    assert logger.log(1, {"loss": 1.0}) == {"loss": 1.0}
    assert logger.log(2, {"loss": 3.0}) == {"loss": 2.0}
    assert logger.log(3, {"loss": 5.0}) == {"loss": 4.0}
    logger.close()
    assert [json.loads(ln)["step"] for ln in open(tmp_path / "m.jsonl")] == [1, 2, 3]
    timer = profiling.StepTimer(batch_size=4)
    timer.tick()
    timer.tick()
    times = timer.summary()
    assert times["p50_ms"] <= times["p90_ms"] <= times["max_ms"] and times["images_per_s"] > 0
    with profiling.span("before"):  # no profiler: not in the block's table
        pass
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.span("dsrg.step"):
            torch.ones(8) @ torch.ones(8)
    assert (tmp_path / "prof" / "trace.json").exists() and (tmp_path / "prof" / "kernels.txt").exists()
    spans = json.loads((tmp_path / "prof" / "spans.json").read_text())
    assert list(spans) == ["dsrg.step"] and spans["dsrg.step"]["count"] == 1
    assert set(profiling.kernel_launches()) == {"mmgrid_splat", "mmgrid_slice", "pool_bwd_h", "pool_bwd_w",
                                                "pool_bwd_h_bf16", "pool_bwd_w_bf16"}


def test_no_port_module_imports_pil():
    """The card's machine has no PIL: importing every module of the port,
    and reading and writing a PNG, loads none of it."""
    import pkgutil
    import subprocess
    import sys
    from pathlib import Path

    import dsrg_tpu_torch

    repo = Path(__file__).resolve().parents[1]
    names = [m.name for m in pkgutil.walk_packages(dsrg_tpu_torch.__path__, "dsrg_tpu_torch.")]
    assert "dsrg_tpu_torch.tools.run_recipe" in names
    code = ("import sys, importlib, tempfile, os, numpy as np\n"
            f"for n in {names!r}: importlib.import_module(n)\n"
            "from dsrg_tpu_torch.utils import imageio\n"
            "p = os.path.join(tempfile.mkdtemp(), 'a.jpg'); imageio.write_png(np.zeros((3, 4, 3), np.uint8), p)\n"
            "assert imageio.read_image_rgb(p).shape == (3, 4, 3)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] == 'PIL'))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env, capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout
