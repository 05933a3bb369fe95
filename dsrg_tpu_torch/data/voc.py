"""PASCAL VOC data pipeline (stage-1 cue training and stage-2 pseudo-GT):
the port's copy of ``dsrg_tpu/data/voc.py``, with the same data order.

Host-side equivalents of the reference's three data layers, emitting NHWC
numpy batches for the train steps:

* stage 1: Caffe ``ImageData`` (resize to 321x321, BGR, mean-subtract,
  shuffle, ``train-s.prototxt:3-22``) + ``AnnotationLayer`` cue lookup
  (``pylayers.py:346-387``; the joint random mirror is applied *on device*
  inside the train step).
* stage 2: ``ImageSegDataLayer`` / ``SimpleTransformer``
  (``pylayers/pylayers/layer.py``): pad to crop size with ignore-label mask
  padding, random (train) or center (test) crop, mirror handled on device.

Images load through ``utils/imageio.py`` (PNG without PIL, anything else
through PIL, by the file's content); resizes use ``scipy.ndimage.zoom``
order-1 — the same routine the reference tools call — for bit parity.
"""

from __future__ import annotations

import os.path as osp
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Tuple

import numpy as np
from scipy.ndimage import zoom as ndzoom

from dsrg_tpu_torch.data.cues import CueDB
from dsrg_tpu_torch.utils import imageio

# Caffe VGG16 per-channel mean, BGR order (the reference's test-ms.py)
BGR_MEAN = np.array([104.0, 117.0, 123.0], np.float32)


def read_id_list(path: str) -> List[str]:
    """Bare image-id lists (train_aug_id.txt / val_id.txt)."""
    return [ln.strip() for ln in open(path) if ln.strip()]


def read_pair_list(path: str) -> List[Tuple[str, str]]:
    """Two-column lists: 'image.jpg id' (input_list.txt) or img/label paths (train.txt)."""
    out = []
    for ln in open(path):
        ln = ln.strip()
        if ln:
            a, b = ln.split()
            out.append((a, b))
    return out


def load_image_bgr(path: str) -> np.ndarray:
    """(H, W, 3) float32 BGR image in [0, 255] (cv2.imread convention)."""
    rgb = imageio.read_image_rgb(path).astype(np.float32)
    return rgb[:, :, ::-1]


def preprocess_image(
    image_bgr: np.ndarray, size: int, mean: np.ndarray = BGR_MEAN
) -> np.ndarray:
    """Resize to size x size (scipy order-1 zoom) and mean-subtract. HWC BGR."""
    img = ndzoom(
        image_bgr.astype(np.float32),
        (size / float(image_bgr.shape[0]), size / float(image_bgr.shape[1]), 1.0),
        order=1,
    )
    return img - mean


def _files_fingerprint(paths) -> str:
    """Short content fingerprint of a file list: (path, size, mtime_ns).

    Decoded-canvas cache tags embed this so a regenerated dataset or a
    re-dumped pseudo-GT set with the same counts/dims invalidates the cache
    instead of silently serving stale canvases/labels.  stat() only — no
    file reads — so ~10k entries cost milliseconds.
    """
    import hashlib
    import os

    h = hashlib.blake2b(digest_size=8)
    for p in paths:
        st = os.stat(p)
        h.update(p.encode())
        h.update(f"{st.st_size}:{st.st_mtime_ns}".encode())
    return h.hexdigest()


class _EpochOrder:
    """Deterministic epoch-permutation sampling.

    The k-th sample drawn is a pure function of ``(seed, k)`` — epoch
    ``k // n`` uses the permutation from ``default_rng((seed, epoch))`` —
    so a resumed run can ``seek()`` to any batch index and reproduce the
    uninterrupted run's data order exactly (the reference restarts its
    ``ImageData``/``BatchLoader`` shuffle from scratch on
    ``solver.restore``; deterministic resume is a deliberate upgrade)."""

    def __init__(self, n: int, shuffle: bool, seed: int):
        self._n = n
        self._shuffle = shuffle
        self._seed = seed
        self._epoch = -1
        self._order = None
        self._count = 0  # samples drawn so far (local, in multi-host mode)
        self._shard_index = 0
        self._shard_count = 1
        self._start_row = None
        self._global_batch = None

    def configure_shard(
        self,
        shard_index: int,
        shard_count: int,
        start_row: int | None = None,
        global_batch: int | None = None,
    ) -> None:
        """Multi-host mode: serve only this process's contiguous slice of
        every GLOBAL batch.

        With ``batch_size`` set to the per-process local batch, local draw
        ``(t, j)`` maps to global sample ``t*global_batch + start_row + j``
        — the same layout the contiguous global-mesh sharding assigns to
        this process's devices, so every process reads a disjoint slice of
        the identical global data order (deterministic resume included).

        ``start_row``/``global_batch`` default to the even split
        (``shard_index * batch_size`` / ``batch_size * shard_count``).
        Uneven global batches (the reference's batch 20 over a pod-slice
        host count that does not divide it) pass them explicitly: this
        process loads ``batch_size`` REAL samples starting at global row
        ``start_row``; rows past the global batch clamp to the last real
        sample (they become masked padding — ``tools/train.py``)."""
        assert 0 <= shard_index < shard_count, (shard_index, shard_count)
        self._shard_index = shard_index
        self._shard_count = shard_count
        self._start_row = start_row
        self._global_batch = global_batch

    def _index_at(self, k: int) -> int:
        epoch, pos = divmod(k, self._n)
        if epoch != self._epoch:
            self._epoch = epoch
            if self._shuffle:
                self._order = np.random.default_rng(
                    (self._seed, epoch)
                ).permutation(self._n)
            else:
                self._order = np.arange(self._n)
        return int(self._order[pos])

    def _next_index(self) -> int:
        k = self._count
        if self._shard_count > 1:
            t, j = divmod(k, self.batch_size)
            gb = (self.batch_size * self._shard_count
                  if self._global_batch is None else self._global_batch)
            start = (self._shard_index * self.batch_size
                     if self._start_row is None else self._start_row)
            k = t * gb + min(start + j, gb - 1)
        idx = self._index_at(k)
        self._count += 1
        return idx

    def seek(self, batches: int) -> None:
        """Position the stream as if ``batches`` batches were already drawn."""
        self._count = batches * self.batch_size


class Stage1Dataset(_EpochOrder):
    """(images, labels, cues) batches from an input list + cue pickle.

    ``input_list.txt`` rows are '<file>.jpg <numeric-id>' where the id keys
    the cue pickle (``train-s.prototxt:3-22``, ``pylayers.py:375-382``).
    """

    def __init__(
        self,
        image_dir: str,
        input_list: str,
        cue_db: CueDB,
        crop_size: int = 321,
        batch_size: int = 20,
        shuffle: bool = True,
        seed: int = 0,
        workers: int = 8,
        ship_uint8: bool = False,
        cache_dir: str | None = None,
    ):
        self.image_dir = image_dir
        self.entries = read_pair_list(input_list)
        self.cue_db = cue_db
        self.crop_size = crop_size
        self.batch_size = batch_size
        # ship raw uint8 BGR canvases; mean-sub runs on device inside the
        # step (stage1._device_normalize) — 4x fewer host->device bytes
        # than f32 (quantization <= 0.5/255 after the resize, below the
        # model's bf16 compute noise)
        self.ship_uint8 = ship_uint8
        # decoded-canvas cache: on single-core hosts JPEG decode + zoom is
        # the loader bottleneck (~30-60 ms/image); the first epoch fills a
        # (n, crop, crop, 3) uint8 memmap, later epochs read it back at
        # memory speed.  The reference's ImageData layer re-decodes every
        # epoch (train-s.prototxt:3-22).  Implies uint8 quantization, so it
        # requires ship_uint8.
        self._cache = None
        if cache_dir is not None:
            if not ship_uint8:
                raise ValueError("cache_dir requires ship_uint8=True")
            import os

            os.makedirs(cache_dir, exist_ok=True)
            fp = _files_fingerprint(
                osp.join(image_dir, fname) for fname, _ in self.entries
            )
            path = osp.join(
                cache_dir, f"stage1_{crop_size}_{len(self.entries)}_{fp}.u8"
            )
            self._cache = np.lib.format.open_memmap(
                path, mode="r+" if osp.exists(path) else "w+",
                dtype=np.uint8,
                shape=(len(self.entries), crop_size, crop_size, 3),
            )
            flag_path = path + ".done"
            self._cache_flags = (
                np.fromfile(flag_path, np.uint8).astype(bool)
                if osp.exists(flag_path)
                else np.zeros(len(self.entries), bool)
            )
            self._cache_flag_path = flag_path
            self._cache_dirty = False
        super().__init__(len(self.entries), shuffle, seed)
        # zlib/PIL/scipy release the GIL in decode/zoom, so threads parallelize IO
        self._pool = ThreadPoolExecutor(max_workers=workers) if workers > 1 else None

    def __len__(self) -> int:
        return len(self.entries)

    def _load_one(self, idx: int):
        fname, image_id = self.entries[idx]
        labels, cues = self.cue_db.get(int(image_id))
        if self._cache is not None and self._cache_flags[idx]:
            return self._cache[idx], labels, cues
        img = load_image_bgr(osp.join(self.image_dir, fname))
        if self.ship_uint8:
            resized = ndzoom(
                img, (self.crop_size / img.shape[0], self.crop_size / img.shape[1], 1.0),
                order=1,
            )
            image = np.clip(np.round(resized), 0, 255).astype(np.uint8)
            if self._cache is not None:
                self._cache[idx] = image
                self._cache_flags[idx] = True
                self._cache_dirty = True
        else:
            image = preprocess_image(img, self.crop_size)
        return image, labels, cues

    def next_batch(self) -> dict:
        n = self.batch_size
        m = self.cue_db.num_classes
        s = self.cue_db.cue_size
        picked = [self._next_index() for _ in range(n)]
        if self._pool is not None:
            loaded = list(self._pool.map(self._load_one, picked))
        else:
            loaded = [self._load_one(e) for e in picked]
        if self._cache is not None and self._cache_dirty:
            self._cache_flags.astype(np.uint8).tofile(self._cache_flag_path)
            self._cache_dirty = False
        images = np.empty((n, self.crop_size, self.crop_size, 3),
                          np.uint8 if self.ship_uint8 else np.float32)
        labels = np.empty((n, m), np.float32)
        # cue volumes are {0,1}: uint8 shipping is exact and 4x smaller
        cues = np.empty((n, s, s, m), np.uint8 if self.ship_uint8 else np.float32)
        for i, (img, lab, cue) in enumerate(loaded):
            images[i], labels[i], cues[i] = img, lab, cue
        return {"images": images, "labels": labels, "cues": cues}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()


class Stage2Dataset(_EpochOrder):
    """(images, labels) crops from an (image, pseudo-GT) pair list.

    SimpleTransformer semantics (``layer.py:169-236``): mean-subtract, pad
    bottom/right to crop size (image with 0, label with ignore_label), random
    crop in Train phase / center crop otherwise.
    """

    def __init__(
        self,
        root: str,
        pair_list: str,
        crop_size: int = 321,
        batch_size: int = 10,
        mean: np.ndarray = BGR_MEAN,
        ignore_label: int = 255,
        phase: str = "Train",
        seed: int = 0,
        workers: int = 8,
        ship_uint8: bool = False,
        cache_dir: str | None = None,
    ):
        self.root = root
        self.entries = read_pair_list(pair_list)
        self.crop = crop_size
        self.batch_size = batch_size
        self.mean = np.asarray(mean, np.float32)
        self.ignore_label = ignore_label
        self.phase = phase
        # uint8 shipping is EXACT for stage 2 (no resize: source pixels are
        # integers, and padding with the integer BGR mean reproduces the
        # reference's pad-then-mean-sub zeros on device).  The on-device
        # normalize subtracts the fixed stage-1 BGR_MEAN constant
        # (train/stage1.py:_device_normalize), so a custom mean cannot ride
        # the uint8 path — fail loudly rather than normalize wrongly.
        if ship_uint8 and not np.array_equal(self.mean, BGR_MEAN):
            raise ValueError(
                "ship_uint8=True moves mean-subtraction on device, which uses "
                f"the fixed BGR_MEAN {tuple(BGR_MEAN)}; got mean="
                f"{tuple(self.mean)}. Use the float path for custom means."
            )
        self.ship_uint8 = ship_uint8
        super().__init__(len(self.entries), True, seed)
        # decoded cache (single-core hosts are decode-bound at batch 10):
        # images vary in size, so canvases are stored padded to the dataset
        # max on a fixed-shape sparse memmap, with per-entry valid dims
        self._cache = None
        if cache_dir is not None:
            if not self.ship_uint8:
                raise ValueError("cache_dir requires ship_uint8=True")
            import os

            os.makedirs(cache_dir, exist_ok=True)
            # fingerprint BOTH columns: re-dumped pseudo-GT (same image list,
            # new label pngs) must invalidate the label cache
            fp = _files_fingerprint(
                self._resolve(p) for pair in self.entries for p in pair
            )
            n = len(self.entries)
            tag = f"stage2_{crop_size}_{n}_{fp}"
            dims_path = osp.join(cache_dir, tag + "_dims.npy")
            if osp.exists(dims_path):
                self._cache_dims = np.load(dims_path)
            else:
                dims = []
                for img_path, _ in self.entries:
                    h, w = imageio.image_size(self._resolve(img_path))  # header only
                    dims.append((max(h, crop_size), max(w, crop_size)))
                self._cache_dims = np.asarray(dims, np.int32)
                np.save(dims_path, self._cache_dims)
            ch, cw = int(self._cache_dims[:, 0].max()), int(self._cache_dims[:, 1].max())
            self._cache_img = np.lib.format.open_memmap(
                osp.join(cache_dir, tag + "_img.u8"),
                mode="r+" if osp.exists(osp.join(cache_dir, tag + "_img.u8")) else "w+",
                dtype=np.uint8, shape=(n, ch, cw, 3),
            )
            self._cache_lbl = np.lib.format.open_memmap(
                osp.join(cache_dir, tag + "_lbl.u8"),
                mode="r+" if osp.exists(osp.join(cache_dir, tag + "_lbl.u8")) else "w+",
                dtype=np.uint8, shape=(n, ch, cw),
            )
            flag_path = osp.join(cache_dir, tag + ".done")
            self._cache_flags = (
                np.fromfile(flag_path, np.uint8).astype(bool)
                if osp.exists(flag_path)
                else np.zeros(n, bool)
            )
            self._cache_flag_path = flag_path
            self._cache_dirty = False
            self._cache = True
        self._pool = ThreadPoolExecutor(max_workers=workers) if workers > 1 else None

    def __len__(self) -> int:
        return len(self.entries)

    def _resolve(self, p: str) -> str:
        # reference concatenates root + path verbatim (layer.py:113-114);
        # additionally accept genuinely absolute paths (pseudo-GT dirs often
        # live outside the dataset root)
        cand = self.root + p
        if not osp.exists(cand) and osp.isabs(p) and osp.exists(p):
            return p
        return cand

    def _decode_padded(self, idx: int):
        """(image, label) decoded and padded to >= crop (pre-crop)."""
        img_path, lbl_path = self.entries[idx]
        image = load_image_bgr(self._resolve(img_path))
        if self.ship_uint8:
            image = image.astype(np.uint8)  # source pixels are exact ints
        else:
            image = image - self.mean
        label = imageio.read_raw(self._resolve(lbl_path)).astype(np.float32)
        if label.ndim == 3:
            label = label[..., 0]
        c = self.crop
        pad_h = max(c - image.shape[0], 0)
        pad_w = max(c - image.shape[1], 0)
        if pad_h or pad_w:
            if self.ship_uint8:
                # pad with the integer BGR mean: device mean-sub yields the
                # reference's exact zero padding (layer.py:196-200)
                pad_val = np.round(self.mean).astype(np.uint8)
                image = np.stack(
                    [np.pad(image[..., ch], ((0, pad_h), (0, pad_w)),
                            constant_values=pad_val[ch]) for ch in range(3)],
                    axis=-1,
                )
            else:
                image = np.pad(image, ((0, pad_h), (0, pad_w), (0, 0)))
            label = np.pad(label, ((0, pad_h), (0, pad_w)),
                           constant_values=self.ignore_label)
        return image, label

    def _load_pair(self, idx: int, crop_seed: int):
        if self._cache is not None and self._cache_flags[idx]:
            h, w = self._cache_dims[idx]
            image = self._cache_img[idx, :h, :w]
            label = self._cache_lbl[idx, :h, :w]
        else:
            image, label = self._decode_padded(idx)
            if self._cache is not None:
                h, w = image.shape[:2]
                self._cache_img[idx, :h, :w] = image
                self._cache_lbl[idx, :h, :w] = label  # classes+ignore fit uint8
                self._cache_flags[idx] = True
                self._cache_dirty = True
        c = self.crop
        h, w = label.shape
        if self.phase == "Train":
            # per-item Generator: thread-safe + order-deterministic
            crop_rng = np.random.default_rng(crop_seed)
            off_h = crop_rng.integers(0, h - c + 1)
            off_w = crop_rng.integers(0, w - c + 1)
        else:
            off_h, off_w = (h - c) // 2, (w - c) // 2
        return (
            image[off_h : off_h + c, off_w : off_w + c],
            label[off_h : off_h + c, off_w : off_w + c].astype(np.int32),
        )

    def next_batch(self) -> dict:
        n, c = self.batch_size, self.crop
        base = self._count  # crop seeds keyed to sample index: resume-exact
        picked = [self._next_index() for _ in range(n)]
        seeds = [
            int(np.random.SeedSequence((self._seed, base + j)).generate_state(1)[0]
                % (2**31 - 1))
            for j in range(n)
        ]
        jobs = list(zip(picked, seeds))
        if self._pool is not None:
            loaded = list(self._pool.map(lambda a: self._load_pair(*a), jobs))
        else:
            loaded = [self._load_pair(*a) for a in jobs]
        if self._cache is not None and self._cache_dirty:
            self._cache_flags.astype(np.uint8).tofile(self._cache_flag_path)
            self._cache_dirty = False
        images = np.empty((n, c, c, 3),
                          np.uint8 if self.ship_uint8 else np.float32)
        # labels fit uint8 exactly (classes < 255, ignore == 255): 4x fewer
        # host->device bytes; the step shrinks/compares in f32/int32 anyway
        labels = np.empty((n, c, c), np.uint8 if self.ship_uint8 else np.int32)
        for i, (img, lab) in enumerate(loaded):
            images[i], labels[i] = img, lab
        return {"images": images, "labels": labels}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()
