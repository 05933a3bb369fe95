"""COCO 81-class cue dataset (``dsrg_tpu/data/coco.py``), the counterpart of
the reference's ``AnnotationLayerCOCO`` (``pylayers/pylayers/pylayers.py:389-512``).

Reads (image, label) path pairs; resizes images to ``new_size`` with scipy
order-1 zoom; builds a dense per-class cue volume of shape
(new_h/8 + 1, new_w/8 + 1, 81) from the label png subsampled to that grid
(every non-ignore pixel becomes a cue); multi-hot image labels from the
classes present.  The random mirror is applied on the device inside the
train step, jointly with the image (``:500-503``).  Images and labels are
read through ``utils/imageio.py`` (PNG without PIL; a JPEG through PIL).
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Iterator

import numpy as np
from scipy.ndimage import zoom as ndzoom

from dsrg_tpu_torch.data.voc import _EpochOrder, _files_fingerprint, load_image_bgr, read_pair_list
from dsrg_tpu_torch.utils import imageio

COCO_MEAN = np.array([104.008, 116.669, 122.675], np.float32)


class COCOCueDataset(_EpochOrder):
    def __init__(
        self,
        root: str,
        source: str,
        batch_size: int = 10,
        new_size: tuple = (321, 321),
        num_classes: int = 81,
        mean: np.ndarray = COCO_MEAN,
        ignore_label: int = 255,
        seed: int = 0,
        ship_uint8: bool = False,
        cache_dir: str | None = None,
    ):
        """``ship_uint8``: ship raw uint8 BGR canvases and uint8 {0,1} cue
        volumes; the mean (this dataset's, not integral) is subtracted on
        the device: pass the same mean as ``input_mean`` to
        ``make_stage1_step``.  ``cache_dir``: the first epoch fills uint8
        memmaps (canvas, score-resolution label grid, multi-hot), later
        epochs decode nothing; the tag fingerprints both path columns, so
        regenerated data invalidates it.
        """
        self.root = root
        self.entries = read_pair_list(source)
        self.batch_size = batch_size
        self.new_h, self.new_w = new_size
        self.num_classes = num_classes
        self.mean = np.asarray(mean, np.float32)
        self.ignore_label = ignore_label
        self.ship_uint8 = ship_uint8
        super().__init__(len(self.entries), True, seed)
        self.cue_h = self.new_h // 8 + 1
        self.cue_w = self.new_w // 8 + 1
        self._cache = None
        if cache_dir is not None:
            if not ship_uint8:
                raise ValueError("cache_dir requires ship_uint8=True")
            os.makedirs(cache_dir, exist_ok=True)
            fp = _files_fingerprint(self.root + p for pair in self.entries for p in pair)
            n = len(self.entries)
            tag = f"coco_{self.new_h}x{self.new_w}_{n}_{fp}"

            def _mm(suffix, shape):
                path = osp.join(cache_dir, tag + suffix)
                return np.lib.format.open_memmap(path, mode="r+" if osp.exists(path) else "w+",
                                                 dtype=np.uint8, shape=shape)

            self._cache_img = _mm("_img.u8", (n, self.new_h, self.new_w, 3))
            # the score-resolution label grid (< 255 a class, 255 ignore):
            # cues are rebuilt from it, 81x smaller than the dense volume
            self._cache_small = _mm("_small.u8", (n, self.cue_h, self.cue_w))
            self._cache_hot = _mm("_hot.u8", (n, num_classes))
            flag_path = osp.join(cache_dir, tag + ".done")
            self._cache_flags = (np.fromfile(flag_path, np.uint8).astype(bool) if osp.exists(flag_path)
                                 else np.zeros(n, bool))
            self._cache_flag_path = flag_path
            self._cache_dirty = False
            self._cache = True

    def __len__(self) -> int:
        return len(self.entries)

    def _decode_one(self, image_path: str, label_path: str):
        """(float resized canvas, multi-hot, small label grid) from disk."""
        image = load_image_bgr(self.root + image_path)
        image = ndzoom(image, (self.new_h / image.shape[0], self.new_w / image.shape[1], 1.0), order=1)

        label = imageio.read_raw(self.root + label_path).astype(np.int32)
        if label.ndim == 3:
            label = label[..., 0]
        # nearest rows and columns of the cue grid
        lh = np.clip(np.round(np.linspace(0, label.shape[0] - 1, self.cue_h)).astype(int), 0, None)
        lw = np.clip(np.round(np.linspace(0, label.shape[1] - 1, self.cue_w)).astype(int), 0, None)
        small = label[np.ix_(lh, lw)].astype(np.uint8)

        image_label = np.zeros(self.num_classes, np.uint8)
        present = np.unique(label)
        image_label[present[present != self.ignore_label]] = 1
        return image, image_label, small

    def _cues_from_small(self, small: np.ndarray, dtype) -> np.ndarray:
        cues = np.zeros((self.cue_h, self.cue_w, self.num_classes), dtype)
        valid = small != self.ignore_label
        cues[valid, small[valid].astype(np.intp)] = 1
        return cues

    def _load_one(self, idx: int):
        image_path, label_path = self.entries[idx]
        if self._cache is not None and self._cache_flags[idx]:
            canvas = self._cache_img[idx]
            image_label = self._cache_hot[idx]
            small = self._cache_small[idx]
        else:
            image, image_label, small = self._decode_one(image_path, label_path)
            if not self.ship_uint8:
                # the float path: the unquantised resize minus the mean, as the reference
                return ((image - self.mean).astype(np.float32), image_label.astype(np.float32),
                        self._cues_from_small(small, np.float32))
            canvas = np.clip(np.round(image), 0, 255).astype(np.uint8)
            if self._cache is not None:
                self._cache_img[idx] = canvas
                self._cache_hot[idx] = image_label
                self._cache_small[idx] = small
                self._cache_flags[idx] = True
                self._cache_dirty = True
        return canvas, image_label, self._cues_from_small(small, np.uint8)

    def next_batch(self) -> dict:
        n = self.batch_size
        img_dtype = np.uint8 if self.ship_uint8 else np.float32
        images = np.empty((n, self.new_h, self.new_w, 3), img_dtype)
        labels = np.empty((n, self.num_classes), np.float32)
        cues = np.empty((n, self.cue_h, self.cue_w, self.num_classes), img_dtype)
        for i in range(n):
            images[i], labels[i], cues[i] = self._load_one(self._next_index())
        if self._cache is not None and self._cache_dirty:
            self._cache_flags.astype(np.uint8).tofile(self._cache_flag_path)
            self._cache_dirty = False
        return {"images": images, "labels": labels, "cues": cues}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()
