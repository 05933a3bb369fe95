"""The batches the train steps see, worked out from the generated samples.

The loaders' documented rules: sample ``k`` of the stream is
``default_rng((seed, k // n)).permutation(n)[k % n]``; stage 1 resizes each
BGR image to the crop with ``scipy.ndimage.zoom(order=1)`` and subtracts the
BGR mean; stage 2 subtracts the mean, pads to the crop (image 0, label 255)
and crops at ``default_rng(s)``'s offsets, ``s`` the first word of
``SeedSequence((seed, k))`` modulo 2**31 - 1; float images travel to the
card as float16.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import zoom as ndzoom

from portbench.yardstick.synth import dense_cues, dense_labels

BGR_MEAN = np.array([104.0, 117.0, 123.0], np.float32)


def sample_index(n: int, seed: int, k: int) -> int:
    return int(np.random.default_rng((seed, k // n)).permutation(n)[k % n])


def _bgr(sample) -> np.ndarray:
    return sample.image[:, :, ::-1].astype(np.float32)


def resized(sample, crop: int) -> np.ndarray:
    """Stage 1's image: BGR resized to crop x crop, mean subtracted."""
    img = _bgr(sample)
    return ndzoom(img, (crop / float(img.shape[0]), crop / float(img.shape[1]), 1.0), order=1) - BGR_MEAN


def stage1_batch(samples, t: int, batch: int, crop: int, cue: int, num_classes: int, seed: int) -> dict:
    picked = [samples[sample_index(len(samples), seed, t * batch + j)] for j in range(batch)]
    return {"images": np.stack([resized(s, crop).astype(np.float16).astype(np.float32) for s in picked]),
            "labels": np.stack([dense_labels(s, num_classes) for s in picked]),
            "cues": np.stack([dense_cues(s, num_classes, cue) for s in picked])}


def stage2_batch(samples, t: int, batch: int, crop: int, seed: int, ignore: int = 255) -> dict:
    images, labels = [], []
    for j in range(batch):
        k = t * batch + j
        s = samples[sample_index(len(samples), seed, k)]
        img = _bgr(s) - BGR_MEAN
        lab = s.gt.astype(np.float32)
        ph, pw = max(crop - img.shape[0], 0), max(crop - img.shape[1], 0)
        img = np.pad(img, ((0, ph), (0, pw), (0, 0)))
        lab = np.pad(lab, ((0, ph), (0, pw)), constant_values=ignore)
        rng = np.random.default_rng(int(np.random.SeedSequence((seed, k)).generate_state(1)[0] % (2**31 - 1)))
        oh = rng.integers(0, lab.shape[0] - crop + 1)
        ow = rng.integers(0, lab.shape[1] - crop + 1)
        images.append(img[oh:oh + crop, ow:ow + crop].astype(np.float16).astype(np.float32))
        labels.append(lab[oh:oh + crop, ow:ow + crop].astype(np.int64))
    return {"images": np.stack(images), "labels": np.stack(labels)}
