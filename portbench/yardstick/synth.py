"""The benchmark's frozen copy of the synthetic VOC generator.

A copy of the ``voc`` profile of ``dsrg_tpu_torch/data/synth.py`` (colour x
shape x texture class signatures, 2-4 occluding objects, background
distractors in muted class colours, low-frequency lighting), kept here so
that a change to the program cannot change the traffic.  Three departures:
each image draws from a generator of its own, ``default_rng((seed,
index))``, so that a pool is made by a few threads; a caller may fix the
image's size (``make_image(..., size=(h, w))``); and the seed cues follow
DSRG's rule for its cue file (``cues_from_gt``), not the profile's sparse
points.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
from scipy.ndimage import gaussian_filter, zoom as ndzoom


@dataclass(frozen=True)
class SynthSpec:
    n_fg_classes: int = 20
    size_min: int = 241
    size_max: int = 500
    objects_min: int = 2
    objects_max: int = 4
    cue_grid: int = 41
    crop_size: int = 321
    noise: float = 10.0
    cam_share: float = 0.2        # foreground cue: CAM score >= this share of the class's maximum
    bg_saliency: float = 0.06     # background cue: normalised saliency under this
    cam_blur: float = 1.5         # the synthetic CAM's blur, in grid cells
    part_spread: float = 0.6      # its part weighting: a bump this share of the object's extent wide
    saliency_blur: float = 1.0    # the synthetic saliency map's blur, in grid cells


PALETTE = np.array(
    [
        (205, 60, 55), (55, 190, 70), (65, 90, 215), (230, 200, 60),
        (170, 70, 200), (60, 200, 200), (235, 130, 40), (130, 220, 120),
        (200, 60, 140), (90, 45, 150), (165, 165, 45), (45, 135, 105),
        (220, 110, 110), (110, 170, 220), (195, 105, 60), (120, 120, 210),
        (90, 210, 160), (210, 170, 130), (150, 45, 90), (105, 105, 30),
    ],
    np.float32,
)
N_SHAPES = 8
N_TEXTURES = 4


def _rot(yy, xx, cy, cx, theta):
    u = (xx - cx) * np.cos(theta) + (yy - cy) * np.sin(theta)
    v = -(xx - cx) * np.sin(theta) + (yy - cy) * np.cos(theta)
    return u, v


def _shape_mask(kind: int, yy, xx, cy, cx, r, theta):
    u, v = _rot(yy, xx, cy, cx, theta)
    if kind == 0:  # circle
        return u * u + v * v <= r * r
    if kind == 1:  # square
        return (np.abs(u) <= r) & (np.abs(v) <= r)
    if kind == 2:  # ellipse
        return (u / r) ** 2 + (v / (0.55 * r)) ** 2 <= 1.0
    if kind == 3:  # triangle
        return (v >= -0.85 * r) & (np.abs(u) <= 0.75 * (r - v) * 0.6) & (v <= r)
    if kind == 4:  # ring
        d2 = u * u + v * v
        return (d2 <= r * r) & (d2 >= (0.45 * r) ** 2)
    if kind == 5:  # diamond
        return np.abs(u) + np.abs(v) <= 1.2 * r
    if kind == 6:  # cross
        return ((np.abs(u) <= 0.35 * r) & (np.abs(v) <= r)) | ((np.abs(v) <= 0.35 * r) & (np.abs(u) <= r))
    d2 = u * u + v * v  # 7: half-moon
    d2b = (u - 0.55 * r) ** 2 + v * v
    return (d2 <= r * r) & (d2b >= (0.75 * r) ** 2)


def _texture_field(kind: int, yy, xx, cy, cx, r, theta, phase: float):
    u, v = _rot(yy, xx, cy, cx, theta)
    k = 2.0 * np.pi / max(r * 0.45, 4.0)
    if kind == 0:
        return np.ones_like(u)
    if kind == 1:
        return np.where(np.sin(k * u + phase) > 0, 1.22, 0.72)
    if kind == 2:
        return np.where(np.sin(k * u + phase) * np.sin(k * v + phase) > 0, 1.2, 0.74)
    s = (np.sin(k * u + phase) * np.sin(k * v + phase)) ** 2
    return 0.78 + 0.55 * (s > 0.55)


def class_signature(cls: int):
    i = (cls - 1) % len(PALETTE)
    return PALETTE[i], i % N_SHAPES, (i // N_SHAPES + i) % N_TEXTURES


def _low_freq_field(rng, h, w, amp):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.zeros((h, w), np.float32)
    for _ in range(3):
        fy, fx = rng.uniform(0.5, 2.0, 2) * np.pi / max(h, w)
        ph = rng.uniform(0, 2 * np.pi)
        out += np.cos(fy * yy + fx * xx * rng.choice([-1.0, 1.0]) + ph)
    return amp * out / 3.0


def _obj_window(h, w, cy, cx, r):
    pad = int(1.6 * r) + 2
    y0, y1 = max(int(cy) - pad, 0), min(int(cy) + pad, h)
    x0, x1 = max(int(cx) - pad, 0), min(int(cx) + pad, w)
    yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float32)
    return (slice(y0, y1), slice(x0, x1)), yy, xx


def make_image(rng: np.random.Generator, spec: SynthSpec, size: Optional[Tuple[int, int]] = None):
    """(RGB uint8 image, uint8 ground-truth mask, bool mask of the unlabelled
    distractors)."""
    if size is None:
        h = int(rng.integers(spec.size_min, spec.size_max + 1))
        w = int(rng.integers(spec.size_min, spec.size_max + 1))
    else:
        h, w = size
    base = rng.integers(90, 140)
    img = np.full((h, w, 3), base, np.float32)
    img += _low_freq_field(rng, h, w, 18.0)[..., None]
    distractors = np.zeros((h, w), bool)
    for _ in range(int(rng.integers(2, 5))):  # unlabelled distractors in muted class colours
        cls = int(rng.integers(1, spec.n_fg_classes + 1))
        color, _, tex = class_signature(cls)
        r = int(rng.integers(min(h, w) // 8, min(h, w) // 3))
        cy, cx = float(rng.integers(0, h)), float(rng.integers(0, w))
        theta = float(rng.uniform(0, np.pi))
        win, yy, xx = _obj_window(h, w, cy, cx, r)
        mask = _shape_mask(1, yy, xx, cy, cx, r, theta)
        muted = 0.45 * color + 0.55 * np.float32(base)
        t = _texture_field(tex, yy, xx, cy, cx, r, theta, rng.uniform(0, 6.3))
        img[win][mask] = muted[None, :] * t[mask, None]
        distractors[win] |= mask
    gt = np.zeros((h, w), np.uint8)
    for _ in range(int(rng.integers(spec.objects_min, spec.objects_max + 1))):
        cls = int(rng.integers(1, spec.n_fg_classes + 1))
        color, shape, tex = class_signature(cls)
        r = int(rng.integers(min(h, w) // 6, min(h, w) // 3))
        cy = float(rng.integers(int(0.6 * r), h - int(0.6 * r)))
        cx = float(rng.integers(int(0.6 * r), w - int(0.6 * r)))
        theta = float(rng.uniform(0, np.pi)) if shape != 0 else 0.0
        win, yy, xx = _obj_window(h, w, cy, cx, r)
        mask = _shape_mask(shape, yy, xx, cy, cx, r, theta)
        if not mask.any():
            continue
        t = _texture_field(tex, yy, xx, cy, cx, r, theta, rng.uniform(0, 6.3))
        img[win][mask] = color[None, :] * t[mask, None] + rng.normal(0, spec.noise * 0.8, (int(mask.sum()), 3))
        gt[win][mask] = cls  # later objects occlude earlier ones
    img *= 1.0 + _low_freq_field(rng, h, w, 0.13)[..., None]
    img += rng.normal(0, spec.noise, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8), gt, distractors


def _on_grid(m: np.ndarray, spec: SynthSpec) -> np.ndarray:
    """``m`` resized to the crop (nearest) and read at the score grid's cells."""
    g, crop = spec.cue_grid, spec.crop_size
    m_r = m if m.shape == (crop, crop) else ndzoom(m, (crop / m.shape[0], crop / m.shape[1]), order=0)
    stride = max((crop - 1) // max(g - 1, 1), 1)
    idx = np.minimum(np.arange(g) * stride, m_r.shape[0] - 1)
    return m_r[np.ix_(idx, np.minimum(idx, m_r.shape[1] - 1))]


def cues_from_gt(rng: np.random.Generator, gt: np.ndarray, distractors: np.ndarray, spec: SynthSpec):
    """(class, row, col) seed cues on the score grid, by the rule DSRG states
    for its cue file (Huang et al., CVPR 2018, section 4.1, after SEC):
    foreground, for each class in the image, the cells whose CAM score is at
    least ``cam_share`` (20%) of that class's maximum; background, the cells
    whose normalised saliency (DRFI's in the paper) is under ``bg_saliency``
    (0.06).  A cell holds one label: the class of the highest score, over
    background.  Stand-ins for the two maps: a class's CAM score is its mask
    weighted by a bump at one of its cells (CAM peaks on a discriminative
    part) and blurred (CAM is coarse); the saliency is the blurred objects,
    the unlabelled distractors at half weight, scaled to [0, 1]."""
    g = spec.cue_grid
    small = _on_grid(gt, spec)
    yy, xx = np.mgrid[0:g, 0:g].astype(np.float64)
    label = np.full((g, g), -1, np.int64)
    best = np.zeros((g, g))
    for cls in np.unique(small[small > 0]):
        m = small == cls
        ys, xs = np.nonzero(m)
        k = int(rng.integers(len(ys)))
        width = spec.part_spread * np.sqrt(len(ys))
        bump = np.exp(-((yy - ys[k]) ** 2 + (xx - xs[k]) ** 2) / (2.0 * width * width))
        score = gaussian_filter(m * bump, spec.cam_blur)
        win = (score >= spec.cam_share * score.max()) & (score > best)
        label[win], best[win] = cls, score[win]
    sal = np.maximum(gaussian_filter((small > 0).astype(np.float64), spec.saliency_blur),
                     0.5 * gaussian_filter(_on_grid(distractors.astype(np.float64), spec), spec.saliency_blur))
    span = sal.max() - sal.min()
    sal = (sal - sal.min()) / span if span > 0 else np.zeros_like(sal)
    label[(label < 0) & (sal < spec.bg_saliency)] = 0
    rs, cols = np.nonzero(label >= 0)
    return label[rs, cols], rs.astype(np.int64), cols.astype(np.int64)


@dataclass
class Sample:
    image: np.ndarray        # (h, w, 3) RGB uint8
    gt: np.ndarray           # (h, w) uint8 class map
    cues: tuple              # (class, row, col) arrays on the cue grid
    fg: np.ndarray           # foreground classes that have cues (the image-level labels)


def make_pool(seed: int, n: int, spec: SynthSpec, sizes: Optional[Sequence[Tuple[int, int]]] = None,
              threads: int = 8) -> list:
    """``n`` samples, sample ``i`` from ``default_rng((seed, i))``; ``sizes``
    fixes each image's (h, w)."""
    def one(i):
        rng = np.random.default_rng((seed, i))
        img, gt, distractors = make_image(rng, spec, None if sizes is None else sizes[i])
        c, r, col = cues_from_gt(rng, gt, distractors, spec)
        return Sample(img, gt, (c, r, col), np.unique(c[c > 0]))

    with ThreadPoolExecutor(max_workers=threads) as pool:
        return list(pool.map(one, range(n)))


def dense_labels(sample: Sample, num_classes: int) -> np.ndarray:
    """(M,) multi-hot image labels, background always set."""
    out = np.zeros(num_classes, np.float32)
    out[0] = 1.0
    out[sample.fg] = 1.0
    return out


def dense_cues(sample: Sample, num_classes: int, cue_size: int) -> np.ndarray:
    """(cue, cue, M) {0, 1} cues."""
    out = np.zeros((cue_size, cue_size, num_classes), np.float32)
    c, r, col = sample.cues
    out[r, col, c] = 1.0
    return out
