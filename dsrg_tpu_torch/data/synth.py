"""Synthetic weakly-supervised segmentation data: the port's own copy of
``dsrg_tpu/data/synth.py`` (``SynthSpec``, the ``easy`` and ``voc``
profiles, ``make_image``, ``cues_from_gt``, ``make_dataset``), with the same names and
the same numpy ``Generator`` calls in the same order, so that a seed gives
the same arrays in both packages.

No VOC data can be in this repository; these generated images with sparse
seed cues, in the reference's cue format (``data/cues.save_cue_db``), are
its accuracy proxy (``tools/synth_check.py``, ``chip_smoke.py``).

Two difficulty profiles:

* ``easy``: 2 foreground classes (a red circle and a green square), 1-2
  objects, square images, a flat noisy background.
* ``voc``: 20 foreground classes (colour x shape x texture signatures), 2-4
  occluding objects, variable image sizes, background texture overlap and
  low-frequency lighting.

Cues land as CAM + saliency seeds do: a few interior foreground points per
class on the score grid and background points anywhere unoccupied.
"""

from __future__ import annotations

import os
import os.path as osp
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
from scipy.ndimage import binary_erosion, zoom as ndzoom


@dataclass
class SynthSpec:
    """Knobs for one synthetic dataset family."""

    n_classes: int = 21          # label channels incl. background
    n_fg_classes: int = 2        # distinct foreground classes actually drawn
    size_min: int = 321          # sampled image height/width range
    size_max: int = 321
    square: bool = True          # False: H and W sampled independently
    objects_min: int = 1
    objects_max: int = 2
    texture_overlap: bool = False  # distractor bg patches in muted fg colors
    lighting: bool = False         # low-frequency multiplicative shading
    n_fg_cues: int = 12
    n_bg_cues: int = 40
    cue_grid: int = 41             # score-grid size at crop_size (321 -> 41)
    crop_size: int = 321           # training-time resize target
    noise: float = 10.0


EASY = SynthSpec()

VOC_HARD = SynthSpec(
    n_fg_classes=20,
    size_min=241,
    size_max=500,
    square=False,
    objects_min=2,
    objects_max=4,
    texture_overlap=True,
    lighting=True,
)

PROFILES = {"easy": EASY, "voc": VOC_HARD}

# 20 visually distinct foreground base colors (class 1..20).
#
# Identifiability constraint (see ``signature_margins``): every labeled color
# must stay >= MIN_MUTED_MARGIN away (RGB L2) from the *muted distractor*
# gamut {0.45*color_j + 0.55*base : j in 1..20, base in [90, 140)} that
# ``texture_overlap`` paints into the UNLABELED background — otherwise the
# class is genuinely inseparable from background by local appearance and
# weakly-supervised seed growing must fail on it.  The original class-19
# color (150, 90, 90) sat 5.4 units from muted class-1 red and collapsed to
# 0.01 IoU in the production-length run (seed precision 0.16 at every
# checkpoint); six more classes sat below 30.  The entries below were chosen
# by constrained search (min perturbation of the original hues s.t. muted
# margin >= 35, fg-fg margin >= 45, gray-band margin >= 45), enforced on the
# JAX package's copy by ``tests/test_data_utils.py``;
# ``tests/test_torch_port_synth.py`` holds this copy equal to it.
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

# Margins enforced between labeled colors and the confusable background
# content ``make_image`` can draw (muted distractor patches, the gray base).
MIN_MUTED_MARGIN = 35.0
MIN_FG_MARGIN = 45.0
MIN_GRAY_MARGIN = 45.0


def signature_margins():
    """Per-class separability margins of the palette (RGB L2 distances).

    Returns ``(muted_d, fg_d, gray_d)``, each shape (20,): distance of each
    labeled color to (a) the nearest muted distractor color any image can
    contain, (b) the nearest other labeled color, (c) the nearest gray in the
    background-base band (widened by the lighting field's +-13%).
    """
    bases = np.arange(90, 140, dtype=np.float32)
    muted = (0.45 * PALETTE[:, None, :] + 0.55 * bases[None, :, None]).reshape(-1, 3)
    muted_d = np.sqrt(((PALETTE[:, None, :] - muted[None, :, :]) ** 2).sum(-1)).min(1)
    d = np.sqrt(((PALETTE[:, None, :] - PALETTE[None, :, :]) ** 2).sum(-1))
    np.fill_diagonal(d, np.inf)
    fg_d = d.min(1)
    grays = np.stack([np.linspace(75, 160, 50)] * 3, -1).astype(np.float32)
    gray_d = np.sqrt(((PALETTE[:, None, :] - grays[None, :, :]) ** 2).sum(-1)).min(1)
    return muted_d, fg_d, gray_d

N_SHAPES = 8
N_TEXTURES = 4


def _rot(yy, xx, cy, cx, theta):
    u = (xx - cx) * np.cos(theta) + (yy - cy) * np.sin(theta)
    v = -(xx - cx) * np.sin(theta) + (yy - cy) * np.cos(theta)
    return u, v


def _shape_mask(kind: int, yy, xx, cy, cx, r, theta):
    """Boolean mask for shape family ``kind`` (class signature, not random)."""
    u, v = _rot(yy, xx, cy, cx, theta)
    if kind == 0:  # circle
        return u * u + v * v <= r * r
    if kind == 1:  # square
        return (np.abs(u) <= r) & (np.abs(v) <= r)
    if kind == 2:  # ellipse
        return (u / r) ** 2 + (v / (0.55 * r)) ** 2 <= 1.0
    if kind == 3:  # isoceles triangle
        return (v >= -0.85 * r) & (np.abs(u) <= 0.75 * (r - v) * 0.6) & (v <= r)
    if kind == 4:  # ring
        d2 = u * u + v * v
        return (d2 <= r * r) & (d2 >= (0.45 * r) ** 2)
    if kind == 5:  # diamond
        return np.abs(u) + np.abs(v) <= 1.2 * r
    if kind == 6:  # plus / cross
        return ((np.abs(u) <= 0.35 * r) & (np.abs(v) <= r)) | (
            (np.abs(v) <= 0.35 * r) & (np.abs(u) <= r)
        )
    # 7: half-moon — circle minus an offset circle
    d2 = u * u + v * v
    d2b = (u - 0.55 * r) ** 2 + v * v
    return (d2 <= r * r) & (d2b >= (0.75 * r) ** 2)


def _texture_field(kind: int, yy, xx, cy, cx, r, theta, phase: float):
    """Multiplicative texture in [~0.6, ~1.3] tied to the class signature."""
    u, v = _rot(yy, xx, cy, cx, theta)
    k = 2.0 * np.pi / max(r * 0.45, 4.0)
    if kind == 0:  # solid
        return np.ones_like(u)
    if kind == 1:  # stripes
        return np.where(np.sin(k * u + phase) > 0, 1.22, 0.72)
    if kind == 2:  # checker
        return np.where(np.sin(k * u + phase) * np.sin(k * v + phase) > 0, 1.2, 0.74)
    # 3: dots — bright blobs on a darker base
    s = (np.sin(k * u + phase) * np.sin(k * v + phase)) ** 2
    return 0.78 + 0.55 * (s > 0.55)


def class_signature(cls: int):
    """(color, shape_kind, texture_kind) for foreground class ``cls`` >= 1."""
    i = (cls - 1) % len(PALETTE)
    return PALETTE[i], i % N_SHAPES, (i // N_SHAPES + i) % N_TEXTURES


def _low_freq_field(rng, h, w, amp):
    """Sum of a few random low-frequency cosine waves, zero-mean, |.|<=amp."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.zeros((h, w), np.float32)
    for _ in range(3):
        fy, fx = rng.uniform(0.5, 2.0, 2) * np.pi / max(h, w)
        ph = rng.uniform(0, 2 * np.pi)
        out += np.cos(fy * yy + fx * xx * rng.choice([-1.0, 1.0]) + ph)
    return amp * out / 3.0


def _obj_window(h, w, cy, cx, r):
    """Bounding-box slices + local coordinate grids (keeps per-object work
    O(r²) instead of O(H·W) — the generator runs on a single host core)."""
    pad = int(1.6 * r) + 2
    y0, y1 = max(int(cy) - pad, 0), min(int(cy) + pad, h)
    x0, x1 = max(int(cx) - pad, 0), min(int(cx) + pad, w)
    yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float32)
    return (slice(y0, y1), slice(x0, x1)), yy, xx


def make_image(rng: np.random.Generator, spec: SynthSpec):
    """One (rgb uint8 image, uint8 gt-mask) pair under ``spec``."""
    if spec.square:
        h = w = int(rng.integers(spec.size_min, spec.size_max + 1))
    else:
        h = int(rng.integers(spec.size_min, spec.size_max + 1))
        w = int(rng.integers(spec.size_min, spec.size_max + 1))

    base = rng.integers(90, 140)
    img = np.full((h, w, 3), base, np.float32)
    img += _low_freq_field(rng, h, w, 18.0)[..., None]

    if spec.texture_overlap:
        # distractor patches: muted fg colors + fg textures, NOT labeled
        for _ in range(int(rng.integers(2, 5))):
            cls = int(rng.integers(1, spec.n_fg_classes + 1))
            color, _, tex = class_signature(cls)
            r = int(rng.integers(min(h, w) // 8, min(h, w) // 3))
            cy = float(rng.integers(0, h))
            cx = float(rng.integers(0, w))
            theta = float(rng.uniform(0, np.pi))
            win, yy, xx = _obj_window(h, w, cy, cx, r)
            mask = _shape_mask(1, yy, xx, cy, cx, r, theta)  # rotated square patch
            muted = 0.45 * color + 0.55 * np.float32(base)
            t = _texture_field(tex, yy, xx, cy, cx, r, theta, rng.uniform(0, 6.3))
            img[win][mask] = muted[None, :] * t[mask, None]

    gt = np.zeros((h, w), np.uint8)
    n_obj = int(rng.integers(spec.objects_min, spec.objects_max + 1))
    for _ in range(n_obj):
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
        img[win][mask] = color[None, :] * t[mask, None] + rng.normal(
            0, spec.noise * 0.8, (int(mask.sum()), 3)
        )
        gt[win][mask] = cls  # draw order = z order: later objects occlude

    if spec.lighting:
        img *= 1.0 + _low_freq_field(rng, h, w, 0.13)[..., None]
    img += rng.normal(0, spec.noise, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8), gt


def cues_from_gt(rng: np.random.Generator, gt: np.ndarray, spec: SynthSpec):
    """Sparse (class, row, col) seed cues on the score grid.

    Mirrors how CAM seeds behave after the training-time resize
    (``Stage1Dataset`` resizes every image to ``crop_size``; the score grid
    is ``(crop-1)/8+1``): the gt is nearest-resized to crop geometry,
    stride-8 sampled, and foreground points are drawn from the *interior*
    (erosion survivors) so each cue's stride cell sits inside its object.
    """
    g = spec.cue_grid
    if gt.shape != (spec.crop_size, spec.crop_size):
        gt_r = ndzoom(
            gt,
            (spec.crop_size / gt.shape[0], spec.crop_size / gt.shape[1]),
            order=0,
        )
    else:
        gt_r = gt
    # exact score-grid sample positions: the 8x-stride conv grid puts cell
    # (i, j) at pixel (8i, 8j) of the crop ((crop-1)/8+1 cells per side)
    stride = max((spec.crop_size - 1) // max(g - 1, 1), 1)
    idx = np.minimum(np.arange(g) * stride, gt_r.shape[0] - 1)
    small = gt_r[np.ix_(np.minimum(idx, gt_r.shape[0] - 1),
                        np.minimum(idx, gt_r.shape[1] - 1))]
    cs, rs, cols = [], [], []
    for cls in np.unique(small):
        m = small == cls
        if cls > 0:
            interior = binary_erosion(m)
            if interior.any():
                m = interior
        ys, xs = np.nonzero(m)
        if len(ys) == 0:
            continue
        take = spec.n_bg_cues if cls == 0 else spec.n_fg_cues
        sel = rng.choice(len(ys), size=min(take, len(ys)), replace=False)
        cs.extend([int(cls)] * len(sel))
        rs.extend(ys[sel].tolist())
        cols.extend(xs[sel].tolist())
    return np.asarray(cs), np.asarray(rs), np.asarray(cols)


def _save_jpeg(img: np.ndarray, path: str) -> None:
    """The JAX package's image file: PIL's JPEG at its default quality."""
    from PIL import Image

    Image.fromarray(img).save(path)


def make_dataset(
    root: str,
    n_train: int,
    n_val: int,
    spec: SynthSpec,
    seed: int = 0,
    progress_every: int = 0,
    encode_image: Optional[Callable[[np.ndarray, str], None]] = None,
) -> str:
    """Write a full reference-format dataset tree under ``root``.

    Layout (identical to the VOC tree the tools expect): ``JPEGImages/``,
    ``SegmentationClass/``, ``cues.pickle``, ``input_list.txt``,
    ``train_aug_id.txt``, ``val_id.txt``.  Image-level labels are derived
    from cue presence (an object fully occluded away yields no cues and no
    label bit — matching how CAM misses invisible objects).

    ``encode_image(array, path)`` writes each RGB image; ``None`` is PIL's
    JPEG, saved as the JAX package saves it, so both packages write the same
    tree for a seed.  ``utils.imageio.write_png`` writes a lossless PNG
    instead, where PIL is not installed: the file keeps its ``<id>.jpg``
    name, which the lists and every tool expect, and the readers decode it by
    its content.  Such a tree has no JPEG artefacts: its images are the
    generated arrays themselves.
    """
    from dsrg_tpu_torch.data.cues import save_cue_db
    from dsrg_tpu_torch.utils.palette import write_png

    encode = encode_image or _save_jpeg
    rng = np.random.default_rng(seed)
    os.makedirs(osp.join(root, "JPEGImages"), exist_ok=True)
    os.makedirs(osp.join(root, "SegmentationClass"), exist_ok=True)
    entries = {}
    train_ids, val_ids = [], []
    for i in range(n_train + n_val):
        img, gt = make_image(rng, spec)
        img_id = f"synth_{i:05d}"
        encode(img, osp.join(root, "JPEGImages", img_id + ".jpg"))
        write_png(gt, osp.join(root, "SegmentationClass", img_id + ".png"))
        if i < n_train:
            train_ids.append(img_id)
            c, r, col = cues_from_gt(rng, gt, spec)
            fg = np.unique(c[c > 0]) if len(c) else np.asarray([], np.int64)
            entries[i] = (fg, (c, r, col))
        else:
            val_ids.append(img_id)
        if progress_every and (i + 1) % progress_every == 0:
            print(f"synth: {i + 1}/{n_train + n_val} images", flush=True)
    save_cue_db(osp.join(root, "cues.pickle"), entries)
    with open(osp.join(root, "input_list.txt"), "w") as f:
        for i, img_id in enumerate(train_ids):
            f.write(f"{img_id}.jpg {i}\n")
    with open(osp.join(root, "train_aug_id.txt"), "w") as f:
        f.write("\n".join(train_ids) + "\n")
    with open(osp.join(root, "val_id.txt"), "w") as f:
        f.write("\n".join(val_ids) + "\n")
    return root
