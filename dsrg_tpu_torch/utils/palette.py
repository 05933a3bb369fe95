"""VOC-style label PNGs (``dsrg_tpu/utils/palette.py``), through the port's
own PNG codec (``utils/imageio.py``) instead of PIL.

The reference writes prediction masks two ways: raw grey PNGs via
``cv2.imwrite`` (``test-ms.py:59-65``) and palette PNGs with the 21-colour
VOC map (``show-result.py:55-61``).
"""

from __future__ import annotations

import numpy as np

from dsrg_tpu_torch.utils import imageio

# The 21 VOC colors used across the reference tools (test-ms.py:50-55),
# scaled to bytes.  Index 255 is conventionally the ignore boundary (white).
_BASE = [
    (0.0, 0.0, 0.0), (0.5, 0.0, 0.0), (0.0, 0.5, 0.0), (0.5, 0.5, 0.0),
    (0.0, 0.0, 0.5), (0.5, 0.0, 0.5), (0.0, 0.5, 0.5), (0.5, 0.5, 0.5),
    (0.25, 0.0, 0.0), (0.75, 0.0, 0.0), (0.25, 0.5, 0.0), (0.75, 0.5, 0.0),
    (0.25, 0.0, 0.5), (0.75, 0.0, 0.5), (0.25, 0.5, 0.5), (0.75, 0.5, 0.5),
    (0.0, 0.25, 0.0), (0.5, 0.25, 0.0), (0.0, 0.75, 0.0), (0.5, 0.75, 0.0),
    (0.0, 0.25, 0.5),
]
VOC_PALETTE = [tuple(int(255 * v) for v in c) for c in _BASE]

VOC_CLASSES = (
    "background", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def write_png(mask: np.ndarray, path: str) -> None:
    """Raw label png (cv2.imwrite equivalent, test-ms.py:64)."""
    imageio.write_png(np.asarray(mask).astype(np.uint8), path)


def write_palette_png(mask: np.ndarray, path: str) -> None:
    """Palette png with the VOC colormap (show-result.py:55-61 equivalent)."""
    pal = list(VOC_PALETTE) + [(255, 255, 255)] * (256 - len(VOC_PALETTE))
    imageio.write_png(np.asarray(mask).astype(np.uint8), path, palette=pal)


def read_mask_png(path: str) -> np.ndarray:
    """Read a label mask png (palette or grayscale) as (H, W) uint8 labels."""
    return imageio.read_mask(path)
