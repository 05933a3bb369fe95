"""The benchmark's own file writers: 8-bit PNG (zlib + numpy) and the
reference's cue pickle, and the synthetic VOC trees the entry points read.

A tree follows the layout of the recipe's VOC tree: ``JPEGImages/<id>.jpg``
(PNG bytes under the VOC name: readers decode a file by its content),
``SegmentationClass/<id>.png``, ``cues.pickle``, ``input_list.txt`` (stage
1) and ``train.txt`` (stage 2's image / label pairs).
"""

from __future__ import annotations

import pickle
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def png_bytes(array: np.ndarray, level: int = 1) -> bytes:
    """An (H, W) grey or (H, W, 3) RGB uint8 array as PNG bytes, every row
    unfiltered."""
    a = np.asarray(array)
    if a.dtype != np.uint8 or a.ndim not in (2, 3) or (a.ndim == 3 and a.shape[2] != 3):
        raise ValueError(f"png_bytes takes (H, W) or (H, W, 3) uint8, got {a.dtype} {a.shape}")
    h, w = a.shape[:2]
    rows = np.zeros((h, 1 + a[0].size), np.uint8)
    rows[:, 1:] = a.reshape(h, -1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if a.ndim == 2 else 2, 0, 0, 0)
    return b"".join([_SIGNATURE, _chunk(b"IHDR", ihdr), _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)),
                     _chunk(b"IEND", b"")])


def write_cue_pickle(path: Path, samples) -> None:
    """The reference's cue pickle: ``"%i_labels"`` -> foreground classes,
    ``"%i_cues"`` -> (class, row, col) arrays, keyed by sample index."""
    data = {}
    for i, s in enumerate(samples):
        data["%i_labels" % i] = np.asarray(s.fg)
        data["%i_cues" % i] = tuple(np.asarray(a) for a in s.cues)
    with open(path, "wb") as f:
        pickle.dump(data, f, protocol=2)


def write_tree(root: Path, samples, threads: int = 8) -> Path:
    """Write ``samples`` as a VOC tree under ``root``; returns ``root``."""
    (root / "JPEGImages").mkdir(parents=True, exist_ok=True)
    (root / "SegmentationClass").mkdir(parents=True, exist_ok=True)
    ids = [f"synth_{i:05d}" for i in range(len(samples))]

    def one(i):
        (root / "JPEGImages" / f"{ids[i]}.jpg").write_bytes(png_bytes(samples[i].image))
        (root / "SegmentationClass" / f"{ids[i]}.png").write_bytes(png_bytes(samples[i].gt))

    with ThreadPoolExecutor(max_workers=threads) as pool:
        list(pool.map(one, range(len(samples))))
    write_cue_pickle(root / "cues.pickle", samples)
    (root / "input_list.txt").write_text("".join(f"{n}.jpg {i}\n" for i, n in enumerate(ids)))
    (root / "train.txt").write_text("".join(f"/JPEGImages/{n}.jpg /SegmentationClass/{n}.png\n" for n in ids))
    return root


def tree_bytes(root: Path) -> int:
    """Bytes of the files under ``root``."""
    return sum(f.stat().st_size for f in root.rglob("*") if f.is_file())
