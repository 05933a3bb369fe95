"""Localization-cue database (``dsrg_tpu/data/cues.py``).

The reference ships cues as a Python-2 pickle mapping
``"%i_labels" -> array of foreground class indices`` and
``"%i_cues" -> (class, row, col) index arrays`` on a 41x41 grid
(``pylayers.py:346-382``; ``training/localization_cues/localization_cues[-sal].pickle``).
The same file is read here (latin1 bridges the Python-2 pickle); a pickle
can run code when it is loaded, so read only files of the recipe.  Dense
NHWC arrays come out:

  labels: (M,) multi-hot with bit 0 (background) always set
  cues:   (cue_h, cue_w, M) {0, 1}

Stage 1 trains on the cues; the pseudo ground truth restricts each image's
mask to its label set.
"""

from __future__ import annotations

import pickle
from typing import Tuple

import numpy as np


class CueDB:
    def __init__(self, path: str, num_classes: int = 21, cue_size: int = 41):
        with open(path, "rb") as f:
            self.data = pickle.load(f, encoding="latin1")
        self.num_classes = num_classes
        self.cue_size = cue_size

    def __contains__(self, image_id: int) -> bool:
        return ("%i_labels" % image_id) in self.data

    def labels(self, image_id: int) -> np.ndarray:
        out = np.zeros(self.num_classes, np.float32)
        out[0] = 1.0  # background bit always on (pylayers.py:378)
        out[self.data["%i_labels" % image_id]] = 1.0
        return out

    def cues(self, image_id: int) -> np.ndarray:
        out = np.zeros((self.cue_size, self.cue_size, self.num_classes), np.float32)
        c, r, col = self.data["%i_cues" % image_id]
        out[r, col, c] = 1.0
        return out

    def get(self, image_id: int) -> Tuple[np.ndarray, np.ndarray]:
        return self.labels(image_id), self.cues(image_id)


def save_cue_db(path: str, entries: dict) -> None:
    """Write a cue pickle in the reference's format.

    ``entries``: image_id -> (fg_class_indices array, (class, row, col) arrays).
    """
    data = {}
    for image_id, (labels, cues_idx) in entries.items():
        data["%i_labels" % image_id] = np.asarray(labels)
        data["%i_cues" % image_id] = tuple(np.asarray(a) for a in cues_idx)
    with open(path, "wb") as f:
        pickle.dump(data, f, protocol=2)
