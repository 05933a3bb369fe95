"""Deep seeded region growing (DSRG's ``DSRGLayer``, ``pylayers.py:237-275``)
on the host, with scipy's connected-component labelling.

Per image: cue pixels get ``class + 1`` (the highest cue class winning);
where the refined probability, restricted to the image's classes, peaks on
a foreground class above ``th2``, or on the background above both ``th1``
and ``th2``, the peak class (the first maximum) overwrites it.  Then, class
by class in ascending order, every 8-connected component of that class's
candidate pixels that holds one of its seeds joins its seeds, except pixels
seeded by exactly one other class.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

_EIGHT = np.ones((3, 3), bool)


def grow(labels: np.ndarray, cues: np.ndarray, probs: np.ndarray, th1: float = 0.99,
         th2: float = 0.85) -> np.ndarray:
    """(B, M) labels, (B, h, w, M) cues and refined probabilities (fp32) ->
    (B, h, w, M) grown cues."""
    out = np.empty(cues.shape, np.float32)
    t1, t2 = np.float32(th1), np.float32(th2)
    for b in range(cues.shape[0]):
        present = labels[b] > 0.5
        masked = np.where(present, probs[b], -np.inf).astype(np.float32)
        argc = masked.argmax(-1)
        maxp = masked.max(-1)
        cue_label = np.where(cues[b] > 0.5, np.arange(1, cues.shape[-1] + 1), 0).max(-1)
        fg = (maxp > t2) & (argc != 0)
        bg = (argc == 0) & (maxp > t1) & (maxp > t2)
        label_map = np.where(fg, argc + 1, cue_label)
        label_map = np.where(bg, 1, label_map)
        seed = cues[b] > 0.5
        for c in np.nonzero(present)[0]:
            cand = label_map == c + 1
            barrier = cand & ~seed[..., c] & (seed.sum(-1) == 1)
            comp, _ = ndimage.label(cand, structure=_EIGHT)
            starts = np.unique(comp[cand & seed[..., c]])
            reach = np.isin(comp, starts[starts > 0])
            seed[..., c] |= reach & ~barrier
        out[b] = seed
    return out
