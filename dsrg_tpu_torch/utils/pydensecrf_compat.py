"""The reference's other CRF parameterisation (``training/tools/utils.py``;
``dsrg_tpu/utils/pydensecrf_compat.py``).

The reference ships a ``dense_crf()`` helper on the external pydensecrf
package with its own defaults (sxy 3 Gaussian / 49 bilateral, compat 3 / 4,
srgb 5).  It is dead code there, referenced only from commented-out lines,
and it returns the input probabilities instead of the inference result
(``utils.py:46-48``).  This keeps its signature and parameterisation on the
port's ``DenseCRF`` and returns the result; ``faithful_bug=True`` gives the
input back, as the reference does.
"""

from __future__ import annotations

import numpy as np

from dsrg_tpu_torch.ops.crf.api import DenseCRF, PottsCompatibility


def dense_crf(probs: np.ndarray, img: np.ndarray = None, n_iters: int = 10,
              sxy_gaussian: float = 3.0, compat_gaussian: float = 3.0,
              sxy_bilateral: float = 49.0, compat_bilateral: float = 4.0,
              srgb_bilateral: float = 5.0, faithful_bug: bool = False, device=None) -> np.ndarray:
    """(H, W, M) probabilities, and an optional (H, W, 3) image for the
    bilateral term -> (H, W, M) marginals (numpy), computed on ``device``
    (the card by default)."""
    if faithful_bug:
        return probs  # utils.py:46-48 returns its input
    h, w, m = probs.shape
    crf = DenseCRF(w, h, m, device=device)
    unary_cost = -np.log(np.maximum(probs, 1e-20)).reshape(h * w, m)
    crf.set_unary_energy(unary_cost.astype(np.float32).ravel())
    crf.add_pairwise_gaussian(sxy_gaussian, sxy_gaussian, PottsCompatibility(compat_gaussian))
    if img is not None:
        crf.add_pairwise_bilateral(sxy_bilateral, sxy_bilateral, srgb_bilateral, srgb_bilateral,
                                   srgb_bilateral, np.asarray(img, np.float32),
                                   PottsCompatibility(compat_bilateral))
    return crf.inference(n_iters).reshape(h, w, m)
