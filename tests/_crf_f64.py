"""A float64 numpy reference for the ``DenseCRF`` object API's inference,
and the two kinds of input the CRF tests hold fp32 engines to it on.

Shared by ``test_torch_port_crf_api.py`` (the JAX package and the port on
the CPU) and ``test_torch_port_cuda.py`` (the port on the card), so both
measure the same distance on the same inputs.  Imports neither package.
"""

from __future__ import annotations

import numpy as np

H, W, M = 24, 20, 5
SPATIAL = (3, 3, 3.0)  # add_pairwise_gaussian(sx, sy, Potts(w))
BILATERAL = (30, 30, 13, 13, 13, 10.0)  # add_pairwise_bilateral(sx, sy, sr, sg, sb, image, Potts(w))
NTYPES = ("no", "before", "after", "symmetric")
IID_SEEDS = (8, 9, 10)
IID_TOL = 2e-3  # fp32 marginals against float64 on i.i.d. inputs: the CPU engines reach ~1e-3 there


def iid_case(seed: int):
    """A pixel-noise image and i.i.d. Dirichlet probabilities: each pixel's
    neighbours pull towards near-ties that fp32 rounding decides."""
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    probs = rng.dirichlet(np.ones(M), size=H * W).astype(np.float32)
    return image, probs


def coherent_case(seed: int):
    """A two-colour image with probabilities that favour one class per
    region, as a network's do."""
    rng = np.random.default_rng(seed)
    image = np.zeros((H, W, 3), np.int32)
    image[:, : W // 2] = [200, 60, 50]
    image[:, W // 2:] = [30, 180, 190]
    image = np.clip(image + rng.integers(-20, 20, image.shape), 0, 255).astype(np.uint8)
    prefer = np.zeros((H, W, M))
    prefer[:, : W // 2, 1] = prefer[:, W // 2:, 3] = 1.0
    probs = (0.65 * rng.dirichlet(np.ones(M), size=(H, W)) + 0.35 * prefer).reshape(H * W, M).astype(np.float32)
    return image, probs


def set_up(crf, potts, image, probs, ntype: str):
    """The unaries and both pairwise terms on a ``DenseCRF(W, H, M)`` of
    either package; ``potts`` is its ``PottsCompatibility``."""
    crf.set_unary_energy(-np.log(probs).ravel())
    sx, sy, w = SPATIAL
    crf.add_pairwise_gaussian(sx, sy, potts(w), normalization=ntype)
    *scales, w = BILATERAL
    crf.add_pairwise_bilateral(*scales, image, potts(w), normalization=ntype)
    return crf


def mean_field_f64(image, probs, ntype: str, n_iters: int = 10) -> np.ndarray:
    """(N, M) marginals of :func:`set_up`'s CRF in float64: the exact
    Gaussian kernels, the reference's normalisations and Potts updates."""
    ys, xs = np.mgrid[0:H, 0:W]
    pos = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float64)
    colour = image.reshape(-1, 3).astype(np.float64)
    feats = [(pos / SPATIAL[:2], SPATIAL[2]),
             (np.concatenate([pos / BILATERAL[:2], colour / BILATERAL[2:5]], -1), BILATERAL[5])]
    unary = np.log(probs.astype(np.float64))

    def softmax(x):
        e = np.exp(x - x.max(1, keepdims=True))
        return e / e.sum(1, keepdims=True)

    terms = []
    for f, w in feats:
        k = np.exp(-0.5 * ((f[:, None, :] - f[None, :, :]) ** 2).sum(-1))
        deg = k.sum(1)[:, None] + 1e-20
        pre = {"no": 1.0, "before": 1.0 / deg, "after": 1.0, "symmetric": deg ** -0.5}[ntype]
        post = {"no": 1.0, "before": 1.0, "after": 1.0 / deg, "symmetric": deg ** -0.5}[ntype]
        terms.append((k, pre, post, w))
    q = softmax(unary)
    for _ in range(n_iters):
        q = softmax(unary + sum(w * post * (k @ (pre * q)) for k, pre, post, w in terms))
    return q
