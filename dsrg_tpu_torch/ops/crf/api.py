"""The dense-CRF API: the public ``CRF()`` and the train step's refinement
(``dsrg_tpu/ops/crf/api.py``).

:func:`CRF` mirrors the reference's ``krahenbuhl2013.CRF``: one image, the
parameterization ``(10, 80/sf, 80/sf, cf, cf, cf, 3, 3/sf, 3/sf)``, and an
engine rule: the exact N^2 engine up to ``EXACT_MAX_PIXELS`` pixels, the
matmul bilateral grid (``mean_field_mmgrid``, the splat / slice kernels)
above.  The pseudo ground truth of a VOC image (500x375) takes the grid.
A caller may name any of the five engines: ``exact``, ``mmgrid``, ``grid``
(dense bilateral grid), ``lattice`` (compact lattice) or ``native`` (the
exact mean field of ``native/crf_cpu.cpp`` on the host).

:class:`DenseCRF` mirrors the reference's Cython wrapper class
(``CRF/krahenbuhl2013/wrapper.pyx:20-60``) and ``densecrf.h``'s step and
energy surface, on the exact engine's ``mean_field_general``: costs go in
flat and pixel-major, marginals and labels come out as numpy, the work runs
on ``device`` (the card by default).  The label compatibilities and unary
energies are the reference's classes of the same names.

The rest are the batched equivalents of the reference's Caffe ``CRFLayer``
and ``DSRGLayer.refinement`` (``pylayers.py:54-92,310-331``): shrink the
mean-subtracted images to the score resolution, run the exact dense CRF per
image with the probabilities as unaries, clamp and renormalise.  The
``CRFLayer``'s backward is the reference's heuristic ``(1 - Q) * g``,
reproduced on purpose rather than replaced by the CRF's Jacobian
(:func:`crf_log_refine`, :func:`crf_refine_with_log`).
"""

from __future__ import annotations

import logging
from typing import List

import numpy as np
import torch

from dsrg_tpu_torch._device import full_fp32, resolve_device
from dsrg_tpu_torch.data.voc import BGR_MEAN
from dsrg_tpu_torch.ops.crf import exact
from dsrg_tpu_torch.ops.crf.exact import mean_field_exact
from dsrg_tpu_torch.ops.crf.features import bilateral_features, spatial_features
from dsrg_tpu_torch.ops.crf.grid import mean_field_grid
from dsrg_tpu_torch.ops.crf.lattice import mean_field_lattice
from dsrg_tpu_torch.ops.crf.mmgrid import mean_field_mmgrid
from dsrg_tpu_torch.ops.interp import zoom_bilinear
from dsrg_tpu_torch.ops.softmax import MIN_PROB
from dsrg_tpu_torch.utils.profiling import span

COLOR_FACTOR = 13.0  # the reference CRF's colour scale (pylayers.py:82,335)
# above this pixel count "auto" leaves the exact engine for the grid: the
# exact engine's two (N, N) fp32 kernel matrices are 268 MB each at 8192 px
EXACT_MAX_PIXELS = 8192
ENGINES = ("auto", "exact", "mmgrid", "grid", "lattice", "native")

_log = logging.getLogger("dsrg_tpu_torch.crf")
_logged_engines: set = set()


def prepare_crf_images(images: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Mean-subtracted (B, H, W, 3) BGR images -> (B, out_h, out_w, 3) guides:
    bilinear zoom, re-add the BGR mean, round (``pylayers.py:70-75``)."""
    small = zoom_bilinear(images.float(), out_h, out_w)
    return torch.round(small + torch.as_tensor(BGR_MEAN, device=small.device))


def _crf_core(guides: torch.Tensor, unary: torch.Tensor, maxiter: int, scale_factor: float,
              color_factor: float, fast: bool = False) -> torch.Tensor:
    """The reference ``CRF()`` call, batched: guides (B, h, w, 3), unary
    (B, h, w, M) -> (B, h, w, M) marginals."""
    b, h, w, m = unary.shape
    img = torch.round(guides).float()
    bila = bilateral_features(img, 80.0 / scale_factor, 80.0 / scale_factor,
                              color_factor, color_factor, color_factor)
    spat = spatial_features(h, w, 3.0 / scale_factor, 3.0 / scale_factor, device=unary.device)
    q = mean_field_exact(unary.reshape(b, h * w, m).float(), (bila, spat), (10.0, 3.0),
                         n_iters=maxiter, fast=fast)
    return q.reshape(b, h, w, m)


def resolve_engine(engine: str, h: int, w: int) -> str:
    """The engine ``CRF(engine=...)`` runs for an (h, w) image: the named
    one, or for "auto" "exact" up to ``EXACT_MAX_PIXELS`` pixels and
    "mmgrid" above.  Raises for an unknown name; it never substitutes one
    engine for another."""
    if engine not in ENGINES:
        raise ValueError(f"unknown CRF engine {engine!r}; expected one of {'/'.join(ENGINES)}")
    if engine != "auto":
        return engine
    resolved = "exact" if h * w <= EXACT_MAX_PIXELS else "mmgrid"
    if (resolved, h, w) not in _logged_engines:
        # an approximate engine can move masks a little: say once per
        # geometry which one "auto" took, so a parity run knows to ask for "exact"
        _logged_engines.add((resolved, h, w))
        _log.info("CRF engine=auto resolved to '%s' for %dx%d (%d px; exact<=%d px)",
                  resolved, h, w, h * w, EXACT_MAX_PIXELS)
    return resolved


def CRF(image, unary, maxiter: int = 10, scale_factor: float = 1.0,
        color_factor: float = 13, engine: str = "auto", device=None) -> torch.Tensor:
    """Fully connected CRF inference with Gaussian potentials, as the
    reference's ``CRF()``: ``image`` (H, W, 3) in [0, 256) (uint8 or float,
    rounded), ``unary`` (H, W, M) scores (probabilities or log-probabilities,
    as callers passed them to the reference).  Returns the (H, W, M)
    marginals as an f32 tensor on the unary's device.

    ``engine``: "exact" (N^2 kernel matrices), "mmgrid" (matmul bilateral
    grid on the splat / slice kernels), "grid" (dense bilateral grid),
    "lattice" (compact lattice), "native" (the host's C++ exact engine,
    whatever the unary's device; its library builds at first use and a
    failed build raises) or "auto" (exact up to ``EXACT_MAX_PIXELS``
    pixels, mmgrid above).  ``device``: where numpy inputs go (the card by
    default); a tensor ``unary`` stays on its device.
    """
    if not isinstance(unary, torch.Tensor):
        unary = torch.as_tensor(np.asarray(unary), device=resolve_device(device))
    image = torch.as_tensor(image if isinstance(image, torch.Tensor) else np.array(image),
                            device=unary.device)
    h, w = unary.shape[:2]
    if tuple(image.shape) != (h, w, 3):
        raise ValueError(f"image {tuple(image.shape)} does not match unary {tuple(unary.shape)}")
    unary = unary.float()
    kwargs = dict(scale_factor=float(scale_factor), color_factor=float(color_factor))
    resolved = resolve_engine(engine, h, w)
    if resolved == "exact":
        return _crf_core(image[None].float(), unary[None], maxiter, float(scale_factor),
                         float(color_factor))[0]
    if resolved == "native":
        from dsrg_tpu_torch import native

        q = native.crf_cpu(image.float().cpu().numpy(), unary.cpu().numpy(), maxiter=maxiter, **kwargs)
        return torch.from_numpy(q).to(unary.device)
    engines = {"mmgrid": mean_field_mmgrid, "grid": mean_field_grid, "lattice": mean_field_lattice}
    return engines[resolved](unary, image, n_iters=maxiter, **kwargs)


class PottsCompatibility:
    """out = -w * Q (``labelcompatibility.cpp:45-47``)."""

    def __init__(self, w: float):
        self.w = float(w)

    def __call__(self, m: torch.Tensor) -> torch.Tensor:
        return -self.w * m


class DiagonalCompatibility:
    """out = Q * v per label (``labelcompatibility.cpp:66-69``; no negation)."""

    def __init__(self, v):
        self.v = torch.as_tensor(v, dtype=torch.float32)

    def __call__(self, m: torch.Tensor) -> torch.Tensor:
        return m * self.v.to(m.device)[None, :]


class MatrixCompatibility:
    """out = Q @ W.T with W symmetrised (``labelcompatibility.cpp:79-85``)."""

    def __init__(self, mat):
        mat = torch.as_tensor(mat, dtype=torch.float32)
        self.mat = 0.5 * (mat + mat.T)

    def __call__(self, m: torch.Tensor) -> torch.Tensor:
        with full_fp32():
            return m @ self.mat.to(m.device).T


class ConstUnaryEnergy:
    """A stored (M, N) cost matrix, class-major as the reference keeps it
    (``unary.cpp:42-47``)."""

    def __init__(self, unary_costs):
        self.unary = np.asarray(unary_costs, np.float32)

    def get(self) -> np.ndarray:
        return self.unary

    def parameters(self) -> np.ndarray:
        return np.zeros((0,), np.float32)

    def set_parameters(self, v) -> None:
        pass

    def gradient(self, b) -> np.ndarray:
        return np.zeros((0,), np.float32)


class LogisticUnaryEnergy:
    """A learnable unary ``U = L @ f`` over (F, N) features, with the
    reference's parameter layout (column-major) and ``gradient(b) = b @
    f.T`` (``unary.cpp:49-70``)."""

    def __init__(self, L, features):
        self.L = np.asarray(L, np.float32)
        self.f = np.asarray(features, np.float32)

    def get(self) -> np.ndarray:
        return self.L @ self.f

    def parameters(self) -> np.ndarray:
        return self.L.reshape(-1, order="F").copy()

    def set_parameters(self, v) -> None:
        self.L = np.asarray(v, np.float32).reshape(self.L.shape, order="F")

    def gradient(self, b) -> np.ndarray:
        return (np.asarray(b, np.float32) @ self.f.T).reshape(-1, order="F")


class DenseCRF:
    """The reference's ``DenseCRF`` wrapper class on the exact engine.

    Geometry (W, H, nlabels) as the reference's constructor takes it
    (``wrapper.pyx:23``); pixels in row-major order (y * W + x,
    ``densecrf.cpp:61-81``).  Inputs may be numpy or tensors; the unaries,
    features and kernels live on ``device`` (the card by default; ``"cpu"``
    for the CPU), and every method returns numpy where the reference does.
    The (N, N) kernel matrices are built at each call: 1.47 GB each at
    N = 19200 (160x120).
    """

    def __init__(self, W: int, H: int, nlabels: int, device=None):
        self.W, self.H, self.M = int(W), int(H), int(nlabels)
        self.N = self.W * self.H
        self.device = resolve_device(device)
        self._unary_cost = torch.zeros((self.N, self.M), dtype=torch.float32, device=self.device)
        self._feats: List[torch.Tensor] = []
        self._compats: List = []
        self._ntypes: List[str] = []

    def _tensor(self, x) -> torch.Tensor:
        x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x, np.float32))
        return x.to(self.device, torch.float32)

    # -- wrapper.pyx surface --------------------------------------------------
    def npixels(self) -> int:
        return self.N

    def nlabels(self) -> int:
        return self.M

    def set_unary_energy(self, unary_costs) -> None:
        """Flat (N * M) costs, pixel-major (``densecrf_wrapper.cpp:32-37``)."""
        self._unary_cost = self._tensor(unary_costs).reshape(self.N, self.M)

    def set_unary(self, energy) -> None:
        """``setUnaryEnergy(UnaryEnergy*)`` (``densecrf.h:60-66``): a
        ``ConstUnaryEnergy`` / ``LogisticUnaryEnergy``, class-major (M, N)."""
        self._unary_cost = self._tensor(energy.get()).T.contiguous()

    def add_pairwise_energy(self, w1, theta_alpha_1, theta_alpha_2, theta_betta_1, theta_betta_2,
                            theta_betta_3, w2, theta_gamma_1, theta_gamma_2, im) -> None:
        """Gaussian (theta_gamma, Potts w2) + bilateral (theta_alpha /
        theta_betta, Potts w1); ``im`` the flat (H*W*3) byte image
        (``densecrf_wrapper.cpp:18-30``)."""
        img = self._tensor(im).reshape(self.H, self.W, 3)
        self.add_pairwise_gaussian(theta_gamma_1, theta_gamma_2, PottsCompatibility(w2))
        self.add_pairwise_bilateral(theta_alpha_1, theta_alpha_2, theta_betta_1, theta_betta_2,
                                    theta_betta_3, img, PottsCompatibility(w1))

    def inference(self, n_iters: int = 10) -> np.ndarray:
        """Flat (N * M) float32 marginals."""
        q = exact.mean_field_general(-self._unary_cost, self._feats, self._compats,
                                     n_iters=n_iters, norm_types=self._ntypes)
        return q.cpu().numpy().astype(np.float32).ravel()

    def map(self, n_iters: int = 10) -> np.ndarray:
        q = self.inference(n_iters).reshape(self.N, self.M)
        return np.argmax(q, axis=1).astype(np.int32)

    # -- densecrf.h's step and energy surface (densecrf.cpp:141-235) -----------
    def _apply_pairwise(self, k: int, q: torch.Tensor) -> torch.Tensor:
        """compat_k(filter_k(q)) of (N, M) q: one pairwise term's message."""
        with full_fp32():
            kernel = exact.gaussian_kernel_matrix(self._feats[k].float())
        pre, post = exact.kernel_norm_weights(kernel, self._ntypes[k])
        return self._compats[k](exact.normalized_filter(kernel, q, pre, post))

    def unary_energy(self, labels) -> np.ndarray:
        """Per-pixel unary cost of a labelling (``densecrf.cpp:141-153``)."""
        lab = np.asarray(labels, np.int64).reshape(self.N)
        valid = (lab >= 0) & (lab < self.M)
        u = self._unary_cost.cpu().numpy()
        out = np.zeros(self.N, np.float32)
        out[valid] = u[np.arange(self.N)[valid], lab[valid]]
        return out

    def pairwise_energy(self, labels, term: int = -1) -> np.ndarray:
        """Per-pixel pairwise energy of a labelling, of one term or all
        (``densecrf.cpp:154-177``)."""
        if term == -1:
            total = np.zeros(self.N, np.float32)
            for k in range(len(self._feats)):
                total += self.pairwise_energy(labels, k)
            return total
        lab = np.asarray(labels, np.int64).reshape(self.N)
        valid = (lab >= 0) & (lab < self.M)
        q = np.zeros((self.N, self.M), np.float32)
        q[np.arange(self.N)[valid], lab[valid]] = 1.0
        msg = self._apply_pairwise(term, self._tensor(q)).cpu().numpy()
        out = np.zeros(self.N, np.float32)
        out[valid] = -0.5 * msg[np.arange(self.N)[valid], lab[valid]]
        return out

    def start_inference(self) -> np.ndarray:
        """(N, M) initial marginals from the unaries (``densecrf.cpp:178-186``)."""
        return exact._softmax_cols(-self._unary_cost).cpu().numpy()

    def step_inference(self, q) -> np.ndarray:
        """One mean-field update of (N, M) marginals (``densecrf.cpp:187-201``)."""
        qt = self._tensor(q).reshape(self.N, self.M)
        tmp = -self._unary_cost
        for k in range(len(self._feats)):
            tmp = tmp - self._apply_pairwise(k, qt)
        return exact._softmax_cols(tmp).cpu().numpy()

    def kl_divergence(self, q) -> float:
        """The KL diagnostic of marginals (``densecrf.cpp:214-235``), summed
        in float64 on the host from float32 messages."""
        qn = np.asarray(q, np.float64).reshape(self.N, self.M)
        kl = float(np.sum(qn * np.log(np.maximum(qn, 1e-20))))
        kl += float(np.sum(self._unary_cost.cpu().numpy().astype(np.float64) * qn))
        for k in range(len(self._feats)):
            msg = self._apply_pairwise(k, self._tensor(qn.astype(np.float32))).cpu().numpy()
            kl += float(np.sum(qn * msg.astype(np.float64)))
        return kl

    # -- densecrf.h's extended surface -----------------------------------------
    def add_pairwise_gaussian(self, sx, sy, compat, normalization: str = "symmetric") -> None:
        """``normalization``: the reference's ``NormalizationType``
        (``pairwise.h:31-42``), "no" | "before" | "after" | "symmetric"."""
        self._feats.append(spatial_features(self.H, self.W, float(sx), float(sy), device=self.device))
        self._compats.append(compat)
        self._ntypes.append(normalization)

    def add_pairwise_bilateral(self, sx, sy, sr, sg, sb, image, compat,
                               normalization: str = "symmetric") -> None:
        img = self._tensor(image).reshape(self.H, self.W, 3)
        self._feats.append(bilateral_features(img, float(sx), float(sy), float(sr), float(sg), float(sb)))
        self._compats.append(compat)
        self._ntypes.append(normalization)


@span("dsrg.crf")
def crf_refine_probs(probs: torch.Tensor, images: torch.Tensor, scale_factor: float = 12.0,
                     maxiter: int = 10, min_prob: float = MIN_PROB,
                     fast: bool = False) -> torch.Tensor:
    """Refine (B, h, w, M) probabilities with the dense CRF guided by the
    mean-subtracted (B, H, W, 3) images: clamp to ``min_prob``, mean field,
    clamp the marginals and renormalise.  ``torch.maximum`` splits the
    gradient at ties as ``jnp.maximum`` does, which matters for
    :func:`crf_refine_with_log_truegrad`: after the CRFLayer's clamp many
    probabilities equal ``min_prob`` exactly."""
    b, h, w, _ = probs.shape
    floor = torch.tensor(min_prob, dtype=probs.dtype, device=probs.device)
    guides = prepare_crf_images(images, h, w)
    q = _crf_core(guides, torch.maximum(probs, floor), maxiter, scale_factor, COLOR_FACTOR,
                  fast=fast)
    q = torch.maximum(q, floor)
    return q / q.sum(-1, keepdim=True)


def crf_log_refine(probs: torch.Tensor, images: torch.Tensor) -> torch.Tensor:
    """The ``CRFLayer`` forward: ``log`` of :func:`crf_refine_probs` at its
    defaults.  Its backward is the reference's heuristic ``(1 - Q) * g``
    (``pylayers.py:90-92``), not the CRF's Jacobian, and no gradient
    reaches the images (``propagate_down: 0``, ``train-s.prototxt:769``)."""
    return crf_refine_with_log(probs, images)[0]


class _RefineWithLog(torch.autograd.Function):
    @staticmethod
    def forward(ctx, probs, images, scale_factor, maxiter, fast):
        q = crf_refine_probs(probs, images, scale_factor=scale_factor, maxiter=maxiter, fast=fast)
        ctx.save_for_backward(q)
        ctx.mark_non_differentiable(q)
        return torch.log(q), q

    @staticmethod
    @span("dsrg.crf")
    def backward(ctx, g_log, _g_q):
        (q,) = ctx.saved_tensors
        return (1.0 - q) * g_log, None, None, None, None


def crf_refine_with_log(probs: torch.Tensor, images: torch.Tensor, scale_factor: float = 12.0,
                        maxiter: int = 10, fast: bool = False):
    """One CRF evaluation returning ``(log Q, Q)`` for the train step.

    ``log Q`` carries the CRFLayer's heuristic backward ``(1 - Q) * g`` to
    ``probs``; no gradient reaches the images (``propagate_down: 0``) and
    ``Q``, the region grower's input, is detached.
    """
    return _RefineWithLog.apply(probs, images, scale_factor, maxiter, fast)


def crf_refine_with_log_truegrad(probs: torch.Tensor, images: torch.Tensor,
                                 scale_factor: float = 12.0, maxiter: int = 10,
                                 fast: bool = False):
    """``crf_refine_with_log`` with autograd through the mean-field loop
    (CRF-as-RNN) instead of the heuristic backward; ``Q`` stays detached."""
    q = crf_refine_probs(probs, images, scale_factor=scale_factor, maxiter=maxiter, fast=fast)
    return torch.log(q), q.detach()
