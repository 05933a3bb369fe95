"""Multi-scale inference with dense-CRF smoothing (``dsrg_tpu/inference.py``).

Two pipelines, as in the JAX package, after the reference's ``test-ms.py`` /
``test-ms-f.py``: per scale, resize the image, forward to the fc8-SEC score
map, resize the scores back and sum; softmax with a 1e-5 floor; optionally
the dense CRF (10 mean-field iterations at scale factor 1); argmax.

* The host-zoom paths (``predict_probs``, ``predict_probs_batch``,
  ``predict_masks``, ``predict_mask``) keep the reference's host work as the
  JAX package does it: ``scipy.ndimage.zoom(order=1)`` for the resizes and
  a numpy softmax; the forward and the CRF run on ``self.device``.
  ``predict_mask(restrict_labels=...)`` makes the recipe's pseudo ground
  truth (``tools/generate_train_gt.py``).
* The device pipeline (``predict_masks_device`` / ``iter_masks_device``)
  resizes on the card (per-image align-corners zoom matrices) and runs the
  masked matmul-grid CRF on the shared padded canvas; the host ships one
  uint8 canvas per chunk and receives one uint8 mask per image.  With a
  ``mesh`` the chunk pads to a multiple of the mesh's devices and each
  device runs its rows on its own replica of the model.
"""

from __future__ import annotations

import contextlib
import copy
import inspect
import itertools
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch
from scipy.ndimage import zoom as ndzoom

from dsrg_tpu_torch._device import resolve_device
from dsrg_tpu_torch.data.voc import BGR_MEAN
from dsrg_tpu_torch.ops.crf.api import CRF
from dsrg_tpu_torch.ops.crf.mmgrid import mean_field_mmgrid
from dsrg_tpu_torch.utils.profiling import span

EPS = 1e-5  # probability floor (test-ms.py:102-103)


def pack_canvas(images_rgb, batch: int, ph: int, pw: int):
    """(canvas, dims): uint8 RGB images packed into a zero (batch, ph, pw, 3)
    canvas with (batch, 2) true sizes.  Pad slots get unit dims, which keep
    the align-corners map finite; their outputs are dropped."""
    canvas = np.zeros((batch, ph, pw, 3), np.uint8)
    dims = np.ones((batch, 2), np.float32)
    for i, im in enumerate(images_rgb):
        h, w = im.shape[:2]
        if h > ph or w > pw:
            raise ValueError(f"image {h}x{w} exceeds canvas {ph}x{pw}")
        canvas[i, :h, :w] = np.asarray(im, np.uint8)
        dims[i] = (h, w)
    return canvas, dims


def _dyn_interp_rows(out_cap: int, in_cap: int, in_valid: torch.Tensor,
                     out_valid: torch.Tensor) -> torch.Tensor:
    """(B, out_cap, in_cap) align-corners interpolation rows for per-image
    valid lengths (B,) on fixed-width canvases: out ``i`` -> in
    ``i * (in_valid-1) / (out_valid-1)``.  Rows at ``i >= out_valid`` clamp
    to the last valid input sample; callers mask or crop them."""
    iv = in_valid.to(torch.float32)[:, None]
    ov = out_valid.to(torch.float32)[:, None]
    i = torch.arange(out_cap, dtype=torch.float32, device=iv.device)[None, :]
    scale = torch.where(ov > 1.0, (iv - 1.0) / torch.clamp(ov - 1.0, min=1.0),
                        torch.zeros_like(ov))
    x = torch.minimum(i * scale, torch.clamp(iv - 1.0, min=0.0))
    lo = torch.minimum(torch.clamp(torch.floor(x), min=0.0), torch.clamp(iv - 2.0, min=0.0))
    frac = x - lo
    lo_i = lo.to(torch.int64)[..., None]
    cols = torch.arange(in_cap, device=iv.device)
    return ((cols == lo_i) * (1.0 - frac)[..., None]
            + (cols == lo_i + 1) * frac[..., None])


def _bucket(v: int, b: int) -> int:
    return -(-v // b) * b


def _softmax_floor(scores: np.ndarray) -> np.ndarray:
    """The reference's numpy softmax over the class axis with the 1e-5 floor."""
    e = np.exp(scores - scores.max(-1, keepdims=True))
    return np.maximum(e / e.sum(-1, keepdims=True), EPS)


class Predictor:
    def __init__(self, model: torch.nn.Module, params=None, num_classes: int = 21,
                 bucket: int = 1, device=None, mesh=None):
        """``model``: either family (``DeepLabLargeFOV``, or
        ``ResNet101DeepLab``, whose frozen BN statistics are buffers of the
        module, so one state_dict carries all its variables, as the JAX
        package's variables dict does).  ``params``: optional state_dict
        (torch tensors or numpy arrays) loaded into ``model``.  ``bucket`` > 1 pads the host-zoom paths'
        forward inputs up to 8k+1 shape buckets (masked, so exact) instead
        of forwarding each image at its own shape.  ``device`` defaults to
        the card and raises where CUDA is absent; pass ``"cpu"`` to run the
        plain versions.  ``mesh``: a ``parallel.Mesh``; the device pipeline
        then splits each chunk over its devices (this process's), each with
        a replica of the model (per-image work needs no collective), and
        ``device`` is the mesh's first."""
        self.mesh = mesh
        self.device = mesh.devices[0] if mesh is not None else resolve_device(device)
        if params is not None:
            model.load_state_dict({k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
                                   for k, v in params.items()})
        self.model = model.to(self.device).eval()
        # one model per distinct device of the mesh, the given one on the first
        self._replicas = {self.device: self.model}
        for dev in (mesh.devices if mesh is not None else ()):
            if dev not in self._replicas:
                self._replicas[dev] = copy.deepcopy(self.model).to(dev)
        self.num_classes = num_classes
        self.bucket = max(int(bucket), 1)
        self._pool = None  # the host zooms' thread pool, made at first use
        self._chunk_ids = itertools.count()  # device-pipeline chunks, the spans' shared ids
        # a model that takes per-image valid extents forwards a padded canvas
        # exactly as the image alone (models/masking.py)
        self._exact_canvas = "valid_hw" in inspect.signature(type(model).forward).parameters

    @property
    def exact_canvas(self) -> bool:
        """True when the model takes ``valid_hw``: forwards on a shared
        padded canvas then equal per-image forwards."""
        return self._exact_canvas

    def _pad_size(self, s: int) -> int:
        if self.bucket == 1:
            return s
        b = self.bucket
        return ((s + b - 1) // b) * b + 1  # stride-8-friendly 8k+1 shapes

    def _zoom_pool(self) -> ThreadPoolExecutor:
        """One thread pool for the host zooms, shared by every call (scipy's
        zoom releases the interpreter lock)."""
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=8)
        return self._pool

    def close(self) -> None:
        """Shut the host zooms' thread pool down, if one was made."""
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    # -- host-zoom paths -------------------------------------------------------

    def _forward(self, x: np.ndarray, dims: Optional[np.ndarray]) -> np.ndarray:
        """Eval forward of an (N, H, W, 3) f32 canvas on the device, masked
        to the (N, 2) valid extents ``dims`` when given (callers give them
        only to a model that takes ``valid_hw``)."""
        with torch.inference_mode():
            xt = torch.from_numpy(x).to(self.device)
            if dims is None:
                return self.model(xt).cpu().numpy()
            return self.model(xt, valid_hw=torch.from_numpy(dims).to(self.device)).cpu().numpy()

    def scores_at_size(self, image_bgr: np.ndarray) -> np.ndarray:
        """Forward one (h, w, 3) mean-subtracted BGR image -> (h', w', M) scores."""
        h, w = image_bgr.shape[:2]
        ph, pw = self._pad_size(h), self._pad_size(w)
        x = np.zeros((1, ph, pw, 3), np.float32)
        x[0, :h, :w] = image_bgr
        masked = (ph, pw) != (h, w) and self._exact_canvas
        scores = self._forward(x, np.asarray([[h, w]], np.float32) if masked else None)[0]
        return scores[: (h - 1) // 8 + 1, : (w - 1) // 8 + 1]

    def predict_probs(self, image_rgb: np.ndarray, sizes: Optional[Sequence[int]] = None,
                      scales: Optional[Sequence[float]] = None) -> np.ndarray:
        """Multi-scale score averaging -> (H, W, M) floored softmax probabilities.

        ``sizes``: absolute square sizes (``test-ms.py`` uses [241, 321, 401]);
        ``scales``: relative zoom factors (``test-ms-f.py`` uses [0.75, 1,
        1.25]); neither means scale 1.  Not both.
        """
        if sizes is not None and scales is not None:
            raise ValueError("pass exactly one of sizes/scales")
        im = np.asarray(image_rgb, np.float32)
        d1, d2 = float(im.shape[0]), float(im.shape[1])
        bgr = im[:, :, ::-1] - BGR_MEAN
        if sizes is not None:
            zooms = [(s / d1, s / d2) for s in sizes]
        else:
            zooms = [(s, s) for s in (scales or (1.0,))]
        scores_all = 0.0
        for zy, zx in zooms:
            scores = self.scores_at_size(ndzoom(bgr, (zy, zx, 1.0), order=1))
            scores_all = scores_all + ndzoom(
                scores, (d1 / scores.shape[0], d2 / scores.shape[1], 1.0), order=1)
        return _softmax_floor(scores_all)

    def _scores_batch(self, images_bgr: list) -> list:
        """Forward a list of (h_i, w_i, 3) mean-subtracted images as one
        batch on a shared canvas; returns per-image cropped score maps."""
        ph = self._pad_size(max(im.shape[0] for im in images_bgr))
        pw = self._pad_size(max(im.shape[1] for im in images_bgr))
        x = np.zeros((len(images_bgr), ph, pw, 3), np.float32)
        for i, im in enumerate(images_bgr):
            x[i, : im.shape[0], : im.shape[1]] = im
        dims = None
        if self._exact_canvas and any(im.shape[:2] != (ph, pw) for im in images_bgr):
            dims = np.asarray([im.shape[:2] for im in images_bgr], np.float32)
        scores = self._forward(x, dims)
        return [scores[i, : (im.shape[0] - 1) // 8 + 1, : (im.shape[1] - 1) // 8 + 1]
                for i, im in enumerate(images_bgr)]

    def predict_probs_batch(self, images_rgb: list, sizes: Optional[Sequence[int]] = None,
                            scales: Optional[Sequence[float]] = None) -> list:
        """``predict_probs`` for a list of RGB images, one forward per scale."""
        if sizes is not None and scales is not None:
            raise ValueError("pass exactly one of sizes/scales")
        n = len(images_rgb)
        dims = [(float(im.shape[0]), float(im.shape[1])) for im in images_rgb]
        bgrs = [np.asarray(im, np.float32)[:, :, ::-1] - BGR_MEAN for im in images_rgb]
        if sizes is not None:
            zoom_sets = [[(s / d1, s / d2) for (d1, d2) in dims] for s in sizes]
        else:
            zoom_sets = [[(s, s)] * n for s in (scales or (1.0,))]

        pool = self._zoom_pool()
        scores_all = [0.0] * n
        for per_image_zoom in zoom_sets:
            scaled = list(pool.map(lambda iz: ndzoom(bgrs[iz[0]], (*iz[1], 1.0), order=1),
                                   enumerate(per_image_zoom)))

            def up(i_sc):
                i, sc = i_sc
                return ndzoom(sc, (dims[i][0] / sc.shape[0], dims[i][1] / sc.shape[1], 1.0), order=1)

            for i, sc in enumerate(pool.map(up, enumerate(self._scores_batch(scaled)))):
                scores_all[i] = scores_all[i] + sc
        return [_softmax_floor(sa) for sa in scores_all]

    def predict_masks(self, images_rgb: list, sizes: Optional[Sequence[int]] = None,
                      scales: Optional[Sequence[float]] = None, smooth: bool = True,
                      canvas_bucket: int = 32, crf_batch: int = 4) -> list:
        """Batched ``predict_mask``: one forward per scale, then one masked
        matmul-grid CRF per ``crf_batch`` images on a shared padded canvas
        (masked splat and normalisation make it exact for each image's
        valid region)."""
        probs = self.predict_probs_batch(images_rgb, sizes=sizes, scales=scales)
        if not smooth:
            return [p.argmax(-1).astype(np.uint8) for p in probs]
        ph = _bucket(max(im.shape[0] for im in images_rgb), canvas_bucket)
        pw = _bucket(max(im.shape[1] for im in images_rgb), canvas_bucket)
        m = probs[0].shape[-1]
        out = []
        for c0 in range(0, len(images_rgb), crf_batch):
            idxs = range(c0, min(c0 + crf_batch, len(images_rgb)))
            # the last chunk is padded with empty masks: one canvas shape throughout
            img = np.zeros((crf_batch, ph, pw, 3), np.float32)
            unary = np.full((crf_batch, ph, pw, m), -20.0, np.float32)
            mask = np.zeros((crf_batch, ph, pw), np.float32)
            for j, i in enumerate(idxs):
                h, w = images_rgb[i].shape[:2]
                img[j, :h, :w] = images_rgb[i]
                unary[j, :h, :w] = np.log(probs[i])
                mask[j, :h, :w] = 1.0
            with torch.inference_mode():
                q = mean_field_mmgrid(*(torch.from_numpy(a).to(self.device) for a in (unary, img)),
                                      n_iters=10, valid_mask=torch.from_numpy(mask).to(self.device))
                labels = torch.argmax(q, -1).to(torch.uint8).cpu().numpy()
            for j, i in enumerate(idxs):
                h, w = images_rgb[i].shape[:2]
                out.append(labels[j, :h, :w])
        return out

    def predict_mask(self, image_rgb: np.ndarray, sizes: Optional[Sequence[int]] = None,
                     scales: Optional[Sequence[float]] = None, smooth: bool = True,
                     restrict_labels: Optional[Sequence[int]] = None,
                     crf_engine: str = "auto") -> np.ndarray:
        """The reference's predict_mask -> (H, W) uint8 label mask.

        ``restrict_labels``: optional class indices (background included) to
        restrict the argmax to, as ``generate_train_gt.py`` makes the pseudo
        ground truth; a tie goes to the label listed first.
        ``crf_engine``: the CRF's engine (``ops/crf/api.CRF``: auto, exact,
        mmgrid, grid, lattice or native); "auto" takes the exact engine up to
        8192 pixels and the matmul grid above (a VOC image takes the grid).
        """
        probs = self.predict_probs(image_rgb, sizes=sizes, scales=scales)
        with torch.inference_mode():
            if smooth:
                q = CRF(image_rgb, torch.from_numpy(np.log(probs)).to(self.device),
                        scale_factor=1.0, engine=crf_engine)
            else:  # nothing for the device to do: the argmax stays on the host
                q = torch.from_numpy(probs)
            if restrict_labels is None:
                return torch.argmax(q, -1).to(torch.uint8).cpu().numpy()
            subset = torch.as_tensor(np.asarray(restrict_labels), dtype=torch.int64, device=q.device)
            pick = torch.argmax(q.index_select(-1, subset), -1)
            return subset[pick].to(torch.uint8).cpu().numpy()

    # -- device pipeline -------------------------------------------------------

    def _build_device_ms(self, ph: int, pw: int, sizes: Optional[tuple],
                         scales: Optional[tuple], smooth: bool, model: Optional[torch.nn.Module] = None):
        """The whole chunk pipeline as one function of (canvas_u8, dims), on
        ``model`` (by default the predictor's)."""
        model = self.model if model is None else model
        # per multi-scale entry: static forward-canvas dims, the per-image
        # valid extent on it, and whether the forward must mask
        if sizes is not None:
            specs = [(int(s), int(s), (lambda s: lambda d: torch.full_like(d, s))(float(s)), False)
                     for s in sizes]
        else:
            def cap8(v):  # smallest 8k+1 canvas >= the scaled extent
                return int(-(-(int(np.ceil(v)) - 1) // 8) * 8 + 1)

            specs = [(cap8(s * ph), cap8(s * pw), (lambda s: lambda d: torch.round(s * d))(float(s)),
                      True) for s in scales]

        def fn(canvas_u8: torch.Tensor, dims: torch.Tensor) -> torch.Tensor:
            mean = torch.as_tensor(BGR_MEAN, device=canvas_u8.device)
            bgr = canvas_u8.flip(-1).to(torch.float32) - mean
            d1, d2 = dims[:, 0], dims[:, 1]
            scores_all = 0.0
            for fh, fw, valid, masked in specs:
                vh, vw = valid(d1), valid(d2)
                mh = _dyn_interp_rows(fh, ph, d1, vh)  # (B, fh, ph)
                mw = _dyn_interp_rows(fw, pw, d2, vw)
                xs = torch.einsum("bop,bpwc->bowc", mh, bgr)
                xs = torch.einsum("boq,bhqc->bhoc", mw, xs)  # (B, fh, fw, 3)
                valid_hw = torch.stack([vh, vw], -1) if masked else None
                sc = model(xs, valid_hw=valid_hw)
                so_h, so_w = sc.shape[1], sc.shape[2]
                sv_h = torch.floor((vh - 1.0) / 8.0) + 1.0
                sv_w = torch.floor((vw - 1.0) / 8.0) + 1.0
                uh = _dyn_interp_rows(ph, so_h, sv_h, d1)
                uw = _dyn_interp_rows(pw, so_w, sv_w, d2)
                up = torch.einsum("bph,bhwc->bpwc", uh, sc)
                scores_all = scores_all + torch.einsum("bqw,bpwc->bpqc", uw, up)
            probs = torch.clamp(torch.softmax(scores_all, -1), min=EPS)
            if smooth:
                ih = torch.arange(ph, dtype=torch.float32, device=dims.device)
                iw = torch.arange(pw, dtype=torch.float32, device=dims.device)
                mask = (ih[None, :, None] < d1[:, None, None]) & (iw[None, None, :] < d2[:, None, None])
                probs = mean_field_mmgrid(torch.log(probs), canvas_u8.to(torch.float32),
                                          n_iters=10, valid_mask=mask)
            return torch.argmax(probs, -1).to(torch.uint8)

        return fn

    def predict_masks_device(self, images_rgb: list, sizes: Optional[Sequence[int]] = None,
                             scales: Optional[Sequence[float]] = None, smooth: bool = True,
                             canvas_bucket: int = 32) -> list:
        """The test-ms (``sizes``) / test-ms-f (``scales``) pipeline for one
        chunk of RGB uint8 images -> list of (h, w) uint8 masks."""
        return self._finish_device_ms(
            self._submit_device_ms(images_rgb, sizes, scales, smooth, canvas_bucket))

    def _submit_device_ms(self, images_rgb, sizes, scales, smooth, canvas_bucket):
        """Enqueue one chunk on the card; returns (images, device masks,
        chunk id) without waiting, so a caller can enqueue the next chunk
        first.  The id is the chunk's sequence number, which the spans
        ``dsrg.serve.submit`` and ``dsrg.serve.finish`` of one chunk share."""
        if (sizes is None) == (scales is None):
            raise ValueError("exactly one of sizes/scales must be given")
        chunk_id = next(self._chunk_ids)
        with span("dsrg.serve.submit", chunk_id):
            ph = _bucket(max(im.shape[0] for im in images_rgb), canvas_bucket)
            pw = _bucket(max(im.shape[1] for im in images_rgb), canvas_bucket)
            devices = self.mesh.devices if self.mesh is not None else (self.device,)
            per = -(-len(images_rgb) // len(devices))  # rows per device, the chunk padded to a multiple
            canvas, dims = pack_canvas(images_rgb, per * len(devices), ph, pw)
            sizes_t = tuple(sizes) if sizes is not None else None
            scales_t = tuple(scales) if scales is not None else None
            masks = []
            for i, dev in enumerate(devices):
                fn = self._build_device_ms(ph, pw, sizes_t, scales_t, bool(smooth), self._replicas[dev])
                rows = slice(i * per, (i + 1) * per)
                with torch.inference_mode(), (torch.cuda.device(dev) if dev.type == "cuda"
                                              else contextlib.nullcontext()):
                    masks.append(fn(torch.from_numpy(canvas[rows]).to(dev),
                                    torch.from_numpy(dims[rows]).to(dev)))
        return images_rgb, masks, chunk_id

    @staticmethod
    def _finish_device_ms(submitted) -> list:
        images_rgb, dev_q, chunk_id = submitted
        with span("dsrg.serve.finish", chunk_id):
            q = np.concatenate([m.cpu().numpy() for m in dev_q])
            return [q[i, : im.shape[0], : im.shape[1]] for i, im in enumerate(images_rgb)]

    def iter_masks_device(self, images_iter, sizes: Optional[Sequence[int]] = None,
                          scales: Optional[Sequence[float]] = None, chunk: int = 8,
                          smooth: bool = True, canvas_bucket: int = 32, in_flight: int = 2):
        """Stream (image, mask) pairs with up to ``in_flight`` chunks enqueued
        on the card, so packing and uploading the next chunk overlaps the
        card's work on the previous one."""
        in_flight = max(1, int(in_flight))
        pending: deque = deque()
        batch: list = []

        def _submit(b):
            pending.append(self._submit_device_ms(b, sizes, scales, smooth, canvas_bucket))
            while len(pending) > in_flight:
                done = pending.popleft()
                yield from zip(done[0], self._finish_device_ms(done))

        for im in images_iter:
            batch.append(im)
            if len(batch) == chunk:
                yield from _submit(batch)
                batch = []
        if batch:
            yield from _submit(batch)
        while pending:
            done = pending.popleft()
            yield from zip(done[0], self._finish_device_ms(done))
