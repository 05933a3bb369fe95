"""Device-resident multi-scale inference with dense-CRF smoothing.

Counterpart of the device pipeline of ``dsrg_tpu/inference.py``
(``Predictor.predict_masks_device`` / ``iter_masks_device``), which mirrors
the reference's ``test-ms.py`` / ``test-ms-f.py``: per scale, resize the
image on the card (per-image align-corners zoom matrices), forward to the
fc8-SEC score map, resize scores back and sum; softmax with a 1e-5 floor;
the masked matmul-grid CRF (10 mean-field iterations at scale factor 1) on
the shared padded canvas; argmax to uint8 masks.  The host ships one uint8
canvas per chunk and receives one uint8 mask per image.
"""

from __future__ import annotations

from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from dsrg_tpu_torch._device import resolve_device
from dsrg_tpu_torch.data.voc import BGR_MEAN
from dsrg_tpu_torch.ops.crf.mmgrid import mean_field_mmgrid

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


class Predictor:
    def __init__(self, model: torch.nn.Module, params=None, num_classes: int = 21,
                 device=None):
        """``params``: optional state_dict (torch tensors or numpy arrays)
        loaded into ``model``.  ``device`` defaults to the card and raises
        where CUDA is absent; pass ``"cpu"`` to run the plain versions."""
        self.device = resolve_device(device)
        if params is not None:
            model.load_state_dict({k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
                                   for k, v in params.items()})
        self.model = model.to(self.device).eval()
        self.num_classes = num_classes

    def _build_device_ms(self, ph: int, pw: int, sizes: Optional[tuple],
                         scales: Optional[tuple], smooth: bool):
        """The whole chunk pipeline as one function of (canvas_u8, dims)."""
        model = self.model
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
        """Enqueue one chunk on the card; returns (images, device masks)
        without waiting, so a caller can enqueue the next chunk first."""
        if (sizes is None) == (scales is None):
            raise ValueError("exactly one of sizes/scales must be given")
        ph = _bucket(max(im.shape[0] for im in images_rgb), canvas_bucket)
        pw = _bucket(max(im.shape[1] for im in images_rgb), canvas_bucket)
        canvas, dims = pack_canvas(images_rgb, len(images_rgb), ph, pw)
        fn = self._build_device_ms(ph, pw, tuple(sizes) if sizes is not None else None,
                                   tuple(scales) if scales is not None else None, bool(smooth))
        with torch.inference_mode():
            masks = fn(torch.from_numpy(canvas).to(self.device),
                       torch.from_numpy(dims).to(self.device))
        return images_rgb, masks

    @staticmethod
    def _finish_device_ms(submitted) -> list:
        images_rgb, dev_q = submitted
        q = dev_q.cpu().numpy()
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
