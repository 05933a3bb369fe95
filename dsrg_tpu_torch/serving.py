"""Model export and serving (``dsrg_tpu/serving.py``).

The reference deploys a Caffe ``deploy.prototxt`` and a ``.caffemodel``
loaded into a fresh process.  Here, as in the JAX package, the deploy
forward (optionally with the floored softmax) or the whole served pipeline
(``Predictor._build_device_ms``: per-image resizes to each scale, one
forward per scale, score fusion, floored softmax, the masked mmgrid CRF,
argmax) is traced once with ``torch.export`` and saved with
``torch.export.save``, weights embedded, as one artifact.

Two differences from the JAX package's artifact, which needs no framework
code at load time (``jax.export`` writes self-contained StableHLO):

* ``dsrg_tpu_torch`` must be importable where an artifact is loaded: the
  pipeline calls the CRF's splat and slice as the custom ops
  ``dsrg_tpu_torch::mmgrid_splat`` / ``::mmgrid_slice``, which importing
  this module registers before ``torch.export.load`` reads the program;
* on the card those ops launch the port's CUDA kernels, whose shared
  libraries ``nvcc`` builds into ``dsrg_tpu_torch/_build/`` at the first
  launch (seconds; the CUDA toolkit must be installed there).

The exporters take ``model`` as an ``nn.Module`` that already holds its
weights (``Predictor`` / ``tools._infer_common.load_predictor`` load them
so), not the JAX package's separate ``variables``.  An artifact runs on the
device it was exported on: the card unless the exporter was given
``device="cpu"``.  The loaders run it in full fp32 (TF32 off inside the
call), as the JAX package and the port's ``Predictor`` compute.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from dsrg_tpu_torch._device import full_fp32, resolve_device
from dsrg_tpu_torch.inference import Predictor, pack_canvas
from dsrg_tpu_torch.ops.crf import mmgrid_kernels  # noqa: F401  (registers the custom ops)
from dsrg_tpu_torch.ops.softmax import floored_softmax


class _Program(torch.nn.Module):
    """``fn`` as a module that holds ``model``, so that export embeds its
    parameters and buffers."""

    def __init__(self, model: torch.nn.Module, fn):
        super().__init__()
        self.model = model
        self._fn = fn

    def forward(self, *args):
        return self._fn(*args)


def _export(model: torch.nn.Module, fn, example: tuple, path: str) -> str:
    model.eval()
    with torch.no_grad():
        exported = torch.export.export(_Program(model, fn), example, strict=False)
    torch.export.save(exported, path)
    return path


def _load(path: str):
    """(callable program, its inputs' fake tensors) of an artifact."""
    exported = torch.export.load(path)
    inputs = [n.meta["val"] for n in exported.graph.nodes
              if n.op == "placeholder" and n.name in exported.graph_signature.user_inputs]
    return exported.module(), inputs


def make_deploy_fn(model: torch.nn.Module, input_shape: Tuple[int, int, int, int],
                   with_softmax: bool = True):
    """(fn, example): ``fn`` maps (B, H, W, 3) float32 images to scores or
    floored-softmax probabilities; ``example`` is a zero input of
    ``input_shape`` on the model's device."""

    def fn(images):
        scores = model(images)
        return floored_softmax(scores) if with_softmax else scores

    dev = next(model.parameters()).device
    return fn, torch.zeros(tuple(input_shape), dtype=torch.float32, device=dev)


def export_deploy(model: torch.nn.Module, path: str,
                  input_shape: Tuple[int, int, int, int] = (1, 321, 321, 3),
                  with_softmax: bool = True, device=None) -> str:
    """Export the deploy forward at ``input_shape`` to ``path``; the model
    moves to ``device`` (the card by default)."""
    model.to(resolve_device(device))
    fn, example = make_deploy_fn(model, input_shape, with_softmax)
    return _export(model, fn, (example,), path)


class ServingModel:
    """An exported deploy artifact: (B, H, W, 3) images in, numpy out."""

    def __init__(self, path: str):
        self._program, (spec,) = _load(path)
        self.input_shape = tuple(int(d) for d in spec.shape)
        self.device = spec.device

    def __call__(self, images: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(images, np.float32), device=self.device)
        with torch.no_grad(), full_fp32():
            return self._program(x).cpu().numpy()


def export_pipeline(model: torch.nn.Module, path: str, canvas_hw: Tuple[int, int] = (512, 512),
                    batch: int = 8, sizes: Optional[Tuple[int, ...]] = (241, 321, 401),
                    scales: Optional[Tuple[float, ...]] = None, smooth: bool = True,
                    num_classes: int = 21, device=None) -> str:
    """Export the whole multi-scale pipeline, CRF included, as one artifact.

    Its program is ``Predictor._build_device_ms``'s, static in batch and
    canvas: a (batch, H, W, 3) uint8 RGB canvas and (batch, 2) float32 true
    sizes in, (batch, H, W) uint8 masks out (``test-ms.py:84-111``'s
    predict_mask for every image).  ``scales`` (test-ms-f) is taken when
    ``sizes`` is None, as in the JAX package.
    """
    pred = Predictor(model, num_classes=num_classes, device=device)
    ph, pw = int(canvas_hw[0]), int(canvas_hw[1])
    fn = pred._build_device_ms(ph, pw, tuple(sizes) if sizes is not None else None,
                               tuple(scales) if scales is not None else None, bool(smooth))
    example = (torch.zeros((batch, ph, pw, 3), dtype=torch.uint8, device=pred.device),
               torch.ones((batch, 2), dtype=torch.float32, device=pred.device))
    return _export(pred.model, fn, example, path)


class ServingPipeline:
    """An exported pipeline artifact: a list of RGB uint8 arrays in, a list
    of (h, w) uint8 masks out.  Packs each chunk of the exported batch into
    the canvas (the last chunk padded with unit-size slots whose outputs are
    dropped) and crops the masks."""

    def __init__(self, path: str):
        self._program, (canvas, _) = _load(path)
        self.batch, self.ph, self.pw, _ = (int(d) for d in canvas.shape)
        self.device = canvas.device

    def __call__(self, images_rgb) -> list:
        out = []
        images_rgb = list(images_rgb)
        for c0 in range(0, len(images_rgb), self.batch):
            chunk = images_rgb[c0: c0 + self.batch]
            canvas, dims = pack_canvas(chunk, self.batch, self.ph, self.pw)
            with torch.no_grad(), full_fp32():
                q = self._program(torch.from_numpy(canvas).to(self.device),
                                  torch.from_numpy(dims).to(self.device)).cpu().numpy()
            out.extend(q[i, : im.shape[0], : im.shape[1]] for i, im in enumerate(chunk))
        return out
