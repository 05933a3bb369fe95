"""The stage-2 retrain step (``dsrg_tpu/train/stage2.py``): plain DeepLab
training on the pseudo ground truth that stage 1's predictor produced.

Reference ``train-f.prototxt``: batch 10 @ 321² crops, joint random mirror of
image and label map, VGG16-LargeFOV with dropout, ``Interp`` shrink x8 of
the label map, ``SoftmaxWithLoss`` with ignore label 255 normalised by the
valid pixel count, ``SegAccuracy``; Caffe SGD with the poly rate
(``solver-f.prototxt``).  The backward routes the max pools through the
``pool_bwd_h`` / ``pool_bwd_w`` kernels, 5 + 5 launches per step (1 + 1
for the ResNet-101 family, whose one max pool is ``pool1``).

As in stage 1 the step runs on the model's device, parity with the JAX
package needs TF32 off on the card, ``cfg.compute_dtype`` must be the
model's, a ResNet's frozen BN statistics travel as the module's buffers,
and ``axis_name`` (a ``parallel.Mesh``) makes the step data-parallel.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from dsrg_tpu_torch._device import resolve_device
from dsrg_tpu_torch.config import Stage2Config
from dsrg_tpu_torch.losses import softmax_cross_entropy_ignore_sums
from dsrg_tpu_torch.ops.interp import caffe_interp_shrink
from dsrg_tpu_torch.parallel.mesh import Mesh, all_reduce_sum
from dsrg_tpu_torch.train.optimizer import CaffeSGD, global_norm, lr_poly
from dsrg_tpu_torch.train.stage1 import _device_normalize, check_compute_dtype, init_params, rank_streams
from dsrg_tpu_torch.train.train_state import TrainState
from dsrg_tpu_torch.utils.profiling import span


def make_optimizer(model: nn.Module, cfg: Stage2Config) -> CaffeSGD:
    return CaffeSGD(dict(model.named_parameters()),
                    lr_poly(cfg.base_lr, cfg.power, cfg.max_iter),
                    momentum=cfg.momentum, weight_decay=cfg.weight_decay,
                    clip_gradients=cfg.clip_gradients)


def init_stage2(model: nn.Module, cfg: Stage2Config, device=None) -> TrainState:
    """Initialise ``model`` (seed ``cfg.seed``), move it to ``device`` (the
    card by default) and build its optimizer and random stream."""
    dev = resolve_device(device)
    init_params(model, cfg.seed)
    model.to(dev)
    generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    return TrainState(model, make_optimizer(model, cfg), generator)


def make_stage2_step(model: nn.Module, cfg: Stage2Config, optimizer: CaffeSGD,
                     generator: Optional[torch.Generator] = None,
                     axis_name: Optional[Mesh] = None) -> Callable[[dict], dict]:
    """Build ``step(batch) -> metrics``, which trains ``model`` in place.

    ``batch``: a dict of tensors or arrays with
      images: (B, H, W, 3) f32 mean-subtracted BGR, or raw uint8 BGR
      labels: (B, H, W) integer label maps, ``cfg.ignore_label`` = ignore
      pad_mask: optional (B,) {1, 0}; rows marked 0 become all-ignore and
        drop out of the valid-normalised loss exactly.
    ``metrics``: 0-d tensors ``loss``, ``accuracy`` and ``grad_norm``.
    ``axis_name``: a ``parallel.Mesh``; the batch is then this rank's rows,
    and the loss and accuracy sums, the valid pixel count and the gradients
    are summed over the ranks before the division (the exact global
    normalisation, whatever each rank's ignore pixels), as in
    ``train.stage1.make_stage1_step``.
    Raises ``ValueError`` when ``cfg.compute_dtype`` is not the model's.
    """
    check_compute_dtype(model, cfg)
    names = list(optimizer.params)
    params = [optimizer.params[n] for n in names]
    streams = rank_streams(generator, axis_name)

    @span("dsrg.step")
    def train_step(batch: dict) -> dict:
        def get(key):
            return torch.as_tensor(batch[key], device=device)

        with span("dsrg.forward"):
            device = params[0].device
            gen = streams()
            images = _device_normalize(get("images"))
            labels = get("labels")
            if cfg.mirror:  # one draw flips image and label map together
                flip = torch.rand(images.shape[0], generator=gen, device=device) < 0.5
                images = torch.where(flip[:, None, None, None], images.flip(2), images)
                labels = torch.where(flip[:, None, None], labels.flip(2), labels)
            # the Interp shrink of the label map: at 321 -> 41 a strided view
            # (exact subsampling); int64 for the loss's gather
            small = caffe_interp_shrink(labels[..., None].float(), cfg.shrink_factor)[..., 0]
            small = small.contiguous().to(torch.int64)
            if batch.get("pad_mask") is not None:
                keep = get("pad_mask")[:, None, None] > 0
                small = torch.where(keep, small, torch.full_like(small, cfg.ignore_label))

            scores = model(images, train=True, generator=gen)
        with span("dsrg.loss"):
            loss_sum, acc_sum, n_valid = softmax_cross_entropy_ignore_sums(
                scores, small, cfg.ignore_label)
        with span("dsrg.backward"):
            grads = list(torch.autograd.grad(loss_sum, params))
        with span("dsrg.update"):
            loss_sum = loss_sum.detach()
            if axis_name is not None:
                *grads, loss_sum, acc_sum, n_valid = all_reduce_sum(grads + [loss_sum, acc_sum, n_valid],
                                                                    axis_name)

            inv = 1.0 / torch.clamp_min(n_valid, 1.0)
            grads = {n: g * inv for n, g in zip(names, grads)}
            optimizer.step(grads)
            with torch.no_grad():
                return {
                    "loss": loss_sum * inv,
                    "accuracy": acc_sum * inv,
                    "grad_norm": global_norm(grads.values()),
                }

    train_step.axis_name = axis_name
    return train_step
