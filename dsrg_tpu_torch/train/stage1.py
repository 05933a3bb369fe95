"""The stage-1 DSRG train step (``dsrg_tpu/train/stage1.py``; ``SURVEY.md`` §3.1).

Per step, in the reference's layer order (``train-s.prototxt``):
  joint random mirror of images and cues   (AnnotationLayer)
  -> the backbone's train forward         (VGG16-LargeFOV with dropout, or
                                            ResNet-101 with frozen BN; max
                                            pools routed on the kernels)
  -> floored softmax, then the CRFLayer's clamp with identity gradient
  -> dense-CRF refinement, once            (CRFLayer + DSRGLayer.refinement)
  -> seeded region growing                 (no gradient)
  -> balanced seed loss + constrain loss, weighted sums over valid samples
  -> backward and the Caffe SGD update     (step-lr policy)

The step runs on the model's device: the card by default, the CPU (plain
versions of the kernels) when the model was placed there.  Parity with the
JAX package needs fp32 throughout, so a caller on the card turns TF32 off
(``torch.backends.cudnn.allow_tf32 = False``; PyTorch's default is True for
convolutions).  ``cfg.compute_dtype`` is the model's: a bfloat16 model
(``DeepLabLargeFOV(compute_dtype=torch.bfloat16)``) returns float32 scores,
so softmax, CRF, growing and losses stay float32, as in the JAX package.  A
ResNet's frozen BN statistics are buffers of the module (the JAX step's
``extra_vars``): they move with it and no step changes them.
With ``axis_name`` (a ``parallel.Mesh``) the step is data-parallel: each
rank computes its rows, one all-reduce adds the gradients and metric sums
over the ranks, and every rank makes the same update (JAX's ``psum`` in a
``shard_map``; ``DistributedDataParallel`` does not apply, since the step
takes its gradients with ``torch.autograd.grad``, whose hooks DDP never
sees).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from dsrg_tpu_torch._device import resolve_device
from dsrg_tpu_torch.config import Stage1Config
from dsrg_tpu_torch.data.voc import BGR_MEAN
from dsrg_tpu_torch.losses import balanced_seed_loss_per_sample, constrain_loss_per_sample
from dsrg_tpu_torch.ops.crf.api import crf_refine_with_log, crf_refine_with_log_truegrad
from dsrg_tpu_torch.ops.grow import dsrg_grow
from dsrg_tpu_torch.ops.softmax import MIN_PROB, clamp_straight_through, floored_softmax
from dsrg_tpu_torch.parallel.mesh import Mesh, all_reduce_sum
from dsrg_tpu_torch.train.optimizer import CaffeSGD, global_norm, lr_step
from dsrg_tpu_torch.train.train_state import TrainState
from dsrg_tpu_torch.utils.profiling import span


def _device_normalize(images: torch.Tensor, mean=BGR_MEAN) -> torch.Tensor:
    """f32 mean-subtracted images as they are; raw uint8 BGR minus ``mean``
    (the VOC mean by default)."""
    if images.dtype == torch.uint8:
        return images.float() - torch.as_tensor(mean, dtype=torch.float32, device=images.device)
    return images.float()


def init_params(model: nn.Module, seed: int) -> None:
    """Initialise ``model`` in place with the distributions of flax's
    ``model.init``: lecun-normal (truncated at 2 sigma, fan-in scaled) for
    the convolutions, normal(0.01) for the heads (``fc8*``, ``fc1_voc12*``),
    zero biases; a batch norm's scale 1 and offset 0, its running mean 0 and
    variance 1.  The draws come from a CPU generator seeded with ``seed``,
    so the weights are the same on every device; they are not JAX's draws."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            buf.fill_(1.0 if name.endswith("running_var") else 0.0)
        for name, p in model.named_parameters():
            if name.endswith(".bias"):
                val = torch.zeros(p.shape)
            elif p.ndim == 1:  # a batch norm's scale
                val = torch.ones(p.shape)
            elif name.startswith(("fc8", "fc1_voc12")):
                val = torch.empty(p.shape).normal_(0.0, 0.01, generator=gen)
            else:
                # .87962566103423978 is the std of a unit normal truncated at +-2
                std = float(np.sqrt(1.0 / np.prod(p.shape[1:]))) / 0.87962566103423978
                val = torch.nn.init.trunc_normal_(torch.empty(p.shape), 0.0, std, -2 * std,
                                                  2 * std, generator=gen)
            p.copy_(val)


def check_compute_dtype(model: nn.Module, cfg) -> None:
    """Raise unless ``cfg.compute_dtype`` (a name, "float32" or "bfloat16",
    as in the JAX package) is the model's ``compute_dtype``.  The JAX steps
    trust their caller, whose ``tools/train.py`` builds the model from the
    same flag; the port has no such tool yet, and a silent float32 run of a
    bfloat16 config is the fault this check stops."""
    want = getattr(torch, cfg.compute_dtype, None)
    if not isinstance(want, torch.dtype):
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r} names no torch dtype")
    have = getattr(model, "compute_dtype", torch.float32)
    if have != want:
        raise ValueError(f"the config's compute_dtype is {cfg.compute_dtype!r} but the model computes "
                         f"in {have}; build the model with compute_dtype=torch.{cfg.compute_dtype}")


def make_optimizer(model: nn.Module, cfg: Stage1Config) -> CaffeSGD:
    return CaffeSGD(dict(model.named_parameters()),
                    lr_step(cfg.base_lr, cfg.gamma, cfg.stepsize),
                    momentum=cfg.momentum, weight_decay=cfg.weight_decay,
                    clip_gradients=cfg.clip_gradients)


def init_stage1(model: nn.Module, cfg: Stage1Config, device=None) -> TrainState:
    """Initialise ``model`` (seed ``cfg.seed``), move it to ``device`` (the
    card by default) and build its optimizer and random stream."""
    dev = resolve_device(device)
    init_params(model, cfg.seed)
    model.to(dev)
    generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    return TrainState(model, make_optimizer(model, cfg), generator)


def rank_streams(generator: Optional[torch.Generator],
                 mesh: Optional[Mesh]) -> Callable[[], Optional[torch.Generator]]:
    """Per step, the random stream of this rank's mirror and dropout draws:
    JAX's ``fold_in(rng, axis_index)``.  With several ranks each step draws
    one key from the shared ``generator``, which so advances alike on every
    rank (a snapshot of it does not depend on the rank), and seeds a
    generator of this rank's from (key, rank): a resume at the same world
    size continues every rank's stream.  With one rank it is the shared
    stream itself, so a one-rank step is the plain step."""
    if mesh is None or mesh.world_size == 1:
        return lambda: generator
    if generator is None:
        raise ValueError("a data-parallel step needs the train state's generator")
    own = torch.Generator(device=generator.device)

    def stream() -> torch.Generator:
        key = int(torch.randint(0, 2**63 - 1, (1,), generator=generator, device=generator.device).item())
        return own.manual_seed(int(np.random.SeedSequence((key, mesh.rank)).generate_state(1, np.uint64)[0]))

    return stream


def make_stage1_step(model: nn.Module, cfg: Stage1Config, optimizer: CaffeSGD,
                     generator: Optional[torch.Generator] = None,
                     input_mean=BGR_MEAN, axis_name: Optional[Mesh] = None) -> Callable[[dict], dict]:
    """Build ``step(batch) -> metrics``, which trains ``model`` in place.

    ``batch``: a dict of tensors or arrays with
      images: (B, H, W, 3) f32 mean-subtracted BGR, or raw uint8 BGR from
        which the step subtracts ``input_mean`` (BGR channel means)
      labels: (B, M) multi-hot image labels (bit 0 = background, always 1)
      cues:   (B, h, w, M) {0, 1} seed cues at score resolution (f32 or uint8)
      pad_mask: optional (B,) {1, 0}; rows marked 0 contribute nothing to
        the losses, gradients or metrics.
    ``metrics``: 0-d tensors ``loss``, ``loss_seed``, ``loss_constrain``,
    ``seed_pixels`` and ``grad_norm``, as the JAX step returns them.
    ``axis_name``: a ``parallel.Mesh`` (JAX's mesh axis name; a torch
    collective names the process group, which the mesh holds).  The batch
    is then this rank's rows; the losses' weighted sums, the valid count,
    the seed pixels and the gradients are summed over the ranks before the
    division and the update, so the clipping sees the global gradient and
    the metrics are the global ones on every rank.  Each rank draws from
    its own stream (:func:`rank_streams`).
    Raises ``ValueError`` when ``cfg.compute_dtype`` is not the model's
    (:func:`check_compute_dtype`).
    """
    check_compute_dtype(model, cfg)
    refine = crf_refine_with_log_truegrad if cfg.crf_true_grad else crf_refine_with_log
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
            images = _device_normalize(get("images"), input_mean)
            labels = get("labels").float()
            cues = get("cues").float()
            b = images.shape[0]
            weights = (torch.ones(b, device=device) if batch.get("pad_mask") is None
                       else get("pad_mask").float())
            if cfg.mirror:
                flip = torch.rand(b, generator=gen, device=device) < 0.5
                images = torch.where(flip[:, None, None, None], images.flip(2), images)
                cues = torch.where(flip[:, None, None, None], cues.flip(2), cues)

            scores = model(images, train=True, generator=gen)
            probs = clamp_straight_through(floored_softmax(scores), MIN_PROB)
        with span("dsrg.loss"):
            q_log, q = refine(probs, images, cfg.crf_scale_factor, cfg.crf_iters, cfg.crf_fast)
            cues_new = dsrg_grow(labels, cues, q, th1=cfg.th1, th2=cfg.th2)
            # weighted SUMS of per-sample losses, divided by the valid count below:
            # the exact mean over valid samples, whatever the padding
            sum_seed = (weights * balanced_seed_loss_per_sample(probs, cues_new)).sum()
            sum_con = (weights * constrain_loss_per_sample(probs, q_log)).sum()
            loss_sum = sum_seed + sum_con
        with span("dsrg.backward"):
            grads = list(torch.autograd.grad(loss_sum, params))
        with span("dsrg.update"):
            sums = [t.detach() for t in (loss_sum, sum_seed, sum_con, weights.sum(),
                                         (cues_new * weights[:, None, None, None]).sum())]
            if axis_name is not None:
                reduced = all_reduce_sum(grads + sums, axis_name)
                grads, sums = reduced[:len(grads)], reduced[len(grads):]
            loss_sum, sum_seed, sum_con, n_valid, seed_pixels = sums

            inv = 1.0 / torch.clamp_min(n_valid, 1.0)
            grads = {n: g * inv for n, g in zip(names, grads)}
            optimizer.step(grads)
            with torch.no_grad():
                return {
                    "loss": loss_sum * inv,
                    "loss_seed": sum_seed * inv,
                    "loss_constrain": sum_con * inv,
                    "seed_pixels": seed_pixels,
                    "grad_norm": global_norm(grads.values()),
                }

    train_step.axis_name = axis_name
    return train_step
