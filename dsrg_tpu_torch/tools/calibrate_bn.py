"""BN-statistics calibration -> a warm-start ``.caffemodel`` for ResNet-101
(``dsrg_tpu/tools/calibrate_bn.py``).

The reference never trains its ResNet from scratch: Caffe-DeepLab freezes
batch norm (statistics and scale / offset, lr_mult 0) and warm-starts from a
pretrained caffemodel whose statistics condition every layer.  This tool
makes that warm start from data: ``--batches`` forward batches with BN on
batch statistics, moving the running averages as flax does (momentum 0.95,
biased variance); optionally the heads' kernels rescaled so that the frozen
net's scores have ``--head-logit-std``; then params and calibrated statistics
written as a DeepLab-v2-named ``.caffemodel`` (``models/export_caffe.py``).
The trainer imports it through ``--weights x.caffemodel``, the path a
downloaded pretrained model takes.

Usage (on a synth_check tree)::

    python -m dsrg_tpu_torch.tools.calibrate_bn \\
        --image-dir data/JPEGImages --input-list data/input_list.txt \\
        --cues data/cues.pickle --out resnet_calib.caffemodel

The flags are the JAX tool's plus ``--device`` (``cuda`` by default, ``cpu``
for the plain versions).
"""

from __future__ import annotations

import argparse
import json

import torch

from dsrg_tpu_torch._device import disable_tf32, resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--image-dir", required=True)
    p.add_argument("--input-list", required=True)
    p.add_argument("--cues", required=True, help="cue pickle (images only are used)")
    p.add_argument("--out", required=True, help="output .caffemodel path")
    p.add_argument("--batches", type=int, default=50,
                   help="calibration forward batches (momentum 0.95: 50 "
                        "batches leave <8%% weight on the identity init)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--crop-size", type=int, default=321)
    p.add_argument("--num-classes", type=int, default=21)
    p.add_argument("--head-logit-std", type=float, default=0.5,
                   help="rescale the classifier heads so that the frozen-BN "
                        "score maps have this std on the last calibration "
                        "batch (0 = keep the random init).  A random-weight "
                        "ResNet-101's residual stream grows ~sqrt(depth); "
                        "unscaled 3x3x2048 heads then emit |logit| ~ 15 maps "
                        "whose floored softmax saturates.  Scores are linear "
                        "in the heads, so the rescale is exact.")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions); "
                        "cuda without a card raises")
    return p.parse_args(argv)


@torch.no_grad()
def calibrate(model, batches, head_logit_std: float = 0.5):
    """Calibrate ``model``'s BN statistics in place on ``batches`` (an
    iterable of (B, H, W, 3) mean-subtracted images on the model's device),
    then, with ``head_logit_std`` > 0, rescale the heads (``fc1_voc12*``,
    ``fc8*``; kernels and biases) so that the frozen net's scores on the last
    batch have that std.  Returns the scores' std before and after the
    rescale (None without one)."""
    images = None
    for i, images in enumerate(batches):
        model(images, train_bn=True)
        if (i + 1) % 10 == 0:
            print(f"calibrated {i + 1} batches", flush=True)
    if not head_logit_std > 0:
        return None
    # the score std under the training condition (frozen calibrated BN)
    std0 = model(images).std(correction=0).item()
    scale = head_logit_std / max(std0, 1e-6)
    for name, p in model.named_parameters():
        if name.startswith(("fc1_voc12", "fc8")):
            p.mul_(scale)
    std1 = model(images).std(correction=0).item()
    print(f"head rescale: score std {std0:.3f} -> {std1:.3f} (kernel scale {scale:.4g})", flush=True)
    return std0, std1


def main(argv=None) -> str:
    args = parse_args(argv)
    from dsrg_tpu_torch.data.cues import CueDB
    from dsrg_tpu_torch.data.voc import Stage1Dataset
    from dsrg_tpu_torch.models import ResNet101DeepLab
    from dsrg_tpu_torch.models.export_caffe import resnet_variables_to_blobs, write_caffemodel
    from dsrg_tpu_torch.train.stage1 import init_params
    from dsrg_tpu_torch.utils.profiling import kernel_launches

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        disable_tf32()
    cue_db = CueDB(args.cues, num_classes=args.num_classes, cue_size=(args.crop_size - 1) // 8 + 1)
    dataset = iter(Stage1Dataset(args.image_dir, args.input_list, cue_db, crop_size=args.crop_size,
                                 batch_size=args.batch_size, seed=args.seed))
    model = ResNet101DeepLab(num_classes=args.num_classes)
    init_params(model, args.seed)
    model.to(dev)
    calibrate(model, (torch.as_tensor(next(dataset)["images"], device=dev).float() for _ in range(args.batches)),
              args.head_logit_std)

    # calibration must have moved the statistics off the identity init
    v0 = model.bn1.running_mean.abs().mean().item()
    if not v0 > 0:
        raise RuntimeError("bn1 running mean did not move: calibration failed")
    blobs = resnet_variables_to_blobs(model.state_dict())
    write_caffemodel(args.out, blobs)
    print(f"wrote {args.out}: {len(blobs)} layers, bn1 |mean|={v0:.4f}", flush=True)
    print("kernel launches: " + json.dumps(kernel_launches()), flush=True)
    return args.out


if __name__ == "__main__":
    main()
