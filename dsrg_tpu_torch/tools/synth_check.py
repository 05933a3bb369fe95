"""End-to-end learning sanity check on a synthetic shapes dataset
(``dsrg_tpu/tools/synth_check.py``).

The reference has no automated check that its pipeline actually learns
(SURVEY.md §4: quality control was entirely empirical); VOC data is also not
always at hand.  This tool generates a self-contained weakly-supervised
dataset (``dsrg_tpu_torch.data.synth`` — sparse seed cues in the reference's
pickle format standing in for CAM + saliency seeds), then runs the REAL
stage-1 DSRG trainer from scratch, the real multi-scale inference CLI path,
and the real evaluator, reporting val mIoU.  Random predictions score ~0.02
mIoU here; a working DSRG stack reaches >0.5 within a few hundred
iterations because the seed loss + region growing expand the sparse cues to
the full shapes.

Two dataset profiles (``--profile``): ``easy`` (round-2 two-class smoke set)
and ``voc`` (20 fg classes, occlusion, variable sizes, texture overlap —
the standing VOC-difficulty accuracy proxy; see ``data/synth.py``).

Usage::

    python -m dsrg_tpu_torch.tools.synth_check --work-dir /tmp/synth --iters 300

The tree's images are PIL JPEGs, as the JAX package writes them; where PIL is
not installed, ``--image-format png`` writes them as lossless PNGs (through
``utils/imageio.write_png``, under the same ``<id>.jpg`` names).
``--device`` goes to every phase.  ``--dataset coco`` drives the 81-class
dense-cue path: stage s from (image, label png) pairs, ``test_coco``'s
streaming mIoU, and with ``--two-stage`` the pseudo ground truth and a
stage-f retrain.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os.path as osp

import numpy as np

from dsrg_tpu_torch.data.synth import PROFILES, make_dataset as _synth_make_dataset


def make_dataset(root: str, n_train: int, n_val: int, size: int, seed: int = 0,
                 profile: str = "easy", progress_every: int = 0, encode_image=None):
    """Back-compat wrapper: build the profile's spec at image/crop ``size``.

    For the ``easy`` profile ``size`` fixes the (square) image size exactly
    as in round 2; for ``voc`` it sets the training crop/resize geometry
    while image sizes vary per the profile."""
    spec = PROFILES[profile]
    overrides = dict(
        crop_size=size, cue_grid=(size - 1) // 8 + 1,
    )
    if spec.square:
        overrides.update(size_min=size, size_max=size)
    spec = dataclasses.replace(spec, **overrides)
    return _synth_make_dataset(root, n_train, n_val, spec, seed=seed,
                               progress_every=progress_every, encode_image=encode_image)


def _miou_fg(root: str, pred_dir: str, ids_file: str = "val_id.txt",
             n_classes: int = 21) -> dict:
    """Honest mIoU over background + every fg class present in the val gt.

    The reference's jaccard drops classes without a correct hit
    (utils/confusion.py:85-92 quirk) — an all-background predictor scores
    ~0.79 on background alone — so this is the actual learning signal."""
    from dsrg_tpu_torch.utils.confusion import ConfusionMatrix
    from dsrg_tpu_torch.utils.palette import read_mask_png

    conf = ConfusionMatrix(n_classes)
    present = {0}
    for img_id in open(osp.join(root, ids_file)).read().split():
        gt = read_mask_png(osp.join(root, "SegmentationClass", img_id + ".png"))
        pred = read_mask_png(osp.join(pred_dir, img_id + ".png"))
        present.update(np.unique(gt).tolist())
        conf.add(gt, pred)
    m = conf.M
    classes = sorted(c for c in present if c < n_classes)
    with np.errstate(divide="ignore", invalid="ignore"):
        per = [
            float(np.nan_to_num(m[i, i] / (m[i].sum() + m[:, i].sum() - m[i, i])))
            for i in classes
        ]
    return {
        "classes_present": classes,
        "iou_per_class": [round(v, 4) for v in per],
        "miou3": round(float(np.mean(per)), 4),
    }


_miou3 = _miou_fg  # round-2 name, kept for external callers


def _run_coco_proof(args, root: str) -> float:
    """From-scratch learning proof of the COCO dense-cue path: stage s reads
    (image, label png) pairs and builds dense 81-channel cue volumes at
    score resolution (``data/coco.py``); the evaluation is ``test_coco``'s
    streaming mIoU.  ``--two-stage`` adds the pseudo-GT dump, a stage-f
    retrain and the final evaluation."""
    from dsrg_tpu_torch.tools import test_coco
    from dsrg_tpu_torch.tools import train as train_tool
    from dsrg_tpu_torch.tools._infer_common import build_arg_parser

    ids = {split: open(osp.join(root, f"{split}_id.txt")).read().split() for split in ("train_aug", "val")}
    pair_paths = {}
    for split, split_ids in ids.items():
        pair_paths[split] = osp.join(root, f"coco_{split}_pairs.txt")
        with open(pair_paths[split], "w") as f:
            for i in split_ids:
                f.write(f"JPEGImages/{i}.jpg SegmentationClass/{i}.png\n")

    snap = osp.join(args.work_dir, "models-coco")
    train_tool.main([
        "--stage", "s", "--dataset", "coco",
        "--root", root + "/", "--pair-list", pair_paths["train_aug"],
        "--snapshot-dir", snap, "--max-iter", str(args.iters),
        "--batch-size", str(args.batch_size), "--crop-size", str(args.size),
        "--snapshot-every", str(args.iters), "--display", "25",
        "--dtype", args.dtype, "--model", args.model_name, "--device", args.device,
    ] + (["--crf-true-grad"] if args.crf_true_grad else [])
      + (["--crf-fast"] if args.crf_fast else []))
    model_path = osp.join(snap, f"step_{args.iters}_params")

    def coco_eval(model, out_dir):
        ev = build_arg_parser("").parse_args([
            "--images", pair_paths["val"], "--dir", root, "--model", model,
            "--output", out_dir, "--num-classes", "81",
            "--batch", str(args.batch), "--model-name", args.model_name, "--device", args.device,
        ] + (["--smooth"] if args.smooth else []))
        return test_coco.run_coco(ev, sizes=args.sizes or [args.size])

    if args.two_stage:
        # the pseudo-GT dump over train, then a stage-f retrain (run.sh on the COCO path)
        dump_dir = osp.join(args.work_dir, "coco_pseudo_gt")
        dump = build_arg_parser("").parse_args([
            "--images", pair_paths["train_aug"], "--dir", root,
            "--model", model_path, "--output", dump_dir,
            "--num-classes", "81", "--batch", str(args.batch),
            "--model-name", args.model_name, "--device", args.device,
        ])
        test_coco.run_coco(dump, sizes=args.sizes or [args.size])
        f_pairs = osp.join(root, "coco_f_pairs.txt")
        with open(f_pairs, "w") as f:
            for i in ids["train_aug"]:
                f.write(f"/JPEGImages/{i}.jpg {osp.abspath(osp.join(dump_dir, i + '.png'))}\n")
        snap_f = osp.join(args.work_dir, "models-coco-f")
        train_tool.main([
            "--stage", "f", "--root", root, "--pair-list", f_pairs,
            "--snapshot-dir", snap_f, "--num-classes", "81",
            "--max-iter", str(args.iters2 or args.iters),
            "--batch-size", str(args.batch_size), "--crop-size", str(args.size),
            "--snapshot-every", str(args.iters2 or args.iters),
            "--display", "25", "--weights", model_path,
            "--dtype", args.dtype, "--model", args.model_name, "--device", args.device,
        ])
        model_path = osp.join(snap_f, f"step_{args.iters2 or args.iters}_params")

    pred_dir = osp.join(args.work_dir, "coco_preds")
    miou_quirk = coco_eval(model_path, pred_dir)
    out = {"coco_val_miou_refquirk": float(miou_quirk), "iters": args.iters,
           "dataset": "coco", "two_stage": bool(args.two_stage),
           **_miou_fg(root, pred_dir, n_classes=81)}
    print(json.dumps(out))
    return out["miou3"]


def main(argv=None) -> float:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--work-dir", required=True)
    p.add_argument("--iters", type=int, default=300)
    p.add_argument("--n-train", type=int, default=64)
    p.add_argument("--n-val", type=int, default=16)
    p.add_argument("--size", type=int, default=321, help="image/crop size")
    p.add_argument("--profile", choices=sorted(PROFILES), default="easy",
                   help="dataset difficulty (easy: 2-class smoke set; voc: "
                        "20 classes, occlusion, varied sizes, texture overlap)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--sizes", type=int, nargs="+", default=None,
                   help="inference scale sizes (default: [size])")
    p.add_argument("--smooth", action="store_true", help="CRF at inference")
    p.add_argument("--batch", type=int, default=8, help="inference chunk")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--model-name", choices=["vgg16", "resnet101"], default="vgg16")
    p.add_argument("--weights", default=None,
                   help="warm-start params file forwarded to the trainer")
    p.add_argument("--clip-gradients", type=float, default=None,
                   help="forward the Caffe solver clip_gradients threshold "
                        "to the trainer (ResNet warm starts want ~10)")
    p.add_argument("--base-lr", type=float, default=None,
                   help="override the stage-s solver base_lr (the calibrated "
                        "ResNet warm start trains stably at 1e-4 + clip 10; "
                        "the VGG default is solver-s.prototxt's 5e-4)")
    p.add_argument("--crf-true-grad", action="store_true",
                   help="train with the true mean-field Jacobian (CRF-as-RNN)")
    p.add_argument("--crf-fast", action="store_true",
                   help="bf16 CRF kernel matmuls in the stage-s step")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--two-stage", action="store_true",
                   help="run the FULL run.sh-equivalent recipe (stage-s train "
                        "-> pseudo-GT dump -> stage-f retrain -> final "
                        "predictions -> evaluate) via run_recipe instead of "
                        "the single-stage loop")
    p.add_argument("--dataset", choices=["voc", "coco"], default="voc",
                   help="coco: drive the 81-class dense-cue path "
                        "(AnnotationLayerCOCO equivalent, data/coco.py): "
                        "stage-s training from label pngs, test-coco "
                        "streaming-mIoU eval, optional --two-stage retrain")
    p.add_argument("--iters2", type=int, default=None,
                   help="stage-2 iterations (default: --iters)")
    p.add_argument("--in-process", action="store_true",
                   help="forwarded to run_recipe under --two-stage: run the "
                        "recipe phases in this process instead of supervised "
                        "subprocesses (for cheap smokes; production runs "
                        "want the default's RSS-watchdog isolation)")
    p.add_argument("--device", default="cuda",
                   help="forwarded to every phase: cuda (default) or cpu")
    p.add_argument("--image-format", choices=["jpeg", "png"], default="jpeg",
                   help="the tree's images: PIL JPEGs (as the JAX package "
                        "writes them) or lossless PNGs, which need no PIL")
    args = p.parse_args(argv)

    root = osp.join(args.work_dir, "data")
    from dsrg_tpu_torch.utils.imageio import write_png

    make_dataset(root, args.n_train, args.n_val, args.size, args.seed,
                 profile=args.profile,
                 progress_every=500 if args.n_train + args.n_val > 500 else 0,
                 encode_image=write_png if args.image_format == "png" else None)
    if args.dataset == "coco":
        return _run_coco_proof(args, root)

    if args.two_stage:
        from dsrg_tpu_torch.tools import run_recipe

        w = osp.join(args.work_dir, "recipe")
        run_recipe.main([
            "--pascal-dir", root, "--list-dir", root,
            "--cues", osp.join(root, "cues.pickle"),
            "--work-dir", w,
            "--stage1-iters", str(args.iters),
            "--stage2-iters", str(args.iters2 or args.iters),
            "--dtype", args.dtype,
            "--batch-size", str(args.batch_size),
            "--crop-size", str(args.size),
            "--test-sizes", str(args.size),
            "--test-scales", "1.0",
            "--model", args.model_name, "--device", args.device,
        ] + ([] if args.smooth else ["--no-smooth"])
          + (["--in-process"] if args.in_process else []))
        miou = float(
            open(osp.join(w, "DSRG_result_final.txt")).read().splitlines()[0].split()[1]
        )
        out = {"synthetic_val_miou_refquirk": miou, "two_stage": True,
               "iters": args.iters, **_miou3(root, osp.join(w, "DSRG_final_output"))}
        print(json.dumps(out))
        return out["miou3"]

    from dsrg_tpu_torch.tools import evaluate as evaluate_tool
    from dsrg_tpu_torch.tools import train as train_tool
    from dsrg_tpu_torch.tools._infer_common import build_arg_parser, run_inference

    snap_dir = osp.join(args.work_dir, "models")
    train_tool.main([
        "--stage", "s",
        "--image-dir", osp.join(root, "JPEGImages"),
        "--input-list", osp.join(root, "input_list.txt"),
        "--cues", osp.join(root, "cues.pickle"),
        "--snapshot-dir", snap_dir,
        "--max-iter", str(args.iters),
        "--batch-size", str(args.batch_size),
        "--crop-size", str(args.size),
        "--snapshot-every", str(args.iters),
        "--display", "25",
        "--dtype", args.dtype,
        "--model", args.model_name, "--device", args.device,
    ] + (["--weights", args.weights] if args.weights else [])
      + (["--clip-gradients", str(args.clip_gradients)]
         if args.clip_gradients is not None else [])
      + (["--base-lr", str(args.base_lr)] if args.base_lr is not None else [])
      + (["--crf-true-grad"] if args.crf_true_grad else [])
      + (["--crf-fast"] if args.crf_fast else []))
    params_path = osp.join(snap_dir, f"step_{args.iters}_params")

    pred_dir = osp.join(args.work_dir, "preds")
    infer_argv = [
        "--images", osp.join(root, "val_id.txt"),
        "--dir", root,
        "--model", params_path,
        "--output", pred_dir,
        "--batch", str(args.batch),
        "--model-name", args.model_name, "--device", args.device,
    ] + (["--smooth"] if args.smooth else [])
    run_inference(
        build_arg_parser("").parse_args(infer_argv),
        sizes=args.sizes or [args.size],
    )

    result_path = osp.join(args.work_dir, "result.txt")
    miou = evaluate_tool.main([
        "--pred", pred_dir,
        "--gt", osp.join(root, "SegmentationClass"),
        "--test_ids", osp.join(root, "val_id.txt"),
        "--save_path", result_path,
        "--class_num", "21",
    ])
    out = {"synthetic_val_miou_refquirk": miou, "iters": args.iters,
           **_miou3(root, pred_dir)}
    print(json.dumps(out))
    return out["miou3"]


if __name__ == "__main__":
    main()
