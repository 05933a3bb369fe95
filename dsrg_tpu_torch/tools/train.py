"""Training CLI — mirror of ``training/tools/train.py`` + ``run.sh`` stages
(``dsrg_tpu/tools/train.py``, its single-process VOC path).

The reference takes ``--solver/--weights/--snapshot/--gpu``; the solver
prototxt is replaced by ``--stage {s,f}`` selecting the built-in
solver-s/solver-f hyperparameters (overridable via flags).  ``--weights``
warm-starts parameters from a params file (``net.copy_from`` semantics);
``--snapshot`` resumes a full train state (``solver.restore`` semantics).
``--weights x.caffemodel`` imports Caffe weights for either family (for a
ResNet-101 its BN statistics too: the warm start that ``calibrate_bn``
writes).  ``--dataset coco`` trains stage s on the 81-class dense cues of
``data/coco.py`` (``--root`` / ``--pair-list``), its mean subtracted on the
device from uint8 batches.  The flags are the JAX CLI's plus ``--device``
(``cuda`` by default, ``cpu`` for the kernels' plain versions).  Flags whose
code waits for a later slice of the port (several processes) exit naming
their ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os.path as osp

import torch

from dsrg_tpu_torch._device import disable_tf32, resolve_device
from dsrg_tpu_torch.config import Stage1Config, Stage2Config
from dsrg_tpu_torch.data.coco import COCO_MEAN, COCOCueDataset
from dsrg_tpu_torch.data.cues import CueDB
from dsrg_tpu_torch.data.loader import PrefetchLoader
from dsrg_tpu_torch.data.voc import BGR_MEAN, Stage1Dataset, Stage2Dataset
from dsrg_tpu_torch.models import FAMILIES
from dsrg_tpu_torch.models.import_caffe import caffe_blobs_to_torch, load_caffemodel, resnet_blobs_to_torch
from dsrg_tpu_torch.tools._infer_common import not_ported
from dsrg_tpu_torch.train import checkpoint as ckpt
from dsrg_tpu_torch.train.stage1 import init_stage1, make_stage1_step
from dsrg_tpu_torch.train.stage2 import init_stage2, make_stage2_step


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a DSRG network")
    p.add_argument("--stage", choices=["s", "f"], required=True,
                   help="s = DSRG seed training, f = retrain on pseudo GT")
    p.add_argument("--weights", default=None,
                   help="params file or .caffemodel to warm-start from")
    p.add_argument("--snapshot", default=None, help="full train-state checkpoint to resume")
    p.add_argument("--snapshot-dir", default="models", help="snapshot output dir")
    p.add_argument("--gpu", dest="gpu_id", default=0, type=int, help="unused (parity flag)")
    p.add_argument("--coordinator", default=None,
                   help="multi-host coordinator (ROADMAP.md Queue 1 item 8; exits until then)")
    p.add_argument("--num-processes", type=int, default=1,
                   help="multi-host process count; > 1 exits (ROADMAP.md Queue 1 item 8)")
    p.add_argument("--process-id", type=int, default=0, help="multi-host: this process's index")
    # data
    p.add_argument("--image-dir", help="stage s: JPEGImages dir")
    p.add_argument("--input-list", help="stage s: input_list.txt (file id pairs)")
    p.add_argument("--cues", help="stage s: localization cue pickle")
    p.add_argument("--root", help="stage f / coco: dataset root")
    p.add_argument("--pair-list", help="stage f / coco: (image, label) pair list")
    p.add_argument("--dataset", choices=["voc", "coco"], default="voc",
                   help="stage s data source: VOC cue pickle or COCO dense cues "
                        "(--root / --pair-list; --num-classes 21 becomes 81)")
    p.add_argument("--model", dest="model_name", choices=sorted(FAMILIES),
                   default="vgg16", help="backbone family")
    # solver overrides
    p.add_argument("--max-iter", type=int, default=None)
    p.add_argument("--base-lr", type=float, default=None)
    p.add_argument("--clip-gradients", type=float, default=None,
                   help="Caffe solver clip_gradients: scale raw grads to this "
                        "global L2 norm when exceeded (the VGG recipe leaves it off)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--crop-size", type=int, default=None)
    p.add_argument("--snapshot-every", type=int, default=None)
    p.add_argument("--num-classes", type=int, default=21)
    p.add_argument("--display", type=int, default=10)
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="compute dtype; float32 also turns TF32 off on the card")
    p.add_argument("--crf-fast", action="store_true",
                   help="bf16 CRF kernel matmuls in the stage-s step (throughput "
                        "opt-in; default is the reference's fp32 mean field)")
    p.add_argument("--crf-true-grad", action="store_true",
                   help="backprop the TRUE mean-field Jacobian (CRF-as-RNN) "
                        "through the stage-s CRF instead of the reference's "
                        "heuristic (1-Q)*g CRFLayer backward")
    p.add_argument("--no-mesh", action="store_true", help="unused (one device per process)")
    p.add_argument("--cache-decoded", action="store_true",
                   help="cache decoded uint8 canvases to a memmap under "
                        "--snapshot-dir (stage s: resized crops; stage f: "
                        "max-padded originals + labels).  First epoch "
                        "decodes, later epochs read at memory speed; "
                        "implies --ship-uint8")
    p.add_argument("--ship-uint8", action="store_true",
                   help="ship raw uint8 image canvases and mean-subtract on "
                        "device (4x fewer host->device bytes than f32; exact "
                        "for stage f, <=0.5/255 resize quantization for "
                        "stage s)")
    p.add_argument("--auto-resume", action="store_true",
                   help="resume from the latest snapshot in --snapshot-dir if present")
    p.add_argument("--rss-limit-gb", type=float, default=-1.0,
                   help="host-RSS watchdog: past this many GB, snapshot and "
                        "exit 75 so a supervisor can relaunch with "
                        "--auto-resume (deterministic data order makes the "
                        "restart lossless).  -1 = auto (80%% of MemTotal), 0 = off")
    p.add_argument("--stall-limit-min", type=float, default=60.0,
                   help="stall watchdog: exit 75 when no training step "
                        "completes for this many minutes (wedged device; "
                        "resume replays from the last snapshot).  0 = off")
    p.add_argument("--sync-snapshots", action="store_true",
                   help="write snapshots synchronously (default: host copies, "
                        "then the write on a background thread)")
    # in-training validation (the reference has none; SegAccuracy-equivalent+)
    p.add_argument("--val-every", type=int, default=0, help="validate every N iters (0 = off)")
    p.add_argument("--val-ids", default=None, help="validation id list")
    p.add_argument("--val-dir", default=None, help="VOC root for validation images")
    p.add_argument("--val-gt", default=None, help="ground-truth mask dir")
    p.add_argument("--val-limit", type=int, default=100, help="max validation images")
    p.add_argument("--metrics-log", default=None, help="JSONL metrics file")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of steps 10-14 here")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions); "
                        "cuda without a card raises")
    return p.parse_args(argv)


def _flush_metrics(pending, logger):
    """Materialize deferred step metrics with ONE device->host transfer.

    A separate ``.item()`` per scalar is a synchronising round trip each;
    stacking the 0-d metrics on the device first makes it one transfer per
    display block."""
    if not pending:
        return None
    keys = sorted(pending[0][1])
    flat = torch.stack([m[k].float() for _, m in pending for k in keys]).cpu().numpy()
    averaged = None
    for row, (itn, _) in enumerate(pending):
        averaged = logger.log(
            itn,
            {k: float(flat[row * len(keys) + i]) for i, k in enumerate(keys)},
        )
    pending.clear()
    return averaged


def _override(cfg, args):
    changes = {}
    if args.max_iter is not None:
        changes["max_iter"] = args.max_iter
    if args.base_lr is not None:
        changes["base_lr"] = args.base_lr
    if args.clip_gradients is not None:
        changes["clip_gradients"] = args.clip_gradients
    if args.batch_size is not None:
        changes["batch_size"] = args.batch_size
    if args.crop_size is not None:
        changes["crop_size"] = args.crop_size
        if hasattr(cfg, "cue_size"):
            changes["cue_size"] = (args.crop_size - 1) // 8 + 1
    if args.snapshot_every is not None:
        changes["snapshot_every"] = args.snapshot_every
    changes["num_classes"] = args.num_classes
    changes["compute_dtype"] = args.dtype
    if getattr(args, "crf_fast", False) and hasattr(cfg, "crf_fast"):
        changes["crf_fast"] = True
    if getattr(args, "crf_true_grad", False) and hasattr(cfg, "crf_true_grad"):
        changes["crf_true_grad"] = True
    return dataclasses.replace(cfg, **changes)


def _check_ported(args) -> None:
    if args.num_processes > 1 or args.coordinator:
        raise not_ported("--num-processes > 1 / --coordinator", 8)


def main(argv=None) -> None:
    args = parse_args(argv)
    _check_ported(args)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        if args.dtype == "float32":
            disable_tf32()
        # one crop shape for the whole run: let cuDNN time its algorithms once
        torch.backends.cudnn.benchmark = True
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    cache_dir = osp.join(args.snapshot_dir, "decoded_cache") if args.cache_decoded else None

    if args.stage == "s":
        if args.dataset == "coco" and args.num_classes == 21:
            args.num_classes = 81
        cfg = _override(Stage1Config(), args)
        model = FAMILIES[args.model_name](num_classes=cfg.num_classes, compute_dtype=dtype)
        state = init_stage1(model, cfg, device=dev)
        if args.dataset == "coco":
            dataset = COCOCueDataset(
                args.root, args.pair_list, batch_size=cfg.batch_size,
                new_size=(cfg.crop_size, cfg.crop_size), num_classes=cfg.num_classes, seed=cfg.seed,
                ship_uint8=args.ship_uint8 or args.cache_decoded, cache_dir=cache_dir,
            )
            input_mean = COCO_MEAN
        else:
            cue_db = CueDB(args.cues, num_classes=cfg.num_classes, cue_size=cfg.cue_size)
            dataset = Stage1Dataset(
                args.image_dir, args.input_list, cue_db,
                crop_size=cfg.crop_size, batch_size=cfg.batch_size, seed=cfg.seed,
                ship_uint8=args.ship_uint8 or args.cache_decoded, cache_dir=cache_dir,
            )
            input_mean = BGR_MEAN
        step = make_stage1_step(model, cfg, state.optimizer, state.generator, input_mean=input_mean)
    else:
        cfg = _override(Stage2Config(), args)
        model = FAMILIES[args.model_name](num_classes=cfg.num_classes, compute_dtype=dtype)
        state = init_stage2(model, cfg, device=dev)
        dataset = Stage2Dataset(
            args.root, args.pair_list,
            crop_size=cfg.crop_size, batch_size=cfg.batch_size, seed=cfg.seed,
            ship_uint8=args.ship_uint8 or args.cache_decoded, cache_dir=cache_dir,
        )
        step = make_stage2_step(model, cfg, state.optimizer, state.generator)

    if args.weights and args.weights.endswith(".caffemodel"):
        blobs = load_caffemodel(args.weights)
        to_torch = resnet_blobs_to_torch if args.model_name == "resnet101" else caffe_blobs_to_torch
        model.load_state_dict(to_torch(blobs, model.state_dict()))
    elif args.weights:
        ckpt.copy_from(model, ckpt.load_params(args.weights))
    if args.snapshot:
        ckpt.restore_checkpoint(args.snapshot, state)
    elif args.auto_resume:
        latest = ckpt.latest_checkpoint(args.snapshot_dir)
        if latest:
            print("auto-resume from", latest, flush=True)
            ckpt.restore_checkpoint(latest, state)

    if state.step:
        # reproduce the uninterrupted run's data order after a resume
        # (sample k is a pure function of (seed, k) — data/voc.py:_EpochOrder)
        dataset.seek(state.step)
    loader = PrefetchLoader(dataset, device=dev)
    print(f"single-device training on {dev}", flush=True)

    def run_validation():
        from dsrg_tpu_torch.inference import Predictor
        from dsrg_tpu_torch.utils.confusion import ConfusionMatrix
        from dsrg_tpu_torch.utils.imageio import read_image_rgb
        from dsrg_tpu_torch.utils.palette import read_mask_png

        predictor = Predictor(model, num_classes=cfg.num_classes, device=dev)  # eval mode, same weights
        try:
            conf = ConfusionMatrix(cfg.num_classes)
            ids = [ln.strip() for ln in open(args.val_ids) if ln.strip()][: args.val_limit]
            for img_id in ids:
                img = read_image_rgb(osp.join(args.val_dir, "JPEGImages", img_id + ".jpg"))
                mask = predictor.predict_mask(img, sizes=[cfg.crop_size], smooth=False)
                gt = read_mask_png(osp.join(args.val_gt, img_id + ".png"))
                conf.add(gt, mask)
        finally:
            predictor.close()
            model.train()
        miou, _, _ = conf.jaccard()
        return miou

    from dsrg_tpu_torch.utils import watchdog
    from dsrg_tpu_torch.utils.profiling import MetricLogger, StepTimer, kernel_launches, trace

    rss_limit = watchdog.resolve_limit(args.rss_limit_gb)
    stall = watchdog.StallWatchdog(args.stall_limit_min * 60.0, describe="training-step")
    logger = MetricLogger(args.metrics_log, average_window=args.display)
    timer = StepTimer(cfg.batch_size)
    start_iter = state.step
    profiler_ctx = None
    pending = []
    writer = ckpt.AsyncCheckpointWriter() if not args.sync_snapshots else None
    for it in range(start_iter, cfg.max_iter):
        if args.profile_dir and it == start_iter + 10:
            profiler_ctx = trace(args.profile_dir)
            profiler_ctx.__enter__()
        batch = next(loader)
        metrics = step(batch)
        # defer host materialization to the display boundary: a per-step
        # sync would stall the device queue
        pending.append((it + 1, metrics))
        if (it + 1) % args.display == 0:
            averaged = _flush_metrics(pending, logger)
        timer.tick()
        stall.tick()
        if args.profile_dir and it == start_iter + 14 and profiler_ctx is not None:
            profiler_ctx.__exit__(None, None, None)
            profiler_ctx = None
            print("profile trace ->", args.profile_dir, flush=True)
        if (it + 1) % args.display == 0:
            extra = ""
            if timer.step_time:
                extra = f" ({timer.step_time * 1000:.0f} ms/iter, {timer.images_per_sec:.1f} img/s)"
            print(f"iter {it + 1}: loss = {averaged['loss']:.4f}{extra}", flush=True)
        if args.val_every and (it + 1) % args.val_every == 0 and args.val_ids:
            miou = run_validation()
            logger.log(it + 1, {"val_miou": miou})
            print(f"iter {it + 1}: val mIoU = {miou:.4f}", flush=True)
            stall.tick()  # a long-but-finite validation is progress too
        snapped = (it + 1) % cfg.snapshot_every == 0 or (it + 1) == cfg.max_iter
        if snapped:
            if writer is not None:  # host copies now, the write in the background
                path = writer.save(args.snapshot_dir, state, it + 1)
                writer.save_params(path + "_params", model)
            else:
                path = ckpt.save_checkpoint(args.snapshot_dir, state, it + 1)
                ckpt.save_params(path + "_params", model)
            print("snapshot ->", path, flush=True)
        # host-RSS watchdog (utils/watchdog.py): past the limit, persist a
        # full snapshot and hand control back to the supervisor — completing
        # the run beats restarting, so never fire on the final iteration
        if (rss_limit and (it + 1) % args.display == 0
                and (it + 1) != cfg.max_iter and watchdog.over_limit(rss_limit)):
            stall.close()  # the sync snapshot below may legitimately be slow
            if not snapped:
                path = ckpt.save_checkpoint(args.snapshot_dir, state, it + 1)
            if writer is not None:
                writer.close()  # drain any in-flight async snapshot
            loader.close()
            logger.close()
            print(f"rss-watchdog: host RSS {watchdog.rss_gb():.1f} GB > "
                  f"{rss_limit:.1f} GB limit at iter {it + 1}; snapshot "
                  f"saved -> exit {watchdog.RESTART_EXIT_CODE} (relaunch "
                  "with --auto-resume to continue losslessly)", flush=True)
            raise SystemExit(watchdog.RESTART_EXIT_CODE)
    stall.close()
    if profiler_ctx is not None:  # a run that ended inside the profiled steps
        profiler_ctx.__exit__(None, None, None)
        print("profile trace ->", args.profile_dir, flush=True)
    _flush_metrics(pending, logger)  # flush any tail metrics
    if writer is not None:
        writer.close()  # drain the in-flight snapshot before exit
    loader.close()
    logger.close()
    print(f"trained steps {start_iter} to {state.step}", flush=True)
    print("kernel launches: " + json.dumps(kernel_launches()), flush=True)


if __name__ == "__main__":
    main()
