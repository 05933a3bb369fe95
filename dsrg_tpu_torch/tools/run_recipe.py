"""Two-stage VOC recipe runner — the ``run.sh`` equivalent.

  1. stage-s DSRG training (8k iters) from ImageNet VGG16 weights
  2. multi-scale dump of pseudo GT over train_aug (test-ms, smooth)
  3. stage-f retraining (20k iters) from the stage-s model
  4. multi-scale val predictions (test-ms-f, smooth)
  5. mIoU evaluation against SegmentationClass

(``training/experiment/seed_mc/run.sh:1-11``; ``dsrg_tpu/tools/run_recipe.py``)

Each compute phase runs as its OWN supervised subprocess by default
(``python -m dsrg_tpu_torch.tools.<name>``): a phase's host memory and its
device memory (a trainer's cuDNN workspaces, a dump's canvases) are given
back when it ends, the in-phase RSS watchdog bounds host memory within a
phase (snapshot + exit 75), and the supervisor relaunches a watchdog/OOM
exit until the phase completes — lossless under ``--auto-resume``
(deterministic resume for the trainers, ``--skip-existing`` for the dumps).
``--in-process`` runs every phase in this process instead, freeing the
trainer's model and the card's cached memory before each dump.  ``--device``
goes to every phase; each phase prints its wall time.
"""

from __future__ import annotations

import argparse
import gc
import os
import os.path as osp
import subprocess
import sys
import time

from dsrg_tpu_torch.utils import watchdog


def _count_pngs(out_dir: str) -> int:
    if not osp.isdir(out_dir):
        return 0
    return sum(1 for f in os.listdir(out_dir) if f.endswith(".png"))


def _release_device_memory() -> None:
    """Collect the finished phase's objects and give the card's cached
    blocks back (the fp32 stage-1 warm-up peaks near 40 GiB while cuDNN
    searches its algorithms)."""
    gc.collect()
    import torch

    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _supervise(module: str, phase_args: list, progress_probe, args) -> None:
    """Run one phase CLI as a subprocess; relaunch watchdog/OOM exits.

    Restartable exits are the watchdog's :data:`watchdog.RESTART_EXIT_CODE`
    and kill-by-signal (rc < 0 from subprocess, or 137 from a shell wrapper
    — the kernel OOM killer).  Anything else propagates.  A restartable exit
    only relaunches when ``--auto-resume`` made relaunching lossless, and
    only while the phase demonstrably progresses (its snapshot step / output
    png count advances) — three relaunches with zero progress abort rather
    than loop forever on e.g. a limit below the process' floor RSS.
    """
    cmd = [sys.executable, "-m", module] + [str(a) for a in phase_args]
    # the child must resolve dsrg_tpu_torch the same way this process did
    # (test runs add the checkout to sys.path via conftest, which
    # subprocesses don't inherit) — prepend this package's root to PYTHONPATH
    env = dict(os.environ)
    pkg_root = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
    last = progress_probe()
    no_progress = 0
    relaunches = 0
    while True:
        rc = subprocess.call(cmd, env=env)
        if rc == 0:
            return
        restartable = (rc == watchdog.RESTART_EXIT_CODE or rc == 137 or rc < 0)
        if not restartable:
            raise SystemExit(rc)
        if not args.auto_resume:
            raise SystemExit(
                f"{module} exited {rc} (memory watchdog / OOM kill); rerun "
                "the recipe with --auto-resume to enable lossless supervised "
                "relaunches"
            )
        now = progress_probe()
        no_progress = 0 if now != last else no_progress + 1
        last = now
        if no_progress >= 3:
            raise SystemExit(
                f"{module} exited {rc} three times without progress "
                f"(stuck at {now}); check --rss-limit-gb against the "
                "process' baseline memory footprint"
            )
        relaunches += 1
        if relaunches > args.max_relaunches:
            raise SystemExit(f"{module}: relaunch budget "
                             f"({args.max_relaunches}) exhausted")
        print(f"[recipe] {module} exited {rc} -> relaunching with resume "
              f"({relaunches}/{args.max_relaunches}, progress {now})",
              flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pascal-dir", required=True, help="VOC12 root")
    p.add_argument("--list-dir", required=True, help="dir with input_list.txt etc.")
    p.add_argument("--cues", required=True, help="localization_cues-sal.pickle")
    p.add_argument("--weights", default=None, help="ImageNet VGG16 init params")
    p.add_argument("--work-dir", default="work", help="output dir")
    p.add_argument("--stage1-iters", type=int, default=8000)
    p.add_argument("--stage2-iters", type=int, default=20000)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--batch-size", type=int, default=None, help="override both stages")
    p.add_argument("--crop-size", type=int, default=None)
    p.add_argument("--test-sizes", type=int, nargs="+", default=[241, 321, 401],
                   help="pseudo-GT dump scales (test-ms)")
    p.add_argument("--test-scales", type=float, nargs="+", default=[0.75, 1.0, 1.25],
                   help="final prediction scales (test-ms-f)")
    p.add_argument("--test-batch", type=int, default=None,
                   help="forwarded to both dump phases as --batch "
                        "(images per forward/CRF chunk)")
    p.add_argument("--no-smooth", action="store_true", help="skip CRF post-processing")
    p.add_argument("--model", dest="model_name", choices=["vgg16", "resnet101"],
                   default="vgg16", help="backbone family for both stages")
    p.add_argument("--engine", default="auto",
                   choices=["auto", "exact", "mmgrid", "lattice", "grid", "native"],
                   help="CRF engine for the inference stages")
    p.add_argument("--pipeline", default="auto", choices=["auto", "host", "device"],
                   help="batched inference pipeline for both dump stages "
                        "(device = whole multi-scale pass on device; see "
                        "test tools)")
    p.add_argument("--ship-uint8", action="store_true",
                   help="forwarded to both trainers: raw uint8 canvases + "
                        "on-device mean subtraction (4x fewer host->device "
                        "bytes; for slow host links)")
    p.add_argument("--cache-decoded", action="store_true",
                   help="forwarded to both trainers: memmap decode cache "
                        "(for decode-bound hosts; epoch >= 2 reads at memory "
                        "speed)")
    p.add_argument("--auto-resume", action="store_true",
                   help="make the whole recipe relaunch-safe: both trainers "
                        "resume from their latest snapshot (completed stages "
                        "become no-ops), both dump phases skip existing "
                        "output pngs, and watchdog/OOM phase exits are "
                        "relaunched automatically")
    p.add_argument("--val-every", type=int, default=0,
                   help="forwarded to both trainers: validate on val_id.txt "
                        "every N iters (single-scale, no CRF)")
    p.add_argument("--snapshot-every", type=int, default=None,
                   help="forwarded to both trainers (default: one snapshot "
                        "at stage end)")
    p.add_argument("--display", type=int, default=10,
                   help="forwarded to both trainers: loss display cadence")
    p.add_argument("--rss-limit-gb", type=float, default=-1.0,
                   help="forwarded to every compute phase: host-RSS watchdog "
                        "limit (see utils/watchdog.py).  -1 = auto (80%% of "
                        "MemTotal), 0 = off")
    p.add_argument("--stall-limit-min", type=float, default=60.0,
                   help="forwarded to every compute phase: stall-watchdog "
                        "limit (exit 75 when no step/chunk completes for "
                        "this long; raise it if legitimate gaps — e.g. "
                        "first remote compiles of new canvas shapes — "
                        "exceed an hour).  0 = off")
    p.add_argument("--max-relaunches", type=int, default=50,
                   help="supervisor budget for watchdog/OOM phase relaunches")
    p.add_argument("--in-process", action="store_true",
                   help="run all phases in THIS process: no subprocess "
                        "isolation, no supervised relaunch — a watchdog exit "
                        "ends the whole recipe (relaunch it with "
                        "--auto-resume to continue)")
    p.add_argument("--parity", action="store_true",
                   help="reference-parity mode: fp32 everywhere (training + "
                        "CRF mean field), exact per-shape forwards, serial "
                        "per-image inference.  The one remaining numeric "
                        "deviation from the reference pipeline is the "
                        "full-resolution CRF approximation; its measured "
                        "bound (99.9%+ argmax agreement with the reference's "
                        "permutohedral algorithm on photo-statistics inputs) "
                        "is recorded in STATUS.md.")
    p.add_argument("--device", default="cuda",
                   help="forwarded to every phase: cuda (default) or cpu")
    args = p.parse_args(argv)

    if args.parity:
        args.dtype = "float32"

    size_overrides = ["--model", args.model_name, "--display", str(args.display),
                      "--device", args.device,
                      "--rss-limit-gb", str(args.rss_limit_gb),
                      "--stall-limit-min", str(args.stall_limit_min)]
    if args.batch_size is not None:
        size_overrides += ["--batch-size", str(args.batch_size)]
    if args.crop_size is not None:
        size_overrides += ["--crop-size", str(args.crop_size)]
    if args.ship_uint8:
        size_overrides.append("--ship-uint8")
    if args.cache_decoded:
        size_overrides.append("--cache-decoded")
    if args.auto_resume:
        size_overrides.append("--auto-resume")

    w = args.work_dir
    ld = args.list_dir
    jpeg = osp.join(args.pascal_dir, "JPEGImages")

    val_overrides = []
    if args.val_every:
        val_overrides = ["--val-every", str(args.val_every),
                         "--val-ids", osp.join(ld, "val_id.txt"),
                         "--val-dir", args.pascal_dir,
                         "--val-gt", osp.join(args.pascal_dir, "SegmentationClass")]

    def train_phase(train_args: list, snapshot_dir: str) -> None:
        t0 = time.perf_counter()
        if args.in_process:
            from dsrg_tpu_torch.tools import train as train_tool

            train_tool.main(train_args)
        else:
            def probe():
                from dsrg_tpu_torch.train.checkpoint import latest_checkpoint

                return latest_checkpoint(snapshot_dir)

            _supervise("dsrg_tpu_torch.tools.train", train_args, probe, args)
        print(f"[recipe] train --stage {train_args[1]}: {time.perf_counter() - t0:.1f} s", flush=True)

    def dump_phase(module: str, dump_args: list, extent_flag: str,
                   extents, out_dir: str) -> None:
        t0 = time.perf_counter()
        if args.in_process:
            from dsrg_tpu_torch.tools._infer_common import build_arg_parser, run_inference

            _release_device_memory()  # the trainer's model and cached blocks
            parsed = build_arg_parser("").parse_args(dump_args)
            kw = {"sizes" if extent_flag == "--sizes" else "scales": extents}
            run_inference(parsed, **kw)
        else:
            _supervise(module, dump_args + [extent_flag] + list(extents),
                       lambda: _count_pngs(out_dir), args)
        print(f"[recipe] {module.rsplit('.', 1)[1]}: {time.perf_counter() - t0:.1f} s", flush=True)

    # 1. stage-s training
    s_args = ["--stage", "s", "--image-dir", jpeg,
              "--input-list", osp.join(ld, "input_list.txt"), "--cues", args.cues,
              "--snapshot-dir", osp.join(w, "model-s"),
              "--max-iter", str(args.stage1_iters),
              "--snapshot-every", str(args.snapshot_every or args.stage1_iters),
              "--metrics-log", osp.join(w, "metrics-s.jsonl"),
              "--dtype", args.dtype] + size_overrides + val_overrides
    if args.weights:
        s_args += ["--weights", args.weights]
    train_phase(s_args, osp.join(w, "model-s"))
    model_s = osp.join(w, "model-s", f"step_{args.stage1_iters}_params")

    infer_overrides = ["--engine", args.engine, "--pipeline", args.pipeline, "--device", args.device,
                       "--rss-limit-gb", str(args.rss_limit_gb),
                       "--stall-limit-min", str(args.stall_limit_min)]
    if args.parity:
        infer_overrides += ["--batch", "1", "--bucket", "1"]
    elif args.test_batch is not None:
        infer_overrides += ["--batch", str(args.test_batch)]
    if args.auto_resume:
        infer_overrides.append("--skip-existing")

    # 2. pseudo-GT dump over train_aug
    dsrg_out = osp.join(w, "DSRGOutput")
    test_ms_args = ["--images", osp.join(ld, "train_aug_id.txt"), "--dir", args.pascal_dir,
                    "--model", model_s, "--output", dsrg_out,
                    "--model-name", args.model_name] + infer_overrides
    if not args.no_smooth:
        test_ms_args.append("--smooth")
    dump_phase("dsrg_tpu_torch.tools.test_ms", test_ms_args, "--sizes",
               args.test_sizes, dsrg_out)

    # 3. stage-f retraining (pair list written against the pseudo GT)
    pair_list = osp.join(w, "train_pairs.txt")
    ids = [ln.strip() for ln in open(osp.join(ld, "train_aug_id.txt")) if ln.strip()]
    with open(pair_list, "w") as f:
        for i in ids:
            f.write(f"/JPEGImages/{i}.jpg {osp.abspath(osp.join(dsrg_out, i + '.png'))}\n")
    f_args = ["--stage", "f", "--root", args.pascal_dir, "--pair-list", pair_list,
              "--snapshot-dir", osp.join(w, "model-f"),
              "--max-iter", str(args.stage2_iters),
              "--snapshot-every", str(args.snapshot_every or args.stage2_iters),
              "--metrics-log", osp.join(w, "metrics-f.jsonl"),
              "--weights", model_s, "--dtype", args.dtype] + size_overrides + val_overrides
    train_phase(f_args, osp.join(w, "model-f"))
    model_f = osp.join(w, "model-f", f"step_{args.stage2_iters}_params")

    # 4. final val predictions
    final_out = osp.join(w, "DSRG_final_output")
    mf_args = ["--images", osp.join(ld, "val_id.txt"), "--dir", args.pascal_dir,
               "--model", model_f, "--output", final_out,
               "--model-name", args.model_name] + infer_overrides
    if not args.no_smooth:
        mf_args.append("--smooth")
    dump_phase("dsrg_tpu_torch.tools.test_ms_f", mf_args, "--scales",
               args.test_scales, final_out)

    # 5. evaluate (host-only numpy, stays in-process)
    from dsrg_tpu_torch.tools import evaluate as evaluate_tool

    t0 = time.perf_counter()
    evaluate_tool.main(
        ["--pred", final_out, "--gt", osp.join(args.pascal_dir, "SegmentationClass"),
         "--test_ids", osp.join(ld, "val_id.txt"),
         "--save_path", osp.join(w, "DSRG_result_final.txt"), "--class_num", "21"]
    )
    print(f"[recipe] evaluate: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
