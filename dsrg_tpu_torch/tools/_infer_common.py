"""Shared main loop of the inference CLIs (``dsrg_tpu/tools/_infer_common.py``).

Mirrors the main loops of ``training/tools/test*.py``: iterate an id list,
predict a mask per image, write ``<id>.png`` to the output dir.  The flags
are the JAX CLI's, so one argv drives either package, plus ``--device``
(``cuda`` by default, ``cpu`` for the plain versions of the kernels; no
fallback from one to the other).  Images are read by their content through
``utils/imageio.py``.  Each run ends with a line of images per second and a
line of the port's kernel launches (``kernel launches: {...}``).
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import time
from typing import Optional, Sequence

import numpy as np

from dsrg_tpu_torch._device import disable_tf32, resolve_device
from dsrg_tpu_torch.inference import Predictor
from dsrg_tpu_torch.models import FAMILIES
from dsrg_tpu_torch.train.checkpoint import load_params
from dsrg_tpu_torch.utils.imageio import read_image_rgb
from dsrg_tpu_torch.utils.palette import write_png
from dsrg_tpu_torch.utils.profiling import kernel_launches


def build_arg_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--images", dest="image_list", required=True, help="id list file")
    p.add_argument("--dir", dest="data_dir", required=True, help="VOC root (with JPEGImages/)")
    p.add_argument("--model", dest="model", required=True, help="params file (train.py's step_N_params)")
    p.add_argument("--net", dest="net", default=None, help="unused (prototxt parity flag)")
    p.add_argument("--output", dest="output_dir", default="", help="output png dir")
    p.add_argument("--smooth", dest="smooth", action="store_true", help="CRF post-processing")
    p.add_argument("--gpu", dest="gpu_id", default=0, type=int, help="unused (parity flag)")
    p.add_argument("--num-classes", "--class", dest="num_classes", default=21,
                   type=int, help="--class kept as the reference's COCO-tool "
                                  "spelling (test-coco.py:37)")
    p.add_argument("--model-name", choices=sorted(FAMILIES), default="vgg16",
                   help="backbone family")
    p.add_argument("--batch", default=8, type=int,
                   help="images per batched forward/CRF chunk (1 = reference-style serial)")
    p.add_argument("--bucket", default=1, type=int,
                   help="pad inputs up to multiples of this before the forward; "
                        "1 (default) = exact per-shape forward like the reference, "
                        ">1 = fewer distinct shapes (masked, so exact)")
    p.add_argument("--engine", default="auto",
                   choices=["auto", "exact", "mmgrid", "lattice", "grid", "native"],
                   help="CRF engine for --smooth (auto = exact below ~8k px, "
                        "matmul grid above; exact = parity at any size; "
                        "lattice = compact lattice, grid = dense bilateral "
                        "grid, native = the host's C++ exact engine). "
                        "With --smooth, engines other than auto/mmgrid force "
                        "serial per-image inference (the batched CRF is the "
                        "masked matmul grid).")
    p.add_argument("--mesh", action="store_true",
                   help="data-parallel the device pipeline over all visible "
                        "devices (each with a replica of the weights; chunks "
                        "pad to a mesh-divisible batch); with --device cpu a "
                        "mesh of the one CPU")
    p.add_argument("--skip-existing", action="store_true",
                   help="skip ids whose output png already exists (resume "
                        "an interrupted dump)")
    p.add_argument("--rss-limit-gb", type=float, default=-1.0,
                   help="host-RSS watchdog: past this many GB, exit 75 after "
                        "the current chunk so a supervisor can relaunch with "
                        "--skip-existing.  -1 = auto (80%% of MemTotal), 0 = off")
    p.add_argument("--stall-limit-min", type=float, default=60.0,
                   help="stall watchdog: exit 75 when no chunk completes "
                        "for this many minutes (wedged device; relaunch with "
                        "--skip-existing resumes).  0 = off")
    p.add_argument("--canvas-bucket", default=32, type=int,
                   help="device pipeline: round the shared chunk canvas up "
                        "to multiples of this (px); datasets with widely "
                        "varying sizes want a large value so that chunks "
                        "share a few canvas shapes")
    p.add_argument("--in-flight", dest="in_flight", default=2, type=int,
                   help="device pipeline: chunks kept in flight (uploads/"
                        "compute/downloads pipelined).  2 (default) keeps the "
                        "device fed through each blocking mask download")
    p.add_argument("--pipeline", default="auto", choices=["auto", "host", "device"],
                   help="batched execution pipeline: device = whole multi-scale "
                        "pass (resize/forward/fuse/CRF/argmax) on the device "
                        "per chunk, uint8 in/out; host = per-stage host round "
                        "trips. auto = device whenever batched: absolute "
                        "sizes are reference-exact, and fractional scales "
                        "mask the shared per-scale canvas inside the net.")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions); "
                        "cuda without a card raises")
    return p


def load_predictor(
    model_path: str, num_classes: int, model_name: str = "vgg16", bucket: int = 1,
    mesh: bool = False, device=None,
) -> Predictor:
    """A fp32 predictor of a params file (a VGG16-LargeFOV, or with
    ``model_name="resnet101"`` a ResNet-101 and its BN statistics) on
    ``device`` (the card by default, with TF32 off as the JAX package
    computes).  ``mesh``: the device pipeline splits each chunk over every
    card of the host (``parallel.make_mesh()``), or over the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        disable_tf32()
    model = FAMILIES[model_name](num_classes=num_classes)
    mesh_obj = None
    if mesh:
        from dsrg_tpu_torch.parallel import make_mesh

        mesh_obj = make_mesh(None if dev.type == "cuda" else [dev])
    return Predictor(model, load_params(model_path), num_classes=num_classes, bucket=bucket, device=dev,
                     mesh=mesh_obj)


def preview_mask(image_rgb: np.ndarray, mask: np.ndarray, num_classes: int) -> None:
    """Interactive (image | mask) preview — the reference test tools' no-
    ``--output`` behavior (``training/tools/test-ms.py:130-139``: ``plt.show``
    of the image beside the VOC-colormapped mask).  Headless backends (Agg)
    make ``plt.show`` a no-op, so scripted runs without a display just
    continue; missing matplotlib degrades to a notice rather than an error."""
    try:
        import matplotlib.pyplot as plt
        from matplotlib.colors import ListedColormap
    except ImportError:
        print("(no matplotlib: pass --output to write pngs)", flush=True)
        return
    from dsrg_tpu_torch.utils.palette import VOC_PALETTE

    pal = np.asarray(VOC_PALETTE, np.float64) / 255.0
    cmap = ListedColormap(pal[: max(num_classes, 2)])
    fig = plt.figure()
    ax = fig.add_subplot(1, 2, 1)
    ax.imshow(image_rgb)
    ax.set_axis_off()
    ax = fig.add_subplot(1, 2, 2)
    ax.matshow(mask, vmin=0, vmax=num_classes, cmap=cmap)
    ax.set_axis_off()
    plt.show()
    plt.close(fig)


def resolve_pipeline(args, sizes, scales, exact_canvas: bool = False):
    """(engine, chunk, pipeline, use_device) from the shared CLI flags.

    One dispatch rule for every eval tool: a non-mmgrid CRF engine only
    matters under ``--smooth`` and then forces serial per-image inference
    (the batched/device CRF is the masked matmul grid) — contradicting an
    explicit ``--pipeline device`` is an error rather than a silent
    downgrade.  The device pipeline runs whenever batched: absolute sizes
    are reference-exact forwards, and fractional scales are exact too when
    the model masks its canvas internally (``exact_canvas`` — true for both
    in-tree backbones via ``valid_hw``, ``models/masking.py``; residual
    device-vs-host difference is fp reassociation at near-tied argmaxes,
    measured at zero mIoU delta by ``neutrality_study --miou-study``).
    Models without that contract keep the host path for scales under
    ``auto`` because their canvas forward would carry a border perturbation
    — ``exact_canvas`` therefore defaults to the safe False; callers pass
    ``predictor.exact_canvas``.
    """
    engine = getattr(args, "engine", "auto")
    chunk = max(int(getattr(args, "batch", 1)), 1)
    pipeline = getattr(args, "pipeline", "auto")
    if getattr(args, "smooth", False) and engine not in ("auto", "mmgrid"):
        if pipeline == "device":
            raise SystemExit(
                f"--pipeline device smooths with the mmgrid engine; drop "
                f"--engine {engine} or use --pipeline host"
            )
        chunk = 1
    use_device = pipeline != "host" and (
        sizes is not None
        or (scales is not None and (pipeline == "device" or exact_canvas))
    ) and (chunk > 1 or pipeline == "device")
    return engine, chunk, pipeline, use_device


def report(n_images: int, t0: float) -> None:
    """The run's closing lines: images per second and kernel launches."""
    dt = time.perf_counter() - t0
    print(f"{n_images} images in {dt:.2f} s ({n_images / dt if dt > 0 else float('nan'):.2f} images/s)",
          flush=True)
    print("kernel launches: " + json.dumps(kernel_launches()), flush=True)


def run_inference(
    args,
    sizes: Optional[Sequence[int]] = None,
    scales: Optional[Sequence[float]] = None,
) -> None:
    predictor = load_predictor(
        args.model, args.num_classes, getattr(args, "model_name", "vgg16"),
        bucket=int(getattr(args, "bucket", 1)), mesh=bool(getattr(args, "mesh", False)),
        device=getattr(args, "device", "cuda"),
    )
    image_ids = [ln.strip() for ln in open(args.image_list) if ln.strip()]
    data_dir = osp.join(args.data_dir, "JPEGImages")
    if args.output_dir and not osp.isdir(args.output_dir):
        os.makedirs(args.output_dir)
    from dsrg_tpu_torch.utils import watchdog

    if getattr(args, "skip_existing", False) and args.output_dir:
        _, image_ids = watchdog.split_existing(
            image_ids, lambda i: osp.join(args.output_dir, i + ".png")
        )
    engine, chunk, pipeline, use_device = resolve_pipeline(
        args, sizes, scales, exact_canvas=predictor.exact_canvas
    )

    rss_limit, stall = watchdog.arm(args, persist=bool(args.output_dir),
                                    describe="inference-chunk")

    def _maybe_restart(done: int) -> None:
        watchdog.maybe_restart(rss_limit, done, len(image_ids))

    def _load(i):
        return read_image_rgb(osp.join(data_dir, i + ".jpg"))

    def _emit(img_id, image, mask):
        if args.output_dir:
            write_png(mask, osp.join(args.output_dir, img_id + ".png"))
        else:
            preview_mask(image, mask, args.num_classes)

    t0 = time.perf_counter()
    try:
        if use_device:
            # device-resident streaming pipeline: uint8 canvases up, uint8
            # masks down, --in-flight chunks pipelined; reference-exact for
            # absolute sizes (every image forwards at exactly (s, s))
            stream = predictor.iter_masks_device(
                (_load(i) for i in image_ids),
                sizes=sizes,
                scales=scales,
                chunk=chunk,
                smooth=args.smooth,
                canvas_bucket=int(getattr(args, "canvas_bucket", 32)),
                in_flight=int(getattr(args, "in_flight", 2)),
            )
            for n, (img_id, (img, mask)) in enumerate(zip(image_ids, stream)):
                print(n, img_id, flush=True)
                _emit(img_id, img, mask)
                stall.tick()
                if (n + 1) % max(chunk, 1) == 0:
                    _maybe_restart(n + 1)
        else:
            for start in range(0, len(image_ids), chunk):
                ids = image_ids[start: start + chunk]
                print(start, " ".join(ids), flush=True)
                images = [_load(i) for i in ids]
                if chunk == 1:
                    masks = [
                        predictor.predict_mask(
                            images[0], sizes=sizes, scales=scales, smooth=args.smooth,
                            crf_engine=engine,
                        )
                    ]
                else:
                    masks = predictor.predict_masks(
                        images, sizes=sizes, scales=scales, smooth=args.smooth,
                        canvas_bucket=int(getattr(args, "canvas_bucket", 32)),
                    )
                for img_id, image, mask in zip(ids, images, masks):
                    _emit(img_id, image, mask)
                stall.tick()
                _maybe_restart(start + len(ids))
    finally:
        stall.close()
        predictor.close()
    report(len(image_ids), t0)
