"""CRF-engine mIoU-neutrality study on photo-statistics inputs
(``dsrg_tpu/tools/neutrality_study.py``).

VOC is not in the repository, so engine neutrality is measured on synthetic
*photo-like* inputs (piecewise-constant colour regions with smooth shading,
texture noise and CNN-like blurred, corrupted unaries) at production
geometry (500x375, 21 classes, 10 iterations, the inference
parameterisation sf=1.0).  The oracle is the native permutohedral engine on
the host (``native.crf_permutohedral``), the algorithm of the reference's
``CRF/src/permutohedral.cpp``, so "agreement with the oracle" reads as
agreement with the reference pipeline's CRF.  The mmgrid, lattice and grid
engines run on ``--device`` (the card by default).

Also: the train-geometry ``crf_fast`` question (bf16 against fp32 exact
mean field at 41^2 x 21 and its effect on the grown seeds), the device
pipeline against the host pipeline with a trained model
(``--pipeline-study``) and the two pipelines' mIoU on a val set
(``--miou-study``).

Run: ``python -m dsrg_tpu_torch.tools.neutrality_study [--images N] [--size H W]``
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import tempfile
import time

import numpy as np
import torch

from dsrg_tpu_torch._device import resolve_device


def make_photo_like(rng, h, w, n_regions=8, n_classes=21):
    """Piecewise-constant regions + smooth shading + noise, and CNN-ish unaries."""
    from scipy.ndimage import gaussian_filter, zoom

    # voronoi regions
    seeds = rng.uniform(0, 1, size=(n_regions, 2)) * [h, w]
    ys, xs = np.mgrid[0:h, 0:w]
    d = (ys[None] - seeds[:, 0, None, None]) ** 2 + (xs[None] - seeds[:, 1, None, None]) ** 2
    region = np.argmin(d, axis=0)
    region_colors = rng.uniform(30, 225, size=(n_regions, 3)).astype(np.float32)
    img = region_colors[region]
    # smooth shading field
    low = rng.uniform(-30, 30, size=(6, 8, 3)).astype(np.float32)
    shade = zoom(low, (h / 6, w / 8, 1), order=1)[:h, :w]
    img = np.clip(img + shade + rng.normal(size=img.shape) * 6, 0, 255).astype(np.float32)

    # CNN-like unaries: region class + blur + corruption
    cls_of_region = rng.integers(0, n_classes, size=n_regions)
    label = cls_of_region[region]
    logits = np.zeros((h, w, n_classes), np.float32)
    logits[ys, xs, label] = 3.0
    logits = gaussian_filter(logits, sigma=(8, 8, 0))
    logits += rng.normal(size=logits.shape).astype(np.float32) * 0.4
    e = np.exp(logits - logits.max(-1, keepdims=True))
    probs = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    return img, np.maximum(probs, 1e-5), label


def engine_neutrality(n_images=3, h=375, w=500, m=21, seed=0, device=None):
    """Argmax agreement and mean |dQ| of each engine on ``device`` against
    the native permutohedral oracle on the host, with each engine's wall ms
    per image (the first image includes its first-call costs)."""
    from dsrg_tpu_torch import native
    from dsrg_tpu_torch.ops.crf.grid import mean_field_grid
    from dsrg_tpu_torch.ops.crf.lattice import mean_field_lattice
    from dsrg_tpu_torch.ops.crf.mmgrid import mean_field_mmgrid

    dev = resolve_device(device)
    engines = {"mmgrid": mean_field_mmgrid, "lattice": mean_field_lattice, "grid": mean_field_grid}

    rng = np.random.default_rng(seed)
    rows = {k: {"agree": [], "mad": [], "ms": []} for k in engines}
    oracle_ms = []
    for _ in range(n_images):
        img, probs, _ = make_photo_like(rng, h, w)
        unary = np.log(probs)
        t0 = time.perf_counter()
        q_ref = native.crf_permutohedral(img, unary, maxiter=10, scale_factor=1.0)
        oracle_ms.append((time.perf_counter() - t0) * 1000)
        a_ref = q_ref.argmax(-1)
        for name, fn in engines.items():
            t0 = time.perf_counter()
            with torch.inference_mode():
                q = fn(torch.from_numpy(unary).to(dev), torch.from_numpy(img).to(dev), n_iters=10).cpu().numpy()
            dt = (time.perf_counter() - t0) * 1000
            rows[name]["agree"].append(float((q.argmax(-1) == a_ref).mean()))
            rows[name]["mad"].append(float(np.abs(q - q_ref).mean()))
            rows[name]["ms"].append(dt)
    out = {
        "geometry": f"{h}x{w}x{m}, 10 iters, sf=1.0",
        "oracle": "native permutohedral (reference algorithm), "
        f"{np.mean(oracle_ms):.0f} ms/image host",
        "n_images": n_images,
    }
    for name, r in rows.items():
        out[name] = {
            "argmax_agreement_vs_reference_algo": round(float(np.mean(r["agree"])), 5),
            "mean_abs_marginal_diff": round(float(np.mean(r["mad"])), 6),
            "wall_ms_per_image_incl_compile_first": [round(x, 1) for x in r["ms"]],
        }
    return out


def crf_fast_neutrality(n_batches=4, batch=8, h=41, m=21, seed=0, device=None):
    """bf16 vs fp32 train-geometry CRF: effect on the grown seeds."""
    from dsrg_tpu_torch.ops.crf.api import crf_refine_probs
    from dsrg_tpu_torch.ops.grow import dsrg_grow

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    diffs, seed_mismatch = [], []
    for _ in range(n_batches):
        imgs, probs, labels_l = [], [], []
        for _ in range(batch):
            img, p, label = make_photo_like(rng, h, h, n_regions=4, n_classes=m)
            imgs.append(img)
            probs.append(p)
            lab = np.zeros(m, np.float32)
            lab[np.unique(label)] = 1.0
            lab[0] = 1.0
            labels_l.append(lab)
        imgs = torch.from_numpy(np.stack(imgs) - 127.0).to(dev)  # mean-subtracted-ish guide
        probs = torch.from_numpy(np.stack(probs)).to(dev)
        labels = np.stack(labels_l)
        cues = (rng.uniform(size=(batch, h, h, m)) < 0.02).astype(np.float32)
        cues *= labels[:, None, None, :]
        labels_t, cues_t = torch.from_numpy(labels).to(dev), torch.from_numpy(cues).to(dev)

        with torch.inference_mode():
            q32 = crf_refine_probs(probs, imgs, fast=False)
            q16 = crf_refine_probs(probs, imgs, fast=True)
            diffs.append(float((q32 - q16).abs().mean()))
            g32 = dsrg_grow(labels_t, cues_t, q32)
            g16 = dsrg_grow(labels_t, cues_t, q16)
            seed_mismatch.append(float((g32 != g16).float().mean()))
    return {
        "geometry": f"batch {batch} @ {h}x{h}x{m}, sf=12, 10 iters",
        "n_batches": n_batches,
        "mean_abs_marginal_diff_bf16_vs_fp32": round(float(np.mean(diffs)), 6),
        "grown_seed_disagreement_rate": round(float(np.mean(seed_mismatch)), 6),
    }


def pipeline_neutrality(model_path: str, n_images: int = 12, h: int = 375, w: int = 500,
                        scales=(0.75, 1.0, 1.25), smooth: bool = True, model_name: str = "vgg16",
                        seed: int = 0, device=None):
    """The scales-mode device pipeline against the serial per-image host
    pipeline (``test-ms-f.py:115-130``): mask agreement on photo-statistics
    inputs at production sizes with a TRAINED model (random weights make the
    argmax noise-dominated).  Both forwards are exact on their canvases
    (``models/masking.py``); what remains is summation order in the zooms
    at near-tied argmaxes."""
    import dataclasses

    from dsrg_tpu_torch.data.synth import PROFILES, make_image
    from dsrg_tpu_torch.tools._infer_common import load_predictor

    predictor = load_predictor(model_path, 21, model_name, device=device)
    rng = np.random.default_rng(seed)
    spec = dataclasses.replace(PROFILES["voc"], size_min=min(h, w), size_max=max(h, w))
    imgs = []
    for i in range(n_images):
        if i % 2 == 0:
            img, _ = make_image(rng, spec)  # the model's native statistics
        else:
            img, _, _ = make_photo_like(rng, h, w)
            img = np.clip(img, 0, 255).astype(np.uint8)
        imgs.append(img)

    agree, host_ms, dev_ms = [], [], []
    try:
        t0 = time.perf_counter()
        dev_masks = predictor.predict_masks_device(imgs, scales=list(scales), smooth=smooth)
        dev_ms.append((time.perf_counter() - t0) * 1000 / len(imgs))
        for img, dm in zip(imgs, dev_masks):
            t0 = time.perf_counter()
            hm = predictor.predict_mask(img, scales=list(scales), smooth=smooth)
            host_ms.append((time.perf_counter() - t0) * 1000)
            agree.append(float((hm == dm).mean()))
    finally:
        predictor.close()
    return {
        "geometry": f"{n_images} images ~{h}x{w}, scales {list(scales)}, smooth={smooth}",
        "mask_agreement_mean": round(float(np.mean(agree)), 6),
        "mask_agreement_min": round(float(np.min(agree)), 6),
        "per_image_agreement": [round(a, 5) for a in agree],
        "host_serial_ms_per_image": round(float(np.mean(host_ms)), 1),
        "device_pipeline_ms_per_image_incl_compile": round(float(np.mean(dev_ms)), 1),
    }


def pipeline_miou_study(model_path: str, data_root: str, work_dir: str, scales=(0.75, 1.0, 1.25),
                        smooth: bool = True, model_name: str = "vgg16", batch: int = 8,
                        num_classes: int = 21, bucket: int = 64, canvas_bucket: int = 512,
                        device: str = "cuda"):
    """Device-vs-host final-eval mIoU on a val set with ground truth: the
    test-ms-f workload over ``data_root``'s ``val_id.txt`` once per
    pipeline (``--pipeline host`` and ``device``), each evaluated against
    ``SegmentationClass``; reports both mIoUs (the reference's and the
    honest ``miou3``), their deltas and the per-image mask agreement.
    ``data_root`` is a synth_check-layout tree (JPEGImages/,
    SegmentationClass/, val_id.txt)."""
    from dsrg_tpu_torch.tools import evaluate as evaluate_tool
    from dsrg_tpu_torch.tools._infer_common import build_arg_parser, run_inference
    from dsrg_tpu_torch.tools.synth_check import _miou_fg
    from dsrg_tpu_torch.utils.palette import read_mask_png

    ids_file = osp.join(data_root, "val_id.txt")
    out = {"geometry": f"scales {list(scales)}, smooth={smooth}, batch {batch}", "val_ids": ids_file}
    pred_dirs = {}
    for pipeline in ("host", "device"):
        pred_dir = osp.join(work_dir, f"preds_{pipeline}")
        argv = [
            "--images", ids_file, "--dir", data_root, "--model", model_path,
            "--output", pred_dir, "--batch", str(batch),
            "--model-name", model_name, "--pipeline", pipeline,
            "--num-classes", str(num_classes),
            # bucketed forwards are exact with the masked canvas and bound
            # the number of forward shapes on a val set of varied sizes
            "--bucket", str(bucket), "--canvas-bucket", str(canvas_bucket), "--device", device,
        ] + (["--smooth"] if smooth else [])
        t0 = time.perf_counter()
        run_inference(build_arg_parser("").parse_args(argv), scales=list(scales))
        wall = time.perf_counter() - t0
        miou = evaluate_tool.main([
            "--pred", pred_dir, "--gt", osp.join(data_root, "SegmentationClass"),
            "--test_ids", ids_file, "--save_path", osp.join(work_dir, f"result_{pipeline}.txt"),
            "--class_num", str(num_classes),
        ])
        out[f"miou_{pipeline}"] = round(miou, 5)
        # honest variant: mean over bg + fg classes present in the val gt
        out[f"miou_honest_{pipeline}"] = _miou_fg(data_root, pred_dir, n_classes=num_classes)["miou3"]
        out[f"wall_s_{pipeline}"] = round(wall, 1)
        pred_dirs[pipeline] = pred_dir

    ids = [ln.strip() for ln in open(ids_file) if ln.strip()]
    agree = [float(np.mean(read_mask_png(osp.join(pred_dirs["host"], i + ".png"))
                           == read_mask_png(osp.join(pred_dirs["device"], i + ".png")))) for i in ids]
    out["miou_delta_device_minus_host"] = round(out["miou_device"] - out["miou_host"], 5)
    out["miou_honest_delta_device_minus_host"] = round(out["miou_honest_device"] - out["miou_honest_host"], 5)
    out["mask_agreement_mean"] = round(float(np.mean(agree)), 6)
    out["mask_agreement_min"] = round(float(np.min(agree)), 6)
    out["n_val"] = len(ids)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--images", type=int, default=3)
    p.add_argument("--size", type=int, nargs=2, default=[375, 500])
    p.add_argument("--skip-fast", action="store_true")
    p.add_argument("--pipeline-study", action="store_true",
                   help="scales-mode device-vs-host pipeline mask agreement "
                        "(requires --model)")
    p.add_argument("--miou-study", action="store_true",
                   help="device-vs-host final-eval mIoU delta on a val set "
                        "with GT (requires --model and --data-root)")
    p.add_argument("--model", default=None, help="trained params file")
    p.add_argument("--data-root", default=None,
                   help="synth_check-layout dataset root for --miou-study")
    p.add_argument("--work-dir", default=osp.join(tempfile.gettempdir(), "pipe_miou"),
                   help="prediction/result output dir for --miou-study")
    p.add_argument("--no-smooth", action="store_true",
                   help="--miou-study: skip the CRF smoothing pass")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--model-name", default="vgg16", choices=["vgg16", "resnet101"])
    p.add_argument("--scales", type=float, nargs="+", default=[0.75, 1.0, 1.25])
    p.add_argument("--device", default="cuda",
                   help="where the engines and models run: cuda (default) or "
                        "cpu (the plain versions); the oracle runs on the host")
    args = p.parse_args(argv)

    if args.miou_study:
        if not (args.model and args.data_root):
            p.error("--miou-study requires --model and --data-root")
        import os

        os.makedirs(args.work_dir, exist_ok=True)
        report = {"pipeline_miou": pipeline_miou_study(
            args.model, args.data_root, args.work_dir, scales=args.scales, smooth=not args.no_smooth,
            model_name=args.model_name, batch=args.batch, device=args.device)}
        print(json.dumps(report, indent=2))
        return

    if args.pipeline_study:
        if not args.model:
            p.error("--pipeline-study requires --model")
        report = {"pipeline": pipeline_neutrality(args.model, max(args.images, 4), *args.size,
                                                  scales=args.scales, model_name=args.model_name,
                                                  device=args.device)}
        print(json.dumps(report, indent=2))
        return

    report = {"engines": engine_neutrality(args.images, *args.size, device=args.device)}
    if not args.skip_fast:
        report["crf_fast"] = crf_fast_neutrality(device=args.device)
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
