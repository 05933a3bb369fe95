"""Smoke run of the PyTorch + CUDA port (``dsrg_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit; TF32 off (the reference computes fp32);
  2. build every CUDA kernel of the serving path from ``dsrg_tpu_torch/csrc``;
  3. each kernel against its plain PyTorch version on the card, at the shapes
     the serving path gives it (8 images of 500x375 on a 512x384 canvas:
     1040 tiles of 1600 pixels, gc = 21, C = 21 and C = 1), timed beside the
     plain version, one library call and the card's bound;
  4. the serving path itself: ``Predictor.predict_masks_device`` with the
     21-class, 4-head VGG16-LargeFOV (random weights from a numpy seed) on 8
     synthetic 500x375 images, in sizes mode (241, 321, 401) and in scales
     mode (0.75, 1, 1.25), both with the dense CRF; the kernels' launch
     counts prove the path went through them;
  5. the same pipeline on a small input on the card and on the CPU (plain
     versions), whose masks must agree.
The last lines are a JSON line of kernels, the card's name and power limit,
and ``{"ok": true, "device": {...}}``.  Exits non-zero without that line when
there is no CUDA device or no ``dsrg_tpu_torch`` beside this file.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
N_IMAGES, IMG_H, IMG_W = 8, 375, 500
SIZES, SCALES = (241, 321, 401), (0.75, 1.0, 1.25)
PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s (data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
TOL = 1e-5  # x max|plain|: the kernels differ from the plain versions in fp32 summation order only


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _images(rng, n, h, w):
    """Synthetic photos: a few flat colour regions plus noise."""
    out = []
    for _ in range(n):
        img = np.empty((h, w, 3), np.int32)
        img[:] = rng.integers(0, 255, 3)
        for _ in range(4):
            y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
            img[y0: y0 + rng.integers(h // 8, h // 2), x0: x0 + rng.integers(w // 8, w // 2)] = rng.integers(0, 255, 3)
        out.append(np.clip(img + rng.integers(-12, 12, img.shape), 0, 255).astype(np.uint8))
    return out


def _weights(model, rng) -> dict:
    """He-normal convolutions, N(0, 0.01) classifiers, zero biases."""
    out = {}
    for name, t in model.state_dict().items():
        if name.endswith(".bias"):
            out[name] = np.zeros(t.shape, np.float32)
        else:
            std = 0.01 if name.startswith("fc8") else float(np.sqrt(2.0 / np.prod(t.shape[1:])))
            out[name] = (rng.standard_normal(t.shape) * std).astype(np.float32)
    return out


def _kernel_phase(mk, tmm, dev, rng) -> dict:
    """Each kernel vs its plain version at the serving path's shapes."""
    guide = torch.from_numpy(np.stack(_images(rng, N_IMAGES, 384, 512))).to(dev)
    plan = tmm.MMGridPlan(guide, 80.0, 13.0)
    wbg, wr = plan.wbg, plan.wr_t_bf16
    t, px, nb = wbg.shape
    gc = plan.gc
    print(f"kernel shapes: T={t} px={px} B={nb} gc={gc}", flush=True)
    rows = {}
    for c in (21, 1):
        q = gc * c
        values = torch.from_numpy(rng.random((t, c, px), dtype=np.float32)).to(dev)
        slab = mk.padded_empty((t, nb, q), torch.bfloat16, dev)  # the plan's layout
        slab.copy_(torch.from_numpy(rng.standard_normal((t, nb, q), dtype=np.float32)))
        slab_c, wbg_c = slab.contiguous(), wbg.contiguous()
        u = (wr.float()[:, :, None, :] * values.bfloat16().float()[:, None]).bfloat16()
        u = u.reshape(t, q, px).transpose(1, 2).contiguous()
        wbg_t = wbg.transpose(1, 2).contiguous()
        gemm_flop = 2.0 * t * px * nb * q
        cases = {
            "mmgrid_splat": (
                lambda: mk.splat(wbg, values, wr), lambda: mk.splat_plain(wbg, values, wr),
                lambda: torch.bmm(wbg_t, u),
                2 * t * px * nb + 4 * t * c * px + 2 * t * gc * px + 4 * t * nb * q),
            "mmgrid_slice": (
                lambda: mk.slice(wbg, slab, wr), lambda: mk.slice_plain(wbg, slab, wr),
                lambda: torch.bmm(wbg_c, slab_c),
                2 * t * px * nb + 2 * t * nb * q + 2 * t * gc * px + 4 * t * c * px),
        }
        for name, (kern, plain, lib, nbytes) in cases.items():
            got = kern()
            ref = plain()
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            tol = TOL * ref.abs().max().item()
            ok = bool(torch.isfinite(got).all().item()) and err <= tol
            print(f"{name} C={c}: max_abs_err {err:.3e} (tolerance {tol:.3e}) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise SystemExit(f"{name} disagrees with its plain version at C={c}")
            del got, ref
            ms = _time_ms(kern, 10)
            plain_ms = _time_ms(plain, 3)
            lib_ms = _time_ms(lib, 10)
            bound_by = "bytes" if nbytes / PEAK_BYTES > gemm_flop / PEAK_BF16 else "operations"
            bound_ms = 1e3 * max(nbytes / PEAK_BYTES, gemm_flop / PEAK_BF16)
            print(f"{name} C={c}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.bmm "
                  f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
                  f"{gemm_flop / ms / 1e9:.1f} TFLOP/s", flush=True)
            if c == 21:
                rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                  bound_by=bound_by, library_ms=lib_ms)
        del values, slab, u, wbg_t, slab_c, wbg_c
    del plan, guide
    torch.cuda.empty_cache()
    return rows


def _profile_phase(predictor, images, out_dir: Path) -> None:
    """One sizes-mode chunk under torch.profiler: device time by kernel group."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predictor.predict_masks_device(images, sizes=SIZES)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    groups: dict = {}
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = evt.self_device_time_total / 1e3
        name = evt.key.lower()
        if "splat_kernel" in name:
            group = "mmgrid_splat"
        elif "slice_kernel" in name:
            group = "mmgrid_slice"
        elif any(k in name for k in ("conv", "fprop", "implicit", "winograd", "cudnn", "fft")):
            group = "convolution"
        elif "gemm" in name:
            group = "gemm"
        else:
            group = "other"
        groups[group] = groups.get(group, 0.0) + ms
        kernels.append((ms, evt.count, evt.key))
    busy = sum(groups.values())
    if busy == 0.0:
        print("profile: the profiler recorded no device time", flush=True)
        return
    print(f"profile (sizes mode, one chunk, under the profiler): wall {wall_ms:.1f} ms, device busy "
          f"{busy:.1f} ms, idle share {max(0.0, 1.0 - busy / wall_ms):.3f}", flush=True)
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {group}: {ms:.2f} ms ({ms / busy:.3f} of device time)", flush=True)
    kernels.sort(reverse=True)
    for ms, count, key in kernels[:12]:
        print(f"    {ms:9.2f} ms  x{count:<5d} {key[:110]}", flush=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "chip_smoke_profile.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from dsrg_tpu_torch import _build
    from dsrg_tpu_torch.inference import Predictor
    from dsrg_tpu_torch.models import DeepLabLargeFOV
    from dsrg_tpu_torch.ops.crf import mmgrid as tmm
    from dsrg_tpu_torch.ops.crf import mmgrid_kernels as mk

    smi = _smi()
    print(f"card: {smi}", flush=True)
    print("torch", torch.__version__, "cuda", torch.version.cuda, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # a server's canvases come in a few bucketed shapes: let cuDNN time its
    # algorithms once per shape (the warm-up chunk) instead of guessing
    torch.backends.cudnn.benchmark = True
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    t0 = time.perf_counter()
    logs = _build.build(mk.KERNELS)
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    rows = _kernel_phase(mk, tmm, dev, rng)

    model = DeepLabLargeFOV(num_classes=21)
    params = _weights(model, rng)
    predictor = Predictor(model, params, num_classes=21, device="cuda")
    images = _images(rng, N_IMAGES, IMG_H, IMG_W)
    launches = {"mmgrid_splat": 0, "mmgrid_slice": 0}
    for mode in ({"sizes": SIZES}, {"scales": SCALES}):
        predictor.predict_masks_device(images, **mode)  # warm-up: cuDNN plans, first launches
        torch.cuda.synchronize()
        mk.splat.launches = mk.slice.launches = 0
        t0 = time.perf_counter()
        masks = predictor.predict_masks_device(images, **mode)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {"mmgrid_splat": mk.splat.launches, "mmgrid_slice": mk.slice.launches}
        print(f"main path {mode}: {1e3 * dt:.1f} ms/chunk of {N_IMAGES}, "
              f"{N_IMAGES / dt:.2f} images/s, launches {counts}", flush=True)
        # one chunk: 1 mask normalisation + 10 mean-field iterations, one launch each
        if counts != {"mmgrid_splat": 11, "mmgrid_slice": 11}:
            raise SystemExit(f"kernel launches {counts}, expected 11 of each")
        for k in launches:
            launches[k] += counts[k]
        for im, m in zip(images, masks):
            if m.shape != im.shape[:2] or m.dtype != np.uint8 or int(m.max()) >= 21:
                raise SystemExit(f"bad mask: {m.shape} {m.dtype} max {m.max()}")
        print(f"  classes present: {sorted(set(np.unique(np.concatenate([m.ravel() for m in masks])).tolist()))}",
              flush=True)

    _profile_phase(predictor, images, Path(__file__).resolve().parent / "chiprun_out")

    # the same pipeline on a small input, on the card and on the CPU (plain versions), must agree
    small = _images(rng, 2, 72, 96)
    cpu_pred = Predictor(DeepLabLargeFOV(num_classes=21), params, num_classes=21, device="cpu")
    for mode in ({"sizes": (41, 57)}, {"scales": (0.75, 1.0)}):
        on_card = predictor.predict_masks_device(small, canvas_bucket=16, **mode)
        on_cpu = cpu_pred.predict_masks_device(small, canvas_bucket=16, **mode)
        agree = min(float((a == b).mean()) for a, b in zip(on_card, on_cpu))
        print(f"card vs CPU masks {mode}: agreement {agree:.5f}", flush=True)
        if agree <= 0.99:
            raise SystemExit("the card's masks disagree with the CPU's")

    kernels = [
        {"name": "mmgrid_splat", "route": "cuda", "source": "dsrg_tpu_torch/csrc/mmgrid_splat.cu",
         "replaces": "dsrg_tpu/ops/crf/pallas_mmgrid.py:112", "launches": launches["mmgrid_splat"],
         **rows["mmgrid_splat"]},
        {"name": "mmgrid_slice", "route": "cuda", "source": "dsrg_tpu_torch/csrc/mmgrid_slice.cu",
         "replaces": "dsrg_tpu/ops/crf/pallas_mmgrid.py:87", "launches": launches["mmgrid_slice"],
         **rows["mmgrid_slice"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
