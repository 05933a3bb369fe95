"""Smoke run of the PyTorch + CUDA port (``dsrg_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit; TF32 off (the reference computes fp32);
  2. build every CUDA kernel of the port from ``dsrg_tpu_torch/csrc``, one
     nvcc per source, all started together;
  3. the mmgrid kernels against their plain PyTorch versions on the card, at
     the shapes the serving path gives them (8 images of 500x375 on a
     512x384 canvas: 1040 tiles of 1600 pixels, gc = 21, C = 21 and C = 1)
     on a photo-like guide and, at C = 21, on a pixel-noise guide (no two
     pixels of a tile share their colour bins), and on a small
     ``spatial_exact`` plan (corner-scaled r weights), each launched twice
     for equal bits; timed beside the plain version, ``torch.bmm`` on the
     dense operands and the card's bound for the bytes the sparse kernel
     must move; the plan's build time and that of the dense operands; then
     at the pseudo ground truth's shapes: one unmasked 500x375 image (130
     tiles, fewer than the card's 132 SMs) and ``predict_masks``' CRF batch
     (4 images on a 512x384 canvas, values masked to the images);
  4. the pool backward kernels against their plain versions at the five max
     pools of the stage-1 step (batch 20 @ 321^2) and of the stage-2 step
     (batch 10), on integer inputs full of ties: with integer cotangents
     (the error must be 0, and ATen's routing must agree), with
     normal-distributed cotangents (equal bits: only the sum over taps in
     the order t = 0..k-1 gives them) and with NaN and +-inf in inputs and
     cotangents; timed the same way, with the bytes moved, the achieved
     GB/s, each block's shared memory, and (batch 20) pool1 at other tile
     sizes; the kernels' line reports batch 20;
  5. the serving path: ``Predictor.predict_masks_device`` with the 21-class,
     4-head VGG16-LargeFOV (random weights from a numpy seed) on 8 synthetic
     500x375 images, in sizes mode (241, 321, 401) and in scales mode
     (0.75, 1, 1.25), both with the dense CRF; the kernels' launch counts
     prove the path went through them and the count of ``dense_operands``
     calls that it never built the dense form; then the same pipeline on a small
     input on the card and on the CPU (plain versions), whose masks must
     agree;
  6. the stage-1 train step, the serving predictor freed: ``init_stage1`` +
     ``make_stage1_step`` with the default ``Stage1Config`` (batch 20 @
     321^2, 21 classes, 4 heads, exact CRF at 41^2, fp32) on a synthetic
     batch; 2 warm-up and 5 timed steps
     with finite losses and 5 + 5 pool kernel launches per step, one step
     under the profiler, one with the region growing timed; then one tiny
     step from the same weights on the card and on the CPU, which must agree;
  7. the pseudo ground truth (``tools/generate_train_gt.py``): a predictor of
     the serving phase's net and weights, ``Predictor.predict_mask(sizes=[321],
     restrict_labels=...)`` on 8 synthetic 500x375 images with label sets
     (background and two classes) read back through ``CueDB``; the CRF's
     ``auto`` engine takes the mmgrid kernels there, 11 + 11 launches per
     image; ms/image split into host work, forward and CRF; then
     ``predict_masks`` (crf_batch 4: 22 + 22 launches per 8 images), whose
     masks must agree with the per-image ones; then ``predict_mask`` at
     72x96 (exact engine) and with the mmgrid engine, card against CPU;
  8. the stage-2 retrain step: ``init_stage2`` + ``make_stage2_step`` with
     the default ``Stage2Config`` (batch 10 @ 321², 21 classes, 4 heads)
     on crops of phase 7's masks with a band of ignore labels; 2 warm-up
     and 5 timed steps with finite metrics and 5 + 5 pool launches per
     step, one step under the profiler; a tiny step card against CPU.
The last lines are a JSON line of kernels, the card's name and power limit,
and ``{"ok": true, "device": {...}}``.  Exits non-zero without that line when
there is no CUDA device or no ``dsrg_tpu_torch`` beside this file.
"""

from __future__ import annotations

import json
import re
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
PEAK_FP32 = 67e12  # H100 SXM fp32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
TOL = 1e-5  # x max|plain|: the kernels differ from the plain versions in fp32 summation order only
TRAIN_BATCH, TRAIN_STEPS = 20, 5
# (channels, H, W, stride) of the five 3x3 pad-1 MAX pools at 321^2
POOLS = ((64, 321, 321, 2), (128, 161, 161, 2), (256, 81, 81, 2), (512, 41, 41, 1),
         (512, 41, 41, 1))
CARD_VS_CPU_RTOL = 1e-3  # fp32 sums in other orders through a VGG step
GT_SIZES = (321,)  # tools/generate_train_gt.py:48-54
STAGE2_BATCH = 10


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _ptxas_summary(log: str) -> list:
    """One line per kernel of a ``-Xptxas -v`` log: its template arguments,
    registers, static shared memory and spills."""
    out = []
    for entry, body in re.findall(r"Compiling entry function '(\S+)'(.*?)(?=ptxas info\s*: Compil|\Z)", log, re.S):
        kernel = re.search(r"\d+([a-z_]+_kernel)(.*)", entry)
        name, rest = (kernel.group(1), kernel.group(2)) if kernel else (entry, "")
        targs = ",".join(re.findall(r"L[ib](\d+)E", rest.split("Ev")[0]))
        used = re.search(r"Used (\d+) registers", body)
        smem = re.search(r"(\d+) bytes smem", body)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", body)
        out.append(f"{name}<{targs}>: {used.group(1) if used else '?'} registers, "
                   f"{smem.group(1) if smem else 0} bytes static shared memory, spills "
                   f"{'/'.join(spill.groups()) if spill else '?'} bytes")
    return out


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


def _hold(what: str, kern, plain) -> float:
    """Fatal unless ``kern()`` gives the same bits twice and agrees with
    ``plain()`` within TOL x max|plain|; returns the max abs error."""
    got, again, ref = kern(), kern(), plain()
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise SystemExit(f"{what}: two launches on the same inputs differ")
    err = (got - ref).abs().max().item()
    tol = TOL * ref.abs().max().item()
    ok = bool(torch.isfinite(got).all().item()) and err <= tol
    print(f"{what}: max_abs_err {err:.3e} (tolerance {tol:.3e}), two launches equal "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"{what} disagrees with its plain version")
    return err


def _kernel_case(mk, tmm, dev, rng, what: str, guide, channels, valid=None) -> tuple:
    """Each mmgrid kernel vs its plain version on a plan of ``guide`` at the
    serving path's shapes, for each channel count; the splat's values zero
    outside ``valid`` (N, H, W) where given, as a masked canvas's are.
    Returns the kernels' rows at C = 21 and the plan's build time in ms."""
    plan = tmm.MMGridPlan(guide, 80.0, 13.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    plan_ms = _time_ms(lambda: tmm.MMGridPlan(guide, 80.0, 13.0), 5)
    plan_peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    sparse = (plan.idx, plan.wbg4, plan.wr2_bf16)
    (t, px), gc = plan.idx.shape, plan.gc
    nb = gc * gc
    kept = sum(x.numel() * x.element_size() for x in (*sparse, plan.wr2, plan.perm)) / 2**20
    print(f"{what} guide: T={t} px={px} B={nb} gc={gc}; plan build {plan_ms:.3f} ms per chunk of "
          f"{guide.shape[0]} (synchronised), peak {plan_peak:.1f} MiB above what was allocated, "
          f"keeps {kept:.1f} MiB of index, order and weights", flush=True)
    # the dense operands, for the torch.bmm yardstick only: what the dense form's plan had to build
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    dense_ms = _time_ms(plan.dense_operands, 3)
    dense_peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    wbg, wr_t = plan.dense_operands()
    print(f"{what} guide: dense_operands of that plan {dense_ms:.3f} ms, peak {dense_peak:.1f} MiB, "
          f"{(wbg.numel() + wr_t.numel()) * 2 / 2**20:.1f} MiB of bf16 operands", flush=True)
    # the slab cells (b, g, r) that some pixel of the tile reaches: what the slice must read
    cells = torch.zeros((t, nb * gc), dtype=torch.bool, device=dev)
    bg, lo_r = (plan.idx & 0xFFFF).long(), (plan.idx >> 16).long()
    for corner in (0, 1, gc, gc + 1):
        for dr in (0, 1):
            cells.scatter_(1, (bg + corner) * gc + lo_r + dr, True)
    reached = int(cells.sum().item())
    print(f"{what} guide: slab cells reached {reached} of {t * nb * gc} ({reached / (t * nb * gc):.4f})",
          flush=True)
    del cells, bg, lo_r
    rows = {}
    for c in channels:
        q = gc * c
        values = torch.from_numpy(rng.random((t, c, px), dtype=np.float32)).to(dev)
        if valid is not None:
            values = values * plan._tile_cf(plan.pad_cf(valid[:, None].float()))
        slab = torch.from_numpy(rng.standard_normal((t, nb, q), dtype=np.float32)).to(dev).bfloat16()
        u = (wr_t.float()[:, :, None, :] * values.bfloat16().float()[:, None]).bfloat16()
        u = u.reshape(t, q, px).transpose(1, 2).contiguous()
        wbg_t = wbg.transpose(1, 2).contiguous()
        gemm_flop = 2.0 * t * px * nb * q  # the dense form multiplies the zeros too
        sparse_flop = 2.0 * t * px * 8 * c  # 4 corners x 2 r bins per pixel and channel, fp32
        weights = 16 * t * px  # idx 4 + wbg4 8 + wr2 4 bytes per pixel
        dense_weights = 2 * t * px * nb + 2 * t * gc * px
        # bytes a kernel must move: its sparse weights, the pixels' order, values
        # in and the fp32 slab out (splat); sparse weights, the reached cells of
        # the bf16 slab in and values out (slice)
        cases = {
            "mmgrid_splat": (
                lambda: mk.splat(*sparse, values, gc, plan.perm), lambda: mk.splat_plain(*sparse, values, gc),
                lambda: torch.bmm(wbg_t, u), 4 * t * px + 4 * t * c * px + 4 * t * nb * q,
                4 * t * c * px + 4 * t * nb * q),
            "mmgrid_slice": (
                lambda: mk.slice(*sparse, slab, gc), lambda: mk.slice_plain(*sparse, slab, gc),
                lambda: torch.bmm(wbg, slab), 2 * reached * c + 4 * t * c * px, 2 * t * nb * q + 4 * t * c * px),
        }
        for name, (kern, plain, lib, io_bytes, dense_io_bytes) in cases.items():
            err = _hold(f"{name} C={c}, {what} guide", kern, plain)
            ms = _time_ms(kern, 20)
            plain_ms = _time_ms(plain, 3)
            lib_ms = _time_ms(lib, 10)
            by_bytes, by_ops = (weights + io_bytes) / PEAK_BYTES, sparse_flop / PEAK_FP32
            bound_by = "bytes" if by_bytes > by_ops else "operations"
            bound_ms = 1e3 * max(by_bytes, by_ops)
            dense_bound_ms = 1e3 * max((dense_weights + dense_io_bytes) / PEAK_BYTES, gemm_flop / PEAK_BF16)
            print(f"{name} C={c}, {what} guide: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.bmm "
                  f"on the dense operands {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
                  f"{(weights + io_bytes) / 1e6:.1f} MB; the dense form's bound {dense_bound_ms:.4f} "
                  f"ms); {(weights + io_bytes) / ms / 1e9:.3f} TB/s", flush=True)
            if c == 21:
                rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                  bound_by=bound_by, library_ms=lib_ms)
        del values, slab, u, wbg_t, cases
    del plan, wbg, wr_t, sparse
    torch.cuda.empty_cache()
    return rows, plan_ms


def _kernel_phase(mk, tmm, dev, rng) -> tuple:
    """The mmgrid kernels at the serving path's shapes, on the photo-like
    guide the main path sees (the kernels' rows and the plan's build time come
    from it) and on pixel noise, where no two pixels of a tile share their
    bins: the two ends of what a photo can ask of them; then on a small
    ``spatial_exact`` plan."""
    guide = torch.from_numpy(np.stack(_images(rng, N_IMAGES, 384, 512))).to(dev)
    rows, plan_ms = _kernel_case(mk, tmm, dev, rng, "photo-like", guide, (21, 1))
    guide = torch.from_numpy(rng.integers(0, 256, (N_IMAGES, 384, 512, 3), dtype=np.uint8)).to(dev)
    _kernel_case(mk, tmm, dev, rng, "pixel-noise", guide, (21,))
    # the pseudo ground truth's CRF: one unmasked image at its own size (a
    # stream of its own, so that the later phases draw what they drew before)
    one = np.random.default_rng(SEED + 1)
    guide = torch.from_numpy(_images(one, 1, IMG_H, IMG_W)[0][None]).to(dev)
    _kernel_case(mk, tmm, dev, one, "one 500x375 image", guide, (21,))
    # predict_masks' CRF batch: 4 such images on the zero 512x384 canvas, masked
    four = np.random.default_rng(SEED + 2)
    canvas = np.zeros((4, 384, 512, 3), np.uint8)
    canvas[:, :IMG_H, :IMG_W] = np.stack(_images(four, 4, IMG_H, IMG_W))
    valid = torch.zeros((4, 384, 512), dtype=torch.bool, device=dev)
    valid[:, :IMG_H, :IMG_W] = True
    _kernel_case(mk, tmm, dev, four, "predict_masks canvas of 4", torch.from_numpy(canvas).to(dev), (21,), valid)

    # corner-scaled r weights: a plan of the spatial_exact path, 16x16-pixel tiles
    guide = torch.from_numpy(np.stack(_images(rng, 2, 72, 96))).to(dev)
    plan = tmm.MMGridPlan(guide, 16.0, 13.0, spatial_exact=True)
    (t, px), gc = plan.idx.shape, plan.gc
    values = torch.from_numpy(rng.random((t, 21, px), dtype=np.float32)).to(dev)
    slab = torch.from_numpy(rng.standard_normal((t, gc * gc, gc * 21), dtype=np.float32)).to(dev).bfloat16()
    for ci, wr2 in enumerate(plan.corner_wr2()):
        ops = (plan.idx, plan.wbg4, wr2)
        _hold(f"mmgrid_splat spatial_exact corner {ci} (T={t} px={px})",
              lambda: mk.splat(*ops, values, gc, plan.perm), lambda: mk.splat_plain(*ops, values, gc))
        _hold(f"mmgrid_slice spatial_exact corner {ci} (T={t} px={px})",
              lambda: mk.slice(*ops, slab, gc), lambda: mk.slice_plain(*ops, slab, gc))
    return rows, plan_ms


def _with_specials(t: torch.Tensor, gen, shares) -> torch.Tensor:
    """A copy of ``t`` with NaN, +inf and -inf at the given shares of places."""
    t = t.clone()
    for value, share in zip((float("nan"), float("inf"), float("-inf")), shares):
        t[torch.rand(t.shape, generator=gen, device=t.device) < share] = value
    return t


def _pool_phase(pk, pooling, dev, batch: int) -> dict:
    """pool_bwd_h / pool_bwd_w vs their plain versions at a train step's
    five pools at ``batch``.  Returns each kernel's row, its times the mean
    per launch over one step's five launches."""
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev).float()

    def normal(shape):
        return torch.randn(shape, generator=gen, device=dev)

    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "op_bound_ms")
    sums = {n: dict.fromkeys(keys, 0.0) for n in ("pool_bwd_h", "pool_bwd_w")}
    err = {n: 0.0 for n in sums}
    forward = {"ms": 0.0, "pad_ms": 0.0}
    for i, (c, h, w, s) in enumerate(POOLS, 1):
        ho, ph = pooling._caffe_pool_geometry(h, 3, s, 1)
        wo, pw = pooling._caffe_pool_geometry(w, 3, s, 1)
        # the library yardstick: ATen's max-pool backward on the -inf padded
        # pass input, through the indices of its own forward (first max)
        x = ints(0, 3, (batch, c, h, w))
        xp = pooling._pad_hw(x, (0, 0), pw, float("-inf"))
        yw_full, idx_w = torch.ops.aten.max_pool2d_with_indices(xp, [1, 3], [1, s])
        yw = yw_full[..., :wo].contiguous()
        ywp = pooling._pad_hw(yw, ph, (0, 0), float("-inf"))
        y_full, idx_h = torch.ops.aten.max_pool2d_with_indices(ywp, [3, 1], [s, 1])
        g, gw = ints(-4, 5, (batch, c, ho, wo)), ints(-4, 5, (batch, c, h, wo))
        g_lib = torch.nn.functional.pad(g, (0, 0, 0, y_full.shape[2] - ho))
        gw_lib = torch.nn.functional.pad(gw, (0, yw_full.shape[3] - wo))
        aten_bwd = torch.ops.aten.max_pool2d_with_indices_backward
        plans = {"pool_bwd_h": pk.plan_h(batch * c, h, wo, ho, 3, s, 1), "pool_bwd_w": pk.plan_w(x[..., 0].numel(), w, wo)}
        # (wrapper, plain version, pass input, integer cotangent, ATen call, crop of its result)
        cases = {
            "pool_bwd_h": (pk.pool_bwd_h, pk.pool_bwd_h_plain, yw, g,
                           lambda: aten_bwd(g_lib, ywp, [3, 1], [s, 1], [0, 0], [1, 1], False, idx_h),
                           lambda out: out[:, :, ph[0]: ph[0] + h]),
            "pool_bwd_w": (pk.pool_bwd_w, pk.pool_bwd_w_plain, x, gw,
                           lambda: aten_bwd(gw_lib, xp, [1, 3], [1, s], [0, 0], [1, 1], False, idx_w),
                           lambda out: out[..., pw[0]: pw[0] + w]),
        }
        # the forward of the same pool: two library max pools, each on a copy padded with -inf
        pads = _time_ms(lambda: pooling._pad_hw(x, (0, 0), pw, float("-inf")), 20) \
            + _time_ms(lambda: pooling._pad_hw(yw, ph, (0, 0), float("-inf")), 20)
        fwd = _time_ms(lambda: pooling.caffe_max_pool_train(x, 3, s, 1), 20)
        print(f"pool{i} (batch {batch}) forward: {fwd:.4f} ms, of which the two F.pad copies to -inf {pads:.4f} ms", flush=True)
        forward["ms"] += fwd
        forward["pad_ms"] += pads
        for name, (wrapper, plain_fn, src, cot, lib, crop) in cases.items():
            def kern(tile_bytes=pk.TILE_BYTES):
                return wrapper(src, cot, 3, s, 1, tile_bytes)

            def plain():
                return plain_fn(src, cot, 3, s, 1)

            plan, n_floats = plans[name], 2 * src.numel() + cot.numel()
            got, again, ref, lib_out = kern(), kern(), plain(), crop(lib())
            torch.cuda.synchronize()
            e = (got - ref).abs().max().item()
            lib_agrees, same = torch.equal(got, lib_out), torch.equal(got, again)
            # normal cotangents: the plain version's bits need its order of summation;
            # then NaN and +-inf in the input (5%, 10%, 30%) and in the cotangent (2% each)
            fcot = normal(cot.shape)
            floats = torch.equal(wrapper(src, fcot, 3, s, 1), plain_fn(src, fcot, 3, s, 1))
            ssrc, scot = _with_specials(src, gen, (0.05, 0.1, 0.3)), _with_specials(fcot, gen, (0.02, 0.02, 0.02))
            sgot, sref = wrapper(ssrc, scot, 3, s, 1), plain_fn(ssrc, scot, 3, s, 1)
            specials = torch.allclose(sgot, sref, rtol=0.0, atol=0.0, equal_nan=True)
            n_nan = int(torch.isnan(sref).sum().item())
            ok = e == 0.0 and same and floats and specials and lib_agrees
            print(f"pool{i} {name} (B, C, H, W) = {(batch, c, h, w)} s{s}: max_abs_err {e}, two "
                  f"launches equal {same}, normal cotangents equal to plain {floats}, with NaN and inf "
                  f"equal to plain {specials} ({n_nan} NaN results), ATen's routing "
                  f"{'agrees' if lib_agrees else 'differs'}: {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise SystemExit(f"{name} disagrees with its plain version or with ATen at pool{i}")
            err[name] = max(err[name], e)
            del got, again, ref, lib_out, fcot, ssrc, scot, sgot, sref
            row = dict(ms=_time_ms(kern, 20), plain_ms=_time_ms(plain, 3), library_ms=_time_ms(lib, 20),
                       bound_ms=1e3 * 4 * n_floats / PEAK_BYTES,
                       # per window k compares for its first maximum, per output element up to k gathered taps
                       op_bound_ms=1e3 * (cot.numel() * 3 + src.numel() * 3) / PEAK_FP32)
            print(f"pool{i} {name} (batch {batch}): kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                  f"ATen max_pool2d_with_indices_backward {row['library_ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.4f} ms (bytes: {4 * n_floats / 1e6:.1f} MB; operations "
                  f"{row['op_bound_ms']:.4f} ms); {4 * n_floats / row['ms'] / 1e6:.1f} GB/s; blocks of "
                  f"{plan.rows} rows x {plan.planes} planes, {plan.smem} bytes of shared memory", flush=True)
            if i in (1, 4) and batch == TRAIN_BATCH:  # the largest pool and a one-band one at other tile sizes
                other = {t: _time_ms(lambda: kern(t), 20) for t in (pk.TILE_BYTES // 2, pk.TILE_BYTES * 2)}
                print(f"pool{i} {name} at other tile sizes: "
                      + ", ".join(f"{t} bytes {ms:.4f} ms" for t, ms in other.items()), flush=True)
            for k in keys:
                sums[name][k] += row[k]
        del x, xp, yw_full, idx_w, yw, ywp, y_full, idx_h, g, gw, g_lib, gw_lib, cases
        torch.cuda.empty_cache()
    print(f"the pools' forward over the five pools of a step at batch {batch}: {forward['ms']:.4f} ms, of which the "
          f"F.pad copies to -inf {forward['pad_ms']:.4f} ms", flush=True)
    rows = {}
    for name, tot in sums.items():
        print(f"{name} over the five pools of a step at batch {batch}: kernel {tot['ms']:.4f} ms, plain "
              f"{tot['plain_ms']:.4f} ms, ATen {tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms",
              flush=True)
        per = {k: v / len(POOLS) for k, v in tot.items()}
        bound_by = "bytes" if per["bound_ms"] >= per["op_bound_ms"] else "operations"
        rows[name] = dict(max_abs_err=err[name], ms=per["ms"], plain_ms=per["plain_ms"],
                          bound_ms=max(per["bound_ms"], per["op_bound_ms"]), bound_by=bound_by,
                          library_ms=per["library_ms"])
    return rows


def _group(kernel: str) -> str:
    name = kernel.lower()
    if "splat_kernel" in name:
        return "mmgrid_splat"
    if "slice_kernel" in name:
        return "mmgrid_slice"
    if "pool_bwd" in name:
        return "pool_bwd"
    # cuDNN's FFT convolutions run complex ("cf32") GEMMs between their FFTs
    if any(k in name for k in ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd", "cudnn", "fft",
                               "cf32")):
        return "convolution"
    if "gemm" in name:
        return "gemm"
    return "other"


def _profile(title: str, fn, out_file: Path) -> None:
    """``fn()`` once under torch.profiler: device time by kernel group."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    groups: dict = {}
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = evt.self_device_time_total / 1e3
        group = _group(evt.key)
        groups[group] = groups.get(group, 0.0) + ms
        kernels.append((ms, evt.count, evt.key))
    busy = sum(groups.values())
    if busy == 0.0:
        print(f"profile ({title}): the profiler recorded no device time", flush=True)
        return
    print(f"profile ({title}, under the profiler): wall {wall_ms:.1f} ms, device busy "
          f"{busy:.1f} ms, idle share {max(0.0, 1.0 - busy / wall_ms):.3f}", flush=True)
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {group}: {ms:.2f} ms ({ms / busy:.3f} of device time)", flush=True)
    kernels.sort(reverse=True)
    for ms, count, key in kernels[:12]:
        print(f"    {ms:9.2f} ms  x{count:<5d} {key[:110]}", flush=True)
    out_file.parent.mkdir(parents=True, exist_ok=True)
    out_file.write_text(prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))


def _train_batch(rng, cfg, dev) -> dict:
    """A synthetic stage-1 batch as ``bench.py`` builds it: background plus
    two random classes per image, 2% cue density, N(0, 40) images."""
    b, m = cfg.batch_size, cfg.num_classes
    labels = np.zeros((b, m), np.float32)
    labels[:, 0] = 1.0
    for i in range(b):
        labels[i, rng.integers(1, m, size=2)] = 1.0
    cues = (rng.uniform(size=(b, cfg.cue_size, cfg.cue_size, m)) < 0.02).astype(np.float32)
    images = rng.normal(size=(b, cfg.crop_size, cfg.crop_size, 3)).astype(np.float32) * 40
    batch = {"images": images, "labels": labels, "cues": cues * labels[:, None, None, :]}
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def _train_phase(pk, rng, out_dir: Path) -> dict:
    """The stage-1 step at full width; returns the pool kernels' launches."""
    from dsrg_tpu_torch.config import Stage1Config
    from dsrg_tpu_torch.models import DeepLabLargeFOV
    from dsrg_tpu_torch.ops.grow import region_grow
    from dsrg_tpu_torch.train import stage1

    cfg = Stage1Config(batch_size=TRAIN_BATCH)
    model = DeepLabLargeFOV(num_classes=cfg.num_classes)
    state = stage1.init_stage1(model, cfg)  # on the card: the default
    step = stage1.make_stage1_step(model, cfg, state.optimizer, state.generator)
    batch = _train_batch(rng, cfg, next(model.parameters()).device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"train: {type(model).__name__} {n_params} parameters on {next(model.parameters()).device}, "
          f"batch {cfg.batch_size} @ {cfg.crop_size}^2, cues {cfg.cue_size}^2, {cfg.num_classes} "
          f"classes, heads {model.head_dilations}, CRF {cfg.crf_iters} iterations", flush=True)

    def check(metrics, what):
        vals = {k: v.item() for k, v in metrics.items()}
        print(f"  {what}: " + ", ".join(f"{k} {v:.6g}" for k, v in vals.items()), flush=True)
        if not all(np.isfinite(v) for v in vals.values()):
            raise SystemExit(f"train step {what}: non-finite metrics {vals}")

    torch.cuda.reset_peak_memory_stats()
    for i in range(2):
        check(step(batch), f"warm-up step {i}")
    torch.cuda.synchronize()
    pk.pool_bwd_h.launches = pk.pool_bwd_w.launches = 0
    checks0 = region_grow.dsrg_grow.checks
    t0 = time.perf_counter()
    metrics = [step(batch) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_STEPS
    launches = {"pool_bwd_h": pk.pool_bwd_h.launches, "pool_bwd_w": pk.pool_bwd_w.launches}
    checks = (region_grow.dsrg_grow.checks - checks0) / TRAIN_STEPS
    for i, m in enumerate(metrics):
        check(m, f"timed step {i}")
    print(f"main path (train): {1e3 * dt:.1f} ms/step, {cfg.batch_size / dt:.2f} images/s over "
          f"{TRAIN_STEPS} steps; launches {launches}; region-growing convergence checks "
          f"{checks:.1f}/step; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if launches != {n: 5 * TRAIN_STEPS for n in launches}:
        raise SystemExit(f"pool kernel launches {launches}, expected {5 * TRAIN_STEPS} of each")

    _profile("train, one step", lambda: step(batch), out_dir / "chip_smoke_train_profile.txt")

    # one more step with the region growing bracketed by synchronisations
    grow, grow_ms = stage1.dsrg_grow, []

    def timed_grow(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = grow(*args, **kwargs)
        torch.cuda.synchronize()
        grow_ms.append(1e3 * (time.perf_counter() - t))
        return out

    stage1.dsrg_grow = timed_grow
    try:
        checks0 = region_grow.dsrg_grow.checks
        step(batch)
    finally:
        stage1.dsrg_grow = grow
    print(f"region growing: {grow_ms[0]:.2f} ms of the step, "
          f"{region_grow.dsrg_grow.checks - checks0} convergence checks", flush=True)
    del state, step, model, batch, metrics
    torch.cuda.empty_cache()
    return launches


def _train_card_vs_cpu(rng) -> None:
    """One tiny step from the same weights on the card and on the CPU."""
    from dsrg_tpu_torch.config import Stage1Config
    from dsrg_tpu_torch.models import DeepLabLargeFOV
    from dsrg_tpu_torch.train.stage1 import init_stage1, make_stage1_step

    cfg = Stage1Config(num_classes=6, batch_size=2, crop_size=41, cue_size=6, crf_iters=2, mirror=False)
    batch = {k: v.numpy() for k, v in _train_batch(rng, cfg, "cpu").items()}
    out = {}
    for dev in ("cuda", "cpu"):
        model = DeepLabLargeFOV(num_classes=6, head_dilations=(2, 4), dropout_rate=0.0)
        state = init_stage1(model, cfg, device=dev)  # the same seeded weights on both
        m = make_stage1_step(model, cfg, state.optimizer, state.generator)(batch)
        out[dev] = {k: v.item() for k, v in m.items()}
    print(f"card vs CPU step: card {out['cuda']}, CPU {out['cpu']}", flush=True)
    for key in ("loss", "loss_seed", "loss_constrain", "grad_norm"):
        a, b = out["cuda"][key], out["cpu"][key]
        if not abs(a - b) <= CARD_VS_CPU_RTOL * abs(b):
            raise SystemExit(f"card vs CPU step: {key} {a} vs {b}")
    if out["cuda"]["seed_pixels"] != out["cpu"]["seed_pixels"]:
        raise SystemExit("card vs CPU step: seed_pixels differ")


def _pseudo_gt_phase(mk, predictor, cpu_pred, images, rng, out_dir: Path) -> tuple:
    """The pseudo ground truth at full width; returns the mmgrid kernels'
    launches and the restricted masks."""
    import tempfile

    from dsrg_tpu_torch import inference
    from dsrg_tpu_torch.data.cues import CueDB, save_cue_db

    n, m = len(images), predictor.num_classes
    entries = {}
    for i in range(n):
        fg = np.sort(rng.choice(np.arange(1, m), size=2, replace=False))
        cells = rng.integers(0, 41, (2, 5))
        entries[i] = (fg, (np.repeat(fg, 5)[:5], cells[0], cells[1]))
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        save_cue_db(str(Path(tmp) / "cues.pickle"), entries)
        db = CueDB(str(Path(tmp) / "cues.pickle"), num_classes=m)
        label_sets = [np.flatnonzero(db.labels(i)) for i in range(n)]
    print(f"pseudo-GT: {n} images of {IMG_H}x{IMG_W}, sizes {GT_SIZES}, label sets "
          f"{[ls.tolist() for ls in label_sets]}", flush=True)

    # the split of a call, each part bracketed by synchronisations: the
    # host's scipy zooms and numpy softmax, the forward (upload, net,
    # download) and the CRF; the rest is the log, the unary's upload and the
    # argmax's download
    split = {"zoom": 0.0, "softmax": 0.0, "forward": 0.0, "crf": 0.0}
    patched = {"ndzoom": "zoom", "_softmax_floor": "softmax", "CRF": "crf"}
    originals = {name: getattr(inference, name) for name in patched}
    fwd = predictor.scores_at_size

    def timed(key, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            split[key] += time.perf_counter() - t
            return out
        return call

    predictor.predict_mask(images[0], sizes=GT_SIZES, restrict_labels=label_sets[0])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    predictor.scores_at_size = timed("forward", fwd)
    for name, key in patched.items():
        setattr(inference, name, timed(key, originals[name]))
    masks, per_image, launches = [], [], {"mmgrid_splat": 0, "mmgrid_slice": 0}
    try:
        mk.dense_operands.calls = 0
        for im, labels in zip(images, label_sets):
            mk.splat.launches = mk.slice.launches = 0
            t0 = time.perf_counter()
            masks.append(predictor.predict_mask(im, sizes=GT_SIZES, restrict_labels=labels))
            per_image.append(time.perf_counter() - t0)
            counts = {"mmgrid_splat": mk.splat.launches, "mmgrid_slice": mk.slice.launches}
            if counts != {"mmgrid_splat": 11, "mmgrid_slice": 11}:
                raise SystemExit(f"pseudo-GT kernel launches {counts} for one image, expected 11 of each")
            for k in launches:
                launches[k] += counts[k]
    finally:
        del predictor.scores_at_size
        for name, fn in originals.items():
            setattr(inference, name, fn)
    total = sum(per_image)
    rest = total - sum(split.values())
    print(f"main path (pseudo-GT, predict_mask): {1e3 * total / n:.2f} ms/image (per image "
          f"{', '.join(f'{1e3 * t:.2f}' for t in per_image)}); host zooms {1e3 * split['zoom'] / n:.2f}, "
          f"host softmax {1e3 * split['softmax'] / n:.2f}, forward {1e3 * split['forward'] / n:.2f}, CRF "
          f"{1e3 * split['crf'] / n:.2f}, the rest (log, unary upload, mask download) {1e3 * rest / n:.2f} "
          f"ms/image (host clock, synchronised); launches {launches}, dense_operands calls "
          f"{mk.dense_operands.calls}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB",
          flush=True)
    if mk.dense_operands.calls:
        raise SystemExit("the pseudo-GT path built the dense operands on the card")
    for i, (im, mask, labels) in enumerate(zip(images, masks, label_sets)):
        present = set(np.unique(mask).tolist())
        if mask.shape != im.shape[:2] or mask.dtype != np.uint8 or not present <= set(labels.tolist()):
            raise SystemExit(f"pseudo-GT mask {i}: {mask.shape} {mask.dtype}, labels {present} "
                             f"outside {labels.tolist()}")
        print(f"  image {i}: labels {sorted(present)} of {labels.tolist()}", flush=True)

    # the batched path, against the per-image masks before restriction
    free = [predictor.predict_mask(im, sizes=GT_SIZES) for im in images]
    predictor.predict_masks(images, sizes=GT_SIZES, crf_batch=4)  # warm-up: the batch's cuDNN plans
    torch.cuda.synchronize()
    mk.splat.launches = mk.slice.launches = mk.dense_operands.calls = 0
    t0 = time.perf_counter()
    batched = predictor.predict_masks(images, sizes=GT_SIZES, crf_batch=4)
    dt = time.perf_counter() - t0
    counts = {"mmgrid_splat": mk.splat.launches, "mmgrid_slice": mk.slice.launches}
    agree = min(float((a == b).mean()) for a, b in zip(batched, free))
    print(f"main path (pseudo-GT, predict_masks, crf_batch 4): {1e3 * dt:.1f} ms per {n} images, "
          f"launches {counts}, dense_operands calls {mk.dense_operands.calls}; agreement with "
          f"predict_mask before restriction {agree:.5f}", flush=True)
    if counts != {"mmgrid_splat": 22, "mmgrid_slice": 22} or mk.dense_operands.calls:
        raise SystemExit(f"predict_masks launches {counts}, expected 22 of each and no dense operands")
    if agree <= 0.99:
        raise SystemExit("predict_masks disagrees with predict_mask")
    for k in launches:
        launches[k] += counts[k]

    _profile("pseudo-GT, one predict_mask", lambda: predictor.predict_mask(
        images[0], sizes=GT_SIZES, restrict_labels=label_sets[0]), out_dir / "chip_smoke_gt_profile.txt")

    # card vs CPU at 72x96: "auto" takes the exact engine there, then the grid's kernels
    small = _images(rng, 1, 72, 96)[0]
    for engine in ("auto", "mmgrid"):
        on_card = predictor.predict_mask(small, sizes=(41, 57), restrict_labels=label_sets[0], crf_engine=engine)
        on_cpu = cpu_pred.predict_mask(small, sizes=(41, 57), restrict_labels=label_sets[0], crf_engine=engine)
        agree = float((on_card == on_cpu).mean())
        print(f"card vs CPU predict_mask 72x96, engine {engine}: agreement {agree:.5f}", flush=True)
        if agree <= 0.99:
            raise SystemExit(f"predict_mask ({engine}) on the card disagrees with the CPU's")
    return launches, masks


def _stage2_batch(images, masks, cfg, dev) -> dict:
    """Raw uint8 BGR crops of the images and their pseudo ground truth at
    the crop size, the last 21 rows ignored, repeated up to the batch."""
    c = cfg.crop_size
    x0 = (IMG_W - c) // 2
    crops = [(im[:c, x0: x0 + c, ::-1], mask[:c, x0: x0 + c].copy()) for im, mask in zip(images, masks)]
    crops = [crops[i % len(crops)] for i in range(cfg.batch_size)]
    labels = np.stack([lab for _, lab in crops])
    labels[:, c - 21:] = cfg.ignore_label
    batch = {"images": np.stack([im for im, _ in crops]), "labels": labels}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in batch.items()}


def _stage2_phase(pk, images, masks, out_dir: Path) -> dict:
    """The stage-2 step at full width on phase 7's pseudo ground truth;
    returns the pool kernels' launches."""
    from dsrg_tpu_torch.config import Stage2Config
    from dsrg_tpu_torch.models import DeepLabLargeFOV
    from dsrg_tpu_torch.train.stage2 import init_stage2, make_stage2_step

    cfg = Stage2Config(batch_size=STAGE2_BATCH)
    model = DeepLabLargeFOV(num_classes=cfg.num_classes)
    state = init_stage2(model, cfg)  # on the card: the default
    step = make_stage2_step(model, cfg, state.optimizer, state.generator)
    batch = _stage2_batch(images, masks, cfg, next(model.parameters()).device)
    valid = batch["labels"] != cfg.ignore_label
    print(f"stage 2: {type(model).__name__} on {next(model.parameters()).device}, batch {cfg.batch_size} "
          f"@ {cfg.crop_size}^2, {cfg.num_classes} classes, heads {model.head_dilations}, labels "
          f"{sorted(torch.unique(batch['labels']).tolist())}, valid pixels {valid.float().mean().item():.4f}",
          flush=True)

    def check(metrics, what):
        vals = {k: v.item() for k, v in metrics.items()}
        print(f"  {what}: " + ", ".join(f"{k} {v:.6g}" for k, v in vals.items()), flush=True)
        if not all(np.isfinite(v) for v in vals.values()):
            raise SystemExit(f"stage-2 step {what}: non-finite metrics {vals}")

    torch.cuda.reset_peak_memory_stats()
    for i in range(2):
        check(step(batch), f"warm-up step {i}")
    torch.cuda.synchronize()
    pk.pool_bwd_h.launches = pk.pool_bwd_w.launches = 0
    t0 = time.perf_counter()
    metrics = [step(batch) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_STEPS
    launches = {"pool_bwd_h": pk.pool_bwd_h.launches, "pool_bwd_w": pk.pool_bwd_w.launches}
    for i, m in enumerate(metrics):
        check(m, f"timed step {i}")
    print(f"main path (stage 2): {1e3 * dt:.1f} ms/step, {cfg.batch_size / dt:.2f} images/s over "
          f"{TRAIN_STEPS} steps; launches {launches}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if launches != {n: 5 * TRAIN_STEPS for n in launches}:
        raise SystemExit(f"stage-2 pool kernel launches {launches}, expected {5 * TRAIN_STEPS} of each")
    _profile("stage 2, one step", lambda: step(batch), out_dir / "chip_smoke_stage2_profile.txt")
    del state, step, model, batch, metrics
    torch.cuda.empty_cache()

    # one tiny step from the same weights on the card and on the CPU
    rng = np.random.default_rng(SEED)
    cfg = Stage2Config(num_classes=6, batch_size=2, crop_size=41, mirror=False)
    tiny = {"images": rng.integers(0, 256, (2, 41, 41, 3)).astype(np.uint8),
            "labels": rng.integers(0, 6, (2, 41, 41)).astype(np.uint8)}
    tiny["labels"][:, 30:] = cfg.ignore_label
    out = {}
    for dev in ("cuda", "cpu"):
        model = DeepLabLargeFOV(num_classes=6, head_dilations=(2, 4), dropout_rate=0.0)
        state = init_stage2(model, cfg, device=dev)  # the same seeded weights on both
        m = make_stage2_step(model, cfg, state.optimizer, state.generator)(tiny)
        out[dev] = {k: v.item() for k, v in m.items()}
    print(f"card vs CPU stage-2 step: card {out['cuda']}, CPU {out['cpu']}", flush=True)
    for key, b in out["cpu"].items():
        if not abs(out["cuda"][key] - b) <= CARD_VS_CPU_RTOL * abs(b):
            raise SystemExit(f"card vs CPU stage-2 step: {key} {out['cuda'][key]} vs {b}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from dsrg_tpu_torch import _build
    from dsrg_tpu_torch.inference import Predictor
    from dsrg_tpu_torch.models import DeepLabLargeFOV
    from dsrg_tpu_torch.ops import pool_kernels as pk
    from dsrg_tpu_torch.ops import pooling
    from dsrg_tpu_torch.ops.crf import mmgrid as tmm
    from dsrg_tpu_torch.ops.crf import mmgrid_kernels as mk

    smi = _smi()
    print(f"card: {smi}", flush=True)
    print("torch", torch.__version__, "cuda", torch.version.cuda, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # a server's canvases come in a few bucketed shapes and a trainer's crop
    # is fixed: let cuDNN time its algorithms once per shape (the warm-up)
    torch.backends.cudnn.benchmark = True
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    out_dir = Path(__file__).resolve().parent / "chiprun_out"

    t0 = time.perf_counter()
    logs = _build.build(mk.KERNELS + pk.KERNELS)
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in logs.items():
        for line in _ptxas_summary(log):
            print(f"  {name}: {line}", flush=True)

    rows, plan_ms = _kernel_phase(mk, tmm, dev, rng)
    rows.update(_pool_phase(pk, pooling, dev, TRAIN_BATCH))  # the stage-1 step's: the kernels' line
    _pool_phase(pk, pooling, dev, STAGE2_BATCH)

    model = DeepLabLargeFOV(num_classes=21)
    params = _weights(model, rng)
    predictor = Predictor(model, params, num_classes=21, device="cuda")
    images = _images(rng, N_IMAGES, IMG_H, IMG_W)
    launches = {"mmgrid_splat": 0, "mmgrid_slice": 0}
    for mode in ({"sizes": SIZES}, {"scales": SCALES}):
        predictor.predict_masks_device(images, **mode)  # warm-up: cuDNN plans, first launches
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mk.splat.launches = mk.slice.launches = mk.dense_operands.calls = 0
        t0 = time.perf_counter()
        masks = predictor.predict_masks_device(images, **mode)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {"mmgrid_splat": mk.splat.launches, "mmgrid_slice": mk.slice.launches}
        print(f"main path {mode}: {1e3 * dt:.1f} ms/chunk of {N_IMAGES}, "
              f"{N_IMAGES / dt:.2f} images/s, launches {counts}, dense_operands calls "
              f"{mk.dense_operands.calls}, CRF plan build {plan_ms:.3f} ms of the chunk, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
        if mk.dense_operands.calls:
            raise SystemExit("the main path built the dense operands on the card")
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

    _profile("sizes mode, one chunk", lambda: predictor.predict_masks_device(images, sizes=SIZES),
             out_dir / "chip_smoke_profile.txt")

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
    del predictor, cpu_pred, model
    torch.cuda.empty_cache()

    launches.update(_train_phase(pk, rng, out_dir))
    _train_card_vs_cpu(rng)

    # the pseudo ground truth: a predictor of the same net and weights, as
    # generate_train_gt.py makes one from the stage-1 snapshot
    predictor = Predictor(DeepLabLargeFOV(num_classes=21), params, num_classes=21, device="cuda")
    cpu_pred = Predictor(DeepLabLargeFOV(num_classes=21), params, num_classes=21, device="cpu")
    gt_launches, gt_masks = _pseudo_gt_phase(mk, predictor, cpu_pred, images, rng, out_dir)
    for k, v in gt_launches.items():
        launches[k] += v
    predictor.close()
    del predictor, cpu_pred
    torch.cuda.empty_cache()
    for k, v in _stage2_phase(pk, images, gt_masks, out_dir).items():
        launches[k] += v

    kernels = [
        {"name": "mmgrid_splat", "route": "cuda", "source": "dsrg_tpu_torch/csrc/mmgrid_splat.cu",
         "replaces": "dsrg_tpu/ops/crf/pallas_mmgrid.py:112", "launches": launches["mmgrid_splat"],
         **rows["mmgrid_splat"]},
        {"name": "mmgrid_slice", "route": "cuda", "source": "dsrg_tpu_torch/csrc/mmgrid_slice.cu",
         "replaces": "dsrg_tpu/ops/crf/pallas_mmgrid.py:87", "launches": launches["mmgrid_slice"],
         **rows["mmgrid_slice"]},
        {"name": "pool_bwd_h", "route": "cuda", "source": "dsrg_tpu_torch/csrc/pool_bwd_h.cu",
         "replaces": "dsrg_tpu/ops/pallas_pool.py:166", "launches": launches["pool_bwd_h"],
         **rows["pool_bwd_h"]},
        {"name": "pool_bwd_w", "route": "cuda", "source": "dsrg_tpu_torch/csrc/pool_bwd_w.cu",
         "replaces": "dsrg_tpu/ops/pallas_pool.py:189", "launches": launches["pool_bwd_w"],
         **rows["pool_bwd_w"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
