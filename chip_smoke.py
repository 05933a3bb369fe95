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
     sizes; the kernels' line reports batch 20; then the same checks and
     times for the kernels' bfloat16 versions (bf16 inputs and cotangents,
     bits equal to the plain versions, which round after every add), and
     each pool's forward with implicit padding beside the former form that
     padded two -inf copies;
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
     step, one step under the profiler; a tiny step card against CPU;
  9. the precisions: the stage-1 step (batch 20) and the stage-2 step
     (batch 10) at full width in fp32 with TF32 off, in fp32 with TF32 on
     (cuDNN and matmul) and in bfloat16 (``DeepLabLargeFOV(compute_dtype=
     torch.bfloat16)``, ``compute_dtype="bfloat16"``, stage 1 with
     ``crf_fast=True``): ms/step, images/s, peak memory, the pool kernels'
     launches by element type and a profile of one step each; a served
     chunk of 8 in sizes mode with a bf16 model; a tiny bf16 step card
     against CPU; TF32 off again after it;
  10. the learning check (``dsrg_tpu/tools/synth_check.py`` in memory): the
     ``easy`` synthetic set at 321 (64 train, 16 val images, seed 0, cues in
     the reference's pickle through ``save_cue_db`` / ``CueDB``), stage 1
     from ``init_stage1`` for 300 iterations at batch 8, val masks from
     ``predict_masks_device(sizes=[321], smooth=False)``, scored by the
     reference's quirk mIoU and the honest ``miou3``; once in fp32 (TF32
     off), once in bf16 with ``crf_fast=True``; fatal if either ``miou3`` is
     below 0.5.
Each phase prints its wall time, and the script its total.  The last lines are a JSON line of kernels, the card's name and power limit,
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
BF16 = torch.bfloat16
TRAIN_BATCH, TRAIN_STEPS = 20, 5
# (channels, H, W, stride) of the five 3x3 pad-1 MAX pools at 321^2
POOLS = ((64, 321, 321, 2), (128, 161, 161, 2), (256, 81, 81, 2), (512, 41, 41, 1),
         (512, 41, 41, 1))
CARD_VS_CPU_RTOL = 1e-3  # fp32 sums in other orders through a VGG step
# bf16 rounds at other places on the card than on the CPU: the tiny step's
# metrics in bf16 sit within 1e-3 of the fp32 step's on the CPU, and the
# constrain term (~1e-3 of the loss) is held on the loss's scale
BF16_CARD_VS_CPU_RTOL = 1e-2
# the learning check (dsrg_tpu/tools/synth_check.py: 64 / 16 images, 300
# iterations at batch 8, the bar of a working DSRG stack)
LEARN_TRAIN, LEARN_VAL, LEARN_ITERS, LEARN_BATCH, LEARN_MIOU = 64, 16, 300, 8, 0.5
LEARN_SIZE = 321  # image, crop and prediction size; cues on its (size - 1) / 8 + 1 grid
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
        targs = ",".join((["bf16" if "bfloat16" in rest else "f32"] if "_kernelI" in entry and "pool" in name
                          else []) + re.findall(r"L[ib](\d+)E", rest.split("Ev")[0]))
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


def _former_forward(pooling, x, k, s, p):
    """The pool's train forward as the port ran it before implicit padding:
    each pass on a copy padded with -inf, then cropped."""
    oh, ph = pooling._caffe_pool_geometry(x.shape[2], k, s, p)
    ow, pw = pooling._caffe_pool_geometry(x.shape[3], k, s, p)
    yw = torch.nn.functional.max_pool2d(pooling._pad_hw(x, (0, 0), pw, float("-inf")), (1, k), (1, s))[..., :ow]
    return torch.nn.functional.max_pool2d(pooling._pad_hw(yw, ph, (0, 0), float("-inf")), (k, 1), (s, 1))[:, :, :oh]


def _pool_phase(pk, pooling, dev, batch: int, dtype=torch.float32) -> dict:
    """pool_bwd_h / pool_bwd_w vs their plain versions at a train step's
    five pools at ``batch`` in ``dtype`` (float32 or bfloat16, the kernels'
    two element types).  Returns each kernel's row, its times the mean per
    launch over one step's five launches."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sfx, elem = pk.ENTRY_SUFFIX[dtype], torch.empty((), dtype=dtype).element_size()

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev).to(dtype)

    def normal(shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "op_bound_ms")
    sums = {n: dict.fromkeys(keys, 0.0) for n in ("pool_bwd_h", "pool_bwd_w")}
    err = {n: 0.0 for n in sums}
    forward = {"ms": 0.0, "former_ms": 0.0, "pad_ms": 0.0}
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
        plans = {"pool_bwd_h": pk.plan_h(batch * c, h, wo, ho, 3, s, 1, pk.TILE_BYTES, elem),
                 "pool_bwd_w": pk.plan_w(x[..., 0].numel(), w, wo, pk.TILE_BYTES, elem)}
        # (wrapper, plain version, pass input, integer cotangent, ATen call, crop of its result)
        cases = {
            "pool_bwd_h": (pk.pool_bwd_h, pk.pool_bwd_h_plain, yw, g,
                           lambda: aten_bwd(g_lib, ywp, [3, 1], [s, 1], [0, 0], [1, 1], False, idx_h),
                           lambda out: out[:, :, ph[0]: ph[0] + h]),
            "pool_bwd_w": (pk.pool_bwd_w, pk.pool_bwd_w_plain, x, gw,
                           lambda: aten_bwd(gw_lib, xp, [1, 3], [1, s], [0, 0], [1, 1], False, idx_w),
                           lambda out: out[..., pw[0]: pw[0] + w]),
        }
        # the forward of the same pool: two library max pools with implicit
        # padding, beside the former form on -inf padded copies
        fwd = _time_ms(lambda: pooling.caffe_max_pool_train(x, 3, s, 1), 20)
        former = _time_ms(lambda: _former_forward(pooling, x, 3, s, 1), 20)
        pads = _time_ms(lambda: pooling._pad_hw(x, (0, 0), pw, float("-inf")), 20) \
            + _time_ms(lambda: pooling._pad_hw(yw, ph, (0, 0), float("-inf")), 20)
        if not torch.equal(pooling.caffe_max_pool_train(x, 3, s, 1), _former_forward(pooling, x, 3, s, 1)):
            raise SystemExit(f"pool{i}: the implicitly padded forward differs from the padded copies' form")
        print(f"pool{i} (batch {batch}, {dtype}) forward: {fwd:.4f} ms with implicit padding; the former "
              f"form {former:.4f} ms, of which its two F.pad copies to -inf {pads:.4f} ms", flush=True)
        forward["ms"] += fwd
        forward["former_ms"] += former
        forward["pad_ms"] += pads
        for name, (wrapper, plain_fn, src, cot, lib, crop) in cases.items():
            def kern(tile_bytes=pk.TILE_BYTES):
                return wrapper(src, cot, 3, s, 1, tile_bytes)

            def plain():
                return plain_fn(src, cot, 3, s, 1)

            label = name + sfx
            plan, n_bytes = plans[name], elem * (2 * src.numel() + cot.numel())
            got, again, ref, lib_out = kern(), kern(), plain(), crop(lib())
            torch.cuda.synchronize()
            e = (got.float() - ref.float()).abs().max().item()
            lib_agrees, same = torch.equal(got, lib_out), torch.equal(got, again)
            # normal cotangents: the plain version's bits need its order of summation
            # (and, in bf16, its rounding after every add); then NaN and +-inf in the
            # input (5%, 10%, 30%) and in the cotangent (2% each)
            fcot = normal(cot.shape)
            floats = torch.equal(wrapper(src, fcot, 3, s, 1), plain_fn(src, fcot, 3, s, 1))
            ssrc, scot = _with_specials(src, gen, (0.05, 0.1, 0.3)), _with_specials(fcot, gen, (0.02, 0.02, 0.02))
            sgot, sref = wrapper(ssrc, scot, 3, s, 1), plain_fn(ssrc, scot, 3, s, 1)
            specials = torch.allclose(sgot, sref, rtol=0.0, atol=0.0, equal_nan=True)
            n_nan = int(torch.isnan(sref).sum().item())
            ok = e == 0.0 and same and floats and specials and lib_agrees
            print(f"pool{i} {label} (B, C, H, W) = {(batch, c, h, w)} s{s}: max_abs_err {e}, two "
                  f"launches equal {same}, normal cotangents equal to plain {floats}, with NaN and inf "
                  f"equal to plain {specials} ({n_nan} NaN results), ATen's routing "
                  f"{'agrees' if lib_agrees else 'differs'}: {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise SystemExit(f"{label} disagrees with its plain version or with ATen at pool{i}")
            err[name] = max(err[name], e)
            del got, again, ref, lib_out, fcot, ssrc, scot, sgot, sref
            row = dict(ms=_time_ms(kern, 20), plain_ms=_time_ms(plain, 3), library_ms=_time_ms(lib, 20),
                       bound_ms=1e3 * n_bytes / PEAK_BYTES,
                       # per window k compares for its first maximum, per output element up to k gathered taps
                       op_bound_ms=1e3 * (cot.numel() * 3 + src.numel() * 3) / PEAK_FP32)
            print(f"pool{i} {label} (batch {batch}): kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                  f"ATen max_pool2d_with_indices_backward {row['library_ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.4f} ms (bytes: {n_bytes / 1e6:.1f} MB; operations "
                  f"{row['op_bound_ms']:.4f} ms); {n_bytes / row['ms'] / 1e6:.1f} GB/s; blocks of "
                  f"{plan.rows} rows x {plan.planes} planes, {plan.smem} bytes of shared memory", flush=True)
            if i in (1, 4) and batch == TRAIN_BATCH and dtype == torch.float32:
                # the largest pool and a one-band one at other tile sizes
                other = {t: _time_ms(lambda: kern(t), 20) for t in (pk.TILE_BYTES // 2, pk.TILE_BYTES * 2)}
                print(f"pool{i} {name} at other tile sizes: "
                      + ", ".join(f"{t} bytes {ms:.4f} ms" for t, ms in other.items()), flush=True)
            for k in keys:
                sums[name][k] += row[k]
        del x, xp, yw_full, idx_w, yw, ywp, y_full, idx_h, g, gw, g_lib, gw_lib, cases
        torch.cuda.empty_cache()
    print(f"the pools' forward over the five pools of a step at batch {batch} in {dtype}: {forward['ms']:.4f} ms "
          f"with implicit padding; the former form {forward['former_ms']:.4f} ms, of which the F.pad copies to "
          f"-inf {forward['pad_ms']:.4f} ms", flush=True)
    rows = {}
    for name, tot in sums.items():
        print(f"{name + sfx} over the five pools of a step at batch {batch}: kernel {tot['ms']:.4f} ms, plain "
              f"{tot['plain_ms']:.4f} ms, ATen {tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms",
              flush=True)
        per = {k: v / len(POOLS) for k, v in tot.items()}
        bound_by = "bytes" if per["bound_ms"] >= per["op_bound_ms"] else "operations"
        rows[name + sfx] = dict(max_abs_err=err[name], ms=per["ms"], plain_ms=per["plain_ms"],
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


def _profile(title: str, fn, out_file: Path, conv_shapes: bool = False) -> None:
    """``fn()`` once under torch.profiler: device time by kernel group;
    ``conv_shapes``: also the convolutions' device time by input shapes
    (which layers the convolution time goes to)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=conv_shapes) as prof:
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
    if conv_shapes:
        convs = sorted(((evt.device_time_total / 1e3, evt.count, evt.key, evt.input_shapes[:3])
                        for evt in prof.key_averages(group_by_input_shape=True)
                        if evt.key in ("aten::cudnn_convolution", "aten::convolution_backward")), reverse=True)
        for ms, count, key, shapes in convs[:10]:
            print(f"    {ms:9.2f} ms  x{count:<3d} {key} {shapes}", flush=True)
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
    _zero_counts(pk)
    checks0 = region_grow.dsrg_grow.checks
    t0 = time.perf_counter()
    metrics = [step(batch) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_STEPS
    launches = _launch_counts(pk)
    checks = (region_grow.dsrg_grow.checks - checks0) / TRAIN_STEPS
    for i, m in enumerate(metrics):
        check(m, f"timed step {i}")
    print(f"main path (train): {1e3 * dt:.1f} ms/step, {cfg.batch_size / dt:.2f} images/s over "
          f"{TRAIN_STEPS} steps; launches {launches}; region-growing convergence checks "
          f"{checks:.1f}/step; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if launches != {n: 0 if n.endswith("_bf16") else 5 * TRAIN_STEPS for n in launches}:
        raise SystemExit(f"pool kernel launches {launches}, expected {5 * TRAIN_STEPS} of each fp32 one")

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


def _train_card_vs_cpu(rng, bf16: bool = False) -> None:
    """One tiny step from the same weights on the card and on the CPU; with
    ``bf16``, a bf16 model with the bf16 CRF (``crf_fast``)."""
    from dsrg_tpu_torch.config import Stage1Config
    from dsrg_tpu_torch.models import DeepLabLargeFOV
    from dsrg_tpu_torch.train.stage1 import init_stage1, make_stage1_step

    what = "bf16 step" if bf16 else "step"
    cfg = Stage1Config(num_classes=6, batch_size=2, crop_size=41, cue_size=6, crf_iters=2, mirror=False,
                       compute_dtype="bfloat16" if bf16 else "float32", crf_fast=bf16)
    batch = {k: v.numpy() for k, v in _train_batch(rng, cfg, "cpu").items()}
    out = {}
    for dev in ("cuda", "cpu"):
        model = DeepLabLargeFOV(num_classes=6, head_dilations=(2, 4), dropout_rate=0.0,
                                compute_dtype=BF16 if bf16 else torch.float32)
        state = init_stage1(model, cfg, device=dev)  # the same seeded weights on both
        m = make_stage1_step(model, cfg, state.optimizer, state.generator)(batch)
        out[dev] = {k: v.item() for k, v in m.items()}
    print(f"card vs CPU {what}: card {out['cuda']}, CPU {out['cpu']}", flush=True)
    rtol = BF16_CARD_VS_CPU_RTOL if bf16 else CARD_VS_CPU_RTOL
    for key in ("loss", "loss_seed", "loss_constrain", "grad_norm"):
        a, b = out["cuda"][key], out["cpu"][key]
        # in bf16 the constrain term (~1e-3 of the loss) is judged on the loss's scale
        scale = abs(out["cpu"]["loss"]) if bf16 and key == "loss_constrain" else abs(b)
        if not abs(a - b) <= rtol * scale:
            raise SystemExit(f"card vs CPU {what}: {key} {a} vs {b}")
    if out["cuda"]["seed_pixels"] != out["cpu"]["seed_pixels"]:
        raise SystemExit(f"card vs CPU {what}: seed_pixels differ")


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
    _zero_counts(pk)
    t0 = time.perf_counter()
    metrics = [step(batch) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_STEPS
    launches = _launch_counts(pk)
    for i, m in enumerate(metrics):
        check(m, f"timed step {i}")
    print(f"main path (stage 2): {1e3 * dt:.1f} ms/step, {cfg.batch_size / dt:.2f} images/s over "
          f"{TRAIN_STEPS} steps; launches {launches}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if launches != {n: 0 if n.endswith("_bf16") else 5 * TRAIN_STEPS for n in launches}:
        raise SystemExit(f"stage-2 pool kernel launches {launches}, expected {5 * TRAIN_STEPS} of each fp32 one")
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


PRECISIONS = (("fp32", False), ("tf32", True), ("bf16", False))  # (name, TF32 on)


def _set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def _launch_counts(pk) -> dict:
    return {"pool_bwd_h": pk.pool_bwd_h.launches, "pool_bwd_w": pk.pool_bwd_w.launches,
            "pool_bwd_h_bf16": pk.pool_bwd_h.launches_bf16, "pool_bwd_w_bf16": pk.pool_bwd_w.launches_bf16}


def _zero_counts(pk) -> None:
    pk.pool_bwd_h.launches = pk.pool_bwd_w.launches = 0
    pk.pool_bwd_h.launches_bf16 = pk.pool_bwd_w.launches_bf16 = 0


def _timed_steps(pk, what: str, precision: str, step, batch, n_images: int, out_dir: Path) -> dict:
    """Two warm-up and TRAIN_STEPS timed steps of ``step``, the pool kernels'
    launches by element type (5 + 5 per step, of the precision's type), peak
    memory (of the warm-up, which holds cuDNN's algorithm search when the
    precision's shapes are new, and of the timed steps) and a profile of one
    step; returns the launches."""
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        step(batch)
    torch.cuda.synchronize()
    warm_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(pk)
    t0 = time.perf_counter()
    metrics = [step(batch) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_STEPS
    launches = _launch_counts(pk)
    last = {k: v.item() for k, v in metrics[-1].items()}
    if not all(np.isfinite(v) for m in metrics for v in (t.item() for t in m.values())):
        raise SystemExit(f"{what} {precision}: non-finite metrics {last}")
    fp32, bf16 = (0, 5 * TRAIN_STEPS) if precision == "bf16" else (5 * TRAIN_STEPS, 0)
    expected = {"pool_bwd_h": fp32, "pool_bwd_w": fp32, "pool_bwd_h_bf16": bf16, "pool_bwd_w_bf16": bf16}
    print(f"main path ({what}, {precision}): {1e3 * dt:.1f} ms/step, {n_images / dt:.2f} images/s over "
          f"{TRAIN_STEPS} steps; launches {launches}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB (warm-up {warm_peak:.2f} GiB); last step "
          + ", ".join(f"{k} {v:.6g}" for k, v in last.items()), flush=True)
    if launches != expected:
        raise SystemExit(f"{what} {precision}: pool kernel launches {launches}, expected {expected}")
    _profile(f"{what}, {precision}, one step", lambda: step(batch),
             out_dir / f"chip_smoke_{what.replace(' ', '')}_{precision}_profile.txt", conv_shapes=True)
    return launches


def _precision_phase(pk, mk, dev, images, gt_masks, params, fp32_masks, out_dir: Path) -> dict:
    """Both train steps at full width in fp32 (TF32 off), fp32 with TF32 and
    bf16; a served chunk with a bf16 model; a tiny bf16 step card vs CPU.
    Returns the pool and mmgrid kernels' launches of these runs."""
    from dsrg_tpu_torch.config import Stage1Config, Stage2Config
    from dsrg_tpu_torch.inference import Predictor
    from dsrg_tpu_torch.models import DeepLabLargeFOV
    from dsrg_tpu_torch.train import stage1, stage2

    launches = dict.fromkeys(("pool_bwd_h", "pool_bwd_w", "pool_bwd_h_bf16", "pool_bwd_w_bf16"), 0)
    try:
        for what, cfg_cls, batch_size, mod in (("stage 1", Stage1Config, TRAIN_BATCH, stage1),
                                               ("stage 2", Stage2Config, STAGE2_BATCH, stage2)):
            for precision, tf32 in PRECISIONS:
                _set_tf32(tf32)
                bf16 = precision == "bf16"
                extra = {"crf_fast": True} if bf16 and cfg_cls is Stage1Config else {}
                cfg = cfg_cls(batch_size=batch_size, compute_dtype="bfloat16" if bf16 else "float32", **extra)
                model = DeepLabLargeFOV(num_classes=cfg.num_classes, compute_dtype=BF16 if bf16 else torch.float32)
                init = stage1.init_stage1 if mod is stage1 else stage2.init_stage2
                make = stage1.make_stage1_step if mod is stage1 else stage2.make_stage2_step
                state = init(model, cfg, device=dev)
                step = make(model, cfg, state.optimizer, state.generator)
                batch = (_train_batch(np.random.default_rng(SEED), cfg, dev) if mod is stage1
                         else _stage2_batch(images, gt_masks, cfg, dev))
                for k, v in _timed_steps(pk, what, precision, step, batch, cfg.batch_size, out_dir).items():
                    launches[k] += v
                del state, step, model, batch
                torch.cuda.empty_cache()
    finally:
        _set_tf32(False)

    # a served chunk of 8 in sizes mode with a bf16 model of the serving weights
    predictor = Predictor(DeepLabLargeFOV(num_classes=21, compute_dtype=BF16), params, num_classes=21,
                          device=dev)
    predictor.predict_masks_device(images, sizes=SIZES)  # warm-up: the bf16 cuDNN plans
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mk.splat.launches = mk.slice.launches = mk.dense_operands.calls = 0
    t0 = time.perf_counter()
    masks = predictor.predict_masks_device(images, sizes=SIZES)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {"mmgrid_splat": mk.splat.launches, "mmgrid_slice": mk.slice.launches}
    agree = min(float((a == b).mean()) for a, b in zip(masks, fp32_masks))
    print(f"main path (serving, bf16 model, sizes {SIZES}): {1e3 * dt:.1f} ms/chunk of {len(images)}, "
          f"{len(images) / dt:.2f} images/s, launches {counts}, dense_operands calls {mk.dense_operands.calls}, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; agreement with the fp32 "
          f"model's masks {agree:.5f} (random weights: near-uniform scores)", flush=True)
    if counts != {"mmgrid_splat": 11, "mmgrid_slice": 11} or mk.dense_operands.calls:
        raise SystemExit(f"bf16 serving: launches {counts}, expected 11 of each and no dense operands")
    for im, m in zip(images, masks):
        if m.shape != im.shape[:2] or m.dtype != np.uint8 or int(m.max()) >= 21:
            raise SystemExit(f"bf16 serving: bad mask {m.shape} {m.dtype} max {m.max()}")
    launches.update(counts)
    _profile("serving, bf16 model, sizes mode, one chunk", lambda: predictor.predict_masks_device(images, sizes=SIZES),
             out_dir / "chip_smoke_serving_bf16_profile.txt")
    predictor.close()
    del predictor
    torch.cuda.empty_cache()

    _train_card_vs_cpu(np.random.default_rng(SEED), bf16=True)
    return launches


def _synth_set(out_dir: Path):
    """The ``easy`` synthetic set at LEARN_SIZE as ``synth_check.py`` makes
    it, in memory: ``make_image`` then, for a train image, ``cues_from_gt``,
    from one generator of seed 0; the cues go through the reference's pickle."""
    import dataclasses
    import tempfile

    from dsrg_tpu_torch.data import synth
    from dsrg_tpu_torch.data.cues import CueDB, save_cue_db

    grid = (LEARN_SIZE - 1) // 8 + 1
    spec = dataclasses.replace(synth.PROFILES["easy"], crop_size=LEARN_SIZE, cue_grid=grid, size_min=LEARN_SIZE,
                               size_max=LEARN_SIZE)
    rng = np.random.default_rng(SEED)
    images, gts, entries = [], [], {}
    for i in range(LEARN_TRAIN + LEARN_VAL):
        img, gt = synth.make_image(rng, spec)
        images.append(img)
        gts.append(gt)
        if i < LEARN_TRAIN:
            c, r, col = synth.cues_from_gt(rng, gt, spec)
            entries[i] = (np.unique(c[c > 0]) if len(c) else np.asarray([], np.int64), (c, r, col))
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        save_cue_db(str(Path(tmp) / "cues.pickle"), entries)
        db = CueDB(str(Path(tmp) / "cues.pickle"), num_classes=21, cue_size=grid)
        labels, cues = zip(*(db.get(i) for i in range(LEARN_TRAIN)))
    return images, gts, np.stack(labels), np.stack(cues)


def _miou3(conf, gts) -> tuple:
    """``synth_check._miou_fg``: IoU over background and every class present
    in the val ground truth, a class never hit scoring 0."""
    m = conf.M
    classes = sorted({0} | {int(c) for g in gts for c in np.unique(g)})
    with np.errstate(divide="ignore", invalid="ignore"):
        per = [float(np.nan_to_num(m[i, i] / (m[i].sum() + m[:, i].sum() - m[i, i]))) for i in classes]
    return float(np.mean(per)), classes, per


def _learning_phase(pk, dev, out_dir: Path) -> dict:
    """Stage 1 from scratch on the synthetic set, then val masks and their
    scores, in fp32 (TF32 off) and in bf16 with crf_fast; returns the pool
    kernels' launches of the bf16 run."""
    from dsrg_tpu_torch.config import Stage1Config
    from dsrg_tpu_torch.inference import Predictor
    from dsrg_tpu_torch.models import DeepLabLargeFOV
    from dsrg_tpu_torch.train.stage1 import init_stage1, make_stage1_step
    from dsrg_tpu_torch.utils.confusion import ConfusionMatrix

    t0 = time.perf_counter()
    images, gts, labels, cues = _synth_set(out_dir)
    print(f"learning check: the easy synthetic set, {LEARN_TRAIN} train + {LEARN_VAL} val images of "
          f"{LEARN_SIZE}x{LEARN_SIZE}, "
          f"{int(cues.sum())} cue cells, classes {sorted(set(np.unique(np.stack(gts)).tolist()))}; made in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    bgr = torch.from_numpy(np.ascontiguousarray(np.stack(images[:LEARN_TRAIN])[..., ::-1])).to(dev)
    labels_d, cues_d = torch.from_numpy(labels).to(dev), torch.from_numpy(cues).to(dev)
    launches, scores = {}, {}
    for precision, dtype in (("fp32", torch.float32), ("bf16", BF16)):
        bf16 = dtype == BF16
        cfg = Stage1Config(batch_size=LEARN_BATCH, crop_size=LEARN_SIZE, cue_size=cues.shape[1],
                           compute_dtype="bfloat16" if bf16 else "float32", crf_fast=bf16)
        model = DeepLabLargeFOV(num_classes=21, compute_dtype=dtype)
        state = init_stage1(model, cfg, device=dev)
        step = make_stage1_step(model, cfg, state.optimizer, state.generator)
        _zero_counts(pk)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = []
        order = {}  # synth_check's loader: sample k is permutation (seed, epoch k // n) at k % n
        for it in range(LEARN_ITERS):
            idx = [order.setdefault(k // LEARN_TRAIN, np.random.default_rng((SEED, k // LEARN_TRAIN)).permutation(
                LEARN_TRAIN))[k % LEARN_TRAIN] for k in range(it * LEARN_BATCH, (it + 1) * LEARN_BATCH)]
            sel = torch.as_tensor(np.asarray(idx), device=dev)
            m = step({"images": bgr[sel], "labels": labels_d[sel], "cues": cues_d[sel]})
            if it % 50 == 0 or it == LEARN_ITERS - 1:
                losses.append((it, m["loss"].item(), m["seed_pixels"].item()))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches[precision] = _launch_counts(pk)
        predictor = Predictor(model, device=dev)
        t0 = time.perf_counter()
        preds = []
        for c0 in range(LEARN_TRAIN, LEARN_TRAIN + LEARN_VAL, 8):
            preds += predictor.predict_masks_device(images[c0: c0 + 8], sizes=[LEARN_SIZE], smooth=False)
        predict_s = time.perf_counter() - t0
        conf = ConfusionMatrix(21)
        for gt, pred in zip(gts[LEARN_TRAIN:], preds):
            conf.add(gt, pred)
        quirk = conf.jaccard()[0]
        miou3, classes, per = _miou3(conf, gts[LEARN_TRAIN:])
        scores[precision] = miou3
        print(f"learning check ({precision}{', crf_fast' if bf16 else ', TF32 off'}): {LEARN_ITERS} iterations at "
              f"batch {LEARN_BATCH} in {train_s:.2f} s ({1e3 * train_s / LEARN_ITERS:.1f} ms/step), loss / seed "
              f"pixels at " + ", ".join(f"{it}: {loss:.4f} / {px:.0f}" for it, loss, px in losses)
              + f"; val masks in {predict_s:.2f} s; val mIoU (reference quirk) {quirk:.4f}, miou3 {miou3:.4f} "
              f"over classes {classes} (IoU {', '.join(f'{v:.4f}' for v in per)}); launches "
              f"{launches[precision]}", flush=True)
        predictor.close()
        del predictor, state, step, model
        torch.cuda.empty_cache()
    print(f"learning check: miou3 bf16 - fp32 = {scores['bf16'] - scores['fp32']:+.4f}", flush=True)
    low = {k: v for k, v in scores.items() if not v >= LEARN_MIOU}
    if low:
        raise SystemExit(f"learning check: miou3 below {LEARN_MIOU}: {low}")
    expected = {"fp32": (LEARN_ITERS * 5, 0), "bf16": (0, LEARN_ITERS * 5)}
    for precision, (fp32, bf16) in expected.items():
        if launches[precision] != {"pool_bwd_h": fp32, "pool_bwd_w": fp32, "pool_bwd_h_bf16": bf16,
                                   "pool_bwd_w_bf16": bf16}:
            raise SystemExit(f"learning check {precision}: pool kernel launches {launches[precision]}")
    return {k: launches["fp32"][k] + launches["bf16"][k] for k in launches["fp32"]}


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

    start = time.perf_counter()
    phase_t = [start]

    def phase_done(name: str) -> None:
        now = time.perf_counter()
        print(f"phase {name}: {now - phase_t[0]:.1f} s (total {now - start:.1f} s)", flush=True)
        phase_t[0] = now

    smi = _smi()
    print(f"card: {smi}", flush=True)
    print("torch", torch.__version__, "cuda", torch.version.cuda, flush=True)
    _set_tf32(False)
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
    phase_done("2 (build)")

    rows, plan_ms = _kernel_phase(mk, tmm, dev, rng)
    phase_done("3 (mmgrid kernels)")
    rows.update(_pool_phase(pk, pooling, dev, TRAIN_BATCH))  # the stage-1 step's: the kernels' line
    _pool_phase(pk, pooling, dev, STAGE2_BATCH)
    rows.update(_pool_phase(pk, pooling, dev, TRAIN_BATCH, BF16))
    _pool_phase(pk, pooling, dev, STAGE2_BATCH, BF16)
    phase_done("4 (pool kernels, fp32 and bf16)")

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
        if "sizes" in mode:
            sizes_masks = masks

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
    phase_done("5 (serving)")

    launches.update(_train_phase(pk, rng, out_dir))
    _train_card_vs_cpu(rng)
    phase_done("6 (stage-1 step)")

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
    phase_done("7 (pseudo ground truth)")
    for k, v in _stage2_phase(pk, images, gt_masks, out_dir).items():
        launches[k] += v
    phase_done("8 (stage-2 step)")

    for k, v in _precision_phase(pk, mk, dev, images, gt_masks, params, sizes_masks, out_dir).items():
        launches[k] = launches.get(k, 0) + v
    phase_done("9 (precisions: fp32, TF32, bf16)")
    for k, v in _learning_phase(pk, dev, out_dir).items():
        launches[k] = launches.get(k, 0) + v
    phase_done("10 (learning check)")

    kernels = [
        {"name": "mmgrid_splat", "route": "cuda", "source": "dsrg_tpu_torch/csrc/mmgrid_splat.cu",
         "replaces": "dsrg_tpu/ops/crf/pallas_mmgrid.py:112", "launches": launches["mmgrid_splat"],
         **rows["mmgrid_splat"]},
        {"name": "mmgrid_slice", "route": "cuda", "source": "dsrg_tpu_torch/csrc/mmgrid_slice.cu",
         "replaces": "dsrg_tpu/ops/crf/pallas_mmgrid.py:87", "launches": launches["mmgrid_slice"],
         **rows["mmgrid_slice"]},
    ] + [
        {"name": name + sfx, "route": "cuda", "source": f"dsrg_tpu_torch/csrc/{name}.cu",
         "replaces": f"dsrg_tpu/ops/pallas_pool.py:{line}", "launches": launches[name + sfx], **rows[name + sfx]}
        for name, line in (("pool_bwd_h", 166), ("pool_bwd_w", 189)) for sfx in ("", "_bf16")
    ]
    print(json.dumps({"kernels": kernels}))
    print(f"chip_smoke: total {time.perf_counter() - start:.1f} s", flush=True)
    print(_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
