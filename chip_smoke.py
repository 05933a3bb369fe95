"""Smoke run of the PyTorch + CUDA port (``dsrg_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit; TF32 off (the reference computes fp32);
  2. build every CUDA kernel of the port from ``dsrg_tpu_torch/csrc``, one
     nvcc per source, all started together, and the native engines
     (``native/*.cpp`` with ``g++``, ``dsrg_tpu_torch/native.py``);
  3. the mmgrid kernels against their plain PyTorch versions on the card, at
     the shapes the serving path gives them (8 images of 500x375 on a
     512x384 canvas: 1040 tiles of 1600 pixels, gc = 21, C = 21 and C = 1)
     on a photo-like guide and, at C = 21, on a pixel-noise guide (no two
     pixels of a tile share their colour bins), and on a small
     ``spatial_exact`` plan (corner-scaled r weights), each launched twice
     for equal bits; timed (launches queued behind a spin of the card:
     device time) beside the plain version, ``torch.bmm`` on the dense
     operands and the card's bound for the bytes the sparse kernel must
     move; the plan's build time and that of the dense operands (issued to
     an idle card: the host's work included); then
     at the pseudo ground truth's shapes: one unmasked 500x375 image (130
     tiles, fewer than the card's 132 SMs) and ``predict_masks``' CRF batch
     (4 images on a 512x384 canvas, values masked to the images);
  4. the pool backward kernels against their plain versions at the five max
     pools of the stage-1 step (batch 20 @ 321^2) and of the stage-2 step
     (batch 10), on integer inputs full of ties: with integer cotangents
     (the error must be 0, and ATen's routing must agree), with
     normal-distributed cotangents (equal bits: only the sum over taps in
     the order t = 0..k-1 gives them) and with NaN and +-inf in inputs and
     cotangents; timed the same way (the kernels also from the host's
     launch rate), with the bytes moved, the achieved GB/s, each block's
     shared memory, and (batch 20) pool1 and pool4 at
     other tile sizes; the kernels' line reports batch 20; then the same
     checks and times for the kernels' bfloat16 versions (bf16 inputs and
     cotangents, -0 and subnormals among the normal ones, bits equal to the
     plain versions, which round after every add; each time beside its
     bound and the former design's times, and pool4/5 also
     with the L2 flushed before every launch, as a step finds them), and
     each pool's forward with implicit padding beside the former form that
     padded two -inf copies (issued to an idle card); then the same checks
     and times at ResNet-101's pool1 (3x3/2/1 over (B, 64, 161, 161)) at
     batch 20 and 10, fp32 and bf16;
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
     6b: a one-rank NCCL group (``parallel.distributed.init_group``; NCCL
     refuses two ranks on one card) and the same step from the same state
     and batch through ``parallel.data_parallel_step``: loss within 1e-5 and
     parameters within 2e-5 relative of the plain step (whether the bits are
     equal printed, and whether two plain steps' are), the batch padded to 24
     (4 masked rows; mirror and dropout off) against the unpadded step, 3
     timed steps with 5 + 5 pool launches each, the coalesced all-reduce
     timed alone (its share of the step) and one step under the profiler;
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
     8b: the stage-2 step over the NCCL group as in 6b (padded 10 -> 12);
     8c: ``Predictor(mesh=make_mesh())`` on phase 5's chunk in sizes mode
     with the CRF: phase 5's masks, 11 + 11 mmgrid launches; the group is
     destroyed after it;
  9. the precisions: the stage-1 step (batch 20) and the stage-2 step
     (batch 10) at full width in fp32 with TF32 on (cuDNN and matmul) and
     in bfloat16 (``DeepLabLargeFOV(compute_dtype=torch.bfloat16)``,
     ``compute_dtype="bfloat16"``, stage 1 with ``crf_fast=True``; fp32
     with TF32 off is phases 6 and 8, whose profiles also list the
     convolutions by shape): ms/step, images/s, peak memory, the pool kernels'
     launches by element type and a profile of one step each; a served
     chunk of 8 in sizes mode with a bf16 model; a tiny bf16 step card
     against CPU; TF32 off again after it;
  10. the learning check (``dsrg_tpu/tools/synth_check.py`` in memory): the
     ``easy`` synthetic set at 321 (64 train, 16 val images, seed 0, cues in
     the reference's pickle through ``save_cue_db`` / ``CueDB``), stage 1
     from ``init_stage1`` for 200 iterations at batch 8, val masks from
     ``predict_masks_device(sizes=[321], smooth=False)``, scored by the
     reference's quirk mIoU and the honest ``miou3``; once in fp32 (TF32
     off), once in bf16 with ``crf_fast=True``; fatal if either ``miou3`` is
     below 0.5;
  11. the recipe on files (``tools/synth_check.py --two-stage`` with the
     CRF on): the same ``easy`` set written as a tree by
     ``data/synth.make_dataset`` with the port's PNG writer (the card's
     machine has no PIL; the images are the arrays, without JPEG
     artefacts), then ``python -m dsrg_tpu_torch.tools.run_recipe`` in its
     default supervised mode, every phase a ``python -m
     dsrg_tpu_torch.tools.*`` child on the card: stage s and stage f for 200
     iterations at batch 8 (fp32, TF32 off), the ``test_ms`` and
     ``test_ms_f`` dumps at 321 with the CRF, and ``evaluate``; each phase's
     wall time, the dumps' images/s, the children's kernel launches (pool
     kernels in both trainers, mmgrid kernels in both dumps), every mask read
     back through ``utils/imageio``; fatal if ``miou3`` is below 0.5.  Then
     the train CLI at the reference's batches: stage s (batch 20) for 12
     iterations with a snapshot every 6, a second process with
     ``--auto-resume`` to 18 that must start at 12, and stage f (batch 10)
     for 15 iterations from the recipe's stage-s weights with
     ``--profile-dir`` (steps 10-14): ms/step from the display lines beside
     phases 6 and 8's in-memory steps, the idle share, launches; the data
     order after ``seek`` against the uninterrupted stream; and a full-width
     stage-1 snapshot: its size, sync and async save and restore times, and
     the restored state bit for bit (also when the parameters move while an
     async write is in flight);
  12. ResNet-101 DeepLab at full depth and width (blocks (3, 4, 23, 3),
     heads (6, 12, 18, 24), 21 classes): the warm start in memory
     (``init_params``, BN calibrated on N(0, 40) images, heads rescaled, as
     ``tools/calibrate_bn.py`` does); the stage-1 step (batch 20) and the
     stage-2 step (batch 10) with the default configs in fp32, TF32 and bf16
     (1 + 1 pool launches per step, profiles with a batch-norm group); tiny
     ResNet steps card vs CPU (fp32 and bf16); a served chunk of 8 in sizes
     mode with the fp32 and the bf16 model (11 + 11 mmgrid launches), masks
     on a small input card vs CPU, and the pseudo ground truth of phase 7's
     images and label sets; then the warm start through the CLIs on phase
     11's tree: ``calibrate_bn`` (statistics moved, the import gives back the
     file's arrays bit for bit), ``train --model resnet101 --weights`` at
     batch 20 with a snapshot and a resumed second process (the frozen BN
     arrays as the file has them), ``test_ms --model-name resnet101`` (masks
     in range, mmgrid launches), and a full-width ResNet snapshot's size,
     save and restore times;
  13. COCO at 81 classes (VGG16-LargeFOV, heads (6, 12, 18, 24)) and the
     other CRF engines: (a) the mmgrid kernels against their plain versions
     at a served chunk's shapes for 8 images of 640x480 (COCO's most common
     size; 1536 tiles of 1600 pixels, gc = 21, C = 81, where the splat
     takes its unstaged template) on photo-like and pixel-noise guides,
     uniform and integer values, two launches equal, timed as phase 3 times
     them (the plain versions in chunks of 128 tiles); (b) the served chunk
     ``predict_masks_device(sizes=[481], smooth=True)`` on 8 such images:
     ms/chunk, 11 + 11 launches, no ``dense_operands``, masks uint8 < 81, a
     profile, a small input card vs CPU; (c) ``COCOCueDataset(ship_uint8=
     True)`` batches from a PNG-encoded synthetic tree and the default
     ``Stage1Config`` at 81 classes with ``input_mean=COCO_MEAN`` (batch 20
     @ 321^2): 2 warm-up and 5 timed steps, 5 + 5 pool launches per step,
     peak memory, a profile; (d) ``python -m dsrg_tpu_torch.tools.
     synth_check --dataset coco --image-format png`` (200 iterations at
     batch 8 on the ``easy`` set at 321, ``test_coco``'s streaming mIoU and
     ``miou3``, fatal below 0.5), then the train CLI with ``--dataset coco
     --cache-decoded`` at batch 20 (ms/step beside (c)); (e) ``dump_cues
     --grow`` from (d)'s snapshot, ``ap`` on its cue pngs and
     ``show_result --smooth`` on two images, every output read back through
     ``utils/imageio``; (f) ``neutrality_study.engine_neutrality`` at
     375x500x21 (mmgrid, lattice and grid on the card against the native
     permutohedral oracle on the host, fatal below 0.998 agreement) and
     ``crf_fast_neutrality``;
  14. serving export: (a) phase 5's net (its weights from ``SEED``) exported
     with ``serving.export_pipeline`` (sizes (241, 321, 401), CRF on, canvas
     384x512, batch 8: phase 5's chunk program) and loaded with
     ``ServingPipeline``: export and load seconds, bytes; (b) the artifact on
     phase 5's 8 images beside ``predict_masks_device`` (a warm-up, then 3
     timed chunks each): ms/chunk, images/s, peak memory, masks fatal below
     0.999 agreement per image; (c) one artifact chunk under the profiler:
     the mmgrid kernels' launches by kernel name and by the custom ops'
     counters, fatal unless 11 + 11 both ways; (d) ``export_deploy`` at
     (8, 321, 321, 3) against the eager forward with ``floored_softmax``,
     fatal beyond 1e-4 relative; (e) ``python -m dsrg_tpu_torch.tools.export``
     in both modes on phase 11's ``step_200_params`` (two child processes
     at once, beside (f)'s CPU reference), then a fresh process that loads
     and runs both artifacts without importing jax; (f) the
     ``DenseCRF`` object API at 120x160x21 (Gaussian and bilateral terms, 10
     iterations) on the card against the CPU (fatal beyond 1e-4), and one
     CRF-learning run (``minimize_lbfgs`` on ``tests/test_crf_learning.py``'s
     diagonal problem) on the card, whose objective must fall.
Each phase prints its wall time, and the script its total.  The last lines are a JSON line of kernels, the card's name and power limit,
and ``{"ok": true, "device": {...}}``.  Exits non-zero without that line when
there is no CUDA device or no ``dsrg_tpu_torch`` beside this file.
"""

from __future__ import annotations

import json
import os
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
# the tiny ResNet's bf16 gradient norm (random BN statistics and scales):
# the JAX package and the port sit 1.6-12.7% apart on it over six seeds
# (tests/test_torch_port_resnet.py, S1_BF16_NORM_RTOL), an H100 and the CPU
# 10.9%; the losses hold BF16_CARD_VS_CPU_RTOL
RESNET_BF16_NORM_RTOL = 0.2
# the learning check (dsrg_tpu/tools/synth_check.py: 64 / 16 images at batch
# 8, the bar of a working DSRG stack), 200 iterations, not synth_check's 300:
# the script's time limit; the losses flatten by 150-200 (phase 10's curve)
LEARN_TRAIN, LEARN_VAL, LEARN_ITERS, LEARN_BATCH, LEARN_MIOU = 64, 16, 200, 8, 0.5
LEARN_SIZE = 321  # image, crop and prediction size; cues on its (size - 1) / 8 + 1 grid
GT_SIZES = (321,)  # tools/generate_train_gt.py:48-54
STAGE2_BATCH = 10
# the bf16 pool kernels' ms per step with their former design, the float32
# blocks on bf16 elements (PERF.md section 6; NVIDIA H100 80GB HBM3, 700 W):
# (net, batch) -> kernel -> (two readings timed as the kernel rows are now,
# queued, on one card beside the new design; the time as first recorded,
# from the host's launch rate)
FORMER_BF16_STEP_MS = {
    ("VGG", 20): {"pool_bwd_h": ((0.5273, 0.5299), 0.547), "pool_bwd_w": ((0.8412, 0.8469), 0.865)},
    ("VGG", 10): {"pool_bwd_h": ((0.2962, 0.2983), 0.3089), "pool_bwd_w": ((0.4616, 0.4644), 0.4769)},
    ("ResNet-101", 20): {"pool_bwd_h": ((0.0590, 0.0592), 0.0632), "pool_bwd_w": ((0.1069, 0.1073), 0.1094)},
    ("ResNet-101", 10): {"pool_bwd_h": ((0.0342, 0.0345), 0.0365), "pool_bwd_w": ((0.0617, 0.0621), 0.0646)},
}
BN_RANGE = "frozen_batch_norm"  # the profiler range of the ResNet's batch norm (models/resnet101_deeplab.py)


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
        name, rest = entry, ""
        for m in re.finditer(r"(?<!\d)(\d+)(?=[A-Za-z_])", entry):  # <length><identifier>, as mangled
            ident = entry[m.end(): m.end() + int(m.group(1))]
            if ident.endswith("_kernel"):
                name, rest = ident, entry[m.end() + len(ident):]
                break
        targs = ",".join((["bf16" if "bfloat16" in rest or "bf16" in name else "f32"]
                          if "_kernelI" in entry and "pool" in name else [])
                         + re.findall(r"L[ib](\d+)E", rest.split("Ev")[0]))
        used = re.search(r"Used (\d+) registers", body)
        smem = re.search(r"(\d+) bytes smem", body)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", body)
        out.append(f"{name}<{targs}>: {used.group(1) if used else '?'} registers, "
                   f"{smem.group(1) if smem else 0} bytes static shared memory, spills "
                   f"{'/'.join(spill.groups()) if spill else '?'} bytes")
    return out


def _time_ms_cold(fn, iters: int, flush: torch.Tensor) -> float:
    """Device ms per call of ``fn``, each launch finding the L2 cache holding
    ``flush`` (written just before it, which keeps the card busy while the
    host issues the launch) instead of its own inputs; only the launch is
    timed."""
    fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        pair = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        pair[0].record()
        fn()
        pair[1].record()
        events.append(pair)
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / iters


def _time_ms(fn, iters: int, queued: bool = False) -> float:
    """Ms per call of ``fn``, averaged over ``iters`` calls between two events
    on the card. By default the calls are issued to an idle card, so a call
    that is shorter than its host work reads the host's launch rate. With
    ``queued`` they wait behind a ~25 ms spin of the card and run back to
    back: device time only, the host's launch overhead (tens of us a wrapper
    call) hidden. The kernel rows of phases 3-4 are timed queued."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(50_000_000)
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


def _chunked(fn, n_tiles: int, chunk):
    """``fn(lo, hi)`` over tiles [lo, hi) in chunks of ``chunk`` tiles, joined
    (the plain versions are per tile: a chunk bounds their memory)."""
    if chunk is None:
        return fn(0, n_tiles)
    return torch.cat([fn(lo, min(lo + chunk, n_tiles)) for lo in range(0, n_tiles, chunk)])


def _kernel_case(mk, tmm, dev, rng, what: str, guide, channels, valid=None, row_c: int = 21,
                 chunk=None, integer: bool = False) -> tuple:
    """Each mmgrid kernel vs its plain version on a plan of ``guide`` at the
    serving path's shapes, for each channel count; the splat's values zero
    outside ``valid`` (N, H, W) where given, as a masked canvas's are.
    ``chunk``: tiles per call of the plain versions and per build of the
    dense yardstick's operands (COCO's 81 classes would need ~40 GB at
    once); ``integer``: integer values in [0, 4) instead of uniform ones.
    Returns the kernels' rows at C = ``row_c`` and the plan's build time in ms."""
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
    # a large slab is drawn on the card (4.6 GB of fp32 normals at C = 81)
    gen = None if chunk is None else torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    for c in channels:
        q = gc * c
        if integer:
            values = torch.from_numpy(rng.integers(0, 4, (t, c, px)).astype(np.float32)).to(dev)
        else:
            values = torch.from_numpy(rng.random((t, c, px), dtype=np.float32)).to(dev)
        if valid is not None:
            values = values * plan._tile_cf(plan.pad_cf(valid[:, None].float()))
        if gen is None:
            slab = torch.from_numpy(rng.standard_normal((t, nb, q), dtype=np.float32)).to(dev).bfloat16()
        else:
            slab = torch.randn((t, nb, q), generator=gen, device=dev).bfloat16()
        u = torch.empty((t, px, q), dtype=torch.bfloat16, device=dev)
        for lo in range(0, t, chunk or t):
            hi = min(lo + (chunk or t), t)
            ut = (wr_t[lo:hi].float()[:, :, None, :] * values[lo:hi].bfloat16().float()[:, None]).bfloat16()
            u[lo:hi] = ut.reshape(hi - lo, q, px).transpose(1, 2)
            del ut
        wbg_t = wbg.transpose(1, 2).contiguous()
        gemm_flop = 2.0 * t * px * nb * q  # the dense form multiplies the zeros too
        sparse_flop = 2.0 * t * px * 8 * c  # 4 corners x 2 r bins per pixel and channel, fp32
        weights = 16 * t * px  # idx 4 + wbg4 8 + wr2 4 bytes per pixel
        dense_weights = 2 * t * px * nb + 2 * t * gc * px

        def part(x, lo, hi):
            return tuple(a[lo:hi] for a in x)

        # bytes a kernel must move: its sparse weights, the pixels' order, values
        # in and the fp32 slab out (splat); sparse weights, the reached cells of
        # the bf16 slab in and values out (slice)
        cases = {
            "mmgrid_splat": (
                lambda: mk.splat(*sparse, values, gc, plan.perm),
                lambda: _chunked(lambda lo, hi: mk.splat_plain(*part(sparse, lo, hi), values[lo:hi], gc), t, chunk),
                lambda: torch.bmm(wbg_t, u), 4 * t * px + 4 * t * c * px + 4 * t * nb * q,
                4 * t * c * px + 4 * t * nb * q),
            "mmgrid_slice": (
                lambda: mk.slice(*sparse, slab, gc),
                lambda: _chunked(lambda lo, hi: mk.slice_plain(*part(sparse, lo, hi), slab[lo:hi], gc), t, chunk),
                lambda: torch.bmm(wbg, slab), 2 * reached * c + 4 * t * c * px, 2 * t * nb * q + 4 * t * c * px),
        }
        template = "staged" if mk.splat_staged(px, c) else "unstaged"
        for name, (kern, plain, lib, io_bytes, dense_io_bytes) in cases.items():
            err = _hold(f"{name} C={c}, {what} guide", kern, plain)
            ms = _time_ms(kern, 20, queued=True)
            plain_ms = _time_ms(plain, 3, queued=True)
            lib_ms = _time_ms(lib, 10, queued=True)
            by_bytes, by_ops = (weights + io_bytes) / PEAK_BYTES, sparse_flop / PEAK_FP32
            bound_by = "bytes" if by_bytes > by_ops else "operations"
            bound_ms = 1e3 * max(by_bytes, by_ops)
            dense_bound_ms = 1e3 * max((dense_weights + dense_io_bytes) / PEAK_BYTES, gemm_flop / PEAK_BF16)
            print(f"{name} C={c}, {what} guide: kernel {ms:.4f} ms ({ms / bound_ms:.2f}x bound"
                  f"{', splat template ' + template if name == 'mmgrid_splat' else ''}), plain {plain_ms:.4f} ms"
                  f"{' in chunks of ' + str(chunk) + ' tiles' if chunk else ''}, torch.bmm "
                  f"on the dense operands {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
                  f"{(weights + io_bytes) / 1e6:.1f} MB; the dense form's bound {dense_bound_ms:.4f} "
                  f"ms); {(weights + io_bytes) / ms / 1e9:.3f} TB/s", flush=True)
            if c == row_c:
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


def _pool_phase(pk, pooling, dev, batch: int, dtype=torch.float32, pools=POOLS, net: str = "VGG") -> dict:
    """pool_bwd_h / pool_bwd_w vs their plain versions at a train step's
    ``pools`` (VGG's five, or ResNet-101's pool1) at ``batch`` in ``dtype``
    (float32 or bfloat16, the kernels' two element types).  Returns each
    kernel's row, its times the mean per launch over one step's launches."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sfx, elem = pk.ENTRY_SUFFIX[dtype], torch.empty((), dtype=dtype).element_size()

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev).to(dtype)

    def normal(shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    keys = ("ms", "launch_ms", "plain_ms", "library_ms", "bound_ms", "op_bound_ms")
    sums = {n: dict.fromkeys(keys, 0.0) for n in ("pool_bwd_h", "pool_bwd_w")}
    # 256 MB, five L2s, written before each launch of the timing with the L2 flushed
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev) if dtype == BF16 and pools is POOLS else None
    err = {n: 0.0 for n in sums}
    forward = {"ms": 0.0, "former_ms": 0.0, "pad_ms": 0.0}
    for i, (c, h, w, s) in enumerate(pools, 1):
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
        plans = {"pool_bwd_h": pk.plan_h(batch * c, h, wo, ho, 3, s, 1, pk.default_tile_bytes("pool_bwd_h", dtype),
                                         elem),
                 "pool_bwd_w": pk.plan_w(x[..., 0].numel(), w, wo, pk.default_tile_bytes("pool_bwd_w", dtype), elem)}
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
        print(f"{net} pool{i} (batch {batch}, {dtype}) forward: {fwd:.4f} ms with implicit padding; the former "
              f"form {former:.4f} ms, of which its two F.pad copies to -inf {pads:.4f} ms", flush=True)
        forward["ms"] += fwd
        forward["former_ms"] += former
        forward["pad_ms"] += pads
        for name, (wrapper, plain_fn, src, cot, lib, crop) in cases.items():
            def kern(tile_bytes=None):
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
            if dtype == BF16:  # -0 and subnormals (multiples of 2^-133) among them
                fcot[torch.rand(fcot.shape, generator=gen, device=dev) < 0.05] = -0.0
                tiny = torch.rand(fcot.shape, generator=gen, device=dev) < 0.05
                fcot[tiny] = (torch.randint(-127, 128, fcot.shape, generator=gen, device=dev).float()
                              * 2.0 ** -133).to(dtype)[tiny]
            floats = torch.equal(wrapper(src, fcot, 3, s, 1).view(torch.int16 if dtype == BF16 else torch.int32),
                                 plain_fn(src, fcot, 3, s, 1).view(torch.int16 if dtype == BF16 else torch.int32))
            ssrc, scot = _with_specials(src, gen, (0.05, 0.1, 0.3)), _with_specials(fcot, gen, (0.02, 0.02, 0.02))
            sgot, sref = wrapper(ssrc, scot, 3, s, 1), plain_fn(ssrc, scot, 3, s, 1)
            specials = torch.allclose(sgot, sref, rtol=0.0, atol=0.0, equal_nan=True)
            n_nan = int(torch.isnan(sref).sum().item())
            ok = e == 0.0 and same and floats and specials and lib_agrees
            print(f"{net} pool{i} {label} (B, C, H, W) = {(batch, c, h, w)} s{s}: max_abs_err {e}, two "
                  f"launches equal {same}, normal cotangents equal to plain {floats}, with NaN and inf "
                  f"equal to plain {specials} ({n_nan} NaN results), ATen's routing "
                  f"{'agrees' if lib_agrees else 'differs'}: {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise SystemExit(f"{label} disagrees with its plain version or with ATen at pool{i}")
            err[name] = max(err[name], e)
            del got, again, ref, lib_out, fcot, ssrc, scot, sgot, sref
            row = dict(ms=_time_ms(kern, 20, queued=True), launch_ms=_time_ms(kern, 20),
                       plain_ms=_time_ms(plain, 3, queued=True), library_ms=_time_ms(lib, 20, queued=True),
                       bound_ms=1e3 * n_bytes / PEAK_BYTES,
                       # per window k compares for its first maximum, per output element up to k gathered taps
                       op_bound_ms=1e3 * (cot.numel() * 3 + src.numel() * 3) / PEAK_FP32)
            print(f"{net} pool{i} {label} (batch {batch}): kernel {row['ms']:.4f} ms "
                  f"({row['ms'] / max(row['bound_ms'], row['op_bound_ms']):.2f}x bound; {row['launch_ms']:.4f} ms "
                  f"from the host's launch rate), plain {row['plain_ms']:.4f} ms, "
                  f"ATen max_pool2d_with_indices_backward {row['library_ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.4f} ms (bytes: {n_bytes / 1e6:.1f} MB; operations "
                  f"{row['op_bound_ms']:.4f} ms); {n_bytes / row['ms'] / 1e6:.1f} GB/s; blocks of "
                  f"{plan.rows} rows x {plan.planes} planes, {plan.smem} bytes of shared memory", flush=True)
            if i in (1, 4) and batch == TRAIN_BATCH and pools is POOLS:
                # the largest pool and a one-band one at other tile sizes
                tile = pk.default_tile_bytes(name, dtype)
                other = {t: _time_ms(lambda: kern(t), 20, queued=True) for t in (tile // 2, tile * 2)}
                print(f"pool{i} {label} at other tile sizes: "
                      + ", ".join(f"{t} bytes {ms:.4f} ms" for t, ms in other.items()), flush=True)
            if i in (4, 5) and dtype == BF16 and pools is POOLS:
                # 103 MB a launch, two L2s: timed again as a step finds them, its L2 full of other data
                print(f"{net} pool{i} {label} (batch {batch}) with the L2 flushed before each launch: "
                      f"{_time_ms_cold(kern, 20, flush):.4f} ms", flush=True)
            for k in keys:
                sums[name][k] += row[k]
        del x, xp, yw_full, idx_w, yw, ywp, y_full, idx_h, g, gw, g_lib, gw_lib, cases
        torch.cuda.empty_cache()
    print(f"{net}: the pools' forward over the {len(pools)} pool(s) of a step at batch {batch} in {dtype}: "
          f"{forward['ms']:.4f} ms "
          f"with implicit padding; the former form {forward['former_ms']:.4f} ms, of which the F.pad copies to "
          f"-inf {forward['pad_ms']:.4f} ms", flush=True)
    rows = {}
    del flush
    for name, tot in sums.items():
        bound = max(tot["bound_ms"], tot["op_bound_ms"])
        former = FORMER_BF16_STEP_MS.get((net, batch), {}).get(name) if dtype == BF16 else None
        before = (f"; the former design {' / '.join(map(str, former[0]))} ms queued on one card beside this "
                  f"design's, {former[1]} ms as recorded from the launch rate" if former else "")
        print(f"{net}: {name + sfx} over the {len(pools)} pool(s) of a step at batch {batch}: kernel "
              f"{tot['ms']:.4f} ms queued ({tot['ms'] / bound:.2f}x bound), {tot['launch_ms']:.4f} ms from the "
              f"host's launch rate{before}; plain "
              f"{tot['plain_ms']:.4f} ms, ATen {tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms",
              flush=True)
        per = {k: v / len(pools) for k, v in tot.items()}
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
    if "nccl" in name:
        return "all-reduce"
    # cuDNN's FFT convolutions run complex ("cf32") GEMMs between their FFTs
    if any(k in name for k in ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd", "cudnn", "fft",
                               "cf32")):
        return "convolution"
    if "gemm" in name:
        return "gemm"
    return "other"


def _profile(title: str, fn, out_file: Path, conv_shapes: bool = False) -> dict:
    """``fn()`` once under torch.profiler: device time by kernel group;
    ``conv_shapes``: also the convolutions' device time by input shapes
    (which layers the convolution time goes to).  Returns the kernel
    launches by group, as the profiler counted them."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=conv_shapes) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    groups: dict = {}
    counts: dict = {}
    kernels = []
    for evt in prof.key_averages():
        # the ResNet's batch norm is elementwise work inside a named range; the
        # range's own device-side annotation is no kernel
        if evt.device_type != torch.autograd.DeviceType.CUDA or evt.key == BN_RANGE:
            continue
        ms = evt.self_device_time_total / 1e3
        group = _group(evt.key)
        groups[group] = groups.get(group, 0.0) + ms
        counts[group] = counts.get(group, 0) + evt.count
        kernels.append((ms, evt.count, evt.key))
    # the kernels launched inside the batch-norm ranges (forward and backward)
    # move from "other" to a group of their own
    bn_ms = sum(evt.device_time_total for evt in prof.events()
                if evt.name == BN_RANGE and evt.device_type == torch.autograd.DeviceType.CPU) / 1e3
    if bn_ms:
        groups["batch norm"] = bn_ms
        groups["other"] = groups.get("other", 0.0) - bn_ms
    busy = sum(groups.values())
    if busy == 0.0:
        print(f"profile ({title}): the profiler recorded no device time", flush=True)
        return counts
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
    return counts


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


def _train_phase(pk, rng, out_dir: Path) -> tuple:
    """The stage-1 step at full width; returns the pool kernels' launches
    and the ms per step."""
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

    _profile("train, one step", lambda: step(batch), out_dir / "chip_smoke_train_profile.txt", conv_shapes=True)

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
    # phase 6b reuses the model, its state and the batch
    return launches, 1e3 * dt, {"state": state, "cfg": cfg, "batch": batch}


def _train_card_vs_cpu(rng, bf16: bool = False, resnet: bool = False) -> None:
    """One tiny step from the same weights on the card and on the CPU; with
    ``bf16``, a bf16 model with the bf16 CRF (``crf_fast``); with ``resnet``
    a ResNet (blocks (1, 1, 2, 1)) with random BN statistics and the ResNet
    warm start's solver (base_lr 1e-4, clip 10) in place of the VGG."""
    from dsrg_tpu_torch.config import Stage1Config
    from dsrg_tpu_torch.models import DeepLabLargeFOV, ResNet101DeepLab
    from dsrg_tpu_torch.train.stage1 import init_stage1, make_stage1_step

    what = ("ResNet " if resnet else "") + ("bf16 step" if bf16 else "step")
    solver = {"base_lr": 1e-4, "clip_gradients": 10.0} if resnet else {}
    cfg = Stage1Config(num_classes=6, batch_size=2, crop_size=41, cue_size=6, crf_iters=2, mirror=False,
                       compute_dtype="bfloat16" if bf16 else "float32", crf_fast=bf16, **solver)
    batch = {k: v.numpy() for k, v in _train_batch(rng, cfg, "cpu").items()}
    dtype = BF16 if bf16 else torch.float32

    def build():
        if resnet:
            return ResNet101DeepLab(num_classes=6, stage_blocks=(1, 1, 2, 1), head_dilations=(2, 4),
                                    compute_dtype=dtype)
        return DeepLabLargeFOV(num_classes=6, head_dilations=(2, 4), dropout_rate=0.0, compute_dtype=dtype)

    stats = {k: torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
             for k, v in build().state_dict().items() if "running" in k}
    out = {}
    for dev in ("cuda", "cpu"):
        model = build()
        state = init_stage1(model, cfg, device=dev)  # the same seeded weights on both
        model.load_state_dict({**model.state_dict(), **stats})
        m = make_stage1_step(model, cfg, state.optimizer, state.generator)(batch)
        out[dev] = {k: v.item() for k, v in m.items()}
    print(f"card vs CPU {what}: card {out['cuda']}, CPU {out['cpu']}", flush=True)
    rtol = BF16_CARD_VS_CPU_RTOL if bf16 else CARD_VS_CPU_RTOL
    for key in ("loss", "loss_seed", "loss_constrain", "grad_norm"):
        a, b = out["cuda"][key], out["cpu"][key]
        # in bf16 the constrain term (~1e-3 of the loss) is judged on the loss's scale
        scale = abs(out["cpu"]["loss"]) if bf16 and key == "loss_constrain" else abs(b)
        tol = RESNET_BF16_NORM_RTOL if bf16 and resnet and key == "grad_norm" else rtol
        if not abs(a - b) <= tol * scale:
            raise SystemExit(f"card vs CPU {what}: {key} {a} vs {b}")
    if out["cuda"]["seed_pixels"] != out["cpu"]["seed_pixels"]:
        raise SystemExit(f"card vs CPU {what}: seed_pixels differ")


def _timed_pseudo_gt(mk, predictor, images, label_sets, what: str) -> tuple:
    """``predict_mask(sizes=GT_SIZES, restrict_labels=...)`` of each image
    after a warm-up, 11 + 11 mmgrid launches each and no dense operands,
    with ms/image split into host zooms, host softmax, forward and CRF;
    returns the masks and the launches."""
    from dsrg_tpu_torch import inference

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
                raise SystemExit(f"{what} kernel launches {counts} for one image, expected 11 of each")
            for k in launches:
                launches[k] += counts[k]
    finally:
        del predictor.scores_at_size
        for name, fn in originals.items():
            setattr(inference, name, fn)
    total = sum(per_image)
    rest = total - sum(split.values())
    n = len(images)
    print(f"main path ({what}, predict_mask): {1e3 * total / n:.2f} ms/image (per image "
          f"{', '.join(f'{1e3 * t:.2f}' for t in per_image)}); host zooms {1e3 * split['zoom'] / n:.2f}, "
          f"host softmax {1e3 * split['softmax'] / n:.2f}, forward {1e3 * split['forward'] / n:.2f}, CRF "
          f"{1e3 * split['crf'] / n:.2f}, the rest (log, unary upload, mask download) {1e3 * rest / n:.2f} "
          f"ms/image (host clock, synchronised); launches {launches}, dense_operands calls "
          f"{mk.dense_operands.calls}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB",
          flush=True)
    if mk.dense_operands.calls:
        raise SystemExit(f"the {what} path built the dense operands on the card")
    return masks, launches


def _pseudo_gt_phase(mk, predictor, cpu_pred, images, rng, out_dir: Path) -> tuple:
    """The pseudo ground truth at full width; returns the mmgrid kernels'
    launches, the restricted masks and the images' label sets."""
    import tempfile

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

    masks, launches = _timed_pseudo_gt(mk, predictor, images, label_sets, "pseudo-GT")
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
    return launches, masks, label_sets


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


def _stage2_phase(pk, images, masks, out_dir: Path) -> tuple:
    """The stage-2 step at full width on phase 7's pseudo ground truth;
    returns the pool kernels' launches and the ms per step."""
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
    _profile("stage 2, one step", lambda: step(batch), out_dir / "chip_smoke_stage2_profile.txt", conv_shapes=True)
    keep = {"state": state, "cfg": cfg, "batch": batch}  # for phase 8b
    del state, step, model, batch, metrics

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
    return launches, 1e3 * dt, keep


# data parallelism (phases 6b, 8b, 8c): the one card is a one-rank NCCL group (NCCL
# refuses two ranks of one communicator on one card; tests/test_torch_port_
# parallel.py holds two ranks against the JAX package on the CPU)
DP_STEPS = 3
DP_PAD = (24, 12)  # stage 1's batch 20 and stage 2's 10, padded as over 8 / 4 ranks
DP_LOSS_RTOL, DP_PARAM_RTOL, DP_PARAM_ATOL = 1e-5, 2e-5, 1e-7  # tests/test_dp_equivalence.py's bounds


def _nccl_group():
    """A one-rank NCCL group on 127.0.0.1 and the mesh over it.
    ``parallel.distributed.initialize`` does nothing for one process, as
    JAX's does; ``init_group`` is its body."""
    import socket

    from dsrg_tpu_torch.parallel import make_mesh
    from dsrg_tpu_torch.parallel.distributed import init_group

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    init_group(f"127.0.0.1:{port}", 1, 0, device="cuda")
    mesh = make_mesh()
    print(f"data parallelism: NCCL {'.'.join(map(str, torch.cuda.nccl.version()))} group of world size "
          f"{mesh.world_size} on {mesh.device}, made in {time.perf_counter() - t0:.2f} s", flush=True)
    return mesh


def _state_copy(state) -> tuple:
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            {k: v.clone() for k, v in state.optimizer.velocity.items()},
            state.generator.get_state(), state.optimizer.step_count)


def _state_back(state, copy) -> None:
    params, velocity, generator, step = copy
    state.model.load_state_dict(params)
    for k, v in velocity.items():
        state.optimizer.velocity[k].copy_(v)
    state.generator.set_state(generator)
    state.optimizer.step_count = step


def _held(what: str, got: tuple, ref: tuple) -> bool:
    """Loss within DP_LOSS_RTOL and every parameter within DP_PARAM_RTOL /
    DP_PARAM_ATOL of ``ref`` (metrics, parameters); returns whether the
    bits are equal."""
    (m, params), (m_ref, params_ref) = got, ref
    if not abs(m["loss"] - m_ref["loss"]) <= DP_LOSS_RTOL * abs(m_ref["loss"]):
        raise SystemExit(f"{what}: loss {m['loss']} vs {m_ref['loss']}")
    worst = 0.0
    for k, t in params_ref.items():
        err = (params[k] - t).abs() - DP_PARAM_RTOL * t.abs()
        worst = max(worst, float(err.max()))
    if worst > DP_PARAM_ATOL:
        raise SystemExit(f"{what}: a parameter exceeds {DP_PARAM_RTOL} relative + {DP_PARAM_ATOL} by {worst}")
    bits = m == m_ref and all(torch.equal(params[k], t) for k, t in params_ref.items())
    print(f"  {what}: loss {m['loss']:.8g} vs {m_ref['loss']:.8g}, within the bounds; bits equal: {bits}",
          flush=True)
    return bits


def _dp_step_phase(pk, what: str, ctx: dict, make, plain_ms: float, pad_to: int, mesh, out_dir: Path) -> dict:
    """A phase's step again as a data-parallel step over ``mesh``, from the
    same weights and batch as its plain step: held to it at the default
    config; the batch padded to ``pad_to`` rows (mirroring and dropout off:
    the draws of a padded batch are not the unpadded one's) held to the
    unpadded step; DP_STEPS timed steps with 5 + 5 pool launches each, and
    one profiled.  Returns the pool launches of the timed steps."""
    import dataclasses

    from dsrg_tpu_torch.parallel import data_parallel_step, shard_batch
    from dsrg_tpu_torch.parallel.mesh import all_reduce_sum, pad_batch_to_rows

    state, cfg, batch = ctx["state"], ctx["cfg"], ctx["batch"]
    model, start = state.model, _state_copy(state)

    def run(config, step_batch, dp: bool) -> tuple:
        _state_back(state, start)
        step = make(model, config, state.optimizer, state.generator, axis_name=mesh if dp else None)
        if dp:
            step = data_parallel_step(step, mesh)
            step_batch = shard_batch(step_batch, mesh)
        m = {k: v.item() for k, v in step(step_batch).items()}
        return m, {k: v.clone() for k, v in model.state_dict().items()}

    plain = run(cfg, batch, False)
    _held(f"{what}, data-parallel vs plain step", run(cfg, batch, True), plain)
    again = run(cfg, batch, False)
    print(f"  {what}: two plain steps from one state equal in bits: "
          f"{all(torch.equal(again[1][k], t) for k, t in plain[1].items())}", flush=True)
    plain_cfg, rate = dataclasses.replace(cfg, mirror=False), model.dropout.rate
    model.dropout.rate = 0.0
    # the padded shapes are run once: cuDNN's heuristics, not a timed search
    torch.backends.cudnn.benchmark = False
    try:
        host = {k: v.cpu().numpy() for k, v in batch.items()}
        padded = {k: torch.from_numpy(v).to(mesh.device) for k, v in pad_batch_to_rows(host, pad_to).items()}
        _held(f"{what}, padded {cfg.batch_size}->{pad_to} (mirror and dropout off) vs unpadded",
              run(plain_cfg, padded, True), run(plain_cfg, batch, False))
    finally:
        model.dropout.rate = rate
        torch.backends.cudnn.benchmark = True
    _state_back(state, start)
    step = data_parallel_step(make(model, cfg, state.optimizer, state.generator, axis_name=mesh), mesh)
    local = shard_batch(batch, mesh)
    step(local)
    torch.cuda.synchronize()
    _zero_counts(pk)
    t0 = time.perf_counter()
    metrics = [step(local) for _ in range(DP_STEPS)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / DP_STEPS
    launches = _launch_counts(pk)
    if not all(np.isfinite(v.item()) for m in metrics for v in m.values()):
        raise SystemExit(f"{what}: non-finite data-parallel metrics")
    print(f"main path ({what}, data-parallel over NCCL, world size {mesh.world_size}): {1e3 * dt:.1f} ms/step "
          f"over {DP_STEPS} steps, against the plain step's {plain_ms:.1f} ms; launches {launches}", flush=True)
    if launches != {n: 0 if n.endswith("_bf16") else 5 * DP_STEPS for n in launches}:
        raise SystemExit(f"{what}: data-parallel pool launches {launches}, expected {5 * DP_STEPS} of each fp32 one")
    # the reduction alone: one rank's NCCL all-reduce may copy nothing, the
    # concatenation and the split remain
    grads = [torch.zeros_like(p) for p in state.optimizer.params.values()]
    grads += [torch.zeros((), device=mesh.device) for _ in range(5)]
    all_reduce_sum(grads, mesh)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(10):
        all_reduce_sum(grads, mesh)
    ev[1].record()
    torch.cuda.synchronize()
    ar_ms = ev[0].elapsed_time(ev[1]) / 10
    print(f"  {what}: the coalesced all-reduce of {sum(g.numel() for g in grads)} fp32 values (concatenation, "
          f"NCCL all_reduce, split) {ar_ms:.3f} ms, {ar_ms / (1e3 * dt):.4f} of the data-parallel step", flush=True)
    _profile(f"{what}, data-parallel, one step", lambda: step(local),
             out_dir / f"chip_smoke_dp_{what.replace(' ', '').replace('-', '')}_profile.txt")
    return launches


def _dp_serving(mk, mesh, params, images, plain_masks) -> dict:
    """``Predictor(mesh=...)`` on phase 5's chunk in sizes mode with the CRF:
    the masks of ``predict_masks_device``, 11 + 11 mmgrid launches."""
    from dsrg_tpu_torch.inference import Predictor
    from dsrg_tpu_torch.models import DeepLabLargeFOV

    predictor = Predictor(DeepLabLargeFOV(num_classes=21), params, num_classes=21, mesh=mesh)
    predictor.predict_masks_device(images, sizes=SIZES)  # warm-up
    torch.cuda.synchronize()
    mk.splat.launches = mk.slice.launches = 0
    t0 = time.perf_counter()
    masks = predictor.predict_masks_device(images, sizes=SIZES)
    dt = time.perf_counter() - t0
    counts = {"mmgrid_splat": mk.splat.launches, "mmgrid_slice": mk.slice.launches}
    equal = all(np.array_equal(a, b) for a, b in zip(masks, plain_masks))
    print(f"main path (served chunk over a mesh of {len(mesh.devices)} device): {1e3 * dt:.1f} ms/chunk of "
          f"{len(images)}, launches {counts}, masks equal to predict_masks_device's: {equal}", flush=True)
    if counts != {"mmgrid_splat": 11, "mmgrid_slice": 11}:
        raise SystemExit(f"served chunk over a mesh: kernel launches {counts}, expected 11 of each")
    if not equal:
        raise SystemExit("served chunk over a mesh: masks differ from predict_masks_device's")
    return counts


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


def _timed_steps(pk, what: str, precision: str, step, batch, n_images: int, out_dir: Path,
                 pools: int = 5) -> dict:
    """Two warm-up and TRAIN_STEPS timed steps of ``step``, the pool kernels'
    launches by element type (``pools`` + ``pools`` per step, of the
    precision's type: 5 for VGG, 1 for ResNet-101), peak
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
    fp32, bf16 = (0, pools * TRAIN_STEPS) if precision == "bf16" else (pools * TRAIN_STEPS, 0)
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
    """Both train steps at full width in fp32 with TF32 and in bf16 (their
    fp32 runs, TF32 off, are phases 6 and 8); a served chunk with a bf16
    model; a tiny bf16 step card vs CPU.  Returns the pool and mmgrid
    kernels' launches of these runs."""
    from dsrg_tpu_torch.config import Stage1Config, Stage2Config
    from dsrg_tpu_torch.inference import Predictor
    from dsrg_tpu_torch.models import DeepLabLargeFOV
    from dsrg_tpu_torch.train import stage1, stage2

    launches = dict.fromkeys(("pool_bwd_h", "pool_bwd_w", "pool_bwd_h_bf16", "pool_bwd_w_bf16"), 0)
    try:
        for what, cfg_cls, batch_size, mod in (("stage 1", Stage1Config, TRAIN_BATCH, stage1),
                                               ("stage 2", Stage2Config, STAGE2_BATCH, stage2)):
            for precision, tf32 in PRECISIONS[1:]:  # fp32: phases 6 and 8 run the same steps
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


# the recipe on files (dsrg_tpu/tools/synth_check.py --two-stage with the CRF
# on, at the reference's batches for the trainers' own runs)
RECIPE_ITERS, RECIPE_BATCH = LEARN_ITERS, 8
GEOM_ITERS, GEOM_EVERY, GEOM_RESUME_TO, GEOM_F_ITERS = 12, 6, 18, 15
KERNEL_NAMES = ("mmgrid_splat", "mmgrid_slice", "pool_bwd_h", "pool_bwd_w", "pool_bwd_h_bf16", "pool_bwd_w_bf16")


def _run_cli(module: str, argv: list, log: Path) -> list:
    """``python -m <module> <argv>`` from the checkout's root, its output
    kept in ``log``; returns [(seconds since the start, line)].  Fails on a
    non-zero exit."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-u", "-m", module] + [str(a) for a in argv]
    t0 = time.perf_counter()
    lines = []
    log.parent.mkdir(parents=True, exist_ok=True)
    with open(log, "w") as f, subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True) as proc:
        for line in proc.stdout:
            f.write(line)
            lines.append((time.perf_counter() - t0, line.rstrip("\n")))
        rc = proc.wait()
    if rc != 0:
        tail = "\n".join(line for _, line in lines[-25:])
        raise SystemExit(f"{module} exited {rc} after {time.perf_counter() - t0:.1f} s (log {log}):\n{tail}")
    return lines


def _launch_lines(lines) -> list:
    return [json.loads(line.split(":", 1)[1]) for _, line in lines if line.startswith("kernel launches:")]


def _display_ms(lines, first: int, last: int, batch: int) -> tuple:
    """Steady ms/step from the arrival of the display lines ``iter first``
    and ``iter last`` (each ends in a synchronising metrics transfer), and the
    StepTimer's p50 over the display window of the last one."""
    at = {}
    p50 = None
    for t, line in lines:
        m = re.match(r"iter (\d+): loss = \S+(?: \(ms/iter p50 (\d+), p90 \d+, max \d+; ([\d.]+) img/s\))?", line)
        if m:
            at[int(m.group(1))] = t
            if int(m.group(1)) == last and m.group(2):
                p50 = float(m.group(2))
    ms = 1e3 * (at[last] - at[first]) / (last - first)
    return ms, batch * 1e3 / ms, p50


def _check_masks(mask_dir: Path, ids, shape) -> None:
    from dsrg_tpu_torch.utils.imageio import read_mask

    for i in ids:
        m = read_mask(str(mask_dir / f"{i}.png"))
        if m.shape != shape or m.dtype != np.uint8 or int(m.max()) >= 21:
            raise SystemExit(f"recipe: bad mask {mask_dir / i}.png: {m.shape} {m.dtype} max {m.max()}")


def _snapshot_checks(dev, ckpt_dir: Path, family=None) -> None:
    """A full-width stage-1 state of ``family`` (VGG16-LargeFOV by default):
    the snapshot's size, sync and async save and restore times, and the
    restored state bit for bit (parameters and buffers, velocities, step,
    the card's generator), also when the parameters move right after an
    async save."""
    from dsrg_tpu_torch.config import Stage1Config
    from dsrg_tpu_torch.models import DeepLabLargeFOV
    from dsrg_tpu_torch.train import checkpoint as ckpt
    from dsrg_tpu_torch.train.stage1 import init_stage1

    family = family or DeepLabLargeFOV

    def make(seed):
        state = init_stage1(family(num_classes=21), Stage1Config(seed=seed), device=dev)
        for buf in state.model.buffers():  # BN statistics of their own per seed
            buf.copy_(torch.rand(buf.shape, generator=torch.Generator(device=dev).manual_seed(seed), device=dev))
        gen = torch.Generator(device=dev).manual_seed(seed)
        for v in state.optimizer.velocity.values():
            v.copy_(torch.randn(v.shape, generator=gen, device=dev))
        state.optimizer.step_count = 1000 + seed
        torch.rand(1000, generator=state.generator, device=dev)  # move the random stream on
        return state

    def snap(state):
        return ({k: v.clone() for k, v in state.model.state_dict().items()},
                {k: v.clone() for k, v in state.optimizer.velocity.items()},
                state.step, state.generator.get_state().clone())

    def same(a, b) -> bool:
        return (all(torch.equal(a[0][k], b[0][k]) for k in a[0]) and all(torch.equal(a[1][k], b[1][k]) for k in a[1])
                and a[2] == b[2] and torch.equal(a[3], b[3]))

    saved = make(1)
    want = snap(saved)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = ckpt.save_checkpoint(str(ckpt_dir / "sync"), saved, saved.step)
    sync_ms = 1e3 * (time.perf_counter() - t0)
    writer = ckpt.AsyncCheckpointWriter()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    apath = writer.save(str(ckpt_dir / "async"), saved, saved.step)
    async_ms = 1e3 * (time.perf_counter() - t0)
    with torch.no_grad():  # the step's in-place update, while the write is in flight
        for p in saved.model.parameters():
            p.add_(1.0)
    writer.close()
    async_total_ms = 1e3 * (time.perf_counter() - t0)
    size = os.path.getsize(path)
    for what, p in (("sync", path), ("async", apath)):
        restored = make(2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.restore_checkpoint(p, restored)
        torch.cuda.synchronize()
        restore_ms = 1e3 * (time.perf_counter() - t0)
        ok = same(snap(restored), want)
        print(f"{family.__name__} snapshot ({what}): {size} bytes ({size / 2**20:.1f} MiB) for "
              f"{sum(t.numel() for t in want[0].values())} parameters and buffers + velocities; restore {restore_ms:.1f} ms; "
              f"restored state equals the saved one bit for bit: {ok}", flush=True)
        if not ok:
            raise SystemExit(f"snapshot ({what}): the restored state differs from the saved one")
        del restored
    print(f"{family.__name__} snapshot save: sync {sync_ms:.1f} ms; async {async_ms:.1f} ms to return (host copies), "
          f"{async_total_ms:.1f} ms to the file on disk", flush=True)
    del saved
    torch.cuda.empty_cache()


def _recipe_phase(dev, out_dir: Path, in_memory_ms: dict) -> dict:
    """The recipe on files: a PNG-encoded synthetic tree, the supervised
    ``run_recipe`` (every phase a ``python -m dsrg_tpu_torch.tools.*``
    child on the card), the trainers at the reference's batches with a
    snapshot and a resume, and the snapshot's size and times.  The kernels'
    counts are the children's own (each starts at 0 and prints them when it
    ends); returns their sums."""
    import dataclasses
    import shutil

    from dsrg_tpu_torch.data import synth
    from dsrg_tpu_torch.data.voc import Stage1Dataset
    from dsrg_tpu_torch.data.cues import CueDB
    from dsrg_tpu_torch.tools.synth_check import _miou3
    from dsrg_tpu_torch.utils import imageio

    base = out_dir / "recipe"
    shutil.rmtree(base, ignore_errors=True)
    root, work, logs = base / "data", base / "work", base / "logs"
    spec = dataclasses.replace(synth.PROFILES["easy"], crop_size=LEARN_SIZE, cue_grid=(LEARN_SIZE - 1) // 8 + 1,
                               size_min=LEARN_SIZE, size_max=LEARN_SIZE)
    t0 = time.perf_counter()
    synth.make_dataset(str(root), LEARN_TRAIN, LEARN_VAL, spec, seed=SEED, encode_image=imageio.write_png)
    train_ids = (root / "train_aug_id.txt").read_text().split()
    val_ids = (root / "val_id.txt").read_text().split()
    print(f"recipe: the easy tree at {LEARN_SIZE}, {len(train_ids)} train + {len(val_ids)} val images, PNG-encoded "
          f"(no PIL), written in {time.perf_counter() - t0:.2f} s", flush=True)

    counts = dict.fromkeys(KERNEL_NAMES, 0)

    def add(launches):
        for k in KERNEL_NAMES:
            counts[k] += launches.get(k, 0)

    lines = _run_cli("dsrg_tpu_torch.tools.run_recipe", [
        "--pascal-dir", root, "--list-dir", root, "--cues", root / "cues.pickle", "--work-dir", work,
        "--stage1-iters", RECIPE_ITERS, "--stage2-iters", RECIPE_ITERS, "--batch-size", RECIPE_BATCH,
        "--crop-size", LEARN_SIZE, "--test-sizes", LEARN_SIZE, "--test-scales", "1.0", "--dtype", "float32",
        "--display", 50], logs / "run_recipe.log")
    phases = [line for _, line in lines if line.startswith("[recipe] ")]
    rates = [line for _, line in lines if re.match(r"\d+ images in ", line)]
    losses = [line for _, line in lines if line.startswith("iter ")]
    per_phase = _launch_lines(lines)
    print("recipe (supervised, every phase a child process): " + "; ".join(p[9:] for p in phases), flush=True)
    print("recipe: dumps " + "; ".join(rates) + "; trainers' display lines " + " | ".join(losses), flush=True)
    names = ("train --stage s", "test_ms", "train --stage f", "test_ms_f")
    for name, launches in zip(names, per_phase):
        print(f"recipe: {name} kernel launches {launches}", flush=True)
        add(launches)
    pool = {"pool_bwd_h": 5 * RECIPE_ITERS, "pool_bwd_w": 5 * RECIPE_ITERS}
    grid = {"mmgrid_splat": 11, "mmgrid_slice": 11}  # per chunk of 8: mask normalisation + 10 iterations
    expected = [pool, {k: v * len(train_ids) // 8 for k, v in grid.items()}, pool,
                {k: v * len(val_ids) // 8 for k, v in grid.items()}]
    if len(per_phase) != 4 or any(got.get(k) != v for got, want in zip(per_phase, expected) for k, v in want.items()):
        raise SystemExit(f"recipe: kernel launches {per_phase}, expected at least {expected}")
    _check_masks(work / "DSRGOutput", train_ids, (LEARN_SIZE, LEARN_SIZE))
    _check_masks(work / "DSRG_final_output", val_ids, (LEARN_SIZE, LEARN_SIZE))
    quirk = float((work / "DSRG_result_final.txt").read_text().split()[1])
    honest = _miou3(str(root), str(work / "DSRG_final_output"))
    print(f"recipe: val mIoU (reference quirk) {quirk:.4f}, miou3 {honest['miou3']:.4f} over classes "
          f"{honest['classes_present']} (IoU {honest['iou_per_class']}); every mask reads back through "
          f"utils/imageio", flush=True)
    if not honest["miou3"] >= LEARN_MIOU:
        raise SystemExit(f"recipe: miou3 {honest['miou3']} below {LEARN_MIOU}")

    # the trainers at the reference's batches: a snapshot and a resume, then stage f
    snap_s, snap_f = base / "geom-s", base / "geom-f"
    s_args = ["--stage", "s", "--image-dir", root / "JPEGImages", "--input-list", root / "input_list.txt",
              "--cues", root / "cues.pickle", "--snapshot-dir", snap_s, "--snapshot-every", GEOM_EVERY,
              "--display", 2, "--dtype", "float32"]
    batch_s, batch_f = 20, 10  # Stage1Config / Stage2Config defaults
    runs = {}
    runs["s"] = _run_cli("dsrg_tpu_torch.tools.train", s_args + ["--max-iter", GEOM_ITERS], logs / "geom_s.log")
    runs["s resumed"] = _run_cli("dsrg_tpu_torch.tools.train",
                                 s_args + ["--max-iter", GEOM_RESUME_TO, "--auto-resume"], logs / "geom_s_resume.log")
    runs["f"] = _run_cli("dsrg_tpu_torch.tools.train", [
        "--stage", "f", "--root", root, "--pair-list", work / "train_pairs.txt", "--snapshot-dir", snap_f,
        "--weights", work / "model-s" / f"step_{RECIPE_ITERS}_params", "--max-iter", GEOM_F_ITERS,
        "--snapshot-every", GEOM_F_ITERS, "--display", 2, "--dtype", "float32", "--profile-dir", base / "profile-f"],
        logs / "geom_f.log")
    text = {k: [line for _, line in v] for k, v in runs.items()}
    if not any(line.startswith("auto-resume from") and line.endswith(f"step_{GEOM_ITERS}")
               for line in text["s resumed"]) or f"trained steps {GEOM_ITERS} to {GEOM_RESUME_TO}" not in \
            text["s resumed"]:
        raise SystemExit("recipe: the resumed trainer did not continue at step "
                         f"{GEOM_ITERS}:\n" + "\n".join(text["s resumed"][-10:]))
    for name, n_steps, (first, last), batch, mem in (
            ("s", GEOM_ITERS, (8, 12), batch_s, "s"), ("s resumed", GEOM_RESUME_TO - GEOM_ITERS, (14, 18), batch_s, "s"),
            ("f", GEOM_F_ITERS, (4, 10), batch_f, "f")):
        ms, ips, p50 = _display_ms(runs[name], first, last, batch)
        launches = _launch_lines(runs[name])[-1]
        add(launches)
        print(f"trainer CLI (stage {name}, batch {batch} @ {LEARN_SIZE}^2, fp32, TF32 off): {ms:.1f} ms/step, "
              f"{ips:.2f} images/s over steps {first + 1}-{last} (display lines); StepTimer p50 at iter {last} "
              f"{p50} ms/iter (over the display window); in memory (phase "
              f"{6 if mem == 's' else 8}) {in_memory_ms[mem]:.1f} ms/step; launches {launches}", flush=True)
        if launches["pool_bwd_h"] != 5 * n_steps or launches["pool_bwd_w"] != 5 * n_steps:
            raise SystemExit(f"trainer CLI stage {name}: pool launches {launches}, expected {5 * n_steps} each")
    profile = [line for line in text["f"] if line.startswith("profile:")]
    print(f"trainer CLI (stage f) steps 10-14 under --profile-dir: {profile}", flush=True)
    if not profile:
        raise SystemExit("recipe: the stage-f trainer wrote no profile")

    # the resumed run's data: _EpochOrder after seek() against the uninterrupted stream
    cue_db = CueDB(str(root / "cues.pickle"), cue_size=(LEARN_SIZE - 1) // 8 + 1)
    straight = Stage1Dataset(str(root / "JPEGImages"), str(root / "input_list.txt"), cue_db, batch_size=batch_s)
    resumed = Stage1Dataset(str(root / "JPEGImages"), str(root / "input_list.txt"), cue_db, batch_size=batch_s)
    order = [straight._next_index() for _ in range(GEOM_RESUME_TO * batch_s)]
    resumed.seek(GEOM_ITERS)
    tail = [resumed._next_index() for _ in range((GEOM_RESUME_TO - GEOM_ITERS) * batch_s)]
    print(f"resume: the data order of steps {GEOM_ITERS + 1}-{GEOM_RESUME_TO} after seek({GEOM_ITERS}) equals the "
          f"uninterrupted stream's: {tail == order[GEOM_ITERS * batch_s:]}", flush=True)
    if tail != order[GEOM_ITERS * batch_s:]:
        raise SystemExit("resume: the data order after seek() differs")

    _snapshot_checks(dev, base / "ckpt")
    print(f"recipe: kernel launches of phase 11 {counts}", flush=True)
    return counts


# ResNet-101 DeepLab (phase 12): the warm start's weights in memory, then its
# pool1 and both steps, serving, the pseudo ground truth and the CLIs
RESNET_POOL1 = ((64, 161, 161, 2),)  # (channels, H, W, stride) of pool1 at 321^2
RESNET_CALIB_BATCHES, RESNET_CALIB_BATCH, RESNET_CALIB_SIZE = 8, 8, 321
RESNET_CLI_ITERS, RESNET_CLI_RESUME_TO = 4, 6
RESNET_SOLVER = ["--base-lr", "1e-4", "--clip-gradients", "10"]  # the calibrated warm start's (synth_check.py)


def _resnet_weights(dev) -> dict:
    """The ResNet warm start in memory, as ``tools/calibrate_bn.py`` makes
    it: ``init_params`` (seed SEED), BN calibrated on N(0, 40) images at
    321^2, heads rescaled to a score std of 0.5.  Returns the state_dict on
    the host."""
    from dsrg_tpu_torch.models import ResNet101DeepLab
    from dsrg_tpu_torch.tools.calibrate_bn import calibrate
    from dsrg_tpu_torch.train.stage1 import init_params

    model = ResNet101DeepLab(num_classes=21)
    init_params(model, SEED)
    model.to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    shape = (RESNET_CALIB_BATCH, RESNET_CALIB_SIZE, RESNET_CALIB_SIZE, 3)
    std0, std1 = calibrate(model, (torch.randn(shape, generator=gen, device=dev) * 40
                                   for _ in range(RESNET_CALIB_BATCHES)))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"ResNet-101: {n_params} parameters, {sum(b.numel() for b in model.buffers())} BN statistics; "
          f"blocks {model.stage_blocks}, heads {model.head_dilations}; BN calibrated on "
          f"{RESNET_CALIB_BATCHES} batches of {RESNET_CALIB_BATCH} in {time.perf_counter() - t0:.2f} s, score "
          f"std {std0:.3f} -> {std1:.3f}", flush=True)
    weights = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    del model
    torch.cuda.empty_cache()
    return weights


def _resnet_steps(pk, dev, weights, images, gt_masks, out_dir: Path) -> dict:
    """Both steps of the ResNet at full width, batch 20 / 10 with the
    default configs, in fp32 (TF32 off), TF32 and bf16 (stage 1 with
    ``crf_fast``): 1 + 1 pool launches per step; tiny steps card vs CPU.
    Returns the pool kernels' launches."""
    from dsrg_tpu_torch.config import Stage1Config, Stage2Config
    from dsrg_tpu_torch.models import ResNet101DeepLab
    from dsrg_tpu_torch.train import stage1, stage2

    launches = dict.fromkeys(("pool_bwd_h", "pool_bwd_w", "pool_bwd_h_bf16", "pool_bwd_w_bf16"), 0)
    try:
        for what, cfg_cls, batch_size, mod in (("resnet stage 1", Stage1Config, TRAIN_BATCH, stage1),
                                               ("resnet stage 2", Stage2Config, STAGE2_BATCH, stage2)):
            for precision, tf32 in PRECISIONS:
                _set_tf32(tf32)
                bf16 = precision == "bf16"
                extra = {"crf_fast": True} if bf16 and cfg_cls is Stage1Config else {}
                cfg = cfg_cls(batch_size=batch_size, compute_dtype="bfloat16" if bf16 else "float32", **extra)
                model = ResNet101DeepLab(num_classes=cfg.num_classes, compute_dtype=BF16 if bf16 else torch.float32)
                init = stage1.init_stage1 if mod is stage1 else stage2.init_stage2
                make = stage1.make_stage1_step if mod is stage1 else stage2.make_stage2_step
                state = init(model, cfg, device=dev)
                model.load_state_dict(weights)  # the calibrated warm start
                step = make(model, cfg, state.optimizer, state.generator)
                batch = (_train_batch(np.random.default_rng(SEED), cfg, dev) if mod is stage1
                         else _stage2_batch(images, gt_masks, cfg, dev))
                for k, v in _timed_steps(pk, what, precision, step, batch, cfg.batch_size, out_dir, pools=1).items():
                    launches[k] += v
                del state, step, model, batch
                torch.cuda.empty_cache()
    finally:
        _set_tf32(False)
    for bf16 in (False, True):
        _train_card_vs_cpu(np.random.default_rng(SEED), bf16=bf16, resnet=True)
    return launches


def _resnet_serving(mk, dev, weights, images, label_sets, out_dir: Path) -> dict:
    """A served chunk of 8 (sizes mode, CRF on) with the fp32 and the bf16
    model: 11 + 11 mmgrid launches, no dense operands; masks on a small
    input card vs CPU; then the pseudo ground truth of each image.  Returns
    the mmgrid launches."""
    from dsrg_tpu_torch.inference import Predictor
    from dsrg_tpu_torch.models import ResNet101DeepLab

    launches = {"mmgrid_splat": 0, "mmgrid_slice": 0}
    for precision, dtype in (("fp32", torch.float32), ("bf16", BF16)):
        predictor = Predictor(ResNet101DeepLab(num_classes=21, compute_dtype=dtype), weights, num_classes=21,
                              device=dev)
        predictor.predict_masks_device(images, sizes=SIZES)  # warm-up: cuDNN's plans, first launches
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mk.splat.launches = mk.slice.launches = mk.dense_operands.calls = 0
        t0 = time.perf_counter()
        masks = predictor.predict_masks_device(images, sizes=SIZES)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {"mmgrid_splat": mk.splat.launches, "mmgrid_slice": mk.slice.launches}
        print(f"main path (ResNet serving, {precision} model, sizes {SIZES}): {1e3 * dt:.1f} ms/chunk of "
              f"{len(images)}, {len(images) / dt:.2f} images/s, launches {counts}, dense_operands calls "
              f"{mk.dense_operands.calls}, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"classes present {sorted(set(np.unique(np.concatenate([m.ravel() for m in masks])).tolist()))}",
              flush=True)
        if counts != {"mmgrid_splat": 11, "mmgrid_slice": 11} or mk.dense_operands.calls:
            raise SystemExit(f"ResNet serving ({precision}): launches {counts}, expected 11 of each and no "
                             "dense operands")
        for im, m in zip(images, masks):
            if m.shape != im.shape[:2] or m.dtype != np.uint8 or int(m.max()) >= 21:
                raise SystemExit(f"ResNet serving ({precision}): bad mask {m.shape} {m.dtype} max {m.max()}")
        for k in launches:
            launches[k] += counts[k]
        _profile(f"ResNet serving, {precision} model, sizes mode, one chunk",
                 lambda: predictor.predict_masks_device(images, sizes=SIZES),
                 out_dir / f"chip_smoke_resnet_serving_{precision}_profile.txt")
        if precision == "fp32":
            small = _images(np.random.default_rng(SEED), 2, 72, 96)
            cpu_pred = Predictor(ResNet101DeepLab(num_classes=21), weights, num_classes=21, device="cpu")
            on_card = predictor.predict_masks_device(small, sizes=(41, 57), canvas_bucket=16)
            on_cpu = cpu_pred.predict_masks_device(small, sizes=(41, 57), canvas_bucket=16)
            agree = min(float((a == b).mean()) for a, b in zip(on_card, on_cpu))
            print(f"card vs CPU ResNet masks, sizes (41, 57): agreement {agree:.5f}", flush=True)
            if agree <= 0.99:
                raise SystemExit("the ResNet's masks on the card disagree with the CPU's")
            cpu_pred.close()
            gt_masks, counts = _timed_pseudo_gt(mk, predictor, images, label_sets, "ResNet pseudo-GT")
            for i, (im, mask, labels) in enumerate(zip(images, gt_masks, label_sets)):
                present = set(np.unique(mask).tolist())
                if mask.shape != im.shape[:2] or mask.dtype != np.uint8 or not present <= set(labels.tolist()):
                    raise SystemExit(f"ResNet pseudo-GT mask {i}: {mask.shape} {mask.dtype}, labels {present} "
                                     f"outside {labels.tolist()}")
            for k in launches:
                launches[k] += counts[k]
        predictor.close()
        del predictor
        torch.cuda.empty_cache()
    return launches


def _resnet_clis(dev, out_dir: Path) -> dict:
    """The ResNet warm start through the CLIs on phase 11's PNG tree:
    ``calibrate_bn`` writes a ``.caffemodel`` (statistics moved; the
    import gives back the file's arrays bit for bit), ``train --model
    resnet101 --weights`` at batch 20 with a snapshot, a second process
    resumed from it (BN statistics, scale and offset leave both as the file
    has them), ``test_ms --model-name resnet101`` on the val images; then
    a full-width ResNet snapshot's size and times.  Returns the children's
    kernel launches."""
    from dsrg_tpu_torch.models import ResNet101DeepLab
    from dsrg_tpu_torch.models.export_caffe import resnet_variables_to_blobs
    from dsrg_tpu_torch.models.import_caffe import load_caffemodel, resnet_blobs_to_torch
    from dsrg_tpu_torch.train import checkpoint as ckpt

    base = out_dir / "recipe"
    root, work, logs = base / "data", base / "resnet", base / "logs"
    calib, snap = work / "calib.caffemodel", work / "snap"
    counts = dict.fromkeys(KERNEL_NAMES, 0)

    def add(lines):
        for k, v in _launch_lines(lines)[-1].items():
            counts[k] = counts.get(k, 0) + v

    data = ["--image-dir", root / "JPEGImages", "--input-list", root / "input_list.txt", "--cues",
            root / "cues.pickle"]
    work.mkdir(parents=True, exist_ok=True)
    lines = _run_cli("dsrg_tpu_torch.tools.calibrate_bn", data + [
        "--out", calib, "--batches", RESNET_CALIB_BATCHES, "--batch-size", RESNET_CALIB_BATCH],
        logs / "resnet_calibrate_bn.log")
    add(lines)
    print("calibrate_bn: " + "; ".join(line for _, line in lines if line.startswith(("head rescale", "wrote"))),
          flush=True)
    blobs = load_caffemodel(str(calib))
    imported = resnet_blobs_to_torch(blobs, ResNet101DeepLab(num_classes=21).state_dict())
    again = resnet_variables_to_blobs(imported)
    moved = (float(np.abs(blobs["bn_conv1"][0]).mean()), float(np.abs(blobs["bn4b22_branch2b"][1] - 1.0).mean()))
    same = list(again) == list(blobs) and all(
        a.shape == b.shape and np.array_equal(a, b) for name in blobs for a, b in zip(again[name], blobs[name]))
    print(f"calibrate_bn: {calib.stat().st_size} bytes, {len(blobs)} layers; bn_conv1 |mean| {moved[0]:.4f}, "
          f"bn4b22_branch2b |var - 1| {moved[1]:.4f}; the import gives back the file's arrays bit for bit: {same}",
          flush=True)
    if not (moved[0] > 0 and moved[1] > 0):
        raise SystemExit("calibrate_bn: the BN statistics did not move off the identity init")
    if not same:
        raise SystemExit("calibrate_bn: the import does not reproduce the exported arrays")

    s_args = ["--stage", "s", "--model", "resnet101", "--weights", calib, "--snapshot-dir", snap,
              "--snapshot-every", RESNET_CLI_ITERS, "--display", 1, "--dtype", "float32"] + RESNET_SOLVER + data
    runs = {"first": _run_cli("dsrg_tpu_torch.tools.train", s_args + ["--max-iter", RESNET_CLI_ITERS],
                              logs / "resnet_train.log"),
            "resumed": _run_cli("dsrg_tpu_torch.tools.train",
                                s_args + ["--max-iter", RESNET_CLI_RESUME_TO, "--auto-resume"],
                                logs / "resnet_train_resume.log")}
    text = {k: [line for _, line in v] for k, v in runs.items()}
    losses = [float(line.split("loss = ")[1].split()[0]) for k in runs for line in text[k] if line.startswith("iter ")]
    if len(losses) != RESNET_CLI_RESUME_TO or not all(np.isfinite(losses)):
        raise SystemExit(f"ResNet train CLI: losses {losses}")
    if not any(line.startswith("auto-resume from") and line.endswith(f"step_{RESNET_CLI_ITERS}")
               for line in text["resumed"]) or \
            f"trained steps {RESNET_CLI_ITERS} to {RESNET_CLI_RESUME_TO}" not in text["resumed"]:
        raise SystemExit("ResNet train CLI: the resumed process did not continue at step "
                         f"{RESNET_CLI_ITERS}:\n" + "\n".join(text["resumed"][-10:]))
    for name, n_steps in (("first", RESNET_CLI_ITERS), ("resumed", RESNET_CLI_RESUME_TO - RESNET_CLI_ITERS)):
        launches = _launch_lines(runs[name])[-1]
        add(runs[name])
        if launches["pool_bwd_h"] != n_steps or launches["pool_bwd_w"] != n_steps:
            raise SystemExit(f"ResNet train CLI ({name}): pool launches {launches}, expected {n_steps} each")
    ms, ips, p50 = _display_ms(runs["first"], 2, RESNET_CLI_ITERS, TRAIN_BATCH)
    print(f"ResNet train CLI (stage s, batch {TRAIN_BATCH} @ {LEARN_SIZE}^2, fp32, TF32 off, warm start from "
          f"calibrate_bn's file): {ms:.1f} ms/step over steps 3-{RESNET_CLI_ITERS} (display lines), StepTimer p50 "
          f"{p50} ms/iter; losses {losses} (a trend, not checked); the resumed process continued at step "
          f"{RESNET_CLI_ITERS}; launches {_launch_lines(runs['first'])[-1]} / {_launch_lines(runs['resumed'])[-1]}",
          flush=True)
    params = ckpt.load_params(str(snap / f"step_{RESNET_CLI_RESUME_TO}_params"))
    frozen = [k for k in imported if "bn" in k]  # statistics, scale and offset of every BN
    kept = all(torch.equal(params[k], imported[k]) for k in frozen)
    print(f"ResNet train CLI: {len(frozen)} BN arrays after {RESNET_CLI_RESUME_TO} steps equal the file's: {kept}",
          flush=True)
    if not kept:
        raise SystemExit("ResNet train CLI: the frozen BN arrays moved or were not imported")

    val_ids = (root / "val_id.txt").read_text().split()
    lines = _run_cli("dsrg_tpu_torch.tools.test_ms", [
        "--images", root / "val_id.txt", "--dir", root, "--model", snap / f"step_{RESNET_CLI_RESUME_TO}_params",
        "--model-name", "resnet101", "--output", work / "test_ms", "--smooth", "--sizes", LEARN_SIZE],
        logs / "resnet_test_ms.log")
    launches = _launch_lines(lines)[-1]
    add(lines)
    chunks = -(-len(val_ids) // 8)
    print(f"ResNet test_ms ({len(val_ids)} images, CRF): " + "; ".join(
        line for _, line in lines if re.match(r"\d+ images in ", line)) + f"; launches {launches}", flush=True)
    if launches["mmgrid_splat"] != 11 * chunks or launches["mmgrid_slice"] != 11 * chunks:
        raise SystemExit(f"ResNet test_ms: mmgrid launches {launches}, expected {11 * chunks} each")
    _check_masks(work / "test_ms", val_ids, (LEARN_SIZE, LEARN_SIZE))

    _snapshot_checks(dev, work / "ckpt", ResNet101DeepLab)
    return counts


def _resnet_phase(pk, mk, dev, images, gt_masks, label_sets, out_dir: Path) -> dict:
    """Phase 12: ResNet-101 DeepLab at full depth and width; returns the
    kernels' launches of its main paths."""
    weights = _resnet_weights(dev)
    launches = _resnet_steps(pk, dev, weights, images, gt_masks, out_dir)
    launches.update(_resnet_serving(mk, dev, weights, images, label_sets, out_dir))
    del weights
    for k, v in _resnet_clis(dev, out_dir).items():
        launches[k] = launches.get(k, 0) + v
    print(f"ResNet-101: kernel launches of phase 12 {launches}", flush=True)
    return launches


# COCO and the other CRF engines (phase 13): the 81-class path at full width
COCO_CLASSES = 81
COCO_H, COCO_W = 480, 640  # COCO's most common image size
COCO_SIZES = (481,)  # tools/test_coco.py's --sizes default
COCO_KERNEL_CHUNK = 128  # tiles per call of the plain versions at C = 81
COCO_CLI_ITERS, COCO_CLI_FIRST, COCO_CLI_LAST = 12, 6, 12
COCO_SEED_IMAGES = 16  # dump_cues --grow / ap over the first train images
ENGINE_AGREE = 0.998  # each engine against the native permutohedral oracle


def _strs(*argv) -> list:
    return [str(a) for a in argv]


def _coco_kernels(mk, tmm, dev, rng) -> None:
    """(a) the mmgrid kernels at C = 81 on the tiles of a served chunk of 8
    640x480 images: photo-like and pixel-noise guides, uniform and integer
    values; the 1600-pixel tiles take the unstaged splat."""
    guide = torch.from_numpy(np.stack(_images(rng, N_IMAGES, COCO_H, COCO_W))).to(dev)
    _kernel_case(mk, tmm, dev, rng, "COCO photo-like", guide, (COCO_CLASSES,), row_c=COCO_CLASSES,
                 chunk=COCO_KERNEL_CHUNK)
    _kernel_case(mk, tmm, dev, rng, "COCO photo-like, integer values", guide, (COCO_CLASSES,),
                 row_c=COCO_CLASSES, chunk=COCO_KERNEL_CHUNK, integer=True)
    guide = torch.from_numpy(rng.integers(0, 256, (N_IMAGES, COCO_H, COCO_W, 3), dtype=np.uint8)).to(dev)
    _kernel_case(mk, tmm, dev, rng, "COCO pixel-noise", guide, (COCO_CLASSES,), row_c=COCO_CLASSES,
                 chunk=COCO_KERNEL_CHUNK)


def _coco_serving(mk, dev, rng, out_dir: Path) -> dict:
    """(b) the 81-class served chunk: ``predict_masks_device(sizes=[481],
    smooth=True)`` on 8 images of 640x480; 11 + 11 mmgrid launches, no
    dense operands, masks uint8 < 81, and a small input card vs CPU."""
    from dsrg_tpu_torch.inference import Predictor
    from dsrg_tpu_torch.models import DeepLabLargeFOV

    model = DeepLabLargeFOV(num_classes=COCO_CLASSES)
    params = _weights(model, rng)
    predictor = Predictor(model, params, num_classes=COCO_CLASSES, device=dev)
    images = _images(rng, N_IMAGES, COCO_H, COCO_W)
    predictor.predict_masks_device(images, sizes=COCO_SIZES)  # warm-up: cuDNN plans, first launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mk.splat.launches = mk.slice.launches = mk.dense_operands.calls = 0
    t0 = time.perf_counter()
    masks = predictor.predict_masks_device(images, sizes=COCO_SIZES)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {"mmgrid_splat": mk.splat.launches, "mmgrid_slice": mk.slice.launches}
    print(f"main path (COCO, sizes {list(COCO_SIZES)}, {COCO_CLASSES} classes, {N_IMAGES} images of "
          f"{COCO_W}x{COCO_H}): {1e3 * dt:.1f} ms/chunk, {N_IMAGES / dt:.2f} images/s, launches {counts}, "
          f"dense_operands calls {mk.dense_operands.calls}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if mk.dense_operands.calls:
        raise SystemExit("COCO: the served chunk built the dense operands on the card")
    if counts != {"mmgrid_splat": 11, "mmgrid_slice": 11}:
        raise SystemExit(f"COCO: kernel launches {counts}, expected 11 of each")
    for im, m in zip(images, masks):
        if m.shape != im.shape[:2] or m.dtype != np.uint8 or int(m.max()) >= COCO_CLASSES:
            raise SystemExit(f"COCO: bad mask {m.shape} {m.dtype} max {m.max()}")
    print(f"  classes present: {len(np.unique(np.concatenate([m.ravel() for m in masks])))}", flush=True)
    _profile("COCO sizes mode, one chunk", lambda: predictor.predict_masks_device(images, sizes=COCO_SIZES),
             out_dir / "chip_smoke_coco_profile.txt")
    small = _images(rng, 2, 72, 96)
    cpu_pred = Predictor(DeepLabLargeFOV(num_classes=COCO_CLASSES), params, num_classes=COCO_CLASSES, device="cpu")
    on_card = predictor.predict_masks_device(small, sizes=(57,), canvas_bucket=16)
    on_cpu = cpu_pred.predict_masks_device(small, sizes=(57,), canvas_bucket=16)
    agree = min(float((a == b).mean()) for a, b in zip(on_card, on_cpu))
    print(f"COCO card vs CPU masks (sizes [57], 72x96): agreement {agree:.5f}", flush=True)
    if agree <= 0.99:
        raise SystemExit("COCO: the card's masks disagree with the CPU's")
    predictor.close()
    del predictor, cpu_pred, model
    torch.cuda.empty_cache()
    return counts


def _coco_pairs(root: Path, ids_file: str, out: Path) -> Path:
    ids = (root / ids_file).read_text().split()
    out.write_text("".join(f"JPEGImages/{i}.jpg SegmentationClass/{i}.png\n" for i in ids))
    return out


def _coco_step(pk, root: Path, stage1_ms: float, out_dir: Path) -> dict:
    """(c) COCO stage s in memory: ``COCOCueDataset(ship_uint8=True)``
    batches of the PNG tree, then the default ``Stage1Config`` at 81 classes
    with ``input_mean=COCO_MEAN`` (batch 20 @ 321^2, exact CRF at 41^2)."""
    from dsrg_tpu_torch.config import Stage1Config
    from dsrg_tpu_torch.data.coco import COCO_MEAN, COCOCueDataset
    from dsrg_tpu_torch.models import DeepLabLargeFOV
    from dsrg_tpu_torch.train import stage1

    cfg = Stage1Config(num_classes=COCO_CLASSES)
    pairs = _coco_pairs(root, "train_aug_id.txt", root / "coco_train_pairs_smoke.txt")
    ds = COCOCueDataset(str(root) + "/", str(pairs), batch_size=cfg.batch_size,
                        new_size=(cfg.crop_size, cfg.crop_size), num_classes=COCO_CLASSES, ship_uint8=True)
    t0 = time.perf_counter()
    batches = [ds.next_batch() for _ in range(2)]
    decode_ms = 1e3 * (time.perf_counter() - t0) / 2
    b = batches[0]
    print(f"COCO data: batch {cfg.batch_size}: images {b['images'].shape} {b['images'].dtype}, cues "
          f"{b['cues'].shape} {b['cues'].dtype}, labels {b['labels'].shape}; {decode_ms:.1f} ms/batch to decode "
          f"(one thread); classes per image {b['labels'].sum(1).tolist()}", flush=True)
    if b["images"].dtype != np.uint8 or b["cues"].shape != (cfg.batch_size, cfg.cue_size, cfg.cue_size,
                                                             COCO_CLASSES):
        raise SystemExit("COCO data: unexpected batch")
    model = DeepLabLargeFOV(num_classes=COCO_CLASSES)
    state = stage1.init_stage1(model, cfg)
    step = stage1.make_stage1_step(model, cfg, state.optimizer, state.generator, input_mean=COCO_MEAN)
    batch = {k: torch.from_numpy(v).cuda() for k, v in b.items()}
    launches = _timed_steps(pk, "COCO stage 1", "fp32", step, batch, cfg.batch_size, out_dir)
    print(f"  beside the 21-class step of phase 6: {stage1_ms:.1f} ms/step", flush=True)
    del state, step, model, batch
    torch.cuda.empty_cache()
    return launches


def _coco_learning(pk, mk, base: Path, logs: Path) -> tuple:
    """(d) ``synth_check --dataset coco`` (a child process): the easy tree at
    321 as PNGs, stage s for LEARN_ITERS iterations at batch 8, scored by
    ``test_coco``'s streaming mIoU and the honest miou3; then the train CLI
    with ``--dataset coco --cache-decoded`` at batch 20.  Returns the
    children's launches and the CLI's ms/step."""
    work = base / "synth"
    lines = _run_cli("dsrg_tpu_torch.tools.synth_check", [
        "--work-dir", work, "--dataset", "coco", "--iters", LEARN_ITERS, "--batch-size", LEARN_BATCH,
        "--size", LEARN_SIZE, "--n-train", LEARN_TRAIN, "--n-val", LEARN_VAL, "--batch", 8,
        "--image-format", "png"], logs / "synth_check_coco.log")
    result = json.loads([line for _, line in lines if line.startswith('{"coco_val_miou_refquirk"')][-1])
    per_phase = _launch_lines(lines)  # the child's counts so far, after the trainer and after test_coco
    counts = {k: per_phase[-1].get(k, 0) for k in KERNEL_NAMES}
    rates = [line for _, line in lines if re.match(r"\d+ images in ", line)]
    print(f"COCO learning check (synth_check --dataset coco, {LEARN_ITERS} iterations at batch {LEARN_BATCH}): "
          f"{result}; eval {rates}; launches train {per_phase[0]}, test_coco {per_phase[-1]}", flush=True)
    if per_phase[0].get("pool_bwd_h") != 5 * LEARN_ITERS or per_phase[0].get("pool_bwd_w") != 5 * LEARN_ITERS:
        raise SystemExit(f"COCO learning check: pool launches {per_phase[0]}")
    if not result["miou3"] >= LEARN_MIOU:
        raise SystemExit(f"COCO learning check: miou3 {result['miou3']} below {LEARN_MIOU}")
    root = work / "data"
    pairs = _coco_pairs(root, "train_aug_id.txt", root / "coco_cli_pairs.txt")
    cli = _run_cli("dsrg_tpu_torch.tools.train", [
        "--stage", "s", "--dataset", "coco", "--root", str(root) + "/", "--pair-list", pairs,
        "--snapshot-dir", base / "cli", "--max-iter", COCO_CLI_ITERS, "--snapshot-every", COCO_CLI_ITERS,
        "--display", 2, "--dtype", "float32", "--cache-decoded"], logs / "train_coco_cli.log")
    ms, ips, p50 = _display_ms(cli, COCO_CLI_FIRST, COCO_CLI_LAST, 20)
    launches = _launch_lines(cli)[-1]
    for k in KERNEL_NAMES:
        counts[k] += launches.get(k, 0)
    cached = sorted(p.name for p in (base / "cli" / "decoded_cache").iterdir())
    print(f"COCO train CLI (--cache-decoded, batch 20 @ {LEARN_SIZE}^2, fp32): {ms:.1f} ms/step, {ips:.2f} images/s "
          f"over steps {COCO_CLI_FIRST + 1}-{COCO_CLI_LAST} (display lines); StepTimer p50 {p50} ms/iter; launches "
          f"{launches}; cache files {cached}", flush=True)
    if launches["pool_bwd_h"] != 5 * COCO_CLI_ITERS or launches["pool_bwd_w"] != 5 * COCO_CLI_ITERS:
        raise SystemExit(f"COCO train CLI: pool launches {launches}")
    return counts, work / "models-coco" / f"step_{LEARN_ITERS}_params", root


def _coco_seed_clis(mk, snapshot: Path, root: Path, base: Path) -> dict:
    """(e) ``dump_cues --grow`` with (d)'s snapshot over the first train
    images, ``ap`` on its ``_cue.png`` files (ground truth at the cue grid),
    and ``show_result --smooth`` on two val images; every output read back
    through ``utils/imageio``.  In this process: returns its mmgrid launches."""
    from dsrg_tpu_torch.tools import ap, dump_cues, show_result
    from dsrg_tpu_torch.utils import imageio

    grid = 41  # dump_cues forwards at 321: scores and cues on the 41^2 grid
    rows = (root / "input_list.txt").read_text().splitlines()[:COCO_SEED_IMAGES]
    (base / "seed_list.txt").write_text("\n".join(rows) + "\n")
    ids = [r.split()[0][:-4] for r in rows]
    (base / "seed_ids.txt").write_text("\n".join(ids) + "\n")
    gt_small = base / "gt_cue_grid"
    gt_small.mkdir(parents=True, exist_ok=True)
    for i in ids:  # the ground truth at the cues' grid (nearest rows and columns: stride 8 at 321)
        gt = imageio.read_mask(str(root / "SegmentationClass" / f"{i}.png"))
        rows_, cols = (np.round(np.linspace(0, n - 1, grid)).astype(int) for n in gt.shape)
        imageio.write_png(gt[np.ix_(rows_, cols)], str(gt_small / f"{i}.png"))
    t0 = time.perf_counter()
    dump_cues.main(_strs("--images", base / "seed_list.txt", "--dir", root, "--cues", root / "cues.pickle",
                         "--output", base / "cues", "--num-classes", COCO_CLASSES, "--grow", "--model", snapshot))
    dump_s = time.perf_counter() - t0
    grown = 0
    for i in ids:
        m = imageio.read_mask(str(base / "cues" / f"{i}_cue.png"))
        if m.shape != (grid, grid) or not set(np.unique(m).tolist()) <= set(range(COCO_CLASSES)) | {255}:
            raise SystemExit(f"dump_cues: bad cue mask {i}: {m.shape} {np.unique(m)}")
        grown += int((m != 255).sum())
    miou = ap.main(_strs("--pred", base / "cues", "--gt", gt_small, "--test_ids", base / "seed_ids.txt",
                         "--save_path", base / "ap.txt", "--class_num", COCO_CLASSES))
    print(f"dump_cues --grow: {len(ids)} images in {dump_s:.2f} s, {grown / len(ids):.1f} of {grid * grid} cells "
          f"seeded per image; ap: {(base / 'ap.txt').read_text().splitlines()[1]}, meanIOU {miou:.4f}", flush=True)
    if not np.isfinite(miou):
        raise SystemExit("ap: no mean IoU")

    val = (root / "val_id.txt").read_text().split()[:2]
    (base / "show_ids.txt").write_text("\n".join(val) + "\n")
    s0, l0 = mk.splat.launches, mk.slice.launches
    t0 = time.perf_counter()
    show_result.main(_strs("--images", base / "show_ids.txt", "--dir", root, "--model", snapshot, "--output",
                           base / "show", "--num-classes", COCO_CLASSES, "--gt", root / "SegmentationClass",
                           "--smooth", "--save-probs"))
    show_s = time.perf_counter() - t0
    counts = {"mmgrid_splat": mk.splat.launches - s0, "mmgrid_slice": mk.slice.launches - l0}
    for i in val:
        vis = imageio.read_image_rgb(str(base / "show" / f"{i}_vis.png"))
        mask = imageio.read_mask(str(base / "show" / f"{i}.png"))
        probs = np.load(base / "show" / f"{i}.npy")
        if (vis.shape != (LEARN_SIZE, 3 * LEARN_SIZE, 3) or mask.shape != (LEARN_SIZE, LEARN_SIZE)
                or int(mask.max()) >= COCO_CLASSES or probs.shape != (LEARN_SIZE, LEARN_SIZE, COCO_CLASSES)
                or not np.isfinite(probs).all()):
            raise SystemExit(f"show_result: bad outputs for {i}: {vis.shape} {mask.shape} {probs.shape}")
    print(f"show_result --smooth: {len(val)} images in {show_s:.2f} s, panels {vis.shape}, launches {counts}",
          flush=True)
    if counts != {"mmgrid_splat": 11 * len(val), "mmgrid_slice": 11 * len(val)}:
        raise SystemExit(f"show_result: mmgrid launches {counts}, expected {11 * len(val)} of each")
    return counts


def _engines(mk, dev) -> dict:
    """(f) ``engine_neutrality`` at 375x500x21 (3 photo-like images): mmgrid,
    lattice and grid on the card against the native permutohedral oracle on
    the host; then ``crf_fast_neutrality`` at its defaults."""
    from dsrg_tpu_torch.tools import neutrality_study

    s0, l0 = mk.splat.launches, mk.slice.launches
    t0 = time.perf_counter()
    report = neutrality_study.engine_neutrality(3, IMG_H, IMG_W, device=dev)
    wall = time.perf_counter() - t0
    counts = {"mmgrid_splat": mk.splat.launches - s0, "mmgrid_slice": mk.slice.launches - l0}
    print(f"engine neutrality ({report['geometry']}, {wall:.1f} s): oracle {report['oracle']}", flush=True)
    for name in ("mmgrid", "lattice", "grid"):
        r = report[name]
        print(f"  {name}: agreement {r['argmax_agreement_vs_reference_algo']}, mean |dQ| "
              f"{r['mean_abs_marginal_diff']}, ms/image {r['wall_ms_per_image_incl_compile_first']} (the first "
              f"includes first-call costs)", flush=True)
        if not r["argmax_agreement_vs_reference_algo"] >= ENGINE_AGREE:
            raise SystemExit(f"engine {name} agrees with the oracle on {r['argmax_agreement_vs_reference_algo']} "
                             f"< {ENGINE_AGREE}")
    if counts != {"mmgrid_splat": 33, "mmgrid_slice": 33}:
        raise SystemExit(f"engine neutrality: mmgrid launches {counts}, expected 33 of each")
    print(f"crf_fast neutrality: {neutrality_study.crf_fast_neutrality(device=dev)}", flush=True)
    return counts


def _coco_phase(pk, mk, tmm, dev, rng, stage1_ms: float, out_dir: Path, phase_done) -> dict:
    """Phase 13: COCO at 81 classes and the grid, lattice and native
    engines; returns the kernels' launches of its main paths."""
    import shutil

    from dsrg_tpu_torch.tools.synth_check import make_dataset
    from dsrg_tpu_torch.utils import imageio

    _set_tf32(False)
    base = out_dir / "coco"
    shutil.rmtree(base, ignore_errors=True)
    logs = base / "logs"
    _coco_kernels(mk, tmm, dev, rng)
    phase_done("13a (mmgrid at C = 81)")
    launches = _coco_serving(mk, dev, rng, out_dir)
    phase_done("13b (COCO served chunk)")
    root = base / "data"
    make_dataset(str(root), LEARN_TRAIN, LEARN_VAL, LEARN_SIZE, SEED, encode_image=imageio.write_png)
    launches.update(_coco_step(pk, root, stage1_ms, out_dir))
    phase_done("13c (COCO stage s in memory)")
    counts, snapshot, root = _coco_learning(pk, mk, base, logs)
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    phase_done("13d (COCO learning check, train CLI)")
    for k, v in _coco_seed_clis(mk, snapshot, root, base).items():
        launches[k] += v
    phase_done("13e (dump_cues, ap, show_result)")
    for k, v in _engines(mk, dev).items():
        launches[k] += v
    for snapshots in (base / "synth" / "models-coco", base / "cli"):  # ~0.45 GB each, read by nothing later
        shutil.rmtree(snapshots, ignore_errors=True)
    print(f"COCO and engines: kernel launches of phase 13 {launches}", flush=True)
    return launches


# serving export (phase 14): phase 5's net and images as torch.export artifacts
EXPORT_CANVAS = (384, 512)  # phase 5's chunk canvas: 500x375 on 32-pixel buckets
EXPORT_CHUNKS = 3  # timed chunks of the artifact and of the eager pipeline
EXPORT_AGREE = 0.999  # masks per image, artifact against eager (tests/test_serving.py's bound)
DEPLOY_SHAPE = (8, 321, 321, 3)
DEPLOY_RTOL = 1e-4  # elementwise, on probabilities floored at ~1e-4
RECIPE_SNAPSHOT = Path("recipe") / "work" / "model-s" / f"step_{RECIPE_ITERS}_params"  # phase 11's, under out_dir
CRF_API_HW, CRF_API_M = (120, 160), 21  # DenseCRF: N = 19200, two 1.47 GB kernel matrices
CRF_API_TOL = 1e-4  # card against CPU, on the marginals
# a child process loads both CLI artifacts and runs each once
_ARTIFACT_CHILD = """
import json, sys
import numpy as np
from dsrg_tpu_torch.ops.crf import mmgrid_kernels as mk
from dsrg_tpu_torch.serving import ServingModel, ServingPipeline
pipe, deploy, shape = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
rng = np.random.default_rng(0)
images = [rng.integers(0, 256, (375, 500, 3)).astype(np.uint8) for _ in range(3)]
masks = ServingPipeline(pipe)(images)
probs = ServingModel(deploy)(rng.normal(size=shape).astype(np.float32) * 40)
print(json.dumps({"masks": [list(m.shape) for m in masks], "mask_max": max(int(m.max()) for m in masks),
                  "probs": list(probs.shape), "sums": float(np.abs(probs.sum(-1) - 1).max()),
                  "launches": [mk.splat.launches, mk.slice.launches], "jax": "jax" in sys.modules}))
"""


def _timed_chunks(fn, n: int) -> tuple:
    """``fn()`` once to warm up, then ``n`` timed calls (each ends in the
    result's download, a synchronisation): (ms of each call, the last
    result, the peak GiB of the timed calls)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        ms.append(1e3 * (time.perf_counter() - t0))
    return ms, out, torch.cuda.max_memory_allocated() / 2**30


def _ms(each: list) -> str:
    return f"{sum(each) / len(each):.1f} ms ({', '.join(f'{t:.1f}' for t in each)})"


def _crf_api_case(rng):
    """A four-region photo-like image and probabilities that favour one
    class per region, as a network's do (i.i.d. probabilities make near
    ties that fp32 rounding decides: ``tests/test_torch_port_train.py``)."""
    h, w = CRF_API_HW
    img = np.zeros((h, w, 3), np.int32)
    prefer = np.zeros((h, w, CRF_API_M))
    for (y, x), colour, cls in zip(((0, 0), (0, 1), (1, 0), (1, 1)),
                                   ([200, 60, 50], [30, 180, 190], [90, 90, 220], [240, 230, 60]), (1, 3, 7, 12)):
        img[y * h // 2: (y + 1) * h // 2, x * w // 2: (x + 1) * w // 2] = colour
        prefer[y * h // 2: (y + 1) * h // 2, x * w // 2: (x + 1) * w // 2, cls] = 1.0
    img = np.clip(img + rng.integers(-12, 12, img.shape), 0, 255).astype(np.uint8)
    probs = 0.65 * rng.dirichlet(np.ones(CRF_API_M), size=(h, w)) + 0.35 * prefer
    return img, probs.reshape(h * w, CRF_API_M).astype(np.float32)


def _crf_api(dev, after_card):
    """Phase 14f: the DenseCRF object API at 120x160x21, card against CPU,
    and one CRF-learning run (``tests/test_crf_learning.py``'s diagonal
    problem) by L-BFGS on the card.  ``after_card()`` runs once the card's
    marginals are timed, before the CPU's; its result is returned."""
    from dsrg_tpu_torch.ops.crf import exact
    from dsrg_tpu_torch.ops.crf.api import DenseCRF, DiagonalCompatibility
    from dsrg_tpu_torch.ops.crf.features import bilateral_features
    from dsrg_tpu_torch.ops.crf.objectives import log_likelihood, minimize_lbfgs

    h, w = CRF_API_HW
    img, probs = _crf_api_case(np.random.default_rng(SEED))
    out = {}
    for where in ("cuda", "cpu"):
        crf = DenseCRF(w, h, CRF_API_M, device=where)
        crf.set_unary_energy(-np.log(probs).ravel())
        crf.add_pairwise_energy(10, 80, 80, 13, 13, 13, 3, 3, 3, img.ravel())  # the reference CRF() at sf 1
        if where == "cuda":
            ms, q, peak = _timed_chunks(lambda: crf.inference(10), EXPORT_CHUNKS)
            print(f"DenseCRF {h}x{w}x{CRF_API_M} (N = {h * w}), Gaussian + bilateral, inference(10) on the card: "
                  f"{_ms(ms)}, peak {peak:.2f} GiB", flush=True)
            result = after_card()
        else:
            t0 = time.perf_counter()
            q = crf.inference(10)
            print(f"  on the CPU (beside the export CLI's children): {1e3 * (time.perf_counter() - t0):.1f} ms",
                  flush=True)
        out[where] = q
        del crf
    torch.cuda.empty_cache()
    err = float(np.abs(out["cuda"] - out["cpu"]).max())
    agree = float((out["cuda"].reshape(-1, CRF_API_M).argmax(-1) == out["cpu"].reshape(-1, CRF_API_M).argmax(-1)).mean())
    print(f"  card vs CPU: max |dQ| {err:.3e} (tolerance {CRF_API_TOL}), argmax agreement {agree:.5f}", flush=True)
    if not err <= CRF_API_TOL:
        raise SystemExit("DenseCRF: the card's marginals disagree with the CPU's")

    # tests/test_crf_learning.py's problem: 10x10, 4 labels, diagonal compatibility and feature scales
    n_side, m = 10, 4
    rng = np.random.default_rng(0)
    image = np.zeros((n_side, n_side, 3), np.float32)
    image[:, : n_side // 2] = (60, 120, 200)
    image[:, n_side // 2:] = (200, 80, 40)
    image = np.round((image + rng.normal(size=image.shape).astype(np.float32) * 6).clip(0, 255))
    gt = np.broadcast_to(np.where(np.arange(n_side)[None, :] < n_side // 2, 1, 3), (n_side, n_side)).ravel()
    unary = rng.normal(size=(n_side * n_side, m)).astype(np.float32) * 0.5
    unary[np.arange(n_side * n_side), gt] += 1.0
    unary[: n_side * n_side // 4] = rng.normal(size=(n_side * n_side // 4, m)) * 0.5
    image_t, unary_t = torch.from_numpy(image).to(dev), torch.from_numpy(unary).to(dev)
    gt_t = torch.from_numpy(gt.astype(np.int64)).to(dev)

    def loss(p):
        s_xy, s_rgb = torch.exp(p[m]), torch.exp(p[m + 1])
        feats = bilateral_features(image_t, s_xy, s_xy, s_rgb, s_rgb, s_rgb)
        q = exact.mean_field_general(unary_t, [feats], [DiagonalCompatibility(p[:m])], n_iters=3)
        return -log_likelihood(q, gt_t)

    p0 = torch.tensor([0.0] * m + [float(np.log(5.0)), float(np.log(30.0))], device=dev)
    t0 = time.perf_counter()
    p_star = minimize_lbfgs(loss, p0, max_iters=40)
    with torch.no_grad():
        l0, l1 = loss(p0).item(), loss(p_star).item()
    print(f"CRF learning (L-BFGS, 40 iterations at most, on the card): objective {l0:.6f} -> {l1:.6f} in "
          f"{time.perf_counter() - t0:.2f} s, parameters on {p_star.device}", flush=True)
    if not (l1 < l0 - 1e-3 and p_star.is_cuda):
        raise SystemExit("CRF learning: the objective did not fall on the card")
    return result


def _export_phase(mk, dev, params, images, out_dir: Path, phase_done) -> dict:
    """Phase 14: serving export.  Phase 5's net and images as a pipeline
    artifact (export, load, masks and ms/chunk against the eager pipeline,
    the CRF kernels' launches counted by the profiler and by the custom ops'
    counters) and a deploy artifact; the CRF object API on the card, its CPU
    reference computed beside the export CLI's two children; a fresh loader
    in a child process.  Returns the kernels' launches of the artifact's
    chunks."""
    import tempfile

    from dsrg_tpu_torch import serving
    from dsrg_tpu_torch.inference import Predictor
    from dsrg_tpu_torch.models import DeepLabLargeFOV
    from dsrg_tpu_torch.ops.softmax import floored_softmax

    _set_tf32(False)
    predictor = Predictor(DeepLabLargeFOV(num_classes=21), params, num_classes=21, device="cuda")
    launches = {"mmgrid_splat": 0, "mmgrid_slice": 0}
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp = Path(tmp)
        path = tmp / "pipeline.pt2"
        t0 = time.perf_counter()
        serving.export_pipeline(predictor.model, str(path), canvas_hw=EXPORT_CANVAS, batch=N_IMAGES, sizes=SIZES,
                                smooth=True)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        served = serving.ServingPipeline(str(path))
        print(f"pipeline artifact (sizes {SIZES}, CRF on, canvas {EXPORT_CANVAS}, batch {N_IMAGES}): exported in "
              f"{export_s:.2f} s, {path.stat().st_size:,} bytes, loaded in {time.perf_counter() - t0:.2f} s",
              flush=True)
        if (served.batch, served.ph, served.pw) != (N_IMAGES, *EXPORT_CANVAS) or served.device.type != "cuda":
            raise SystemExit(f"pipeline artifact: batch {served.batch}, canvas {served.ph}x{served.pw} on "
                             f"{served.device}")

        # (b) the eager pipeline (the yardstick) and the artifact in turns
        art_ms, eager_ms = [], []
        counted = dict.fromkeys(launches, 0)
        for who in ("eager", "artifact", "artifact", "eager"):
            if who == "eager":
                ms, want, eager_peak = _timed_chunks(lambda: predictor.predict_masks_device(images, sizes=SIZES),
                                                     EXPORT_CHUNKS)
                eager_ms += ms
                continue
            mk.splat.launches = mk.slice.launches = 0
            ms, got, art_peak = _timed_chunks(lambda: served(images), EXPORT_CHUNKS)
            art_ms += ms
            counted["mmgrid_splat"] += mk.splat.launches
            counted["mmgrid_slice"] += mk.slice.launches
        agree = [float((g == w).mean()) for g, w in zip(got, want)]
        print(f"pipeline artifact: {_ms(art_ms)}/chunk of {N_IMAGES}, {N_IMAGES * 1e3 * len(art_ms) / sum(art_ms):.2f} "
              f"images/s, peak {art_peak:.2f} GiB; eager predict_masks_device {_ms(eager_ms)}/chunk, peak "
              f"{eager_peak:.2f} GiB (in turns eager, artifact, artifact, eager: {EXPORT_CHUNKS} timed chunks after a "
              f"warm-up each); launches {counted}; masks "
              f"agree per image {min(agree):.5f}..{max(agree):.5f}", flush=True)
        for g, im in zip(got, images):
            if g.shape != im.shape[:2] or g.dtype != np.uint8 or int(g.max()) >= 21:
                raise SystemExit(f"pipeline artifact: bad mask {g.shape} {g.dtype} max {g.max()}")
        if min(agree) < EXPORT_AGREE:
            raise SystemExit(f"pipeline artifact: masks agree with the eager ones on {min(agree)} < {EXPORT_AGREE}")
        if counted != dict.fromkeys(launches, 2 * 11 * (1 + EXPORT_CHUNKS)):
            raise SystemExit(f"pipeline artifact: kernel launches {counted}, expected 11 of each per chunk")

        # (c) one chunk's launches by kernel name under the profiler, and by the counters
        mk.splat.launches = mk.slice.launches = 0
        by_name = _profile("pipeline artifact, one chunk", lambda: served(images),
                           out_dir / "chip_smoke_artifact_profile.txt")
        by_name = {k: by_name.get(k, 0) for k in launches}
        by_counter = {"mmgrid_splat": mk.splat.launches, "mmgrid_slice": mk.slice.launches}
        print(f"pipeline artifact, one chunk: launches by the profiler's kernel names {by_name}, by the custom "
              f"ops' counters {by_counter}", flush=True)
        if by_name != dict.fromkeys(launches, 11) or by_counter != by_name:
            raise SystemExit("pipeline artifact: the launches of a chunk are not 11 + 11 both ways")
        for k in launches:
            launches[k] = counted[k] + by_counter[k]
        phase_done("14a-c (pipeline artifact)")

        # (d) the deploy artifact against the eager forward with floored_softmax
        dpath = tmp / "deploy.pt2"
        t0 = time.perf_counter()
        serving.export_deploy(predictor.model, str(dpath), input_shape=DEPLOY_SHAPE)
        export_s = time.perf_counter() - t0
        deploy = serving.ServingModel(str(dpath))
        x = (torch.randn(DEPLOY_SHAPE, generator=torch.Generator().manual_seed(SEED)) * 40).numpy()
        deploy_ms, probs, _ = _timed_chunks(lambda: deploy(x), EXPORT_CHUNKS)
        with torch.no_grad():
            eager_ms, ref, _ = _timed_chunks(lambda: floored_softmax(predictor.model(torch.from_numpy(x).to(dev)))
                                             .cpu().numpy(), EXPORT_CHUNKS)
        rel = float((np.abs(probs - ref) / np.abs(ref)).max())
        print(f"deploy artifact {DEPLOY_SHAPE}: exported in {export_s:.2f} s, {dpath.stat().st_size:,} bytes; "
              f"{_ms(deploy_ms)}/batch (eager {_ms(eager_ms)}); max relative error {rel:.3e} (tolerance "
              f"{DEPLOY_RTOL})", flush=True)
        if not rel <= DEPLOY_RTOL:
            raise SystemExit("deploy artifact: disagrees with the eager forward")
        del predictor, served, deploy
        torch.cuda.empty_cache()
        phase_done("14d (deploy artifact)")

        # (e) the export CLI on phase 11's snapshot in two children at once (each spends most of its
        # time on the host), started once (f) has timed the card: (f)'s CPU reference runs beside
        # them; then a fresh process that loads both artifacts
        root = Path(__file__).resolve().parent
        env = dict(os.environ, PYTHONPATH=str(root) + os.pathsep + os.environ.get("PYTHONPATH", ""))
        cli, children = {}, {}

        def start_children():
            for mode, extra in (("pipeline", ["--canvas", *EXPORT_CANVAS]),
                                ("deploy", ["--input-size", DEPLOY_SHAPE[1]])):
                cli[mode] = tmp / f"cli_{mode}.pt2"
                argv = ["--model", out_dir / RECIPE_SNAPSHOT, "--output", cli[mode], "--mode", mode, "--batch",
                        N_IMAGES, *extra]
                children[mode] = subprocess.Popen(
                    [sys.executable, "-m", "dsrg_tpu_torch.tools.export", *map(str, argv)], cwd=root, env=env,
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            return time.perf_counter()

        t0 = _crf_api(dev, start_children)
        for mode, proc in children.items():
            log, _ = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise SystemExit(f"export CLI --mode {mode} exited {proc.returncode}:\n{log[-3000:]}")
            print(f"export CLI --mode {mode}: done after {time.perf_counter() - t0:.1f} s (both children started "
                  f"together), {cli[mode].stat().st_size:,} bytes; {log.strip().splitlines()[-1]}", flush=True)
        t0 = time.perf_counter()
        child = subprocess.run([sys.executable, "-c", _ARTIFACT_CHILD, str(cli["pipeline"]), str(cli["deploy"]),
                                json.dumps(list(DEPLOY_SHAPE))], cwd=root, env=env, capture_output=True, text=True,
                               timeout=600)
        if child.returncode != 0:
            raise SystemExit(f"artifact loader child exited {child.returncode}:\n{child.stderr[-3000:]}")
        res = json.loads(child.stdout.strip().splitlines()[-1])
        print(f"a fresh process loaded and ran both CLI artifacts in {time.perf_counter() - t0:.1f} s: {res}",
              flush=True)
        if (res["jax"] or res["masks"] != [[375, 500]] * 3 or res["mask_max"] >= 21
                or res["probs"] != [DEPLOY_SHAPE[0], 41, 41, 21] or res["sums"] > 1e-5 or res["launches"] != [11, 11]):
            raise SystemExit("artifact loader child: wrong result, or jax was imported")
    print(f"serving export: kernel launches of phase 14 {launches}", flush=True)
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
    from dsrg_tpu_torch import native

    t0 = time.perf_counter()
    lib = native.build()
    print(f"native engines ({native._cxx()} {' '.join(native.flags(native._cxx()))}): {lib.name} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    phase_done("2 (build)")

    rows, plan_ms = _kernel_phase(mk, tmm, dev, rng)
    phase_done("3 (mmgrid kernels)")
    rows.update(_pool_phase(pk, pooling, dev, TRAIN_BATCH))  # the stage-1 step's: the kernels' line
    _pool_phase(pk, pooling, dev, STAGE2_BATCH)
    rows.update(_pool_phase(pk, pooling, dev, TRAIN_BATCH, BF16))
    _pool_phase(pk, pooling, dev, STAGE2_BATCH, BF16)
    for dtype in (torch.float32, BF16):  # ResNet-101's one pool, at both steps' batches
        for batch in (TRAIN_BATCH, STAGE2_BATCH):
            _pool_phase(pk, pooling, dev, batch, dtype, RESNET_POOL1, "ResNet-101")
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

    train_launches, stage1_ms, stage1_ctx = _train_phase(pk, rng, out_dir)
    launches.update(train_launches)
    _train_card_vs_cpu(rng)
    phase_done("6 (stage-1 step)")
    import torch.distributed as dist

    from dsrg_tpu_torch.train.stage1 import make_stage1_step
    from dsrg_tpu_torch.train.stage2 import make_stage2_step

    mesh = _nccl_group()
    for k, v in _dp_step_phase(pk, "stage 1", stage1_ctx, make_stage1_step, stage1_ms, DP_PAD[0], mesh,
                               out_dir).items():
        launches[k] += v
    del stage1_ctx
    torch.cuda.empty_cache()
    phase_done("6b (data-parallel stage-1 step)")

    # the pseudo ground truth: a predictor of the same net and weights, as
    # generate_train_gt.py makes one from the stage-1 snapshot
    predictor = Predictor(DeepLabLargeFOV(num_classes=21), params, num_classes=21, device="cuda")
    cpu_pred = Predictor(DeepLabLargeFOV(num_classes=21), params, num_classes=21, device="cpu")
    gt_launches, gt_masks, label_sets = _pseudo_gt_phase(mk, predictor, cpu_pred, images, rng, out_dir)
    for k, v in gt_launches.items():
        launches[k] += v
    predictor.close()
    del predictor, cpu_pred
    torch.cuda.empty_cache()
    phase_done("7 (pseudo ground truth)")
    stage2_launches, stage2_ms, stage2_ctx = _stage2_phase(pk, images, gt_masks, out_dir)
    for k, v in stage2_launches.items():
        launches[k] += v
    phase_done("8 (stage-2 step)")
    for k, v in _dp_step_phase(pk, "stage 2", stage2_ctx, make_stage2_step, stage2_ms, DP_PAD[1], mesh,
                               out_dir).items():
        launches[k] += v
    del stage2_ctx
    torch.cuda.empty_cache()
    phase_done("8b (data-parallel stage-2 step)")
    for k, v in _dp_serving(mk, mesh, params, images, sizes_masks).items():
        launches[k] += v
    dist.destroy_process_group()
    phase_done("8c (served chunk over a mesh)")

    for k, v in _precision_phase(pk, mk, dev, images, gt_masks, params, sizes_masks, out_dir).items():
        launches[k] = launches.get(k, 0) + v
    phase_done("9 (precisions: fp32, TF32, bf16)")
    for k, v in _learning_phase(pk, dev, out_dir).items():
        launches[k] = launches.get(k, 0) + v
    phase_done("10 (learning check)")
    for k, v in _recipe_phase(dev, out_dir, {"s": stage1_ms, "f": stage2_ms}).items():
        launches[k] = launches.get(k, 0) + v
    phase_done("11 (the recipe on files)")
    for k, v in _resnet_phase(pk, mk, dev, images, gt_masks, label_sets, out_dir).items():
        launches[k] = launches.get(k, 0) + v
    phase_done("12 (ResNet-101)")
    for k, v in _coco_phase(pk, mk, tmm, dev, rng, stage1_ms, out_dir, phase_done).items():
        launches[k] = launches.get(k, 0) + v
    phase_done("13f (engines)")
    for k, v in _export_phase(mk, dev, params, images, out_dir, phase_done).items():
        launches[k] = launches.get(k, 0) + v
    phase_done("14e-f (export CLI, CRF object API)")

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
