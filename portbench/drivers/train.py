"""The train entry: ``tools/train.py``'s loop for ``--stage s`` or ``--stage f``
on one card, with its defaults (``Stage1Dataset`` / ``Stage2Dataset`` with
8 decode threads, ``PrefetchLoader``, ``make_stage1_step`` /
``make_stage2_step``, cuDNN's algorithm search on, the step's metrics read
back every 10 steps), on a synthetic VOC tree written from the seed.

Set-up builds the one train state, drives it through its first three steps
(whose losses, applied first gradient and change the reference follows),
warms up further, and hands the same state to the window: a closed loop of
steps for ``--seconds``.  ``--trace 1`` profiles a short slice after the
window.  Then the program's state is freed and the reference runs.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from portbench.harness import Context, Outcome, log
from portbench.reference import data as ref_data
from portbench.reference import train as ref_train
from portbench.yardstick import arith, files, synth, trace
from portbench.yardstick.weights import make_weights

COMPARED_STEPS = 3


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def start_peak(dev) -> None:
    """Log set-up's peak of allocated memory (cuDNN's algorithm search sets
    it) and start counting the window's own."""
    if dev.type == "cuda":
        log(f"memory: set-up peak {torch.cuda.max_memory_allocated(dev)} bytes allocated")
        torch.cuda.reset_peak_memory_stats(dev)


def window_peak(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def solver(ctx: Context) -> dict:
    """The traffic's solver with the configuration's overrides."""
    return {**ctx.traffic["solver"], **ctx.config.get("solver", {}).get(ctx.traffic["stage"], {})}


def calib_batch(samples, crop: int, n: int, dev) -> torch.Tensor:
    """The first ``n`` images resized to the crop, mean-subtracted BGR."""
    return torch.as_tensor(np.stack([ref_data.resized(s, crop) for s in samples[:n]]), device=dev)


class Program:
    """The program's train state, data and step, built as the train CLI
    builds them."""

    def __init__(self, ctx: Context, samples, tree, weights: dict):
        from dsrg_tpu_torch.config import Stage1Config, Stage2Config
        from dsrg_tpu_torch.data.cues import CueDB
        from dsrg_tpu_torch.data.loader import PrefetchLoader
        from dsrg_tpu_torch.data.voc import Stage1Dataset, Stage2Dataset
        from dsrg_tpu_torch.models import FAMILIES
        from dsrg_tpu_torch.train import stage1, stage2

        cfg, tr, dev, s = ctx.config, ctx.traffic, ctx.device, solver(ctx)
        common = dict(num_classes=cfg["num_classes"], batch_size=tr["batch"], crop_size=tr["crop"],
                      base_lr=s["base_lr"], momentum=s["momentum"], weight_decay=s["weight_decay"],
                      clip_gradients=s.get("clip_gradients", 0.0), mirror=tr["mirror"],
                      seed=ctx.seeds["order"], compute_dtype=cfg["precision"])
        kwargs = {"head_dilations": tuple(cfg["head_dilations"]), "compute_dtype": torch.float32}
        if cfg["family"] == "resnet101":
            kwargs["stage_blocks"] = tuple(cfg["blocks"])
        with torch.device("meta"):
            self.model = FAMILIES[cfg["family"]](num_classes=cfg["num_classes"], **kwargs)
        self.model.to_empty(device=dev)
        self.model.load_state_dict(weights)
        self.generator = torch.Generator(device=dev).manual_seed(ctx.seeds["stream"])
        if tr["stage"] == "s":
            self.cfg = dataclasses.replace(
                Stage1Config(), cue_size=tr["cue"], th1=tr["th1"], th2=tr["th2"],
                crf_scale_factor=tr["crf_scale_factor"], crf_iters=tr["crf_iters"], gamma=s["gamma"],
                stepsize=s["stepsize"], **common)
            self.optimizer = stage1.make_optimizer(self.model, self.cfg)
            dataset = Stage1Dataset(str(tree / "JPEGImages"), str(tree / "input_list.txt"),
                                    CueDB(str(tree / "cues.pickle"), self.cfg.num_classes, self.cfg.cue_size),
                                    crop_size=self.cfg.crop_size, batch_size=self.cfg.batch_size,
                                    seed=self.cfg.seed)
            self.step = stage1.make_stage1_step(self.model, self.cfg, self.optimizer, self.generator)
        else:
            self.cfg = dataclasses.replace(Stage2Config(), power=s["power"], max_iter=s["max_iter"],
                                           ignore_label=tr["ignore_label"], **common)
            self.optimizer = stage2.make_optimizer(self.model, self.cfg)
            dataset = Stage2Dataset(str(tree), str(tree / "train.txt"), crop_size=self.cfg.crop_size,
                                    batch_size=self.cfg.batch_size, seed=self.cfg.seed)
            self.step = stage2.make_stage2_step(self.model, self.cfg, self.optimizer, self.generator)
        self.loader = PrefetchLoader(dataset, device=dev)

    def close(self) -> None:
        self.loader.close()


def build(ctx: Context):
    """(samples, program, host copy of the initial weights)."""
    tr, dev = ctx.traffic, ctx.device
    t = time.perf_counter()
    cues = {k: v for k, v in tr.get("cues", {}).items() if k != "rule"}
    spec = synth.SynthSpec(size_min=tr.get("size_min", 241), size_max=tr.get("size_max", 500),
                           crop_size=tr["crop"], cue_grid=(tr["crop"] - 1) // 8 + 1, **cues)
    samples = synth.make_pool(ctx.seeds["data"], tr["pool"], spec)
    tree = files.write_tree(ctx.tmp / "voc", samples)
    log(f"data: {len(samples)} images and cues in {time.perf_counter() - t:.2f} s, "
        f"{files.tree_bytes(tree) / 2**20:.1f} MiB written")
    t = time.perf_counter()
    weights = make_weights(ctx.config, ctx.seeds["weights"], dev, calib_batch(samples, tr["crop"], 8, dev))
    sync(dev)
    log(f"weights: {sum(v.numel() for v in weights.values())} values in {time.perf_counter() - t:.2f} s")
    program = Program(ctx, samples, tree, weights)
    w0 = {k: v.to("cpu") for k, v in weights.items()}
    return samples, program, w0


def first_steps(program: Program, w0: dict, sol: dict, dev) -> dict:
    """The program's first steps through its own feed and call: losses, the
    applied first gradients' norms, the changes' norms."""
    losses, grad_norms = [], None
    for t in range(COMPARED_STEPS):
        metrics = program.step(next(program.loader))
        losses.append(float(metrics["loss"]))
        if t == 0:
            grad_norms = ref_train.applied_gradient_norms(program.optimizer.velocity, w0, sol)
    params = dict(program.model.named_parameters())
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": ref_train.change_norms(params, w0)}


def reference(ctx: Context, samples, w0: dict, half_batch: bool = False, dtype=torch.float32) -> dict:
    tr, cfg = ctx.traffic, ctx.config
    if tr["stage"] == "s":
        def batches(t):
            return ref_data.stage1_batch(samples, t, tr["batch"], tr["crop"], tr["cue"], cfg["num_classes"],
                                         ctx.seeds["order"])
    else:
        def batches(t):
            return ref_data.stage2_batch(samples, t, tr["batch"], tr["crop"], ctx.seeds["order"],
                                         tr["ignore_label"])
    return ref_train.run_steps(cfg, tr, solver(ctx), w0, batches, ctx.seeds["stream"], ctx.device,
                               half_batch=half_batch, steps=COMPARED_STEPS, dtype=dtype)


def _window(program: Program, seconds: float, dev):
    """Closed-loop steps for ``seconds``: (steps, elapsed s, loader wait s,
    losses, host seconds per step)."""
    steps, wait, pending, losses, host = 0, 0.0, [], [], []
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        t = time.perf_counter()
        batch = next(program.loader)
        wait += time.perf_counter() - t
        pending.append(program.step(batch)["loss"])
        host.append(time.perf_counter() - t)
        steps += 1
        if len(pending) == 10:  # the train CLI's display interval: one read-back per 10 steps
            losses += torch.stack(pending).cpu().tolist()
            pending = []
    sync(dev)
    elapsed = time.perf_counter() - start
    if pending:
        losses += torch.stack(pending).cpu().tolist()
    return steps, elapsed, wait, losses, host


def run(ctx: Context) -> Outcome:
    from dsrg_tpu_torch.ops.grow import dsrg_grow
    from dsrg_tpu_torch.utils.profiling import kernel_launches

    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    sol = solver(ctx)
    samples, program, w0 = build(ctx)
    t = time.perf_counter()
    prog = first_steps(program, w0, sol, dev)
    for _ in range(tr["warmup_steps"] - COMPARED_STEPS):
        program.step(next(program.loader))
    sync(dev)
    log(f"warm-up: {tr['warmup_steps']} steps in {time.perf_counter() - t:.2f} s; first losses {prog['losses']}")
    setup_s = time.perf_counter() - ctx.t0

    start_peak(dev)
    before, checks = kernel_launches(), dsrg_grow.checks
    steps, elapsed, wait, losses, host = _window(program, ctx.seconds, dev)
    after = kernel_launches()
    peak = window_peak(dev)
    log(f"window: {steps} steps in {elapsed:.3f} s, loader wait {wait:.4f} s; per step: the grower's host "
        f"checks {(dsrg_grow.checks - checks) / max(steps, 1):.2f}, host ms p10 / p50 / p90 / max {' / '.join(f'{1e3 * v:.1f}' for v in np.percentile(host, [10, 50, 90, 100]))}, "
        "kernel launches "
        + str({k: (after[k] - before[k]) / max(steps, 1) for k in after if after[k] != before[k]}))
    digest = None
    if ctx.trace:
        path = ctx.tmp / "trace.json"
        trace.profiled(lambda: [program.step(next(program.loader)) for _ in range(tr["profile_steps"])], path)
        digest = trace.digest(path)
        path.unlink()
        log(f"trace: {tr['profile_steps']} steps, window {digest.window_s:.4f} s, busy {digest.busy_s:.4f} s")
    log(f"memory: the window's peak {peak} bytes allocated")
    program.close()
    del program
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    ref = reference(ctx, samples, w0)
    log(f"reference: {COMPARED_STEPS} steps in {time.perf_counter() - t:.2f} s; losses {ref['losses']}")
    checks = ref_train.compare(prog, ref, ctx.limits)
    images = steps * tr["batch"]
    record = {"steps": steps, "seconds": elapsed, "loader_wait_s": wait, "units": tr["profile_steps"],
              "train_flops": arith.train_flops(cfg, tr["crop"]) * images,
              "pool_bytes": arith.pool_backward_bytes(cfg, tr["crop"], tr["batch"])}
    failed = int(sum(not np.isfinite(v) for v in losses))
    return Outcome(e2e={"setup_s": setup_s, "train_images_per_s": images / elapsed}, record=record,
                   checks=checks, attempted=steps, failed=failed, memory_peak_bytes=peak, digest=digest)
