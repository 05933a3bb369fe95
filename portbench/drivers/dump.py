"""The dump entry: the loop of ``tools/_infer_common.run_inference`` for
``test_ms --batch 8 --smooth`` on one card (``read_image_rgb`` of each file,
``Predictor.iter_masks_device`` with the CLI's defaults, ``write_png`` of each
mask), over a synthetic VOC tree written from the seed.

The images stream in a closed loop: the next is handed over as the pipeline
asks for it.  Set-up warms every canvas shape the traffic draws; the window
then streams whole chunks until ``--seconds`` have passed and drains the
pipeline.  A chunk's time runs from the handing over of its last image to
the yield of its first mask.  After the window a sample of the masks, drawn
from the seed, is held against the reference.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from portbench.drivers.train import calib_batch, start_peak, sync, window_peak
from portbench.harness import Context, Outcome, log
from portbench.reference import serve as ref_serve
from portbench.yardstick import arith, files, synth, trace
from portbench.yardstick.weights import make_weights


def pool_sizes(traffic: dict) -> list:
    """The pool's (h, w): each size's share of the pool as the traffic
    states it, the same for every seed."""
    n = traffic["pool"]
    counts = [int(round(share * n)) for share in traffic["size_shares"]]
    counts[-1] = n - sum(counts[:-1])
    return [tuple(hw) for hw, k in zip(traffic["image_sizes"], counts) for _ in range(k)]


def _canvas_key(hws, bucket: int):
    return tuple(-(-max(hw[i] for hw in hws) // bucket) * bucket for i in (0, 1))


class Stream:
    """Pool indices for the pipeline, one seeded permutation per pass, with
    the handing-over time of each chunk's last image."""

    def __init__(self, paths, order_seed: int, chunk: int, deadline=None, first=None):
        self.paths, self.chunk, self.deadline = paths, chunk, deadline
        self.rng = np.random.default_rng(order_seed)
        self.first = list(first or [])
        self.handed, self.last_image_t = [], []

    def __iter__(self):
        from dsrg_tpu_torch.utils.imageio import read_image_rgb

        order: list = []
        while True:
            if len(self.handed) % self.chunk == 0:
                if self.deadline is not None and time.perf_counter() >= self.deadline:
                    return
                if self.deadline is None and not self.first:
                    return
            if self.first:
                i = self.first.pop(0)
            else:
                if not order:
                    order = list(self.rng.permutation(len(self.paths)))
                i = int(order.pop(0))
            image = read_image_rgb(str(self.paths[i]))
            self.handed.append(i)
            if len(self.handed) % self.chunk == 0:
                self.last_image_t.append(time.perf_counter())
            yield image


def _serve(predictor, stream: Stream, tr: dict, out: Path, keep: bool):
    """Run the pipeline over ``stream``; (masks kept, first-mask times)."""
    from dsrg_tpu_torch.utils.palette import write_png

    masks, first_mask_t = [], []
    it = predictor.iter_masks_device(iter(stream), sizes=tr["sizes"], chunk=tr["chunk"], smooth=tr["smooth"],
                                     canvas_bucket=tr["canvas_bucket"], in_flight=tr["in_flight"])
    for n, (_, mask) in enumerate(it):
        if n % tr["chunk"] == 0:
            first_mask_t.append(time.perf_counter())
        write_png(mask, str(out / f"{n % 64:02d}.png"))
        if keep:
            masks.append(mask)
    return masks, first_mask_t


def run(ctx: Context) -> Outcome:
    from dsrg_tpu_torch.inference import Predictor
    from dsrg_tpu_torch.models import FAMILIES
    from dsrg_tpu_torch.utils.profiling import kernel_launches

    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    t = time.perf_counter()
    sizes = pool_sizes(tr)
    order = np.random.default_rng(ctx.seeds["order"]).permutation(len(sizes))
    sizes = [sizes[i] for i in order]
    samples = synth.make_pool(ctx.seeds["data"], len(sizes), synth.SynthSpec(), sizes=sizes)
    tree = files.write_tree(ctx.tmp / "voc", samples)
    paths = [tree / "JPEGImages" / f"synth_{i:05d}.jpg" for i in range(len(samples))]
    out = ctx.tmp / "masks"
    out.mkdir(exist_ok=True)
    log(f"data: {len(samples)} images in {time.perf_counter() - t:.2f} s, "
        f"{files.tree_bytes(tree) / 2**20:.1f} MiB written")
    t = time.perf_counter()
    weights = make_weights(cfg, ctx.seeds["weights"], dev, calib_batch(samples, 321, 8, dev))
    with torch.device("meta"):
        model = FAMILIES[cfg["family"]](num_classes=cfg["num_classes"],
                                        head_dilations=tuple(cfg["head_dilations"]))
    model.to_empty(device=dev)
    model.load_state_dict(weights)
    w0 = {k: v.to("cpu") for k, v in weights.items()}
    del weights
    predictor = Predictor(model, num_classes=cfg["num_classes"], device=dev)
    sync(dev)
    log(f"weights: {time.perf_counter() - t:.2f} s")

    # warm-up: a chunk of each canvas shape the traffic draws, then two mixed ones
    t = time.perf_counter()
    by_size = {hw: [i for i, s in enumerate(sizes) if s == hw] for hw in set(sizes)}
    chunk = tr["chunk"]
    first = []
    for hw, idx in sorted(by_size.items()):
        first += (idx * chunk)[:chunk]
    first += list(range(2 * chunk))
    canvases = {_canvas_key([sizes[i] for i in first[k:k + chunk]], tr["canvas_bucket"])
                for k in range(0, len(first), chunk)}
    _serve(predictor, Stream(paths, 0, chunk, first=first), tr, out, keep=False)
    sync(dev)
    log(f"warm-up: {len(first) // chunk} chunks, canvases {sorted(canvases)}, in {time.perf_counter() - t:.2f} s")
    setup_s = time.perf_counter() - ctx.t0

    start_peak(dev)
    before = kernel_launches()
    start = time.perf_counter()
    stream = Stream(paths, ctx.seeds["order"], chunk, deadline=start + ctx.seconds)
    masks, first_mask_t = _serve(predictor, stream, tr, out, keep=True)
    sync(dev)
    elapsed = time.perf_counter() - start
    after = kernel_launches()
    peak = window_peak(dev)
    n_chunks = len(stream.last_image_t)
    chunk_ms = [1e3 * (b - a) for a, b in zip(stream.last_image_t, first_mask_t)]
    log(f"window: {len(masks)} masks, {n_chunks} chunks in {elapsed:.3f} s; kernel launches per chunk "
        + str({k: (after[k] - before[k]) / max(n_chunks, 1) for k in after if after[k] != before[k]}))
    digest, mm_bytes = None, 0.0
    if ctx.trace:
        units = tr["profile_chunks"]
        picked = list(range(units * chunk))
        path = ctx.tmp / "trace.json"
        trace.profiled(lambda: _serve(predictor, Stream(paths, 0, chunk, first=picked), tr, out, keep=False), path)
        digest = trace.digest(path)
        path.unlink()
        for k in range(units):
            ims = [samples[i].image for i in picked[k * chunk:(k + 1) * chunk]]
            ph, pw = _canvas_key([im.shape[:2] for im in ims], tr["canvas_bucket"])
            canvas = np.zeros((chunk, ph, pw, 3), np.uint8)
            for j, im in enumerate(ims):
                canvas[j, : im.shape[0], : im.shape[1]] = im
            for channels, calls in ((1, 1), (cfg["num_classes"], tr["crf_iters"])):
                mm_bytes += calls * sum(arith.mmgrid_bytes(canvas, channels))
        log(f"trace: {units} chunks, window {digest.window_s:.4f} s, busy {digest.busy_s:.4f} s")
    log(f"memory: the window's peak {peak} bytes allocated")
    del predictor, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    rng = np.random.default_rng(ctx.seeds["data"] + 1)
    pick = sorted(rng.choice(len(masks), size=min(tr["sample"], len(masks)), replace=False).tolist())
    params = {k: v.to(dev) for k, v in w0.items()}
    gaps = [ref_serve.label_gap(params, cfg, samples[stream.handed[n]].image, masks[n], tr["sizes"], dev)
            for n in pick]
    log(f"reference: {len(pick)} images in {time.perf_counter() - t:.2f} s; gaps {gaps}")
    n_img = len(masks)
    record = {"images": n_img, "seconds": elapsed, "units": tr.get("profile_chunks", 1), "mmgrid_bytes": mm_bytes,
              "serve_flops": n_img * sum(arith.forward_flops(cfg, s) for s in tr["sizes"])}
    p90 = float(np.percentile(chunk_ms, 90)) if chunk_ms else float("nan")
    return Outcome(e2e={"setup_s": setup_s, "serve_images_per_s": n_img / elapsed, "serve_chunk_ms_p90": p90},
                   record=record, checks={"label_gap": max(gaps) if gaps else float("inf")},
                   attempted=len(stream.handed), failed=len(stream.handed) - n_img, memory_peak_bytes=peak,
                   digest=digest)
