"""Dump localization cues as ``<id>_cue.png`` masks for ``tools/ap.py``
(``dsrg_tpu/tools/dump_cues.py``).

The reference measures seed quality on such pngs (``ap.py:152``) but ships
no generator.  Without ``--grow`` the masks are the pickle's raw cues; with
``--grow`` they are the cues a model grows: its scores at 321
(``Predictor.scores_at_size``), the floored softmax, the dense CRF of the
train step (``crf_refine_probs``) and ``dsrg_grow``, the DSRGLayer's
pipeline at inference time, on the model's device.  Unseeded pixels are 255.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import time

import numpy as np
import torch

from dsrg_tpu_torch.data.cues import CueDB
from dsrg_tpu_torch.utils import watchdog
from dsrg_tpu_torch.utils.palette import write_png


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--images", dest="image_list", required=True,
                   help="input_list.txt ('file.jpg id' rows)")
    p.add_argument("--dir", dest="data_dir", required=True, help="VOC root")
    p.add_argument("--cues", required=True, help="localization cue pickle")
    p.add_argument("--output", dest="output_dir", required=True)
    p.add_argument("--num-classes", default=21, type=int)
    p.add_argument("--grow", action="store_true",
                   help="run CRF refinement + DSRG growing with --model first")
    p.add_argument("--model", default=None, help="params file (with --grow)")
    p.add_argument("--th1", default=0.99, type=float)
    p.add_argument("--th2", default=0.85, type=float)
    p.add_argument("--skip-existing", action="store_true",
                   help="skip ids whose _cue.png already exists (resume an "
                        "interrupted dump)")
    p.add_argument("--rss-limit-gb", type=float, default=-1.0,
                   help="host-RSS watchdog: past this many GB, exit 75 so a "
                        "supervisor can relaunch with --skip-existing.  "
                        "-1 = auto (80%% of MemTotal), 0 = off")
    p.add_argument("--stall-limit-min", type=float, default=60.0,
                   help="stall watchdog: exit 75 when no image completes "
                        "for this many minutes.  0 = off")
    p.add_argument("--device", default="cuda",
                   help="--grow: cuda (default) or cpu (the plain versions); "
                        "cuda without a card raises")
    return p.parse_args(argv)


def cues_to_mask(cues: np.ndarray, ignore: int = 255) -> np.ndarray:
    """(h, w, M) cue volume -> (h, w) label mask; unseeded pixels = ignore."""
    has = cues.sum(-1) > 0
    lab = cues.argmax(-1).astype(np.uint8)
    lab[~has] = ignore
    return lab


def main(argv=None) -> None:
    args = parse_args(argv)
    cue_db = CueDB(args.cues, num_classes=args.num_classes)
    rows = [ln.strip().split() for ln in open(args.image_list) if ln.strip()]
    if not osp.isdir(args.output_dir):
        os.makedirs(args.output_dir)
    if args.skip_existing:
        _, rows = watchdog.split_existing(
            rows, lambda r: osp.join(args.output_dir, osp.splitext(osp.basename(r[0]))[0] + "_cue.png"))
    # --output is required here, so persistence always holds
    rss_limit, stall = watchdog.arm(args, persist=True, describe="image")

    predictor = None
    if args.grow:
        from dsrg_tpu_torch.data.voc import load_image_bgr, preprocess_image
        from dsrg_tpu_torch.ops.crf.api import crf_refine_probs
        from dsrg_tpu_torch.ops.grow import dsrg_grow
        from dsrg_tpu_torch.ops.softmax import floored_softmax
        from dsrg_tpu_torch.tools._infer_common import load_predictor

        predictor = load_predictor(args.model, args.num_classes, device=args.device)

        def refine_grow(labels, cues, scores, img):
            dev = predictor.device
            with torch.inference_mode():
                q = crf_refine_probs(floored_softmax(torch.from_numpy(scores).to(dev)),
                                     torch.from_numpy(img).to(dev))
                return dsrg_grow(torch.from_numpy(labels).to(dev), torch.from_numpy(cues).to(dev), q,
                                 th1=args.th1, th2=args.th2).cpu().numpy()

    t0 = time.perf_counter()
    try:
        for index, (fname, image_id) in enumerate(rows):
            if index % 100 == 0:
                print("%d processed" % index, flush=True)
                watchdog.maybe_restart(rss_limit, index, len(rows))
            img_id = osp.splitext(osp.basename(fname))[0]
            labels, cues = cue_db.get(int(image_id))
            if args.grow:
                img = load_image_bgr(osp.join(args.data_dir, "JPEGImages", img_id + ".jpg"))
                img = preprocess_image(img, 321)
                scores = predictor.scores_at_size(img)
                cues = refine_grow(labels[None], cues[None], scores[None], img[None].astype(np.float32))[0]
            write_png(cues_to_mask(cues), osp.join(args.output_dir, img_id + "_cue.png"))
            stall.tick()
    finally:
        stall.close()
        if predictor is not None:
            predictor.close()
    if args.grow:
        from dsrg_tpu_torch.tools._infer_common import report

        report(len(rows), t0)


if __name__ == "__main__":
    main()
