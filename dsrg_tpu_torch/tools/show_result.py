"""Visualisation CLI (``dsrg_tpu/tools/show_result.py``), the counterpart of
``training/tools/show-result.py``.

Writes side-by-side (image | prediction | ground truth) colour pngs
``<id>_vis.png``, the prediction as a palette png ``<id>.png`` and, with
``--save-probs``, the probabilities as ``<id>.npy``
(``show-result.py:55-61,94-95``).  Predictions are multi-scale at 241, 321
and 401; ``--smooth`` adds the CRF (``--engine``).  Files go through
``utils/imageio.py``.
"""

from __future__ import annotations

import os
import os.path as osp
import time

import numpy as np
import torch

from dsrg_tpu_torch.tools._infer_common import build_arg_parser, load_predictor, report
from dsrg_tpu_torch.utils import imageio
from dsrg_tpu_torch.utils.palette import VOC_PALETTE, write_palette_png


def _colorize(mask: np.ndarray) -> np.ndarray:
    pal = np.zeros((256, 3), np.uint8)
    pal[: len(VOC_PALETTE)] = np.asarray(VOC_PALETTE, np.uint8)
    pal[255] = (255, 255, 255)
    return pal[mask]


def main(argv=None) -> None:
    p = build_arg_parser(__doc__)
    p.add_argument("--gt", dest="gt_dir", default=None, help="SegmentationClass dir")
    p.add_argument("--save-probs", action="store_true", help="also np.save raw probs")
    args = p.parse_args(argv)

    predictor = load_predictor(args.model, args.num_classes, args.model_name, device=args.device)
    image_ids = [ln.strip() for ln in open(args.image_list) if ln.strip()]
    data_dir = osp.join(args.data_dir, "JPEGImages")
    if args.output_dir and not osp.isdir(args.output_dir):
        os.makedirs(args.output_dir)

    t0 = time.perf_counter()
    try:
        for index, img_id in enumerate(image_ids):
            print(index, img_id, flush=True)
            image = imageio.read_image_rgb(osp.join(data_dir, img_id + ".jpg"))
            probs = predictor.predict_probs(image, sizes=[241, 321, 401])
            if args.smooth:
                from dsrg_tpu_torch.ops.crf.api import CRF

                with torch.inference_mode():
                    probs = CRF(image, torch.from_numpy(np.log(probs)).to(predictor.device), scale_factor=1.0,
                                engine=args.engine).cpu().numpy()
            mask = probs.argmax(-1).astype(np.uint8)

            panels = [image, _colorize(mask)]
            if args.gt_dir:
                gt = imageio.read_raw(osp.join(args.gt_dir, img_id + ".png"))
                panels.append(_colorize(gt.astype(np.uint8)))
            imageio.write_png(np.concatenate(panels, axis=1), osp.join(args.output_dir, img_id + "_vis.png"))
            write_palette_png(mask, osp.join(args.output_dir, img_id + ".png"))
            if args.save_probs:
                np.save(osp.join(args.output_dir, img_id + ".npy"), probs)
    finally:
        predictor.close()
    report(len(image_ids), t0)


if __name__ == "__main__":
    main()
