"""COCO inference with a streaming mIoU (``dsrg_tpu/tools/test_coco.py``),
the counterpart of ``training/tools/test-coco.py``.

One forward size (481 by default), the running mIoU printed every 100
images and the final one at the end (``test-coco.py:62-81,147-169``).
Images that are not RGB are skipped, as the reference's ``test-coco-f.py``
does; the mode comes from the file's header (``utils/imageio.image_mode``).
Three pipelines, as in the JAX tool: the device stream (batched, the
default), the batched host path (``--pipeline host``) and per-image host
inference (``--batch 1``, or an engine other than auto / mmgrid with
``--smooth``).  ``--skip-existing`` folds the masks already written back
into the confusion, so a resumed run reports the whole set's mIoU.
"""

from __future__ import annotations

import os
import os.path as osp
import time

from dsrg_tpu_torch.tools._infer_common import (build_arg_parser, load_predictor, preview_mask, report,
                                                resolve_pipeline)
from dsrg_tpu_torch.utils import imageio, watchdog
from dsrg_tpu_torch.utils.confusion import ConfusionMatrix
from dsrg_tpu_torch.utils.palette import read_mask_png, write_png


def run_coco(args, sizes=None, scales=None) -> float:
    """Predict every row of ``args.image_list`` ('image [label]' paths under
    ``args.data_dir``); returns the final mIoU, NaN without labels."""
    predictor = load_predictor(
        args.model, args.num_classes, getattr(args, "model_name", "vgg16"),
        bucket=int(getattr(args, "bucket", 1)), mesh=bool(getattr(args, "mesh", False)),
        device=getattr(args, "device", "cuda"),
    )
    rows = [ln.strip().split() for ln in open(args.image_list) if ln.strip()]
    conf = ConfusionMatrix(args.num_classes)
    if args.output_dir and not osp.isdir(args.output_dir):
        os.makedirs(args.output_dir)
    has_gt = bool(rows) and len(rows[0]) > 1
    rss_limit, stall = watchdog.arm(args, persist=bool(args.output_dir), describe="image")

    def _out_path(row):
        return osp.join(args.output_dir, osp.splitext(osp.basename(row[0]))[0] + ".png")

    if getattr(args, "skip_existing", False) and args.output_dir:
        done_rows, rows = watchdog.split_existing(rows, _out_path)
        # the masks already written (this model's own outputs) count in the mIoU
        for row in done_rows:
            if len(row) > 1:
                conf.add(read_mask_png(osp.join(args.data_dir, row[1])), read_mask_png(_out_path(row)))

    def score(index, row, image, mask):
        if args.output_dir:
            write_png(mask, _out_path(row))
        else:  # no --output: the reference's interactive preview
            preview_mask(image, mask, args.num_classes)
        if has_gt:
            conf.add(read_mask_png(osp.join(args.data_dir, row[1])), mask)
            if (index + 1) % 100 == 0:
                ave_j, _, _ = conf.jaccard()
                print(f"{index + 1} images, running meanIOU: {ave_j:.4f}", flush=True)
        stall.tick()
        if (index + 1) % 100 == 0:
            watchdog.maybe_restart(rss_limit, index + 1, len(rows))

    engine, chunk, _, use_device = resolve_pipeline(args, sizes, scales, exact_canvas=predictor.exact_canvas)

    def rgb_rows():
        for row in rows:
            path = osp.join(args.data_dir, row[0])
            if imageio.image_mode(path) != "RGB":  # the reference skips non-RGB (test-coco-f.py)
                print("skip non-RGB", row[0], flush=True)
                continue
            yield row, imageio.read_image_rgb(path)

    t0 = time.perf_counter()
    index = 0
    try:
        if use_device:
            kept = []  # the generator runs at least one chunk ahead of the masks

            def gen():
                for row, img in rgb_rows():
                    kept.append(row)
                    yield img

            stream = predictor.iter_masks_device(
                gen(), sizes=sizes, scales=scales, chunk=chunk, smooth=args.smooth,
                canvas_bucket=int(getattr(args, "canvas_bucket", 32)),
                in_flight=int(getattr(args, "in_flight", 2)),
            )
            for index, (img, mask) in enumerate(stream, 1):
                score(index - 1, kept[index - 1], img, mask)
        else:
            batch_rows, batch_imgs = [], []

            def flush():
                nonlocal index
                if chunk > 1:  # the batched host path: one forward per scale per chunk
                    masks = predictor.predict_masks(batch_imgs, sizes=sizes, scales=scales, smooth=args.smooth)
                else:
                    masks = [predictor.predict_mask(batch_imgs[0], sizes=sizes, scales=scales,
                                                    smooth=args.smooth, crf_engine=engine)]
                for row, img, mask in zip(batch_rows, batch_imgs, masks):
                    score(index, row, img, mask)
                    index += 1
                batch_rows.clear()
                batch_imgs.clear()

            for row, img in rgb_rows():
                batch_rows.append(row)
                batch_imgs.append(img)
                if len(batch_imgs) == chunk:
                    flush()
            if batch_imgs:
                flush()
    finally:
        stall.close()
        predictor.close()
    report(index, t0)
    if conf.M.sum() > 0:
        ave_j, _, _ = conf.jaccard()
        print("final meanIOU:", ave_j)
        return ave_j
    return float("nan")


def main(argv=None) -> None:
    p = build_arg_parser(__doc__)
    p.set_defaults(num_classes=81)
    p.add_argument("--sizes", type=int, nargs="+", default=[481],
                   help="absolute forward sizes (reference default 481)")
    args = p.parse_args(argv)
    run_coco(args, sizes=args.sizes)


if __name__ == "__main__":
    main()
