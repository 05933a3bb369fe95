"""Pseudo-ground-truth generator — mirror of ``training/tools/generate_train_gt.py``.

Forward at 321 (+ optional CRF), then restrict the argmax to the image-level
label set from the cue pickle with background inserted
(``generate_train_gt.py:98-104``).  With ``--smooth`` the CRF's ``auto``
engine takes the exact engine up to 8192 pixels and the mmgrid kernels above.
"""

from __future__ import annotations

import os
import os.path as osp
import time

import numpy as np

from dsrg_tpu_torch.data.cues import CueDB
from dsrg_tpu_torch.tools._infer_common import build_arg_parser, load_predictor, report
from dsrg_tpu_torch.utils.imageio import read_image_rgb
from dsrg_tpu_torch.utils.palette import write_png


def main(argv=None) -> None:
    p = build_arg_parser(__doc__)
    p.add_argument("--cues", required=True, help="localization cue pickle (for label sets)")
    args = p.parse_args(argv)

    # --model-name and --mesh reach the predictor (the JAX tool ignores both
    # and always loads VGG16); predict_mask is the host-zoom path, which a
    # mesh leaves on the mesh's first device, as JAX's does
    predictor = load_predictor(args.model, args.num_classes, args.model_name, mesh=args.mesh,
                               device=args.device)
    cue_db = CueDB(args.cues, num_classes=args.num_classes)
    if args.output_dir and not osp.isdir(args.output_dir):
        os.makedirs(args.output_dir)

    rows = [ln.strip().split() for ln in open(args.image_list) if ln.strip()]
    data_dir = osp.join(args.data_dir, "JPEGImages")
    from dsrg_tpu_torch.utils import watchdog

    if args.skip_existing and args.output_dir:
        _, rows = watchdog.split_existing(
            rows,
            lambda r: osp.join(args.output_dir,
                               osp.splitext(osp.basename(r[0]))[0] + ".png"),
        )
    rss_limit, stall = watchdog.arm(args, persist=bool(args.output_dir),
                                    describe="image")
    t0 = time.perf_counter()
    try:
        for index, (fname, image_id) in enumerate(rows):
            print(index, fname, flush=True)
            stall.tick()
            if index % 50 == 0:
                watchdog.maybe_restart(rss_limit, index, len(rows))
            img_id = osp.splitext(osp.basename(fname))[0]
            image = read_image_rgb(osp.join(data_dir, img_id + ".jpg"))
            fg = np.asarray(cue_db.data["%i_labels" % int(image_id)]).ravel()
            restrict = np.concatenate([[0], fg]).astype(np.int32)  # insert bg
            mask = predictor.predict_mask(
                image, sizes=[321], smooth=args.smooth, restrict_labels=restrict
            )
            if args.output_dir:
                write_png(mask, osp.join(args.output_dir, img_id + ".png"))
    finally:
        stall.close()
        predictor.close()
    report(len(rows), t0)


if __name__ == "__main__":
    main()
