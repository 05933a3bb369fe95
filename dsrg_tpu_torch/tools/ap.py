"""Seed (cue) quality report (``dsrg_tpu/tools/ap.py``), the counterpart of
``training/tools/ap.py``.

Reads ``<id>_cue.png`` predictions (unseeded pixels 255, which the
confusion ignores) and writes per-class accuracy / recall / IoU and their
means (``ap.py:152,172-185``).
"""

from __future__ import annotations

import argparse
import os.path as osp

import numpy as np

from dsrg_tpu_torch.utils.confusion import ConfusionMatrix
from dsrg_tpu_torch.utils.palette import read_mask_png


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="evaluate seed quality")
    p.add_argument("--pred", dest="pred_dir", required=True)
    p.add_argument("--class_num", dest="class_num", default=21, type=int)
    p.add_argument("--gt", dest="gt_dir", required=True)
    p.add_argument("--test_ids", dest="test_ids", required=True)
    p.add_argument("--save_path", dest="save_path", required=True)
    p.add_argument("--suffix", default="_cue", help="prediction filename suffix")
    return p.parse_args(argv)


def main(argv=None) -> float:
    """Writes the report to ``--save_path``; returns the mean IoU."""
    args = parse_args(argv)
    conf = ConfusionMatrix(args.class_num)
    test_ids = [ln.strip() for ln in open(args.test_ids) if ln.strip()]
    for index, img_id in enumerate(test_ids):
        if index % 100 == 0:
            print("%d processed" % index, flush=True)
        pred = read_mask_png(osp.join(args.pred_dir, img_id + args.suffix + ".png"))
        gt = read_mask_png(osp.join(args.gt_dir, img_id + ".png"))
        conf.add(gt, pred)

    m = conf.M
    with np.errstate(divide="ignore", invalid="ignore"):
        acc_list = np.diag(m) / m.sum(axis=1)
        rec_list = np.diag(m) / m.sum(axis=0)
    ave_j, j_list, _ = conf.jaccard()
    with open(args.save_path, "w") as f:
        f.write("accuracy per class: " + str(list(acc_list)) + "\n")
        f.write("mean accuracy: " + str(np.nanmean(acc_list)) + "\n")
        f.write("recall per class: " + str(list(rec_list)) + "\n")
        f.write("mean recall: " + str(np.nanmean(rec_list)) + "\n")
        f.write("meanIOU: " + str(ave_j) + "\n")
        f.write(str(j_list) + "\n")
    print("meanIOU:", ave_j)
    return ave_j


if __name__ == "__main__":
    main()
