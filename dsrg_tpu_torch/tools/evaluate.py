"""mIoU evaluation CLI — mirror of ``training/tools/evaluate.py``.

Same flags, same output file format (``evaluate.py:159-162``):
  meanIOU: <float>\n  <per-class list>\n  <confusion matrix>
"""

from __future__ import annotations

import argparse
import os.path as osp

from dsrg_tpu_torch.utils.confusion import ConfusionMatrix
from dsrg_tpu_torch.utils.palette import read_mask_png


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="evaluate segmentation result")
    p.add_argument("--pred", dest="pred_dir", required=True, help="prediction result dir")
    p.add_argument("--class_num", dest="class_num", default=21, type=int,
                   help="class number include bg")
    p.add_argument("--gt", dest="gt_dir", required=True, help="ground truth dir")
    p.add_argument("--test_ids", dest="test_ids", required=True, help="test ids file path")
    p.add_argument("--save_path", dest="save_path", required=True, help="result file path")
    return p.parse_args(argv)


def evaluate(pred_dir, gt_dir, test_ids_path, class_num):
    conf = ConfusionMatrix(class_num)
    test_ids = [ln.strip() for ln in open(test_ids_path) if ln.strip()]
    for index, img_id in enumerate(test_ids):
        if index % 100 == 0:
            print("%d processed" % index, flush=True)
        pred = read_mask_png(osp.join(pred_dir, img_id + ".png"))
        gt = read_mask_png(osp.join(gt_dir, img_id + ".png"))
        conf.add(gt, pred)
    return conf


def main(argv=None) -> float:
    """Returns the mean IoU so in-process callers (synth_check,
    neutrality_study) need not re-parse the result file's text format."""
    args = parse_args(argv)
    conf = evaluate(args.pred_dir, args.gt_dir, args.test_ids, args.class_num)
    ave_j, j_list, m = conf.jaccard()
    with open(args.save_path, "w") as f:
        f.write("meanIOU: " + str(ave_j) + "\n")
        f.write(str(j_list) + "\n")
        f.write(str(m) + "\n")
    print("meanIOU:", ave_j)
    return float(ave_j)


if __name__ == "__main__":
    main()
