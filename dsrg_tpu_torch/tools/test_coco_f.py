"""COCO inference at native scale (``dsrg_tpu/tools/test_coco_f.py``), the
counterpart of ``training/tools/test-coco-f.py``: the scale-1 zoom variant
of ``test_coco`` with its running mIoU, skipping non-RGB images."""

from dsrg_tpu_torch.tools._infer_common import build_arg_parser
from dsrg_tpu_torch.tools.test_coco import run_coco


def main(argv=None) -> None:
    p = build_arg_parser(__doc__)
    p.set_defaults(num_classes=81)
    p.add_argument("--scales", type=float, nargs="+", default=[1.0],
                   help="fractional forward scales (reference default 1.0)")
    args = p.parse_args(argv)
    run_coco(args, scales=args.scales)


if __name__ == "__main__":
    main()
