"""Multi-scale inference at relative scales [0.75, 1, 1.25] — mirror of
``training/tools/test-ms-f.py`` (final val predictions, ``run.sh:10``)."""

from dsrg_tpu_torch.tools._infer_common import build_arg_parser, run_inference


def main(argv=None) -> None:
    p = build_arg_parser(__doc__)
    p.add_argument("--scales", type=float, nargs="+", default=[0.75, 1.0, 1.25],
                   help="fractional forward scales to fuse (reference default)")
    args = p.parse_args(argv)
    run_inference(args, scales=args.scales)


if __name__ == "__main__":
    main()
