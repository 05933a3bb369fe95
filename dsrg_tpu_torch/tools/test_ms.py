"""Multi-scale inference at sizes [241, 321, 401] — mirror of
``training/tools/test-ms.py`` (stage-1 pseudo-GT dump, ``run.sh:6``)."""

from dsrg_tpu_torch.tools._infer_common import build_arg_parser, run_inference


def main(argv=None) -> None:
    p = build_arg_parser(__doc__)
    p.add_argument("--sizes", type=int, nargs="+", default=[241, 321, 401],
                   help="absolute forward sizes to fuse (reference default)")
    args = p.parse_args(argv)
    run_inference(args, sizes=args.sizes)


if __name__ == "__main__":
    main()
