"""Single-scale (321) inference CLI — mirror of ``training/tools/test.py``.

(The reference file reads a stale blob name ``fc8-prod`` and would KeyError
unmodified, ``test.py:83``; we read the real final score map.)
"""

from dsrg_tpu_torch.tools._infer_common import build_arg_parser, run_inference


def main(argv=None) -> None:
    args = build_arg_parser(__doc__).parse_args(argv)
    run_inference(args, sizes=[321])


if __name__ == "__main__":
    main()
