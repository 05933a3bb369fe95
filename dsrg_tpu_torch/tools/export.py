"""Export a trained model for serving with ``torch.export`` (``dsrg_tpu/tools/export.py``).

The reference deploys ``deploy.prototxt`` + ``.caffemodel`` loaded into a
fresh Caffe process (``training/tools/test-ms.py:114-118``).  This writes
either the bare deploy forward (``--mode deploy``) or the whole multi-scale
+ CRF pipeline (``--mode pipeline``: uint8 canvases in, uint8 masks out) as
one weights-embedded ``torch.export`` artifact, loaded with
``dsrg_tpu_torch.serving.ServingModel`` / ``ServingPipeline``.  Unlike the
JAX package's StableHLO, loading it needs ``dsrg_tpu_torch`` importable
(importing ``dsrg_tpu_torch.serving`` registers the CRF's custom ops), and
on the card the kernels' shared libraries are built with ``nvcc`` into
``dsrg_tpu_torch/_build/`` at the first launch.  The artifact runs on the
device it was exported on (``--device``).
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", required=True, help="params file (train.py's step_N_params)")
    p.add_argument("--output", required=True, help="output artifact path")
    p.add_argument("--mode", choices=["deploy", "pipeline"], default="pipeline")
    p.add_argument("--num-classes", default=21, type=int)
    p.add_argument("--model-name", choices=["vgg16", "resnet101"], default="vgg16")
    p.add_argument("--batch", default=8, type=int, help="exported batch size")
    p.add_argument("--canvas", default=[512, 512], type=int, nargs=2,
                   metavar=("H", "W"), help="pipeline canvas (max image size)")
    p.add_argument("--input-size", default=321, type=int,
                   help="deploy-mode square input size")
    p.add_argument("--sizes", default=[241, 321, 401], type=int, nargs="+",
                   help="pipeline absolute scale sizes (test-ms)")
    p.add_argument("--scales", default=None, type=float, nargs="+",
                   help="pipeline fractional scales (test-ms-f) instead of --sizes")
    p.add_argument("--no-smooth", action="store_true", help="skip the CRF stage")
    p.add_argument("--platforms", default=None, nargs="+",
                   help="jax.export's lowering platforms: no meaning for torch.export "
                        "(an artifact runs on the --device it was exported on); refused")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions): where "
                        "the artifact runs; cuda without a card raises")
    args = p.parse_args(argv)
    if args.platforms is not None:
        raise SystemExit("--platforms is a jax.export lowering list and has no meaning for "
                         "torch.export: an artifact runs on the device it was exported on; "
                         "pass --device instead")

    from dsrg_tpu_torch.serving import export_deploy, export_pipeline
    from dsrg_tpu_torch.tools._infer_common import load_predictor

    pred = load_predictor(args.model, args.num_classes, args.model_name, device=args.device)
    if args.mode == "deploy":
        path = export_deploy(pred.model, args.output,
                             input_shape=(args.batch, args.input_size, args.input_size, 3),
                             device=pred.device)
    else:
        path = export_pipeline(pred.model, args.output, canvas_hw=tuple(args.canvas),
                               batch=args.batch, sizes=None if args.scales else tuple(args.sizes),
                               scales=tuple(args.scales) if args.scales else None,
                               smooth=not args.no_smooth, num_classes=args.num_classes,
                               device=pred.device)
    print("exported", args.mode, "->", path, flush=True)


if __name__ == "__main__":
    main()
