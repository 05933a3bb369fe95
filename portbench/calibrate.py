"""The readings that the limits of ``correct`` are set from, on the card.

    python3 -m portbench.calibrate --workload <cell> --seeds 1 2 3 ... [--seconds 4]

For each seed, in one process: the program as the configuration states it
(float32, TF32 off) against the reference, the control (the program with
TF32 on: the nearest precision below the configuration's) against the
reference, and for a train cell the planted fault "half of the batch left
out, the mean taken over the rest" (the reference so broken, in the
program's place) and a second witness: the reference and the program each
against the reference computed in float64.  A train cell reads its first three steps and needs no
window; a dump cell streams ``--seconds``.  Prints one JSON line per seed
and reading of the numbers that the cell's limits file names; the
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time
from pathlib import Path

import torch

from portbench import harness
from portbench.reference import train as ref_train


def _tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on


def train_readings(ctx, witness: bool = False) -> dict:
    from portbench.drivers import train

    sol = train.solver(ctx)
    samples, program, w0 = train.build(ctx)
    prog = train.first_steps(program, w0, sol, ctx.device)
    program.close()
    _tf32(True)
    program = train.Program(ctx, samples, ctx.tmp / "voc", {k: v.to(ctx.device) for k, v in w0.items()})
    control = train.first_steps(program, w0, sol, ctx.device)
    program.close()
    _tf32(False)
    del program
    torch.cuda.empty_cache()
    ref = train.reference(ctx, samples, w0)
    half = train.reference(ctx, samples, w0, half_batch=True)
    names = ctx.limits
    out = {"program": ref_train.compare(prog, ref, names), "control": ref_train.compare(control, ref, names),
           "half_batch": ref_train.compare(half, ref, names)}
    if witness:
        ref64 = train.reference(ctx, samples, w0, dtype=torch.float64)
        out.update(reference_vs_f64=ref_train.compare(ref, ref64, names),
                   program_vs_f64=ref_train.compare(prog, ref64, names))
    return {**out,
            "losses": {"program": prog["losses"], "control": control["losses"], "reference": ref["losses"],
                       "half_batch": half["losses"]}}


def dump_readings(ctx) -> dict:
    from portbench.drivers import dump

    out = {"program": dump.run(ctx).checks}
    _tf32(True)
    try:
        out["control"] = dump.run(ctx).checks
    finally:
        _tf32(False)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--witness", type=int, default=0, help="train cells: also read the first N seeds against "
                   "the reference in float64")
    args = p.parse_args(argv)
    bench = harness.load_benchmark()
    cell = harness.find(bench["workloads"], args.workload, "workload")
    config = harness.load_config(bench, cell["config"])
    traffic = harness.load_json("traffic", cell["traffic"])
    limits = harness.load_json("limits", cell["name"])
    limits.pop("name")
    torch.backends.cudnn.benchmark = True
    _tf32(False)
    for seed in args.seeds:
        tmp = Path(tempfile.mkdtemp(prefix="portbench-cal-"))
        try:
            ctx = harness.Context(cell=cell, config=config, traffic=traffic, seed=seed, seconds=args.seconds,
                                  trace=False, device=torch.device("cuda", 0), tmp=tmp, t0=time.perf_counter(),
                                  limits=limits)
            if traffic["entry"] == "train":
                readings = train_readings(ctx, witness=seed in args.seeds[:args.witness])
            else:
                readings = dump_readings(ctx)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(json.dumps({"workload": args.workload, "seed": seed, **readings}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
