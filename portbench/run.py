"""Run one cell of the port's benchmark once, on the card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints progress on standard error, the
numbers that decide ``correct`` beside their limits as its last lines, and
one JSON result as the last line of standard output.  Exits with a code
other than 0, and prints no result, where the card or the program is
missing, or where a forbidden module (``harness.FORBIDDEN``) was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """``time.perf_counter()`` at this process's start (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.perf_counter() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


T0 = _process_start()
BENCH_DIR = Path(__file__).resolve().parent

# the caches a run may fill live at fixed paths inside the checkout; the
# program builds its CUDA libraries into dsrg_tpu_torch/_build/ itself
os.environ["TRITON_CACHE_DIR"] = str(BENCH_DIR / ".cache" / "triton")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(BENCH_DIR / ".cache" / "inductor")
os.environ["USE_FLAX"] = "0"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Run one cell of the port's benchmark on the card.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _card(torch) -> dict:
    name = torch.cuda.get_device_name(0)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        smi = "nvidia-smi not available"
    return {"kind": name, "smi": smi}


def main(argv=None) -> int:
    args = parse_args(argv)
    from portbench import harness

    try:
        bench = harness.load_benchmark()
        chips = harness.find(bench["workloads"], args.workload, "workload")["chips"]
    except (OSError, KeyError, ValueError) as e:
        harness.log(f"portbench: cannot set up {args.workload!r}: {e}")
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"portbench: the cell needs {chips} CUDA device(s); "
                    f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    try:
        import dsrg_tpu_torch  # noqa: F401
    except ImportError as e:
        harness.log(f"portbench: the program is not importable: {e}")
        return 4
    card = _card(torch)
    harness.log(f"card: {card['kind']} ({card['smi']}); torch {torch.__version__}, CUDA {torch.version.cuda}; "
                f"{time.perf_counter() - T0:.2f} s since the process started")
    # the configuration's precision: float32 with TF32 off; cuDNN searches
    # its algorithms once per shape, as the CLIs set it
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    line = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0", T0, card["kind"])
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"portbench: forbidden modules loaded: {', '.join(bad)}")
        return 5
    for name, check in line["checks"].items():
        harness.log(f"check {name}: {check['value']} (limit {check['limit']})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
