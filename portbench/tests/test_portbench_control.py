"""The control comes out not correct: the program with TF32 on (the nearest
precision below the configurations' float32 with TF32 off) fails at least
one of each cell's numbers, on the card, at the cell's own size, where the
program as configured passes them.  Run on the card with

    python -m pytest -m cuda -p no:cacheprovider portbench/tests/test_portbench_control.py
"""

import json
import tempfile
import time
from pathlib import Path

import pytest
import torch

from portbench import calibrate, harness

CELLS = ("vgg16_largefov.stage1", "resnet101_deeplabv2.stage1", "vgg16_largefov.stage2", "vgg16_largefov.test_ms")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    bench = harness.load_benchmark()
    entry = harness.find(bench["workloads"], cell, "workload")
    limits = harness.load_json("limits", cell)
    limits.pop("name")
    torch.backends.cudnn.benchmark = True
    calibrate._tf32(False)  # the configurations' precision; PyTorch lets cuDNN use TF32 by default
    ctx = harness.Context(cell=entry, config=harness.load_config(bench, entry["config"]),
                          traffic=harness.load_json("traffic", entry["traffic"]), seed=20261018, seconds=4.0,
                          trace=False, device=torch.device("cuda", 0), tmp=Path(tempfile.mkdtemp()),
                          t0=time.perf_counter(), limits=limits)
    readings = (calibrate.train_readings if ctx.traffic["entry"] == "train" else calibrate.dump_readings)(ctx)
    print(json.dumps(readings))
    assert harness.judge(readings["program"], limits)
    assert not harness.judge(readings["control"], limits)
