"""What the benchmark loads: no JAX and no JAX package in a run, and no
program in the reference; nothing reads the JAX package's benchmark files."""

import json
import re
import subprocess
import sys

import pytest

from portbench import harness

TINY = {
    "vgg16_largefov.stage1": {"batch": 2, "crop": 41, "cue": 6, "pool": 8, "warmup_steps": 3,
                              "profile_steps": 1, "size_min": 48, "size_max": 72},
    "vgg16_largefov.test_ms": {"chunk": 2, "sizes": [41, 49], "image_sizes": [[60, 84], [84, 60]], "pool": 6,
                               "sample": 2, "profile_chunks": 1},
}


@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_run_loads_no_forbidden_module(cell):
    code = ("import json, sys, time; from portbench import harness; "
            f"harness.run_cell({cell!r}, 7, 0.5, False, 'cpu', time.perf_counter(), overrides={TINY[cell]!r}); "
            "print(json.dumps({'forbidden': harness.forbidden_modules(), "
            "'top': sorted({m.split('.')[0] for m in sys.modules})}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == []
    assert "dsrg_tpu_torch" in got["top"]  # the port passes: names are compared whole


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "dsrg_tpu_torch_x", sys)
    assert "dsrg_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "dsrg_tpu.ops", sys)
    assert "dsrg_tpu" in harness.forbidden_modules()


def test_the_reference_loads_no_program():
    code = ("import sys, numpy as np, torch; "
            "import portbench.reference.train, portbench.reference.serve, portbench.reference.data; "
            "from portbench.reference import serve; "
            "img = np.random.default_rng(0).integers(0, 255, (50, 60, 3)).astype(np.uint8); "
            "q = serve.crf_marginals(torch.log(torch.full((50, 60, 3), 1 / 3.)), torch.as_tensor(img)); "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    top = out.stdout.strip().splitlines()[-1]
    assert "dsrg_tpu" not in top and "jax" not in top


def test_nothing_reads_the_jax_benchmark_files():
    """No string names those files and no import loads them."""
    literal = re.compile(r"""["'][^"'\n]*(bench\.py|chip_smoke|BENCH_r|BENCH_\*|MULTICHIP|BASELINE)[^"'\n]*["']""")
    module = re.compile(r"^\s*(import|from)\s+(bench|chip_smoke|tools_\w+)\b", re.M)
    for path in harness.BENCH_DIR.rglob("*.py"):
        if path.name == "test_portbench_isolation.py":
            continue
        text = path.read_text()
        assert not literal.search(text) and not module.search(text), path
