"""Discovery by name, the contract's names and units, and a cell added as
files plus one ``BENCHMARK.json`` entry."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TINY_STAGE2 = {"batch": 2, "crop": 41, "pool": 8, "warmup_steps": 3, "profile_steps": 1,
               "size_min": 48, "size_max": 72}


def test_every_cell_finds_its_files_by_name():
    bench = harness.load_benchmark()
    for cell in bench["workloads"]:
        harness.load_config(bench, cell["config"])
        traffic = harness.load_json("traffic", cell["traffic"])
        assert harness.load_driver(traffic["entry"]).run
        assert harness.load_json("limits", cell["name"])
        e2e, per_layer = harness.cell_metrics(bench, cell["name"])
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and per_layer
        for m in per_layer:
            assert harness.load_metric(m["name"]).read({"digest": None, "units": 1}) is None


def test_names_units_and_keys_keep_to_the_contract():
    bench = harness.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]] + \
        [m["name"] for m in bench["end_to_end"] + bench["per_layer"]] + [w["traffic"] for w in bench["workloads"]]
    for name in names:
        assert NAME.match(name), name
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
        assert set(m) <= {"name", "unit", "better", "bound", "source", "layer", "moves", "workloads"}
    assert len({c["name"] for c in bench["configs"]}) == len(bench["configs"])
    assert len({w["name"] for w in bench["workloads"]}) == len(bench["workloads"])
    assert all(w["chips"] == 1 for w in bench["workloads"])
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["file"].startswith("portbench/")
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200


def test_a_cell_added_as_files_runs_without_an_edit(tmp_path: Path):
    """Copy the benchmark, add a traffic mix, its limits, one workload entry
    and its name in the metrics' cell lists, and run the new cell (small, on
    the CPU) from the copy."""
    shutil.copytree(harness.BENCH_DIR, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    bench = harness.load_benchmark()
    traffic = json.loads((harness.BENCH_DIR / "traffic" / "stage2.json").read_text())
    (tmp_path / "portbench" / "traffic" / "stage2_short.json").write_text(json.dumps({**traffic, "batch": 4}))
    (tmp_path / "portbench" / "limits" / "vgg16_largefov.stage2_short.json").write_text(
        (harness.BENCH_DIR / "limits" / "vgg16_largefov.stage2.json").read_text())
    bench["workloads"].append({"name": "vgg16_largefov.stage2_short", "config": "vgg16_largefov",
                               "traffic": "stage2_short", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "vgg16_largefov.stage2" in m.get("workloads", []):
            m["workloads"].append("vgg16_largefov.stage2_short")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, time, sys; from portbench import harness; "
            f"line = harness.run_cell('vgg16_largefov.stage2_short', 5, 0.5, False, 'cpu', time.perf_counter(), "
            f"overrides={TINY_STAGE2!r}); print(json.dumps(line))")
    env = {"PYTHONPATH": f"{tmp_path}:{harness.ROOT}", "PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and set(line["metrics"]) == {"setup_s", "train_images_per_s"}
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"
