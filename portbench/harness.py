"""Discovery and the parts of a run that every entry shares.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
configuration is its file (``configs/<name>.json``), the mix
``traffic/<name>.json``, whose ``entry`` names the driver
(``drivers/<entry>.py``) that runs it; each per-layer metric is
``metrics/<name>.py`` with ``read(record) -> float | None``; each cell's
limits for ``correct`` are ``limits/<cell>.json``.  A cell, a mix, a
configuration or a metric is added by adding files and entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import shutil
import sys
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "dsrg_tpu")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find(items: List[dict], name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_config(bench: dict, name: str, root: Path = ROOT) -> dict:
    entry = find(bench["configs"], name, "configuration")
    with open(root / entry["file"]) as f:
        return {**json.load(f), "name": name}


def load_json(kind: str, name: str) -> dict:
    with open(BENCH_DIR / kind / f"{name}.json") as f:
        return {**json.load(f), "name": name}


def load_driver(entry: str):
    return importlib.import_module(f"portbench.drivers.{entry}")


def load_metric(name: str):
    """``metrics/<name>.py`` (a name may hold dots, so it is loaded by path)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(bench: dict, cell: str):
    """(end-to-end, per-layer) metric entries that ``cell`` reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, per_layer


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole: ``dsrg_tpu_torch`` is not ``dsrg_tpu``."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def seeds(seed: int) -> Dict[str, int]:
    """Independent 32-bit seeds for the parts of a run, from ``--seed``."""
    words = np.random.SeedSequence(seed).generate_state(4)
    return dict(zip(("data", "weights", "stream", "order"), (int(w) for w in words)))


@dataclass
class Context:
    """One run: its cell and arguments, the device, a scratch directory."""
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    tmp: Path
    t0: float
    limits: Dict[str, float] = field(default_factory=dict)

    @property
    def seeds(self) -> Dict[str, int]:
        return seeds(self.seed)


@dataclass
class Outcome:
    """What a driver returns: the end-to-end values, what the per-layer
    readers read, the compared numbers and the device's peak memory."""
    e2e: Dict[str, float]
    record: dict
    checks: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    digest: Optional[object] = None


def judge(checks: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(name in checks and np.isfinite(checks[name]) and checks[name] <= limit
               for name, limit in limits.items())


def _finite(v) -> Optional[float]:
    """A number for the result line: JSON has no NaN."""
    return float(v) if v is not None and np.isfinite(v) else None


def result_line(bench: dict, ctx: Context, outcome: Outcome, device: dict,
                read_metric: Callable[[str], object] = load_metric) -> dict:
    """The result object; the compared numbers come last."""
    e2e, per_layer = cell_metrics(bench, ctx.cell["name"])
    if ctx.trace:
        values = {}
        record = {**outcome.record, "digest": outcome.digest, "config": ctx.config, "traffic": ctx.traffic}
        for m in per_layer:
            v = read_metric(m["name"]).read(record)
            if v is not None:
                values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = {m["name"]: {"value": float(outcome.e2e[m["name"]]), "unit": m["unit"]} for m in e2e}
    correct = outcome.failed == 0 and judge(outcome.checks, ctx.limits)
    line = {"correct": bool(correct), "attempted": int(outcome.attempted), "failed": int(outcome.failed),
            "metrics": values, "device": device}
    if ctx.trace and outcome.digest is not None:
        d = outcome.digest
        line["breakdown"] = {"device_ops": [[n, s] for n, s in d.top_ops()],
                             "idle_gaps": [[n, s] for n, s in d.idle_gaps]}
    line["checks"] = {name: {"value": _finite(outcome.checks.get(name)), "limit": limit}
                      for name, limit in ctx.limits.items()}
    return line


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device, t0: float, kind: str = "",
             overrides: Optional[dict] = None, root: Path = ROOT) -> dict:
    """Run ``workload`` once on ``device`` and return its result line.
    ``overrides`` replaces traffic parameters (the tests' small sizes)."""
    import torch

    bench = load_benchmark(root)
    cell = find(bench["workloads"], workload, "workload")
    config = load_config(bench, cell["config"], root)
    traffic = {**load_json("traffic", cell["traffic"]), **(overrides or {})}
    limits = load_json("limits", cell["name"])
    limits.pop("name")
    tmp = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        ctx = Context(cell=cell, config=config, traffic=traffic, seed=seed, seconds=seconds, trace=trace,
                      device=torch.device(device), tmp=tmp, t0=t0, limits=limits)
        outcome = load_driver(traffic["entry"]).run(ctx)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    info = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type, "kind": kind,
            "count": cell["chips"], "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    if trace and outcome.digest is not None:
        info.update(busy_s=outcome.digest.busy_s, window_s=outcome.digest.window_s)
    return result_line(bench, ctx, outcome, info)
