"""Reduction of a profiler trace to what the per-layer metrics read.

``profiled(fn, path)`` runs ``fn`` under ``torch.profiler`` (CPU and CUDA),
inside the benchmark's own range ``portbench.slice``, and writes the Chrome
trace to ``path``; :func:`digest` reads it back.  Each device operation
(kernel, copy, set) is tied through its launch's correlation id to the stack
of host ranges (ATen ops, ``record_function`` ranges) around the launch on
the launching thread, so that device time is attributed by the ATen op that
launched it.  The traced window runs from the slice's start to the later of
its end and the last device operation it launched; busy time is the union
of the device operations' intervals inside it.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, FrozenSet, List, Tuple

SLICE = "portbench.slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")


@dataclass
class DeviceOp:
    name: str
    start_us: float
    dur_us: float
    host: FrozenSet[str]   # names of the host ranges around its launch


@dataclass
class Digest:
    window_s: float
    busy_s: float
    ops: List[DeviceOp]
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def device_seconds(self, keep: Callable[[DeviceOp], bool]) -> float:
        return sum(op.dur_us for op in self.ops if keep(op)) * 1e-6

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        by_name: Dict[str, float] = defaultdict(float)
        for op in self.ops:
            by_name[op.name[:120]] += op.dur_us * 1e-6
        return sorted(by_name.items(), key=lambda kv: -kv[1])[:n]


def profiled(fn: Callable[[], None], path) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(SLICE):
            fn()
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))


def _stacks(spans: List[dict], points: List[Tuple[float, int]]) -> Dict[int, FrozenSet[str]]:
    """For launches ``(ts, key)`` on one thread, the names of the (nested)
    host spans that contain each."""
    spans = sorted(spans, key=lambda e: (e["ts"], -e["dur"]))
    out, stack, i = {}, [], 0
    for ts, key in sorted(points):
        while i < len(spans) and spans[i]["ts"] <= ts:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= spans[i]["ts"]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < ts:
            stack.pop()
        out[key] = frozenset(s["name"] for s in stack if s["ts"] <= ts <= s["ts"] + s["dur"])
    return out


def digest(path, n_gaps: int = 10) -> Digest:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans_by_tid: Dict = defaultdict(list)
    launches: Dict[int, dict] = {}
    device: List[dict] = []
    slice_ev = None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in HOST_CATS:
            spans_by_tid[e["tid"]].append(e)
            if e["name"] == SLICE and cat == "user_annotation":
                slice_ev = e
        elif cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = e
        elif cat in DEVICE_CATS:
            device.append(e)
    if slice_ev is None:
        raise RuntimeError(f"{path}: no {SLICE} range in the trace")
    t0, t1 = slice_ev["ts"], slice_ev["ts"] + slice_ev["dur"]
    points: Dict = defaultdict(list)
    for corr, ev in launches.items():
        if t0 <= ev["ts"] <= t1:
            points[ev["tid"]].append((ev["ts"], corr))
    host: Dict[int, FrozenSet[str]] = {}
    for tid, pts in points.items():
        host.update(_stacks(spans_by_tid[tid], pts))
    ops = [DeviceOp(e["name"], e["ts"], e["dur"], host[e["args"]["correlation"]]) for e in device
           if e.get("args", {}).get("correlation") in host]
    end = max([t1] + [op.start_us + op.dur_us for op in ops])
    busy, gaps, cursor = 0.0, [], t0
    for op in sorted(ops, key=lambda o: o.start_us):
        s, e = max(op.start_us, cursor), op.start_us + op.dur_us
        if s > cursor:
            gaps.append((cursor, s))
        if e > s:
            busy += e - s
        cursor = max(cursor, e)
    if end > cursor:
        gaps.append((cursor, end))
    return Digest((end - t0) * 1e-6, busy * 1e-6, ops, _label_gaps(gaps, spans_by_tid[slice_ev["tid"]], n_gaps))


def _label_gaps(gaps, spans, n: int) -> List[Tuple[str, float]]:
    """The ``n`` longest idle gaps, each named by the innermost host op of
    the main thread running at its middle."""
    spans = sorted((e for e in spans if e["name"] != SLICE), key=lambda e: e["ts"])
    starts = [e["ts"] for e in spans]
    out = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid)
        inside = [e for e in spans[max(0, i - 2000):i] if e["ts"] + e["dur"] >= mid]
        name = min(inside, key=lambda e: e["dur"])["name"] if inside else "(no host op)"
        out.append((name[:120], (b - a) * 1e-6))
    return out


# attribution by the ATen op that launched a device operation
CONV_OPS = frozenset({"aten::convolution", "aten::_convolution", "aten::convolution_backward",
                      "aten::cudnn_convolution"})
MATMUL_OPS = frozenset({"aten::matmul", "aten::mm", "aten::bmm"})


def is_conv(op: DeviceOp) -> bool:
    return bool(op.host & CONV_OPS)


def is_matmul(op: DeviceOp) -> bool:
    """A matrix product that is no convolution and no resize (``einsum``)."""
    return bool(op.host & MATMUL_OPS) and not is_conv(op) and "aten::einsum" not in op.host
