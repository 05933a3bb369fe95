"""Tracing / profiling / metric logging (``dsrg_tpu/utils/profiling.py``).

The reference has none of this (``SURVEY.md`` §5: an unused ``import
timeit`` is its entire observability story).  Here:

* :func:`span` — the program's named host spans at its layer boundaries.
  They are ``torch.profiler`` ranges, so they share the device trace's
  clock, and they record only while a profiler session does: with none, a
  span reads one flag and does nothing else.  :func:`span_totals` gives each
  span's count, inclusive and self host seconds since :func:`reset_spans`;
* :func:`trace` — ``torch.profiler`` over a block of steps, written as a
  Chrome trace (``chrome://tracing``, Perfetto) where the JAX package writes
  a ``jax.profiler`` trace, with the block's span totals beside it;
* :class:`StepTimer` — p50 / p90 / max host ms per step over a window, with
  images/sec;
* :class:`MetricLogger` — JSONL metric writer + Caffe-style console lines
  (``display`` / ``average_loss``, solver-s.prototxt:10-11);
* :func:`kernel_launches` — the port's CUDA kernel launch counters, which the
  CLIs print when they finish.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

# span name -> [count, inclusive s, self s, args]; filled only while a
# profiler session records, from any thread (the loader's, autograd's)
_SPANS: Dict[str, list] = {}
_SPANS_LOCK = threading.Lock()
_OPEN = threading.local()  # .stack: this thread's open spans, innermost last


class _SpanBase:
    __slots__ = ("name", "args")

    def __call__(self, fn):
        """As a decorator: a span around each call, on or off as the
        profiler is at that call."""
        name, args = self.name, self.args

        @functools.wraps(fn)
        def spanned(*a, **kw):
            with span(name, args):
                return fn(*a, **kw)

        return spanned


class _Off(_SpanBase):
    """The shared no-op of one span name."""

    __slots__ = ()

    def __init__(self, name: str):
        self.name, self.args = name, None

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


class _On(_SpanBase):
    __slots__ = ("_range", "_t0", "_children")

    def __init__(self, name: str, args):
        self.name, self.args = name, args

    def __enter__(self):
        self._range = _autograd_profiler.record_function(self.name)
        self._range.__enter__()
        stack = _OPEN.__dict__.setdefault("stack", [])
        stack.append(self)
        self._children = 0.0
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        stack = _OPEN.stack
        stack.pop()
        if stack:
            stack[-1]._children += dt
        with _SPANS_LOCK:
            entry = _SPANS.setdefault(self.name, [0, 0.0, 0.0, []])
            entry[0] += 1
            entry[1] += dt
            entry[2] += dt - self._children
            if self.args is not None:
                entry[3].append(self.args)
        self._range.__exit__(*exc)
        return False


_OFF: Dict[str, _Off] = {}


def span(name: str, args=None):
    """A named host span: ``with span("dsrg.grow"): ...`` or, with no
    ``args``, ``@span("dsrg.io.read")``.

    While a ``torch.profiler`` session records it opens
    ``record_function(name)``, so the range sits in the same Chrome trace as
    the device work it launches, and adds its count, inclusive host seconds
    and self host seconds (inclusive minus its child spans on the same
    thread) to the table :func:`span_totals` reads; ``args`` (a served
    chunk's sequence number) is kept in the table in call order.  With no
    session it returns a shared no-op: no range, no clock read, no
    allocation."""
    if not _autograd_profiler._is_profiler_enabled:
        off = _OFF.get(name)
        return off if off is not None else _OFF.setdefault(name, _Off(name))
    return _On(name, args)


def span_totals() -> Dict[str, dict]:
    """``{name: {"count", "inclusive_s", "self_s", "args"}}`` of the spans
    closed while a profiler recorded, since the last :func:`reset_spans`."""
    with _SPANS_LOCK:
        return {name: {"count": n, "inclusive_s": inc, "self_s": own, "args": list(args)}
                for name, (n, inc, own, args) in _SPANS.items()}


def reset_spans() -> None:
    with _SPANS_LOCK:
        _SPANS.clear()


def union_seconds(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals: overlapping device
    operations (several streams) count once."""
    total, cursor = 0.0, float("-inf")
    for a, b in sorted(intervals):
        a = max(a, cursor)
        if b > a:
            total += b - a
        cursor = max(cursor, b)
    return total


def _device_intervals(trace_path: str) -> List[Tuple[float, float]]:
    """(start, end) in us of the device's kernels, copies and sets in a
    Chrome trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block: ``with trace('/tmp/tb'): run_steps()``.

    Writes ``trace.json`` (the timeline, with the program's spans as
    ``user_annotation`` ranges), ``kernels.txt`` (device time by kernel) and
    ``spans.json`` (:func:`span_totals` of the block) into ``log_dir`` and
    prints the block's wall time, the device's busy time (the union of its
    operations' intervals) and its idle share.  The device is synchronised
    at both ends, so the wall time covers the block's device work."""
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    os.makedirs(log_dir, exist_ok=True)
    reset_spans()
    with profile(activities=activities) as prof:
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        if on_card:
            torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    trace_path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(trace_path)
    with open(os.path.join(log_dir, "kernels.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total" if on_card else "self_cpu_time_total",
                                          row_limit=40))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(span_totals(), f, indent=1, sort_keys=True)
    if on_card:
        busy_ms = union_seconds(_device_intervals(trace_path)) / 1e3
        print(f"profile: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, idle share "
              f"{1.0 - busy_ms / wall_ms:.3f}", flush=True)
    else:
        print(f"profile: wall {wall_ms:.1f} ms on the CPU (no device time)", flush=True)


def kernel_launches() -> Dict[str, int]:
    """Launches of each CUDA kernel of the port in this process so far."""
    from dsrg_tpu_torch.ops import pool_kernels as pk
    from dsrg_tpu_torch.ops.crf import mmgrid_kernels as mk
    from dsrg_tpu_torch.train.sgd_kernels import caffe_sgd

    return {"mmgrid_splat": mk.splat.launches, "mmgrid_slice": mk.slice.launches,
            "pool_bwd_h": pk.pool_bwd_h.launches, "pool_bwd_w": pk.pool_bwd_w.launches,
            "pool_bwd_h_bf16": pk.pool_bwd_h.launches_bf16, "pool_bwd_w_bf16": pk.pool_bwd_w.launches_bf16,
            "caffe_sgd": caffe_sgd.launches}


class StepTimer:
    """Host time between :meth:`tick` calls over the last ``window`` steps:
    p50, p90 and max ms per step (a stall shows in the p90 and the max,
    which an average would smooth away) and images/s over the window."""

    def __init__(self, batch_size: int, window: int = 20):
        self.batch_size = batch_size
        self.times: collections.deque = collections.deque(maxlen=window)
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
        self._last = now

    def summary(self) -> Optional[Dict[str, float]]:
        """``{"p50_ms", "p90_ms", "max_ms", "images_per_s"}`` over the
        window, or None before the second tick."""
        if not self.times:
            return None
        ms = 1e3 * np.asarray(self.times)
        p50, p90 = np.percentile(ms, [50, 90])
        return {"p50_ms": float(p50), "p90_ms": float(p90), "max_ms": float(ms.max()),
                "images_per_s": 1e3 * self.batch_size * len(ms) / float(ms.sum())}


class MetricLogger:
    def __init__(self, log_path: Optional[str] = None, average_window: int = 10):
        self.log_path = log_path
        if log_path:
            os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)
            self._f = open(log_path, "a")
        else:
            self._f = None
        self.window: Dict[str, collections.deque] = {}
        self.average_window = average_window

    def log(self, step: int, metrics: Dict[str, float]) -> Dict[str, float]:
        averaged = {}
        for k, v in metrics.items():
            v = float(v)
            self.window.setdefault(k, collections.deque(maxlen=self.average_window)).append(v)
            averaged[k] = sum(self.window[k]) / len(self.window[k])
        if self._f:
            self._f.write(json.dumps({"step": step, **{k: float(v) for k, v in metrics.items()}}) + "\n")
            self._f.flush()
        return averaged

    def close(self) -> None:
        if self._f:
            self._f.close()
