"""Tracing / profiling / metric logging (``dsrg_tpu/utils/profiling.py``).

The reference has none of this (``SURVEY.md`` §5: an unused ``import
timeit`` is its entire observability story).  Here:

* :func:`trace` — ``torch.profiler`` over a block of steps, written as a
  Chrome trace (``chrome://tracing``, Perfetto) where the JAX package writes
  a ``jax.profiler`` trace;
* :class:`StepTimer` — EMA step timing with images/sec;
* :class:`MetricLogger` — JSONL metric writer + Caffe-style console lines
  (``display`` / ``average_loss``, solver-s.prototxt:10-11);
* :func:`kernel_launches` — the port's CUDA kernel launch counters, which the
  CLIs print when they finish.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block: ``with trace('/tmp/tb'): run_steps()``.

    Writes ``trace.json`` (the timeline) and ``kernels.txt`` (device time by
    kernel) into ``log_dir`` and prints the block's wall time, the device's
    busy time and its idle share.  The device is synchronised at both ends,
    so the wall time covers the block's device work."""
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        if on_card:
            torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "kernels.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total" if on_card else "self_cpu_time_total",
                                          row_limit=40))
    if on_card:
        busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        print(f"profile: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, idle share "
              f"{max(0.0, 1.0 - busy_ms / wall_ms):.3f}", flush=True)
    else:
        print(f"profile: wall {wall_ms:.1f} ms on the CPU (no device time)", flush=True)


def kernel_launches() -> Dict[str, int]:
    """Launches of each CUDA kernel of the port in this process so far."""
    from dsrg_tpu_torch.ops import pool_kernels as pk
    from dsrg_tpu_torch.ops.crf import mmgrid_kernels as mk

    return {"mmgrid_splat": mk.splat.launches, "mmgrid_slice": mk.slice.launches,
            "pool_bwd_h": pk.pool_bwd_h.launches, "pool_bwd_w": pk.pool_bwd_w.launches,
            "pool_bwd_h_bf16": pk.pool_bwd_h.launches_bf16, "pool_bwd_w_bf16": pk.pool_bwd_w.launches_bf16}


class StepTimer:
    def __init__(self, batch_size: int, ema: float = 0.9):
        self.batch_size = batch_size
        self.ema = ema
        self._last: Optional[float] = None
        self.step_time: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self.step_time = dt if self.step_time is None else (
                self.ema * self.step_time + (1 - self.ema) * dt
            )
        self._last = now

    @property
    def images_per_sec(self) -> float:
        return self.batch_size / self.step_time if self.step_time else float("nan")


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
