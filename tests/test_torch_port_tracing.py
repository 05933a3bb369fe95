"""The port's spans (``dsrg_tpu_torch/utils/profiling.py``), the program's
spans at its layer boundaries, and the benchmark's readers of them
(``portbench/metrics/``), on the CPU at tiny sizes."""

import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dsrg_tpu_torch.config import Stage1Config
from dsrg_tpu_torch.inference import Predictor
from dsrg_tpu_torch.models import DeepLabLargeFOV
from dsrg_tpu_torch.models.resnet101_deeplab import FrozenBatchNorm2d
from dsrg_tpu_torch.ops.grow import dsrg_grow
from dsrg_tpu_torch.train.stage1 import init_stage1, make_stage1_step
from dsrg_tpu_torch.utils import profiling
from portbench import harness
from portbench.yardstick.trace import DeviceOp, Digest

NC, CROP, CUE = 6, 41, 6


@pytest.fixture(scope="module")
def stage1():
    """(step, batch): a tiny stage-1 step whose grower floods two classes."""
    cfg = Stage1Config(num_classes=NC, batch_size=2, crop_size=CROP, cue_size=CUE, crf_iters=2,
                       mirror=False, th1=0.55, th2=0.4)
    model = DeepLabLargeFOV(num_classes=NC, head_dilations=(2, 4), dropout_rate=0.0)
    state = init_stage1(model, cfg, device="cpu")
    rng = np.random.default_rng(0)
    labels = np.zeros((2, NC), np.float32)
    labels[:, 0] = labels[0, 2] = labels[1, 4] = 1.0
    cues = (rng.uniform(size=(2, CUE, CUE, NC)) < 0.15).astype(np.float32) * labels[:, None, None, :]
    batch = {"images": (rng.normal(size=(2, CROP, CROP, 3)) * 40).astype(np.float32),
             "labels": labels, "cues": cues}
    return make_stage1_step(model, cfg, state.optimizer, state.generator), batch


@pytest.fixture(scope="module")
def predictor():
    return Predictor(DeepLabLargeFOV(num_classes=NC, head_dilations=(2, 4)), num_classes=NC, device="cpu")


def _images(n):
    rng = np.random.default_rng(1)
    return [rng.integers(0, 256, (30 + 3 * i, 36 - 2 * i, 3), dtype=np.uint8) for i in range(n)]


def _serve(predictor, n_images):
    return list(predictor.iter_masks_device(iter(_images(n_images)), sizes=[33], chunk=2, in_flight=2))


def test_without_a_profiler_the_program_enters_no_range(stage1, predictor, monkeypatch):
    entered = []
    real_enter = torch.autograd.profiler.record_function.__enter__

    def counting_enter(self):
        entered.append(self.name)
        return real_enter(self)

    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__", counting_enter)
    profiling.reset_spans()
    step, batch = stage1
    step(batch)
    _serve(predictor, 4)
    bn = FrozenBatchNorm2d(3)
    x = torch.randn(2, 3, 5, 5, requires_grad=True)
    bn(x).sum().backward()
    assert entered == [] and profiling.span_totals() == {}
    # the off span is one shared object per name: nothing is allocated
    assert profiling.span("dsrg.grow") is profiling.span("dsrg.grow")
    with profile(activities=[ProfilerActivity.CPU]):
        bn(x).sum().backward()
    assert entered == ["frozen_batch_norm"] * 2
    assert profiling.span_totals()["frozen_batch_norm"]["count"] == 2


def test_a_profiled_step_nests_its_spans_and_counts_each_read_back(stage1, tmp_path):
    step, batch = stage1
    profiling.reset_spans()
    checks = dsrg_grow.checks
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            step(batch)
    checks = dsrg_grow.checks - checks
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    totals = profiling.span_totals()
    assert checks > 2
    assert totals["dsrg.grow.sync"]["count"] == checks + 2  # + the present classes' list, once a step
    for name in ("dsrg.step", "dsrg.forward", "dsrg.loss", "dsrg.backward", "dsrg.update", "dsrg.grow"):
        assert totals[name]["count"] == 2, name
    events = [e for e in json.load(open(tmp_path / "trace.json"))["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    by_name = {}
    for e in events:
        by_name.setdefault(e["name"], []).append(e)

    def inside(child, parents):
        return any(p["ts"] <= child["ts"] and child["ts"] + child["dur"] <= p["ts"] + p["dur"] for p in parents)

    assert len(by_name["dsrg.step"]) == 2 and len(by_name["dsrg.grow.sync"]) == checks + 2
    for child, parent in (("dsrg.forward", "dsrg.step"), ("dsrg.loss", "dsrg.step"),
                          ("dsrg.backward", "dsrg.step"), ("dsrg.update", "dsrg.step"),
                          ("dsrg.grow", "dsrg.loss"), ("dsrg.grow.sync", "dsrg.grow")):
        assert all(inside(e, by_name[parent]) for e in by_name[child]), (child, parent)
    # the four phases partition the step: its own time is only the call's frame
    phases = sum(totals[n]["inclusive_s"] for n in ("dsrg.forward", "dsrg.loss", "dsrg.backward", "dsrg.update"))
    assert totals["dsrg.step"]["self_s"] == pytest.approx(totals["dsrg.step"]["inclusive_s"] - phases, abs=1e-9)
    assert 0.0 <= totals["dsrg.step"]["self_s"] < 0.25 * totals["dsrg.step"]["inclusive_s"]


def test_served_chunks_pair_submit_and_finish_by_id(predictor):
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        masks = _serve(predictor, 4)
    assert len(masks) == 4
    totals = profiling.span_totals()
    submitted, finished = totals["dsrg.serve.submit"]["args"], totals["dsrg.serve.finish"]["args"]
    assert len(submitted) == 2 and submitted == finished and submitted[1] == submitted[0] + 1
    assert totals["dsrg.crf"]["count"] == 2


def _elsewhere():
    with profiling.span("elsewhere", 7):
        time.sleep(0.001)


def test_self_time_is_inclusive_minus_children():
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("outer"):
            time.sleep(0.01)
            for _ in range(2):
                with profiling.span("inner"):
                    time.sleep(0.005)
                    with profiling.span("leaf"):
                        time.sleep(0.002)
            # a span on another thread is no child of this thread's spans
            worker = threading.Thread(target=_elsewhere)
            worker.start()
            worker.join(timeout=10)
    assert not worker.is_alive()
    t = profiling.span_totals()
    assert t["inner"]["count"] == 2 and t["leaf"]["count"] == 2 and t["elsewhere"]["args"] == [7]
    assert t["outer"]["self_s"] == pytest.approx(t["outer"]["inclusive_s"] - t["inner"]["inclusive_s"], abs=1e-9)
    assert t["inner"]["self_s"] == pytest.approx(t["inner"]["inclusive_s"] - t["leaf"]["inclusive_s"], abs=1e-9)
    assert t["leaf"]["self_s"] == t["leaf"]["inclusive_s"]
    assert t["elsewhere"]["self_s"] == t["elsewhere"]["inclusive_s"]
    assert t["outer"]["self_s"] >= 0.01 and t["inner"]["self_s"] >= 0.01


def test_decorated_functions_check_the_profiler_at_each_call():
    @profiling.span("decorated")
    def f(x):
        return x + 1

    profiling.reset_spans()
    assert f(1) == 2 and profiling.span_totals() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        assert f(2) == 3
    assert profiling.span_totals()["decorated"]["count"] == 1


def test_union_seconds_counts_overlaps_once():
    assert profiling.union_seconds([]) == 0.0
    assert profiling.union_seconds([(5, 6), (0, 2), (1, 3), (2.5, 2.75)]) == 4.0


def test_step_timer_reports_percentiles_over_its_window(monkeypatch):
    clock = iter([0.0, 0.01, 0.02, 0.03, 0.13, 0.14])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    timer = profiling.StepTimer(batch_size=4, window=4)
    assert timer.summary() is None
    for _ in range(6):
        timer.tick()
    s = timer.summary()  # the window holds the last four: 10, 10, 100, 10 ms
    assert s["p50_ms"] == pytest.approx(10.0) and s["max_ms"] == pytest.approx(100.0)
    assert s["p90_ms"] == pytest.approx(73.0) and s["images_per_s"] == pytest.approx(16 / 0.13)


def _digest():
    """Two steps' device operations: a grow flag read opens a 2 ms gap that
    the grower's next dilation closes; the 1 ms gap before the loss is not
    the grower's.  Times in us."""
    ops = [DeviceOp("conv", 0.0, 1000.0, frozenset({"aten::convolution", "dsrg.forward"})),
           DeviceOp("crf", 1000.0, 500.0, frozenset({"dsrg.crf", "aten::bmm"})),
           DeviceOp("crf_bwd", 1200.0, 500.0, frozenset({"dsrg.crf"})),  # overlaps: another stream
           DeviceOp("dilate", 1700.0, 100.0, frozenset({"dsrg.grow", "aten::max_pool2d"})),
           DeviceOp("dilate", 3800.0, 100.0, frozenset({"dsrg.grow", "aten::max_pool2d"})),
           DeviceOp("loss", 4900.0, 100.0, frozenset({"dsrg.loss"}))]
    return Digest(window_s=0.005, busy_s=0.0029, ops=ops)


SPAN_TABLE = {"dsrg.grow.sync": {"count": 30, "inclusive_s": 0.06, "self_s": 0.06, "args": []},
              "dsrg.update": {"count": 2, "inclusive_s": 0.05, "self_s": 0.05, "args": []},
              "dsrg.serve.submit": {"count": 3, "inclusive_s": 0.09, "self_s": 0.06, "args": [4, 5, 6]},
              "dsrg.io.read": {"count": 24, "inclusive_s": 0.12, "self_s": 0.12, "args": []},
              "dsrg.io.write": {"count": 24, "inclusive_s": 0.03, "self_s": 0.03, "args": []}}
WANT = {"grow_syncs.train": 15.0, "grow_idle_ms.train": 1.0, "update_host_ms.train": 25.0,
        "crf_ms.train": 0.5, "crf_ms.serve": 0.5, "serve_submit_ms.serve": 45.0, "serve_io_ms.serve": 75.0}


@pytest.mark.parametrize("name", sorted(WANT))
def test_span_readers(name, monkeypatch):
    reader = harness.load_metric(name)
    assert reader.read({"digest": None, "units": 1}) is None
    monkeypatch.setattr(profiling, "span_totals", lambda: SPAN_TABLE)
    assert reader.read({"digest": _digest(), "units": 2}) == pytest.approx(WANT[name])
    monkeypatch.setattr(profiling, "span_totals", lambda: {})
    empty = Digest(window_s=0.005, busy_s=0.0, ops=[DeviceOp("conv", 0.0, 1.0, frozenset())])
    assert reader.read({"digest": empty, "units": 2}) is None


def test_every_new_reader_is_declared_for_its_cells():
    bench = harness.load_benchmark()
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name in WANT:
        assert declared[name]["workloads"] and declared[name]["unit"] in ("count", "ms")
