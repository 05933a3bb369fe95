"""Each driver's plumbing at small sizes on the CPU: the reference against a
port run comes out correct, and a run whose timed path is broken
underneath comes out not correct, once for each fault the cell can have
(a step that leaves its state unchanged, half of the batch left out with
the mean over the rest, an answer altered where it is produced).  The cells
take one card, so no exchange between cards can be left out."""

import time

import pytest
import torch

from portbench import harness

TRAIN = {"batch": 2, "crop": 41, "pool": 8, "warmup_steps": 3, "profile_steps": 1, "size_min": 48,
         "size_max": 72}
TINY = {
    "vgg16_largefov.stage1": {**TRAIN, "cue": 6},
    "resnet101_deeplabv2.stage1": {**TRAIN, "cue": 6},
    "vgg16_largefov.stage2": TRAIN,
    "vgg16_largefov.test_ms": {"chunk": 2, "sizes": [41, 49], "image_sizes": [[60, 84], [84, 60]], "pool": 6,
                               "sample": 3, "profile_chunks": 1},
}
TRAIN_CELLS = [c for c in TINY if "stage" in c]


def _run(cell: str, seed: int = 11) -> dict:
    return harness.run_cell(cell, seed, 0.5, False, "cpu", time.perf_counter(), overrides=TINY[cell])


@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_sound_run_is_correct(cell):
    line = _run(cell)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0


def _unchanged(monkeypatch):
    from dsrg_tpu_torch.train.optimizer import CaffeSGD

    def step(self, grads):
        self.step_count += 1

    monkeypatch.setattr(CaffeSGD, "step", step)


def _half_batch(monkeypatch):
    from dsrg_tpu_torch.data.loader import PrefetchLoader

    nxt = PrefetchLoader.__next__

    def half(self):
        batch = nxt(self)
        b = batch["images"].shape[0]
        keep = (torch.arange(b, device=batch["images"].device) < b // 2).float()
        return {**batch, "pad_mask": keep}

    monkeypatch.setattr(PrefetchLoader, "__next__", half)


def _altered_loss(monkeypatch):
    from dsrg_tpu_torch.train import stage1, stage2

    for module, name in ((stage1, "make_stage1_step"), (stage2, "make_stage2_step")):
        make = getattr(module, name)

        def wrapped(*args, _make=make, **kwargs):
            step = _make(*args, **kwargs)
            return lambda batch: {**(m := step(batch)), "loss": m["loss"] * 1.01}

        monkeypatch.setattr(module, name, wrapped)


FAULTS = {"state_unchanged": _unchanged, "half_batch": _half_batch, "loss_altered": _altered_loss}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_a_broken_train_step_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    line = _run(cell)
    assert not line["correct"], line["checks"]


def test_an_altered_mask_is_not_correct(monkeypatch):
    from dsrg_tpu_torch.inference import Predictor

    finish = Predictor._finish_device_ms

    def altered(submitted):
        masks = finish(submitted)
        for m in masks:
            m[:6, :6] = (m[:6, :6] + 1) % 21
        return masks

    monkeypatch.setattr(Predictor, "_finish_device_ms", staticmethod(altered))
    line = _run("vgg16_largefov.test_ms")
    assert not line["correct"], line["checks"]
