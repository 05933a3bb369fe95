"""The Caffe SGD update: the plain loop and the CUDA kernel pair
(``train/sgd_kernels.py``, ``csrc/caffe_sgd.cu``), and the train steps that
hand it their gradients.

On the CPU: the plain path is the former two-stage computation (``g * inv``
for every leaf, then ``CaffeSGD.step``) bit for bit, the gradient norm is
taken once a step, a CPU optimizer never builds or loads the kernels, and a
step whose update is replaced still returns every metric.  On the card
(``cuda`` marker; skip elsewhere): the kernel pair against the plain loop run
on the card, at ResNet-101's and VGG16-LargeFOV's leaf shapes.  Nothing here
imports JAX, so on a machine without it the card tests run with
``python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_sgd.py``.
"""

import numpy as np
import pytest
import torch

from dsrg_tpu_torch import _build
from dsrg_tpu_torch.config import Stage1Config, Stage2Config
from dsrg_tpu_torch.models import FAMILIES, DeepLabLargeFOV, ResNet101DeepLab
from dsrg_tpu_torch.train import optimizer as opt_mod
from dsrg_tpu_torch.train import sgd_kernels
from dsrg_tpu_torch.train.optimizer import CaffeSGD, ScaledGrads, global_norm, lr_step
from dsrg_tpu_torch.train.sgd_kernels import caffe_sgd
from dsrg_tpu_torch.train.stage1 import init_stage1, make_stage1_step
from dsrg_tpu_torch.train.stage2 import init_stage2, make_stage2_step

NC, CROP, CUE = 6, 41, 6
# a name for each kind of leaf vgg_param_mults tells apart: weights, biases,
# the heads' weights and biases, frozen batch norm
NAMES = ("conv1_1.weight", "conv1_1.bias", "fc8_voc12_1.weight", "fc8_voc12_1.bias", "layer1.0.bn1.weight",
         "layer1.0.bn1.bias", "fc7.weight")
SHAPES = ((8, 3, 3, 3), (8,), (NC, 8, 3, 3), (NC,), (8,), (8,), (4099,))


def _leaves(gen, device="cpu", names=NAMES, shapes=SHAPES, scale=0.05):
    return {n: (torch.randn(s, generator=gen) * scale).to(device) for n, s in zip(names, shapes)}


def _two_stage_step(opt, raw, inv):
    """The update as the train steps made it before the kernel pair:
    ``{n: g * inv}``, then the loop of ``CaffeSGD.step``; returns the metric's
    norm, taken again after the update as the steps took it."""
    grads = {n: g * inv for n, g in raw.items()}
    scale = None
    if opt.clip_gradients and opt.clip_gradients > 0:
        scale = torch.clamp(opt.clip_gradients / torch.clamp_min(global_norm(grads.values()), 1e-12), max=1.0)
    lr = opt.lr_fn(opt.step_count)
    for name, w in opt.params.items():
        g = grads[name] if scale is None else grads[name] * scale
        g = g + (opt.weight_decay * opt.decay_mults[name]) * w
        g = (lr * opt.lr_mults[name]) * g
        v = opt.velocity[name]
        v.mul_(opt.momentum).add_(g)
        w.sub_(v)
    opt.step_count += 1
    return global_norm(grads.values())


def _pair(params, clip, share=False):
    """Two optimizers over copies of ``params`` (the first over ``params``
    themselves with ``share``)."""
    kw = dict(lr_fn=lr_step(0.1, 0.33, 2), momentum=0.9, weight_decay=5e-3, clip_gradients=clip)
    first = dict(params) if share else {n: p.clone() for n, p in params.items()}
    return CaffeSGD(first, **kw), CaffeSGD({n: p.clone() for n, p in params.items()}, **kw)


def _bits(t):
    return t.view(torch.int32)


# ---------------------------------------------------------------- CPU

# clip off, on but not engaging, engaging
@pytest.mark.parametrize("clip", [0.0, 1e30, 0.05])
def test_plain_update_is_the_two_stage_computation(clip):
    """Three steps (the second crosses lr_step's boundary) from a
    ScaledGrads: parameters, velocities and the norm bit for bit."""
    gen = torch.Generator().manual_seed(0)
    new, old = _pair(_leaves(gen), clip)
    for _ in range(3):
        raw = _leaves(gen, scale=1.0)
        inv = 1.0 / torch.clamp_min(torch.tensor(3.0), 1.0)
        grads = ScaledGrads(raw, inv)
        new.step(grads)
        norm = _two_stage_step(old, raw, inv)
        assert torch.equal(grads.norm(), norm)
    assert new.step_count == old.step_count == 3
    for n in NAMES:
        assert torch.equal(new.params[n], old.params[n]), n
        assert torch.equal(new.velocity[n], old.velocity[n]), n
    assert torch.equal(new.params["layer1.0.bn1.weight"], _leaves(torch.Generator().manual_seed(0))[
        "layer1.0.bn1.weight"])  # lr 0: frozen


def _stage2(clip):
    model = DeepLabLargeFOV(num_classes=NC, head_dilations=(2, 4))
    cfg = Stage2Config(num_classes=NC, batch_size=2, crop_size=CROP, mirror=False, max_iter=10,
                       clip_gradients=clip)
    state = init_stage2(model, cfg, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"images": torch.from_numpy((rng.normal(size=(2, CROP, CROP, 3)) * 40).astype(np.float32)),
             "labels": torch.from_numpy(rng.integers(0, NC, (2, CROP, CROP)))}
    return state, make_stage2_step(model, cfg, state.optimizer, state.generator), batch


def _stage1():
    """A ResNet of one block a stage: frozen BN leaves and the clip."""
    model = ResNet101DeepLab(num_classes=NC, head_dilations=(2, 4), stage_blocks=(1, 1, 1, 1))
    cfg = Stage1Config(num_classes=NC, batch_size=2, crop_size=CROP, cue_size=CUE, crf_iters=3, mirror=False,
                       clip_gradients=10.0, base_lr=1e-4)
    state = init_stage1(model, cfg, device="cpu")
    rng = np.random.default_rng(1)
    labels = np.zeros((2, NC), np.float32)
    labels[:, 0] = labels[0, 2] = labels[1, 4] = 1.0
    cues = (rng.uniform(size=(2, CUE, CUE, NC)) < 0.15).astype(np.float32) * labels[:, None, None, :]
    batch = {"images": (rng.normal(size=(2, CROP, CROP, 3)) * 40).astype(np.float32), "labels": labels,
             "cues": cues}
    return state, make_stage1_step(model, cfg, state.optimizer, state.generator), batch


@pytest.mark.parametrize("stage,clip", [("stage2", 0.0), ("stage2", 1.0), ("stage1", 10.0)])
def test_a_step_takes_the_gradient_norm_once(stage, clip, monkeypatch):
    """With the clip on, the update's norm is the metric; off, the metric
    takes it.  Either way one global norm a step."""
    calls = []

    def counted(tensors):
        calls.append(1)
        return global_norm(tensors)

    monkeypatch.setattr(opt_mod, "global_norm", counted)
    state, step, batch = _stage1() if stage == "stage1" else _stage2(clip)
    assert state.optimizer.clip_gradients == clip
    for k in range(2):
        metrics = step(batch)
        assert len(calls) == k + 1
    assert state.optimizer.step_count == 2 and torch.isfinite(metrics["grad_norm"])


def test_a_cpu_optimizer_never_builds_or_loads_the_kernels(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the kernels were built or loaded for a CPU optimizer")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    before = caffe_sgd.launches
    gen = torch.Generator().manual_seed(2)
    opt, _ = _pair(_leaves(gen), 1.0)
    opt.step(ScaledGrads(_leaves(gen, scale=1.0), torch.tensor(0.5)))
    opt.step(_leaves(gen, scale=1.0))  # a plain mapping too
    assert caffe_sgd.launches == before and "caffe_sgd" not in _build._libs
    assert sgd_kernels._entry.cache_info().currsize == 0


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_a_replaced_update_still_returns_every_metric(stage, monkeypatch):
    """``step(self, grads)`` that only counts (the benchmark's fault of a
    state left unchanged): the step runs, leaves the parameters as they were
    and returns every metric, the norm that of the scaled gradients."""
    seen = []

    def step(self, grads):
        seen.append(grads)
        self.step_count += 1

    monkeypatch.setattr(CaffeSGD, "step", step)
    state, train_step, batch = _stage1() if stage == "stage1" else _stage2(0.0)
    before = {n: p.clone() for n, p in state.optimizer.params.items()}
    metrics = train_step(batch)
    keys = {"loss", "loss_seed", "loss_constrain", "seed_pixels", "grad_norm"} if stage == "stage1" else \
        {"loss", "accuracy", "grad_norm"}
    assert set(metrics) == keys and all(torch.isfinite(v) for v in metrics.values())
    assert all(torch.equal(p, before[n]) for n, p in state.optimizer.params.items())
    grads = seen[0]
    expect = global_norm([grads.raw[n] * grads.inv for n in grads.raw])
    assert torch.equal(metrics["grad_norm"], expect) and metrics["grad_norm"] > 0


def _refused_cases():
    f = torch.zeros(4)
    return {
        "cpu tensors": ([f], [f.clone()], [f.clone()], None, [0.0], [0.1]),
        "float64": ([f.double()], [f.double()], [f.double()], None, [0.0], [0.1]),
        "shapes": ([torch.zeros(5)], [f.clone()], [f.clone()], None, [0.0], [0.1]),
        "not contiguous": ([torch.zeros(4, 2).t()], [torch.zeros(2, 4)], [torch.zeros(2, 4)], None, [0.0], [0.1]),
        "counts": ([f], [f.clone(), f.clone()], [f.clone()], None, [0.0], [0.1]),
        "coefficients": ([f], [f.clone()], [f.clone()], None, [0.0, 1.0], [0.1]),
    }


@pytest.mark.parametrize("case", sorted(_refused_cases()))
def test_caffe_sgd_refuses_what_the_kernels_do_not_take(case):
    grads, params, velocity, inv, wd, lr = _refused_cases()[case]
    with pytest.raises(ValueError):
        caffe_sgd(grads, params, velocity, inv, wd, lr, 0.9, 0.0)


# ---------------------------------------------------------------- card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _family_leaves(family, dev, seed):
    """The named leaves of the full-size model, random (N(0, 0.05)), on the card."""
    with torch.device("meta"):
        model = FAMILIES[family](num_classes=21)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {n: torch.randn(p.shape, generator=gen, device=dev) * 0.05 for n, p in model.named_parameters()}


def _grads_like(params, gen, scale):
    return {n: torch.randn(p.shape, generator=gen, device=p.device) * scale for n, p in params.items()}


def _plain_on_card(opt, grads):
    """The plain loop on the card's ATen ops: the kernels' twin."""
    opt._step_plain(grads)
    opt.step_count += 1


@pytest.mark.cuda
@pytest.mark.parametrize("clip", ["off", "not engaging", "engaging"])
@pytest.mark.parametrize("family", ["resnet101", "vgg16"])
def test_kernels_match_the_plain_loop(cuda, family, clip):
    """Three steps at the family's 320 / 50 leaf shapes (grad sums at batch
    20, inv = 1/20): w and v bit-equal where the clip does not engage, within
    1e-6 of the leaf's largest where it does; the norm within 1e-6 relative;
    lr-0 leaves unchanged; 2 launches a step; the same bits on a second run."""
    params = _family_leaves(family, cuda, 0)
    n_leaves = {"resnet101": 320, "vgg16": 50}[family]
    assert len(params) == n_leaves
    limit = {"off": 0.0, "not engaging": 1e30, "engaging": 10.0}[clip]
    kern, plain = _pair(params, limit)
    again, _ = _pair(params, limit)
    gen = torch.Generator(device=cuda).manual_seed(1)
    inv = 1.0 / torch.clamp_min(torch.tensor(20.0, device=cuda), 1.0)
    for _ in range(3):
        raw = _grads_like(params, gen, 0.5)
        grads, ref, rerun = ScaledGrads(raw, inv), ScaledGrads(raw, inv), ScaledGrads(raw, inv)
        before = caffe_sgd.launches
        kern.step(grads)
        assert caffe_sgd.launches == before + 2
        again.step(rerun)
        _plain_on_card(plain, ref)
        torch.testing.assert_close(grads.norm(), ref.norm(), rtol=1e-6, atol=0)
        assert torch.equal(grads.norm(), rerun.norm())
        if clip == "engaging":
            assert ref.norm() > limit
    for n in params:
        assert torch.equal(_bits(kern.params[n]), _bits(again.params[n]))
        assert torch.equal(_bits(kern.velocity[n]), _bits(again.velocity[n]))
        for got, want in ((kern.params[n], plain.params[n]), (kern.velocity[n], plain.velocity[n])):
            if clip == "engaging":
                assert (got - want).abs().max() <= 1e-6 * want.abs().max(), n
            else:
                assert torch.equal(_bits(got), _bits(want)), n
        if kern.lr_mults[n] == 0.0:
            assert torch.equal(_bits(kern.params[n]), _bits(params[n])), n
    assert any(m == 0.0 for m in kern.lr_mults.values()) == (family == "resnet101")


def _small_leaves(dev, seed, n=7):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {name: torch.randn(s, generator=gen, device=dev) * 0.05 for name, s in zip(NAMES[:n], SHAPES[:n])}


@pytest.mark.cuda
@pytest.mark.parametrize("clip", [0.0, 10.0])
def test_inf_and_nan_spread_as_in_the_plain_loop(cuda, clip):
    params = _small_leaves(cuda, 3)
    kern, plain = _pair(params, clip)
    gen = torch.Generator(device=cuda).manual_seed(4)
    inv = torch.tensor(0.25, device=cuda)
    for k in range(2):  # an inf, then an inf and a NaN
        raw = _grads_like(params, gen, 1.0)
        raw["conv1_1.weight"].view(-1)[k] = float("inf")
        if k:
            raw["fc7.weight"][4097] = float("nan")
        grads, ref = ScaledGrads(raw, inv), ScaledGrads(raw, inv)
        kern.step(grads)
        _plain_on_card(plain, ref)
        torch.testing.assert_close(grads.norm(), ref.norm(), rtol=0, atol=0, equal_nan=True)
    for n in params:
        for got, want in ((kern.params[n], plain.params[n]), (kern.velocity[n], plain.velocity[n])):
            torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
def test_the_update_follows_replaced_velocities(cuda):
    """``parallel.mesh.replicate_to_mesh`` puts new velocity tensors in the
    dict; the next update writes those and leaves the old ones."""
    params = _small_leaves(cuda, 5)
    kern, plain = _pair(params, 0.0)
    gen = torch.Generator(device=cuda).manual_seed(6)
    inv = torch.tensor(0.5, device=cuda)
    for k in range(3):
        raw = _grads_like(params, gen, 1.0)
        kern.step(ScaledGrads(raw, inv))
        _plain_on_card(plain, ScaledGrads(raw, inv))
        if k == 0:
            old = kern.velocity
            kept = {n: v.clone() for n, v in old.items()}
            kern.velocity = {n: v.clone() for n, v in old.items()}
            kern.params.update({n: w.clone() for n, w in kern.params.items()})  # as a model moved
    for n in params:
        assert torch.equal(_bits(old[n]), _bits(kept[n])), n
        assert torch.equal(_bits(kern.velocity[n]), _bits(plain.velocity[n]))
        assert torch.equal(_bits(kern.params[n]), _bits(plain.params[n]))


@pytest.mark.cuda
def test_unaligned_views(cuda):
    """Leaves as views into one buffer at offsets that are not 16-byte
    aligned (gradients after the coalesced all-reduce)."""
    rng = np.random.default_rng(7)
    sizes = [int(s) for s in rng.integers(1, 9000, 300)]
    names = [f"conv{i}.weight" if i % 3 else f"conv{i}.bias" for i in range(len(sizes))]
    gen = torch.Generator(device=cuda).manual_seed(8)
    flat_w = torch.randn(sum(sizes) + 1, generator=gen, device=cuda) * 0.05
    offsets = np.cumsum([1] + sizes[:-1])  # starts at element 1: no leaf is aligned
    params = {n: flat_w[o:o + s] for n, o, s in zip(names, offsets, sizes)}
    kern, plain = _pair(params, 1e30, share=True)
    inv = torch.tensor(0.1, device=cuda)
    for _ in range(2):
        flat_g = torch.randn(sum(sizes) + 1, generator=gen, device=cuda)
        raw = {n: flat_g[o:o + s] for n, o, s in zip(names, offsets, sizes)}
        grads, ref = ScaledGrads(raw, inv), ScaledGrads(raw, inv)
        before = caffe_sgd.launches
        kern.step(grads)
        assert caffe_sgd.launches == before + 2
        _plain_on_card(plain, ref)
        torch.testing.assert_close(grads.norm(), ref.norm(), rtol=1e-6, atol=0)
    for n in names:
        assert torch.equal(_bits(kern.params[n]), _bits(plain.params[n])), n
        assert torch.equal(_bits(kern.velocity[n]), _bits(plain.velocity[n])), n


@pytest.mark.cuda
def test_more_leaves_than_the_table_holds_are_refused(cuda):
    leaves = [torch.zeros(3, device=cuda) for _ in range(sgd_kernels._entry().max_leaves + 1)]
    before = caffe_sgd.launches
    with pytest.raises(ValueError, match="at most"):
        caffe_sgd(leaves, [t.clone() for t in leaves], [t.clone() for t in leaves], None, [0.0] * len(leaves),
                  [0.1] * len(leaves), 0.9, 0.0)
    assert caffe_sgd.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("clip", [0.0, 10.0])
def test_no_host_sync_in_the_update(cuda, clip):
    params = _family_leaves("resnet101", cuda, 9)
    kern, _ = _pair(params, clip)
    gen = torch.Generator(device=cuda).manual_seed(10)
    inv = 1.0 / torch.clamp_min(torch.tensor(20.0, device=cuda), 1.0)
    kern.step(ScaledGrads(_grads_like(params, gen, 0.5), inv))  # builds and loads first
    raw = _grads_like(params, gen, 0.5)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        grads = ScaledGrads(raw, inv)
        kern.step(grads)
        norm = grads.norm()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(norm)
