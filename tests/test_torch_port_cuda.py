"""The port's CUDA kernels held against their plain versions on the card.

These need an NVIDIA card and nvcc, and skip elsewhere.  They import
nothing of JAX, so on a machine without it they run with
``python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py``.
"""

import os

import numpy as np
import pytest
import torch

import _crf_f64
from dsrg_tpu_torch.ops.crf import mmgrid as tmm
from dsrg_tpu_torch.ops.crf import mmgrid_kernels as mk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, t, px, gc, c, dev, clustered):
    """Sparse operands, values and a slab.  ``clustered``: the pixels of a
    tile share their bins but for a few, as a photo's do; else every pixel
    has bins of its own."""
    rng = np.random.default_rng(seed)
    if clustered:
        lo = np.clip(rng.integers(0, gc - 1, (3, t, 1)) + (rng.random((3, t, px)) < 0.1), 0, gc - 2)
    else:
        lo = rng.integers(0, gc - 1, (3, t, px))
    fb, fg, fr = rng.random((3, t, px)).astype(np.float32)
    wbg4 = np.stack([(1 - fb) * (1 - fg), (1 - fb) * fg, fb * (1 - fg), fb * fg], 1)
    idx = mk.pack_index(*(torch.from_numpy(a) for a in lo), gc).to(dev)
    wbg4 = torch.from_numpy(wbg4).to(dev).bfloat16()
    wr2 = torch.from_numpy(np.stack([1 - fr, fr], 1)).to(dev).bfloat16()
    values = torch.from_numpy(rng.normal(size=(t, c, px)).astype(np.float32)).to(dev)
    slab = torch.from_numpy(rng.normal(size=(t, gc * gc, gc * c)).astype(np.float32)).to(dev).bfloat16()
    return (idx, wbg4, wr2), values, slab


# the serving shape (8 images: 1040 tiles of 1600 pixels, gc = 21, C = 21 and
# the mask normalisation's C = 1) and small odd ones: px not a multiple of
# 4, more channels than lanes, and an 80 x 80 tile (the ``spatial_exact``
# path at sigma_xy 80) whose values do not fit the splat's shared memory
@pytest.mark.parametrize("t,px,gc,c,clustered", [
    (1040, 1600, 21, 21, True), (1040, 1600, 21, 1, True), (3, 1600, 21, 21, False),
    (2, 77, 7, 3, False), (5, 300, 9, 40, True), (1, 256, 5, 81, False), (2, 6400, 21, 21, True),
    (192, 1600, 21, 81, True), (24, 1600, 21, 81, False)])
def test_kernels_match_plain(cuda, t, px, gc, c, clustered):
    """Tolerance 1e-5 x max|plain| (fp32 sums in another order); two launches
    on the same inputs give the same bits, the splat's second one with the
    pixels' order left for the wrapper to compute."""
    sparse, values, slab = _inputs(t * px + c, t, px, gc, c, cuda, clustered)
    s0, l0 = mk.splat.launches, mk.slice.launches
    perm = mk.sort_pixels(sparse[0])
    for kernel, plain, x, more in ((mk.splat, mk.splat_plain, values, (perm,)),
                                  (mk.slice, mk.slice_plain, slab, ())):
        got, again = kernel(*sparse, x, gc, *more), kernel(*sparse, x, gc)
        ref = plain(*sparse, x, gc)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    assert (mk.splat.launches, mk.slice.launches) == (s0 + 2, l0 + 2)


def test_coco_tiles_take_the_unstaged_splat(cuda):
    """COCO's 81 classes at the served 1600-pixel tiles: the splat reads its
    values from device memory (the unstaged template), C = 21 stages them;
    both give the plain version's slab."""
    assert mk.splat_staged(1600, 21) and not mk.splat_staged(1600, 81)
    sparse, values, _ = _inputs(81, 12, 1600, 21, 81, cuda, True)
    got = mk.splat(*sparse, values, 21)
    ref = mk.splat_plain(*sparse, values, 21)
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("engine", ["grid", "lattice"])
def test_grid_and_lattice_card_match_cpu(cuda, engine):
    """The grid and lattice engines on the card against the CPU: their
    splats are index_add_ sums, which the card adds with atomics in no fixed
    order, so marginals agree within 1e-4 and argmaxes on >= 0.999 of the
    pixels, not bit for bit."""
    from dsrg_tpu_torch.ops.crf.grid import mean_field_grid
    from dsrg_tpu_torch.ops.crf.lattice import mean_field_lattice

    fn = {"grid": mean_field_grid, "lattice": mean_field_lattice}[engine]
    rng = np.random.default_rng(9)
    h, w, m = 90, 120, 21
    img = np.zeros((h, w, 3), np.float32)
    img[:, : w // 2] = [200, 60, 50]
    img[:, w // 2:] = [30, 180, 190]
    img = np.clip(img + rng.normal(size=img.shape) * 8, 0, 255).astype(np.float32)
    prefer = np.zeros((h, w, m))
    prefer[:, : w // 2, 1] = prefer[:, w // 2:, 2] = 1.0
    unary = np.log(0.65 * rng.dirichlet(np.ones(m), size=(h, w)) + 0.35 * prefer).astype(np.float32)
    got = fn(torch.from_numpy(unary).to(cuda), torch.from_numpy(img).to(cuda), n_iters=10).cpu()
    ref = fn(torch.from_numpy(unary), torch.from_numpy(img), n_iters=10)
    assert (got - ref).abs().max().item() <= 1e-4
    assert (got.argmax(-1) == ref.argmax(-1)).float().mean().item() >= 0.999


def test_stage1_coco_step_card_matches_cpu(cuda):
    """One tiny 81-class stage-1 step on a uint8 batch with COCO_MEAN from the
    same weights on the card and the CPU: metrics within 1e-3 (fp32 sums in
    other orders), 5 + 5 pool kernel launches on the card."""
    from dsrg_tpu_torch.config import Stage1Config
    from dsrg_tpu_torch.data.coco import COCO_MEAN
    from dsrg_tpu_torch.models import DeepLabLargeFOV
    from dsrg_tpu_torch.ops import pool_kernels as pk
    from dsrg_tpu_torch.train.stage1 import init_stage1, make_stage1_step

    rng = np.random.default_rng(12)
    cfg = Stage1Config(num_classes=81, batch_size=2, crop_size=41, cue_size=6, crf_iters=3, mirror=False)
    labels = np.zeros((2, 81), np.float32)
    labels[:, 0] = labels[0, 17] = labels[1, 60] = 1.0
    small = rng.choice([0, 17, 60, 255], size=(2, 6, 6))
    cues = np.zeros((2, 6, 6, 81), np.uint8)
    for b, y, x in zip(*np.nonzero(small != 255)):
        cues[b, y, x, small[b, y, x]] = 1
    batch = {"images": rng.integers(0, 256, (2, 41, 41, 3)).astype(np.uint8), "labels": labels,
             "cues": cues * labels[:, None, None, :].astype(np.uint8)}
    out = {}
    for dev in (cuda, "cpu"):
        model = DeepLabLargeFOV(num_classes=81, head_dilations=(2, 4), dropout_rate=0.0)
        state = init_stage1(model, cfg, device=dev)
        counts = (pk.pool_bwd_h.launches, pk.pool_bwd_w.launches)
        m = make_stage1_step(model, cfg, state.optimizer, state.generator, input_mean=COCO_MEAN)(batch)
        out[str(dev)] = {k: v.item() for k, v in m.items()}
        launched = (pk.pool_bwd_h.launches - counts[0], pk.pool_bwd_w.launches - counts[1])
        assert launched == ((5, 5) if dev is cuda else (0, 0))
    for key in ("loss", "loss_seed", "loss_constrain", "grad_norm"):
        np.testing.assert_allclose(out[str(cuda)][key], out["cpu"][key], rtol=1e-3, err_msg=key)


def test_plan_on_the_card_is_sparse(cuda):
    """The plan and the filter on the card never build the dense operands."""
    rng = np.random.default_rng(2)
    guide = torch.from_numpy(rng.integers(0, 255, (2, 90, 70, 3)).astype(np.float32)).to(cuda)
    calls = mk.dense_operands.calls
    plan = tmm.MMGridPlan(guide, 80.0, 13.0)
    plan.filter_cf(torch.rand((2, 3, 90, 70), device=cuda))
    assert mk.dense_operands.calls == calls and not hasattr(plan, "wbg")
    cpu_plan = tmm.MMGridPlan(guide.cpu(), 80.0, 13.0)
    for name in ("idx", "perm", "wbg4", "wr2"):
        assert torch.equal(getattr(plan, name).cpu(), getattr(cpu_plan, name)), name


# odd shapes: H and W not multiples of 32, C = 3, both strides of the step's
# 3x3 pad-1 pools and two other windows up to the kernels' largest; integer
# data 0..2 puts several equal maxima in most windows, so any other tie rule shows
@pytest.mark.parametrize("h,w,k,s,p", [(37, 45, 3, 2, 1), (38, 29, 3, 2, 1), (41, 41, 3, 1, 1),
                                       (19, 70, 3, 1, 1), (23, 31, 2, 2, 0), (26, 33, 4, 3, 2)])
def test_pool_kernels_match_plain(cuda, h, w, k, s, p):
    from dsrg_tpu_torch.ops import pool_kernels as pk
    from dsrg_tpu_torch.ops.pooling import _caffe_pool_geometry

    ho, _ = _caffe_pool_geometry(h, k, s, p)
    wo, _ = _caffe_pool_geometry(w, k, s, p)
    rng = np.random.default_rng(h * w + s)

    def ints(lo, hi, shape):
        return torch.tensor(rng.integers(lo, hi, shape), dtype=torch.float32, device=cuda)

    x, yw = ints(0, 3, (2, 3, h, w)), ints(0, 3, (2, 3, h, wo))
    g, gw = ints(-4, 5, (2, 3, ho, wo)), ints(-4, 5, (2, 3, h, wo))
    h0, w0 = pk.pool_bwd_h.launches, pk.pool_bwd_w.launches
    got_h, got_w = pk.pool_bwd_h(yw, g, k, s, p), pk.pool_bwd_w(x, gw, k, s, p)
    torch.cuda.synchronize()
    assert torch.equal(got_h, pk.pool_bwd_h_plain(yw, g, k, s, p))
    assert torch.equal(got_w, pk.pool_bwd_w_plain(x, gw, k, s, p))
    assert (pk.pool_bwd_h.launches, pk.pool_bwd_w.launches) == (h0 + 1, w0 + 1)


def _offset_view(a: np.ndarray, lead: int, dev) -> torch.Tensor:
    """``a`` on the card as a contiguous view that starts ``lead`` floats into
    its storage, so ``lead`` floats beyond a 16-byte boundary."""
    flat = torch.zeros(a.size + lead, dtype=torch.float32, device=dev)
    flat[lead:] = torch.from_numpy(a.ravel())
    return flat[lead:].view(a.shape)


# float cotangents: only the sum over taps in the order t = 0..k-1 gives the
# plain version's bits (integer cotangents give them in any order).  Shapes at
# the tiles' edges: pool1's and pool2's planes (several bands whose boundaries
# fall inside windows, the Caffe last window overhanging, row counts that are
# no multiple of the rows per block); with ``tile`` bytes of shared memory per
# block instead of the default, several bands and ragged last blocks on small
# inputs, and at 64 KB (over the 48 KB that need opting in) blocks of four
# 41 x 41 planes, the last with two; one row; W and Wo below a warp and below
# one 16-byte piece; a plane shorter than one band; the kernels' other
# windows.  ``leads``: the tensors start that many floats beyond a 16-byte
# boundary (x or yw, the cotangent); ``special`` puts NaN and +-inf into the
# inputs (a NaN window routes nothing, -inf can be a maximum) and into the
# cotangents.
@pytest.mark.parametrize("special", [False, True])
@pytest.mark.parametrize("h,w,k,s,p,tile,leads", [
    (321, 321, 3, 2, 1, None, (0, 0)), (161, 161, 3, 2, 1, None, (1, 3)), (41, 41, 3, 1, 1, None, (2, 1)),
    (41, 41, 3, 1, 1, 65536, (1, 2)), (37, 45, 3, 2, 1, 1024, (0, 0)), (38, 29, 3, 2, 1, 1024, (3, 2)),
    (41, 41, 3, 1, 1, 1024, (1, 1)),
    (1, 3, 3, 2, 1, None, (0, 0)), (1, 3, 3, 2, 1, None, (3, 1)), (2, 1, 3, 1, 1, None, (2, 3)),
    (5, 7, 3, 2, 1, 128, (1, 2)), (19, 70, 3, 1, 1, 1024, (0, 3)), (23, 31, 2, 2, 0, 1024, (2, 2)),
    (26, 33, 4, 3, 2, 1024, (3, 0)), (26, 33, 4, 3, 2, None, (0, 0)), (64, 300, 4, 1, 3, 4096, (1, 0))])
def test_pool_kernels_route_floats_in_tap_order(cuda, h, w, k, s, p, tile, leads, special):
    from dsrg_tpu_torch.ops import pool_kernels as pk
    from dsrg_tpu_torch.ops.pooling import _caffe_pool_geometry

    ho, _ = _caffe_pool_geometry(h, k, s, p)
    wo, _ = _caffe_pool_geometry(w, k, s, p)
    rng = np.random.default_rng(h * w + s + special)
    x = rng.integers(0, 3, (2, 3, h, w)).astype(np.float32)
    yw = rng.integers(0, 3, (2, 3, h, wo)).astype(np.float32)
    if special:
        for a in (x, yw):
            a[rng.random(a.shape) < 0.05] = np.nan
            a[rng.random(a.shape) < 0.1] = np.inf
            a[rng.random(a.shape) < 0.3] = -np.inf
    g = rng.normal(size=(2, 3, ho, wo)).astype(np.float32)
    gw = rng.normal(size=(2, 3, h, wo)).astype(np.float32)
    if special:
        for a in (g, gw):
            a[rng.random(a.shape) < 0.02] = np.nan
            a[rng.random(a.shape) < 0.02] = np.inf
            a[rng.random(a.shape) < 0.02] = -np.inf
    x, yw = _offset_view(x, leads[0], cuda), _offset_view(yw, leads[0], cuda)
    g, gw = _offset_view(g, leads[1], cuda), _offset_view(gw, leads[1], cuda)
    assert x.data_ptr() % 16 == 4 * leads[0] and gw.data_ptr() % 16 == 4 * leads[1]
    more = {} if tile is None else {"tile_bytes": tile}
    if tile is not None and tile < 8192 and h > 4:
        assert pk.plan_h(6, h, wo, ho, k, s, p, tile).tiles > 1 and pk.plan_w(6 * h, w, wo, tile).tiles > 1
    got_h, again_h = pk.pool_bwd_h(yw, g, k, s, p, **more), pk.pool_bwd_h(yw, g, k, s, p, **more)
    got_w, again_w = pk.pool_bwd_w(x, gw, k, s, p, **more), pk.pool_bwd_w(x, gw, k, s, p, **more)
    torch.cuda.synchronize()
    ref_h, ref_w = pk.pool_bwd_h_plain(yw, g, k, s, p), pk.pool_bwd_w_plain(x, gw, k, s, p)
    for got, again, ref in ((got_h, again_h, ref_h), (got_w, again_w, ref_w)):
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))
        if special:  # a routed NaN, or inf - inf where two windows meet, is NaN in both
            assert torch.allclose(got, ref, rtol=0.0, atol=0.0, equal_nan=True)
        else:
            assert torch.equal(got, ref)


def test_max_pool_train_cuda_matches_cpu(cuda):
    """The autograd pool on the card (kernels) and on the CPU (plain)."""
    from dsrg_tpu_torch.ops.pooling import caffe_max_pool_train

    rng = np.random.default_rng(1)
    x = torch.tensor(rng.integers(0, 3, (2, 5, 33, 31)), dtype=torch.float32)
    grads = []
    for dev in ("cpu", cuda):
        xd = x.to(dev, copy=True).requires_grad_(True)
        y = caffe_max_pool_train(xd, 3, 2, 1)
        y.backward(torch.arange(y.numel(), dtype=torch.float32, device=dev).reshape(y.shape) % 7)
        grads.append(xd.grad.cpu())
    assert torch.equal(grads[0], grads[1])


def test_mean_field_cuda_matches_cpu(cuda):
    """Two-colour images: on pixel-noise images a bf16 rounding flip of the
    grid slab (fp32 sums in another order) moves marginals by up to ~8e-3,
    between the JAX package and the port on the CPU as much as here."""
    rng = np.random.default_rng(0)
    image = np.zeros((2, 96, 88, 3), np.float32)
    image[:, :, :44] = [200, 60, 50]
    image[:, :, 44:] = [30, 180, 190]
    image = np.clip(image + rng.integers(-20, 20, image.shape), 0, 255).astype(np.float32)
    unary = np.log(rng.dirichlet(np.ones(5), size=(2, 96, 88))).astype(np.float32)
    mask = np.zeros((2, 96, 88), np.float32)
    mask[0, :96, :70] = 1.0
    mask[1, :50, :88] = 1.0
    args = [torch.from_numpy(a) for a in (unary, image, mask)]
    ref = tmm.mean_field_mmgrid(args[0], args[1], 10, valid_mask=args[2])
    got = tmm.mean_field_mmgrid(*(a.to(cuda) for a in args[:2]), 10,
                                valid_mask=args[2].to(cuda)).cpu()
    assert (got - ref).abs().max().item() <= 1e-4
    assert (got.argmax(-1) == ref.argmax(-1)).float().mean().item() == 1.0


def test_mmgrid_one_unmasked_image(cuda):
    """The pseudo ground truth's CRF: one 500x375 image, no mask (130 tiles
    of 1600 pixels, fewer blocks than the card's SMs).  The kernels against
    their plain versions on that plan, and the whole mean field on a smaller
    unmasked image, card against CPU."""
    rng = np.random.default_rng(3)
    guide = np.zeros((1, 375, 500, 3), np.uint8)
    guide[:, :, :250] = [200, 60, 50]
    guide[:, 100:300, 250:] = [30, 180, 190]
    guide = np.clip(guide + rng.integers(-12, 12, guide.shape), 0, 255).astype(np.uint8)
    plan = tmm.MMGridPlan(torch.from_numpy(guide).to(cuda), 80.0, 13.0)
    assert plan.idx.shape == (130, 1600) and plan.gc == 21
    sparse = (plan.idx, plan.wbg4, plan.wr2_bf16)
    for c in (21, 1):
        values = torch.from_numpy(rng.random((130, c, 1600), dtype=np.float32)).to(cuda)
        slab = torch.from_numpy(rng.standard_normal((130, 441, 21 * c), dtype=np.float32)).to(cuda).bfloat16()
        for kernel, plain, x, more in ((mk.splat, mk.splat_plain, values, (plan.perm,)),
                                      (mk.slice, mk.slice_plain, slab, ())):
            got, ref = kernel(*sparse, x, 21, *more), plain(*sparse, x, 21)
            assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()

    image = torch.from_numpy(guide[0, :130, 200:370].copy())
    unary = torch.log(torch.from_numpy(rng.dirichlet(np.ones(5), size=(130, 170)).astype(np.float32)))
    calls, launches = mk.dense_operands.calls, mk.splat.launches
    got = tmm.mean_field_mmgrid(unary.to(cuda), image.to(cuda), 10).cpu()
    assert mk.dense_operands.calls == calls and mk.splat.launches == launches + 11
    ref = tmm.mean_field_mmgrid(unary, image, 10)
    assert (got - ref).abs().max().item() <= 1e-4
    assert (got.argmax(-1) == ref.argmax(-1)).float().mean().item() == 1.0


def _small_predictors(cuda):
    from dsrg_tpu_torch.inference import Predictor
    from dsrg_tpu_torch.models import DeepLabLargeFOV
    from dsrg_tpu_torch.train.stage1 import init_params

    model = DeepLabLargeFOV(num_classes=6, head_dilations=(2, 4))
    init_params(model, 0)
    params = {k: v.clone() for k, v in model.state_dict().items()}
    return [Predictor(DeepLabLargeFOV(num_classes=6, head_dilations=(2, 4)), params, num_classes=6,
                      device=dev) for dev in (cuda, "cpu")]


@pytest.mark.parametrize("engine", ["auto", "mmgrid"])
def test_predict_mask_card_matches_cpu(cuda, engine):
    """``predict_mask`` with restricted labels on a 72x96 image: "auto" takes
    the exact engine there (6912 px), "mmgrid" the kernels."""
    on_card, on_cpu = _small_predictors(cuda)
    rng = np.random.default_rng(4)
    image = np.zeros((72, 96, 3), np.uint8)
    image[:, :48] = [200, 60, 50]
    image[20:60, 48:] = [30, 180, 190]
    image = np.clip(image + rng.integers(-10, 10, image.shape), 0, 255).astype(np.uint8)
    launches = mk.splat.launches
    for restrict in (None, [0, 2, 5]):
        a = on_card.predict_mask(image, sizes=[41, 57], restrict_labels=restrict, crf_engine=engine)
        b = on_cpu.predict_mask(image, sizes=[41, 57], restrict_labels=restrict, crf_engine=engine)
        assert a.shape == image.shape[:2] and a.dtype == np.uint8
        assert (a == b).mean() > 0.99
        if restrict is not None:
            assert set(np.unique(a)) <= set(restrict)
    assert mk.splat.launches - launches == (0 if engine == "auto" else 22)


def test_stage2_step_card_matches_cpu(cuda):
    """One tiny stage-2 step from the same weights on the card (pool
    kernels) and on the CPU (plain versions)."""
    from dsrg_tpu_torch.config import Stage2Config
    from dsrg_tpu_torch.models import DeepLabLargeFOV
    from dsrg_tpu_torch.ops import pool_kernels as pk
    from dsrg_tpu_torch.train.stage2 import init_stage2, make_stage2_step

    rng = np.random.default_rng(5)
    cfg = Stage2Config(num_classes=6, batch_size=2, crop_size=41, mirror=False)
    images = rng.integers(0, 256, (2, 41, 41, 3)).astype(np.uint8)
    labels = rng.integers(0, 6, (2, 41, 41)).astype(np.uint8)
    labels[:, 30:] = 255
    out = {}
    for dev in (cuda, "cpu"):
        model = DeepLabLargeFOV(num_classes=6, head_dilations=(2, 4), dropout_rate=0.0)
        state = init_stage2(model, cfg, device=dev)
        h0 = pk.pool_bwd_h.launches
        m = make_stage2_step(model, cfg, state.optimizer, state.generator)(
            {"images": images, "labels": labels})
        out[str(dev)] = {k: v.item() for k, v in m.items()}
        assert pk.pool_bwd_h.launches - h0 == (5 if dev == cuda else 0)
    for key, v in out["cpu"].items():
        assert abs(out["cuda"][key] - v) <= 1e-3 * abs(v), key


# the bf16 kernels at the tiles' edges: tile sizes that cut several bands and
# ragged last blocks (a tile of the same bytes holds twice as many bf16
# elements), storage offsets of 0..7 elements, NaN and +-inf; widths 1-9 and
# 15-17 around a run of 8 (the columns of the H pass's pairs, the W pass's
# run overhanging a row's end), at both strides; every lead 0..7 of both
# inputs at pool2's plane; tiles too small for a run's rows, whose bands end
# runs mid-run; the 41^2 s = 1 planes whole at stage 2's batch of 10 (x 32
# channels).  The cotangents hold -0 and subnormals besides normal values.
# Their bits are the plain versions', which round to bf16 after every add.
BF16_CASES = [
    (2, 321, 321, 3, 2, 1, None, (0, 0)), (2, 161, 161, 3, 2, 1, None, (5, 3)), (2, 41, 41, 3, 1, 1, None, (7, 1)),
    (2, 41, 41, 3, 1, 1, 65536, (1, 6)), (2, 37, 45, 3, 2, 1, 512, (0, 0)), (2, 38, 29, 3, 2, 1, 512, (3, 2)),
    (2, 41, 41, 3, 1, 1, 512, (1, 1)), (2, 1, 3, 3, 2, 1, None, (7, 1)), (2, 2, 1, 3, 1, 1, None, (2, 3)),
    (2, 19, 70, 3, 1, 1, 512, (4, 3)), (2, 23, 31, 2, 2, 0, 512, (2, 2)), (2, 26, 33, 4, 3, 2, 512, (3, 0)),
] + [(2, 13, w, 3, s, 1, None, (w % 8, (3 * w + 1) % 8)) for s in (1, 2) for w in (*range(1, 10), 15, 16, 17)] + [
    (2, 161, 161, 3, 2, 1, None, (lead, (3 * lead + 5) % 8)) for lead in range(8)] + [
    (2, 45, 21, 3, 2, 1, 256, (1, 4)), (2, 29, 17, 3, 1, 1, 256, (6, 3)), (10, 41, 41, 3, 1, 1, None, (0, 0))]


@pytest.mark.parametrize("special", [False, True])
@pytest.mark.parametrize("batch,h,w,k,s,p,tile,leads", BF16_CASES)
def test_pool_kernels_bf16_match_plain(cuda, batch, h, w, k, s, p, tile, leads, special):
    from dsrg_tpu_torch.ops import pool_kernels as pk
    from dsrg_tpu_torch.ops.pooling import _caffe_pool_geometry

    ho, _ = _caffe_pool_geometry(h, k, s, p)
    wo, _ = _caffe_pool_geometry(w, k, s, p)
    c = 32 if batch > 2 else 3
    rng = np.random.default_rng(h * w + s + special)
    x = rng.integers(0, 3, (batch, c, h, w)).astype(np.float32)
    yw = rng.integers(0, 3, (batch, c, h, wo)).astype(np.float32)
    g = rng.normal(size=(batch, c, ho, wo)).astype(np.float32)
    gw = rng.normal(size=(batch, c, h, wo)).astype(np.float32)
    for a in (g, gw):
        a[rng.random(a.shape) < 0.1] = -0.0
        tiny = rng.random(a.shape) < 0.1  # bf16 subnormals: multiples of 2^-133 below 2^-126
        a[tiny] = rng.integers(-127, 128, tiny.sum()) * np.float32(2.0 ** -133)
    if special:
        for a, shares in ((x, (0.05, 0.1, 0.3)), (yw, (0.05, 0.1, 0.3)), (g, (0.02,) * 3), (gw, (0.02,) * 3)):
            for value, share in zip((np.nan, np.inf, -np.inf), shares):
                a[rng.random(a.shape) < share] = value

    def offset_view(a, lead):
        flat = torch.zeros(a.size + lead, dtype=torch.bfloat16, device=cuda)
        flat[lead:] = torch.from_numpy(a.ravel()).to(cuda).bfloat16()
        return flat[lead:].view(a.shape)

    x, yw = offset_view(x, leads[0]), offset_view(yw, leads[0])
    g, gw = offset_view(g, leads[1]), offset_view(gw, leads[1])
    assert x.data_ptr() % 16 == 2 * leads[0] and gw.data_ptr() % 16 == 2 * leads[1]
    more = {} if tile is None else {"tile_bytes": tile}
    if tile is not None and tile < 8192 and h > 4:
        assert (pk.plan_h(batch * c, h, wo, ho, k, s, p, tile, 2).tiles > 1
                and pk.plan_w(batch * c * h, w, wo, tile, 2).tiles > 1)
    if tile == 256:  # bands shorter than a run
        assert pk.plan_h(batch * c, h, wo, ho, k, s, p, tile, 2).rows < pk.RUN
    counts = (pk.pool_bwd_h.launches, pk.pool_bwd_h.launches_bf16)
    got_h, got_w = pk.pool_bwd_h(yw, g, k, s, p, **more), pk.pool_bwd_w(x, gw, k, s, p, **more)
    torch.cuda.synchronize()
    assert (pk.pool_bwd_h.launches, pk.pool_bwd_h.launches_bf16) == (counts[0], counts[1] + 1)
    for got, ref in ((got_h, pk.pool_bwd_h_plain(yw, g, k, s, p)), (got_w, pk.pool_bwd_w_plain(x, gw, k, s, p))):
        assert got.dtype == torch.bfloat16
        if special:  # NaN payloads may differ
            assert torch.allclose(got.float(), ref.float(), rtol=0.0, atol=0.0, equal_nan=True)
            nan = torch.isnan(ref)
            assert torch.equal(got.view(torch.int16)[~nan], ref.view(torch.int16)[~nan])
        else:
            assert torch.equal(got.view(torch.int16), ref.view(torch.int16))


def test_stage1_bf16_step_card_matches_cpu(cuda):
    """One tiny bf16 stage-1 step with the bf16 CRF from the same weights on
    the card (bf16 pool kernels, bf16 GEMMs) and on the CPU (plain versions):
    bf16 rounds at other places there; on the CPU the bf16 step's metrics sit
    within 1e-3 of the fp32 step's, and the card is held to 1e-2."""
    from dsrg_tpu_torch.config import Stage1Config
    from dsrg_tpu_torch.models import DeepLabLargeFOV
    from dsrg_tpu_torch.ops import pool_kernels as pk
    from dsrg_tpu_torch.train.stage1 import init_stage1, make_stage1_step

    rng = np.random.default_rng(6)
    cfg = Stage1Config(num_classes=6, batch_size=2, crop_size=41, cue_size=6, crf_iters=2, mirror=False,
                       compute_dtype="bfloat16", crf_fast=True)
    labels = np.zeros((2, 6), np.float32)
    labels[:, 0] = labels[0, 2] = labels[1, 4] = 1.0
    batch = {"images": (rng.normal(size=(2, 41, 41, 3)) * 40).astype(np.float32), "labels": labels,
             "cues": (rng.uniform(size=(2, 6, 6, 6)) < 0.1).astype(np.float32) * labels[:, None, None, :]}
    out = {}
    for dev in (cuda, "cpu"):
        model = DeepLabLargeFOV(num_classes=6, head_dilations=(2, 4), dropout_rate=0.0,
                                compute_dtype=torch.bfloat16)
        state = init_stage1(model, cfg, device=dev)
        counts = (pk.pool_bwd_h.launches, pk.pool_bwd_h.launches_bf16)
        m = make_stage1_step(model, cfg, state.optimizer, state.generator)(batch)
        out[str(dev)] = {k: v.item() for k, v in m.items()}
        assert (pk.pool_bwd_h.launches, pk.pool_bwd_h.launches_bf16) == (
            counts[0], counts[1] + (5 if dev == cuda else 0))
    for key in ("loss", "loss_seed", "loss_constrain", "grad_norm"):
        # the constrain term is ~1e-3 of the loss: its bf16 noise is judged on the loss's scale
        scale = out["cpu"]["loss"] if key == "loss_constrain" else out["cpu"][key]
        assert abs(out["cuda"][key] - out["cpu"][key]) <= 1e-2 * abs(scale), key
    assert out["cuda"]["seed_pixels"] == out["cpu"]["seed_pixels"]


# ResNet-101's pool1 (3x3/2/1 over (B, 64, 161, 161) at a 321^2 crop) at the
# stage-1 batch, in both element types: integer inputs full of ties, normal
# cotangents (only the tap order gives the plain version's bits), and NaN /
# +-inf in inputs and cotangents
@pytest.mark.parametrize("special", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_kernels_at_resnet_pool1_match_plain(cuda, dtype, special):
    from dsrg_tpu_torch.ops import pool_kernels as pk
    from dsrg_tpu_torch.ops.pooling import _caffe_pool_geometry

    b, c, h = 20, 64, 161
    ho, _ = _caffe_pool_geometry(h, 3, 2, 1)
    gen = torch.Generator(device=cuda).manual_seed(int(special))
    x = torch.randint(0, 3, (b, c, h, h), generator=gen, device=cuda).to(dtype)
    yw = torch.randint(0, 3, (b, c, h, ho), generator=gen, device=cuda).to(dtype)
    g = torch.randn((b, c, ho, ho), generator=gen, device=cuda).to(dtype)
    gw = torch.randn((b, c, h, ho), generator=gen, device=cuda).to(dtype)
    for t in (g, gw):  # -0 and subnormals of the dtype among the cotangents
        t[torch.rand(t.shape, generator=gen, device=cuda) < 0.1] = -0.0
        tiny = torch.rand(t.shape, generator=gen, device=cuda) < 0.1
        t[tiny] = (torch.randint(-127, 128, t.shape, generator=gen, device=cuda).float()
                   * torch.finfo(dtype).smallest_normal / 128).to(dtype)[tiny]
    if special:
        for t, shares in ((x, (0.05, 0.1, 0.3)), (yw, (0.05, 0.1, 0.3)), (g, (0.02,) * 3), (gw, (0.02,) * 3)):
            for value, share in zip((float("nan"), float("inf"), float("-inf")), shares):
                t[torch.rand(t.shape, generator=gen, device=cuda) < share] = value
    got_h, got_w = pk.pool_bwd_h(yw, g, 3, 2, 1), pk.pool_bwd_w(x, gw, 3, 2, 1)
    torch.cuda.synchronize()
    for got, ref in ((got_h, pk.pool_bwd_h_plain(yw, g, 3, 2, 1)), (got_w, pk.pool_bwd_w_plain(x, gw, 3, 2, 1))):
        assert got.dtype == dtype
        if special:  # NaN payloads may differ
            assert torch.allclose(got.float(), ref.float(), rtol=0.0, atol=0.0, equal_nan=True)
            nan = torch.isnan(ref)
            assert torch.equal(got.float()[~nan].view(torch.int32), ref.float()[~nan].view(torch.int32))
        else:
            assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                               ref.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))


def test_resnet_stage1_step_card_matches_cpu(cuda):
    """One tiny ResNet stage-1 step (random BN statistics, the ResNet warm
    start's solver) from the same weights on the card (pool kernels, 1 + 1
    launches) and on the CPU (plain versions), to 1e-3."""
    from dsrg_tpu_torch.config import Stage1Config
    from dsrg_tpu_torch.models import ResNet101DeepLab
    from dsrg_tpu_torch.ops import pool_kernels as pk
    from dsrg_tpu_torch.train.stage1 import init_stage1, make_stage1_step

    rng = np.random.default_rng(7)
    cfg = Stage1Config(num_classes=6, batch_size=2, crop_size=41, cue_size=6, crf_iters=2, mirror=False,
                       base_lr=1e-4, clip_gradients=10.0)
    labels = np.zeros((2, 6), np.float32)
    labels[:, 0] = labels[0, 2] = labels[1, 4] = 1.0
    batch = {"images": (rng.normal(size=(2, 41, 41, 3)) * 40).astype(np.float32), "labels": labels,
             "cues": (rng.uniform(size=(2, 6, 6, 6)) < 0.1).astype(np.float32) * labels[:, None, None, :]}
    model = ResNet101DeepLab(num_classes=6, stage_blocks=(1, 1, 2, 1), head_dilations=(2, 4))
    stats = {k: torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
             for k, v in model.state_dict().items() if "running" in k}
    out = {}
    for dev in (cuda, "cpu"):
        model = ResNet101DeepLab(num_classes=6, stage_blocks=(1, 1, 2, 1), head_dilations=(2, 4))
        state = init_stage1(model, cfg, device=dev)
        model.load_state_dict({**model.state_dict(), **stats})
        h0, w0 = pk.pool_bwd_h.launches, pk.pool_bwd_w.launches
        m = make_stage1_step(model, cfg, state.optimizer, state.generator)(batch)
        out[str(dev)] = {k: v.item() for k, v in m.items()}
        assert (pk.pool_bwd_h.launches - h0, pk.pool_bwd_w.launches - w0) == ((1, 1) if dev == cuda else (0, 0))
    for key in ("loss", "loss_seed", "loss_constrain", "grad_norm"):
        assert abs(out["cuda"][key] - out["cpu"][key]) <= 1e-3 * abs(out["cpu"][key]), key
    assert out["cuda"]["seed_pixels"] == out["cpu"]["seed_pixels"]


def test_prefetch_loader_to_the_card_equals_cpu(cuda):
    """Batches copied on the loader's own stream (pinned memory, an event the
    consumer waits on) equal the CPU loader's, and a step-sized use right
    after the hand-over reads the copied values."""
    from dsrg_tpu_torch.data.loader import PrefetchLoader

    rng = np.random.default_rng(0)
    batches = [{"images": rng.normal(size=(4, 33, 33, 3)).astype(np.float32) * 40,
                "labels": rng.integers(0, 255, (4, 33, 33)).astype(np.uint8)} for _ in range(6)]
    on_cpu = list(PrefetchLoader(batches, device="cpu"))
    for in_worker in (True, False):
        on_card = list(PrefetchLoader(batches, device=cuda, device_in_worker=in_worker))
        assert len(on_card) == len(on_cpu) == 6
        for a, b in zip(on_card, on_cpu):
            assert a["images"].device.type == "cuda" and a["images"].dtype == torch.float16
            for k in a:
                assert torch.equal((a[k].float() * 2).cpu(), b[k].float() * 2), k


def test_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """A stage-1 state on the card: parameters, velocities, step and the
    card's generator come back bit for bit, and the random stream goes on
    as the saved one would."""
    from dsrg_tpu_torch.config import Stage1Config
    from dsrg_tpu_torch.models import DeepLabLargeFOV
    from dsrg_tpu_torch.train import checkpoint as ckpt
    from dsrg_tpu_torch.train.stage1 import init_stage1

    def make(seed):
        state = init_stage1(DeepLabLargeFOV(num_classes=6, head_dilations=(2,)), Stage1Config(seed=seed),
                            device=cuda)
        for v in state.optimizer.velocity.values():
            v.normal_(generator=torch.Generator(device=cuda).manual_seed(seed))
        state.optimizer.step_count = 10 + seed
        torch.rand(100, generator=state.generator, device=cuda)
        return state

    saved = make(0)
    writer = ckpt.AsyncCheckpointWriter()
    path = writer.save(str(tmp_path), saved, saved.step)
    want = ({k: v.clone() for k, v in saved.model.state_dict().items()},
            {k: v.clone() for k, v in saved.optimizer.velocity.items()})
    with torch.no_grad():
        for p in saved.model.parameters():
            p.mul_(3.0)  # in place after save(): the snapshot keeps the values at save()
    writer.close()
    restored = ckpt.restore_checkpoint(path, make(1))
    assert restored.step == 10
    for k, v in restored.model.state_dict().items():
        assert v.device.type == "cuda" and torch.equal(v, want[0][k]), k
    for k, v in restored.optimizer.velocity.items():
        assert torch.equal(v, want[1][k]), k
    assert torch.equal(restored.generator.get_state(), saved.generator.get_state())
    assert torch.equal(torch.rand(8, generator=restored.generator, device=cuda),
                       torch.rand(8, generator=saved.generator, device=cuda))


def test_train_cli_with_cuda_hidden_raises(cuda, tmp_path):
    """``--device cuda`` (the default) where no card is visible: the CLI
    stops at ``resolve_device`` with its message, before any work."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, "-m", "dsrg_tpu_torch.tools.train", "--stage", "s",
                           "--snapshot-dir", str(tmp_path / "m")], cwd=root, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert not (tmp_path / "m").exists()


def test_pipeline_artifact_on_the_card_matches_eager(cuda, tmp_path):
    """An exported pipeline (canvas 64x64, batch 2, sizes (41,), CRF on) on
    the card: masks against the eager ``predict_masks_device`` on the same
    canvas, and the custom ops' counters count the artifact's 11 + 11
    kernel launches per chunk."""
    from dsrg_tpu_torch import serving

    on_card, _ = _small_predictors(cuda)
    rng = np.random.default_rng(6)
    images = []
    for h, w in ((40, 52), (45, 48), (50, 44)):
        img = np.zeros((h, w, 3), np.uint8)
        img[:, : w // 2] = [200, 60, 50]
        img[:, w // 2:] = [30, 180, 190]
        images.append(np.clip(img + rng.integers(-8, 8, img.shape), 0, 255).astype(np.uint8))
    path = serving.export_pipeline(on_card.model, str(tmp_path / "pipe.pt2"), canvas_hw=(64, 64), batch=2,
                                   sizes=(41,), num_classes=6)
    served = serving.ServingPipeline(path)
    assert served.device.type == "cuda"
    launches = (mk.splat.launches, mk.slice.launches)
    got = served(images)  # two chunks
    assert (mk.splat.launches - launches[0], mk.slice.launches - launches[1]) == (22, 22)
    want = on_card.predict_masks_device(images, sizes=[41], canvas_bucket=64)
    for g, w in zip(got, want):
        assert g.shape == w.shape and (g == w).mean() >= 0.999


def test_deploy_artifact_on_the_card_matches_eager(cuda, tmp_path):
    from dsrg_tpu_torch import serving
    from dsrg_tpu_torch.ops.softmax import floored_softmax

    on_card, _ = _small_predictors(cuda)
    x = np.random.default_rng(7).normal(size=(2, 41, 41, 3)).astype(np.float32) * 40
    served = serving.ServingModel(serving.export_deploy(on_card.model, str(tmp_path / "d.pt2"),
                                                        input_shape=(2, 41, 41, 3)))
    with torch.no_grad():
        ref = floored_softmax(on_card.model(torch.from_numpy(x).to(cuda))).cpu().numpy()
    np.testing.assert_allclose(served(x), ref, rtol=1e-4, atol=1e-6)


def test_dense_crf_card_matches_cpu(cuda):
    """The object API with Gaussian and bilateral terms (all four
    normalisations), card against CPU, on a two-colour image with
    probabilities that favour one class per region.  On i.i.d. inputs the
    next test holds the card to a float64 reference instead."""
    from dsrg_tpu_torch.ops.crf.api import DenseCRF, PottsCompatibility

    image, probs = _crf_f64.coherent_case(8)
    for ntype in _crf_f64.NTYPES:
        out = [_crf_f64.set_up(DenseCRF(_crf_f64.W, _crf_f64.H, _crf_f64.M, device=dev), PottsCompatibility,
                               image, probs, ntype).inference(10) for dev in (cuda, "cpu")]
        assert np.abs(out[0] - out[1]).max() <= 1e-4


@pytest.mark.parametrize("seed", _crf_f64.IID_SEEDS)
def test_dense_crf_card_on_iid_inputs_near_float64(cuda, seed):
    """A pixel-noise image with i.i.d. probabilities: fp32 rounding decides
    near-ties, and the JAX package and the port on the CPU already sit up
    to ~1e-3 from a float64 reference
    (``test_torch_port_crf_f64.py``).
    The card's marginals stay within the same ``IID_TOL`` of it in every
    mode."""
    from dsrg_tpu_torch.ops.crf.api import DenseCRF, PottsCompatibility

    image, probs = _crf_f64.iid_case(seed)
    for ntype in _crf_f64.NTYPES:
        ref = _crf_f64.mean_field_f64(image, probs, ntype)
        q = _crf_f64.set_up(DenseCRF(_crf_f64.W, _crf_f64.H, _crf_f64.M, device=cuda), PottsCompatibility,
                            image, probs, ntype).inference(10)
        assert np.abs(q.reshape(ref.shape) - ref).max() <= _crf_f64.IID_TOL, ntype
