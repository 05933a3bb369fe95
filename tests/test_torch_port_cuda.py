"""The port's CUDA kernels held against their plain versions on the card.

These need an NVIDIA card and nvcc, and skip elsewhere.  They import
nothing of JAX, so on a machine without it they run with
``python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py``.
"""

import numpy as np
import pytest
import torch

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


def _inputs(seed, t, px, gc, c, dev):
    rng = np.random.default_rng(seed)
    wbg = rng.random((t, px, gc * gc)) * (rng.random((t, px, gc * gc)) < 0.2)
    tens = [torch.tensor(a, dtype=torch.float32, device=dev) for a in (
        wbg, rng.normal(size=(t, c, px)), rng.random((t, gc, px)),
        rng.normal(size=(t, gc * gc, gc * c)))]
    wbg, values, wr, slab = tens
    return wbg.bfloat16(), values, wr.bfloat16(), slab.bfloat16()


# odd shapes: px not a multiple of 32, B and Q not multiples of 64, and a C
# large enough that the slice needs more than 48 KB of shared memory
@pytest.mark.parametrize("t,px,gc,c", [(3, 1600, 21, 21), (5, 1600, 21, 1), (2, 77, 7, 3),
                                       (1, 256, 5, 81)])
def test_kernels_match_plain(cuda, t, px, gc, c):
    wbg, values, wr, slab = _inputs(t * px + c, t, px, gc, c, cuda)
    s0, l0 = mk.splat.launches, mk.slice.launches
    got = mk.splat(wbg, values, wr)
    ref = mk.splat_plain(wbg, values, wr)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    got = mk.slice(wbg, slab, wr)
    ref = mk.slice_plain(wbg, slab, wr)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    assert (mk.splat.launches, mk.slice.launches) == (s0 + 1, l0 + 1)


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
