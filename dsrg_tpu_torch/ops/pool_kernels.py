"""The separable Caffe max pool's backward: CUDA kernels and their plain versions.

``pool_bwd_h`` replaces ``dsrg_tpu/ops/pallas_pool.py::pool_bwd_h`` and
``pool_bwd_w`` replaces ``pool_bwd_w``.  Their CUDA sources are
``csrc/pool_bwd_h.cu`` and ``csrc/pool_bwd_w.cu``; each says what bounds it
on the H100 and what its design does about it.  Both route one 1-D max-pool
pass's cotangent back to its input with first-max routing
(``_route_1d``, ``pallas_pool.py:91-149``):

    gx[j] = sum_t [(j+p-t) % s == 0, window o = (j+p-t)/s valid]
                  * [x[j] == max of window o]
                  * [no earlier tap of window o equals that max] * g[o]

with the taps summed in the order t = 0..k-1.  Tensors are NCHW: the H pass
routes along dim 2 against the W-pooled ``yw``, the W pass along dim 3
against the raw input.

A wrapper runs the plain PyTorch version only for tensors on the CPU; a CUDA
tensor launches the kernel, and anything else raises.
``pool_bwd_h.launches`` / ``pool_bwd_w.launches`` count kernel launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dsrg_tpu_torch._build import launch
from dsrg_tpu_torch._device import kernel_device

_F32 = torch.float32
KMAX = 4  # the kernels' largest window (csrc/pool_bwd_*.cu); the plain versions take any


def _route_last(x: torch.Tensor, g: torch.Tensor, k: int, s: int, p: int) -> torch.Tensor:
    """First-max routing along the last axis: x (..., L), g (..., O) -> (..., L)."""
    length, o_len = x.shape[-1], g.shape[-1]
    j = torch.arange(length, device=x.device)
    xp = F.pad(x, (k - 1, k - 1), value=float("-inf"))

    def at(d: int):
        """(x[j + d], j + d inside [0, L)); outside, x reads -inf."""
        return xp[..., k - 1 + d: k - 1 + d + length], (j + d >= 0) & (j + d < length)

    acc = torch.zeros(x.shape, dtype=g.dtype, device=x.device)
    for t in range(k):
        o_scaled = j + p - t
        sel = (o_scaled >= 0) & (o_scaled <= (o_len - 1) * s) & (o_scaled % s == 0)
        wm = at(-t)[0]
        for u in range(1, k):
            wm = torch.maximum(wm, at(u - t)[0])
        hit = sel & (x == wm)
        for tp in range(t):  # tap tp of the same window sits t - tp positions earlier
            xe, inside = at(tp - t)
            hit = hit & ~(inside & (xe == wm))
        o = torch.clamp(torch.div(o_scaled, s, rounding_mode="floor"), 0, o_len - 1)
        acc = acc + torch.where(hit, g.index_select(-1, o), torch.zeros((), dtype=g.dtype))
    return acc


def pool_bwd_h_plain(yw: torch.Tensor, g: torch.Tensor, k: int, s: int, p: int) -> torch.Tensor:
    """(B, C, H, Wo) W-pooled input, (B, C, Ho, Wo) cotangent -> (B, C, H, Wo)."""
    return _route_last(yw.transpose(2, 3), g.transpose(2, 3), k, s, p).transpose(2, 3)


def pool_bwd_w_plain(x: torch.Tensor, gw: torch.Tensor, k: int, s: int, p: int) -> torch.Tensor:
    """(B, C, H, W) raw input, (B, C, H, Wo) cotangent -> (B, C, H, W)."""
    return _route_last(x, gw, k, s, p)


def _check(name: str, x: torch.Tensor, shape, device) -> None:
    if x.dtype != _F32:
        raise TypeError(f"{name}: expected {_F32}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")


def _check_geometry(k: int, s: int, p: int, on_card: bool) -> None:
    if k < 1 or s < 1 or not 0 <= p < k:
        raise ValueError(f"pool geometry k={k} s={s} p={p}: need k, s >= 1 and 0 <= p < k")
    if on_card and k > KMAX:
        raise ValueError(f"the pool kernels take windows up to {KMAX}, got k={k}")


def pool_bwd_h(yw: torch.Tensor, g: torch.Tensor, k: int, s: int, p: int) -> torch.Tensor:
    """Route ``g`` along H against ``yw``; see :func:`pool_bwd_h_plain`."""
    b, c, h, wo = yw.shape
    ho = g.shape[2]
    _check("yw", yw, (b, c, h, wo), yw.device)
    _check("g", g, (b, c, ho, wo), yw.device)
    on_card = kernel_device(yw, "pool kernels")
    _check_geometry(k, s, p, on_card)
    if not on_card:
        return pool_bwd_h_plain(yw, g, k, s, p)
    out = torch.empty((b, c, h, wo), dtype=_F32, device=yw.device)
    launch("pool_bwd_h", out, ((yw.contiguous(), g.contiguous()), (b * c, h, wo, ho, k, s, p)))
    pool_bwd_h.launches += 1
    return out


def pool_bwd_w(x: torch.Tensor, gw: torch.Tensor, k: int, s: int, p: int) -> torch.Tensor:
    """Route ``gw`` along W against ``x``; see :func:`pool_bwd_w_plain`."""
    b, c, h, w = x.shape
    wo = gw.shape[3]
    _check("x", x, (b, c, h, w), x.device)
    _check("gw", gw, (b, c, h, wo), x.device)
    on_card = kernel_device(x, "pool kernels")
    _check_geometry(k, s, p, on_card)
    if not on_card:
        return pool_bwd_w_plain(x, gw, k, s, p)
    out = torch.empty((b, c, h, w), dtype=_F32, device=x.device)
    launch("pool_bwd_w", out, ((x.contiguous(), gw.contiguous()), (b * c * h, w, wo, k, s, p)))
    pool_bwd_w.launches += 1
    return out


pool_bwd_h.launches = 0
pool_bwd_w.launches = 0
KERNELS = ("pool_bwd_h", "pool_bwd_w")
