"""The separable Caffe max pool's backward: CUDA kernels and their plain versions.

``pool_bwd_h`` replaces ``dsrg_tpu/ops/pallas_pool.py::pool_bwd_h`` and
``pool_bwd_w`` replaces ``pool_bwd_w``.  Their CUDA sources are
``csrc/pool_bwd_h.cu`` and ``csrc/pool_bwd_w.cu`` (with ``csrc/pool_route.cuh``);
each says what bounds it on the H100 and what its design does about it.  Both
route one 1-D max-pool pass's cotangent back to its input with first-max
routing (``_route_1d``, ``pallas_pool.py:91-149``):

    gx[j] = sum_t [(j+p-t) % s == 0, window o = (j+p-t)/s valid]
                  * [x[j] == max of window o]
                  * [no earlier tap of window o equals that max] * g[o]

with the taps summed in the order t = 0..k-1, each sum rounded to the
cotangent's dtype (float32 or bfloat16, as JAX's ``acc + term`` rounds).
Tensors are NCHW: the H pass routes along dim 2 against the W-pooled
``yw``, the W pass along dim 3 against the raw input.

A kernel's block owns a tile that the routing never leaves and that is one
contiguous span of each tensor: whole rows in the W pass, a band of rows of
one plane with its halo in the H pass.  It stages the spans in shared memory.
In float32 (C entry points ``pool_bwd_h`` / ``pool_bwd_w``) the block finds
every window's first maximum once, one tap byte per window, and then gathers
per element.  In bfloat16 (``pool_bwd_h_bf16`` / ``pool_bwd_w_bf16``,
``csrc/pool_runs.cuh``) a thread owns a run of :data:`RUN` positions along
the routing axis of two lines at once, computes the run's windows in packed
bfloat16 registers and writes the routed tile to shared memory laid out as
the output, which leaves in 16-byte stores; its tiles hold the routed output
instead of tap bytes, and the H pass's bands are multiples of :data:`RUN`
rows.  The tiles are planned here (:func:`plan_h`, :func:`plan_w`) and handed
to the kernels as integers, so that the geometry can be tested without a
card.

A wrapper runs the plain PyTorch version only for tensors on the CPU; a CUDA
tensor launches the kernel of its dtype, and anything else raises.
``pool_bwd_h.launches`` / ``pool_bwd_w.launches`` count float32 kernel
launches, ``.launches_bf16`` bfloat16 ones.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from dsrg_tpu_torch._build import launch
from dsrg_tpu_torch._device import kernel_device

# the element types the kernels take, with the suffix of their C entry points
ENTRY_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16"}
KMAX = 4  # the kernels' largest window (csrc/pool_route.cuh); the plain versions take any
SMEM_MAX = 232448  # bytes of shared memory a block may use on sm_90 (227 KB)
# Shared memory a float32 tile aims for.  Six such blocks of 256 threads are
# resident on an SM (227 KB), and the loads of some run under the stores of
# others.  The bfloat16 blocks hold their routed output too; their sizes
# were chosen by timing 16-96 KB tiles at the stage-1 step's pools on an H100
# (PERF.md), and the W pass needs 56 KB for W_ROWS rows of 321.
# ``chip_smoke.py`` phase 4 times pool1 and pool4 at half and at twice the
# default of each element type as well.
TILE_BYTES = 32 * 1024
TILE_BYTES_BF16 = {"pool_bwd_h": 48 * 1024, "pool_bwd_w": 56 * 1024}
# Copies of the bfloat16 blocks' run geometry, which the CPU tests hold equal to
# the sources': positions of a thread's run along the routing axis
# (``RUN``, csrc/pool_runs.cuh), and the multiple of rows that a W block holds,
# so that its warps meet no shared-memory bank twice (``W_ROWS``,
# csrc/pool_bwd_w.cu, which gives the reason).
RUN = 8
W_ROWS = 32


class TilePlan(NamedTuple):
    """How a pass is cut into blocks, and a block's shared memory: the span of
    the pass input at element 0, of the cotangent at element ``off_g``, then
    in float32 one byte per window at element ``off_tap``, in bfloat16 the
    span of the routed output at element ``off_out``; ``smem`` bytes in all."""

    rows: int  # output rows per block: of a plane's band (H), of the flat row axis (W)
    tiles: int  # bands per plane (H), blocks in all (W)
    off_g: int
    off_tap: int  # float32; 0 in bfloat16
    smem: int
    planes: int = 1  # H: whole planes per block where several fit (then one band)
    off_out: int = 0  # bfloat16; 0 in float32


def span_room(n: int, elem: int = 4) -> int:
    """Elements of shared memory for a span of ``n`` elements of ``elem``
    bytes that starts up to 16 / elem - 1 elements beyond a 16-byte
    boundary: a multiple of 16 / elem."""
    vec = 16 // elem
    return (n + 2 * (vec - 1)) // vec * vec


def _layout(rows: int, tiles: int, n_in: int, n_win: int, elem: int = 4, n_out: int = 0) -> TilePlan:
    """The three spans of a block's shared memory: the pass input, the
    cotangent, then the tap bytes (``elem`` 4) or the ``n_out`` routed
    elements (``elem`` 2)."""
    off_g = span_room(n_in, elem)
    off_3 = off_g + span_room(n_win, elem)
    if elem == 2:
        return TilePlan(rows, tiles, off_g, 0, elem * (off_3 + span_room(n_out, elem)), off_out=off_3)
    return TilePlan(rows, tiles, off_g, off_3, elem * off_3 + (n_win + 15) // 16 * 16)


def h_band(b: int, jb: int, h: int, ho: int, k: int, s: int, p: int):
    """Band ``b`` of ``jb`` rows of a plane of ``h``: its rows [j0, j1), the
    rows [y_lo, y_hi) of the pass input that their windows read and the
    windows [o_lo, o_hi) that reach them (``band_of`` in csrc/pool_bwd_h.cu)."""
    j0, j1 = b * jb, min(b * jb + jb, h)
    y_lo, y_hi = max(j0 - (k - 1), 0), min(j1 + (k - 1), h)
    o_lo = -(-max(j0 + p - (k - 1), 0) // s)
    o_hi = max(min((j1 - 1 + p) // s + 1, ho), o_lo)
    return j0, j1, y_lo, y_hi, o_lo, o_hi


def _plan_h_bands(jb: int, h: int, wo: int, ho: int, k: int, s: int, p: int, elem: int = 4) -> TilePlan:
    n_bands = -(-h // jb)
    bands = [h_band(b, jb, h, ho, k, s, p) for b in range(n_bands)]
    return _layout(jb, n_bands, max(y_hi - y_lo for _, _, y_lo, y_hi, _, _ in bands) * wo,
                   max(o_hi - o_lo for *_, o_lo, o_hi in bands) * wo, elem,
                   max(j1 - j0 for j0, j1, *_ in bands) * wo)


@functools.lru_cache(maxsize=256)
def plan_h(n: int, h: int, wo: int, ho: int, k: int, s: int, p: int,
           tile_bytes: int = TILE_BYTES, elem: int = 4) -> TilePlan:
    """Tiles of the H pass over ``n`` planes (h, wo) -> (ho, wo) of
    ``elem``-byte elements: the fewest bands whose shared memory stays
    within ``tile_bytes``, of equal height but for the last (a band of one
    row where even that is larger; in bfloat16 a multiple of :data:`RUN`
    rows where one fits, so that the runs of a band are whole); where a
    whole plane fits, as many planes as fit (their rows are one span as long
    as every window reaches into its plane, as Caffe's do)."""
    def fits(j):
        return _plan_h_bands(j, h, wo, ho, k, s, p, elem).smem <= tile_bytes

    step = RUN if elem == 2 and fits(min(RUN, h)) else 1
    jb = next((j for j in range(-(-h // step) * step, step, -step) if fits(j)), step)
    jb = -(-h // -(-h // jb))  # the same bands, of equal height
    plan = _plan_h_bands(-(-jb // step) * step, h, wo, ho, k, s, p, elem)
    if plan.smem > SMEM_MAX:
        raise ValueError(f"pool_bwd_h: one row of {wo} elements with its windows needs {plan.smem} "
                         f"bytes of shared memory, over the card's {SMEM_MAX}")
    if plan.tiles == 1 and h_band(0, h, h, ho, k, s, p)[4:] == (0, ho):
        def whole(pb):
            return _layout(h, 1, pb * h * wo, pb * ho * wo, elem, pb * h * wo)._replace(planes=pb)

        pb = 1
        while pb < n and whole(pb + 1).smem <= tile_bytes:
            pb += 1
        plan = whole(pb)
    return plan


@functools.lru_cache(maxsize=256)
def plan_w(rows: int, w: int, wo: int, tile_bytes: int = TILE_BYTES, elem: int = 4) -> TilePlan:
    """Blocks of whole rows of the W pass over ``rows`` rows w -> wo of
    ``elem``-byte elements: as many rows as stay within ``tile_bytes``, at
    least one; in bfloat16 a multiple of :data:`W_ROWS` rows where that many
    fit (16 row pairs: the block's warps then meet no bank twice)."""
    per_row = 2 * elem * w + elem * wo if elem == 2 else elem * w + (elem + 1) * wo
    rb = max(min(tile_bytes // per_row, rows), 1)
    while rb > 1 and _layout(rb, 0, rb * w, rb * wo, elem, rb * w).smem > tile_bytes:
        rb -= 1
    if elem == 2 and W_ROWS <= rb < rows:
        rb -= rb % W_ROWS
    plan = _layout(rb, -(-rows // rb), rb * w, rb * wo, elem, rb * w)
    if plan.smem > SMEM_MAX:
        raise ValueError(f"pool_bwd_w: one row of {w} elements with its windows needs {plan.smem} "
                         f"bytes of shared memory, over the card's {SMEM_MAX}")
    return plan


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


def default_tile_bytes(kernel: str, dtype: torch.dtype) -> int:
    """The shared memory a block of ``kernel`` ("pool_bwd_h" or "pool_bwd_w")
    aims for in ``dtype``."""
    return TILE_BYTES_BF16[kernel] if dtype == torch.bfloat16 else TILE_BYTES


def _check(name: str, x: torch.Tensor, shape, device, dtype) -> None:
    if dtype not in ENTRY_SUFFIX:
        raise TypeError(f"the pool kernels take {' or '.join(map(str, ENTRY_SUFFIX))}, got {dtype}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")


def _check_geometry(k: int, s: int, p: int, on_card: bool) -> None:
    if k < 1 or s < 1 or not 0 <= p < k:
        raise ValueError(f"pool geometry k={k} s={s} p={p}: need k, s >= 1 and 0 <= p < k")
    if on_card and k > KMAX:
        raise ValueError(f"the pool kernels take windows up to {KMAX}, got k={k}")


def pool_bwd_h(yw: torch.Tensor, g: torch.Tensor, k: int, s: int, p: int,
               tile_bytes: int | None = None) -> torch.Tensor:
    """Route ``g`` along H against ``yw``; see :func:`pool_bwd_h_plain`.
    ``tile_bytes``: the shared memory a block of the kernel aims for (by
    default :func:`default_tile_bytes`)."""
    b, c, h, wo = yw.shape
    ho = g.shape[2]
    _check("yw", yw, (b, c, h, wo), yw.device, g.dtype)
    _check("g", g, (b, c, ho, wo), yw.device, g.dtype)
    on_card = kernel_device(yw, "pool kernels")
    _check_geometry(k, s, p, on_card)
    if not on_card:
        return pool_bwd_h_plain(yw, g, k, s, p)
    out = torch.empty((b, c, h, wo), dtype=g.dtype, device=yw.device)
    plan = plan_h(b * c, h, wo, ho, k, s, p, tile_bytes or default_tile_bytes("pool_bwd_h", g.dtype),
                  g.element_size())
    launch("pool_bwd_h", out, ((yw.contiguous(), g.contiguous()),
                               (b * c, h, wo, ho, k, s, p, plan.rows, plan.planes, plan.off_g,
                                plan.off_out or plan.off_tap, plan.smem)), "pool_bwd_h" + ENTRY_SUFFIX[g.dtype])
    if g.dtype == torch.bfloat16:
        pool_bwd_h.launches_bf16 += 1
    else:
        pool_bwd_h.launches += 1
    return out


def pool_bwd_w(x: torch.Tensor, gw: torch.Tensor, k: int, s: int, p: int,
               tile_bytes: int | None = None) -> torch.Tensor:
    """Route ``gw`` along W against ``x``; see :func:`pool_bwd_w_plain`.
    ``tile_bytes``: the shared memory a block of the kernel aims for (by
    default :func:`default_tile_bytes`)."""
    b, c, h, w = x.shape
    wo = gw.shape[3]
    _check("x", x, (b, c, h, w), x.device, gw.dtype)
    _check("gw", gw, (b, c, h, wo), x.device, gw.dtype)
    on_card = kernel_device(x, "pool kernels")
    _check_geometry(k, s, p, on_card)
    if not on_card:
        return pool_bwd_w_plain(x, gw, k, s, p)
    out = torch.empty((b, c, h, w), dtype=gw.dtype, device=x.device)
    plan = plan_w(b * c * h, w, wo, tile_bytes or default_tile_bytes("pool_bwd_w", gw.dtype), gw.element_size())
    launch("pool_bwd_w", out, ((x.contiguous(), gw.contiguous()),
                               (b * c * h, w, wo, k, s, p, plan.rows, plan.off_g, plan.off_out or plan.off_tap,
                                plan.smem)),
           "pool_bwd_w" + ENTRY_SUFFIX[gw.dtype])
    if gw.dtype == torch.bfloat16:
        pool_bwd_w.launches_bf16 += 1
    else:
        pool_bwd_w.launches += 1
    return out


pool_bwd_h.launches = pool_bwd_h.launches_bf16 = 0
pool_bwd_w.launches = pool_bwd_w.launches_bf16 = 0
KERNELS = ("pool_bwd_h", "pool_bwd_w")
