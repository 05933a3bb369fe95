"""The tile geometry of the port's pool backward kernels, held on the CPU.

``plan_h`` / ``plan_w`` (``dsrg_tpu_torch/ops/pool_kernels.py``) cut a pass
into the tiles that the CUDA kernels' blocks own.  The kernels themselves run
only on the card (``tests/test_torch_port_cuda.py``); here the plans are
checked for what the kernels rely on, at both element sizes (float32, 4
bytes; bfloat16, 2), a numpy walk over the tiles that does what a float32
block does (stage the spans, one first-max tap per window, gather per
element) is held bit for bit against the plain versions, and so is a walk
that does what a bfloat16 block does (runs of ``RUN`` positions along the
routing axis, each run's windows once, a bfloat16 round after every add).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from dsrg_tpu_torch.ops import pool_kernels as pk
from dsrg_tpu_torch.ops.pooling import _caffe_pool_geometry

# (h, w, k, s, p): the five max pools of the stage-1 step at 321^2, then
# ragged ones: sizes below a warp and below a 16-byte piece, one row, an even
# size at s = 2, the kernels' other windows, and a row too long for the
# default tile
POOLS = [(321, 321, 3, 2, 1), (161, 161, 3, 2, 1), (81, 81, 3, 2, 1), (41, 41, 3, 1, 1),
         (41, 41, 3, 1, 1)]
RAGGED = [(37, 45, 3, 2, 1), (38, 29, 3, 2, 1), (1, 3, 3, 2, 1), (2, 1, 3, 1, 1), (19, 70, 3, 1, 1),
          (23, 31, 2, 2, 0), (26, 33, 4, 3, 2), (7, 5000, 3, 2, 1), (700, 9, 3, 2, 1)]
SMALL_TILE = 1024  # bytes: forces several bands and blocks on small inputs


def _out(size, k, s, p):
    return _caffe_pool_geometry(size, k, s, p)[0]


def _check_layout(plan, n_in, n_win, tile_bytes, smallest, elem, n_out=0):
    """The three buffers of a block's shared memory: 16-byte aligned, room
    for a span that starts 0..vec-1 elements beyond a 16-byte boundary (vec
    = 16 / elem elements per piece), in order, within the plan's bytes;
    within ``tile_bytes`` unless the tile is already the smallest there is,
    and always within what the card allows.  The third buffer holds one byte
    per window in float32 and the ``n_out`` routed elements in bfloat16."""
    vec = 16 // elem
    third = plan.off_out if elem == 2 else plan.off_tap
    assert (plan.off_tap, plan.off_out)[elem == 4] == 0  # the other layout's offset is unused
    assert plan.off_g % vec == 0 and third % vec == 0 and plan.smem % 16 == 0
    for lead in range(vec):
        assert vec * -(-(lead + n_in) // vec) <= plan.off_g
        assert plan.off_g + vec * -(-(lead + n_win) // vec) <= third
        if elem == 2:
            assert elem * (third + vec * -(-(lead + n_out) // vec)) <= plan.smem
    assert elem * third + (n_win if elem == 4 else n_out) <= plan.smem <= pk.SMEM_MAX
    assert plan.smem <= tile_bytes or smallest


N_PLANES = 7  # not a multiple of the planes per block wherever a block takes several


@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("tile_bytes", [pk.TILE_BYTES, SMALL_TILE, *pk.TILE_BYTES_BF16.values()])
@pytest.mark.parametrize("h,w,k,s,p", POOLS[:4] + RAGGED)
def test_plan_h_covers_each_row_once(h, w, k, s, p, tile_bytes, elem):
    ho, wo = _out(h, k, s, p), _out(w, k, s, p)
    plan = pk.plan_h(N_PLANES, h, wo, ho, k, s, p, tile_bytes, elem)
    assert plan.tiles == -(-h // plan.rows) and 1 <= plan.planes <= N_PLANES
    covered = np.zeros(h, int)
    n_in = n_win = n_out = 0
    for b in range(plan.tiles):
        j0, j1, y_lo, y_hi, o_lo, o_hi = pk.h_band(b, plan.rows, h, ho, k, s, p)
        covered[j0:j1] += 1
        assert 0 <= y_lo <= j0 < j1 <= y_hi <= h and 0 <= o_lo <= o_hi <= ho
        # exactly the windows that hold a row of the band, and all their rows inside the plane
        touching = [o for o in range(ho) if o * s - p < j1 and o * s - p + k > j0]
        assert touching == list(range(o_lo, o_hi))
        for o in touching:
            assert y_lo <= max(o * s - p, 0) and min(o * s - p + k, h) <= y_hi
        if plan.planes > 1:  # whole planes, so that the planes of a block are one span of each tensor
            assert (plan.tiles, y_lo, y_hi, o_lo, o_hi) == (1, 0, h, 0, ho)
        n_in = max(n_in, ((plan.planes - 1) * h + y_hi - y_lo) * wo)
        n_win = max(n_win, ((plan.planes - 1) * ho + o_hi - o_lo) * wo)
        n_out = max(n_out, ((plan.planes - 1) * h + j1 - j0) * wo)
    assert (covered == 1).all()
    _check_layout(plan, n_in, n_win, tile_bytes, plan.rows == 1, elem, n_out)
    # bfloat16 bands are whole runs where a run's rows fit: a multiple of RUN rows, or the whole plane
    step = pk.RUN if elem == 2 and pk._plan_h_bands(min(pk.RUN, h), h, wo, ho, k, s, p, elem).smem <= tile_bytes else 1
    assert plan.rows % step == 0 or plan.tiles == 1
    if plan.tiles > 1:  # the fewest bands: one fewer would not fit
        fewer = -(-h // (plan.tiles - 1) // step) * step
        assert pk._plan_h_bands(fewer, h, wo, ho, k, s, p, elem).smem > tile_bytes
    elif plan.planes < N_PLANES and pk.h_band(0, h, h, ho, k, s, p)[4:] == (0, ho):  # as many planes as fit
        more = plan.planes + 1
        assert pk._layout(h, 1, more * h * wo, more * ho * wo, elem, more * h * wo).smem > tile_bytes


@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("tile_bytes", [pk.TILE_BYTES, SMALL_TILE, *pk.TILE_BYTES_BF16.values()])
@pytest.mark.parametrize("h,w,k,s,p", POOLS[:4] + RAGGED)
def test_plan_w_covers_each_row_once(h, w, k, s, p, tile_bytes, elem):
    wo = _out(w, k, s, p)
    for rows in (h, 20 * 64 * h):
        plan = pk.plan_w(rows, w, wo, tile_bytes, elem)
        assert 1 <= plan.rows <= rows
        assert (plan.tiles - 1) * plan.rows < rows <= plan.tiles * plan.rows
        _check_layout(plan, plan.rows * w, plan.rows * wo, tile_bytes, plan.rows == 1, elem, plan.rows * w)
        if plan.rows < rows:  # as many rows as fit; in bf16, whole multiples of W_ROWS where those fit
            step = pk.W_ROWS if elem == 2 and plan.rows >= pk.W_ROWS else 1
            assert plan.rows % step == 0
            more = plan.rows + step
            assert pk._layout(0, 0, more * w, more * wo, elem, more * w).smem > tile_bytes


def test_bf16_tiles_hold_twice_the_elements():
    """A tile of the same bytes: twice the elements in bf16 at pool1's W pass
    (which stages its routed output as well: x, gw and gx, against float32's
    x and gw), and fewer bands per plane in its H pass."""
    f32, bf16 = pk.plan_w(20 * 64 * 321, 321, 161), pk.plan_w(20 * 64 * 321, 321, 161, elem=2)
    assert bf16.rows * (2 * 321 + 161) >= 2 * f32.rows * (321 + 161)
    assert pk.plan_h(20 * 64, 321, 161, 161, 3, 2, 1, elem=2).tiles < pk.plan_h(20 * 64, 321, 161, 161, 3, 2, 1).tiles


def test_plans_raise_beyond_the_cards_shared_memory():
    with pytest.raises(ValueError):
        pk.plan_w(4, 60000, 30000)
    with pytest.raises(ValueError):
        pk.plan_h(2, 5, 30000, 3, 3, 2, 1)


# stage_span() of csrc/pool_route.cuh in Python: a span of n elements whose
# first lies `lead` elements beyond a 16-byte boundary goes to shared
# elements lead .. lead + n as 16-byte pieces of vec = 16 / elem elements, the
# pieces that reach outside element by element
@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 7, 9, 41, 1681, 11 * 321])
@pytest.mark.parametrize("elem,lead", [(4, 0), (4, 1), (4, 2), (4, 3)] + [(2, lead) for lead in range(8)])
def test_span_pieces_are_aligned_and_cover_the_span_once(lead, n, elem):
    vec = 16 // elem
    seen = np.zeros(n, int)
    pieces = (lead + n + vec - 1) // vec
    assert vec * pieces <= pk.span_room(n, elem)
    for c in range(pieces):
        i0 = vec * c - lead
        if i0 >= 0 and i0 + vec <= n:
            assert (lead + i0) % vec == 0  # 16-byte aligned in device and in shared memory
            seen[i0:i0 + vec] += 1
        else:
            inside = [i for i in range(i0, i0 + vec) if 0 <= i < n]
            assert len(inside) < vec
            seen[inside] += 1
    assert (seen == 1).all()


def _block(line, origin, length, g, o_lo, n_out, j0, j1, k, s, p):
    """What one block does.  ``line`` (M, rows): the staged pass input, row
    ``origin`` of the pass axis first; ``g`` (M, windows): the staged
    cotangent, window ``o_lo`` first.  Returns (M, j1 - j0)."""
    tap = np.full(g.shape, -1)
    for i in range(g.shape[1]):  # pass 1: first_max_tap()
        best, nan = np.zeros(len(line), np.float32), np.zeros(len(line), bool)
        for u in range(k):
            pos = (o_lo + i) * s - p + u
            if 0 <= pos < length:
                v = line[:, pos - origin]  # an IndexError here: the tile lacks a halo row
                nan |= np.isnan(v)
                with np.errstate(invalid="ignore"):
                    take = (tap[:, i] < 0) | (v > best)
                best, tap[:, i] = np.where(take, v, best), np.where(take, u, tap[:, i])
        tap[nan, i] = -1
    out = np.zeros((len(line), j1 - j0), np.float32)
    for j in range(j0, j1):  # pass 2: route()
        o, t = divmod(j + p, s)
        while t < k:
            if 0 <= o < n_out:
                assert o_lo <= o < o_lo + g.shape[1]
                hit = tap[:, o - o_lo] == t
                out[hit, j - j0] = out[hit, j - j0] + g[hit, o - o_lo]
            t, o = t + s, o - 1
    return out


def _tiled_h(yw, g, k, s, p, tile_bytes, elem):
    b, c, h, wo = yw.shape
    ho = g.shape[2]
    plan = pk.plan_h(b * c, h, wo, ho, k, s, p, tile_bytes, elem)
    cols = yw.permute(0, 1, 3, 2).reshape(-1, h).numpy()  # one line per (plane, column)
    gcols = g.permute(0, 1, 3, 2).reshape(-1, ho).numpy()
    out = np.full(cols.shape, np.nan, np.float32)
    for first in range(0, b * c, plan.planes):  # a block's planes: the same walk over each
        lines = slice(first * wo, min(first + plan.planes, b * c) * wo)
        for band in range(plan.tiles):
            j0, j1, y_lo, y_hi, o_lo, o_hi = pk.h_band(band, plan.rows, h, ho, k, s, p)
            out[lines, j0:j1] = _block(cols[lines, y_lo:y_hi], y_lo, h, gcols[lines, o_lo:o_hi], o_lo, ho,
                                       j0, j1, k, s, p)
    return torch.from_numpy(out).reshape(b, c, wo, h).permute(0, 1, 3, 2), plan


def _tiled_w(x, gw, k, s, p, tile_bytes, elem):
    w, wo = x.shape[3], gw.shape[3]
    rows, grows = x.reshape(-1, w).numpy(), gw.reshape(-1, wo).numpy()
    plan = pk.plan_w(len(rows), w, wo, tile_bytes, elem)
    out = np.full(rows.shape, np.nan, np.float32)
    for tile in range(plan.tiles):
        r = slice(tile * plan.rows, min((tile + 1) * plan.rows, len(rows)))
        out[r] = _block(rows[r], 0, w, grows[r], 0, wo, 0, w, k, s, p)
    return torch.from_numpy(out).reshape(x.shape), plan


# integer inputs 0..2 put several equal maxima in most windows; the cotangents
# are normal floats, on which only the order t = 0..k-1 gives the plain
# version's bits; "special" adds NaN and +-inf to the inputs.  The walk adds
# in float32: at elem 2 it holds the bf16 kernels' tiles, not their rounding
@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("special", [False, True])
@pytest.mark.parametrize("h,w,k,s,p", [(37, 45, 3, 2, 1), (38, 29, 3, 2, 1), (41, 41, 3, 1, 1),
                                       (1, 3, 3, 2, 1), (23, 31, 2, 2, 0), (26, 33, 4, 3, 2)])
def test_tiled_routing_matches_plain(h, w, k, s, p, special, elem):
    ho, wo = _out(h, k, s, p), _out(w, k, s, p)
    rng = np.random.default_rng(h * w + s)
    x = rng.integers(0, 3, (2, 3, h, w)).astype(np.float32)
    yw = rng.integers(0, 3, (2, 3, h, wo)).astype(np.float32)
    if special:
        for a in (x, yw):
            a[rng.random(a.shape) < 0.05] = np.nan
            a[rng.random(a.shape) < 0.1] = np.inf
            a[rng.random(a.shape) < 0.3] = -np.inf
    x, yw = torch.from_numpy(x), torch.from_numpy(yw)
    g = torch.from_numpy(rng.normal(size=(2, 3, ho, wo)).astype(np.float32))
    gw = torch.from_numpy(rng.normal(size=(2, 3, h, wo)).astype(np.float32))
    tile = SMALL_TILE * elem // 4  # as many elements per tile at both sizes
    got_h, plan_h = _tiled_h(yw, g, k, s, p, tile, elem)
    got_w, plan_w = _tiled_w(x, gw, k, s, p, tile, elem)
    assert h < 8 or plan_h.tiles > 1  # several bands: their boundaries fall inside windows
    assert h < 8 or plan_w.tiles > 1
    assert torch.equal(got_h, pk.pool_bwd_h_plain(yw, g, k, s, p))
    assert torch.equal(got_w, pk.pool_bwd_w_plain(x, gw, k, s, p))


# What a bfloat16 block does (csrc/pool_runs.cuh), in torch on the CPU: runs
# of RUN positions along the routing axis that start where a band (H) or a row
# (W) starts, vectorised over the lines the threads pair up; each run loads the
# positions its windows reach (-inf, and never equal to a maximum, where the
# tile holds no value: the plane's or row's ends, rows of another band), takes
# each window's NaN-propagating maximum once, walks the windows from the last
# to the first so that a position adds its taps in the order t = 0..k-1, adds
# the cotangent where a tap equals the maximum and no earlier tap does (a bf16
# add: rounded after every add), and stores the positions that are the
# block's.  The kernels take this path for k = 3 at s = 1 and 2.
def _run_geom(s, k, phi):
    m_min, m_max = -((k - 1 - phi) // s), (pk.RUN - 1 + phi) // s
    return m_min, m_max, m_min * s - phi  # the windows, and the first position they reach


def _route_runs(line, ok, cot, cot_ok, j0, o0, k, s, phi):
    """One run: ``line(d)`` / ``ok(d)`` the values and the mask at position
    j0 + d (..., L), ``cot(m)`` / ``cot_ok(m)`` window o0 + m's cotangent.
    Returns the RUN routed positions."""
    m_min, m_max, lo = _run_geom(s, k, phi)
    neg = torch.tensor(float("-inf"), dtype=torch.bfloat16)
    zero = torch.zeros((), dtype=torch.bfloat16)
    v = {d: torch.where(ok(d), line(d), neg) for d in range(lo, lo + (m_max - m_min) * s + k)}
    acc = [None] * pk.RUN
    for m in range(m_max, m_min - 1, -1):
        taps = [v[m * s - phi + u] for u in range(k)]
        mx = taps[0]
        for t in taps[1:]:
            mx = torch.maximum(mx, t)  # NaN propagates: a NaN window equals none of its taps
        g = torch.where(cot_ok(m), cot(m), zero)
        seen = torch.zeros(mx.shape, dtype=torch.bool)
        for u, t in enumerate(taps):
            eq = (t == mx) & ok(m * s - phi + u)
            e = m * s - phi + u
            if 0 <= e < pk.RUN:
                term = torch.where(eq & ~seen, g, zero)
                acc[e] = term + zero if acc[e] is None else acc[e] + term  # the sum starts at +0
            seen = seen | eq
    return acc


def _runs_h(yw, g, k, s, p, tile_bytes):
    b, c, h, wo = yw.shape
    ho = g.shape[2]
    n = b * c
    plan = pk.plan_h(n, h, wo, ho, k, s, p, tile_bytes, 2)
    yp, gp = yw.reshape(n, h, wo), g.reshape(n, ho, wo)
    out = torch.full((n, h, wo), float("nan"), dtype=torch.bfloat16)
    for first in range(0, n, plan.planes):
        q = slice(first, min(first + plan.planes, n))
        for band in range(plan.tiles):
            j0b, j1b, y_lo, y_hi, o_lo, o_hi = pk.h_band(band, plan.rows, h, ho, k, s, p)
            phi = (j0b + p) % s
            for j0 in range(j0b, j1b, pk.RUN):  # a band's runs start at its first row
                o0 = (j0 + p - phi) // s
                acc = _route_runs(lambda d: yp[q, min(max(j0 + d, 0), h - 1)],
                                  lambda d: torch.tensor(y_lo <= j0 + d < y_hi),
                                  lambda m: gp[q, min(max(o0 + m, 0), ho - 1)],
                                  lambda m: torch.tensor(o_lo <= o0 + m < o_hi), j0, o0, k, s, phi)
                for e in range(min(pk.RUN, j1b - j0)):
                    out[q, j0 + e] = acc[e]
    return out.reshape(b, c, h, wo), plan


def _runs_w(x, gw, k, s, p, tile_bytes):
    w, wo = x.shape[3], gw.shape[3]
    rows, grows = x.reshape(-1, w), gw.reshape(-1, wo)
    plan = pk.plan_w(len(rows), w, wo, tile_bytes, 2)
    out = torch.full(rows.shape, float("nan"), dtype=torch.bfloat16)
    phi = p % s  # every row's runs start at columns 0, RUN, 2 RUN, ...
    for j0 in range(0, w, pk.RUN):  # the same runs in every block: rows never share a run
        o0 = (j0 + p - phi) // s
        acc = _route_runs(lambda d: rows[:, min(max(j0 + d, 0), w - 1)], lambda d: torch.tensor(0 <= j0 + d < w),
                          lambda m: grows[:, min(max(o0 + m, 0), wo - 1)],
                          lambda m: torch.tensor(0 <= o0 + m < wo), j0, o0, k, s, phi)
        for e in range(min(pk.RUN, w - j0)):
            out[:, j0 + e] = acc[e]
    return out.reshape(x.shape), plan


def _bf16_cases(h, w, k, s, p, special, planes, seed):
    """Integer inputs full of ties and normal cotangents, as bf16; ``special``
    adds NaN and +-inf to both, subnormal and -0 cotangents always."""
    ho, wo = _out(h, k, s, p), _out(w, k, s, p)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 3, (1, planes, h, w)).astype(np.float32)
    yw = rng.integers(0, 3, (1, planes, h, wo)).astype(np.float32)
    g = rng.normal(size=(1, planes, ho, wo)).astype(np.float32)
    gw = rng.normal(size=(1, planes, h, wo)).astype(np.float32)
    for a in (g, gw):
        a[rng.random(a.shape) < 0.1] = -0.0
        tiny = rng.random(a.shape) < 0.1  # bf16 subnormals: multiples of 2^-133 below 2^-126
        a[tiny] = rng.integers(-127, 128, tiny.sum()) * np.float32(2.0 ** -133)
    if special:
        for a, shares in ((x, (0.05, 0.1, 0.3)), (yw, (0.05, 0.1, 0.3)), (g, (0.02,) * 3), (gw, (0.02,) * 3)):
            for value, share in zip((np.nan, np.inf, -np.inf), shares):
                a[rng.random(a.shape) < share] = value
    return [torch.from_numpy(a).bfloat16() for a in (x, yw, g, gw)]


def _same_bits(got, ref):
    """Equal bits, NaN for NaN (a NaN's payload is not held)."""
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got.view(torch.int16)[~nan], ref.view(torch.int16)[~nan])


# the runs at the stage-1 pools (three planes) and at ragged shapes of the
# kernels' run path: bands and planes shorter than a run, runs that overhang a
# plane's or a row's end, widths around a run, a plane of one column; with the
# default tile, and with small ones that cut several bands (whose last run
# overhangs the band) and blocks
@pytest.mark.parametrize("special", [False, True])
@pytest.mark.parametrize("tile_bytes", [pk.TILE_BYTES, 1024])
@pytest.mark.parametrize("h,w,k,s,p", POOLS[:4] + [(37, 45, 3, 2, 1), (38, 29, 3, 2, 1), (1, 3, 3, 2, 1),
                                                   (2, 1, 3, 1, 1), (19, 70, 3, 1, 1), (9, 17, 3, 2, 1),
                                                   (16, 15, 3, 1, 1), (7, 9, 3, 2, 0), (13, 16, 3, 2, 2)])
def test_bf16_runs_match_plain(h, w, k, s, p, tile_bytes, special):
    x, yw, g, gw = _bf16_cases(h, w, k, s, p, special, 3 if h > 100 else 5, h * w + s + special)
    got_h, plan_h = _runs_h(yw, g, k, s, p, tile_bytes)
    got_w, plan_w = _runs_w(x, gw, k, s, p, tile_bytes)
    if tile_bytes < 8192 and h > 30:
        assert plan_h.tiles > 1 and plan_w.tiles > 1
    _same_bits(got_h, pk.pool_bwd_h_plain(yw, g, k, s, p))
    _same_bits(got_w, pk.pool_bwd_w_plain(x, gw, k, s, p))


def test_bf16_run_geometry():
    """A run's windows hold every position of the run, and only windows that
    hold one: at s = 2 five windows over eleven positions, at s = 1 ten over
    twelve; the positions of window m are m s - phi + u."""
    for s, k in ((1, 3), (2, 3)):
        for phi in range(s):
            m_min, m_max, lo = _run_geom(s, k, phi)
            held = {m: [m * s - phi + u for u in range(k)] for m in range(m_min, m_max + 1)}
            assert all(any(0 <= e < pk.RUN for e in pos) for pos in held.values())
            assert not any(0 <= m * s - phi + u < pk.RUN for m in (m_min - 1, m_max + 1) for u in range(k))
            assert sorted({e for pos in held.values() for e in pos if 0 <= e < pk.RUN}) == list(range(pk.RUN))
            assert min(min(pos) for pos in held.values()) == lo
            assert (m_max - m_min + 1, (m_max - m_min) * s + k) == ({1: (10, 12), 2: (5, 11)}[s])


@pytest.mark.parametrize("source,name", [("pool_runs.cuh", "RUN"), ("pool_bwd_w.cu", "W_ROWS")])
def test_run_geometry_matches_the_cuda_sources(source, name):
    """The planner's copy of the bfloat16 run geometry is the kernels' own: a
    RUN that differs would put every band on the slow path, a W_ROWS that
    differs would break the W block's bank order."""
    text = (Path(pk.__file__).resolve().parents[1] / "csrc" / source).read_text()
    found = re.findall(rf"constexpr int {name} = (\d+);", text)
    assert found == [str(getattr(pk, name))]
