"""The tile geometry of the port's pool backward kernels, held on the CPU.

``plan_h`` / ``plan_w`` (``dsrg_tpu_torch/ops/pool_kernels.py``) cut a pass
into the tiles that the CUDA kernels' blocks own.  The kernels themselves run
only on the card (``tests/test_torch_port_cuda.py``); here the plans are
checked for what the kernels rely on, at both element sizes (float32, 4
bytes; bfloat16, 2), and a numpy walk over the tiles that does what a block
does (stage the spans, one first-max tap per window, gather per element) is
held bit for bit against the plain versions.
"""

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


def _check_layout(plan, n_in, n_win, tile_bytes, smallest, elem):
    """The three buffers of a block's shared memory: 16-byte aligned, room
    for a span that starts 0..vec-1 elements beyond a 16-byte boundary (vec
    = 16 / elem elements per piece), in order, within the plan's bytes;
    within ``tile_bytes`` unless the tile is already the smallest there is,
    and always within what the card allows."""
    vec = 16 // elem
    assert plan.off_g % vec == 0 and plan.off_tap % vec == 0 and plan.smem % 16 == 0
    for lead in range(vec):
        assert vec * -(-(lead + n_in) // vec) <= plan.off_g
        assert plan.off_g + vec * -(-(lead + n_win) // vec) <= plan.off_tap
    assert elem * plan.off_tap + n_win <= plan.smem <= pk.SMEM_MAX
    assert plan.smem <= tile_bytes or smallest


N_PLANES = 7  # not a multiple of the planes per block wherever a block takes several


@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("tile_bytes", [pk.TILE_BYTES, SMALL_TILE])
@pytest.mark.parametrize("h,w,k,s,p", POOLS[:4] + RAGGED)
def test_plan_h_covers_each_row_once(h, w, k, s, p, tile_bytes, elem):
    ho, wo = _out(h, k, s, p), _out(w, k, s, p)
    plan = pk.plan_h(N_PLANES, h, wo, ho, k, s, p, tile_bytes, elem)
    assert plan.tiles == -(-h // plan.rows) and 1 <= plan.planes <= N_PLANES
    covered = np.zeros(h, int)
    n_in = n_win = 0
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
    assert (covered == 1).all()
    _check_layout(plan, n_in, n_win, tile_bytes, plan.rows == 1, elem)
    if plan.tiles > 1:  # the fewest bands: one fewer would not fit
        fewer = -(-h // (plan.tiles - 1))
        assert pk._plan_h_bands(fewer, h, wo, ho, k, s, p, elem).smem > tile_bytes
    elif plan.planes < N_PLANES and pk.h_band(0, h, h, ho, k, s, p)[4:] == (0, ho):  # as many planes as fit
        more = plan.planes + 1
        assert pk._layout(h, 1, more * h * wo, more * ho * wo, elem).smem > tile_bytes


@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("tile_bytes", [pk.TILE_BYTES, SMALL_TILE])
@pytest.mark.parametrize("h,w,k,s,p", POOLS[:4] + RAGGED)
def test_plan_w_covers_each_row_once(h, w, k, s, p, tile_bytes, elem):
    wo = _out(w, k, s, p)
    for rows in (h, 20 * 64 * h):
        plan = pk.plan_w(rows, w, wo, tile_bytes, elem)
        assert 1 <= plan.rows <= rows
        assert (plan.tiles - 1) * plan.rows < rows <= plan.tiles * plan.rows
        _check_layout(plan, plan.rows * w, plan.rows * wo, tile_bytes, plan.rows == 1, elem)
        if plan.rows < rows:  # as many rows as fit
            assert pk._layout(0, 0, (plan.rows + 1) * w, (plan.rows + 1) * wo, elem).smem > tile_bytes


def test_bf16_tiles_hold_twice_the_elements():
    """A tile of the same bytes: about twice the bf16 rows of pool1's W pass,
    and fewer bands per plane in its H pass."""
    f32, bf16 = pk.plan_w(20 * 64 * 321, 321, 161), pk.plan_w(20 * 64 * 321, 321, 161, elem=2)
    assert bf16.rows >= 2 * f32.rows - 1
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
