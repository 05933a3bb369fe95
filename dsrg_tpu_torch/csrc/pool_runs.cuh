// The bfloat16 blocks of pool_bwd_h.cu and pool_bwd_w.cu: runs along the
// routing axis, two lines at a time in packed bfloat16 pairs.
//
// A thread owns a run of RUN consecutive positions j0 .. j0 + RUN - 1 of two
// lines (the pair's lanes: two columns of a plane in the H pass, two rows in
// the W pass).  The windows that hold a position of the run, and the k - 1
// positions on either side that they reach, are loaded into registers once;
// every window's maximum and first-maximum test is then computed once for
// both lanes with packed bfloat16 instructions, and the cotangents are added
// with the packed bfloat16 add, so nothing is converted to float and no tap
// byte goes through shared memory.  Runs start where (j0 + p) % s is the same
// for every run of a block (PHI, a template argument), so the windows of a
// run and the positions of their taps are compile-time constants: window
// o0 + m (o0 = (j0 + p - PHI) / s) covers positions j0 - PHI + m s + u,
// u = 0..k-1.
//
// Semantics, bit for bit those of the plain versions (_route_1d):
//   - max.NaN: a window whose maximum is NaN equals none of its taps and
//     routes nothing;
//   - a tap routes where it equals the maximum and no earlier tap of the
//     window does; positions that hold no value of the tile (the -inf halo,
//     rows of another band) are -inf in the maximum and never equal it;
//   - the windows are walked from the last to the first, so each position
//     adds its taps in the order t = 0..k-1; a tap that does not route adds
//     +0, which changes nothing (the sum starts at +0 and is never -0);
//   - add.rn.bf16x2 rounds the exact sum once to bfloat16, which is what the
//     float add followed by a round to bfloat16 gives (double rounding
//     through float's 24 bits is harmless for bfloat16's 8: 24 >= 2 * 8 + 2).
//
// The routed values go to a span of shared memory laid out as the output's
// device memory (unstage_span), and leave it in 16-byte pieces.

#pragma once

#include "pool_route.cuh"

namespace pool_runs {

using namespace pool_route;

constexpr int RUN = 8;                      // positions per run; a multiple of the strides 1 and 2
constexpr unsigned NEG_INF2 = 0xff80ff80u;  // -inf in both lanes

__device__ __forceinline__ unsigned max_nan2(unsigned a, unsigned b) {
  unsigned d;
  asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// 0xffff in each lane where a == b (so -0 == +0, and NaN equals nothing)
__device__ __forceinline__ unsigned eq_mask2(unsigned a, unsigned b) {
  unsigned d;
  asm("set.eq.u32.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ unsigned add2(unsigned a, unsigned b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ unsigned pack2(unsigned short lo, unsigned short hi) {
  return __byte_perm(lo, hi, 0x5410);
}

constexpr int floordiv(int a, int b) { return a >= 0 ? a / b : -((-a + b - 1) / b); }

// The windows of a run: m = M_MIN .. M_MAX, NW of them; their taps cover
// positions j0 + LO .. j0 + LO + NV - 1.
template <int S, int K, int PHI>
struct RunGeom {
  static constexpr int M_MIN = -floordiv(K - 1 - PHI, S);
  static constexpr int M_MAX = floordiv(RUN - 1 + PHI, S);
  static constexpr int NW = M_MAX - M_MIN + 1;
  static constexpr int LO = M_MIN * S - PHI;
  static constexpr int NV = (NW - 1) * S + K;
};

// Routes one run.  v_at(d, v, ok): the pair at position j0 + d in v and a
// full mask in ok, or v = NEG_INF2 and ok = 0 where the tile holds no value
// there; g_at(m): the cotangent pair of window o0 + m, 0 where the tile has
// no such window; store(e, pair): the routed pair of position j0 + e.
template <int S, int K, int PHI, class V, class G, class St>
__device__ __forceinline__ void route_run(V v_at, G g_at, St store) {
  using R = RunGeom<S, K, PHI>;
  unsigned v[R::NV], ok[R::NV], g[R::NW], acc[RUN];
#pragma unroll
  for (int i = 0; i < R::NV; ++i) v_at(R::LO + i, v[i], ok[i]);
#pragma unroll
  for (int i = 0; i < R::NW; ++i) g[i] = g_at(R::M_MIN + i);
#pragma unroll
  for (int e = 0; e < RUN; ++e) acc[e] = 0u;
#pragma unroll
  for (int m = R::M_MAX; m >= R::M_MIN; --m) {
    const int b = (m - R::M_MIN) * S;
    unsigned mx = v[b];
#pragma unroll
    for (int u = 1; u < K; ++u) mx = max_nan2(mx, v[b + u]);
    unsigned seen = 0u;
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const unsigned eq = eq_mask2(v[b + u], mx) & ok[b + u];
      const int e = m * S - PHI + u;
      if (e >= 0 && e < RUN) acc[e] = add2(acc[e], g[m - R::M_MIN] & eq & ~seen);
      seen |= eq;
    }
  }
#pragma unroll
  for (int e = 0; e < RUN; ++e) store(e, acc[e]);
}

// Elements of T that dst lies beyond the last 16-byte boundary.
template <class T>
__device__ __forceinline__ int lead_of(const T* dst) {
  return (int)((reinterpret_cast<uintptr_t>(dst) / sizeof(T)) & (vec<T>() - 1));
}

// The converse of stage_span: src[lead + i] (lead = lead_of(dst), src
// 16-byte aligned) to dst[i] for i in [0, n), as aligned 16-byte pieces, the
// pieces that reach outside the span element by element.  After a
// __syncthreads() that follows the writes to src.
template <class T>
__device__ __forceinline__ void unstage_span(T* dst, const T* src, int n, int tid) {
  constexpr int V = vec<T>();
  const int lead = lead_of(dst);
  const int pieces = (lead + n + V - 1) / V;
  for (int c = tid; c < pieces; c += THREADS) {
    const int i0 = V * c - lead;
    if (i0 >= 0 && i0 + V <= n) {
      *reinterpret_cast<uint4*>(dst + i0) = *reinterpret_cast<const uint4*>(src + V * c);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (i0 + e >= 0 && i0 + e < n) dst[i0 + e] = src[V * c + e];
    }
  }
}

// gx at position j for any k <= KMAX and s >= 1: each window that holds j
// finds its first maximum from the staged line (first_max_tap), in tap
// order.  The blocks' path for windows and strides that have no run
// instantiation.
template <int K, class T>
__device__ __forceinline__ T route_direct(const T* line, int stride, int origin, int len, const T* g,
                                          int g_stride, int o_lo, int n_out, int j, int p, int k, int s) {
  float acc = 0.0f;
  for (int t = 0; t < k; ++t) {
    const int jp = j + p - t;
    if (jp < 0 || jp % s) continue;
    const int o = jp / s;
    if (o >= n_out) continue;
    if (first_max_tap<K, false>(line, stride, origin, o * s - p, len, k) == t)
      acc = round_to<T>(acc + to_float(g[(o - o_lo) * g_stride]));
  }
  return from_float<T>(acc);
}

}  // namespace pool_runs
