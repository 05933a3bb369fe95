// What pool_bwd_h.cu and pool_bwd_w.cu share: staging a contiguous span of
// floats into shared memory with 16-byte asynchronous copies, the tap of a
// window's first maximum, and the sum of the windows that route to a position.
//
// Both kernels work on a tile that the routing never leaves.  A tile's part
// of each tensor is one contiguous span of device memory, whatever the row
// length, so it moves as aligned 16-byte pieces: stage_span() puts src[i] at
// dst[lead + i], where lead (0..3 floats) is what src lies beyond the last
// 16-byte boundary.  Pieces that reach outside the span are copied float by
// float (at most one at each end), so no byte outside the span is read.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pool_route {

constexpr int THREADS = 256;
constexpr int KMAX = 4;           // the largest window; the stage-1 pools use 3
constexpr int SMEM_MAX = 232448;  // what a block may use on sm_90: 227 KB

// Room in floats for a span of n with any lead: a multiple of 4.
constexpr long span_room(long n) { return (n + 3 + 3) / 4 * 4; }

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Starts the copy of src[0..n) to dst[lead..lead + n) by all threads of the
// block and returns lead.  dst is 16-byte aligned with room for span_room(n) floats.
// The data has landed after cp_async_wait_all() and __syncthreads().
__device__ __forceinline__ int stage_span(float* dst, const float* src, int n, int tid) {
  const int lead = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  const int pieces = (lead + n + 3) >> 2;
  for (int c = tid; c < pieces; c += THREADS) {
    const int i0 = 4 * c - lead;  // the piece holds src[i0..i0 + 4)
    if (i0 >= 0 && i0 + 4 <= n) {
      cp_async16(dst + 4 * c, src + i0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (i0 + e >= 0 && i0 + e < n) dst[4 * c + e] = src[i0 + e];
    }
  }
  return lead;
}

// A thread's walk over the positions tid, tid + THREADS, ... of a tile of
// rows of `width`: row and column as loop variables, split by one division
// per thread, none per element.
struct Walk {
  int row, col, drow, dcol, width;
  __device__ __forceinline__ Walk(int tid, int width_) : width(width_) {
    row = tid / width;
    col = tid - row * width;
    drow = THREADS / width;
    dcol = THREADS - drow * width;
  }
  __device__ __forceinline__ void next() {
    row += drow;
    col += dcol;
    if (col >= width) {
      col -= width;
      ++row;
    }
  }
};

// The tap (0..k-1) of the first maximum of the window that covers positions
// base .. base + k - 1 of a line of `len` values, or -1 where the window
// routes nothing: its maximum is NaN.  Positions outside [0, len) are the
// -inf halo: they never hit, so a window of -inf routes to its first real
// tap.  line[(pos - origin) * stride] is the value at position pos.
// K: the window if known at compile time, else 0.  INSIDE: windows that lie
// inside the line take a path of their own without the halo's tests; worth
// it where the windows of a warp are mostly of one kind.
template <int K, bool INSIDE>
__device__ __forceinline__ int first_max_tap(const float* line, int stride, int origin, int base,
                                             int len, int k) {
  if (INSIDE && K > 0 && base >= 0 && base + K <= len) {
    const float* at = line + (base - origin) * stride;
    float best = at[0];
    int tap = 0;
    bool real = best == best;
#pragma unroll
    for (int u = 1; u < K; ++u) {
      const float v = at[u * stride];
      real &= v == v;
      if (v > best) {  // strictly greater: the first of equal maxima stays
        best = v;
        tap = u;
      }
    }
    return real ? tap : -1;
  }
  int tap = -1;
  float best = 0.0f;
  bool nan = false;
#pragma unroll
  for (int u = 0; u < (K > 0 ? K : KMAX); ++u) {
    const int pos = base + u;
    if (u < k && (unsigned)pos < (unsigned)len) {
      const float v = line[(pos - origin) * stride];
      nan |= v != v;
      if (tap < 0 || v > best) {
        best = v;
        tap = u;
      }
    }
  }
  return nan ? -1 : tap;
}

// gx at position j: the cotangents of the windows whose first maximum is j,
// added in the order of their taps t = 0..k-1.  Position j is tap t of
// window o where o * s = j + p - t, so the taps are (j + p) % s, + s, ...
// and the windows (j + p) / s, - 1, ...  tap[(o - o_lo) * stride] and
// g[(o - o_lo) * stride] belong to window o; windows outside [0, n_out) do
// not exist.  S: the stride if known at compile time, else 0.
template <int S, int K>
__device__ __forceinline__ float route(const signed char* tap, const float* g, int stride, int o_lo,
                                       int n_out, int j, int p, int k, int s) {
  const int jp = j + p;
  int o = S == 1 ? jp : S == 2 ? jp >> 1 : jp / s;
  int t = S == 1 ? 0 : S == 2 ? jp & 1 : jp - o * s;
  constexpr int KK = K > 0 ? K : KMAX;
  constexpr int TAPS = S > 0 ? (KK + S - 1) / S : KK;
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < TAPS; ++i) {
    if (t < k && (unsigned)o < (unsigned)n_out) {
      const int at = (o - o_lo) * stride;
      if (tap[at] == t) acc += g[at];
    }
    t += s;
    --o;
  }
  return acc;
}

}  // namespace pool_route
