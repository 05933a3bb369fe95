// What pool_bwd_h.cu and pool_bwd_w.cu share: staging a contiguous span of
// elements (float or bfloat16) into shared memory with 16-byte asynchronous
// copies, the tap of a window's first maximum, and the sum of the windows
// that route to a position.
//
// Both kernels work on a tile that the routing never leaves.  A tile's part
// of each tensor is one contiguous span of device memory, whatever the row
// length, so it moves as aligned 16-byte pieces of VEC = 16 / sizeof(T)
// elements: stage_span() puts src[i] at dst[lead + i], where lead (0..VEC-1
// elements) is what src lies beyond the last 16-byte boundary.  Pieces that
// reach outside the span are copied element by element (at most one at each
// end), so no byte outside the span is read.
//
// Values are compared as floats (__bfloat162float is exact), so NaN and
// +-inf route alike in both types.  Sums are rounded to T after every add,
// as T's own additions round: for bfloat16, acc = bf16(float(acc) + float(g)),
// which is the plain version's and the JAX kernel's bfloat16 `acc + term`.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pool_route {

constexpr int THREADS = 256;
constexpr int KMAX = 4;           // the largest window; the stage-1 pools use 3
constexpr int SMEM_MAX = 232448;  // what a block may use on sm_90: 227 KB

// Elements of T in one 16-byte piece.
template <class T>
__host__ __device__ constexpr int vec() { return 16 / (int)sizeof(T); }

// Room in elements of T for a span of n with any lead: a multiple of vec<T>().
template <class T>
__host__ __device__ constexpr long span_room(long n) {
  return (n + 2 * (vec<T>() - 1)) / vec<T>() * vec<T>();
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// x rounded to T (nearest, ties to even) and back: what an addition in T keeps.
template <class T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <class T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // exact: x is already a bfloat16 value
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Starts the copy of src[0..n) to dst[lead..lead + n) by all threads of the
// block and returns lead.  dst is 16-byte aligned with room for
// span_room<T>(n) elements.  The data has landed after cp_async_wait_all()
// and __syncthreads().
template <class T>
__device__ __forceinline__ int stage_span(T* dst, const T* src, int n, int tid) {
  constexpr int V = vec<T>();
  const int lead = (int)((reinterpret_cast<uintptr_t>(src) / sizeof(T)) & (V - 1));
  const int pieces = (lead + n + V - 1) / V;
  for (int c = tid; c < pieces; c += THREADS) {
    const int i0 = V * c - lead;  // the piece holds src[i0..i0 + V)
    if (i0 >= 0 && i0 + V <= n) {
      cp_async16(dst + V * c, src + i0);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (i0 + e >= 0 && i0 + e < n) dst[V * c + e] = src[i0 + e];
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
template <int K, bool INSIDE, class T>
__device__ __forceinline__ int first_max_tap(const T* line, int stride, int origin, int base,
                                             int len, int k) {
  if (INSIDE && K > 0 && base >= 0 && base + K <= len) {
    const T* at = line + (base - origin) * stride;
    float best = to_float(at[0]);
    int tap = 0;
    bool real = best == best;
#pragma unroll
    for (int u = 1; u < K; ++u) {
      const float v = to_float(at[u * stride]);
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
      const float v = to_float(line[(pos - origin) * stride]);
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
// added in the order of their taps t = 0..k-1, each sum rounded to T.  Position j is tap t of
// window o where o * s = j + p - t, so the taps are (j + p) % s, + s, ...
// and the windows (j + p) / s, - 1, ...  tap[(o - o_lo) * stride] and
// g[(o - o_lo) * stride] belong to window o; windows outside [0, n_out) do
// not exist.  S: the stride if known at compile time, else 0.
template <int S, int K, class T>
__device__ __forceinline__ T route(const signed char* tap, const T* g, int stride, int o_lo,
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
      if (tap[at] == t) acc = round_to<T>(acc + to_float(g[at]));
    }
    t += s;
    --o;
  }
  return from_float<T>(acc);
}

}  // namespace pool_route
