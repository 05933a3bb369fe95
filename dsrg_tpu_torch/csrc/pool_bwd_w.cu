// Backward of the W pass of the separable Caffe max pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel dsrg_tpu/ops/pallas_pool.py::pool_bwd_w
// (_bwd_w_kernel -> _route_1d).  NCHW rows, R = batch x channels x H:
// x (R, W) f32 is the raw pool input, gw (R, Wo) f32 the cotangent of the W
// pass (what pool_bwd_h returns), gx (R, W) f32 the routed cotangent
//
//   gx[r, j] = sum_{t = 0..k-1} [(j + p - t) % s == 0, window o = (j + p - t) / s in [0, Wo)]
//                * [x[r, j] == max of window o]
//                * [no tap t' < t of window o equals that max]
//                * gw[r, o]
//
// Window o covers columns o*s - p .. o*s - p + k - 1; columns outside
// [0, W) are the -inf halo and never hit.  Every window's cotangent goes to
// its first maximum in scan order (Caffe's stored argmax, XLA's
// SelectAndScatter order), and the taps are summed in the order t = 0..k-1
// as _route_1d sums them, so the result is bit-identical to the JAX kernel
// on any data.
//
// Bound on the H100: bytes.  The pass does a few compares per element and
// must read x and gw and write gx once (pool1 at batch 20 @ 321^2: 1.3 GB,
// ~0.4 ms at 3.35 TB/s).  One thread per element of gx, W fastest: a warp
// reads 32 consecutive floats of x and the 2k - 2 around them that the
// window maxima need come from the same or the next cache line.  gw is read
// directly at column (j + p - t) / s; the JAX version's XLA-side repeat of
// gw to the input width is never materialised.  A thread loads its 2k - 1
// columns once into registers (k <= KMAX) and recomputes each window's
// maximum from them; what is left is integer work per element, so the flat
// index is split with a 32-bit division whenever the tensor allows it and
// the stride is a compile-time constant for s = 1 and s = 2.  Sharing the
// columns through shared memory is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int KMAX = 4;  // the largest window; the stage-1 pools use 3

// I: the flat index type; S: the stride if known at compile time, else 0
template <typename I, int S>
__global__ void pool_bwd_w_kernel(const float* __restrict__ x, const float* __restrict__ gw,
                                  float* __restrict__ out, I total, int w, int wo, int k,
                                  int s_arg, int p) {
  const int s = S > 0 ? S : s_arg;
  for (I e = blockIdx.x * (I)THREADS + threadIdx.x; e < total; e += (I)gridDim.x * THREADS) {
    const I r = e / (I)w;
    const int j = (int)(e - r * (I)w);
    const float* row = x + (size_t)r * w;
    // columns j + d, d in (-k, k), once into registers: v[d + KMAX - 1],
    // -inf in the halo, which in[] marks so that it never counts as a hit
    float v[2 * KMAX - 1];
    bool in[2 * KMAX - 1];
#pragma unroll
    for (int d = 1 - KMAX; d < KMAX; ++d) {
      const int c = j + d;
      in[d + KMAX - 1] = d > -k && d < k && c >= 0 && c < w;
      v[d + KMAX - 1] = in[d + KMAX - 1] ? row[c] : -INFINITY;
    }
    const float xj = v[KMAX - 1];
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < KMAX; ++t) {
      const int os = j + p - t;  // o * s for the window that holds column j as tap t
      if (t >= k || os < 0 || os % s != 0 || os / s >= wo) continue;
      float wm = -INFINITY;  // the window's columns are j - t + u, u < k
#pragma unroll
      for (int u = 0; u < KMAX; ++u) {
        const float xv = v[u - t + KMAX - 1];
        if (u < k) wm = (xv > wm || xv != xv) ? xv : wm;  // NaN propagates, as jnp.maximum's does
      }
      if (xj != wm) continue;
      bool first = true;
#pragma unroll
      for (int u = 0; u < KMAX; ++u)
        if (u < t && in[u - t + KMAX - 1] && v[u - t + KMAX - 1] == wm) first = false;
      if (first) acc += gw[(size_t)r * wo + os / s];
    }
    out[e] = acc;
  }
}

template <int S>
void launch(const float* x, const float* gw, float* out, long total, int w, int wo, int k, int s,
            int p, cudaStream_t stream) {
  const long blocks = (total + THREADS - 1) / THREADS;
  const int grid = (int)(blocks < (1L << 30) ? blocks : (1L << 30));
  if (total <= (1L << 30))  // e + the grid's stride stays below 2^32
    pool_bwd_w_kernel<unsigned, S><<<grid, THREADS, 0, stream>>>(x, gw, out, (unsigned)total, w,
                                                                 wo, k, s, p);
  else
    pool_bwd_w_kernel<unsigned long long, S><<<grid, THREADS, 0, stream>>>(
        x, gw, out, (unsigned long long)total, w, wo, k, s, p);
}

}  // namespace

// Returns the CUDA error code of the launch (0 on success; invalid value for
// k > KMAX).  x, gw and out are contiguous f32.
extern "C" int pool_bwd_w(const void* x, const void* gw, void* out, int rows, int w, int wo,
                          int k, int s, int p, void* stream) {
  if (rows <= 0 || w <= 0 || wo <= 0 || k <= 0 || k > KMAX || s <= 0 || p < 0 || p >= k)
    return (int)cudaErrorInvalidValue;
  const long total = (long)rows * w;
  const auto* a = (const float*)x;
  const auto* b = (const float*)gw;
  auto* o = (float*)out;
  const auto st = (cudaStream_t)stream;
  if (s == 1)
    launch<1>(a, b, o, total, w, wo, k, s, p, st);
  else if (s == 2)
    launch<2>(a, b, o, total, w, wo, k, s, p, st);
  else
    launch<0>(a, b, o, total, w, wo, k, s, p, st);
  return (int)cudaGetLastError();
}
