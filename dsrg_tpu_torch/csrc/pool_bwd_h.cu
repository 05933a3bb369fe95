// Backward of the H pass of the separable Caffe max pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel dsrg_tpu/ops/pallas_pool.py::pool_bwd_h
// (_bwd_h_kernel -> _route_1d).  NCHW planes, N = batch x channels:
// yw (N, H, Wo) f32 is the W-pooled input of the H pass, g (N, Ho, Wo) f32
// the cotangent of the pool's output, gw (N, H, Wo) f32 the routed cotangent
//
//   gw[n, j, w] = sum_{t = 0..k-1} [(j + p - t) % s == 0, window o = (j + p - t) / s in [0, Ho)]
//                   * [yw[n, j, w] == max of window o]
//                   * [no tap t' < t of window o equals that max]
//                   * g[n, o, w]
//
// Window o covers rows o*s - p .. o*s - p + k - 1; rows outside [0, H) are
// the -inf halo and never hit.  Every window's cotangent goes to its first
// maximum in scan order (Caffe's stored argmax, XLA's SelectAndScatter
// order), and the taps are summed in the order t = 0..k-1 as _route_1d sums
// them, so the result is bit-identical to the JAX kernel on any data.
//
// Bound on the H100: bytes.  The pass does a few compares per element and
// must read yw and g and write gw once (pool1 at batch 20 @ 321^2: 0.66 GB,
// ~0.2 ms at 3.35 TB/s).  One thread per element of gw, W fastest, so a
// warp reads 32 neighbouring floats of each row it touches; the 2k - 1 rows
// around an element that the window maxima need are re-read by the threads
// of the neighbouring rows from L1/L2, not from device memory, and g is read
// directly at row (j + p - t) / s (the JAX version's upsampled copy of g is
// never materialised).  A thread loads its 2k - 1 rows once into registers
// (k <= KMAX) and recomputes each window's maximum from them; what is left
// is integer work per element, so the flat index is split with 32-bit
// divisions whenever the tensor allows it and the stride is a compile-time
// constant for s = 1 and s = 2.  Sharing the rows across a tile in shared
// memory, instead of re-reading them from L1/L2 per thread, is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int KMAX = 4;  // the largest window; the stage-1 pools use 3

// I: the flat index type; S: the stride if known at compile time, else 0
template <typename I, int S>
__global__ void pool_bwd_h_kernel(const float* __restrict__ yw, const float* __restrict__ g,
                                  float* __restrict__ out, I total, int h, int wo, int ho,
                                  int k, int s_arg, int p) {
  const int s = S > 0 ? S : s_arg;
  for (I e = blockIdx.x * (I)THREADS + threadIdx.x; e < total; e += (I)gridDim.x * THREADS) {
    const I nj = e / (I)wo;
    const int w = (int)(e - nj * (I)wo);
    const I n = nj / (I)h;
    const int j = (int)(nj - n * (I)h);
    const float* col = yw + (size_t)n * h * wo + w;  // column (n, :, w): rows wo apart
    // rows j + d, d in (-k, k), once into registers: v[d + KMAX - 1], -inf
    // in the halo, which in[] marks so that it never counts as a hit
    float v[2 * KMAX - 1];
    bool in[2 * KMAX - 1];
#pragma unroll
    for (int d = 1 - KMAX; d < KMAX; ++d) {
      const int r = j + d;
      in[d + KMAX - 1] = d > -k && d < k && r >= 0 && r < h;
      v[d + KMAX - 1] = in[d + KMAX - 1] ? col[(size_t)r * wo] : -INFINITY;
    }
    const float xj = v[KMAX - 1];
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < KMAX; ++t) {
      const int os = j + p - t;  // o * s for the window that holds row j as tap t
      if (t >= k || os < 0 || os % s != 0 || os / s >= ho) continue;
      float wm = -INFINITY;  // the window's rows are j - t + u, u < k
#pragma unroll
      for (int u = 0; u < KMAX; ++u) {
        const float x = v[u - t + KMAX - 1];
        if (u < k) wm = (x > wm || x != x) ? x : wm;  // NaN propagates, as jnp.maximum's does
      }
      if (xj != wm) continue;
      bool first = true;
#pragma unroll
      for (int u = 0; u < KMAX; ++u)
        if (u < t && in[u - t + KMAX - 1] && v[u - t + KMAX - 1] == wm) first = false;
      if (first) acc += g[((size_t)n * ho + os / s) * wo + w];
    }
    out[e] = acc;
  }
}

template <int S>
void launch(const float* yw, const float* g, float* out, long total, int h, int wo, int ho, int k,
            int s, int p, cudaStream_t stream) {
  const long blocks = (total + THREADS - 1) / THREADS;
  const int grid = (int)(blocks < (1L << 30) ? blocks : (1L << 30));
  if (total <= (1L << 30))  // e + the grid's stride stays below 2^32
    pool_bwd_h_kernel<unsigned, S><<<grid, THREADS, 0, stream>>>(yw, g, out, (unsigned)total, h,
                                                                 wo, ho, k, s, p);
  else
    pool_bwd_h_kernel<unsigned long long, S><<<grid, THREADS, 0, stream>>>(
        yw, g, out, (unsigned long long)total, h, wo, ho, k, s, p);
}

}  // namespace

// Returns the CUDA error code of the launch (0 on success; invalid value for
// k > KMAX).  yw, g and out are contiguous f32.
extern "C" int pool_bwd_h(const void* yw, const void* g, void* out, int n, int h, int wo, int ho,
                          int k, int s, int p, void* stream) {
  if (n <= 0 || h <= 0 || wo <= 0 || ho <= 0 || k <= 0 || k > KMAX || s <= 0 || p < 0 || p >= k)
    return (int)cudaErrorInvalidValue;
  const long total = (long)n * h * wo;
  const auto* a = (const float*)yw;
  const auto* b = (const float*)g;
  auto* o = (float*)out;
  const auto st = (cudaStream_t)stream;
  if (s == 1)
    launch<1>(a, b, o, total, h, wo, ho, k, s, p, st);
  else if (s == 2)
    launch<2>(a, b, o, total, h, wo, ho, k, s, p, st);
  else
    launch<0>(a, b, o, total, h, wo, ho, k, s, p, st);
  return (int)cudaGetLastError();
}
