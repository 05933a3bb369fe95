// Backward of the H pass of the separable Caffe max pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel dsrg_tpu/ops/pallas_pool.py::pool_bwd_h
// (_bwd_h_kernel -> _route_1d).  NCHW planes, N = batch x channels, all in
// one element type T, float or bfloat16 (the JAX kernel's output takes the
// cotangent's dtype): yw (N, H, Wo) is the W-pooled input of the H pass,
// g (N, Ho, Wo) the cotangent of the pool's output, gw (N, H, Wo) the routed
// cotangent
//
//   gw[n, j, w] = sum_{t = 0..k-1} [(j + p - t) % s == 0, window o = (j + p - t) / s in [0, Ho)]
//                   * [yw[n, j, w] == max of window o]
//                   * [no tap t' < t of window o equals that max]
//                   * g[n, o, w]
//
// Window o covers rows o*s - p .. o*s - p + k - 1; rows outside [0, H) are
// the -inf halo and never hit.  Every window's cotangent goes to its first
// maximum in scan order (Caffe's stored argmax, XLA's SelectAndScatter
// order), a window whose maximum is NaN routes nothing, and the taps are
// summed in the order t = 0..k-1 as _route_1d sums them, each sum rounded to
// T, so the result is bit-identical to the JAX kernel on any data.
//
// Bound on the H100: bytes.  The pass does a few compares per element and
// must read yw and g and write gw once (pool1 at batch 20 @ 321^2: 0.66 GB
// in float, 0.33 GB in bfloat16, ~0.2 / ~0.1 ms at 3.35 TB/s); at that rate
// an SM's schedulers start about 85 warp operations for every 32 float
// elements (half as many for bfloat16), so the design counts operations as
// much as bytes.
//
// A block owns one band of jb rows of one plane, all Wo columns, or, where
// planes are small (41 x 41 at pool4 and pool5), a few whole planes (the
// tiles are planned in ops/pool_kernels.py::plan_h).  Routing along H never
// leaves a plane, and a band needs the k - 1 rows of yw above and below it
// and the rows of g whose windows touch it: rows are contiguous, so each is
// one span of device memory, staged into shared memory once with 16-byte
// asynchronous copies whatever Wo is (pool_route.cuh; a tile of the same
// bytes holds twice as many bfloat16 elements).  The halo re-reads 2(k - 1)
// rows per band; the bands of a plane are neighbours in the grid, so blocks
// that run together read neighbouring memory and mostly find the halo in L2 (with the planes as neighbours pool1 took a tenth longer).  Then the
// work is window-centric:
//   pass 1, over the band's windows: the tap of the window's first maximum
//     from k shared-memory reads down its column, one byte per window;
//   pass 2, over the band's elements: the cotangents of the <= ceil(k / s)
//     windows that hold the element and whose first tap it is, in tap order,
//     and one coalesced store per element (staging the float results in
//     shared memory for 16-byte stores was no faster at any pool).
// Threads walk a tile by flat position with row and column as loop
// variables (one division per thread, none per element); a tile's base is
// 64-bit, offsets inside it are 32-bit.  Stride and window are template
// arguments (s = 1, 2; k = 3).  Loads overlap stores across the blocks that
// are resident on an SM (tiles of ~32 KB, 256 threads), not inside a block.
//
// bfloat16 (pool_bwd_h_bf16) has a block of its own: the same bands and
// staging, but half the bytes per element leave half the instructions per
// element, so the element-by-element passes above would be bound by
// instruction issue.
// A thread owns a run of RUN rows of two neighbouring columns
// (pool_runs.cuh): the rows its windows reach are loaded once into
// registers as packed pairs, each window's first maximum is found once for
// the run, and the cotangents are added in packed bfloat16 in tap order, in
// one pass without tap bytes or a barrier between passes.  The runs write
// the band's rows into shared memory laid out as the output, which leaves
// in 16-byte stores.  Runs start at the band's first row; bands are
// multiples of RUN rows (plan_h), so a band's runs are whole but at the
// plane's end.

#include "pool_route.cuh"
#include "pool_runs.cuh"

namespace {

using namespace pool_route;

// Rows [y_lo, y_hi) of yw and windows [o_lo, o_hi) of g that band
// [j0, j1) of a plane needs; o_hi <= o_lo where no window touches it.
struct Band {
  int j0, j1, y_lo, y_hi, o_lo, o_hi;
};

__host__ __device__ inline Band band_of(int b, int jb, int h, int ho, int k, int s, int p) {
  Band t;
  t.j0 = b * jb;
  t.j1 = t.j0 + jb < h ? t.j0 + jb : h;
  t.y_lo = t.j0 - (k - 1) > 0 ? t.j0 - (k - 1) : 0;
  t.y_hi = t.j1 + (k - 1) < h ? t.j1 + (k - 1) : h;
  const int first = t.j0 + p - (k - 1);  // o * s of the first window that reaches row j0
  t.o_lo = first > 0 ? (first + s - 1) / s : 0;
  const int last = (t.j1 - 1 + p) / s + 1;
  t.o_hi = last < ho ? last : ho;
  if (t.o_hi < t.o_lo) t.o_hi = t.o_lo;
  return t;
}

// S, K: the stride and the window if known at compile time, else 0
template <class T, int S, int K>
__global__ void __launch_bounds__(THREADS)
    pool_bwd_h_kernel(const T* __restrict__ yw, const T* __restrict__ g, T* __restrict__ out, int n,
                      int h, int wo, int ho, int k_arg, int s_arg, int p, int jb, int n_bands, int pb,
                      int off_g, int off_tap) {
  extern __shared__ float4 smem4[];
  T* smem = reinterpret_cast<T*>(smem4);
  const int k = K > 0 ? K : k_arg;
  const int s = S > 0 ? S : s_arg;
  const int tid = threadIdx.x;
  // the bands of a plane are neighbours in the grid
  const int group = blockIdx.x / n_bands;
  const size_t n0 = (size_t)group * pb;
  const int np = n - n0 < (size_t)pb ? (int)(n - n0) : pb;  // > 1 only for whole planes
  const Band t = band_of((int)blockIdx.x - group * n_bands, jb, h, ho, k, s, p);
  const int n_win = (t.o_hi - t.o_lo) * wo;
  const int n_el = (t.j1 - t.j0) * wo;
  const int y_plane = h * wo, g_plane = ho * wo;  // from one plane of the tile to the next

  const T* sy = smem + stage_span(smem, yw + (n0 * h + t.y_lo) * wo,
                                  (np - 1) * y_plane + (t.y_hi - t.y_lo) * wo, tid);
  const T* sg = smem + off_g + stage_span(smem + off_g, g + (n0 * ho + t.o_lo) * wo,
                                          (np - 1) * g_plane + n_win, tid);
  signed char* stap = reinterpret_cast<signed char*>(smem + off_tap);
  cp_async_wait_all();
  __syncthreads();

  const Walk first(tid, wo);
  for (int q = 0; q < np; ++q) {
    Walk win = first;
    for (int f = tid; f < n_win; f += THREADS, win.next())
      stap[q * g_plane + f] = (signed char)first_max_tap<K, true>(
          sy + q * y_plane + win.col, wo, t.y_lo, (t.o_lo + win.row) * s - p, h, k);
  }
  __syncthreads();

  T* dst = out + (n0 * h + t.j0) * wo;
  for (int q = 0; q < np; ++q) {
    Walk el = first;
    for (int f = tid; f < n_el; f += THREADS, el.next())
      dst[q * y_plane + f] = route<S, K>(stap + q * g_plane + el.col, sg + q * g_plane + el.col, wo,
                                         t.o_lo, ho, t.j0 + el.row, p, k, s);
  }
}

template <class T, int S, int K>
int launch(const T* yw, const T* g, T* out, int n, int h, int wo, int ho, int k, int s, int p,
           int jb, int pb, int n_bands, int off_g, int off_tap, int smem, cudaStream_t stream) {
  auto kernel = pool_bwd_h_kernel<T, S, K>;
  if (smem > 48 * 1024) {
    const cudaError_t rc =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  kernel<<<(n + pb - 1) / pb * n_bands, THREADS, smem, stream>>>(yw, g, out, n, h, wo, ho, k, s, p,
                                                                 jb, n_bands, pb, off_g, off_tap);
  return (int)cudaGetLastError();
}

// Checks the arguments and the plan, then launches the instantiation for
// T, s and k; returns the CUDA error code.
template <class T>
int run(const void* yw, const void* g, void* out, int n, int h, int wo, int ho, int k, int s, int p,
        int jb, int pb, int off_g, int off_tap, int smem, void* stream) {
  constexpr int V = vec<T>();
  if (n <= 0 || h <= 0 || wo <= 0 || ho <= 0 || k <= 0 || k > KMAX || s <= 0 || p < 0 || p >= k ||
      jb <= 0 || pb <= 0 || off_g % V || off_tap % V || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const int n_bands = (h + jb - 1) / jb;
  if ((long)((n + pb - 1) / pb) * n_bands > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  for (int b = 0; b < n_bands; ++b) {
    const Band t = band_of(b, jb, h, ho, k, s, p);
    if (pb > 1 && (n_bands > 1 || t.o_lo != 0 || t.o_hi != ho)) return (int)cudaErrorInvalidValue;
    const long n_win = ((long)(pb - 1) * ho + t.o_hi - t.o_lo) * wo;
    const long n_y = ((long)(pb - 1) * h + t.y_hi - t.y_lo) * wo;
    if (span_room<T>(n_y) > off_g || off_g + span_room<T>(n_win) > off_tap ||
        (long)sizeof(T) * off_tap + n_win > smem)
      return (int)cudaErrorInvalidValue;
  }
  const auto* a = (const T*)yw;
  const auto* b = (const T*)g;
  auto* o = (T*)out;
  const auto st = (cudaStream_t)stream;
#define POOL_BWD_H(S, K) \
  launch<T, S, K>(a, b, o, n, h, wo, ho, k, s, p, jb, pb, n_bands, off_g, off_tap, smem, st)
  if (k == 3) return s == 1 ? POOL_BWD_H(1, 3) : s == 2 ? POOL_BWD_H(2, 3) : POOL_BWD_H(0, 3);
  return s == 1 ? POOL_BWD_H(1, 0) : s == 2 ? POOL_BWD_H(2, 0) : POOL_BWD_H(0, 0);
#undef POOL_BWD_H
}


// ---- bfloat16 -------------------------------------------------------------

using namespace pool_runs;

// One run of the bfloat16 block: rows j0 .. j0 + RUN - 1 of columns col and
// col + 1 of one plane (sy, sg, so: the plane's staged rows, windows and
// routed rows).  Whole runs inside the band's staged rows and windows load
// and store without tests; the others (at a plane's ends, or past the end
// of a band that is no multiple of RUN rows) test every row and window.
template <int S, int K, int PHI>
__device__ __forceinline__ void run_h(const unsigned short* sy, const unsigned short* sg, unsigned short* so,
                                      const Band& t, int wo, int p, int j0, int col) {
  using R = RunGeom<S, K, PHI>;
  const int o0 = (j0 + p - PHI) / S;
  const unsigned short* ys = sy + (j0 - t.y_lo) * wo + col;
  const unsigned short* gs = sg + (o0 - t.o_lo) * wo + col;
  unsigned short* os = so + (j0 - t.j0) * wo + col;
  auto g_in = [&](int m) { return pack2(gs[m * wo], gs[m * wo + 1]); };
  if (j0 + RUN <= t.j1 && col + 1 < wo && j0 + R::LO >= t.y_lo && j0 + R::LO + R::NV <= t.y_hi &&
      o0 + R::M_MIN >= t.o_lo && o0 + R::M_MAX < t.o_hi) {
    route_run<S, K, PHI>(
        [&](int d, unsigned& v, unsigned& ok) {
          v = pack2(ys[d * wo], ys[d * wo + 1]);
          ok = ~0u;
        },
        g_in,
        [&](int e, unsigned a) {
          os[e * wo] = (unsigned short)a;
          os[e * wo + 1] = (unsigned short)(a >> 16);
        });
  } else {
    const int n_rows = t.j1 - j0;
    const bool hi = col + 1 < wo;  // else the pair's second lane holds no column of the plane
    route_run<S, K, PHI>(
        [&](int d, unsigned& v, unsigned& ok) {
          const bool in = j0 + d >= t.y_lo && j0 + d < t.y_hi;
          const unsigned a = pack2(ys[(in ? d : t.y_lo - j0) * wo], ys[(in ? d : t.y_lo - j0) * wo + 1]);
          v = in ? a : NEG_INF2;
          ok = in ? ~0u : 0u;
        },
        [&](int m) {
          const bool in = o0 + m >= t.o_lo && o0 + m < t.o_hi;
          const unsigned a = g_in(in ? m : t.o_lo - o0);
          return in ? a : 0u;
        },
        [&](int e, unsigned a) {
          if (e < n_rows) {
            os[e * wo] = (unsigned short)a;
            if (hi) os[e * wo + 1] = (unsigned short)(a >> 16);
          }
        });
  }
}

// S, K: the stride and the window of the runs, or 0 for any (then every
// element is routed alone, route_direct).
template <int S, int K>
__global__ void __launch_bounds__(THREADS)
    pool_bwd_h_bf16_kernel(const __nv_bfloat16* __restrict__ yw, const __nv_bfloat16* __restrict__ g,
                           __nv_bfloat16* __restrict__ out, int n, int h, int wo, int ho, int k, int s, int p,
                           int jb, int n_bands, int pb, int off_g, int off_out) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem4);
  const int tid = threadIdx.x;
  const int group = blockIdx.x / n_bands;
  const size_t n0 = (size_t)group * pb;
  const int np = n - n0 < (size_t)pb ? (int)(n - n0) : pb;
  const Band t = band_of((int)blockIdx.x - group * n_bands, jb, h, ho, k, s, p);
  const int y_plane = h * wo, g_plane = ho * wo;
  const __nv_bfloat16* sy = smem + stage_span(smem, yw + (n0 * h + t.y_lo) * wo,
                                              (np - 1) * y_plane + (t.y_hi - t.y_lo) * wo, tid);
  const __nv_bfloat16* sg = smem + off_g + stage_span(smem + off_g, g + (n0 * ho + t.o_lo) * wo,
                                                      (np - 1) * g_plane + (t.o_hi - t.o_lo) * wo, tid);
  __nv_bfloat16* dst = out + (n0 * h + t.j0) * wo;
  __nv_bfloat16* so = smem + off_out + lead_of(dst);
  cp_async_wait_all();
  __syncthreads();

  if constexpr (S > 0 && K > 0) {
    // runs: plane q, run σ of the band, column pair; pairs fastest
    const int n_runs = (t.j1 - t.j0 + RUN - 1) / RUN;
    const int n_pairs = (wo + 1) / 2;
    const int phi = S > 1 ? (t.j0 + p) % S : 0;  // the same for every run of the band
    Walk it(tid, n_pairs);
    int q = 0, run = it.row;  // it.row = q * n_runs + run, kept without a division per item
    while (run >= n_runs) run -= n_runs, ++q;
    for (int f = tid; f < np * n_runs * n_pairs; f += THREADS) {
      const int j0 = t.j0 + run * RUN;
      // a plane's last pair of an odd width overlaps the one before it
      const int col = wo > 1 && 2 * it.col > wo - 2 ? wo - 2 : 2 * it.col;
      const auto* ys = reinterpret_cast<const unsigned short*>(sy) + q * y_plane;
      const auto* gs = reinterpret_cast<const unsigned short*>(sg) + q * g_plane;
      auto* os = reinterpret_cast<unsigned short*>(so) + q * y_plane;
      if (phi == 0)
        run_h<S, K, 0>(ys, gs, os, t, wo, p, j0, col);
      else
        run_h<S, K, (S > 1 ? 1 : 0)>(ys, gs, os, t, wo, p, j0, col);
      const int row = it.row;
      it.next();
      for (run += it.row - row; run >= n_runs; run -= n_runs) ++q;
    }
  } else {
    const int n_el = (t.j1 - t.j0) * wo;
    const Walk first(tid, wo);
    for (int q = 0; q < np; ++q) {
      Walk el = first;
      for (int f = tid; f < n_el; f += THREADS, el.next())
        so[q * y_plane + f] = route_direct<K>(sy + q * y_plane + el.col, wo, t.y_lo, h, sg + q * g_plane + el.col,
                                              wo, t.o_lo, ho, t.j0 + el.row, p, k, s);
    }
  }
  __syncthreads();
  unstage_span(dst, smem + off_out, (np - 1) * y_plane + (t.j1 - t.j0) * wo, tid);
}

template <int S, int K>
int launch_bf16(const __nv_bfloat16* yw, const __nv_bfloat16* g, __nv_bfloat16* out, int n, int h, int wo,
                int ho, int k, int s, int p, int jb, int pb, int n_bands, int off_g, int off_out, int smem,
                cudaStream_t stream) {
  auto kernel = pool_bwd_h_bf16_kernel<S, K>;
  if (smem > 48 * 1024) {
    const cudaError_t rc =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  kernel<<<(n + pb - 1) / pb * n_bands, THREADS, smem, stream>>>(yw, g, out, n, h, wo, ho, k, s, p, jb,
                                                                 n_bands, pb, off_g, off_out);
  return (int)cudaGetLastError();
}

// The bfloat16 layout: the staged rows of yw at element 0, the windows of g
// at off_g, the band's routed rows at off_out, each with room for any lead.
int run_bf16(const void* yw, const void* g, void* out, int n, int h, int wo, int ho, int k, int s, int p,
             int jb, int pb, int off_g, int off_out, int smem, void* stream) {
  using T = __nv_bfloat16;
  constexpr int V = vec<T>();
  if (n <= 0 || h <= 0 || wo <= 0 || ho <= 0 || k <= 0 || k > KMAX || s <= 0 || p < 0 || p >= k ||
      jb <= 0 || pb <= 0 || off_g % V || off_out % V || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const int n_bands = (h + jb - 1) / jb;
  if ((long)((n + pb - 1) / pb) * n_bands > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  for (int b = 0; b < n_bands; ++b) {
    const Band t = band_of(b, jb, h, ho, k, s, p);
    if (pb > 1 && (n_bands > 1 || t.o_lo != 0 || t.o_hi != ho)) return (int)cudaErrorInvalidValue;
    const long n_win = ((long)(pb - 1) * ho + t.o_hi - t.o_lo) * wo;
    const long n_y = ((long)(pb - 1) * h + t.y_hi - t.y_lo) * wo;
    const long n_out = ((long)(pb - 1) * h + t.j1 - t.j0) * wo;
    // (a run of a plane one column wide reads one element past a span: the
    // next span's, unused)
    if (span_room<T>(n_y) > off_g || off_g + span_room<T>(n_win) > off_out ||
        (long)sizeof(T) * (off_out + span_room<T>(n_out)) > smem)
      return (int)cudaErrorInvalidValue;
  }
  const auto* a = (const T*)yw;
  const auto* b = (const T*)g;
  auto* o = (T*)out;
  const auto st = (cudaStream_t)stream;
#define POOL_BWD_H_BF16(S, K) \
  launch_bf16<S, K>(a, b, o, n, h, wo, ho, k, s, p, jb, pb, n_bands, off_g, off_out, smem, st)
  if (k == 3 && s == 1) return POOL_BWD_H_BF16(1, 3);
  if (k == 3 && s == 2) return POOL_BWD_H_BF16(2, 3);
  return k == 3 ? POOL_BWD_H_BF16(0, 3) : POOL_BWD_H_BF16(0, 0);
#undef POOL_BWD_H_BF16
}

}  // namespace

// Return the CUDA error code of the launch (0 on success; invalid value for
// k > KMAX or a plan whose shared memory is too small for its tiles).  yw, g
// and out are contiguous, float (pool_bwd_h) or bfloat16 (pool_bwd_h_bf16);
// a block takes jb rows of each of pb planes (pb > 1 only with jb = h and
// every window reaching into the plane), with the cotangent rows at element
// off_g and, in float, the taps at element off_tap (in bfloat16 the routed
// rows at element off_out) of smem bytes of shared memory, as plan_h lays
// them out.
extern "C" int pool_bwd_h(const void* yw, const void* g, void* out, int n, int h, int wo, int ho,
                          int k, int s, int p, int jb, int pb, int off_g, int off_tap, int smem,
                          void* stream) {
  return run<float>(yw, g, out, n, h, wo, ho, k, s, p, jb, pb, off_g, off_tap, smem, stream);
}

extern "C" int pool_bwd_h_bf16(const void* yw, const void* g, void* out, int n, int h, int wo,
                               int ho, int k, int s, int p, int jb, int pb, int off_g, int off_out,
                               int smem, void* stream) {
  return run_bf16(yw, g, out, n, h, wo, ho, k, s, p, jb, pb, off_g, off_out, smem, stream);
}
