// Backward of the W pass of the separable Caffe max pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel dsrg_tpu/ops/pallas_pool.py::pool_bwd_w
// (_bwd_w_kernel -> _route_1d).  NCHW rows, R = batch x channels x H, all
// in one element type T, float or bfloat16 (the JAX kernel's output takes
// the cotangent's dtype): x (R, W) is the raw pool input, gw (R, Wo) the
// cotangent of the W pass (what pool_bwd_h returns), gx (R, W) the routed
// cotangent
//
//   gx[r, j] = sum_{t = 0..k-1} [(j + p - t) % s == 0, window o = (j + p - t) / s in [0, Wo)]
//                * [x[r, j] == max of window o]
//                * [no tap t' < t of window o equals that max]
//                * gw[r, o]
//
// Window o covers columns o*s - p .. o*s - p + k - 1; columns outside
// [0, W) are the -inf halo and never hit.  Every window's cotangent goes to
// its first maximum in scan order (Caffe's stored argmax, XLA's
// SelectAndScatter order), a window whose maximum is NaN routes nothing, and
// the taps are summed in the order t = 0..k-1 as _route_1d sums them, each
// sum rounded to T, so the result is bit-identical to the JAX kernel on any
// data.
//
// Bound on the H100: bytes.  The pass does a few compares per element and
// must read x and gw and write gx once (pool1 at batch 20 @ 321^2: 1.3 GB
// in float, 0.66 GB in bfloat16, ~0.4 / ~0.2 ms at 3.35 TB/s); at that rate
// an SM's schedulers start about 85 warp operations for every 32 float
// elements (half as many for bfloat16), so the design counts operations as
// much as bytes.
//
// A block owns rb whole rows (planned in ops/pool_kernels.py::plan_w).
// Routing along W never leaves a row, so a tile has no halo, and rb rows of
// x, of gw and of gx are each one contiguous span of device memory, staged
// into shared memory once with 16-byte asynchronous copies although a row
// (321, 161, 81 or 41 elements) is never a multiple of 16 bytes
// (pool_route.cuh; a tile of the same bytes holds twice as many bfloat16
// rows).  gw is read at column (j + p - t) / s; the JAX version's repeat of
// gw to the input width is never materialised.  Then the work is
// window-centric:
//   pass 1, over the tile's windows: the tap of the window's first maximum
//     from k shared-memory reads along its row, one byte per window;
//   pass 2, over the tile's elements: the cotangents of the <= ceil(k / s)
//     windows that hold the element and whose first tap it is, in tap order,
//     and one coalesced store per element (staging the float results in
//     shared memory for 16-byte stores was no faster at any pool).
// Most warps of pass 1 hold a window at a row's edge, so all windows take the
// path that tests for the halo (first_max_tap's INSIDE path was slower here).
// Threads walk a tile by flat position with row and column as loop
// variables (one division per thread and pass, none per element); a tile's
// base is 64-bit, offsets inside it are 32-bit.  Stride and window are
// template arguments (s = 1, 2; k = 3).  Loads overlap stores across the
// blocks that are resident on an SM (tiles of ~32 KB, 256 threads), not
// inside a block.
//
// bfloat16 (pool_bwd_w_bf16) has a block of its own: the same row tiles and
// staging, but a thread owns a run of RUN columns of two neighbouring rows
// as one packed pair (pool_runs.cuh): the run's columns and the k - 1 on
// either side are loaded once into registers, the run's windows (5 at
// s = 2, 10 at s = 1) are computed once each for both rows, and the
// cotangents are added in packed bfloat16 in tap order.  Threads
// next to each other take the next pair of rows, 2w elements (w words)
// further in shared memory, so for an odd w the 16 lanes of a half-warp fall
// in 16 banks, one of each pair b, b + 16.  A warp whose lanes reach from one
// run of columns into the next would otherwise meet its own banks again (the
// next run is 4 words on, and with fewer than 32 row pairs per block most
// warps do), so the runs are taken in the order 0, 4, 8, ..., 1, 5, ...: a
// warp's second half then works 16 words on, in the other bank of each pair,
// wherever the block's row pairs are a multiple of 16 (plan_w makes the rows
// a multiple of W_ROWS = 32).  A row's last run reaches past its end; those
// positions are -inf and are not stored.  The routed rows go to shared memory laid out as the
// output and leave in 16-byte stores.

#include "pool_route.cuh"
#include "pool_runs.cuh"

namespace {

using namespace pool_route;

// plan_w (ops/pool_kernels.py, which keeps a copy that the CPU tests hold
// equal) rounds a bfloat16 block's rows down to a multiple of this: 16 row
// pairs, for the bank argument above.
constexpr int W_ROWS = 32;

// S, K: the stride and the window if known at compile time, else 0
template <class T, int S, int K>
__global__ void __launch_bounds__(THREADS)
    pool_bwd_w_kernel(const T* __restrict__ x, const T* __restrict__ gw, T* __restrict__ out,
                      int rows, int w, int wo, int k_arg, int s_arg, int p, int rb, int off_g,
                      int off_tap) {
  extern __shared__ float4 smem4[];
  T* smem = reinterpret_cast<T*>(smem4);
  const int k = K > 0 ? K : k_arg;
  const int s = S > 0 ? S : s_arg;
  const int tid = threadIdx.x;
  const size_t r0 = (size_t)blockIdx.x * rb;
  const int nr = rows - r0 < (size_t)rb ? (int)(rows - r0) : rb;
  const int n_win = nr * wo;
  const int n_el = nr * w;

  const T* sx = smem + stage_span(smem, x + r0 * w, n_el, tid);
  const T* sg = smem + off_g + stage_span(smem + off_g, gw + r0 * wo, n_win, tid);
  signed char* stap = reinterpret_cast<signed char*>(smem + off_tap);
  cp_async_wait_all();
  __syncthreads();

  Walk win(tid, wo);
  for (int f = tid; f < n_win; f += THREADS, win.next())
    stap[f] = (signed char)first_max_tap<K, false>(sx + win.row * w, 1, 0, win.col * s - p, w, k);
  __syncthreads();

  T* dst = out + r0 * w;
  Walk el(tid, w);
  for (int f = tid; f < n_el; f += THREADS, el.next())
    dst[f] = route<S, K>(stap + el.row * wo, sg + el.row * wo, 1, 0, wo, el.col, p, k, s);
}

template <class T, int S, int K>
int launch(const T* x, const T* gw, T* out, int rows, int w, int wo, int k, int s, int p, int rb,
           int off_g, int off_tap, int smem, cudaStream_t stream) {
  auto kernel = pool_bwd_w_kernel<T, S, K>;
  if (smem > 48 * 1024) {
    const cudaError_t rc =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const int tiles = (rows + rb - 1) / rb;
  kernel<<<tiles, THREADS, smem, stream>>>(x, gw, out, rows, w, wo, k, s, p, rb, off_g, off_tap);
  return (int)cudaGetLastError();
}

// Checks the arguments and the plan, then launches the instantiation for
// T, s and k; returns the CUDA error code.
template <class T>
int run(const void* x, const void* gw, void* out, int rows, int w, int wo, int k, int s, int p,
        int rb, int off_g, int off_tap, int smem, void* stream) {
  constexpr int V = vec<T>();
  if (rows <= 0 || w <= 0 || wo <= 0 || k <= 0 || k > KMAX || s <= 0 || p < 0 || p >= k ||
      rb <= 0 || off_g % V || off_tap % V || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const long n_el = (long)rb * w, n_win = (long)rb * wo;
  if (span_room<T>(n_el) > off_g || off_g + span_room<T>(n_win) > off_tap ||
      (long)sizeof(T) * off_tap + n_win > smem)
    return (int)cudaErrorInvalidValue;
  const auto* a = (const T*)x;
  const auto* b = (const T*)gw;
  auto* o = (T*)out;
  const auto st = (cudaStream_t)stream;
#define POOL_BWD_W(S, K) launch<T, S, K>(a, b, o, rows, w, wo, k, s, p, rb, off_g, off_tap, smem, st)
  if (k == 3) return s == 1 ? POOL_BWD_W(1, 3) : s == 2 ? POOL_BWD_W(2, 3) : POOL_BWD_W(0, 3);
  return s == 1 ? POOL_BWD_W(1, 0) : s == 2 ? POOL_BWD_W(2, 0) : POOL_BWD_W(0, 0);
#undef POOL_BWD_W
}


// ---- bfloat16 -------------------------------------------------------------

using namespace pool_runs;

// One run of the bfloat16 block: columns j0 .. j0 + RUN - 1 of the rows
// whose staged x, gw and routed gx start at x0 / g0 / o0 (lane 0) and
// x1 / g1 / o1 (lane 1).  Runs whose columns and windows all lie inside the
// row load and store without tests.
template <int S, int K, int PHI>
__device__ __forceinline__ void run_w(const unsigned short* x0, const unsigned short* x1,
                                      const unsigned short* g0, const unsigned short* g1,
                                      unsigned short* y0, unsigned short* y1, int w, int wo, int p, int j0) {
  using R = RunGeom<S, K, PHI>;
  const int o0 = (j0 + p - PHI) / S;
  auto store = [&](int e, unsigned a) {
    y0[j0 + e] = (unsigned short)a;
    y1[j0 + e] = (unsigned short)(a >> 16);
  };
  if (j0 + R::LO >= 0 && j0 + R::LO + R::NV <= w && o0 + R::M_MIN >= 0 && o0 + R::M_MAX < wo) {
    // (then the run's RUN columns are inside the row too)
    route_run<S, K, PHI>(
        [&](int d, unsigned& v, unsigned& ok) {
          v = pack2(x0[j0 + d], x1[j0 + d]);
          ok = ~0u;
        },
        [&](int m) { return pack2(g0[o0 + m], g1[o0 + m]); }, store);
  } else {
    route_run<S, K, PHI>(
        [&](int d, unsigned& v, unsigned& ok) {
          const bool in = j0 + d >= 0 && j0 + d < w;
          const unsigned a = pack2(x0[in ? j0 + d : 0], x1[in ? j0 + d : 0]);
          v = in ? a : NEG_INF2;
          ok = in ? ~0u : 0u;
        },
        [&](int m) {
          const bool in = o0 + m >= 0 && o0 + m < wo;
          const unsigned a = pack2(g0[in ? o0 + m : 0], g1[in ? o0 + m : 0]);
          return in ? a : 0u;
        },
        [&](int e, unsigned a) {
          if (j0 + e < w) store(e, a);
        });
  }
}

// S, K: the stride and the window of the runs, or 0 for any (then every
// element is routed alone, route_direct).
template <int S, int K>
__global__ void __launch_bounds__(THREADS)
    pool_bwd_w_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ gw,
                           __nv_bfloat16* __restrict__ out, int rows, int w, int wo, int k, int s, int p,
                           int rb, int off_g, int off_out) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem4);
  const int tid = threadIdx.x;
  const size_t r0 = (size_t)blockIdx.x * rb;
  const int nr = rows - r0 < (size_t)rb ? (int)(rows - r0) : rb;

  const __nv_bfloat16* sx = smem + stage_span(smem, x + r0 * w, nr * w, tid);
  const __nv_bfloat16* sg = smem + off_g + stage_span(smem + off_g, gw + r0 * wo, nr * wo, tid);
  __nv_bfloat16* dst = out + r0 * w;
  __nv_bfloat16* so = smem + off_out + lead_of(dst);
  cp_async_wait_all();
  __syncthreads();

  if constexpr (S > 0 && K > 0) {
    // runs: run σ of a row, then the row pair; pairs fastest.  Lane 1 of the
    // last pair of an odd row count repeats its lane 0.
    const int half = (nr + 1) / 2;
    const int n_runs = (w + RUN - 1) / RUN;
    const auto* xs = reinterpret_cast<const unsigned short*>(sx);
    const auto* gs = reinterpret_cast<const unsigned short*>(sg);
    auto* os = reinterpret_cast<unsigned short*>(so);
    Walk it(tid, half);
    for (int f = tid; f < n_runs * half; f += THREADS, it.next()) {
      const int ra = 2 * it.col, rz = ra + 1 < nr ? ra + 1 : ra;
      int run = it.row;  // the run's place in the order 0, 4, 8, ..., 1, 5, ...
      for (int c = 0; c < 4; ++c) {
        const int in_class = (n_runs - c + 3) / 4;
        if (run < in_class) {
          run = c + 4 * run;
          break;
        }
        run -= in_class;
      }
      const int j0 = run * RUN;
      if (S == 1 || p % S == 0)
        run_w<S, K, 0>(xs + ra * w, xs + rz * w, gs + ra * wo, gs + rz * wo, os + ra * w, os + rz * w, w, wo, p, j0);
      else
        run_w<S, K, (S > 1 ? 1 : 0)>(xs + ra * w, xs + rz * w, gs + ra * wo, gs + rz * wo, os + ra * w,
                                     os + rz * w, w, wo, p, j0);
    }
  } else {
    Walk el(tid, w);
    for (int f = tid; f < nr * w; f += THREADS, el.next())
      so[f] = route_direct<K>(sx + el.row * w, 1, 0, w, sg + el.row * wo, 1, 0, wo, el.col, p, k, s);
  }
  __syncthreads();
  unstage_span(dst, smem + off_out, nr * w, tid);
}

template <int S, int K>
int launch_bf16(const __nv_bfloat16* x, const __nv_bfloat16* gw, __nv_bfloat16* out, int rows, int w, int wo,
                int k, int s, int p, int rb, int off_g, int off_out, int smem, cudaStream_t stream) {
  auto kernel = pool_bwd_w_bf16_kernel<S, K>;
  if (smem > 48 * 1024) {
    const cudaError_t rc =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const int tiles = (rows + rb - 1) / rb;
  kernel<<<tiles, THREADS, smem, stream>>>(x, gw, out, rows, w, wo, k, s, p, rb, off_g, off_out);
  return (int)cudaGetLastError();
}

// The bfloat16 layout: rb rows of x at element 0, of gw at off_g, of the
// routed gx at off_out, each with room for any lead.
int run_bf16(const void* x, const void* gw, void* out, int rows, int w, int wo, int k, int s, int p, int rb,
             int off_g, int off_out, int smem, void* stream) {
  using T = __nv_bfloat16;
  constexpr int V = vec<T>();
  if (rows <= 0 || w <= 0 || wo <= 0 || k <= 0 || k > KMAX || s <= 0 || p < 0 || p >= k || rb <= 0 ||
      off_g % V || off_out % V || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const long n_el = (long)rb * w, n_win = (long)rb * wo;
  if (span_room<T>(n_el) > off_g || off_g + span_room<T>(n_win) > off_out ||
      (long)sizeof(T) * (off_out + span_room<T>(n_el)) > smem)
    return (int)cudaErrorInvalidValue;
  const auto* a = (const T*)x;
  const auto* b = (const T*)gw;
  auto* o = (T*)out;
  const auto st = (cudaStream_t)stream;
#define POOL_BWD_W_BF16(S, K) launch_bf16<S, K>(a, b, o, rows, w, wo, k, s, p, rb, off_g, off_out, smem, st)
  if (k == 3 && s == 1) return POOL_BWD_W_BF16(1, 3);
  if (k == 3 && s == 2) return POOL_BWD_W_BF16(2, 3);
  return k == 3 ? POOL_BWD_W_BF16(0, 3) : POOL_BWD_W_BF16(0, 0);
#undef POOL_BWD_W_BF16
}

}  // namespace

// Return the CUDA error code of the launch (0 on success; invalid value for
// k > KMAX or a plan whose shared memory is too small for its rows).  x, gw
// and out are contiguous, float (pool_bwd_w) or bfloat16 (pool_bwd_w_bf16);
// rb rows per block, the cotangent rows at element off_g and, in float, the
// taps at element off_tap (in bfloat16 the routed rows at element off_out)
// of smem bytes of shared memory, as plan_w lays them out.
extern "C" int pool_bwd_w(const void* x, const void* gw, void* out, int rows, int w, int wo, int k,
                          int s, int p, int rb, int off_g, int off_tap, int smem, void* stream) {
  return run<float>(x, gw, out, rows, w, wo, k, s, p, rb, off_g, off_tap, smem, stream);
}

extern "C" int pool_bwd_w_bf16(const void* x, const void* gw, void* out, int rows, int w, int wo,
                               int k, int s, int p, int rb, int off_g, int off_out, int smem,
                               void* stream) {
  return run_bf16(x, gw, out, rows, w, wo, k, s, p, rb, off_g, off_out, smem, stream);
}
