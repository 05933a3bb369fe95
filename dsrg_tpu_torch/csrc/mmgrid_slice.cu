// Slice of the matmul bilateral-grid (mmgrid) dense CRF, for Hopper (sm_90a).
//
// Replaces the TPU kernel dsrg_tpu/ops/crf/pallas_mmgrid.py::slice_fused
// (_slice_kernel).  For every spatial tile t:
//
//   tt[p, q]      = sum_b wbg[t, p, b] * slab[t, b, q]      (bf16 in, fp32 sum)
//   out[t, c, p]  = sum_r wr[t, r, p] * tt[p, r*C + c]      (fp32)
//
// wbg (T, px, B) bf16 with row stride ldw, slab (T, B, Q = gc*C) bf16 with
// row stride lds (both multiples of 8), wr (T, gc, px) bf16, out (T, C, px)
// f32.  It is the exact transpose of the splat.
//
// Bound on the H100: at the serving geometry (px = 1600, B = Q = 441) the
// tile GEMM has 0.62 GFLOP against 1.4 MB of wbg, 0.39 MB of slab and
// 0.13 MB of output, ~320 FLOP per byte: bound by the bf16 tensor-core
// rate.  The design never writes tt to device memory: a block owns 128
// pixels of one tile and walks the Q columns in 64-wide chunks, each chunk
// a wmma bf16 GEMM over the full B depth (16-byte loads into
// double-buffered shared memory, the next step's loads in flight during the
// current step's MMAs), followed by the r-weighted sum into a (C, 128) fp32
// accumulator in shared memory.  Sums over r run in a fixed order (no
// atomics).  TMA, wgmma, keeping the wbg tile resident across Q chunks and
// the sparsity of wbg and wr are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128;  // pixels per block
constexpr int BN = 64;   // wide columns per chunk
constexpr int BK = 32;   // grid rows b per step
constexpr int LDA = BK + 8;  // bf16 shared rows: multiples of 8 keep fragments 32-byte aligned
constexpr int LDB = BN + 8;
constexpr int LDC = BM + 4;  // f32 shared, column-major chunk of tt
constexpr int THREADS = 256;
constexpr int A_TILE = BM * LDA;
constexpr int B_TILE = BK * LDB;
constexpr int PIPE_BYTES = 2 * (A_TILE + B_TILE) * 2;
constexpr int C_BYTES = BN * LDC * 4;
constexpr int TILE_BYTES = PIPE_BYTES > C_BYTES ? PIPE_BYTES : C_BYTES;

union Pack8 {  // eight bf16 values (raw bits) moved as one 16-byte word
  uint4 u;
  unsigned short h[8];
};

struct Staged {  // one thread's share of one step's operands, held in registers
  Pack8 a[2];
  Pack8 b;
};

__device__ __forceinline__ void load8(Pack8& dst, const __nv_bfloat16* src, bool row_ok, int col,
                                      int n_cols) {
  if (row_ok && col + 8 <= n_cols) {
    dst.u = *reinterpret_cast<const uint4*>(src);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      dst.h[j] = (row_ok && col + j < n_cols) ? __bfloat16_as_ushort(src[j]) : 0;
  }
}

__device__ __forceinline__ void load_step(Staged& s, const __nv_bfloat16* wbg_t, int ldw,
                                          const __nv_bfloat16* slab_t, int lds, int p0, int k0,
                                          int q0, int px, int nb, int nq) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // A: BM pixel rows x BK grid rows, 8-wide segments
    const int idx = threadIdx.x + i * THREADS;
    const int m = idx / (BK / 8), b = k0 + (idx % (BK / 8)) * 8;
    load8(s.a[i], wbg_t + (long)(p0 + m) * ldw + b, p0 + m < px, b, nb);
  }
  const int k = threadIdx.x / (BN / 8), q = q0 + (threadIdx.x % (BN / 8)) * 8;
  load8(s.b, slab_t + (long)(k0 + k) * lds + q, k0 + k < nb, q, nq);
}

__device__ __forceinline__ void store_step(const Staged& s, __nv_bfloat16* a_s,
                                           __nv_bfloat16* b_s) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int m = idx / (BK / 8), kk = (idx % (BK / 8)) * 8;
    *reinterpret_cast<uint4*>(a_s + m * LDA + kk) = s.a[i].u;
  }
  const int k = threadIdx.x / (BN / 8), n = (threadIdx.x % (BN / 8)) * 8;
  *reinterpret_cast<uint4*>(b_s + k * LDB + n) = s.b.u;
}

__global__ void __launch_bounds__(THREADS)
slice_kernel(const __nv_bfloat16* __restrict__ wbg, int ldw,
             const __nv_bfloat16* __restrict__ slab, int lds,
             const __nv_bfloat16* __restrict__ wr, float* __restrict__ out,
             int px, int nb, int c, int gc) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* a_buf = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][BM][LDA]
  __nv_bfloat16* b_buf = a_buf + 2 * A_TILE;                       // [2][BK][LDB]
  float* c_s = reinterpret_cast<float*>(smem);                     // [BN][LDC], between K loops
  float* acc_s = reinterpret_cast<float*>(smem + TILE_BYTES);      // [C][BM]

  const int nq = gc * c;
  const int p0 = blockIdx.x * BM;
  const long t = blockIdx.y;
  const __nv_bfloat16* wbg_t = wbg + t * px * ldw;
  const __nv_bfloat16* slab_t = slab + t * nb * lds;
  const __nv_bfloat16* wr_t = wr + t * gc * px;

  const int warp = threadIdx.x / 32;
  const int wm = (warp % 4) * 32, wn = (warp / 4) * 32;
  for (int idx = threadIdx.x; idx < c * BM; idx += THREADS) acc_s[idx] = 0.0f;
  const int n_steps = (nb + BK - 1) / BK;

  for (int q0 = 0; q0 < nq; q0 += BN) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    Staged st;
    load_step(st, wbg_t, ldw, slab_t, lds, p0, 0, q0, px, nb, nq);
    store_step(st, a_buf, b_buf);
    __syncthreads();
    for (int s = 0; s < n_steps; ++s) {
      const bool more = s + 1 < n_steps;
      if (more) load_step(st, wbg_t, ldw, slab_t, lds, p0, (s + 1) * BK, q0, px, nb, nq);
      const __nv_bfloat16* a_s = a_buf + (s % 2) * A_TILE;
      const __nv_bfloat16* b_s = b_buf + (s % 2) * B_TILE;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(af[i], a_s + (wm + i * 16) * LDA + kk, LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(bf[j], b_s + kk * LDB + wn + j * 16, LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
      }
      if (more) store_step(st, a_buf + ((s + 1) % 2) * A_TILE, b_buf + ((s + 1) % 2) * B_TILE);
      __syncthreads();
    }

    // the chunk of tt, column-major so the epilogue reads neighbouring pixels
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(c_s + (wn + j * 16) * LDC + wm + i * 16, acc[i][j], LDC,
                                wmma::mem_col_major);
    __syncthreads();
    // r-weighted epilogue: column q = r*C + ch of this chunk adds to (ch, p)
    const int q_end = min(q0 + BN, nq);
    for (int idx = threadIdx.x; idx < c * BM; idx += THREADS) {
      const int m = idx % BM, ch = idx / BM;
      const int p = p0 + m;
      if (p >= px) continue;
      float sum = 0.0f;
      for (int q = q0 + ((ch - q0 % c) + c) % c; q < q_end; q += c)
        sum += __bfloat162float(wr_t[(long)(q / c) * px + p]) * c_s[(q - q0) * LDC + m];
      acc_s[idx] += sum;
    }
    __syncthreads();
  }

  float* out_t = out + t * c * px;
  for (int idx = threadIdx.x; idx < c * BM; idx += THREADS) {
    const int m = idx % BM, ch = idx / BM;
    const int p = p0 + m;
    if (p < px) out_t[(long)ch * px + p] = acc_s[idx];
  }
}

}  // namespace

// Returns the CUDA error code of the launch (0 on success).  wbg rows are
// ldw and slab rows lds elements apart; both strides and every base pointer
// must allow 16-byte loads.
extern "C" int mmgrid_slice(const void* wbg, int ldw, const void* slab, int lds, const void* wr,
                            void* out, int n_tiles, int px, int nb, int c, int gc,
                            void* stream) {
  if (n_tiles <= 0 || n_tiles > 65535 || px <= 0 || nb <= 0 || c <= 0 || gc <= 0 ||
      ldw < nb || ldw % 8 != 0 || lds < gc * c || lds % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int smem = TILE_BYTES + c * BM * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(slice_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((px + BM - 1) / BM, n_tiles);
  slice_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)wbg, ldw, (const __nv_bfloat16*)slab, lds, (const __nv_bfloat16*)wr,
      (float*)out, px, nb, c, gc);
  return (int)cudaGetLastError();
}
