// Splat of the matmul bilateral-grid (mmgrid) dense CRF, for Hopper (sm_90a).
//
// Replaces the TPU kernel dsrg_tpu/ops/crf/pallas_mmgrid.py::splat_fused
// (_splat_kernel).  For every spatial tile t:
//
//   out[t, b, q] = sum_p wbg[t, p, b] * u[t, p, q]
//   u[t, p, r*C + c] = bf16( bf16(values[t, c, p]) * wr[t, r, p] )
//
// wbg (T, px, B) bf16 with row stride ldw (a multiple of 8), values
// (T, C, px) f32, wr (T, gc, px) bf16, out (T, B, Q = gc*C) f32.  The
// product of two bf16 numbers is exact in fp32, so u rounds once, to
// nearest even, as the TPU kernel's ``.astype(bf16)`` does; the GEMM
// accumulates in fp32.
//
// Bound on the H100: at the serving geometry (px = 1600, B = Q = 441) the
// tile GEMM has 2*px*B*Q = 0.62 GFLOP against 1.4 MB of wbg and 0.78 MB of
// output, ~290 FLOP per byte: on the line between the bf16 tensor-core rate
// and the memory rate.  The design keeps the operand u out of device memory
// (built in shared memory from the 21-wide values and r-weights, with the
// column -> (r, c) decode done once per block, no 0/1 tile/expand matrices)
// and runs the GEMM on the tensor cores with wmma bf16 16x16x16 fragments.
// A block owns a 128 (b) x 64 (q) output tile of one spatial tile; eight
// warps each hold 32x32 of it.  Operands move in 16-byte loads into
// double-buffered shared memory, the next step's loads in flight while the
// tensor cores work on the current step.  TMA, wgmma and the sparsity of
// wbg (4 of 441 columns per pixel) and wr (2 of 21 bins) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;

namespace {

constexpr int BM = 128;  // grid rows b per block
constexpr int BN = 64;   // wide columns q = r*C + c per block
constexpr int BK = 32;   // pixels per step
constexpr int LDA = BM + 8;  // bf16 shared rows: multiples of 8 keep fragments 32-byte aligned
constexpr int LDU = BN + 8;
constexpr int LDC = BN + 4;  // f32 shared row
constexpr int THREADS = 256;
constexpr int A_TILE = BK * LDA;
constexpr int U_TILE = BK * LDU;
constexpr int PIPE_BYTES = 2 * (A_TILE + U_TILE) * 2;
constexpr int C_BYTES = BM * LDC * 4;
constexpr int SMEM_BYTES = PIPE_BYTES > C_BYTES ? PIPE_BYTES : C_BYTES;
static_assert(SMEM_BYTES <= 48 * 1024, "static shared memory");

union Pack8 {  // eight bf16 values (raw bits) moved as one 16-byte word
  uint4 u;
  unsigned short h[8];
};

struct Staged {  // one thread's share of one step's operands, held in registers
  Pack8 a[2];
  float v[8];
  Pack8 w;
};

__device__ __forceinline__ void load_step(Staged& s, const __nv_bfloat16* wbg_t, int ldw,
                                          const float* v_row, const __nv_bfloat16* wr_row,
                                          bool col_ok, int p0, int b0, int px, int nb,
                                          bool vec_p) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // A: BK rows x BM cols as 8-wide segments
    const int idx = threadIdx.x + i * THREADS;
    const int k = idx / (BM / 8), b = b0 + (idx % (BM / 8)) * 8;
    const int p = p0 + k;
    const __nv_bfloat16* src = wbg_t + (long)p * ldw + b;
    if (p < px && b + 8 <= nb) {
      s.a[i].u = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) s.a[i].h[j] = (p < px && b + j < nb) ? __bfloat16_as_ushort(src[j]) : 0;
    }
  }
  // u: this thread's column n, pixels kg*8 .. kg*8+7 of the step
  const int p = p0 + (threadIdx.x / BN) * 8;
  if (col_ok && vec_p && p < px) {
    const float4 v0 = *reinterpret_cast<const float4*>(v_row + p);
    const float4 v1 = *reinterpret_cast<const float4*>(v_row + p + 4);
    s.v[0] = v0.x; s.v[1] = v0.y; s.v[2] = v0.z; s.v[3] = v0.w;
    s.v[4] = v1.x; s.v[5] = v1.y; s.v[6] = v1.z; s.v[7] = v1.w;
    s.w.u = *reinterpret_cast<const uint4*>(wr_row + p);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool ok = col_ok && p + j < px;
      s.v[j] = ok ? v_row[p + j] : 0.0f;
      s.w.h[j] = ok ? __bfloat16_as_ushort(wr_row[p + j]) : 0;
    }
  }
}

__device__ __forceinline__ void store_step(const Staged& s, __nv_bfloat16* a_s,
                                           __nv_bfloat16* u_s) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int k = idx / (BM / 8), m = (idx % (BM / 8)) * 8;
    *reinterpret_cast<uint4*>(a_s + k * LDA + m) = s.a[i].u;
  }
  const int n = threadIdx.x % BN, k0 = (threadIdx.x / BN) * 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float v = __bfloat162float(__float2bfloat16_rn(s.v[j]));
    u_s[(k0 + j) * LDU + n] = __float2bfloat16_rn(v * __bfloat162float(__ushort_as_bfloat16(s.w.h[j])));
  }
}

__global__ void __launch_bounds__(THREADS)
splat_kernel(const __nv_bfloat16* __restrict__ wbg, int ldw, const float* __restrict__ values,
             const __nv_bfloat16* __restrict__ wr, float* __restrict__ out,
             int px, int nb, int c, int gc, int n_btiles, bool vec_p) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __nv_bfloat16* a_buf = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][BK][LDA]
  __nv_bfloat16* u_buf = a_buf + 2 * A_TILE;                       // [2][BK][LDU]
  float* c_s = reinterpret_cast<float*>(smem);                     // [BM][LDC], after the loop

  const int nq = gc * c;
  const int b0 = (blockIdx.x % n_btiles) * BM;
  const int q0 = (blockIdx.x / n_btiles) * BN;
  const long t = blockIdx.y;
  const __nv_bfloat16* wbg_t = wbg + t * px * ldw;
  // this thread's u column, decoded once
  const int q = q0 + threadIdx.x % BN;
  const bool col_ok = q < nq;
  const int r = col_ok ? q / c : 0, ch = col_ok ? q - r * c : 0;
  const float* v_row = values + (t * c + ch) * px;
  const __nv_bfloat16* wr_row = wr + (t * gc + r) * px;

  const int warp = threadIdx.x / 32;
  const int wm = (warp % 4) * 32, wn = (warp / 4) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int n_steps = (px + BK - 1) / BK;
  Staged st;
  load_step(st, wbg_t, ldw, v_row, wr_row, col_ok, 0, b0, px, nb, vec_p);
  store_step(st, a_buf, u_buf);
  __syncthreads();
  for (int s = 0; s < n_steps; ++s) {
    const bool more = s + 1 < n_steps;
    if (more) load_step(st, wbg_t, ldw, v_row, wr_row, col_ok, (s + 1) * BK, b0, px, nb, vec_p);
    const __nv_bfloat16* a_s = a_buf + (s % 2) * A_TILE;
    const __nv_bfloat16* u_s = u_buf + (s % 2) * U_TILE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(af[i], a_s + kk * LDA + wm + i * 16, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(bf[j], u_s + kk * LDU + wn + j * 16, LDU);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    if (more) store_step(st, a_buf + ((s + 1) % 2) * A_TILE, u_buf + ((s + 1) % 2) * U_TILE);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(c_s + (wm + i * 16) * LDC + wn + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  float* out_t = out + t * nb * nq;
  for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
    const int n = idx % BN, m = idx / BN;
    const int b = b0 + m, qq = q0 + n;
    if (b < nb && qq < nq) out_t[(long)b * nq + qq] = c_s[m * LDC + n];
  }
}

}  // namespace

// Returns the CUDA error code of the launch (0 on success).  wbg rows are
// ldw elements apart; ldw and every base pointer must allow 16-byte loads.
extern "C" int mmgrid_splat(const void* wbg, int ldw, const void* values, const void* wr,
                            void* out, int n_tiles, int px, int nb, int c, int gc,
                            void* stream) {
  if (n_tiles <= 0 || n_tiles > 65535 || px <= 0 || nb <= 0 || c <= 0 || gc <= 0 ||
      ldw < nb || ldw % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int n_btiles = (nb + BM - 1) / BM;
  const int n_qtiles = (gc * c + BN - 1) / BN;
  dim3 grid(n_btiles * n_qtiles, n_tiles);
  splat_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)wbg, ldw, (const float*)values, (const __nv_bfloat16*)wr,
      (float*)out, px, nb, c, gc, n_btiles, px % 8 == 0);
  return (int)cudaGetLastError();
}
