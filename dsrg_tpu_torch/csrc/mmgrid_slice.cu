// Slice of the matmul bilateral-grid (mmgrid) dense CRF, for Hopper (sm_90a).
//
// Replaces the TPU kernel dsrg_tpu/ops/crf/pallas_mmgrid.py::slice_fused
// (_slice_kernel).  For every spatial tile t:
//
//   tt[p, q]      = sum_b wbg[t, p, b] * slab[t, b, q]      (bf16 in, fp32 sum)
//   out[t, c, p]  = sum_r wr[t, r, p] * tt[p, r*C + c]      (fp32)
//
// slab (T, B = gc^2, Q = gc*C) bf16, out (T, C, px) f32: the transpose of the
// splat.  On the TPU that is a dense GEMM per tile, because the TPU has no
// gather.  But a row of wbg has 4 non-zeros (the bilinear corners
// lo_b*gc + lo_g, +1, +gc, +gc+1 of the pixel's colour) and a column of wr
// has 2 (bins lo_r, lo_r + 1), so out[t, c, p] is 8 products.  This kernel
// takes the non-zeros only and gathers:
//
//   idx (T, px) int32: lo_b*gc + lo_g in the low 16 bits, lo_r in the high 16;
//   wbg4 (T, 4, px) bf16: the corner weights, in the column order above;
//   wr2 (T, 2, px) bf16: the weights of bins lo_r and lo_r + 1.
//
// Each weight is the bf16 number the dense operand holds.  For each of the
// two r bins the four corners are summed in ascending b, then the two sums
// are weighted by wr: the nesting of the dense form, so the result differs
// from it by the order of at most 4 + 2 fp32 additions.
//
// Bound on the H100: bytes.  The output is written once (4*T*C*px bytes,
// 140 MB at the serving shape T = 1040, px = 1600, gc = C = 21), 16 bytes of
// index and weights are read per pixel (27 MB), and of the slab the cells
// that some pixel reaches are read once: at most 2*T*B*Q bytes (405 MB).
// How much of that depends on the guide: tiles of a few flat colours reach
// under a hundredth of it, pixel noise most of it.
// The 8*C multiply-adds per pixel take 0.008 ms at the card's fp32 rate.
//
// Design.  One thread per pixel, pixels across the lanes, so the index and
// weight loads and the (C, px) stores are coalesced along px.  A thread
// walks the C channels; for each it loads 8 bf16 values of the slab through
// the read-only cache.  The pixels of a warp lie side by side in a tile;
// where they mostly share their bins, the 32 lanes of such a load ask for a
// few distinct addresses and the load is served in a few transactions (on
// pixel noise each lane has its own and the kernel is several times
// slower: the mapping was chosen on synthetic guides); a tile's
// slab (395 KB) stays in L2 while its pixels are worked.  No shared memory,
// no atomics, nothing carried between threads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

__global__ void __launch_bounds__(THREADS)
slice_kernel(const int* __restrict__ idx, const __nv_bfloat16* __restrict__ wbg4,
             const __nv_bfloat16* __restrict__ wr2, const __nv_bfloat16* __restrict__ slab,
             float* __restrict__ out, long n_pixels, int px, int gc, int c) {
  const long i = (long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_pixels) return;
  const long t = i / px;
  const int p = (int)(i - t * px);
  float* o = out + t * c * px + p;

  const int word = idx[i];
  const int bg = word & 0xFFFF, lo_r = word >> 16;
  const int lo_b = bg / gc, lo_g = bg - lo_b * gc;
  if (lo_r < 0 || lo_r > gc - 2 || lo_b > gc - 2 || lo_g > gc - 2) {  // no such bin
    for (int ch = 0; ch < c; ++ch) o[(long)ch * px] = 0.0f;
    return;
  }
  float w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = ld(wbg4 + (t * 4 + k) * px + p);
  const float wr_lo = ld(wr2 + (t * 2) * px + p), wr_hi = ld(wr2 + (t * 2 + 1) * px + p);

  const int nq = gc * c;
  const __nv_bfloat16* s00 = slab + (t * gc * gc + bg) * nq + lo_r * c;  // (lo_b, lo_g), bin lo_r
  const __nv_bfloat16* s01 = s00 + nq;                                   // (lo_b, lo_g + 1)
  const __nv_bfloat16* s10 = s00 + (long)gc * nq;                        // (lo_b + 1, lo_g)
  const __nv_bfloat16* s11 = s10 + nq;                                   // (lo_b + 1, lo_g + 1)
  for (int ch = 0; ch < c; ++ch) {
    float lo = w[0] * ld(s00 + ch);
    lo = fmaf(w[1], ld(s01 + ch), lo);
    lo = fmaf(w[2], ld(s10 + ch), lo);
    lo = fmaf(w[3], ld(s11 + ch), lo);
    float hi = w[0] * ld(s00 + c + ch);
    hi = fmaf(w[1], ld(s01 + c + ch), hi);
    hi = fmaf(w[2], ld(s10 + c + ch), hi);
    hi = fmaf(w[3], ld(s11 + c + ch), hi);
    o[(long)ch * px] = fmaf(wr_hi, hi, wr_lo * lo);
  }
}

}  // namespace

// Returns the CUDA error code of the launch (0 on success).  All arrays are
// contiguous; a pixel with a bin outside [0, gc - 2] gets zeros.
extern "C" int mmgrid_slice(const void* idx, const void* wbg4, const void* wr2, const void* slab,
                            void* out, int n_tiles, int px, int gc, int c, void* stream) {
  if (n_tiles <= 0 || px <= 0 || gc < 2 || gc > 255 || c <= 0) return (int)cudaErrorInvalidValue;
  const long n_pixels = (long)n_tiles * px;
  const long n_blocks = (n_pixels + THREADS - 1) / THREADS;
  if (n_blocks > 0x7FFFFFFFL) return (int)cudaErrorInvalidValue;
  slice_kernel<<<(unsigned)n_blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)idx, (const __nv_bfloat16*)wbg4, (const __nv_bfloat16*)wr2,
      (const __nv_bfloat16*)slab, (float*)out, n_pixels, px, gc, c);
  return (int)cudaGetLastError();
}
