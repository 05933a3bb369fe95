// Splat of the matmul bilateral-grid (mmgrid) dense CRF, for Hopper (sm_90a).
//
// Replaces the TPU kernel dsrg_tpu/ops/crf/pallas_mmgrid.py::splat_fused
// (_splat_kernel).  For every spatial tile t:
//
//   out[t, b, r*C + c] = sum_p wbg[t, p, b] * u[t, p, r*C + c]
//   u[t, p, r*C + c]   = bf16( bf16(values[t, c, p]) * wr[t, r, p] )
//
// with an fp32 sum, out (T, B = gc^2, Q = gc*C) f32.  On the TPU that is a
// dense GEMM per tile, because the TPU has no scatter.  But a row of wbg has
// 4 non-zeros (the bilinear corners lo_b*gc + lo_g, +1, +gc, +gc+1 of the
// pixel's colour) and a column of wr has 2 (bins lo_r, lo_r + 1): a pixel
// touches 4 x 2 x C entries of the tile's B x Q slab.  This kernel takes the
// non-zeros only and scatters:
//
//   idx (T, px) int32: lo_b*gc + lo_g in the low 16 bits, lo_r in the high 16;
//   wbg4 (T, 4, px) bf16: the corner weights, in the column order above;
//   wr2 (T, 2, px) bf16: the weights of bins lo_r and lo_r + 1;
//   perm (T, px) int32: each tile's pixels ordered by index word;
//   values (T, C, px) f32.
//
// Each weight is the bf16 number the dense operand holds and u still rounds
// once to bf16 (the product of two bf16 numbers is exact in fp32), so the
// function is the dense one; only the zeros are no longer multiplied.
//
// Bound on the H100: bytes.  The slab is written once (4*T*B*Q bytes, 809 MB
// at the serving shape T = 1040, px = 1600, gc = C = 21), the values are
// read once (4*T*C*px, 140 MB) and 20 bytes of index, order and weights per
// pixel (33 MB); the 8*C multiply-adds per pixel take 0.008 ms at the card's
// fp32 rate.
//
// Design.  Pixels that share an index word share their 8 cells (b or b+1,
// g or g+1, r or r+1), and the pixels of a tile share a few words, because a
// 40 x 40 patch of a photo has a few colours.  The plan orders each tile's
// pixels by index word once (`perm`, a stable sort), so that such pixels
// form a segment.  A block owns one tile.  It writes the tile's slab as
// zeros (the stream that the bound counts; there is no zero-fill pass before
// the launch) and stages the tile in shared memory: the index words and
// weights in sorted order, and the values rounded to bf16, read along px in
// 16-byte loads by all threads at once, so that the walk below waits on
// shared memory only.  The sorted pixels are cut into pieces, at every
// change of index word and every PIECE pixels, so that a tile of one colour
// still has work for all warps.
// A warp takes a piece, its lanes the channels c: it walks the piece's
// pixels in ascending order with the 8 cells' sums in registers, 8
// multiply-adds per pixel and lane, and leaves the sums in a slot of shared
// memory.  After a batch of pieces the slots are added into the slab.
//
// The sum has a fixed order, so the result is the same bits on every run,
// without atomics.  The pieces of one segment are added up in ascending
// order by one warp.  A segment's class is the parities of its (lo_b, lo_g,
// lo_r); two segments of one class differ by at least 2 in one bin, so their
// cells are disjoint and warps may add them to the slab side by side.  The 8
// classes follow each other with a barrier between, so a cell that several
// segments reach (at most one of each class) receives them in class order,
// batch after batch, each through one thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PIECE = 128;              // most pixels a warp sums in one go
constexpr int SLOTS = 16;               // pieces per batch
constexpr int NO_CLASS = 8;             // a pixel with a bin out of range: never summed
constexpr int PX_MAX = 0xFFFF;          // a piece's start shares a word with its class
constexpr int LEADER = 1 << 20;         // flag of a segment's first piece
constexpr int SMEM_MAX = 227 * 1024 - 64;  // a block's limit less its static shared memory

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ unsigned bits(const __nv_bfloat16* p) {
  return __bfloat16_as_ushort(*p);
}

__device__ __forceinline__ float lo_bf16(unsigned pair) { return __uint_as_float(pair << 16); }
__device__ __forceinline__ float hi_bf16(unsigned pair) { return __uint_as_float(pair & 0xFFFF0000u); }

// The class (parities of the bins) of an index word, NO_CLASS if a bin lies
// outside [0, gc - 2].
__device__ __forceinline__ int word_class(int word, int gc) {
  const int bg = word & 0xFFFF, r = word >> 16;
  const int b = bg / gc, g = bg - b * gc;
  if (r < 0 || r > gc - 2 || b > gc - 2 || g > gc - 2) return NO_CLASS;
  return (b & 1) | (g & 1) << 1 | (r & 1) << 2;
}

__device__ __forceinline__ int piece_class(int piece) { return (piece >> 16) & 15; }

__device__ __forceinline__ void zero_fill(float* dst, long n) {  // in 16-byte stores
  const long head = min(n, (long)((16 - (reinterpret_cast<size_t>(dst) & 15)) & 15) / 4);
  if (threadIdx.x < head) dst[threadIdx.x] = 0.0f;
  float4* body = reinterpret_cast<float4*>(dst + head);
  const long n4 = (n - head) / 4;
  for (long i = threadIdx.x; i < n4; i += THREADS) body[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const long tail = head + 4 * n4;
  if (tail + threadIdx.x < n) dst[tail + threadIdx.x] = 0.0f;
}

// Bytes of shared memory: meta_s, part_s, piece_s, perm_s and, if staged, v_s.
__host__ __device__ constexpr long smem_bytes(int px, int c, bool staged) {
  return (long)px * sizeof(int4) + (long)SLOTS * 8 * c * sizeof(float) + (long)(px + 1) * sizeof(int) +
         (long)(px + (px & 1)) * sizeof(unsigned short) +
         (staged ? (long)px * (c | 1) * sizeof(__nv_bfloat16) : 0);
}

// STAGED: the tile's values fit shared memory beside the rest; else the walk
// reads them from device memory.
template <bool STAGED>
__global__ void __launch_bounds__(THREADS)
splat_kernel(const int* __restrict__ idx, const int* __restrict__ perm,
             const __nv_bfloat16* __restrict__ wbg4, const __nv_bfloat16* __restrict__ wr2,
             const float* __restrict__ values, float* out, int px, int gc, int c, bool vec4) {
  extern __shared__ __align__(16) unsigned char smem[];
  // the tile's pixels in sorted order: {index word or -1, bf16 bits of corner
  // weights 0 | 1 << 16, of 2 | 3 << 16, of the r weights lo | hi << 16}
  int4* meta_s = reinterpret_cast<int4*>(smem);                  // [px]
  float* part_s = reinterpret_cast<float*>(meta_s + px);         // [SLOTS][8][c]: a piece's sums
  // a piece's first position | its class << 16 | LEADER if it starts a segment
  int* piece_s = reinterpret_cast<int*>(part_s + SLOTS * 8 * c);  // [n_pieces + 1]
  unsigned short* perm_s = reinterpret_cast<unsigned short*>(piece_s + px + 1);  // [px]: the pixel
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(perm_s + px + (px & 1));  // [px][c | 1], by pixel
  __shared__ int n_pieces_s;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long t = blockIdx.x;
  const int nq = gc * c, cpad = c | 1;
  const int* perm_t = perm + t * px;
  float* out_t = out + t * gc * gc * nq;

  for (int i = tid; i < px; i += THREADS) {
    const int p = perm_t[i];
    int4 m = make_int4(-1, 0, 0, 0);
    if (p >= 0 && p < px) {
      const int word = idx[t * px + p];
      const unsigned w0 = bits(wbg4 + (t * 4 + 0) * px + p), w1 = bits(wbg4 + (t * 4 + 1) * px + p);
      const unsigned w2 = bits(wbg4 + (t * 4 + 2) * px + p), w3 = bits(wbg4 + (t * 4 + 3) * px + p);
      const unsigned r0 = bits(wr2 + (t * 2 + 0) * px + p), r1 = bits(wr2 + (t * 2 + 1) * px + p);
      m = make_int4(word_class(word, gc) != NO_CLASS ? word : -1, (int)(w0 | w1 << 16),
                    (int)(w2 | w3 << 16), (int)(r0 | r1 << 16));
    }
    meta_s[i] = m;
    perm_s[i] = (unsigned short)(m.x >= 0 ? p : 0);
  }
  if (STAGED) {  // read along px, 16 bytes a thread where the rows allow it
    const float* v_t = values + t * c * px;
    if (vec4) {
      const int px4 = px / 4;
      for (int e = tid; e < px4 * c; e += THREADS) {
        const int ch = e / px4, p = (e - ch * px4) * 4;
        const float4 v = *reinterpret_cast<const float4*>(v_t + (long)ch * px + p);
        v_s[p * cpad + ch] = __float2bfloat16_rn(v.x);
        v_s[(p + 1) * cpad + ch] = __float2bfloat16_rn(v.y);
        v_s[(p + 2) * cpad + ch] = __float2bfloat16_rn(v.z);
        v_s[(p + 3) * cpad + ch] = __float2bfloat16_rn(v.w);
      }
    } else {
      for (int e = tid; e < px * c; e += THREADS) {
        const int ch = e / px, p = e - ch * px;
        v_s[p * cpad + ch] = __float2bfloat16_rn(v_t[(long)ch * px + p]);
      }
    }
  }
  zero_fill(out_t, (long)gc * gc * nq);
  __syncthreads();

  if (warp == 0) {  // cut the sorted pixels into pieces
    int n = 0;
    for (int i0 = 0; i0 < px; i0 += 32) {
      const int i = i0 + lane;
      const bool leader = i < px && (i == 0 || meta_s[i].x != meta_s[i - 1].x);
      const bool first = leader || (i < px && i % PIECE == 0);
      const unsigned firsts = __ballot_sync(0xFFFFFFFFu, first);
      if (first) {
        const int word = meta_s[i].x;
        const int cls = word < 0 ? NO_CLASS : word_class(word, gc);
        piece_s[n + __popc(firsts & ((1u << lane) - 1))] = i | cls << 16 | (leader ? LEADER : 0);
      }
      n += __popc(firsts);
    }
    if (lane == 0) {
      piece_s[n] = px | NO_CLASS << 16 | LEADER;
      n_pieces_s = n;
    }
  }
  __syncthreads();
  const int n_pieces = n_pieces_s;

  for (int base = 0; base < n_pieces; base += SLOTS) {
    const int n_here = min(SLOTS, n_pieces - base);
    // each piece's sums over its pixels, into its slot
    for (int j = warp; j < n_here; j += WARPS) {
      const int piece = piece_s[base + j];
      if (piece_class(piece) == NO_CLASS) continue;
      const int i0 = piece & 0xFFFF, i1 = piece_s[base + j + 1] & 0xFFFF;
      for (int c0 = 0; c0 < c; c0 += 32) {
        const bool active = c0 + lane < c;
        const int ch = active ? c0 + lane : 0;
        const float* v_ch = values + (t * c + ch) * px;
        float acc[4][2] = {};
#pragma unroll 4
        for (int i = i0; i < i1; ++i) {
          const int4 m = meta_s[i];
          const int p = perm_s[i];
          const float v = STAGED ? __bfloat162float(v_s[p * cpad + ch]) : bf16_round(v_ch[p]);
          const float u_lo = bf16_round(v * lo_bf16(m.w)), u_hi = bf16_round(v * hi_bf16(m.w));
          const float w[4] = {lo_bf16(m.y), hi_bf16(m.y), lo_bf16(m.z), hi_bf16(m.z)};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            acc[k][0] = fmaf(w[k], u_lo, acc[k][0]);
            acc[k][1] = fmaf(w[k], u_hi, acc[k][1]);
          }
        }
        if (active) {
#pragma unroll
          for (int k = 0; k < 8; ++k) part_s[(j * 8 + k) * c + ch] = acc[k >> 1][k & 1];
        }
      }
    }
    __syncthreads();

    // the batch's sums into the slab, class after class.  A piece leads if it
    // starts a segment or the batch; the pieces after it up to the next
    // leader continue its segment.
    unsigned classes = 0;
    for (int j = 0; j < n_here; ++j) {
      const int piece = piece_s[base + j];
      if (j == 0 || (piece & LEADER)) classes |= 1u << piece_class(piece);
    }
    for (int cls = 0; cls < NO_CLASS; ++cls) {
      if (!(classes >> cls & 1)) continue;
      for (int j = warp; j < n_here; j += WARPS) {
        const int piece = piece_s[base + j];
        if (piece_class(piece) != cls || !(j == 0 || (piece & LEADER))) continue;
        int j1 = j + 1;
        while (j1 < n_here && !(piece_s[base + j1] & LEADER)) ++j1;
        const int word = meta_s[piece & 0xFFFF].x;
        float* cell = out_t + (long)((word & 0xFFFF) * gc + (word >> 16)) * c;  // (lo_b, lo_g, lo_r)
        for (int ch = lane; ch < c; ch += 32) {
          // through L2: another warp of the block may have written a cell before a
          // barrier.  All 8 loads go out before the first store waits on one.
          float* dst[8];
          float sum[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            dst[k] = cell + (long)((k >> 2) * gc + ((k >> 1) & 1)) * nq + (k & 1) * c + ch;
            sum[k] = __ldcg(dst[k]);
          }
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            float part = part_s[(j * 8 + k) * c + ch];
            for (int jj = j + 1; jj < j1; ++jj) part += part_s[(jj * 8 + k) * c + ch];
            sum[k] += part;
          }
#pragma unroll
          for (int k = 0; k < 8; ++k) __stcg(dst[k], sum[k]);
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace

// Returns the CUDA error code of the launch (0 on success).  All arrays are
// contiguous; perm (T, px) int32 orders each tile's pixels by index word; a
// pixel with a bin outside [0, gc - 2] adds nothing.
extern "C" int mmgrid_splat(const void* idx, const void* perm, const void* wbg4, const void* wr2,
                            const void* values, void* out, int n_tiles, int px, int gc, int c,
                            void* stream) {
  if (n_tiles <= 0 || px <= 0 || px > PX_MAX || gc < 2 || gc > 255 || c <= 0)
    return (int)cudaErrorInvalidValue;
  const bool staged = smem_bytes(px, c, true) <= SMEM_MAX;
  const long smem = smem_bytes(px, c, staged);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kernel = staged ? splat_kernel<true> : splat_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<n_tiles, THREADS, (int)smem, (cudaStream_t)stream>>>(
      (const int*)idx, (const int*)perm, (const __nv_bfloat16*)wbg4, (const __nv_bfloat16*)wr2,
      (const float*)values, (float*)out, px, gc, c,
      px % 4 == 0 && reinterpret_cast<size_t>(values) % 16 == 0);  // rows of values take 16-byte loads
  return (int)cudaGetLastError();
}
