// The Caffe SGD update of every leaf of a model, with its gradient norm, in
// two launches, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's update (dsrg_tpu/train/
// optimizer.py::caffe_sgd, an optax transformation) is left to XLA, which
// fuses it into a few loops over the whole tree.  The port's plain version
// (train/optimizer.py::CaffeSGD._step_plain) issues about ten ATen ops a
// leaf, and ResNet-101 has 320 leaves: some 4,500 launches a step of a few
// microseconds' work each, which the host needs 10-45 us apiece to issue.
// This pass was added for that.
//
// For each leaf, with inv the train step's 1 / n_valid (a 0-d device value,
// or 1 where the caller gave none), clip > 0 the clipping threshold, and the
// per-leaf coefficients wd = weight_decay * decay_mult and lr = lr(step) *
// lr_mult formed in double and rounded to float once on the host:
//
//   norm  = sqrt(sum over every leaf and element of (g * inv)^2)
//   scale = min(clip / max(norm, 1e-12), 1)                      (clip > 0)
//   g1 = g * inv;  g2 = g1 * scale (clip > 0, else g1);  g3 = g2 + wd * w
//   g4 = lr * g3;  v = v * momentum;  v = v + g4;  w = w - v
//
// each step rounded to float on its own (__fmul_rn / __fadd_rn / __fsub_rn:
// no FMA contraction), in the order the plain loop's ATen ops round, so w
// and v come out bit-equal to it wherever the clip does not engage, inf and
// NaN included; the clip's min and max let a NaN through as torch.clamp
// does, and its quotient is the reciprocal times clip, as `clip / t` is.
// The norm sums fp32 squares in double, rounds the sum to float and takes
// its square root, so it overflows where the plain fp32 sum does.  The lr-0
// leaves (frozen batch norm) stay in the pass: without launches they cost
// their bytes alone.
//
// Bound on the H100: bytes, once launches are gone.  With the clip the
// scale needs the whole norm before any apply, so g is read twice and w and
// v read and written once: 24 B a value, 1.057 GB for ResNet-101's 44.05 M
// values (0.316 ms at 3.35 TB/s).  Without it the norm could be summed in
// the apply's own read of g: 20 B a value, 0.758 GB for VGG16-LargeFOV's
// 37.88 M (0.226 ms).  The pass takes the clip's two reads either way, one
// path for both, at ~0.045 ms a VGG step.
//
// Design.  The leaf table (pointers, sizes, coefficients, each leaf's first
// chunk) travels as one __grid_constant__ kernel parameter of ~25 KB (CUDA
// >= 12.1 allows 32,764 bytes on sm_70+), so nothing is copied to the
// device and nothing waits; a model of more than MAX_LEAVES leaves is
// refused (ResNet-101, the largest the port runs, has 320).  Every leaf is cut into chunks of CHUNK values; a block takes a
// contiguous range of the chunks of all leaves (a grid of a few blocks per
// SM), so one launch covers 50 or 320 leaves alike and tiny leaves cost a
// chunk each.  A full chunk of a leaf whose g, w and v are 16-byte aligned
// moves in 16-byte loads and stores, PER_THREAD of each array in flight per
// thread; a leaf's last chunk, or any chunk of a leaf that is not aligned
// (views into a coalesced all-reduce buffer), goes value by value.
//   sgd_sqnorm_kernel: each block sums (g * inv)^2 over its chunks in
//     double and writes one partial; no atomics, so the norm is the same on
//     every run.
//   sgd_apply_kernel: each block first sums all partials in the same fixed
//     order, so every block holds the same norm and scale, and block 0
//     writes the norm out; then it updates its chunks.

#include <cuda_runtime.h>

namespace {

// train/sgd_kernels.py reads MAX_LEAVES and BLOCKS_PER_SM through caffe_sgd_limits
constexpr int MAX_LEAVES = 512;
constexpr int BLOCKS_PER_SM = 4;  // resident at once: 64 registers a thread at most
constexpr int THREADS = 256;
constexpr int VEC = 4;          // floats in a 16-byte access
constexpr int PER_THREAD = 4;   // 16-byte accesses of each array per thread and chunk
constexpr int CHUNK = THREADS * VEC * PER_THREAD;  // 4096 values

struct Table {
  const float* g[MAX_LEAVES];
  float* w[MAX_LEAVES];
  float* v[MAX_LEAVES];
  long long n[MAX_LEAVES];
  long long first[MAX_LEAVES + 1];  // first chunk of each leaf; first[leaves] = the chunks
  float wd[MAX_LEAVES];             // weight_decay * decay_mult
  float lr[MAX_LEAVES];             // lr(step) * lr_mult
  unsigned char vec[MAX_LEAVES];    // 1 where g, w and v are all 16-byte aligned
  int leaves;
};
static_assert(sizeof(Table) + 64 <= 32764, "the leaf table must fit the kernel parameter space");

__device__ __forceinline__ double block_sum(double x) {
  __shared__ double part[THREADS / 32];
  __shared__ double total;
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int i = 0; i < THREADS / 32; ++i) s += part[i];
    total = s;
  }
  __syncthreads();
  return total;
}

// The leaf that holds chunk c < t.first[t.leaves].
__device__ __forceinline__ int find_leaf(const Table& t, long long c) {
  int lo = 0, hi = t.leaves;  // t.first[lo] <= c < t.first[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (t.first[mid] <= c) lo = mid; else hi = mid;
  }
  return lo;
}

// Calls body(leaf, offset, length, vectorised) for each chunk of this
// block's contiguous range, in order.
template <class Body>
__device__ __forceinline__ void walk_chunks(const Table& t, Body body) {
  const long long chunks = t.first[t.leaves];
  const long long lo = chunks * blockIdx.x / gridDim.x, hi = chunks * (blockIdx.x + 1) / gridDim.x;
  if (lo >= hi) return;
  int leaf = find_leaf(t, lo);
  for (long long c = lo; c < hi; ++c) {
    while (c >= t.first[leaf + 1]) ++leaf;
    const long long off = (c - t.first[leaf]) * CHUNK;
    const long long left = t.n[leaf] - off;
    const int len = left < CHUNK ? (int)left : CHUNK;
    body(leaf, off, len, t.vec[leaf] && len == CHUNK);
  }
}

__device__ __forceinline__ float square_scaled(float g, float inv) {
  const float g1 = __fmul_rn(g, inv);
  return __fmul_rn(g1, g1);
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    sgd_sqnorm_kernel(const __grid_constant__ Table t, const float* inv_p, double* partials) {
  const float inv = inv_p ? *inv_p : 1.0f;
  double acc = 0.0;
  walk_chunks(t, [&](int leaf, long long off, int len, bool vec) {
    const float* g = t.g[leaf] + off;
    if (vec) {
      float4 x[PER_THREAD];
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k) x[k] = reinterpret_cast<const float4*>(g)[k * THREADS + threadIdx.x];
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k) {
        acc += (double)square_scaled(x[k].x, inv);
        acc += (double)square_scaled(x[k].y, inv);
        acc += (double)square_scaled(x[k].z, inv);
        acc += (double)square_scaled(x[k].w, inv);
      }
    } else {
      for (int i = threadIdx.x; i < len; i += THREADS) acc += (double)square_scaled(g[i], inv);
    }
  });
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

struct Coef {
  float inv, scale, wd, lr, momentum;
  bool clip;
};

__device__ __forceinline__ void update(float g, float& w, float& v, const Coef& k) {
  float x = __fmul_rn(g, k.inv);
  if (k.clip) x = __fmul_rn(x, k.scale);
  x = __fadd_rn(x, __fmul_rn(k.wd, w));
  x = __fmul_rn(k.lr, x);
  v = __fadd_rn(__fmul_rn(v, k.momentum), x);
  w = __fsub_rn(w, v);
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    sgd_apply_kernel(const __grid_constant__ Table t, const float* inv_p, const double* partials,
                     int n_partials, float* norm_out, float momentum, float clip) {
  double s = 0.0;
  for (int i = threadIdx.x; i < n_partials; i += THREADS) s += partials[i];
  const float norm = sqrtf((float)block_sum(s));
  if (blockIdx.x == 0 && threadIdx.x == 0) *norm_out = norm;
  Coef k{inv_p ? *inv_p : 1.0f, 1.0f, 0.0f, 0.0f, momentum, clip > 0.0f};
  if (k.clip) {  // torch.clamp(clip / torch.clamp_min(norm, 1e-12), max=1.0), NaN passing through
    const float at_least = isnan(norm) ? norm : fmaxf(norm, 1e-12f);
    const float q = __fmul_rn(__frcp_rn(at_least), clip);
    k.scale = isnan(q) ? q : fminf(q, 1.0f);
  }
  walk_chunks(t, [&](int leaf, long long off, int len, bool vec) {
    const float* g = t.g[leaf] + off;
    float* w = t.w[leaf] + off;
    float* v = t.v[leaf] + off;
    k.wd = t.wd[leaf];
    k.lr = t.lr[leaf];
    if (vec) {
      float4 a[PER_THREAD], b[PER_THREAD], c[PER_THREAD];
#pragma unroll
      for (int j = 0; j < PER_THREAD; ++j) {
        const int i = j * THREADS + threadIdx.x;
        a[j] = reinterpret_cast<const float4*>(g)[i];
        b[j] = reinterpret_cast<const float4*>(w)[i];
        c[j] = reinterpret_cast<const float4*>(v)[i];
      }
#pragma unroll
      for (int j = 0; j < PER_THREAD; ++j) {
        update(a[j].x, b[j].x, c[j].x, k);
        update(a[j].y, b[j].y, c[j].y, k);
        update(a[j].z, b[j].z, c[j].z, k);
        update(a[j].w, b[j].w, c[j].w, k);
        const int i = j * THREADS + threadIdx.x;
        reinterpret_cast<float4*>(w)[i] = b[j];
        reinterpret_cast<float4*>(v)[i] = c[j];
      }
    } else {
      for (int i = threadIdx.x; i < len; i += THREADS) {
        float wi = w[i], vi = v[i];
        update(g[i], wi, vi, k);
        w[i] = wi;
        v[i] = vi;
      }
    }
  });
}

// Fills t with the flat arrays' leaves; false on a negative size or a
// missing pointer.
bool fill(Table& t, const unsigned long long* ptrs, const long long* numel, const float* coef, int leaves) {
  long long chunks = 0;
  for (int i = 0; i < leaves; ++i) {
    const unsigned long long g = ptrs[i], w = ptrs[leaves + i], v = ptrs[2 * leaves + i];
    if (numel[i] < 0 || (numel[i] > 0 && (!g || !w || !v))) return false;
    t.g[i] = reinterpret_cast<const float*>(g);
    t.w[i] = reinterpret_cast<float*>(w);
    t.v[i] = reinterpret_cast<float*>(v);
    t.n[i] = numel[i];
    t.first[i] = chunks;
    chunks += (numel[i] + CHUNK - 1) / CHUNK;
    t.wd[i] = coef[i];
    t.lr[i] = coef[leaves + i];
    t.vec[i] = ((g | w | v) & 15) == 0;
  }
  t.first[leaves] = chunks;
  t.leaves = leaves;
  return true;
}

}  // namespace

// The most leaves one update takes, and the blocks a launch runs per SM.
extern "C" void caffe_sgd_limits(int* max_leaves, int* blocks_per_sm) {
  *max_leaves = MAX_LEAVES;
  *blocks_per_sm = BLOCKS_PER_SM;
}

// One Caffe SGD update; returns the CUDA error code of the launches (0 on
// success, invalid value for a bad table).  ptrs: 3 x leaves device
// addresses (the gradients, then the parameters, then the velocities, each
// contiguous float); numel: leaves sizes; coef: 2 x leaves floats (wd, then
// lr); inv: a device float or null (1); partials: grid doubles of scratch;
// norm: a device float that receives the gradient norm; grid: blocks a
// launch (BLOCKS_PER_SM per SM); clip <= 0: no clipping.  Launches
// sgd_sqnorm_kernel then sgd_apply_kernel on the stream.
extern "C" int caffe_sgd(const unsigned long long* ptrs, const long long* numel, const float* coef, int leaves,
                         const void* inv, void* partials, void* norm, int grid, float momentum, float clip,
                         void* stream) {
  if (leaves <= 0 || leaves > MAX_LEAVES || grid <= 0 || !partials || !norm) return (int)cudaErrorInvalidValue;
  thread_local static Table t;  // 25 KB: off the stack; each launch copies it
  if (!fill(t, ptrs, numel, coef, leaves)) return (int)cudaErrorInvalidValue;
  const auto st = (cudaStream_t)stream;
  const auto* inv_p = (const float*)inv;
  auto* part = (double*)partials;
  sgd_sqnorm_kernel<<<grid, THREADS, 0, st>>>(t, inv_p, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sgd_apply_kernel<<<grid, THREADS, 0, st>>>(t, inv_p, part, grid, (float*)norm, momentum, clip);
  return (int)cudaGetLastError();
}
