// Fused sampling for Hopper (sm_90a): temperature, top-k, top-p and the
// gumbel-argmax draw in one kernel, one CTA per row of logits, for rows of
// any length.
//
// Replaces the TPU kernel bigdl_tpu/ops/sampling.py `_sample_kernel` (with
// `_cutoff`), launched by `fused_sample_logits` (:118, block (bs, v): the
// whole row, any vocabulary).
//
// What it computes, per row s of (S, V) logits, with the reference's exact
// semantics:
//   l = logits[s] / max(temps[s], 1e-6)
//   top-k (0 < k < V): cut = the k-th largest value, found by 60 halvings of
//     [min over unmasked l - 1, max l] on the count of l > mid, snapped to
//     the smallest l above the final lower end; l[l < cut] = NEG_INF
//   top-p (p < 1): the same bisection on the softmax mass of l > mid
//   out[s] = argmax(l + gumbel[s]), the first index on ties
// The gumbel noise is an input (drawn by the caller), as in the reference.
//
// What bounds it: at V = 50257 a row is 196 KB of logits plus 196 KB of
// noise to read once, but the two 60-step bisections make ~120 passes over
// the row (a compare and an add per element each, ~256 float operations
// per element with the softmax), so in float32 operations set the floor,
// a little above bytes. The kernel must not re-read the row from HBM on
// each pass.
//
// What the design does about it: the temperature-scaled row is written
// once and every later pass (bisection steps, truncation, argmax) reads it
// there. Two variants of one kernel body (ROW_IN_SMEM):
// - V <= kMaxVocab (57,856, GPT-2's 50,257 included): the row lives in
//   dynamic shared memory (V * 4 bytes, up to ~227 KB on Hopper), so HBM
//   sees the logits once and the noise once;
// - longer rows (Llama-3's 128,256): the row lives in a float32 (S, V)
//   scratch the wrapper allocates. 8 x 128,256 x 4 B = 4.1 MB stays in the
//   50 MB L2, so each pass is bound by L2 reads (~120 passes of V * 4
//   bytes a row), not by HBM, and the logits and noise still cross HBM
//   once.
// 1024 threads stride over the row; each bisection step is one pass plus a
// block reduction (warp shuffles, then one shared slot per warp), replacing
// the TPU kernel's row sums. A thread reads and writes only its own
// indices of the row, so the scratch needs no fence beyond the barriers
// the reductions already take. The top-k count is an exact integer; the
// top-p mass recomputes exp(l - max) / Z per element on each step instead
// of keeping a second row of probabilities: two more operations per
// element and step than the bound counts. The arithmetic, the tie rule and
// the division are the same in both variants.

#include <math.h>

#include "common.cuh"

namespace bigdl {
namespace {

constexpr int kThreads = 1024;
constexpr int kNumWarps = kThreads / 32;
constexpr int kBisectIters = 60;
// the longest row held in dynamic shared memory: 227 KB a block, less the
// static reduction slots (ops/sampling.py MAX_VOCAB)
constexpr int kMaxVocab = (232448 - 1024) / 4;

struct SumF {
  __device__ float operator()(float a, float b) const { return a + b; }
};
struct MaxF {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct MinF {
  __device__ float operator()(float a, float b) const { return fminf(a, b); }
};
struct SumI {
  __device__ int operator()(int a, int b) const { return a + b; }
};

// every thread gets the result; `red` holds one partial per warp
template <typename V, typename Op>
__device__ V block_reduce(V v, Op op, V* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(kFullMask, v, o));
  __syncthreads();  // the previous reduction's readers are done with `red`
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[threadIdx.x & 31];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// Per-row threshold c such that keeping l >= c keeps exactly the tokens
// with measure(l > l_i) < level; measure is the count (top-k) or the
// softmax mass exp(l - mx) / z (top-p). Invariant of the bisection:
// measure(> lo) >= level, measure(> hi) < level.
template <bool kMass>
__device__ float cutoff(const float* row, int V, float level, float mx,
                        float z, float* redf, int* redi) {
  float lo_t = -kNegInf, hi_t = -INFINITY;
  for (int i = threadIdx.x; i < V; i += kThreads) {
    const float x = row[i];
    // the bracket starts at the UNMASKED extremes (x > 0.5 * NEG_INF)
    if (x > 0.5f * kNegInf) lo_t = fminf(lo_t, x);
    hi_t = fmaxf(hi_t, x);
  }
  float lo = block_reduce(lo_t, MinF(), redf) - 1.0f;
  float hi = block_reduce(hi_t, MaxF(), redf);
  for (int it = 0; it < kBisectIters; ++it) {
    const float mid = 0.5f * (lo + hi);
    bool pred;
    if (kMass) {
      float acc = 0.f;
      for (int i = threadIdx.x; i < V; i += kThreads) {
        const float x = row[i];
        if (x > mid) acc += expf(x - mx) / z;
      }
      pred = block_reduce(acc, SumF(), redf) >= level;
    } else {
      int cnt = 0;
      for (int i = threadIdx.x; i < V; i += kThreads) cnt += row[i] > mid;
      pred = (float)block_reduce(cnt, SumI(), redi) >= level;
    }
    lo = pred ? mid : lo;
    hi = pred ? hi : mid;
  }
  // snap to the smallest logit strictly above lo: the boundary value
  float mn = -kNegInf;
  for (int i = threadIdx.x; i < V; i += kThreads) {
    const float x = row[i];
    if (x > lo) mn = fminf(mn, x);
  }
  return block_reduce(mn, MinF(), redf);
}

// ROW_IN_SMEM: the scaled, truncated row in dynamic shared memory (V
// floats); else in row blockIdx.x of `scratch` (S x V floats)
template <typename T, bool ROW_IN_SMEM>
__global__ void __launch_bounds__(kThreads)
fused_sample_kernel(const T* __restrict__ logits, const T* __restrict__ gumbel,
                    const float* __restrict__ temps, int* __restrict__ out,
                    float* __restrict__ scratch, int V, int top_k,
                    float top_p) {
  extern __shared__ float smem_row[];
  float* row = ROW_IN_SMEM ? smem_row : scratch + (int64_t)blockIdx.x * V;
  __shared__ float redf[kNumWarps];
  __shared__ int redi[kNumWarps];
  __shared__ float redv[kNumWarps];
  __shared__ int redx[kNumWarps];

  const int s = blockIdx.x;
  const int64_t off = (int64_t)s * V;
  const float t = fmaxf(temps[s], 1e-6f);
  for (int i = threadIdx.x; i < V; i += kThreads)
    row[i] = to_f(logits[off + i]) / t;
  __syncthreads();

  if (top_k > 0 && top_k < V) {
    const float kth = cutoff<false>(row, V, (float)top_k, 0.f, 1.f, redf,
                                    redi);
    for (int i = threadIdx.x; i < V; i += kThreads)
      if (row[i] < kth) row[i] = kNegInf;
    __syncthreads();
  }
  if (top_p < 1.f) {
    float mx_t = -INFINITY;
    for (int i = threadIdx.x; i < V; i += kThreads) mx_t = fmaxf(mx_t, row[i]);
    const float mx = block_reduce(mx_t, MaxF(), redf);
    float z_t = 0.f;
    for (int i = threadIdx.x; i < V; i += kThreads) z_t += expf(row[i] - mx);
    const float z = block_reduce(z_t, SumF(), redf);
    const float cut = cutoff<true>(row, V, top_p, mx, z, redf, redi);
    for (int i = threadIdx.x; i < V; i += kThreads)
      if (row[i] < cut) row[i] = kNegInf;
    __syncthreads();
  }

  // argmax of l + gumbel; a thread walks its indices in increasing order
  // and keeps the first maximum, the merge keeps the smaller index on ties
  float bv = -INFINITY;
  int bi = V;
  for (int i = threadIdx.x; i < V; i += kThreads) {
    const float x = row[i] + to_f(gumbel[off + i]);
    if (x > bv) {
      bv = x;
      bi = i;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFullMask, bv, o);
    const int oi = __shfl_xor_sync(kFullMask, bi, o);
    if (ov > bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if ((threadIdx.x & 31) == 0) {
    redv[threadIdx.x >> 5] = bv;
    redx[threadIdx.x >> 5] = bi;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    bv = redv[threadIdx.x];
    bi = redx[threadIdx.x];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kFullMask, bv, o);
      const int oi = __shfl_xor_sync(kFullMask, bi, o);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (threadIdx.x == 0) out[s] = bi;
  }
}

template <typename T>
cudaError_t launch(const void* logits, const void* gumbel, const float* temps,
                   int* out, float* scratch, int S, int V, int top_k,
                   float top_p, cudaStream_t stream) {
  if (V > kMaxVocab) {
    fused_sample_kernel<T, false><<<S, kThreads, 0, stream>>>(
        (const T*)logits, (const T*)gumbel, temps, out, scratch, V, top_k,
        top_p);
    return cudaGetLastError();
  }
  const size_t smem = (size_t)V * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_sample_kernel<T, true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fused_sample_kernel<T, true><<<S, kThreads, smem, stream>>>(
      (const T*)logits, (const T*)gumbel, temps, out, nullptr, V, top_k,
      top_p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace bigdl

// logits, gumbel: (S, V) of one dtype (0 float32, 1 bfloat16); temps: (S,)
// float32; out: (S,) int32. top_k <= 0 or >= V disables top-k; top_p >= 1
// disables top-p. scratch: (S, V) float32 when V > kMaxVocab (the row does
// not fit in shared memory), else unused and may be null. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int bigdl_fused_sample(const void* logits, const void* gumbel,
                                  const float* temps, int* out, float* scratch,
                                  int S, int V, int top_k, float top_p,
                                  int dtype, void* stream) {
  using namespace bigdl;
  if (V <= 0 || (V > kMaxVocab && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  if (S <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return (int)launch<float>(logits, gumbel, temps, out, scratch, S, V,
                              top_k, top_p, s);
  if (dtype == kBF16)
    return (int)launch<__nv_bfloat16>(logits, gumbel, temps, out, scratch, S,
                                      V, top_k, top_p, s);
  return (int)cudaErrorInvalidValue;
}
