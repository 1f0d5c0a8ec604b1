// Flash attention for Hopper (sm_90a): the FlashAttention-2 forward and its
// two backward kernels (dQ; dK with dV), causal or full, over (B*H, S, D)
// tensors at D = 64 or 128, in two hand-written paths: tensor-core kernels
// (wgmma) for bfloat16, and CUDA-core kernels for float32.
//
// Replaces the TPU kernels of bigdl_tpu/ops/flash_attention.py:
//   forward <- `_fwd_kernel` (:45), launched by `_fwd` (:89):
//     bf16: flash_fwd_tc_kernel<D, CAUSAL>; f32: flash_fwd_kernel<D, CAUSAL>
//   dQ      <- `_bwd_dq_kernel` (:120), `_bwd_impl` call :217:
//     bf16: flash_bwd_dq_tc_kernel<D, CAUSAL>; f32: flash_bwd_dq_kernel
//   dK/dV   <- `_bwd_dkv_kernel` (:159), `_bwd_impl` call :238:
//     bf16: flash_bwd_dkv_tc_kernel<D, CAUSAL>; f32: flash_bwd_dkv_kernel
//
// What they compute, per b*h, with s = (q . k) * scale set to NEG_INF where
// a key is not visible (causal: key > query; ragged tail: key >= S):
//   forward: o = softmax(s) . v and lse = logsumexp(s), by the online
//     softmax (running max m, running sum l, rescaled accumulator), with
//     l = max(l, 1e-30);
//   dQ:    p = exp(s - lse), dp = dO . v, ds = p * (dp - delta + dlse) *
//          scale, dq = ds . k;
//   dK/dV: dv = p^T . dO, dk = ds^T . q;
// where delta = rowsum(dO * O) (float32, computed by the caller) and dlse is
// the cotangent of lse (a null pointer means zero). p is rounded to the
// input type before the P.V and P^T.dO products and ds before both of its
// products, as the reference does (:70, :150, :186, :192).
//
// What bounds them. The function costs 4*D operations per visible (query,
// key) pair (two products of D) while q, k, v and the outputs cross HBM
// once. At the training shape (B*H = 96, S = 1024, D = 64, causal) that is
// 12.9 GFLOP a call over 13-19 MB: in bfloat16 the function's bound is
// bytes (0.015-0.023 ms at 3.35 TB/s; 0.013 ms of operations at 989
// TFLOP/s), in float32 on the CUDA cores it is operations (0.19 ms at 67
// TFLOP/s). The flash design recomputes s (and in the backward dp) instead
// of storing the score matrix, so the kernels run more products than the
// function counts: the forward two per pair (its floor is the bytes), dQ
// three (6*D: 0.020 ms at 989 TFLOP/s, at its 0.019 ms of bytes) and dK/dV
// four (S^T, dV, dP^T, dK: 8*D, 25.8 GFLOP, 0.026 ms at 989 TFLOP/s). So
// the bfloat16 backward kernels are bound by their products on the tensor
// cores, at or above their bytes.
//
// The tensor-core kernels (bfloat16; wgmma m64nNk16, f32 accumulators in
// registers; the shared helpers in wgmma.cuh):
// - one CTA of two warpgroups (256 threads); each warpgroup owns 64 rows of
//   the CTA's tile: the forward's and dQ's query tile of 128 rows, dK/dV's
//   key tile of 128 rows. Every operand tile is stored as 64-wide blocks of
//   128-byte swizzle rows (D = 128 is two blocks), which both wgmma views
//   read without a copy: K-major (D contiguous, 32 bytes a k16 step) where
//   D is the product's depth, MN-major with the transpose bit where the
//   rows are the depth (V in P.V; K in dQ += dS.K; dO and Q in dV += P^T.dO
//   and dK += dS^T.Q);
// - forward: the Q tile is staged once; K and V tiles (128 keys at D = 64,
//   64 at D = 128) stream through a two-stage cp.async ring with zero fill
//   past S, the next tile in flight while the current one is multiplied.
//   S = Q.K^T is wgmma_ss; the online softmax runs on the accumulators in
//   the log2 domain (scale * log2(e) folded into one multiply, exp2), a
//   row's max through two quad shuffles, its sum kept per thread until the
//   end; P becomes the register A operand of O += P.V (wgmma_rs) with no
//   trip through shared memory: the accumulator's fragment for 16 columns
//   is the A fragment of one k16 step, packed as bf16 pairs. Causal: a CTA
//   stops at its diagonal tile, a warpgroup skips the tiles above its own
//   rows, only tiles that cross the diagonal or S are masked, and the
//   heaviest query tiles launch first;
// - dQ: the forward's shape. The Q and dO tiles stay resident; each row's
//   lse (times log2(e)), delta and dlse sit in the registers of the four
//   threads that hold the row; K and V tiles (128 keys at D = 64, 64 at
//   D = 128) stream through the two-stage ring from key 0 to the diagonal
//   (the reference's ((qi+1)*bq + bk - 1)//bk). Per key tile: S = Q.K^T
//   and dP = dO.V^T (wgmma_ss), P = exp2(S*scale*log2(e) - lse*log2(e)),
//   dS = P * (dP - delta + dlse) * scale rounded to bf16 as the register A
//   operand of dQ += dS.K (wgmma_rs, K MN-major). Causal work as in the
//   forward;
// - dK/dV: K and V of the key tile stay in shared memory; the query tiles
//   from the diagonal (the reference's (ki*bk)//bq) to the end stream Q,
//   dO and their lse, delta and dlse through a two-stage ring. Per query
//   tile of 64: S^T = K.Q^T (wgmma_ss), P^T = exp2(S^T*scale*log2(e) -
//   lse*log2(e)); dV += bf16(P^T).dO (wgmma_rs); dP^T = V.dO^T (wgmma_ss);
//   dS^T = P^T * (dP^T - delta + dlse) * scale, rounded to bf16; dK +=
//   dS^T.Q (wgmma_rs). lse, delta and dlse are indexed by query, a column
//   of S^T, and are read per column from the staged rows;
// - each wgmma group is waited for (wait_group 0) before its registers or
//   its stage are reused, so no product is in flight across a barrier;
// - epilogue: the accumulators are rounded to bf16 into the warpgroup's own
//   rows of a tile it no longer reads and written out as 16-byte stores;
//   lse (forward) straight from the registers. Every output element has one
//   writer and no atomics are used, so results repeat bit for bit.
// What remains for a later PR: a producer warp on TMA with mbarriers, two
// consumer warpgroups in ping-pong so that one's softmax overlaps the
// other's products, and persistent CTAs.
//
// The CUDA-core kernels (float32, D = 64 or 128):
// - one CTA of 256 threads per (b*h, 64-row tile). The forward and dQ own a
//   query tile and loop over key tiles, up to the diagonal when causal (the
//   reference's ((qi+1)*bq + bk - 1)//bk with bq = bk = 64); dK/dV owns a
//   key tile and loops over query tiles from the diagonal (the reference's
//   (ki*bk)//bq) to the end. No atomics: every output element has exactly
//   one writer, so results repeat bit for bit from run to run.
// - tiles are staged in shared memory as float32 rows padded to D + 4
//   floats, so a half-warp's float4 reads of 16 rows take two wavefronts
//   (the least for 256 bytes) and two rows D + 4 floats apart never
//   collide. Thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16*i
//   (i < 4) of a 64x64 score tile and its columns tx + 16*j (j < 4); of a
//   64xD output tile it owns the same rows and the columns 64*g + 4*tx ..
//   64*g + 4*tx + 3 (g < D / 64: 4 columns at D = 64, 8 at 128). Each
//   inner step of a score tile reads 8 float4 for 64 FMAs. Softmax row
//   reductions are four xor-shuffles inside a half-warp.
// - m, l and the output accumulators live in registers for the whole loop;
//   P (or dS) goes through shared memory once per tile, for the second
//   product. At D = 128 the staged tiles take 135-204 KB of dynamic shared
//   memory, one CTA an SM.
// - the heaviest tiles launch first: under causal masking the last query
//   tiles (forward, dQ) and the first key tiles (dK/dV) do the most work.
// float32 stays on the CUDA cores rather than TF32 tensor cores, to keep
// its results within 2e-5 (O, lse) and 1e-4 (gradients) of the plain
// version's.
// Both paths: ragged S: rows past S stage as zeros, their scores are
// masked, nothing past S is stored; S need not be a multiple of a tile.
// Offsets into the (B*H, S, D) tensors are 64-bit.

#include "common.cuh"
#include "wgmma.cuh"

namespace bigdl {
namespace {

constexpr int kT = 64;            // rows of a query tile and of a key tile
constexpr int kThreads = 256;
static_assert(kT == 64 && kThreads == 256,
              "the thread-to-tile map assumes 16x16 threads on 64x64 tiles");

// padded shared-memory row of a staged tile, and one staged tile, in floats
__host__ __device__ constexpr int row_str(int d) { return d + 4; }
__host__ __device__ constexpr int tile_floats(int d) {
  return kT * row_str(d);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ float comp(const float4& x, int c) {
  return c == 0 ? x.x : c == 1 ? x.y : c == 2 ? x.z : x.w;
}

// over the 16 lanes that share a tile row (one half-warp)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

// Stage rows [row0, row0 + kT) of a (S, D) matrix, zeros past S.
template <int D>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int S) {
#pragma unroll
  for (int it = 0; it < kT * D / 4 / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S) x = load4(src + (int64_t)(row0 + r) * D + c);
    store4(dst + r * row_str(D) + c, x);
  }
}

// acc[i][j] = sum_d A[ty + 16i][d] * B[tx + 16j][d]: a 64x64 tile of A.B^T
template <int D>
__device__ __forceinline__ void mm_abt(float (&acc)[4][4], const float* A,
                                       const float* B, int tx, int ty) {
  constexpr int kStr = row_str(D);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = load4(A + (ty + 16 * i) * kStr + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = load4(B + (tx + 16 * j) * kStr + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// acc[i][4g + e] += sum_c A[ty + 16i][c] * B[c][64g + 4tx + e]: a 64xD
// tile of A.B (A a 64x64 tile)
template <int D>
__device__ __forceinline__ void mm_ab(float (&acc)[4][D / 16],
                                      const float* A, const float* B, int tx,
                                      int ty) {
  constexpr int kStr = row_str(D);
#pragma unroll 2
  for (int c = 0; c < kT; c += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = load4(A + (ty + 16 * i) * kStr + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
      for (int g = 0; g < D / 64; ++g) {
        const float4 b = load4(B + (c + cc) * kStr + 64 * g + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float w = comp(a[i], cc);
          acc[i][4 * g] = fmaf(w, b.x, acc[i][4 * g]);
          acc[i][4 * g + 1] = fmaf(w, b.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(w, b.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(w, b.w, acc[i][4 * g + 3]);
        }
      }
    }
  }
}

// this thread's share of a 64xD tile, row i's values times mul[i], out to
// rows row0 + ty + 16i below S of a (S, D) matrix
template <int D>
__device__ __forceinline__ void store_rows(float* __restrict__ dst,
                                           const float (&acc)[4][D / 16],
                                           const float (&mul)[4], int row0,
                                           int S, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r < S) {
#pragma unroll
      for (int g = 0; g < D / 64; ++g)
        store4(dst + (int64_t)r * D + 64 * g + 4 * tx,
               make_float4(acc[i][4 * g] * mul[i], acc[i][4 * g + 1] * mul[i],
                           acc[i][4 * g + 2] * mul[i],
                           acc[i][4 * g + 3] * mul[i]));
    }
  }
}

// CTAs an SM the float32 kernels budget registers for: two at D = 64, one
// at D = 128 (whose staged tiles take 135-204 KB of shared memory)
__host__ __device__ constexpr int cc_ctas(int d) { return d == 64 ? 2 : 1; }

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, cc_ctas(D))
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int S, float scale) {
  constexpr int kStr = row_str(D), kTile = tile_floats(D);
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kTile;
  float* vs = ks + kTile;
  float* ps = vs + kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nt = (S + kT - 1) / kT;
  const int qt = nt - 1 - blockIdx.y;  // the heaviest causal tiles first
  const int q0 = qt * kT;
  const int64_t base = (int64_t)blockIdx.x * S * D;

  load_tile<D>(qs, q + base, q0, S);
  float m[4], l[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < D / 16; ++e) acc[i][e] = 0.f;
  }

  const int nk = CAUSAL ? qt + 1 : nt;
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();  // the previous tile's P.V is done with ks, vs, ps
    load_tile<D>(ks, k + base, kt * kT, S);
    load_tile<D>(vs, v + base, kt * kT, S);
    __syncthreads();
    float s[4][4];
    mm_abt<D>(s, qs, ks, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = kt * kT + tx + 16 * j;
        const bool seen = c < S && (!CAUSAL || c <= r);
        s[i][j] = seen ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        psum += p;
        ps[(ty + 16 * i) * kStr + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + row_sum(psum);
#pragma unroll
      for (int e = 0; e < D / 16; ++e) acc[i][e] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();
    mm_ab<D>(acc, ps, vs, tx, ty);
  }

  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    const float ll = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / ll;
    if (r < S && tx == 0) lse[(int64_t)blockIdx.x * S + r] = m[i] + logf(ll);
  }
  store_rows<D>(o + base, acc, inv, q0, S, tx, ty);
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, cc_ctas(D))
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ dlse, float* __restrict__ dq,
                    int S, float scale) {
  constexpr int kStr = row_str(D), kTile = tile_floats(D);
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + kTile;
  float* ks = dos + kTile;
  float* vs = ks + kTile;
  float* dss = vs + kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nt = (S + kT - 1) / kT;
  const int qt = nt - 1 - blockIdx.y;  // the heaviest causal tiles first
  const int q0 = qt * kT;
  const int64_t base = (int64_t)blockIdx.x * S * D;
  const int64_t rbase = (int64_t)blockIdx.x * S;

  load_tile<D>(qs, q + base, q0, S);
  load_tile<D>(dos, dout + base, q0, S);
  float lse_r[4], delta_r[4], dlse_r[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    const bool in = r < S;
    lse_r[i] = in ? lse[rbase + r] : 0.f;
    delta_r[i] = in ? delta[rbase + r] : 0.f;
    dlse_r[i] = in && dlse != nullptr ? dlse[rbase + r] : 0.f;
#pragma unroll
    for (int e = 0; e < D / 16; ++e) acc[i][e] = 0.f;
  }

  const int nk = CAUSAL ? qt + 1 : nt;
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();  // the previous tile's dS.K is done with ks, vs, dss
    load_tile<D>(ks, k + base, kt * kT, S);
    load_tile<D>(vs, v + base, kt * kT, S);
    __syncthreads();
    float s[4][4], dp[4][4];
    mm_abt<D>(s, qs, ks, tx, ty);
    mm_abt<D>(dp, dos, vs, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = kt * kT + tx + 16 * j;
        const bool seen = c < S && (!CAUSAL || c <= r);
        const float p = expf((seen ? s[i][j] * scale : kNegInf) - lse_r[i]);
        dss[(ty + 16 * i) * kStr + tx + 16 * j] =
            p * (dp[i][j] - delta_r[i] + dlse_r[i]) * scale;
      }
    }
    __syncthreads();
    mm_ab<D>(acc, dss, ks, tx, ty);
  }

  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<D>(dq + base, acc, one, q0, S, tx, ty);
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, cc_ctas(D))
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ dlse, float* __restrict__ dk,
                     float* __restrict__ dv, int S, float scale) {
  constexpr int kStr = row_str(D), kTile = tile_floats(D);
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + kTile;
  float* qs = vs + kTile;
  float* dos = qs + kTile;
  float* ps = dos + kTile;
  float* dss = ps + kTile;
  float* lse_s = dss + kTile;  // lse, delta, dlse of the query tile's rows
  float* delta_s = lse_s + kT;
  float* dlse_s = delta_s + kT;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nt = (S + kT - 1) / kT;
  const int k0 = blockIdx.y * kT;  // causal: the first key tiles do the most
  const int64_t base = (int64_t)blockIdx.x * S * D;
  const int64_t rbase = (int64_t)blockIdx.x * S;

  load_tile<D>(ks, k + base, k0, S);
  load_tile<D>(vs, v + base, k0, S);
  float dk_acc[4][D / 16], dv_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < D / 16; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  for (int qt = CAUSAL ? blockIdx.y : 0; qt < nt; ++qt) {
    const int q0 = qt * kT;
    __syncthreads();  // the previous tile's products are done with its tiles
    load_tile<D>(qs, q + base, q0, S);
    load_tile<D>(dos, dout + base, q0, S);
    if (threadIdx.x < kT) {
      const int r = q0 + threadIdx.x;
      const bool in = r < S;
      lse_s[threadIdx.x] = in ? lse[rbase + r] : 0.f;
      delta_s[threadIdx.x] = in ? delta[rbase + r] : 0.f;
      dlse_s[threadIdx.x] = in && dlse != nullptr ? dlse[rbase + r] : 0.f;
    }
    __syncthreads();
    // transposed tiles: rows are keys (ty + 16i), columns queries (tx + 16j)
    float p[4][4], dp[4][4];
    mm_abt<D>(p, ks, qs, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = q0 + tx + 16 * j;
        const bool seen = r < S && c < S && (!CAUSAL || c <= r);
        const float sv = seen ? p[i][j] * scale : kNegInf;
        p[i][j] = expf(sv - lse_s[tx + 16 * j]);
        ps[(ty + 16 * i) * kStr + tx + 16 * j] = p[i][j];
      }
    }
    mm_abt<D>(dp, vs, dos, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        dss[(ty + 16 * i) * kStr + r] =
            p[i][j] * (dp[i][j] - delta_s[r] + dlse_s[r]) * scale;
      }
    __syncthreads();
    mm_ab<D>(dv_acc, ps, dos, tx, ty);
    mm_ab<D>(dk_acc, dss, qs, tx, ty);
  }

  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<D>(dk + base, dk_acc, one, k0, S, tx, ty);
  store_rows<D>(dv + base, dv_acc, one, k0, S, tx, ty);
}

// ------------------------------------------------- the tensor-core path --
constexpr int kTcThreads = 256;  // two warpgroups of 64 tile rows each
constexpr int kFwdBM = 128;      // forward: query rows of a CTA
constexpr int kDqBM = 128;       // dQ: query rows of a CTA
constexpr int kDkvBK = 128;      // dK/dV: key rows of a CTA
constexpr int kDkvBQ = 64;       // dK/dV: query rows of a ring stage
constexpr int kTcStages = 2;     // ring depth
constexpr int kMaxSmem = 232448; // a CTA's shared memory on sm_90
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// forward: keys of a ring stage (S and O accumulators of a thread: 64 + 32
// floats at D = 64, 32 + 64 at D = 128)
__host__ __device__ constexpr int fwd_bn(int d) { return d == 64 ? 128 : 64; }

// dQ: keys of a ring stage (S, dP and dQ accumulators of a thread: 64 + 64
// + 32 floats at D = 64, 32 + 32 + 64 at D = 128)
__host__ __device__ constexpr int dq_bn(int d) { return d == 64 ? 128 : 64; }

// bytes of a tile of `rows` bf16 rows of d values
__host__ __device__ constexpr int tile_bytes(int rows, int d) {
  return rows * d * 2;
}

// Dynamic shared memory of one CTA: 1 KiB of slack to align the tiles to
// the 1024-byte swizzle atom, then
//   forward: the Q tile and kTcStages stages of (K, V) tiles;
//   dQ:      the Q and dO tiles and kTcStages stages of (K, V) tiles;
//   dK/dV:   the K and V tiles, kTcStages stages of (Q, dO) tiles, and
//            kTcStages stages of the lse, delta and dlse rows.
// ops/flash_attention.py's `tc_plan` mirrors it for the host.
__host__ __device__ constexpr int fwd_tc_smem(int d) {
  return 1024 + tile_bytes(kFwdBM, d) +
         kTcStages * 2 * tile_bytes(fwd_bn(d), d);
}
__host__ __device__ constexpr int dq_tc_smem(int d) {
  return 1024 + 2 * tile_bytes(kDqBM, d) +
         kTcStages * 2 * tile_bytes(dq_bn(d), d);
}
__host__ __device__ constexpr int dkv_tc_smem(int d) {
  return 1024 + 2 * tile_bytes(kDkvBK, d) +
         kTcStages * (2 * tile_bytes(kDkvBQ, d) + 3 * kDkvBQ * 4);
}
static_assert(fwd_tc_smem(128) <= kMaxSmem && dq_tc_smem(128) <= kMaxSmem &&
                  dkv_tc_smem(128) <= kMaxSmem,
              "a CTA's tiles must fit its shared memory");

// byte offset of the 16-byte chunk holding columns c .. c + 7 (c % 8 == 0)
// of row r in a tile of `rows` rows: 64-wide blocks of swizzled rows
__device__ __forceinline__ uint32_t tile_off(int rows, int r, int c) {
  return (uint32_t)((c >> 6) * rows * kSwizzleRowBytes) +
         swz(r, (c & 63) >> 3);
}

// 4 bytes global -> shared; src-size 0 (valid = false) fills zeros
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Rows [row0, row0 + ROWS) of a (S, D) bf16 matrix into a tile, zeros past
// S; every thread of the CTA issues its share of 16-byte copies.
template <int ROWS, int D>
__device__ __forceinline__ void load_tile_async(
    uint32_t dst, const __nv_bfloat16* __restrict__ src, int row0, int S) {
  constexpr int kChunks = ROWS * D / 8;
  static_assert(kChunks % kTcThreads == 0, "whole copies a thread");
#pragma unroll
  for (int i = 0; i < kChunks / kTcThreads; ++i) {
    const int idx = threadIdx.x + i * kTcThreads;
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    const bool ok = row0 + r < S;
    cp_async16(dst + tile_off(ROWS, r, c),
               ok ? src + (int64_t)(row0 + r) * D + c : src, ok);
  }
}

// wgmma descriptor of k16 step ks of a K-major operand: rows [r0, r0 + M)
// of a tile of `rows` rows (r0 a multiple of 8), depth = the tile's columns
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int r0,
                                           int ks) {
  return wgmma_desc(tile + (ks >> 2) * rows * kSwizzleRowBytes +
                        r0 * kSwizzleRowBytes + (ks & 3) * 32,
                    16, 1024);
}

// wgmma descriptor of k16 step ks of an MN-major operand (transpose bit):
// depth = rows 16 ks .. 16 ks + 15 of a tile of `rows` rows, N = its columns
// (the 64-wide blocks `rows` swizzle rows apart)
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int ks) {
  return wgmma_desc(tile + ks * 16 * kSwizzleRowBytes,
                    rows * kSwizzleRowBytes, 1024);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Columns 16t .. 16t + 15 of an m64nN f32 accumulator, rounded to bf16, as
// the register A operand of k16 step t: the accumulator holds (row, col)
// pairs (r, 16t + 2q), (r + 8, ..), (r, 16t + 8 + 2q), (r + 8, ..) in
// d[8t .. 8t + 7] (q = lane % 4), which is A's fragment order.
template <int R>
__device__ __forceinline__ void to_a_frag(uint32_t (&a)[4],
                                          const float (&d)[R], int t) {
  a[0] = pack_bf16(d[8 * t], d[8 * t + 1]);
  a[1] = pack_bf16(d[8 * t + 2], d[8 * t + 3]);
  a[2] = pack_bf16(d[8 * t + 4], d[8 * t + 5]);
  a[3] = pack_bf16(d[8 * t + 6], d[8 * t + 7]);
}

// over the 4 lanes that share an accumulator row (a quad)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFullMask, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFullMask, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFullMask, x, 1);
  return x + __shfl_xor_sync(kFullMask, x, 2);
}

// barrier of one warpgroup's 128 threads (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// This warpgroup's (64 x D) f32 accumulator, row r's values times
// (r's half of the fragment ? sb : sa), rounded to bf16 into rows
// [64 wg, 64 wg + 64) of `tile` (ROWS rows, no longer read by anyone),
// then out as 16-byte stores to rows [row0, row0 + 64) of a (S, D) matrix,
// those below S.
template <int ROWS, int D>
__device__ __forceinline__ void store_acc(const float (&acc)[D / 2], float sa,
                                          float sb, uint8_t* tile,
                                          __nv_bfloat16* __restrict__ dst,
                                          int row0, int S) {
  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;
  const int r = 64 * wg + 16 * ((tid >> 5) & 3) + (lane >> 2);
  const int c = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j;
    *reinterpret_cast<uint32_t*>(tile + tile_off(ROWS, r, col) + c * 2) =
        pack_bf16(acc[4 * j] * sa, acc[4 * j + 1] * sa);
    *reinterpret_cast<uint32_t*>(tile + tile_off(ROWS, r + 8, col) + c * 2) =
        pack_bf16(acc[4 * j + 2] * sb, acc[4 * j + 3] * sb);
  }
  wg_barrier(wg);
  for (int idx = tid & 127; idx < 64 * D / 8; idx += 128) {
    const int rr = idx / (D / 8), cc = (idx % (D / 8)) * 8;
    if (row0 + rr < S)
      *reinterpret_cast<uint4*>(dst + (int64_t)(row0 + rr) * D + cc) =
          *reinterpret_cast<const uint4*>(tile +
                                          tile_off(ROWS, 64 * wg + rr, cc));
  }
}

// One CTA per (b*h, query tile of kFwdBM rows); warpgroup g owns rows
// 64g .. 64g + 63. scale_log2 = scale * log2(e).
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int S, float scale_log2) {
  constexpr int BN = fwd_bn(D);
  constexpr int kQ = tile_bytes(kFwdBM, D);
  constexpr int kKV = tile_bytes(BN, D);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* q_tile = smem;
  const uint32_t q_s = smem_u32(q_tile);
  const uint32_t kv_s = q_s + kQ;   // stage st: K at + 2 st kKV, V after it

  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;
  const int nq = (S + kFwdBM - 1) / kFwdBM;
  const int q0 = (nq - 1 - (int)blockIdx.y) * kFwdBM;  // heaviest first
  const int wq0 = q0 + 64 * wg;    // this warpgroup's first query row
  const int64_t base = (int64_t)blockIdx.x * S * D;
  const int nkt = (S + BN - 1) / BN;
  const int nk = CAUSAL ? min(nkt, (q0 + kFwdBM + BN - 1) / BN) : nkt;
  const int nk_wg = CAUSAL ? min(nk, (wq0 + 64 + BN - 1) / BN) : nk;
  // this thread's accumulator rows and the first of its column pairs
  const int r_a = wq0 + 16 * ((tid >> 5) & 3) + (lane >> 2), r_b = r_a + 8;
  const int c_lane = 2 * (lane & 3);

  load_tile_async<kFwdBM, D>(q_s, q + base, q0, S);
  load_tile_async<BN, D>(kv_s, k + base, 0, S);
  load_tile_async<BN, D>(kv_s + kKV, v + base, 0, S);
  cp_async_commit();

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<0>();   // tile kt has landed (this thread's copies)
    fence_proxy_async();
    __syncthreads();      // everyone's; tile kt - 1's stage is free
    if (kt + 1 < nk) {
      const uint32_t st = kv_s + ((kt + 1) & 1) * 2 * kKV;
      load_tile_async<BN, D>(st, k + base, (kt + 1) * BN, S);
      load_tile_async<BN, D>(st + kKV, v + base, (kt + 1) * BN, S);
    }
    cp_async_commit();
    if (kt >= nk_wg) continue;    // above this warpgroup's diagonal
    const uint32_t k_s = kv_s + (kt & 1) * 2 * kKV, v_s = k_s + kKV;
    const int k0 = kt * BN;

    // S = Q . K^T
    float s[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss<0>(s, desc_k(q_s, kFwdBM, 64 * wg, ks),
                  desc_k(k_s, BN, 0, ks));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // online softmax in the log2 domain
    const bool masked = (CAUSAL && k0 + BN - 1 > wq0) || k0 + BN > S;
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float xa = s[4 * j + e] * scale_log2;
        float xb = s[4 * j + 2 + e] * scale_log2;
        if (masked) {
          const int c = k0 + 8 * j + c_lane + e;
          if (c >= S || (CAUSAL && c > r_a)) xa = kNegInf;
          if (c >= S || (CAUSAL && c > r_b)) xb = kNegInf;
        }
        s[4 * j + e] = xa;
        s[4 * j + 2 + e] = xb;
        mx_a = fmaxf(mx_a, xa);
        mx_b = fmaxf(mx_b, xb);
      }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * j + e] = exp2f(s[4 * j + e] - m_a);
        s[4 * j + 2 + e] = exp2f(s[4 * j + 2 + e] - m_b);
        ps_a += s[4 * j + e];
        ps_b += s[4 * j + 2 + e];
      }
    l_a = l_a * al_a + ps_a;   // this thread's share of the row sums
    l_b = l_b * al_b + ps_b;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j] *= al_a;
      acc[4 * j + 1] *= al_a;
      acc[4 * j + 2] *= al_b;
      acc[4 * j + 3] *= al_b;
    }

    // O += bf16(P) . V, P from registers
    uint32_t pf[BN / 16][4];
#pragma unroll
    for (int t = 0; t < BN / 16; ++t) to_a_frag(pf[t], s, t);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < BN / 16; ++t)
      wgmma_rs<1>(acc, pf[t], desc_mn(v_s, BN, t));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }
  cp_async_wait<0>();

  l_a = fmaxf(quad_sum(l_a), 1e-30f);
  l_b = fmaxf(quad_sum(l_b), 1e-30f);
  if ((lane & 3) == 0) {
    const int64_t rbase = (int64_t)blockIdx.x * S;
    if (r_a < S) lse[rbase + r_a] = (m_a + log2f(l_a)) * kLn2;
    if (r_b < S) lse[rbase + r_b] = (m_b + log2f(l_b)) * kLn2;
  }
  // Q's rows of this warpgroup are read by no one now
  store_acc<kFwdBM, D>(acc, 1.f / l_a, 1.f / l_b, q_tile, o + base, wq0, S);
}

// One CTA per (b*h, key tile of kDkvBK rows); warpgroup g owns keys
// 64g .. 64g + 63. scale_log2 = scale * log2(e).
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dkv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ dlse,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int S, float scale,
                        float scale_log2) {
  constexpr int BQ = kDkvBQ;
  constexpr int kKV = tile_bytes(kDkvBK, D);
  constexpr int kQ = tile_bytes(BQ, D);
  constexpr int kRow = BQ * 4;     // bytes of one staged per-query row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* k_tile = smem;
  uint8_t* v_tile = smem + kKV;
  const uint32_t k_s = smem_u32(k_tile), v_s = k_s + kKV;
  const uint32_t stage_s = v_s + kKV;          // stage st: Q, then dO
  const float* rows = reinterpret_cast<const float*>(
      smem + 2 * kKV + kTcStages * 2 * kQ);    // stage st: lse, delta, dlse
  const uint32_t rows_s = stage_s + kTcStages * 2 * kQ;

  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;
  const int k0 = blockIdx.y * kDkvBK;   // causal: the first key tiles do most
  const int wk0 = k0 + 64 * wg;         // this warpgroup's first key
  const int nq = (S + BQ - 1) / BQ;
  const int i0 = CAUSAL ? k0 / BQ : 0;
  const int i0_wg = CAUSAL ? wk0 / BQ : 0;
  const int64_t base = (int64_t)blockIdx.x * S * D;
  const int64_t rbase = (int64_t)blockIdx.x * S;
  // this thread's accumulator rows (keys) and first column pair (queries)
  const int c_a = wk0 + 16 * ((tid >> 5) & 3) + (lane >> 2), c_b = c_a + 8;
  const int c_lane = 2 * (lane & 3);

  auto load_stage = [&](int qt, int st) {
    const uint32_t q_st = stage_s + st * 2 * kQ;
    load_tile_async<BQ, D>(q_st, q + base, qt * BQ, S);
    load_tile_async<BQ, D>(q_st + kQ, dout + base, qt * BQ, S);
    if (tid < 3 * BQ) {
      const int which = tid / BQ, i = tid % BQ, r = qt * BQ + i;
      const float* src = which == 0 ? lse : which == 1 ? delta : dlse;
      const bool ok = r < S && src != nullptr;
      cp_async4(rows_s + (st * 3 + which) * kRow + i * 4,
                ok ? src + rbase + r : lse, ok);
    }
  };

  load_tile_async<kDkvBK, D>(k_s, k + base, k0, S);
  load_tile_async<kDkvBK, D>(v_s, v + base, k0, S);
  if (i0 < nq) load_stage(i0, 0);
  cp_async_commit();

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int qt = i0; qt < nq; ++qt) {
    const int st = (qt - i0) & 1;
    cp_async_wait<0>();   // stage st has landed (this thread's copies)
    fence_proxy_async();
    __syncthreads();      // everyone's; the other stage is free
    if (qt + 1 < nq) load_stage(qt + 1, st ^ 1);
    cp_async_commit();
    if (qt < i0_wg) continue;    // every query here is before these keys
    const int q0 = qt * BQ;
    const uint32_t q_st = stage_s + st * 2 * kQ, do_st = q_st + kQ;
    const float* lse_s = rows + st * 3 * BQ;
    const float* delta_s = lse_s + BQ;
    const float* dlse_s = delta_s + BQ;

    // S^T = K . Q^T
    float p[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) p[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss<0>(p, desc_k(k_s, kDkvBK, 64 * wg, ks),
                  desc_k(q_st, BQ, 0, ks));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(p);

    // P^T = exp(S^T * scale - lse[query])
    const bool masked =
        (CAUSAL && wk0 + 63 > q0) || q0 + BQ > S || wk0 + 64 > S;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const int col = 8 * j + c_lane;
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float xa = p[4 * j + e] * scale_log2;
        float xb = p[4 * j + 2 + e] * scale_log2;
        if (masked) {
          const int r = q0 + col + e;
          if (r >= S || c_a >= S || (CAUSAL && c_a > r)) xa = kNegInf;
          if (r >= S || c_b >= S || (CAUSAL && c_b > r)) xb = kNegInf;
        }
        const float ll = (e ? l2.y : l2.x) * kLog2e;
        p[4 * j + e] = exp2f(xa - ll);
        p[4 * j + 2 + e] = exp2f(xb - ll);
      }
    }

    // dV += bf16(P^T) . dO
    {
      uint32_t pf[BQ / 16][4];
#pragma unroll
      for (int t = 0; t < BQ / 16; ++t) to_a_frag(pf[t], p, t);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < BQ / 16; ++t)
        wgmma_rs<1>(dv_acc, pf[t], desc_mn(do_st, BQ, t));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv_acc);
    }

    // dP^T = V . dO^T
    float dp[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss<0>(dp, desc_k(v_s, kDkvBK, 64 * wg, ks),
                  desc_k(do_st, BQ, 0, ks));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dp);

    // dS^T = P^T * (dP^T - delta[query] + dlse[query]) * scale
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const int col = 8 * j + c_lane;
      const float2 dl = *reinterpret_cast<const float2*>(delta_s + col);
      const float2 dls = *reinterpret_cast<const float2*>(dlse_s + col);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d0 = e ? dl.y : dl.x, d1 = e ? dls.y : dls.x;
        p[4 * j + e] = p[4 * j + e] * (dp[4 * j + e] - d0 + d1) * scale;
        p[4 * j + 2 + e] =
            p[4 * j + 2 + e] * (dp[4 * j + 2 + e] - d0 + d1) * scale;
      }
    }

    // dK += bf16(dS^T) . Q
    uint32_t df[BQ / 16][4];
#pragma unroll
    for (int t = 0; t < BQ / 16; ++t) to_a_frag(df[t], p, t);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < BQ / 16; ++t)
      wgmma_rs<1>(dk_acc, df[t], desc_mn(q_st, BQ, t));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dk_acc);
  }
  cp_async_wait<0>();

  // K's and V's rows of this warpgroup are read by no one now
  store_acc<kDkvBK, D>(dk_acc, 1.f, 1.f, k_tile, dk + base, wk0, S);
  store_acc<kDkvBK, D>(dv_acc, 1.f, 1.f, v_tile, dv + base, wk0, S);
}

// One CTA per (b*h, query tile of kDqBM rows); warpgroup g owns rows
// 64g .. 64g + 63. scale_log2 = scale * log2(e).
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const float* __restrict__ dlse,
                       __nv_bfloat16* __restrict__ dq, int S, float scale,
                       float scale_log2) {
  constexpr int BN = dq_bn(D);
  constexpr int kQ = tile_bytes(kDqBM, D);
  constexpr int kKV = tile_bytes(BN, D);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* q_tile = smem;
  const uint32_t q_s = smem_u32(q_tile), do_s = q_s + kQ;
  const uint32_t kv_s = do_s + kQ;  // stage st: K at + 2 st kKV, V after it

  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;
  const int nq = (S + kDqBM - 1) / kDqBM;
  const int q0 = (nq - 1 - (int)blockIdx.y) * kDqBM;  // heaviest first
  const int wq0 = q0 + 64 * wg;    // this warpgroup's first query row
  const int64_t base = (int64_t)blockIdx.x * S * D;
  const int64_t rbase = (int64_t)blockIdx.x * S;
  const int nkt = (S + BN - 1) / BN;
  const int nk = CAUSAL ? min(nkt, (q0 + kDqBM + BN - 1) / BN) : nkt;
  const int nk_wg = CAUSAL ? min(nk, (wq0 + 64 + BN - 1) / BN) : nk;
  // this thread's accumulator rows and the first of its column pairs
  const int r_a = wq0 + 16 * ((tid >> 5) & 3) + (lane >> 2), r_b = r_a + 8;
  const int c_lane = 2 * (lane & 3);

  load_tile_async<kDqBM, D>(q_s, q + base, q0, S);
  load_tile_async<kDqBM, D>(do_s, dout + base, q0, S);
  load_tile_async<BN, D>(kv_s, k + base, 0, S);
  load_tile_async<BN, D>(kv_s + kKV, v + base, 0, S);
  cp_async_commit();

  // the rows' lse (log2 domain), delta and dlse; rows past S read nothing
  float ll_a = 0.f, ll_b = 0.f, dl_a = 0.f, dl_b = 0.f, g_a = 0.f, g_b = 0.f;
  if (r_a < S) {
    ll_a = lse[rbase + r_a] * kLog2e;
    dl_a = delta[rbase + r_a];
    if (dlse != nullptr) g_a = dlse[rbase + r_a];
  }
  if (r_b < S) {
    ll_b = lse[rbase + r_b] * kLog2e;
    dl_b = delta[rbase + r_b];
    if (dlse != nullptr) g_b = dlse[rbase + r_b];
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<0>();   // tile kt has landed (this thread's copies)
    fence_proxy_async();
    __syncthreads();      // everyone's; tile kt - 1's stage is free
    if (kt + 1 < nk) {
      const uint32_t st = kv_s + ((kt + 1) & 1) * 2 * kKV;
      load_tile_async<BN, D>(st, k + base, (kt + 1) * BN, S);
      load_tile_async<BN, D>(st + kKV, v + base, (kt + 1) * BN, S);
    }
    cp_async_commit();
    if (kt >= nk_wg) continue;    // above this warpgroup's diagonal
    const uint32_t k_s = kv_s + (kt & 1) * 2 * kKV, v_s = k_s + kKV;
    const int k0 = kt * BN;

    // S = Q . K^T
    float s[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss<0>(s, desc_k(q_s, kDqBM, 64 * wg, ks), desc_k(k_s, BN, 0, ks));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // P = exp(S * scale - lse), masked before the exp2
    const bool masked = (CAUSAL && k0 + BN - 1 > wq0) || k0 + BN > S;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float xa = s[4 * j + e] * scale_log2;
        float xb = s[4 * j + 2 + e] * scale_log2;
        if (masked) {
          const int c = k0 + 8 * j + c_lane + e;
          if (c >= S || (CAUSAL && c > r_a)) xa = kNegInf;
          if (c >= S || (CAUSAL && c > r_b)) xb = kNegInf;
        }
        s[4 * j + e] = exp2f(xa - ll_a);
        s[4 * j + 2 + e] = exp2f(xb - ll_b);
      }

    // dP = dO . V^T
    float dp[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss<0>(dp, desc_k(do_s, kDqBM, 64 * wg, ks),
                  desc_k(v_s, BN, 0, ks));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dp);

    // dS = P * (dP - delta + dlse) * scale
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - dl_a + g_a) * scale;
        s[4 * j + 2 + e] =
            s[4 * j + 2 + e] * (dp[4 * j + 2 + e] - dl_b + g_b) * scale;
      }

    // dQ += bf16(dS) . K, dS from registers, K read MN-major
    uint32_t df[BN / 16][4];
#pragma unroll
    for (int t = 0; t < BN / 16; ++t) to_a_frag(df[t], s, t);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < BN / 16; ++t)
      wgmma_rs<1>(acc, df[t], desc_mn(k_s, BN, t));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }
  cp_async_wait<0>();

  // Q's rows of this warpgroup are read by no one now
  store_acc<kDqBM, D>(acc, 1.f, 1.f, q_tile, dq + base, wq0, S);
}

template <typename K, typename... Args>
cudaError_t launch_tc(K kernel, int smem, dim3 grid, cudaStream_t stream,
                      Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kTcThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

using bf16 = __nv_bfloat16;

template <int D>
cudaError_t fwd_tc(const void* q, const void* k, const void* v, void* o,
                   float* lse, int BH, int S, float scale, bool causal,
                   cudaStream_t st) {
  const dim3 grid(BH, (S + kFwdBM - 1) / kFwdBM);
  const float sl = scale * kLog2e;
  return causal ? launch_tc(flash_fwd_tc_kernel<D, true>, fwd_tc_smem(D),
                            grid, st, (const bf16*)q, (const bf16*)k,
                            (const bf16*)v, (bf16*)o, lse, S, sl)
                : launch_tc(flash_fwd_tc_kernel<D, false>, fwd_tc_smem(D),
                            grid, st, (const bf16*)q, (const bf16*)k,
                            (const bf16*)v, (bf16*)o, lse, S, sl);
}

template <int D>
cudaError_t dq_tc(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  const float* dlse, void* dq, int BH, int S, float scale,
                  bool causal, cudaStream_t st) {
  const dim3 grid(BH, (S + kDqBM - 1) / kDqBM);
  const float sl = scale * kLog2e;
  return causal
             ? launch_tc(flash_bwd_dq_tc_kernel<D, true>, dq_tc_smem(D), grid,
                         st, (const bf16*)q, (const bf16*)k, (const bf16*)v,
                         (const bf16*)dout, lse, delta, dlse, (bf16*)dq, S,
                         scale, sl)
             : launch_tc(flash_bwd_dq_tc_kernel<D, false>, dq_tc_smem(D),
                         grid, st, (const bf16*)q, (const bf16*)k,
                         (const bf16*)v, (const bf16*)dout, lse, delta, dlse,
                         (bf16*)dq, S, scale, sl);
}

template <int D>
cudaError_t dkv_tc(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   const float* dlse, void* dk, void* dv, int BH, int S,
                   float scale, bool causal, cudaStream_t st) {
  const dim3 grid(BH, (S + kDkvBK - 1) / kDkvBK);
  const float sl = scale * kLog2e;
  return causal
             ? launch_tc(flash_bwd_dkv_tc_kernel<D, true>, dkv_tc_smem(D),
                         grid, st, (const bf16*)q, (const bf16*)k,
                         (const bf16*)v, (const bf16*)dout, lse, delta, dlse,
                         (bf16*)dk, (bf16*)dv, S, scale, sl)
             : launch_tc(flash_bwd_dkv_tc_kernel<D, false>, dkv_tc_smem(D),
                         grid, st, (const bf16*)q, (const bf16*)k,
                         (const bf16*)v, (const bf16*)dout, lse, delta, dlse,
                         (bf16*)dk, (bf16*)dv, S, scale, sl);
}

// the shape checks every tensor-core entry shares; 0 means launch
int check_tc_shape(int S, int D) {
  if ((D != 64 && D != 128) || (S + 127) / 128 > 65535)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// dynamic shared memory of each CUDA-core kernel, in bytes (all above the
// 48 KB a launch gets without opting in)
__host__ __device__ constexpr int fwd_smem(int d) {
  return 4 * tile_floats(d) * (int)sizeof(float);
}
__host__ __device__ constexpr int dq_smem(int d) {
  return 5 * tile_floats(d) * (int)sizeof(float);
}
__host__ __device__ constexpr int dkv_smem(int d) {
  return (6 * tile_floats(d) + 3 * kT) * (int)sizeof(float);
}
static_assert(dkv_smem(128) <= kMaxSmem,
              "a CTA's staged tiles must fit its shared memory");

template <typename K, typename... Args>
cudaError_t launch(K kernel, int smem, int BH, int S, cudaStream_t stream,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(BH, (S + kT - 1) / kT);
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// the shape checks every CUDA-core entry shares (float32 at D = 64 or
// 128; bfloat16 is the tensor-core entries'); 0 means launch
int check_shape(int S, int D, int dtype) {
  if ((D != 64 && D != 128) || dtype != kF32 || (S + kT - 1) / kT > 65535)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <int D>
cudaError_t fwd_cc(const float* q, const float* k, const float* v, float* o,
                   float* lse, int BH, int S, float scale, bool causal,
                   cudaStream_t st) {
  return causal ? launch(flash_fwd_kernel<D, true>, fwd_smem(D), BH, S, st,
                         q, k, v, o, lse, S, scale)
                : launch(flash_fwd_kernel<D, false>, fwd_smem(D), BH, S, st,
                         q, k, v, o, lse, S, scale);
}

template <int D>
cudaError_t dq_cc(const float* q, const float* k, const float* v,
                  const float* dout, const float* lse, const float* delta,
                  const float* dlse, float* dq, int BH, int S, float scale,
                  bool causal, cudaStream_t st) {
  return causal ? launch(flash_bwd_dq_kernel<D, true>, dq_smem(D), BH, S, st,
                         q, k, v, dout, lse, delta, dlse, dq, S, scale)
                : launch(flash_bwd_dq_kernel<D, false>, dq_smem(D), BH, S,
                         st, q, k, v, dout, lse, delta, dlse, dq, S, scale);
}

template <int D>
cudaError_t dkv_cc(const float* q, const float* k, const float* v,
                   const float* dout, const float* lse, const float* delta,
                   const float* dlse, float* dk, float* dv, int BH, int S,
                   float scale, bool causal, cudaStream_t st) {
  return causal
             ? launch(flash_bwd_dkv_kernel<D, true>, dkv_smem(D), BH, S, st,
                      q, k, v, dout, lse, delta, dlse, dk, dv, S, scale)
             : launch(flash_bwd_dkv_kernel<D, false>, dkv_smem(D), BH, S, st,
                      q, k, v, dout, lse, delta, dlse, dk, dv, S, scale);
}

}  // namespace
}  // namespace bigdl

// The CUDA-core entries: q, k, v, o, dout, dq, dk, dv (B*H, S, D) float32
// (`dtype` must be 0), 16-byte aligned, D = 64 or 128; lse, delta, dlse
// (B*H, S) float32, dlse may be null (zero). causal: 0 or 1. Each returns
// the cudaError_t of its launch (0 on success).
extern "C" int bigdl_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, float* lse, int BH, int S, int D,
                               float scale, int causal, int dtype,
                               void* stream) {
  using namespace bigdl;
  if (int bad = check_shape(S, D, dtype)) return bad;
  if (BH <= 0 || S <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const float *fq = (const float*)q, *fk = (const float*)k,
              *fv = (const float*)v;
  const bool c = causal != 0;
  const cudaError_t err =
      D == 64 ? fwd_cc<64>(fq, fk, fv, (float*)o, lse, BH, S, scale, c, st)
              : fwd_cc<128>(fq, fk, fv, (float*)o, lse, BH, S, scale, c, st);
  return (int)err;
}

extern "C" int bigdl_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, const float* dlse,
                                  void* dq, int BH, int S, int D, float scale,
                                  int causal, int dtype, void* stream) {
  using namespace bigdl;
  if (int bad = check_shape(S, D, dtype)) return bad;
  if (BH <= 0 || S <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const float *fq = (const float*)q, *fk = (const float*)k,
              *fv = (const float*)v, *fdo = (const float*)dout;
  const bool c = causal != 0;
  const cudaError_t err =
      D == 64 ? dq_cc<64>(fq, fk, fv, fdo, lse, delta, dlse, (float*)dq, BH,
                          S, scale, c, st)
              : dq_cc<128>(fq, fk, fv, fdo, lse, delta, dlse, (float*)dq, BH,
                           S, scale, c, st);
  return (int)err;
}

extern "C" int bigdl_flash_bwd_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   const float* dlse, void* dk, void* dv,
                                   int BH, int S, int D, float scale,
                                   int causal, int dtype, void* stream) {
  using namespace bigdl;
  if (int bad = check_shape(S, D, dtype)) return bad;
  if (BH <= 0 || S <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const float *fq = (const float*)q, *fk = (const float*)k,
              *fv = (const float*)v, *fdo = (const float*)dout;
  const bool c = causal != 0;
  const cudaError_t err =
      D == 64 ? dkv_cc<64>(fq, fk, fv, fdo, lse, delta, dlse, (float*)dk,
                           (float*)dv, BH, S, scale, c, st)
              : dkv_cc<128>(fq, fk, fv, fdo, lse, delta, dlse, (float*)dk,
                            (float*)dv, BH, S, scale, c, st);
  return (int)err;
}

// The tensor-core entries: q, k, v, o, dout, dq, dk, dv (B*H, S, D)
// bfloat16, lse, delta, dlse as above; D = 64 or 128. Each picks its own
// tiles and dynamic shared memory from (B*H, S, D) (fwd_tc_smem,
// dq_tc_smem, dkv_tc_smem; above the 48 KB a launch gets without opting
// in) and returns the cudaError_t of its launch (0 on success).
extern "C" int bigdl_flash_fwd_tc(const void* q, const void* k, const void* v,
                                  void* o, float* lse, int BH, int S, int D,
                                  float scale, int causal, void* stream) {
  using namespace bigdl;
  if (int bad = check_tc_shape(S, D)) return bad;
  if (BH <= 0 || S <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      D == 64 ? fwd_tc<64>(q, k, v, o, lse, BH, S, scale, causal != 0, st)
              : fwd_tc<128>(q, k, v, o, lse, BH, S, scale, causal != 0, st);
  return (int)err;
}

extern "C" int bigdl_flash_bwd_dq_tc(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* delta,
                                     const float* dlse, void* dq, int BH,
                                     int S, int D, float scale, int causal,
                                     void* stream) {
  using namespace bigdl;
  if (int bad = check_tc_shape(S, D)) return bad;
  if (BH <= 0 || S <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const bool c = causal != 0;
  const cudaError_t err =
      D == 64 ? dq_tc<64>(q, k, v, dout, lse, delta, dlse, dq, BH, S, scale,
                          c, st)
              : dq_tc<128>(q, k, v, dout, lse, delta, dlse, dq, BH, S, scale,
                           c, st);
  return (int)err;
}

extern "C" int bigdl_flash_bwd_dkv_tc(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* delta,
                                      const float* dlse, void* dk, void* dv,
                                      int BH, int S, int D, float scale,
                                      int causal, void* stream) {
  using namespace bigdl;
  if (int bad = check_tc_shape(S, D)) return bad;
  if (BH <= 0 || S <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const bool c = causal != 0;
  const cudaError_t err =
      D == 64 ? dkv_tc<64>(q, k, v, dout, lse, delta, dlse, dk, dv, BH, S,
                           scale, c, st)
              : dkv_tc<128>(q, k, v, dout, lse, delta, dlse, dk, dv, BH, S,
                            scale, c, st);
  return (int)err;
}
