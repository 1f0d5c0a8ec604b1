// Flash attention for Hopper (sm_90a): the FlashAttention-2 forward and its
// two backward kernels (dQ; dK with dV), causal or full, over (B*H, S, D)
// tensors.
//
// Replaces the TPU kernels of bigdl_tpu/ops/flash_attention.py:
//   flash_fwd_kernel     <- `_fwd_kernel` (:45), launched by `_fwd` (:89)
//   flash_bwd_dq_kernel  <- `_bwd_dq_kernel` (:120), `_bwd_impl` call :217
//   flash_bwd_dkv_kernel <- `_bwd_dkv_kernel` (:159), `_bwd_impl` call :238
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
// the cotangent of lse (a null pointer means zero).
//
// What bounds them: operations. Each visible (query, key) pair costs 4*D
// flops (two products of D) while q, k, v and the outputs move once; in
// float32 the products run on the CUDA cores (TF32 stays off, 67 TFLOP/s)
// and the function sits far above the card's balance point. In bfloat16 the
// function is bound by bytes at the tensor cores' rate, but this first
// version computes in float32 on the CUDA cores in both types; wgmma and
// TMA are later work.
//
// What the design does about it:
// - one CTA of 256 threads per (b*h, 64-row tile). The forward and dQ own a
//   query tile and loop over key tiles, up to the diagonal when causal (the
//   reference's ((qi+1)*bq + bk - 1)//bk with bq = bk = 64); dK/dV owns a
//   key tile and loops over query tiles from the diagonal (the reference's
//   (ki*bk)//bq) to the end. No atomics: every output element has exactly
//   one writer, so results repeat bit for bit from run to run.
// - tiles are staged in shared memory as float32 rows padded to D + 4
//   floats, so a half-warp's float4 reads of 16 rows take two wavefronts
//   (the least for 256 bytes) and two rows 68 floats apart never collide.
//   Thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16*i (i < 4) of a
//   64x64 score tile and its columns tx + 16*j (j < 4); of a 64xD output
//   tile it owns the same rows and the columns 4*tx .. 4*tx + 3. Each inner
//   step reads 8 float4 for 64 FMAs. Softmax row reductions are four
//   xor-shuffles inside a half-warp.
// - m, l and the output accumulators live in registers for the whole loop;
//   P (or dS) goes through shared memory once per tile, for the second
//   product.
// - the heaviest tiles launch first: under causal masking the last query
//   tiles (forward, dQ) and the first key tiles (dK/dV) do the most work.
// - bfloat16 inputs are widened to float32 as they are staged; p is rounded
//   to bfloat16 before the P.V and P^T.dO products and ds before both of its
//   products, as the reference does (:70, :150, :186, :192).
// - ragged S: rows past S stage as zeros, their scores are masked, nothing
//   past S is stored; S need not be a multiple of the tile.
// Offsets into the (B*H, S, D) tensors are 64-bit.

#include "common.cuh"

namespace bigdl {
namespace {

constexpr int kD = 64;            // head_dim the kernels are built for
constexpr int kT = 64;            // rows of a query tile and of a key tile
constexpr int kThreads = 256;
constexpr int kStr = kD + 4;      // padded shared-memory row, in floats
constexpr int kTile = kT * kStr;  // floats of one staged tile
static_assert(kD == 64 && kT == 64 && kThreads == 256,
              "the thread-to-tile map assumes 16x16 threads on 64x64 tiles");

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&a);
  u.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// x as the product's operand in the input type: bfloat16 rounds
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
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

// Stage rows [row0, row0 + kT) of a (S, kD) matrix as float32, zeros past S.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst,
                                          const T* __restrict__ src, int row0,
                                          int S) {
#pragma unroll
  for (int it = 0; it < kT * kD / 4 / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / (kD / 4), c = (i % (kD / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S) x = load4(src + (int64_t)(row0 + r) * kD + c);
    store4(dst + r * kStr + c, x);
  }
}

// acc[i][j] = sum_d A[ty + 16i][d] * B[tx + 16j][d]: a 64x64 tile of A.B^T
__device__ __forceinline__ void mm_abt(float (&acc)[4][4], const float* A,
                                       const float* B, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < kD; d += 4) {
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

// acc[i][e] += sum_c A[ty + 16i][c] * B[c][4tx + e]: a 64xD tile of A.B
__device__ __forceinline__ void mm_ab(float (&acc)[4][4], const float* A,
                                      const float* B, int tx, int ty) {
#pragma unroll 2
  for (int c = 0; c < kT; c += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = load4(A + (ty + 16 * i) * kStr + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const float4 b = load4(B + (c + cc) * kStr + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float w = comp(a[i], cc);
        acc[i][0] = fmaf(w, b.x, acc[i][0]);
        acc[i][1] = fmaf(w, b.y, acc[i][1]);
        acc[i][2] = fmaf(w, b.z, acc[i][2]);
        acc[i][3] = fmaf(w, b.w, acc[i][3]);
      }
    }
  }
}

template <typename T, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, float scale) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kTile;
  float* vs = ks + kTile;
  float* ps = vs + kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nt = (S + kT - 1) / kT;
  const int qt = nt - 1 - blockIdx.y;  // the heaviest causal tiles first
  const int q0 = qt * kT;
  const int64_t base = (int64_t)blockIdx.x * S * kD;

  load_tile(qs, q + base, q0, S);
  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  }

  const int nk = CAUSAL ? qt + 1 : nt;
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();  // the previous tile's P.V is done with ks, vs, ps
    load_tile(ks, k + base, kt * kT, S);
    load_tile(vs, v + base, kt * kT, S);
    __syncthreads();
    float s[4][4];
    mm_abt(s, qs, ks, tx, ty);
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
        ps[(ty + 16 * i) * kStr + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = l[i] * alpha + row_sum(psum);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();
    mm_ab(acc, ps, vs, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r < S) {
      const float ll = fmaxf(l[i], 1e-30f);
      store4(o + base + (int64_t)r * kD + 4 * tx,
             make_float4(acc[i][0] / ll, acc[i][1] / ll, acc[i][2] / ll,
                         acc[i][3] / ll));
      if (tx == 0) lse[(int64_t)blockIdx.x * S + r] = m[i] + logf(ll);
    }
  }
}

template <typename T, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ dlse, T* __restrict__ dq, int S,
                    float scale) {
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
  const int64_t base = (int64_t)blockIdx.x * S * kD;
  const int64_t rbase = (int64_t)blockIdx.x * S;

  load_tile(qs, q + base, q0, S);
  load_tile(dos, dout + base, q0, S);
  float lse_r[4], delta_r[4], dlse_r[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    const bool in = r < S;
    lse_r[i] = in ? lse[rbase + r] : 0.f;
    delta_r[i] = in ? delta[rbase + r] : 0.f;
    dlse_r[i] = in && dlse != nullptr ? dlse[rbase + r] : 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  }

  const int nk = CAUSAL ? qt + 1 : nt;
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();  // the previous tile's dS.K is done with ks, vs, dss
    load_tile(ks, k + base, kt * kT, S);
    load_tile(vs, v + base, kt * kT, S);
    __syncthreads();
    float s[4][4], dp[4][4];
    mm_abt(s, qs, ks, tx, ty);
    mm_abt(dp, dos, vs, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = kt * kT + tx + 16 * j;
        const bool seen = c < S && (!CAUSAL || c <= r);
        const float p = expf((seen ? s[i][j] * scale : kNegInf) - lse_r[i]);
        const float ds = p * (dp[i][j] - delta_r[i] + dlse_r[i]) * scale;
        dss[(ty + 16 * i) * kStr + tx + 16 * j] = round_to<T>(ds);
      }
    }
    __syncthreads();
    mm_ab(acc, dss, ks, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r < S)
      store4(dq + base + (int64_t)r * kD + 4 * tx,
             make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
  }
}

template <typename T, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ dlse, T* __restrict__ dk,
                     T* __restrict__ dv, int S, float scale) {
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
  const int64_t base = (int64_t)blockIdx.x * S * kD;
  const int64_t rbase = (int64_t)blockIdx.x * S;

  load_tile(ks, k + base, k0, S);
  load_tile(vs, v + base, k0, S);
  float dk_acc[4][4], dv_acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  for (int qt = CAUSAL ? blockIdx.y : 0; qt < nt; ++qt) {
    const int q0 = qt * kT;
    __syncthreads();  // the previous tile's products are done with its tiles
    load_tile(qs, q + base, q0, S);
    load_tile(dos, dout + base, q0, S);
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
    mm_abt(p, ks, qs, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = q0 + tx + 16 * j;
        const bool seen = r < S && c < S && (!CAUSAL || c <= r);
        const float sv = seen ? p[i][j] * scale : kNegInf;
        p[i][j] = expf(sv - lse_s[tx + 16 * j]);
        ps[(ty + 16 * i) * kStr + tx + 16 * j] = round_to<T>(p[i][j]);
      }
    }
    mm_abt(dp, vs, dos, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        const float ds =
            p[i][j] * (dp[i][j] - delta_s[r] + dlse_s[r]) * scale;
        dss[(ty + 16 * i) * kStr + r] = round_to<T>(ds);
      }
    __syncthreads();
    mm_ab(dv_acc, ps, dos, tx, ty);
    mm_ab(dk_acc, dss, qs, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c < S) {
      const int64_t at = base + (int64_t)c * kD + 4 * tx;
      store4(dk + at, make_float4(dk_acc[i][0], dk_acc[i][1], dk_acc[i][2],
                                  dk_acc[i][3]));
      store4(dv + at, make_float4(dv_acc[i][0], dv_acc[i][1], dv_acc[i][2],
                                  dv_acc[i][3]));
    }
  }
}

// dynamic shared memory of each kernel, in bytes (all above the 48 KB a
// launch gets without opting in)
constexpr int kFwdSmem = 4 * kTile * (int)sizeof(float);
constexpr int kDqSmem = 5 * kTile * (int)sizeof(float);
constexpr int kDkvSmem = (6 * kTile + 3 * kT) * (int)sizeof(float);

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

// the shape checks every entry point shares; 0 means launch
int check_shape(int S, int D, int dtype) {
  if (D != kD || (dtype != kF32 && dtype != kBF16) ||
      (S + kT - 1) / kT > 65535)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace
}  // namespace bigdl

// All tensors contiguous: q, k, v, o, dout, dq, dk, dv (B*H, S, D) of
// `dtype` (0 float32, 1 bfloat16), 16-byte aligned; lse, delta, dlse
// (B*H, S) float32, dlse may be null (zero). D must be 64. causal: 0 or 1.
// Each returns the cudaError_t of its launch (0 on success).
extern "C" int bigdl_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, float* lse, int BH, int S, int D,
                               float scale, int causal, int dtype,
                               void* stream) {
  using namespace bigdl;
  if (int bad = check_shape(S, D, dtype)) return bad;
  if (BH <= 0 || S <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (dtype == kF32) {
    using T = float;
    err = causal ? launch(flash_fwd_kernel<T, true>, kFwdSmem, BH, S, st,
                          (const T*)q, (const T*)k, (const T*)v, (T*)o, lse,
                          S, scale)
                 : launch(flash_fwd_kernel<T, false>, kFwdSmem, BH, S, st,
                          (const T*)q, (const T*)k, (const T*)v, (T*)o, lse,
                          S, scale);
  } else {
    using T = __nv_bfloat16;
    err = causal ? launch(flash_fwd_kernel<T, true>, kFwdSmem, BH, S, st,
                          (const T*)q, (const T*)k, (const T*)v, (T*)o, lse,
                          S, scale)
                 : launch(flash_fwd_kernel<T, false>, kFwdSmem, BH, S, st,
                          (const T*)q, (const T*)k, (const T*)v, (T*)o, lse,
                          S, scale);
  }
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
  cudaError_t err;
  if (dtype == kF32) {
    using T = float;
    err = causal ? launch(flash_bwd_dq_kernel<T, true>, kDqSmem, BH, S, st,
                          (const T*)q, (const T*)k, (const T*)v,
                          (const T*)dout, lse, delta, dlse, (T*)dq, S, scale)
                 : launch(flash_bwd_dq_kernel<T, false>, kDqSmem, BH, S, st,
                          (const T*)q, (const T*)k, (const T*)v,
                          (const T*)dout, lse, delta, dlse, (T*)dq, S, scale);
  } else {
    using T = __nv_bfloat16;
    err = causal ? launch(flash_bwd_dq_kernel<T, true>, kDqSmem, BH, S, st,
                          (const T*)q, (const T*)k, (const T*)v,
                          (const T*)dout, lse, delta, dlse, (T*)dq, S, scale)
                 : launch(flash_bwd_dq_kernel<T, false>, kDqSmem, BH, S, st,
                          (const T*)q, (const T*)k, (const T*)v,
                          (const T*)dout, lse, delta, dlse, (T*)dq, S, scale);
  }
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
  cudaError_t err;
  if (dtype == kF32) {
    using T = float;
    err = causal ? launch(flash_bwd_dkv_kernel<T, true>, kDkvSmem, BH, S, st,
                          (const T*)q, (const T*)k, (const T*)v,
                          (const T*)dout, lse, delta, dlse, (T*)dk, (T*)dv, S,
                          scale)
                 : launch(flash_bwd_dkv_kernel<T, false>, kDkvSmem, BH, S, st,
                          (const T*)q, (const T*)k, (const T*)v,
                          (const T*)dout, lse, delta, dlse, (T*)dk, (T*)dv, S,
                          scale);
  } else {
    using T = __nv_bfloat16;
    err = causal ? launch(flash_bwd_dkv_kernel<T, true>, kDkvSmem, BH, S, st,
                          (const T*)q, (const T*)k, (const T*)v,
                          (const T*)dout, lse, delta, dlse, (T*)dk, (T*)dv, S,
                          scale)
                 : launch(flash_bwd_dkv_kernel<T, false>, kDkvSmem, BH, S, st,
                          (const T*)q, (const T*)k, (const T*)v,
                          (const T*)dout, lse, delta, dlse, (T*)dk, (T*)dv, S,
                          scale);
  }
  return (int)err;
}
