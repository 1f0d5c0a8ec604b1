// 3x3 stride-1 SAME convolution for Hopper (sm_90a), NHWC, as two kernels
// that compute the same function with different staging of the patch rows.
//
// Replaces the TPU kernels of scripts/perf_pallas_conv.py:
//   conv3x3 tap-sum (bigdl_conv3x3_k9)  <- `_k9_kernel` (:64), launched by
//     `conv_pallas9` (:76): nine tap products accumulated in float32;
//   conv3x3 im2col (bigdl_conv3x3_i2c)  <- `_i2c_kernel` (:98), launched by
//     `conv_pallas_i2c` (:112): one product over an on-chip (H*W, 9*Cin)
//     patch matrix.
//
// What they compute, with x (N, H, W, C) and taps wt(k, ty, tx, c):
//   y[n, h, w, k] = sum_{ty, tx, c} x[n, h + ty - 1, w + tx - 1, c]
//                                   * wt(k, ty, tx, c)
// where x outside the image reads as zero (SAME padding, by bounds checks:
// no padded copy of x is made in device memory, unlike the JAX wrappers'
// jnp.pad). The weight tensor is OHWI, w (O, 3, 3, I):
//   flip = 0: wt(k, ty, tx, c) = w[k, ty, tx, c]          (C = I, K = O)
//   flip = 1: wt(k, ty, tx, c) = w[c, 2 - ty, 2 - tx, k]  (C = O, K = I)
// so with flip the same kernels give the input gradient of the convolution
// (dx = conv(dy) over the weights rotated by 180 degrees with in and out
// swapped) without a copy of the weights. float32 or bfloat16 in and out,
// float32 accumulation; any N, H, W, C, K.
//
// What bounds them: operations. A call does 2*N*H*W*9*C*K flops on about
// (N*H*W*(C + K) + 9*C*K) elements; at ResNet-50's shapes that is hundreds
// of flops per byte, far above the card's balance point. This first version
// runs float32 FMAs on the CUDA cores in both types (67 TFLOP/s); mma.sync
// or wgmma on the tensor cores with TMA-fed tiles is later work.
//
// What the design does about it: an implicit GEMM of M = N*H*W pixels by
// K output channels over a depth of 9*C.
// - one CTA of 256 threads per tile of 128 pixels x 64 output channels;
//   thread (ty, tx) = (tid / 16, tid % 16) owns pixels 8*ty .. 8*ty + 7 and
//   channels 4*tx .. 4*tx + 3 of the tile in 32 float32 registers. Each step
//   of depth reads two float4 of patch values and one float4 of taps from
//   shared memory for 32 FMAs.
// - the depth is staged in chunks of 16, float32 in shared memory, two
//   buffers: the next chunk is loaded from device memory into registers
//   while the current one is multiplied, then stored, with one barrier per
//   chunk.
// - the two kernels differ in how a chunk maps onto the depth:
//   tap-sum (k9): the depth runs tap by tap, ceil(C / 16) chunks of one tap
//     each (9 * ceil(C / 16) chunks); a chunk's pixel rows all come from one
//     shifted image position, so the bounds test is one per row. A C that
//     is not a multiple of 16 leaves zero columns in each tap's last chunk.
//   im2col (i2c): the depth is the flattened (tap, c) index of the patch
//     matrix, ceil(9 * C / 16) chunks that may straddle taps, so a small C
//     (the CIFAR stem's 3) packs 27 useful columns into two chunks where
//     tap-sum would stage nine mostly empty ones.
//   `ops/conv3x3.py` takes i2c for C <= 64 and k9 above, the script's own
//   reasoning (im2col "for small Cin").
// - where C is a multiple of 8, a thread loads its 8 consecutive channels of
//   a pixel as one 16-byte (bfloat16) or two 16-byte (float32) loads; else
//   element by element. Taps are read element by element (they are small
//   and stay in L2).
// - no atomics: each output element has one writer, results repeat bit for
//   bit. Offsets into x and y are 64-bit.

#include "common.cuh"

namespace bigdl {
namespace {

constexpr int kBM = 128;      // output pixels per CTA
constexpr int kBN = 64;       // output channels per CTA
constexpr int kBK = 16;       // depth of one staged chunk
constexpr int kThreads = 256;
constexpr int kTapSum = 0;    // row 8, `_k9_kernel`
constexpr int kIm2col = 1;    // row 9, `_i2c_kernel`

struct ConvShape {
  int N, H, W;
  int C;         // the operation's input channels
  int K;         // the operation's output channels
  long long M;   // N * H * W output pixels
};

// offset of tap wt(k, tap = 3 * ty + tx, c) in the OHWI weight tensor
template <bool FLIP>
__device__ __forceinline__ long long tap_offset(int k, int tap, int c,
                                                const ConvShape& s) {
  return FLIP ? ((long long)c * 9 + (8 - tap)) * s.K + k
              : ((long long)k * 9 + tap) * s.C + c;
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// depth index j (0 <= j < kBK) of chunk q -> (tap, c); false past the depth
template <int MODE>
__device__ __forceinline__ bool depth_at(int q, int j, int chunks_per_tap,
                                         int C, int* tap, int* c) {
  if (MODE == kTapSum) {
    *tap = q / chunks_per_tap;
    *c = (q - *tap * chunks_per_tap) * kBK + j;
    return *c < C;
  }
  const int kk = q * kBK + j;
  *tap = kk / C;
  *c = kk - *tap * C;
  return kk < 9 * C;
}

template <typename T, int MODE, bool FLIP>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ y, ConvShape s) {
  __shared__ __align__(16) float As[2][kBK][kBM];   // patch values, k-major
  __shared__ __align__(16) float Bs[2][kBK][kBN];   // taps, k-major

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int k0 = blockIdx.y * kBN;

  // loader of the patch chunk: pixel row a_row, depth a_col .. a_col + 7
  const int a_row = tid >> 1;
  const int a_col = (tid & 1) * 8;
  const long long am = m0 + a_row;
  const bool a_live = am < s.M;
  int an = 0, ah = 0, aw = 0;
  if (a_live) {
    const long long hw = (long long)s.H * s.W;
    an = (int)(am / hw);
    const int r = (int)(am - an * hw);
    ah = r / s.W;
    aw = r - ah * s.W;
  }
  const bool vec = (s.C % 8) == 0;
  const int chunks_per_tap = (s.C + kBK - 1) / kBK;
  const int n_chunks = MODE == kTapSum ? 9 * chunks_per_tap
                                       : (9 * s.C + kBK - 1) / kBK;

  float a_reg[8], b_reg[4];

  // x[an, ah + dy, aw + dx, :] as an offset, or -1 outside the image
  auto pixel = [&](int tap) -> long long {
    const int hh = ah + tap / 3 - 1;
    const int ww = aw + tap % 3 - 1;
    if (!a_live || hh < 0 || hh >= s.H || ww < 0 || ww >= s.W) return -1;
    return (((long long)an * s.H + hh) * s.W + ww) * s.C;
  };

  auto load_chunk = [&](int q) {
    int tap, c;
    if (vec) {
      // 8 consecutive depth indices share a tap when C % 8 == 0
      const bool in = depth_at<MODE>(q, a_col, chunks_per_tap, s.C, &tap, &c);
      const long long off = in ? pixel(tap) : -1;
      if (off >= 0) {
        load8(x + off + c, a_reg);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) a_reg[i] = 0.f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const bool in = depth_at<MODE>(q, a_col + i, chunks_per_tap, s.C,
                                       &tap, &c);
        const long long off = in ? pixel(tap) : -1;
        a_reg[i] = off >= 0 ? to_f(x[off + c]) : 0.f;
      }
    }
    if (!FLIP) {
      // 4 consecutive depth indices (contiguous c) of output channel k
      const int k = k0 + (tid >> 2);
      const int j0 = (tid & 3) * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool in = depth_at<MODE>(q, j0 + i, chunks_per_tap, s.C,
                                       &tap, &c);
        b_reg[i] = (in && k < s.K) ? to_f(w[tap_offset<FLIP>(k, tap, c, s)])
                                   : 0.f;
      }
    } else {
      // 4 consecutive output channels (contiguous k) at one depth index
      const int j = tid >> 4;
      const int kq = k0 + (tid & 15) * 4;
      const bool in = depth_at<MODE>(q, j, chunks_per_tap, s.C, &tap, &c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        b_reg[i] = (in && kq + i < s.K)
                       ? to_f(w[tap_offset<FLIP>(kq + i, tap, c, s)])
                       : 0.f;
    }
  };

  auto store_chunk = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 8; ++i) As[buf][a_col + i][a_row] = a_reg[i];
    if (!FLIP) {
      const int n = tid >> 2, j0 = (tid & 3) * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) Bs[buf][j0 + i][n] = b_reg[i];
    } else {
      const int j = tid >> 4, n0 = (tid & 15) * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) Bs[buf][j][n0 + i] = b_reg[i];
    }
  };

  const int ty = tid >> 4, tx = tid & 15;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  load_chunk(0);
  store_chunk(0);
  __syncthreads();
  for (int q = 0; q < n_chunks; ++q) {
    const int buf = q & 1;
    if (q + 1 < n_chunks) load_chunk(q + 1);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 8]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][kk][ty * 8 + 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    if (q + 1 < n_chunks) store_chunk(buf ^ 1);
    __syncthreads();
  }

  const int kc = k0 + tx * 4;
  if (kc >= s.K) return;
  const bool vec_out = (s.K % 4) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + ty * 8 + i;
    if (m >= s.M) break;
    T* out = y + m * s.K + kc;
    if (vec_out) {
      store4(out, acc[i]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (kc + j < s.K) store_f(out + j, acc[i][j]);
    }
  }
}

template <typename T, int MODE>
cudaError_t launch(const void* x, const void* w, void* y, ConvShape s,
                   bool flip, cudaStream_t stream) {
  const dim3 grid((unsigned)((s.M + kBM - 1) / kBM),
                  (unsigned)((s.K + kBN - 1) / kBN));
  if (flip)
    conv3x3_kernel<T, MODE, true><<<grid, kThreads, 0, stream>>>(
        (const T*)x, (const T*)w, (T*)y, s);
  else
    conv3x3_kernel<T, MODE, false><<<grid, kThreads, 0, stream>>>(
        (const T*)x, (const T*)w, (T*)y, s);
  return cudaGetLastError();
}

template <int MODE>
int conv3x3(const void* x, const void* w, void* y, int N, int H, int W,
            int C, int K, int flip, int dtype, void* stream) {
  if (N < 0 || H < 0 || W < 0 || C <= 0 || K <= 0 ||
      (dtype != kF32 && dtype != kBF16))
    return (int)cudaErrorInvalidValue;
  const ConvShape s{N, H, W, C, K, (long long)N * H * W};
  if (s.M == 0) return (int)cudaSuccess;
  if ((s.M + kBM - 1) / kBM > 0x7fffffffLL || (K + kBN - 1) / kBN > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      dtype == kF32 ? launch<float, MODE>(x, w, y, s, flip != 0, st)
                    : launch<__nv_bfloat16, MODE>(x, w, y, s, flip != 0, st);
  return (int)err;
}

}  // namespace
}  // namespace bigdl

// x (N, H, W, C), w OHWI (K, 3, 3, C), or (C, 3, 3, K) with flip, y
// (N, H, W, K), all contiguous and 16-byte aligned, of one type (dtype 0 =
// float32, 1 = bfloat16). Returns a cudaError_t (0 on a clean launch).
extern "C" int bigdl_conv3x3_k9(const void* x, const void* w, void* y, int N,
                                int H, int W, int C, int K, int flip,
                                int dtype, void* stream) {
  return bigdl::conv3x3<bigdl::kTapSum>(x, w, y, N, H, W, C, K, flip, dtype,
                                        stream);
}

extern "C" int bigdl_conv3x3_i2c(const void* x, const void* w, void* y, int N,
                                 int H, int W, int C, int K, int flip,
                                 int dtype, void* stream) {
  return bigdl::conv3x3<bigdl::kIm2col>(x, w, y, N, H, W, C, K, flip, dtype,
                                        stream);
}
