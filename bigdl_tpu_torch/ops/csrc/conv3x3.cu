// 3x3 stride-1 SAME convolution for Hopper (sm_90a), NHWC, as two kernels
// that compute the same function with different staging of the patch rows,
// each in two hand-written paths: a tensor-core path for bfloat16 and a
// CUDA-core path for float32 and for shapes the first does not take.
//
// Replaces the TPU kernels of scripts/perf_pallas_conv.py:
//   conv3x3 tap-sum (k9)  <- `_k9_kernel` (:64), launched by `conv_pallas9`
//     (:76): one padded image in VMEM, nine tap products accumulated in
//     float32;
//   conv3x3 im2col (i2c)  <- `_i2c_kernel` (:98), launched by
//     `conv_pallas_i2c` (:112): an in-VMEM (H*W, 9*Cin) patch matrix, one
//     product of depth 9*Cin.
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
// swapped) without a copy of the weights. float32 accumulation throughout.
//
// What bounds them. A call does 2*N*H*W*9*C*K operations on
// N*H*W*(C + K) + 9*C*K elements. At ResNet-50's four stride-1 shapes
// (batch 256, C = K = 64, 128, 256, 512 at 56^2, 28^2, 14^2, 7^2) that is
// 59.2 GFLOP a call, 0.060 ms on the bf16 tensor cores (989 TFLOP/s), over
// 206, 103, 53 and 30 MB: the 56^2 shape is bound by bytes (0.061 ms at
// 3.35 TB/s), the other three by operations. On the CUDA cores in float32
// (67 TFLOP/s) no call can take less than 0.88 ms.
//
// The tensor-core path (conv3x3_tc_kernel; bfloat16, C % 8 == 0,
// K % 8 == 0): an implicit GEMM of M = N*H*W pixels by K output channels
// over a depth of 9*C, on wgmma (m64nNk16, bf16 operands, float32
// accumulators in registers).
// - one CTA of 256 threads (two warpgroups) per tile of 128 pixels x BN
//   output channels, BN = 64 when K <= 64 and 128 above; warpgroup g owns
//   pixels 64g .. 64g + 63 of the tile. At 7^2 x 512 there are only 98
//   pixel tiles, so the channel split (4 tiles of 128) gives 392 CTAs;
// - the depth runs in stages of 64 (one 128-byte row of bf16 per pixel or
//   output channel). Every thread issues 16-byte cp.async.cg copies into a
//   ring of kTcStages = 4 stages in dynamic shared memory (im2col: 97 KiB
//   at BN 64, 129 KiB at BN 128; tap-sum: 101-113 KiB at ResNet-50's
//   widths, 225 KiB at W = 255), so three stages are in flight while one
//   is multiplied; a copy outside the image or past the depth has
//   src-size 0 and fills zeros, so no padded copy of x exists and SAME
//   padding costs no branch in the product;
// - the B stage is a (64 depth x BN) block of weights in the 128-byte
//   swizzle wgmma reads. Without flip the weights are depth-minor (OHWI),
//   so B is stored K-major; with flip they are channel-minor, and B is
//   stored MN-major and read with wgmma's transpose bit: flip costs no copy
//   and no extra pass;
// - tap-sum (MODE kTapSum, row 8): per chunk of 64 input channels the CTA
//   stages one halo tile, the linear pixel range [m0 - W - 1,
//   m0 + 128 + W + 1) (the tile's rows with one image row and one pixel on
//   each side), double-buffered, and runs the nine taps against it: pixel
//   m at tap (dy, dx) is halo row (m - m0) + dy*W + dx, so each lane of a
//   warp gives ldmatrix the address of its own shifted row (or of a zero
//   row where the tap leaves the image), a tap shift costs no copy, and the
//   A fragments feed wgmma from registers. The x bytes a CTA stages per
//   chunk are (128 + 2W + 2)/128 of its tile's, not nine times them. The
//   halo needs W <= 255 to fit; the wrapper sends wider images to the
//   CUDA-core path;
// - im2col (MODE kIm2col, row 9): each stage is a (128 pixels x 64 depth)
//   patch tile of the flattened (tap, c) depth, gathered by cp.async into
//   the same swizzle (C % 8 == 0, so a 16-byte piece never straddles a
//   tap; a stage may), and both operands are read by wgmma from shared
//   memory. Below C = 64 a stage packs several taps, where tap-sum would
//   stage mostly empty chunks; the price is that x is gathered once per
//   tap, not once per halo;
// - epilogue: the accumulators are rounded to bf16 into shared memory and
//   written out as 16-byte coalesced stores. Each output element has one
//   writer, so results repeat bit for bit.
// What remains for a later PR: persistent CTAs that keep the weights of a
// channel tile resident and overlap one tile's epilogue with the next
// tile's loads, a producer warp on TMA with mbarriers in place of the
// all-threads cp.async ring, and clusters that multicast the weight stages
// (every CTA of a channel tile reads the same 9*C*BN weights through L2).
//
// The CUDA-core path (conv3x3_simt_kernel; float32, and bfloat16 shapes the
// tensor-core path does not take): the same implicit GEMM in float32 FMAs.
// float32 stays here rather than on TF32 tensor cores, to keep float32
// results within 1e-4 of the plain version's.
// - one CTA of 256 threads per tile of 128 pixels x 64 output channels;
//   thread (ty, tx) = (tid / 16, tid % 16) owns pixels 8*ty .. 8*ty + 7 and
//   channels 4*tx .. 4*tx + 3 of the tile in 32 float32 registers. Each step
//   of depth reads two float4 of patch values and one float4 of taps from
//   shared memory for 32 FMAs.
// - the depth is staged in chunks of 16, float32 in shared memory, two
//   buffers: the next chunk is loaded from device memory into registers
//   while the current one is multiplied, then stored, with one barrier per
//   chunk.
// - tap-sum walks the depth tap by tap, ceil(C / 16) chunks of one tap
//   each; im2col walks the flattened (tap, c) index, ceil(9 * C / 16)
//   chunks that may straddle taps, so the CIFAR stem's C = 3 packs 27
//   useful columns into two chunks.
// - where C is a multiple of 8, a thread loads its 8 consecutive channels of
//   a pixel as one 16-byte (bfloat16) or two 16-byte (float32) loads; else
//   element by element. Any N, H, W, C, K.
// `ops/conv3x3.py` takes i2c for C <= 64 and k9 above (the script's own
// reasoning: im2col "for small Cin"), and within each the tensor-core path
// for bfloat16 with C % 8 == 0 and K % 8 == 0 (and, for k9, W <= 255), the
// CUDA-core path otherwise; the choice is made from the shape and type
// before the launch. Offsets into x and y are 64-bit.

#include "common.cuh"
#include "wgmma.cuh"

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
conv3x3_simt_kernel(const T* __restrict__ x, const T* __restrict__ w,
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
    conv3x3_simt_kernel<T, MODE, true><<<grid, kThreads, 0, stream>>>(
        (const T*)x, (const T*)w, (T*)y, s);
  else
    conv3x3_simt_kernel<T, MODE, false><<<grid, kThreads, 0, stream>>>(
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


// ------------------------------------------------- the tensor-core path --
constexpr int kTcBM = 128;       // output pixels per CTA (two warpgroups)
constexpr int kTcBK = 64;        // depth of one stage: a 128-byte bf16 row
constexpr int kTcStages = 4;     // ring depth
constexpr int kTcThreads = 256;
constexpr int kRowBytes = kTcBK * 2;   // 128
constexpr int kMaxSmem = 232448;       // a CTA's shared memory on sm_90

__host__ __device__ constexpr int round_up(int v, int to) {
  return (v + to - 1) / to * to;
}

// halo rows of the tap-sum kernel: the tile and one image row and one pixel
// on each side, in linear pixel order
__host__ __device__ constexpr int halo_rows(int W) { return kTcBM + 2 * W + 2; }

// Dynamic shared memory of one CTA: 1 KiB of slack to align the ring to
// the 1024-byte swizzle atom, the B ring, then the A ring (im2col) or two
// halo buffers and a zero row (tap-sum). The epilogue's staging tile reuses
// the ring. ops/conv3x3.py's `tc_plan` mirrors it for the host.
__host__ __device__ constexpr int tc_smem_bytes(int mode, int bn, int W) {
  return 1024 + kTcStages * bn * kRowBytes +
         (mode == kTapSum ? 2 * round_up(halo_rows(W) * kRowBytes, 1024) + 128
                          : kTcStages * kTcBM * kRowBytes);
}

// (M tile, N tile) CTA; MODE kTapSum or kIm2col; BN 64 or 128; FLIP as
// the CUDA-core kernel's
template <int MODE, int BN, bool FLIP>
__global__ void __launch_bounds__(kTcThreads, 1)
conv3x3_tc_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ w,
                  __nv_bfloat16* __restrict__ y, ConvShape s, int n_stages) {
  constexpr int kAcc = BN / 2;                 // accumulators a thread
  constexpr int kBStage = BN * kRowBytes;      // bytes of one B stage
  constexpr int kAStage = kTcBM * kRowBytes;   // bytes of one im2col A stage
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* b_ring = smem;
  uint8_t* a_ring = smem + kTcStages * kBStage;   // im2col A, or the halos
  const int halo_bytes = round_up(halo_rows(s.W) * kRowBytes, 1024);
  uint8_t* zero_row = a_ring + 2 * halo_bytes;    // tap-sum only

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;                        // warpgroup
  const int wq = (tid >> 5) & 3;                  // warp within it
  const long long m0 = (long long)blockIdx.x * kTcBM;
  const int n0 = blockIdx.y * BN;
  const long long hw = (long long)s.H * s.W;

  if (MODE == kTapSum && tid < 8)
    reinterpret_cast<uint4*>(zero_row)[tid] = make_uint4(0, 0, 0, 0);

  // ---- loaders (every thread) ----
  // B: without flip, row n (output channel) x 8 chunks of 8 depth values;
  // with flip, depth row r x BN / 8 chunks of 8 output channels
  auto load_b = [&](int q) {
    const uint32_t dst = smem_u32(b_ring + (q % kTcStages) * kBStage);
#pragma unroll
    for (int i = 0; i < BN * 8 / kTcThreads; ++i) {
      const int idx = tid + i * kTcThreads;
      if (!FLIP) {
        const int n = idx >> 3, ch = idx & 7;
        const int k = n0 + n;
        long long off;
        bool ok;
        if (MODE == kTapSum) {
          const int tap = q % 9, c = (q / 9) * kTcBK + ch * 8;
          ok = c < s.C;
          off = ((long long)k * 9 + tap) * s.C + c;
        } else {
          const int j = q * kTcBK + ch * 8;
          ok = j < 9 * s.C;
          off = (long long)k * 9 * s.C + j;
        }
        ok = ok && k < s.K;
        cp_async16(dst + swz(n, ch), ok ? w + off : w, ok);
      } else {
        constexpr int kChunks = BN / 8;
        const int r = idx / kChunks, nc = idx % kChunks;
        int tap, c;
        bool ok;
        if (MODE == kTapSum) {
          tap = q % 9;
          c = (q / 9) * kTcBK + r;
          ok = c < s.C;
        } else {
          const int j = q * kTcBK + r;
          tap = j / s.C;
          c = j - tap * s.C;
          ok = j < 9 * s.C;
        }
        const int k = n0 + nc * 8;
        ok = ok && k < s.K;
        const long long off = ((long long)c * 9 + (8 - tap)) * s.K + k;
        cp_async16(dst + (nc >> 3) * 64 * kRowBytes + swz(r, nc & 7),
                   ok ? w + off : w, ok);
      }
    }
  };

  // im2col A: pixel rows tid / 8 + 32 i, depth chunk tid % 8
  int a_h[4], a_w[4];
  bool a_live[4];
  if (MODE == kIm2col) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long m = m0 + (tid >> 3) + 32 * i;
      a_live[i] = m < s.M;
      const long long r = a_live[i] ? m % hw : 0;
      a_h[i] = (int)(r / s.W);
      a_w[i] = (int)(r - (long long)a_h[i] * s.W);
    }
  }
  auto load_a = [&](int q) {
    const uint32_t dst = smem_u32(a_ring + (q % kTcStages) * kAStage);
    const int ch = tid & 7;
    const int j = q * kTcBK + ch * 8;
    const int tap = j / s.C, c = j - tap * s.C;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = (tid >> 3) + 32 * i;
      const int hh = a_h[i] + dy, ww = a_w[i] + dx;
      const bool ok = a_live[i] && j < 9 * s.C && hh >= 0 && hh < s.H &&
                      ww >= 0 && ww < s.W;
      const long long off = (m0 + row + (long long)dy * s.W + dx) * s.C + c;
      cp_async16(dst + swz(row, ch), ok ? x + off : x, ok);
    }
  };

  // tap-sum halo of channel chunk cc: pixels m0 - W - 1 + r, r < HR
  const int hr_rows = halo_rows(s.W);
  auto load_halo = [&](int cc) {
    const uint32_t dst = smem_u32(a_ring + (cc & 1) * halo_bytes);
    for (int idx = tid; idx < hr_rows * 8; idx += kTcThreads) {
      const int r = idx >> 3, ch = idx & 7;
      const long long p = m0 - s.W - 1 + r;
      const int c = cc * kTcBK + ch * 8;
      const bool ok = p >= 0 && p < s.M && c < s.C;
      cp_async16(dst + swz(r, ch), ok ? x + p * s.C + c : x, ok);
    }
  };

  auto load_stage = [&](int q) {
    load_b(q);
    if (MODE == kIm2col)
      load_a(q);
    else if (q % 9 == 0)
      load_halo(q / 9);
  };

  // ---- tap-sum: this lane's ldmatrix row (tile row i) ----
  // lanes 0-7 / 8-15 / 16-23 / 24-31 address rows 0-7 / 8-15 / 0-7 / 8-15
  // of the warp's 16 at depth 0-7 / 0-7 / 8-15 / 8-15 of each k16 step
  const int li = wg * 64 + wq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int l_half = lane >> 4;
  int l_h = 0, l_w = 0;
  bool l_live = false;
  if (MODE == kTapSum) {
    const long long m = m0 + li;
    l_live = m < s.M;
    const long long r = l_live ? m % hw : 0;
    l_h = (int)(r / s.W);
    l_w = (int)(r - (long long)l_h * s.W);
  }

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  // B descriptor of k16 step ks of ring stage st
  auto b_desc = [&](int st, int ks) -> uint64_t {
    const uint32_t base = smem_u32(b_ring + st * kBStage);
    // K-major: the step is 32 bytes along the row; MN-major: 16 depth rows
    return FLIP ? wgmma_desc(base + ks * 16 * kRowBytes, 64 * kRowBytes, 1024)
                : wgmma_desc(base + ks * 32, 16, 1024);
  };

  auto compute_stage = [&](int q) {
    const int st = q % kTcStages;
    if (MODE == kIm2col) {
      const uint32_t a_base =
          smem_u32(a_ring + st * kAStage) + wg * 64 * kRowBytes;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kTcBK / 16; ++ks)
        wgmma_ss<FLIP ? 1 : 0>(acc, wgmma_desc(a_base + ks * 32, 16, 1024),
                               b_desc(st, ks));
    } else {
      const int tap = q % 9;
      const int dy = tap / 3, dx = tap % 3;
      const int hh = l_h + dy - 1, ww = l_w + dx - 1;
      const bool ok = l_live && hh >= 0 && hh < s.H && ww >= 0 && ww < s.W;
      const int hr = li + dy * s.W + dx;
      const uint32_t halo = smem_u32(a_ring + ((q / 9) & 1) * halo_bytes);
      uint32_t a[kTcBK / 16][4];
#pragma unroll
      for (int ks = 0; ks < kTcBK / 16; ++ks) {
        const int ch = 2 * ks + l_half;
        ldmatrix_x4(a[ks], ok ? halo + swz(hr, ch)
                              : smem_u32(zero_row) + (ch << 4));
      }
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kTcBK / 16; ++ks)
        wgmma_rs<FLIP ? 1 : 0>(acc, a[ks], b_desc(st, ks));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  };

  // ---- the ring: kTcStages - 1 stages in flight ahead of the product ----
#pragma unroll
  for (int q = 0; q < kTcStages - 1; ++q) {
    if (q < n_stages) load_stage(q);
    cp_async_commit();
  }
  for (int q = 0; q < n_stages; ++q) {
    cp_async_wait<kTcStages - 2>();   // stage q has landed (this thread's)
    fence_proxy_async();
    __syncthreads();                  // everyone's; stage q - 1 is consumed
    if (q + kTcStages - 1 < n_stages) load_stage(q + kTcStages - 1);
    cp_async_commit();
    compute_stage(q);
  }
  cp_async_wait<0>();
  __syncthreads();

  // ---- epilogue: bf16 through shared memory, 16-byte stores ----
  constexpr int kStride = BN + 8;     // staging row, in bf16 (padded)
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(smem);
  const int r0 = wg * 64 + wq * 16 + (lane >> 2);
  const int c0 = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(stage + r0 * kStride + j * 8 + c0) =
        __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<__nv_bfloat162*>(stage + (r0 + 8) * kStride + j * 8 +
                                       c0) =
        __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncthreads();
  for (int idx = tid; idx < kTcBM * (BN / 8); idx += kTcThreads) {
    const int r = idx / (BN / 8), cc = idx % (BN / 8);
    const long long m = m0 + r;
    const int k = n0 + cc * 8;
    if (m < s.M && k < s.K)
      *reinterpret_cast<uint4*>(y + m * s.K + k) =
          *reinterpret_cast<const uint4*>(stage + r * kStride + cc * 8);
  }
}

template <int MODE, int BN, bool FLIP>
cudaError_t launch_tc(const void* x, const void* w, void* y, ConvShape s,
                      int bytes, cudaStream_t stream) {
  auto kernel = conv3x3_tc_kernel<MODE, BN, FLIP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int n_stages = MODE == kTapSum ? 9 * ((s.C + kTcBK - 1) / kTcBK)
                                       : (9 * s.C + kTcBK - 1) / kTcBK;
  const dim3 grid((unsigned)((s.M + kTcBM - 1) / kTcBM),
                  (unsigned)((s.K + BN - 1) / BN));
  kernel<<<grid, kTcThreads, bytes, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (__nv_bfloat16*)y, s,
      n_stages);
  return cudaGetLastError();
}

template <int MODE, int BN>
cudaError_t launch_tc_flip(const void* x, const void* w, void* y,
                           ConvShape s, bool flip, int bytes,
                           cudaStream_t stream) {
  return flip ? launch_tc<MODE, BN, true>(x, w, y, s, bytes, stream)
              : launch_tc<MODE, BN, false>(x, w, y, s, bytes, stream);
}

int conv3x3_tc(const void* x, const void* w, void* y, int N, int H, int W,
               int C, int K, int flip, int mode, void* stream) {
  // (W > kMaxSmem never fits, and is refused before its byte count could
  // overflow)
  if (N < 0 || H < 0 || W < 0 || W > kMaxSmem || C <= 0 || K <= 0 ||
      C % 8 || K % 8 || (mode != kTapSum && mode != kIm2col))
    return (int)cudaErrorInvalidValue;
  const int bn = K <= 64 ? 64 : 128;
  const int smem_bytes = tc_smem_bytes(mode, bn, W);
  if (smem_bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  const ConvShape s{N, H, W, C, K, (long long)N * H * W};
  if (s.M == 0) return (int)cudaSuccess;
  if ((s.M + kTcBM - 1) / kTcBM > 0x7fffffffLL || (K + bn - 1) / bn > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool f = flip != 0;
  const int b = smem_bytes;
  cudaError_t err;
  if (mode == kTapSum)
    err = bn == 64 ? launch_tc_flip<kTapSum, 64>(x, w, y, s, f, b, st)
                   : launch_tc_flip<kTapSum, 128>(x, w, y, s, f, b, st);
  else
    err = bn == 64 ? launch_tc_flip<kIm2col, 64>(x, w, y, s, f, b, st)
                   : launch_tc_flip<kIm2col, 128>(x, w, y, s, f, b, st);
  return (int)err;
}

}  // namespace
}  // namespace bigdl

// x (N, H, W, C), w OHWI (K, 3, 3, C), or (C, 3, 3, K) with flip, y
// (N, H, W, K), all contiguous and 16-byte aligned, of one type (dtype 0 =
// float32, 1 = bfloat16). The CUDA-core path. Returns a cudaError_t (0 on a
// clean launch).
extern "C" int bigdl_conv3x3_simt_k9(const void* x, const void* w, void* y,
                                     int N, int H, int W, int C, int K,
                                     int flip, int dtype, void* stream) {
  return bigdl::conv3x3<bigdl::kTapSum>(x, w, y, N, H, W, C, K, flip, dtype,
                                        stream);
}

extern "C" int bigdl_conv3x3_simt_i2c(const void* x, const void* w, void* y,
                                      int N, int H, int W, int C, int K,
                                      int flip, int dtype, void* stream) {
  return bigdl::conv3x3<bigdl::kIm2col>(x, w, y, N, H, W, C, K, flip, dtype,
                                        stream);
}

// The tensor-core path: bfloat16 x, w, y as above with C % 8 == 0 and
// K % 8 == 0; mode 0 = tap-sum, 1 = im2col. The entry picks the channel
// tile (64 when K <= 64, else 128) and the dynamic shared memory
// (tc_smem_bytes), and refuses a tap-sum image too wide for it. Returns a
// cudaError_t (0 on a clean launch).
extern "C" int bigdl_conv3x3_tc(const void* x, const void* w, void* y, int N,
                                int H, int W, int C, int K, int flip,
                                int mode, void* stream) {
  return bigdl::conv3x3_tc(x, w, y, N, H, W, C, K, flip, mode, stream);
}
