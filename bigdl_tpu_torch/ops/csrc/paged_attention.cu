// Paged attention for Hopper (sm_90a): chunk and decode attention straight
// against the paged K/V pool, through each slot's page table.
//
// Replaces the TPU kernels bigdl_tpu/ops/paged_attention.py `_decode_kernel`
// and its int8 variant `_decode_kernel_quant` (both with `_online_update`),
// launched by `_call_kernel` via `paged_pool_attention`.
//
// What it computes, per slot b, head h and chunk query c (absolute position
// start[b] + c):
//   out[b,h,c] = softmax_j(q[b,h,c] . k_j * sm_scale) . v_j
// over the key positions j that are visible: j <= start[b] + c, and the
// table entry of j's page is a real page (< num_pages). A query with no
// visible key (a row whose table is all sentinel: padding and inactive
// slots) comes out as zeros, the plain version's convention.
//
// Pools are float32 or bfloat16 (the queries' type), or int8 with float32
// scale planes k_scale/v_scale of (N, H, PS): key j then reads
// k_j = float(k_int8[j]) * k_scale[j], the reference's dequantisation
// (`k.astype(f32) * ks[..., None]`), one rounding, same as the plain version.
//
// What bounds it: bytes at decode (C = 1). Each query row does 4*D flops
// per visible key against 2*D*elt bytes of K/V (2*(D+4) for int8), far below the card's ~20
// flops/byte (fp32 CUDA cores) or ~295 (bf16 tensor cores) balance point.
// The floor is one read of every visible K/V page over HBM. A 64-query
// prefill chunk shares each page among its queries and, in float32, crosses
// over to operations.
//
// What the design does about it:
// - no dense gather: K/V pages are read straight through the page table;
//   a sentinel entry (>= num_pages) is skipped without being read (the TPU
//   kernel clamps it to page N-1, fetches it and masks it out);
// - the page walk stops at the last page the CTA's queries can see,
//   ceil((start + last query + 1) / page_size), instead of walking the
//   table's full width as the TPU grid does;
// - one CTA per (slot, head, tile of up to 16 queries); its 4 warps split
//   the pages round-robin, each warp keeping its own online-softmax state
//   (m, l, acc in fp32 registers) and staging its page's K and V tile in its
//   own shared-memory slot, so no block-wide barrier sits in the page loop
//   (flash-decoding inside one CTA). The warps' states merge once, at the
//   end, through shared memory;
// - an int8 page is read as 4-byte char4 vectors (1 KiB of K and 1 KiB of V
//   at PS 16, D 64) with its 2 x 16 scales staged in the warp's slot, and
//   dequantised into the same float32 tile the float pools use, so an int8
//   pool moves (D + 4) / (4 D) of a float32 pool's bytes and the rest of
//   the kernel is unchanged;
// - per page tile, lanes map to keys (32 / page_size lanes split one key's
//   dot product), so a page's scores need one shuffle step, and each lane
//   owns D / 32 output dims for the P.V update. Pages of 8, 16 and 32
//   tokens are instantiated at D 64. The page tiles and the warp merge
//   share one buffer, static where it fits (PS 8 and 16); at PS 32 the
//   four warps' K and V tiles take 65 KiB, over the 48 KiB of static
//   shared memory, so that instantiation takes it as dynamic shared
//   memory. The others keep it static: on an H100 their decode case ran
//   slower with a dynamic buffer.
// The simple first version has no cp.async/TMA double buffering: a warp
// loads its page, then computes on it. Inputs may be float32 or bfloat16;
// all arithmetic is float32. Pool offsets are 64-bit.

#include <type_traits>

#include "common.cuh"

namespace bigdl {
namespace {

constexpr int kWarps = 4;

// floats of the kernel's buffer: the warps' padded K and V page tiles,
// reused for the warps' merge at the end
template <int PS, int D, int QT>
__host__ __device__ constexpr int buffer_floats() {
  return kWarps * 2 * PS * (D + 1) > kWarps * QT * (D + 2)
             ? kWarps * 2 * PS * (D + 1)
             : kWarps * QT * (D + 2);
}

// bytes of dynamic shared memory the kernel takes: the buffer where it
// does not fit in static shared memory beside q_s and sc_s, else none
template <int PS, int D, int QT>
__host__ __device__ constexpr int dynamic_bytes() {
  return buffer_floats<PS, D, QT>() * 4 > 40 * 1024
             ? buffer_floats<PS, D, QT>() * 4
             : 0;
}

// T: the queries' and output's type; KV: the pool's (T, or int8_t with the
// scale planes kscale/vscale, which are null for a float pool)
template <typename T, typename KV, int PS, int D, int QT>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_kernel(const T* __restrict__ q, const KV* __restrict__ kpool,
                       const KV* __restrict__ vpool,
                       const float* __restrict__ kscale,
                       const float* __restrict__ vscale,
                       const int* __restrict__ table,
                       const int* __restrict__ start, T* __restrict__ out,
                       int H, int C, int N, int P, float sm_scale) {
  constexpr bool kInt8 = std::is_same<KV, int8_t>::value;
  static_assert(32 % PS == 0 && D % 32 == 0, "unsupported tile");
  constexpr int LPK = 32 / PS;  // lanes sharing one key's dot product
  constexpr int DK = D / LPK;   // dims of that dot product per lane
  constexpr int DV = D / 32;    // output dims per lane
  constexpr int KSTR = D + 1;   // padded row: conflict-free key-major reads

  __shared__ float q_s[QT][D];
  // page tiles, then the warp merge: static, or dynamic where too large
  constexpr bool kDynamic = dynamic_bytes<PS, D, QT>() > 0;
  __shared__ float smem_static[kDynamic ? 1 : buffer_floats<PS, D, QT>()];
  extern __shared__ float smem_dynamic[];
  float* smem = kDynamic ? smem_dynamic : smem_static;
  __shared__ float sc_s[kWarps][2][PS];  // int8: the page's K, V scales

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int c0 = blockIdx.y * QT;
  const int nq = min(QT, C - c0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int64_t q_base = ((int64_t)bh * C + c0) * D;
  for (int i = threadIdx.x; i < nq * D; i += blockDim.x)
    q_s[i / D][i % D] = to_f(q[q_base + i]);
  __syncthreads();

  const int st = start[b];
  // last page any of this tile's queries can see
  const int npages = min(P, (st + c0 + nq - 1) / PS + 1);

  float m[QT], l[QT], acc[QT][DV];
#pragma unroll
  for (int qi = 0; qi < QT; ++qi) {
    m[qi] = kNegInf;
    l[qi] = 0.f;
#pragma unroll
    for (int e = 0; e < DV; ++e) acc[qi][e] = 0.f;
  }

  float* ks = smem + warp * 2 * PS * KSTR;
  float* vs = ks + PS * KSTR;
  const int key = lane / LPK;
  const int part = lane % LPK;
  const int* row_table = table + (int64_t)b * P;

  for (int p = warp; p < npages; p += kWarps) {
    const int page = row_table[p];
    if (page < 0 || page >= N) continue;  // sentinel: nothing to read
    const int64_t base = ((int64_t)page * H + h) * (PS * D);
    __syncwarp();  // the previous page's tile is no longer read
    if constexpr (kInt8) {
      static_assert(D % 4 == 0 && PS <= 32, "unsupported int8 tile");
      const int64_t sbase = ((int64_t)page * H + h) * PS;
      if (lane < PS) {
        sc_s[warp][0][lane] = kscale[sbase + lane];
        sc_s[warp][1][lane] = vscale[sbase + lane];
      }
      __syncwarp();
      const char4* k4 = reinterpret_cast<const char4*>(kpool + base);
      const char4* v4 = reinterpret_cast<const char4*>(vpool + base);
#pragma unroll 4
      for (int i = lane; i < PS * D / 4; i += 32) {
        const int r = (4 * i) / D, d = 4 * i - r * D;
        const char4 kk = k4[i], vv = v4[i];
        const float sk = sc_s[warp][0][r], sv = sc_s[warp][1][r];
        float* kd = ks + r * KSTR + d;
        float* vd = vs + r * KSTR + d;
        kd[0] = (float)kk.x * sk;
        kd[1] = (float)kk.y * sk;
        kd[2] = (float)kk.z * sk;
        kd[3] = (float)kk.w * sk;
        vd[0] = (float)vv.x * sv;
        vd[1] = (float)vv.y * sv;
        vd[2] = (float)vv.z * sv;
        vd[3] = (float)vv.w * sv;
      }
    } else {
#pragma unroll 4
      for (int i = lane; i < PS * D; i += 32) {
        const int r = i / D, d = i - (i / D) * D;
        ks[r * KSTR + d] = to_f(kpool[base + i]);
        vs[r * KSTR + d] = to_f(vpool[base + i]);
      }
    }
    __syncwarp();
    const int kpos = p * PS + key;
#pragma unroll
    for (int qi = 0; qi < QT; ++qi) {
      if (qi < nq) {
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < DK; ++d)
          s += q_s[qi][part * DK + d] * ks[key * KSTR + part * DK + d];
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1)
          s += __shfl_xor_sync(kFullMask, s, o);
        const bool valid = kpos <= st + c0 + qi;
        s = valid ? s * sm_scale : kNegInf;
        float mx = s;
#pragma unroll
        for (int o = 16; o >= LPK; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, o));
        const float m_new = fmaxf(m[qi], mx);
        const float alpha = expf(m[qi] - m_new);
        const float pj = valid ? expf(s - m_new) : 0.f;
        float psum = pj;
#pragma unroll
        for (int o = 16; o >= LPK; o >>= 1)
          psum += __shfl_xor_sync(kFullMask, psum, o);
        l[qi] = l[qi] * alpha + psum;
#pragma unroll
        for (int e = 0; e < DV; ++e) acc[qi][e] *= alpha;
#pragma unroll
        for (int j = 0; j < PS; ++j) {
          const float w = __shfl_sync(kFullMask, pj, j * LPK);
#pragma unroll
          for (int e = 0; e < DV; ++e)
            acc[qi][e] += w * vs[j * KSTR + lane + 32 * e];
        }
        m[qi] = m_new;
      }
    }
  }

  // merge the warps' partial softmax states: [warp][query][m, l, acc...]
  __syncthreads();
  float* cmb = smem;
#pragma unroll
  for (int qi = 0; qi < QT; ++qi) {
    if (qi < nq) {
      float* row = cmb + (warp * QT + qi) * (D + 2);
      if (lane == 0) {
        row[0] = m[qi];
        row[1] = l[qi];
      }
#pragma unroll
      for (int e = 0; e < DV; ++e) row[2 + lane + 32 * e] = acc[qi][e];
    }
  }
  __syncthreads();
  for (int qi = warp; qi < nq; qi += kWarps) {
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      mm = fmaxf(mm, cmb[(w * QT + qi) * (D + 2)]);
    float ll = 0.f, o[DV];
#pragma unroll
    for (int e = 0; e < DV; ++e) o[e] = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* row = cmb + (w * QT + qi) * (D + 2);
      const float sc = expf(row[0] - mm);
      ll += row[1] * sc;
#pragma unroll
      for (int e = 0; e < DV; ++e) o[e] += row[2 + lane + 32 * e] * sc;
    }
    const float inv = 1.f / fmaxf(ll, 1e-30f);
    T* dst = out + q_base + (int64_t)qi * D;
#pragma unroll
    for (int e = 0; e < DV; ++e) store_f(dst + lane + 32 * e, o[e] * inv);
  }
}

template <typename T, typename KV, int PS, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* ks, const float* vs, const int* table,
                   const int* start, void* out, int B, int H, int C, int N,
                   int P, float sm_scale, cudaStream_t stream) {
  constexpr int QT = 16;
  const bool decode = C == 1;
  auto kernel = decode ? paged_attention_kernel<T, KV, PS, D, 1>
                       : paged_attention_kernel<T, KV, PS, D, QT>;
  const int bytes = decode ? dynamic_bytes<PS, D, 1>()
                           : dynamic_bytes<PS, D, QT>();
  if (bytes > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(B * H, decode ? 1 : (C + QT - 1) / QT);
  kernel<<<grid, kWarps * 32, bytes, stream>>>(
      (const T*)q, (const KV*)k, (const KV*)v, ks, vs, table, start,
      (T*)out, H, C, N, P, sm_scale);
  return cudaGetLastError();
}

// KV = void: the pool has the queries' type T
template <typename T, typename KV>
cudaError_t dispatch_shape(const void* q, const void* k, const void* v,
                           const float* ks, const float* vs,
                           const int* table, const int* start, void* out,
                           int B, int H, int C, int D, int N, int PS, int P,
                           float sm_scale, cudaStream_t stream) {
  using Pool = typename std::conditional<std::is_void<KV>::value, T,
                                         KV>::type;
#define BIGDL_PA_CASE(ps, d)                                                \
  if (PS == ps && D == d)                                                   \
    return launch<T, Pool, ps, d>(q, k, v, ks, vs, table, start, out, B, H, \
                                  C, N, P, sm_scale, stream);
  BIGDL_PA_CASE(8, 64)
  BIGDL_PA_CASE(16, 64)
  BIGDL_PA_CASE(32, 64)
#undef BIGDL_PA_CASE
  return cudaErrorInvalidValue;
}

template <typename KV>
int dispatch_dtype(const void* q, const void* k, const void* v,
                   const float* ks, const float* vs, const int* table,
                   const int* start, void* out, int B, int H, int C, int D,
                   int N, int PS, int P, float sm_scale, int dtype,
                   void* stream) {
  if (B <= 0 || H <= 0 || C <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (dtype == kF32)
    err = dispatch_shape<float, KV>(q, k, v, ks, vs, table, start, out, B,
                                    H, C, D, N, PS, P, sm_scale, s);
  else if (dtype == kBF16)
    err = dispatch_shape<__nv_bfloat16, KV>(q, k, v, ks, vs, table, start,
                                            out, B, H, C, D, N, PS, P,
                                            sm_scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

}  // namespace
}  // namespace bigdl

// q, out: (B, H, C, D); k, v: (N, H, PS, D); table: (B, P) int32, entries
// >= N are the "no page" sentinel; start: (B,) int32, query c of row b
// sits at absolute position start[b] + c. dtype: 0 float32, 1 bfloat16,
// for q, out and the pool. Supported (PS, D): (8, 64), (16, 64) and
// (32, 64): GPT-2's heads at the page sizes the reference serves with.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int bigdl_paged_attention(const void* q, const void* k,
                                     const void* v, const int* table,
                                     const int* start, void* out, int B,
                                     int H, int C, int D, int N, int PS,
                                     int P, float sm_scale, int dtype,
                                     void* stream) {
  return bigdl::dispatch_dtype<void>(q, k, v, nullptr, nullptr, table,
                                     start, out, B, H, C, D, N, PS, P,
                                     sm_scale, dtype, stream);
}

// As bigdl_paged_attention over an int8 pool: k, v int8 (N, H, PS, D),
// 16-byte aligned; k_scale, v_scale float32 (N, H, PS). dtype is q's and
// out's.
extern "C" int bigdl_paged_attention_int8(
    const void* q, const void* k, const void* v, const float* k_scale,
    const float* v_scale, const int* table, const int* start, void* out,
    int B, int H, int C, int D, int N, int PS, int P, float sm_scale,
    int dtype, void* stream) {
  return bigdl::dispatch_dtype<int8_t>(q, k, v, k_scale, v_scale, table,
                                       start, out, B, H, C, D, N, PS, P,
                                       sm_scale, dtype, stream);
}
