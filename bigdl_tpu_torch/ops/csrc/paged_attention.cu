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
// per visible key against 2*D*elt bytes of K/V (2*(D+4) for int8), far below
// the card's ~20 flops/byte (fp32 CUDA cores) or ~295 (bf16 tensor cores)
// balance point. The floor is one read of every visible K/V page over HBM.
// A 64-query prefill chunk shares each page among its queries and, in
// float32, crosses over to operations.
//
// What the design does about it:
// - no dense gather: K/V pages are read straight through the page table;
//   a sentinel entry (>= num_pages) is skipped without being read (the TPU
//   kernel clamps it to page N-1, fetches it and masks it out), and the
//   walk stops at the last page the CTA's queries can see,
//   ceil((start + last query + 1) / page_size);
// - the walk of one (slot, head, query tile) is split across a cluster of
//   kSplit CTAs: CTA r walks the r-th run of ceil(pages / kSplit) pages.
//   The split depends on the row alone (its start, the tile and the page
//   size), never on B, H or the card, so a head-sharded launch (tp) does
//   for each (slot, head) exactly what the unsharded one does, and a call
//   repeats bit for bit. At the decode case this turns the longest row's
//   63 pages on one CTA into 8 on each of 8 CTAs;
// - the slot's start, its page-table row and the queries are read at
//   once; then the CTA's pages stream through a ring of kStages pages in
//   shared memory, 16-byte cp.async copies by all 128 threads (int8 pages
//   and their scale rows too, in the pool's own type): the first kStages
//   pages in flight together, each stage refilled as soon as every warp
//   is done with it;
// - each staged page is read by all four warps. Decode (one query): warp w
//   scores keys [w*PS/4, (w+1)*PS/4) of each page, 128/PS lanes to a key,
//   and keeps its own online-softmax state (m, l, acc in fp32 registers).
//   Chunk (a tile of 16 queries): warp w owns queries 4w .. 4w + 3 and
//   scores every key of the page, 32/PS lanes to a key, each K value read
//   once from shared memory for its four queries. A lane owns D/32 output
//   dims for the P.V update, the weights broadcast by shuffles. Staged rows
//   are padded by 16 bytes, so a quarter-warp's 16-byte reads of a key
//   split over lanes hit distinct banks;
// - merge: each warp leaves its (m, l, acc) in its CTA's shared memory;
//   after a cluster barrier the CTA of rank q % kSplit merges query q of
//   the tile over the cluster's states through distributed shared memory
//   in a fixed order (ranks, then warps), and writes it. One launch, no
//   global scratch, no atomics;
// - pages of 8, 16 and 32 tokens are instantiated at head dims 32, 64, 96
//   and 128 (every multiple of 32 up to 128); all shared memory is dynamic
//   (at most 152 KB: D 128, pages of 32, a float32 pool). A lane's share of
//   a key's dot product is read 4 values at a time, or 2 where the share
//   is not a multiple of 4 (decode at pages of 8 and D 32 or 96).
// Inputs may be float32 or bfloat16; all arithmetic is float32 on the CUDA
// cores. Pool offsets are 64-bit.

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace bigdl {
namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kSplit = 8;     // CTAs of a cluster: splits of one page walk
constexpr int kStages = 4;    // pages in the ring
constexpr int kQT = 16;       // queries of a chunk CTA
constexpr int kPad = 16;      // bytes after each staged row

// one ring stage: the page's K rows, its V rows (each D values of the
// pool's type and kPad bytes), then for int8 its K and V scale rows
template <typename KV, int PS, int D>
struct Stage {
  static constexpr bool kInt8 = std::is_same<KV, int8_t>::value;
  static constexpr int kRow = D * (int)sizeof(KV) + kPad;
  static constexpr int kPlane = PS * kRow;
  static constexpr int kBytes = 2 * kPlane + (kInt8 ? 2 * PS * 4 : 0);
};

// dynamic shared memory of a CTA: the ring, the queries (float32), the
// warps' partial states (QT == 1: one per warp; else one per query) and
// the slot's row of the page table (P entries, rounded up to 16 bytes)
template <typename KV, int PS, int D, int QT>
__host__ __device__ constexpr int smem_bytes(int P) {
  return kStages * Stage<KV, PS, D>::kBytes + QT * D * 4 +
         (QT == 1 ? kWarps : QT) * (D + 2) * 4 + (P * 4 + 15) / 16 * 16;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 ld4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 ld2(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2((float)c.x, (float)c.y);
}

// VW (4 or 2) consecutive values from p, aligned to VW elements, as floats
template <int VW, typename X>
__device__ __forceinline__ void ldv(const X* p, float (&o)[VW]) {
  if constexpr (VW == 4) {
    const float4 a = ld4(p);
    o[0] = a.x;
    o[1] = a.y;
    o[2] = a.z;
    o[3] = a.w;
  } else {
    const float2 a = ld2(p);
    o[0] = a.x;
    o[1] = a.y;
  }
}

// Page `page_head` (= page * H + h) of the pools (and its scale rows) into
// the ring stage at `dst`: every thread its share of 16-byte copies.
template <typename KV, int PS, int D>
__device__ __forceinline__ void stage_page(
    uint32_t dst, const KV* __restrict__ kpool, const KV* __restrict__ vpool,
    const float* __restrict__ kscale, const float* __restrict__ vscale,
    int64_t page_head) {
  using St = Stage<KV, PS, D>;
  constexpr int kRowChunks = D * (int)sizeof(KV) / 16;
  constexpr int kChunks = PS * kRowChunks;  // of one plane
  const char* kp =
      reinterpret_cast<const char*>(kpool + page_head * (PS * D));
  const char* vp =
      reinterpret_cast<const char*>(vpool + page_head * (PS * D));
  for (int i = threadIdx.x; i < 2 * kChunks; i += kThreads) {
    const int plane = i / kChunks, j = i - plane * kChunks;
    const int r = j / kRowChunks, c = j - r * kRowChunks;
    cp_async16(dst + plane * St::kPlane + r * St::kRow + c * 16,
               (plane ? vp : kp) + j * 16, true);
  }
  if constexpr (St::kInt8) {
    constexpr int kScChunks = PS * 4 / 16;  // of one scale row
    if (threadIdx.x < 2 * kScChunks) {
      const int plane = threadIdx.x / kScChunks;
      const int c = threadIdx.x - plane * kScChunks;
      cp_async16(dst + 2 * St::kPlane + plane * PS * 4 + c * 16,
                 (plane ? vscale : kscale) + page_head * PS + c * 4, true);
    }
  }
}

// T: the queries' and output's type; KV: the pool's (T, or int8_t with the
// scale planes kscale/vscale, which are null for a float pool). QT = 1 is
// decode; grid (kSplit, B*H, query tiles), one cluster per (slot, head,
// tile).
template <typename T, typename KV, int PS, int D, int QT>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const KV* __restrict__ kpool,
                       const KV* __restrict__ vpool,
                       const float* __restrict__ kscale,
                       const float* __restrict__ vscale,
                       const int* __restrict__ table,
                       const int* __restrict__ start, T* __restrict__ out,
                       int H, int C, int N, int P, float sm_scale) {
  using St = Stage<KV, PS, D>;
  constexpr bool kDecode = QT == 1;
  constexpr int KW = kDecode ? PS / kWarps : PS;  // keys a warp scores
  constexpr int LPK = 32 / KW;   // lanes sharing one key's dot product
  constexpr int DK = D / LPK;    // dims of that dot product per lane
  constexpr int VW = DK % 4 == 0 ? 4 : 2;         // of them read at once
  constexpr int NQW = kDecode ? 1 : QT / kWarps;  // queries a warp owns
  constexpr int DV = D / 32;     // output dims per lane
  constexpr int kParts = kDecode ? kWarps : 1;    // states a query has a CTA
  static_assert(KW >= 1 && 32 % KW == 0 && DK % VW == 0 && D % 32 == 0 &&
                    (kDecode || QT % kWarps == 0),
                "unsupported tile");

  extern __shared__ float4 smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  float* q_s = reinterpret_cast<float*>(smem + kStages * St::kBytes);
  float* part = q_s + QT * D;    // partial states: [row][m, l, acc[D]]
  int* pages_s = reinterpret_cast<int*>(part + (kDecode ? kWarps : QT) *
                                        (D + 2));  // the table row

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int c0 = blockIdx.z * QT;
  const int nq = min(QT, C - c0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // the row's start, its table row and the queries, all read at once
  const int st = start[b];
  const int* row_table = table + (int64_t)b * P;
  for (int i = threadIdx.x; i < P; i += kThreads) pages_s[i] = row_table[i];
  const int64_t q_base = ((int64_t)bh * C + c0) * D;
  for (int i = threadIdx.x; i < QT * D; i += kThreads)
    q_s[i] = i < nq * D ? to_f(q[q_base + i]) : 0.f;
  __syncthreads();
  // pages this tile's queries can see, and this CTA's run of them
  const int npages = min(P, (st + c0 + nq - 1) / PS + 1);
  const int per = (npages + kSplit - 1) / kSplit;
  const int p0 = min(npages, rank * per);
  const int n = min(npages, p0 + per) - p0;

  float m[NQW], l[NQW], acc[NQW][DV];
#pragma unroll
  for (int qi = 0; qi < NQW; ++qi) {
    m[qi] = kNegInf;
    l[qi] = 0.f;
#pragma unroll
    for (int e = 0; e < DV; ++e) acc[qi][e] = 0.f;
  }

  const int kk = (kDecode ? warp * KW : 0) + lane / LPK;  // this lane's key
  const int sub = lane % LPK;
  const int kw0 = kDecode ? warp * KW : 0;   // the warp's first key
  const int wq0 = kDecode ? 0 : warp * NQW;  // the warp's first query
  const uint32_t ring = smem_u32(smem);
  auto issue = [&](int i) {    // page p0 + i into stage i % kStages
    const int page = pages_s[p0 + i];
    if (page >= 0 && page < N)  // a sentinel is not read
      stage_page<KV, PS, D>(ring + (i % kStages) * St::kBytes, kpool, vpool,
                            kscale, vscale, (int64_t)page * H + h);
  };
#pragma unroll
  for (int i = 0; i < kStages; ++i) {
    if (i < n) issue(i);
    cp_async_commit();
  }

  // commit group g holds page g: the prologue's kStages, then page
  // i - 1 + kStages from iteration i >= 1
  for (int i = 0; i < n; ++i) {
    if (i == 0)                    // page i has landed (this thread's part)
      cp_async_wait<kStages - 1>();
    else
      cp_async_wait<kStages - 2>();
    __syncthreads();               // everyone's; page i - 1's stage is free
    if (i > 0) {
      if (i - 1 + kStages < n) issue(i - 1 + kStages);
      cp_async_commit();
    }
    const int p = p0 + i;
    const int page = pages_s[p];
    if (page < 0 || page >= N) continue;
    const uint8_t* stg = smem + (i % kStages) * St::kBytes;
    const float* ksc = reinterpret_cast<const float*>(stg + 2 * St::kPlane);
    const float* vsc = ksc + PS;

    // this lane's part of its key's scores for the warp's queries
    const KV* krow = reinterpret_cast<const KV*>(stg + kk * St::kRow);
    float s[NQW];
#pragma unroll
    for (int qi = 0; qi < NQW; ++qi) s[qi] = 0.f;
#pragma unroll
    for (int t = 0; t < DK / VW; ++t) {
      const int d = VW * sub + VW * LPK * t;
      float kv[VW];
      ldv<VW>(krow + d, kv);
      if constexpr (St::kInt8) {
        const float sk = ksc[kk];
#pragma unroll
        for (int j = 0; j < VW; ++j) kv[j] *= sk;
      }
#pragma unroll
      for (int qi = 0; qi < NQW; ++qi) {
        float qv[VW];
        ldv<VW>(q_s + (wq0 + qi) * D + d, qv);
#pragma unroll
        for (int j = 0; j < VW; ++j) s[qi] = fmaf(qv[j], kv[j], s[qi]);
      }
    }

    // online softmax over the warp's keys of this page
    float pj[NQW];
#pragma unroll
    for (int qi = 0; qi < NQW; ++qi) {
#pragma unroll
      for (int o = LPK / 2; o > 0; o >>= 1)
        s[qi] += __shfl_xor_sync(kFullMask, s[qi], o);
      const bool valid =
          wq0 + qi < nq && p * PS + kk <= st + c0 + wq0 + qi;
      const float sv = valid ? s[qi] * sm_scale : kNegInf;
      float mx = sv;
#pragma unroll
      for (int o = 16; o >= LPK; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, o));
      const float m_new = fmaxf(m[qi], mx);
      const float alpha = expf(m[qi] - m_new);
      pj[qi] = valid ? expf(sv - m_new) : 0.f;
      float psum = pj[qi];
#pragma unroll
      for (int o = 16; o >= LPK; o >>= 1)
        psum += __shfl_xor_sync(kFullMask, psum, o);
      l[qi] = l[qi] * alpha + psum;
#pragma unroll
      for (int e = 0; e < DV; ++e) acc[qi][e] *= alpha;
      m[qi] = m_new;
    }

    // P.V: each V value read once for the warp's queries
#pragma unroll
    for (int j = 0; j < KW; ++j) {
      const KV* vrow =
          reinterpret_cast<const KV*>(stg + St::kPlane + (kw0 + j) * St::kRow);
      float v[DV];
#pragma unroll
      for (int e = 0; e < DV; ++e) {
        v[e] = to_f(vrow[lane + 32 * e]);
        if constexpr (St::kInt8) v[e] *= vsc[kw0 + j];
      }
#pragma unroll
      for (int qi = 0; qi < NQW; ++qi) {
        const float w = __shfl_sync(kFullMask, pj[qi], j * LPK);
#pragma unroll
        for (int e = 0; e < DV; ++e) acc[qi][e] = fmaf(w, v[e], acc[qi][e]);
      }
    }
  }
  cp_async_wait<0>();

  // the warps' partial states, then the cluster's merge of each query
#pragma unroll
  for (int qi = 0; qi < NQW; ++qi) {
    float* row = part + (kDecode ? warp : wq0 + qi) * (D + 2);
    if (lane == 0) {
      row[0] = m[qi];
      row[1] = l[qi];
    }
#pragma unroll
    for (int e = 0; e < DV; ++e) row[2 + lane + 32 * e] = acc[qi][e];
  }
  cluster.sync();
  for (int qq = rank + kSplit * warp; qq < nq; qq += kSplit * kWarps) {
    // every state's m first, all remote reads in flight together
    float mv[kSplit * kParts];
    float mm = kNegInf;
#pragma unroll
    for (int r = 0; r < kSplit; ++r) {
      const float* rp = cluster.map_shared_rank(part, r);
#pragma unroll
      for (int w = 0; w < kParts; ++w)
        mv[r * kParts + w] = rp[(kDecode ? w : qq) * (D + 2)];
    }
#pragma unroll
    for (int i = 0; i < kSplit * kParts; ++i) mm = fmaxf(mm, mv[i]);
    float ll = 0.f, o[DV];
#pragma unroll
    for (int e = 0; e < DV; ++e) o[e] = 0.f;
#pragma unroll
    for (int r = 0; r < kSplit; ++r) {
      const float* rp = cluster.map_shared_rank(part, r);
#pragma unroll
      for (int w = 0; w < kParts; ++w) {
        const float* row = rp + (kDecode ? w : qq) * (D + 2);
        const float sc = expf(mv[r * kParts + w] - mm);
        ll += row[1] * sc;
#pragma unroll
        for (int e = 0; e < DV; ++e) o[e] += row[2 + lane + 32 * e] * sc;
      }
    }
    const float inv = 1.f / fmaxf(ll, 1e-30f);
    T* dst = out + q_base + (int64_t)qq * D;
#pragma unroll
    for (int e = 0; e < DV; ++e) store_f(dst + lane + 32 * e, o[e] * inv);
  }
  cluster.sync();  // the partial states stay until every merge has read them
}

template <typename T, typename KV, int PS, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* ks, const float* vs, const int* table,
                   const int* start, void* out, int B, int H, int C, int N,
                   int P, float sm_scale, cudaStream_t stream) {
  const bool decode = C == 1;
  auto kernel = decode ? paged_attention_kernel<T, KV, PS, D, 1>
                       : paged_attention_kernel<T, KV, PS, D, kQT>;
  const int bytes = decode ? smem_bytes<KV, PS, D, 1>(P)
                           : smem_bytes<KV, PS, D, kQT>(P);
  const dim3 grid(kSplit, B * H, decode ? 1 : (C + kQT - 1) / kQT);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, bytes, stream>>>(
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
#define BIGDL_PA_PAGES(d) \
  BIGDL_PA_CASE(8, d)       \
  BIGDL_PA_CASE(16, d)      \
  BIGDL_PA_CASE(32, d)
  BIGDL_PA_PAGES(32)
  BIGDL_PA_PAGES(64)
  BIGDL_PA_PAGES(96)
  BIGDL_PA_PAGES(128)
#undef BIGDL_PA_PAGES
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

// q, out: (B, H, C, D); k, v: (N, H, PS, D), 16-byte aligned; table: (B,
// P) int32, entries >= N are the "no page" sentinel; start: (B,) int32,
// query c of row b sits at absolute position start[b] + c. dtype: 0
// float32, 1 bfloat16, for q, out and the pool. Supported (PS, D): pages of
// 8, 16 and 32 tokens (the sizes the reference serves with) at D 32, 64, 96
// and 128. B*H and the query tiles ceil(C / 16) at most 65535 each.
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
// k_scale, v_scale float32 (N, H, PS), all 16-byte aligned. dtype is q's
// and out's.
extern "C" int bigdl_paged_attention_int8(
    const void* q, const void* k, const void* v, const float* k_scale,
    const float* v_scale, const int* table, const int* start, void* out,
    int B, int H, int C, int D, int N, int PS, int P, float sm_scale,
    int dtype, void* stream) {
  return bigdl::dispatch_dtype<int8_t>(q, k, v, k_scale, v_scale, table,
                                       start, out, B, H, C, D, N, PS, P,
                                       sm_scale, dtype, stream);
}
