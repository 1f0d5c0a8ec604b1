// Paged attention for Hopper (sm_90a): chunk and decode attention straight
// against the paged K/V pool, through each slot's page table. The kernel,
// shared by its two entries: paged_attention.cu (float pools) and
// paged_attention_int8.cu (int8 pools), built as two sources so that their
// instantiations compile in parallel.
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
// - pages of 8, 16 and 32 tokens are instantiated at built widths DP of
//   32, 64, 96, 128 and 256; a head dim d runs on the narrowest DP >= d
//   (80 on 96, 160-256 on 256). The pools keep their true rows of d
//   values: a staged row is copied in chunks of 16 bytes where d values
//   fill whole chunks, else of 8 or 4 (an int8 row of 72 bytes: 8), else
//   byte by byte; its columns d .. DP - 1 are zeroed once, before the
//   first page lands, and no copy writes them, so they add exact zeros
//   to every dot product; no column past d is written out. The ring holds
//   4 pages, or 2 where 4 would not fit beside the queries and the
//   partial states (DP 256, pages of 32, a float32 pool: 65 KB a page);
//   all shared memory is dynamic (at most 163 KB: DP 256, pages of 32, a
//   float32 pool, 2 pages). Head dims above 256 run on DP 256 in chunks
//   (see paged_attention_kernel). A lane's share of a key's dot product is
//   read 4 values at a time, or 2 where the share is not a multiple of 4
//   (decode at pages of 8 and DP 32 or 96).
// Inputs may be float32 or bfloat16; all arithmetic is float32 on the CUDA
// cores. Pool offsets are 64-bit.

#pragma once

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
constexpr int kRingBytes = 160 * 1024;  // the most 4 ring pages may take
constexpr int kQT = 16;       // queries of a chunk CTA
constexpr int kPad = 16;      // bytes after each staged row
constexpr int kMaxSmem = 232448;  // a CTA's shared memory on sm_90

// one ring stage: the page's K rows, its V rows (each room for DP values
// of the pool's type, and kPad bytes), then for int8 its K and V scale
// rows; kStages pages in the ring: 4, or 2 where 4 would pass kRingBytes
template <typename KV, int PS, int DP>
struct Stage {
  static constexpr bool kInt8 = std::is_same<KV, int8_t>::value;
  static constexpr int kRow = DP * (int)sizeof(KV) + kPad;
  static constexpr int kPlane = PS * kRow;
  static constexpr int kBytes = 2 * kPlane + (kInt8 ? 2 * PS * 4 : 0);
  static constexpr int kStages = 4 * kBytes <= kRingBytes ? 4 : 2;
};

// dynamic shared memory of a CTA: the ring, the queries (float32), the
// warps' partial states (QT == 1: one per warp; else one per query) and
// the slot's row of the page table (P entries, rounded up to 16 bytes)
template <typename KV, int PS, int DP, int QT>
__host__ __device__ constexpr int smem_bytes(int P) {
  using St = Stage<KV, PS, DP>;
  return St::kStages * St::kBytes + QT * DP * 4 +
         (QT == 1 ? kWarps : QT) * (DP + 2) * 4 + (P * 4 + 15) / 16 * 16;
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

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// Page `page_head` (= page * H + h) of the pools (and its scale rows) into
// the ring stage at `dst` (`dst_ptr` the same stage as a pointer): every
// thread its share of the copies. A row holds d values; d == DP copies
// 16-byte chunks in a loop the compiler unrolls; other d copy `cw`-byte
// chunks (16, 8 or 4, whichever divides the row's bytes), or, where none
// does, each byte by a plain load and store.
template <typename KV, int PS, int DP>
__device__ __forceinline__ void stage_page(
    uint32_t dst, uint8_t* dst_ptr, const KV* __restrict__ kpool,
    const KV* __restrict__ vpool, const float* __restrict__ kscale,
    const float* __restrict__ vscale, int64_t page_head, int d, int cw) {
  using St = Stage<KV, PS, DP>;
  const char* kp =
      reinterpret_cast<const char*>(kpool + page_head * (int64_t)(PS * d));
  const char* vp =
      reinterpret_cast<const char*>(vpool + page_head * (int64_t)(PS * d));
  if (d == DP) {
    constexpr int kRowChunks = DP * (int)sizeof(KV) / 16;
    constexpr int kChunks = PS * kRowChunks;  // of one plane
    for (int i = threadIdx.x; i < 2 * kChunks; i += kThreads) {
      const int plane = i / kChunks, j = i - plane * kChunks;
      const int r = j / kRowChunks, c = j - r * kRowChunks;
      cp_async16(dst + plane * St::kPlane + r * St::kRow + c * 16,
                 (plane ? vp : kp) + j * 16, true);
    }
  } else {
    const int row_bytes = d * (int)sizeof(KV);
    const int row_chunks = row_bytes / cw;
    const int chunks = PS * row_chunks;
    for (int i = threadIdx.x; i < 2 * chunks; i += kThreads) {
      const int plane = i / chunks, j = i - plane * chunks;
      const int r = j / row_chunks, c = j - r * row_chunks;
      const int to = plane * St::kPlane + r * St::kRow + c * cw;
      const char* from = (plane ? vp : kp) + (int64_t)j * cw;
      if (cw == 16)
        cp_async16(dst + to, from, true);
      else if (cw == 8)
        cp_async8(dst + to, from);
      else if (cw == 4)
        cp_async4(dst + to, from);
      else
        dst_ptr[to] = *reinterpret_cast<const uint8_t*>(from);
    }
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

// Zero columns d .. DP - 1 of every staged K and V row of the ring: no
// copy writes them, so they stay zero for the whole walk.
template <typename KV, int PS, int DP>
__device__ __forceinline__ void zero_row_tails(uint8_t* ring, int d) {
  using St = Stage<KV, PS, DP>;
  const int lo = d * (int)sizeof(KV);
  const int width = DP * (int)sizeof(KV) - lo;
  const int rows = St::kStages * 2 * PS;
  for (int i = threadIdx.x; i < rows * width; i += kThreads) {
    const int row = i / width, c = i - row * width;
    const int stage = row / (2 * PS), rr = row - stage * 2 * PS;
    ring[stage * St::kBytes + rr * St::kRow + lo + c] = 0;
  }
}

// Zero the whole ring (every stage, rows, pads and scale rows) with
// 16-byte stores: a chunked head dim's stages are then zeros wherever no
// copy has written yet. Stages are 16-byte multiples, the ring 16-byte
// aligned.
template <typename KV, int PS, int DP>
__device__ __forceinline__ void zero_ring(uint8_t* ring) {
  using St = Stage<KV, PS, DP>;
  static_assert(St::kBytes % 16 == 0, "16-byte stages");
  uint4* r = reinterpret_cast<uint4*>(ring);
  for (int i = threadIdx.x; i < St::kStages * St::kBytes / 16; i += kThreads)
    r[i] = make_uint4(0u, 0u, 0u, 0u);
}

// A chunked head dim (d > DP = 256): chunk kc (columns kc*DP .. of each
// row, at most DP of them) of page `page_head`'s K rows into the K plane
// of the ring stage at `dst`, and, when vc >= 0, chunk vc of its V rows
// into the V plane; an int8 page's scale rows as stage_page stages them.
// Copies of `cw` bytes as stage_page makes them (cw divides d's row bytes
// and DP's, so it divides every chunk's); the columns a partial last
// chunk leaves are not written.
template <typename KV, int PS, int DP>
__device__ __forceinline__ void stage_chunk(
    uint32_t dst, uint8_t* dst_ptr, const KV* __restrict__ kpool,
    const KV* __restrict__ vpool, const float* __restrict__ kscale,
    const float* __restrict__ vscale, int64_t page_head, int d, int cw,
    int kc, int vc) {
  using St = Stage<KV, PS, DP>;
  const int64_t row_bytes = (int64_t)d * sizeof(KV);
  for (int plane = 0; plane < 2; ++plane) {
    const int c = plane ? vc : kc;
    if (c < 0) continue;
    const int row_chunks = min(DP, d - c * DP) * (int)sizeof(KV) / cw;
    const int chunks = PS * row_chunks;
    const char* src = reinterpret_cast<const char*>(
        (plane ? vpool : kpool) + page_head * (int64_t)(PS * d) +
        (int64_t)c * DP);
    for (int i = threadIdx.x; i < chunks; i += kThreads) {
      const int r = i / row_chunks, j = i - r * row_chunks;
      const int to = plane * St::kPlane + r * St::kRow + j * cw;
      const char* from = src + r * row_bytes + (int64_t)j * cw;
      if (cw == 16)
        cp_async16(dst + to, from, true);
      else if (cw == 8)
        cp_async8(dst + to, from);
      else if (cw == 4)
        cp_async4(dst + to, from);
      else
        dst_ptr[to] = *reinterpret_cast<const uint8_t*>(from);
    }
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
// scale planes kscale/vscale, which are null for a float pool). DP: the
// built width, d the head dim of q, the pools and out: d <= DP, or, for
// DP = 256, any d in nch = ceil(d / 256) chunks; cw the bytes of one
// staging copy (stage_page). QT = 1 is decode; grid (kSplit, B*H, query
// tiles * nch), one cluster per (slot, head, tile, output chunk).
//
// A chunked head dim (nch > 1) walks its pages in sub-steps of (page,
// chunk): sub-step i stages K's chunk i % nch of page i / nch (and, at the
// page's last chunk, V's chunk of this CTA's output) into the ring, and
// the queries' same chunk into q_s; each lane adds its part of the chunk's
// dot products to its running scores, and the softmax and P.V run at the
// page's last chunk. Every chunk's cluster sums the scores in the same
// order, so the clusters of a (slot, head, tile) agree on every weight;
// each keeps and writes only its chunk of the output. The ring is zeroed
// once first, so a partial last chunk's unwritten columns hold zeros or
// earlier finite pool values, each times a zero query column.
template <typename T, typename KV, int PS, int DP, int QT>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const KV* __restrict__ kpool,
                       const KV* __restrict__ vpool,
                       const float* __restrict__ kscale,
                       const float* __restrict__ vscale,
                       const int* __restrict__ table,
                       const int* __restrict__ start, T* __restrict__ out,
                       int H, int C, int N, int P, int d, int cw,
                       float sm_scale, int nch) {
  using St = Stage<KV, PS, DP>;
  constexpr int D = DP;          // the widths below are the built width's
  constexpr int kStages = St::kStages;
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
  const int tile = blockIdx.z / nch;
  const int oc = blockIdx.z - tile * nch;   // this CTA's output chunk
  const int c0 = tile * QT;
  const int nq = min(QT, C - c0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // the row's start, its table row and the queries, all read at once
  const int st = start[b];
  const int* row_table = table + (int64_t)b * P;
  for (int i = threadIdx.x; i < P; i += kThreads) pages_s[i] = row_table[i];
  const int64_t q_base = ((int64_t)bh * C + c0) * d;
  for (int i = threadIdx.x; i < QT * D; i += kThreads) {
    const int qi = i / D, j = i - qi * D;
    q_s[i] = qi < nq && j < d ? to_f(q[q_base + qi * d + j]) : 0.f;
  }
  if (nch > 1)
    zero_ring<KV, PS, D>(smem);
  else if (d < D)
    zero_row_tails<KV, PS, D>(smem, d);
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
  auto issue = [&](int i) {    // sub-step i into stage i % kStages
    const int pi = i / nch, ch = i - pi * nch;
    const int page = pages_s[p0 + pi];
    if (page < 0 || page >= N) return;  // a sentinel is not read
    const int64_t page_head = (int64_t)page * H + h;
    if (nch == 1)
      stage_page<KV, PS, D>(ring + (i % kStages) * St::kBytes,
                            smem + (i % kStages) * St::kBytes, kpool, vpool,
                            kscale, vscale, page_head, d, cw);
    else
      stage_chunk<KV, PS, D>(ring + (i % kStages) * St::kBytes,
                             smem + (i % kStages) * St::kBytes, kpool, vpool,
                             kscale, vscale, page_head, d, cw, ch,
                             ch == nch - 1 ? oc : -1);
  };
  const int steps = n * nch;   // sub-steps: pages, or (page, chunk) pairs
#pragma unroll
  for (int i = 0; i < kStages; ++i) {
    if (i < steps) issue(i);
    cp_async_commit();
  }

  float s[NQW];                // this lane's running parts of its scores
  // commit group g holds sub-step g: the prologue's kStages, then sub-step
  // i - 1 + kStages from iteration i >= 1
  for (int i = 0; i < steps; ++i) {
    if (i == 0)                    // sub-step i has landed (this thread's)
      cp_async_wait<kStages - 1>();
    else
      cp_async_wait<kStages - 2>();
    __syncthreads();               // everyone's; step i - 1's stage is free
    if (i > 0) {
      if (i - 1 + kStages < steps) issue(i - 1 + kStages);
      cp_async_commit();
    }
    const int pi = i / nch, ch = i - pi * nch;
    const int p = p0 + pi;
    const int page = pages_s[p];
    if (page < 0 || page >= N) continue;
    if (nch > 1) {                 // the queries' chunk ch
      for (int e = threadIdx.x; e < QT * D; e += kThreads) {
        const int qi = e / D, j = ch * D + e - qi * D;
        q_s[e] = qi < nq && j < d ? to_f(q[q_base + qi * d + j]) : 0.f;
      }
      __syncthreads();
    }
    const uint8_t* stg = smem + (i % kStages) * St::kBytes;
    const float* ksc = reinterpret_cast<const float*>(stg + 2 * St::kPlane);
    const float* vsc = ksc + PS;

    // this lane's part of its key's scores for the warp's queries
    const KV* krow = reinterpret_cast<const KV*>(stg + kk * St::kRow);
    if (ch == 0) {
#pragma unroll
      for (int qi = 0; qi < NQW; ++qi) s[qi] = 0.f;
    }
#pragma unroll
    for (int t = 0; t < DK / VW; ++t) {
      const int dd = VW * sub + VW * LPK * t;
      float kv[VW];
      ldv<VW>(krow + dd, kv);
      if constexpr (St::kInt8) {
        const float sk = ksc[kk];
#pragma unroll
        for (int j = 0; j < VW; ++j) kv[j] *= sk;
      }
#pragma unroll
      for (int qi = 0; qi < NQW; ++qi) {
        float qv[VW];
        ldv<VW>(q_s + (wq0 + qi) * D + dd, qv);
#pragma unroll
        for (int j = 0; j < VW; ++j) s[qi] = fmaf(qv[j], kv[j], s[qi]);
      }
    }
    if (ch < nch - 1) continue;    // the page's scores need its next chunk

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
    T* dst = out + q_base + (int64_t)qq * d + oc * D;
#pragma unroll
    for (int e = 0; e < DV; ++e)
      if (oc * D + lane + 32 * e < d)
        store_f(dst + lane + 32 * e, o[e] * inv);
  }
  cluster.sync();  // the partial states stay until every merge has read them
}

// the bytes of one staging copy of a row of d values of `elt` bytes:
// the largest of 16, 8 and 4 that divides the row, else 1
__host__ __device__ constexpr int copy_bytes(int d, int elt) {
  return (d * elt) % 16 == 0 ? 16 : (d * elt) % 8 == 0 ? 8
                                  : (d * elt) % 4 == 0 ? 4 : 1;
}

template <typename T, typename KV, int PS, int DP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* ks, const float* vs, const int* table,
                   const int* start, void* out, int B, int H, int C, int d,
                   int N, int P, float sm_scale, cudaStream_t stream) {
  const bool decode = C == 1;
  auto kernel = decode ? paged_attention_kernel<T, KV, PS, DP, 1>
                       : paged_attention_kernel<T, KV, PS, DP, kQT>;
  const int bytes = decode ? smem_bytes<KV, PS, DP, 1>(P)
                           : smem_bytes<KV, PS, DP, kQT>(P);
  const int nch = (d + DP - 1) / DP;   // 1 unless d > DP = 256
  const int64_t tiles = (int64_t)(decode ? 1 : (C + kQT - 1) / kQT) * nch;
  if (tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(kSplit, B * H, (unsigned)tiles);
  if (grid.y > 65535 || grid.z > 65535 || bytes > kMaxSmem)
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const KV*)k, (const KV*)v, ks, vs, table, start,
      (T*)out, H, C, N, P, d, copy_bytes(d, (int)sizeof(KV)), sm_scale,
      nch);
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
  // the built width that runs head dim D: the narrowest DP >= D, or 256
  // in ceil(D / 256) chunks above it
  const int dp = D <= 32 ? 32 : D <= 64 ? 64 : D <= 96 ? 96 : D <= 128 ? 128
                                                              : 256;
  if (D < 1) return cudaErrorInvalidValue;
#define BIGDL_PA_CASE(ps, w)                                                \
  if (PS == ps && dp == w)                                                  \
    return launch<T, Pool, ps, w>(q, k, v, ks, vs, table, start, out, B, H, \
                                  C, D, N, P, sm_scale, stream);
#define BIGDL_PA_PAGES(w) \
  BIGDL_PA_CASE(8, w)       \
  BIGDL_PA_CASE(16, w)      \
  BIGDL_PA_CASE(32, w)
  BIGDL_PA_PAGES(32)
  BIGDL_PA_PAGES(64)
  BIGDL_PA_PAGES(96)
  BIGDL_PA_PAGES(128)
  BIGDL_PA_PAGES(256)
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

