// Fused sampling for Hopper (sm_90a): temperature, top-k, top-p and the
// gumbel-argmax draw in one kernel, each row split across a cluster of CTAs
// and cut by a radix select.
//
// Replaces the TPU kernel bigdl_tpu/ops/sampling.py `_sample_kernel` :75
// (with `_cutoff` :44), launched by `fused_sample_logits` :96.
//
// What it computes, per row s of (S, V) logits, with the reference's exact
// semantics (ops/sampling.py `fused_sample_logits_ref` is the plain version):
//   l = logits[s] / max(temps[s], 1e-6)            (a true division)
//   top-k (0 < k < V): keep l_i iff count(l > l_i) < k
//   top-p (p < 1): then keep l_i iff mass(l > l_i) < p, the mass being the
//     softmax over the entries top-k kept
//   out[s] = argmax over the kept i of l_i + gumbel[s, i], first index on ties
// Both cuts count only "real" entries (l > NEG_INF / 2), as the reference's
// bisection does. A row where a cut keeps nothing (no real entry, or
// p <= 0) draws token 0, the reference's argmax over an all-NEG_INF row.
// The gumbel noise is an input (drawn by the caller), as in the reference.
//
// What bounds it: bytes. The function reads the logits once, the noise of
// the tokens that can win the draw (the kept set), the temperatures, and
// writes the tokens: 1.6 MB at 8 x 50,257 float32, under 0.5 us at HBM's
// rate. A selection needs a constant number of passes over the row, each
// a few operations an element, so no pass may go back to HBM and the
// passes must be few and short.
//
// What the design does about it:
// - a cluster of kCluster CTAs per row. CTA r stages its contiguous share
//   of the temperature-scaled row (ceil(V / kCluster) logits, a split that
//   depends on V alone, so a row samples the same token alone or in a
//   batch) in its own shared memory, read from HBM by 16-byte loads with a
//   scalar head and tail (a row starts at s * V, unaligned for odd V);
//   rows over kCluster * kMaxShare logits (428,032) re-read and re-scale
//   their share from global memory on each pass instead (ROW_IN_SMEM
//   false), the same arithmetic;
// - each cut is a radix select on the order-preserving uint32 key of l, 8
//   bits a round, most significant first: 4 rounds, each one pass over the
//   share into a 256-bin histogram in shared memory (warp-aggregated
//   atomics), one cluster barrier, and a merge of the cluster's histograms
//   through distributed shared memory that every CTA scans alike. Top-k
//   bins hold counts. Top-p bins hold counts and mass as 64-bit fixed
//   point, exp(l - max) * 2^mass_bits rounded to an integer (two 32-bit
//   atomics with a carry), compared against ceil(Z * p) with Z the total:
//   integer sums do not depend on the order of the atomics, so a call
//   repeats bit for bit, and the rounding (2^-41 of the largest weight an
//   entry) is far under the 1e-5 of a kept-set boundary. The row max and
//   the real count come from the staging pass;
// - the small kept set: when top-k keeps at most kSmall entries (GPT-2
//   serving's k = 50, bfloat16 ties included), the cluster gathers them to
//   rank 0 (remote atomics into its shared memory), as soon as a round's
//   bucket and those above it hold at most kEarly entries (often after 1
//   or 2 rounds), else after the last. Rank 0 alone finishes top-k and
//   top-p by counting, for each candidate, the larger ones and their
//   fixed-point mass, and draws from their gumbel values alone. The general
//   path (top-k off, or a larger kept set) runs the 4 top-p rounds over
//   the cluster and a draw pass that reads the noise of the kept entries
//   only. Both paths use the same weights and threshold and keep the same
//   set;
// - the draw: each CTA's argmax of l + gumbel over its kept entries (first
//   index on ties), pushed to rank 0, merged there in rank order. Without
//   any cut the draw is the staging pass itself: one read of the logits
//   and the noise.
// About 10 cluster barriers replace the previous design's ~125 dependent
// block-wide bisection passes.

#include <cooperative_groups.h>
#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace bigdl {
namespace {

namespace cg = cooperative_groups;
using u64 = unsigned long long;

constexpr int kCluster = 8;     // CTAs a row (ops/sampling.py CLUSTER)
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;      // 8-bit digits, 4 rounds a cut
constexpr int kSmall = 512;     // the largest kept set gathered to rank 0
constexpr int kEarly = 128;     // ... before the last top-k round
constexpr int kMaxSmem = 232448;
// bytes of shared memory before the staged share (ops/sampling.py
// FIXED_SMEM); the share's floats follow
constexpr int kFixedSmem = 18432;
constexpr int kMaxShare = (kMaxSmem - kFixedSmem) / 4;
constexpr float kRealFloor = 0.5f * kNegInf;
enum Path { kPathDraw = 0, kPathSmall = 1, kPathRadix = 2 };

struct Shared {
  uint32_t cnt[2][kBins];  // this CTA's histograms, alternate rounds
  uint32_t mlo[2][kBins];  // their fixed-point mass, low and high words
  uint32_t mhi[2][kBins];
  uint32_t mcnt[kBins];    // the cluster's merged histogram
  u64 mmass[kBins];
  float cand_l[kSmall];    // rank 0: the gathered kept set
  int cand_i[kSmall];
  u64 cand_e[kSmall];
  u64 red64[kWarps];       // block reductions
  float redf[kWarps];
  int redi[kWarps];
  float slot_v[kCluster];  // rank 0: each rank's draw
  int slot_i[kCluster];
  float mx;                // this CTA's max of l and real count (read by
  uint32_t nreal;          // the cluster), then the row's
  float gmx;
  uint32_t gnreal;
  uint32_t ncand;          // rank 0: candidates gathered
  int digit;               // a round's selected bin (-1: none)
  uint32_t eq;             // its count
  u64 above;               // the count or mass above it
  u64 thresh;              // top-p: ceil(Z * p)
};
static_assert(sizeof(Shared) <= kFixedSmem, "shared layout outgrew its room");

__device__ __forceinline__ uint32_t key_of(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float value_of(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}
// the temperature-scaled logit; -0 as +0, so a value has one key
__device__ __forceinline__ float scaled(float x, float t) {
  const float l = x / t;
  return l == 0.f ? 0.f : l;
}
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}
__device__ __forceinline__ void warp_argmax(float& bv, int& bi) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFullMask, bv, o);
    const int oi = __shfl_xor_sync(kFullMask, bi, o);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
}
// every thread gets the block's argmax (first index on ties)
__device__ void block_argmax(Shared* sh, float& bv, int& bi) {
  warp_argmax(bv, bi);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    sh->redf[threadIdx.x >> 5] = bv;
    sh->redi[threadIdx.x >> 5] = bi;
  }
  __syncthreads();
  bv = sh->redf[threadIdx.x & 31];
  bi = sh->redi[threadIdx.x & 31];
  warp_argmax(bv, bi);
}
__device__ float block_max(Shared* sh, float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh->redf[threadIdx.x >> 5] = v;
  __syncthreads();
  v = sh->redf[threadIdx.x & 31];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}
__device__ u64 block_sum(Shared* sh, u64 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh->red64[threadIdx.x >> 5] = v;
  __syncthreads();
  v = sh->red64[threadIdx.x & 31];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// 64-bit add into a (lo, hi) pair of 32-bit words with native atomics: the
// carry out of lo is detected by the one atomic that wraps it
__device__ __forceinline__ void add64(uint32_t* lo, uint32_t* hi, u64 x) {
  const uint32_t xl = (uint32_t)x;
  const uint32_t old = atomicAdd(lo, xl);
  const uint32_t xh = (uint32_t)(x >> 32) + (old + xl < old ? 1u : 0u);
  if (xh) atomicAdd(hi, xh);
}

// Warp-uniform histogram updates: every lane of the warp calls, d < 0 for a
// lane with nothing to add. The lanes of one digit (__match_any_sync) add
// once, by their lowest lane: their count, and (hist_mass) their masses
// m <= 2^40, summed over the group (a reduction on the group's own mask,
// as cooperative groups' labeled partitions do) in two 21-bit halves, each
// under 2^26 over a warp.
__device__ __forceinline__ void hist_count(uint32_t* cnt, int d) {
  const unsigned act = __ballot_sync(kFullMask, d >= 0);
  if (d >= 0) {
    const unsigned grp = __match_any_sync(act, d);
    if ((int)(threadIdx.x & 31) == __ffs(grp) - 1)
      atomicAdd(&cnt[d], (uint32_t)__popc(grp));
  }
}
__device__ __forceinline__ void hist_mass(uint32_t* cnt, uint32_t* lo,
                                          uint32_t* hi, int d, u64 m) {
  const unsigned act = __ballot_sync(kFullMask, d >= 0);
  if (d >= 0) {
    const unsigned grp = __match_any_sync(act, d);
    const uint32_t a = __reduce_add_sync(grp, (uint32_t)(m & 0x1fffffu));
    const uint32_t b = __reduce_add_sync(grp, (uint32_t)(m >> 21));
    if ((int)(threadIdx.x & 31) == __ffs(grp) - 1) {
      atomicAdd(&cnt[d], (uint32_t)__popc(grp));
      add64(&lo[d], &hi[d], ((u64)b << 21) + a);
    }
  }
}

// The cluster's histograms of round buffer `buf` summed bin by bin (threads
// 0..255, ranks in order) into mcnt/mmass. Call after the cluster barrier
// that follows every rank's pass; ends with a block barrier.
__device__ void merge_bins(cg::cluster_group& cluster, Shared* sh, int buf,
                           bool mass) {
  const int b = threadIdx.x;
  if (b < kBins) {
    uint32_t c[kCluster], lo[kCluster], hi[kCluster];
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      const Shared* o = cluster.map_shared_rank(sh, r);
      c[r] = o->cnt[buf][b];
      lo[r] = mass ? o->mlo[buf][b] : 0u;
      hi[r] = mass ? o->mhi[buf][b] : 0u;
    }
    uint32_t cs = 0;
    u64 ms = 0;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      cs += c[r];
      ms += ((u64)hi[r] << 32) | lo[r];
    }
    sh->mcnt[b] = cs;
    sh->mmass[b] = ms;
  }
  __syncthreads();
}

// Warp 0: lane L owns merged bins 8L .. 8L+7. Top-k: the bin holding the
// k-th largest key of the bucket, the largest d with count(bins >= d) >= k.
__device__ void select_count(Shared* sh, uint32_t k) {
  const int lane = threadIdx.x;
  uint32_t c[8], local = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j] = sh->mcnt[8 * lane + j];
    local += c[j];
  }
  uint32_t suf = local;  // inclusive suffix sum over the lanes
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t t = __shfl_down_sync(kFullMask, suf, o);
    if (lane + o < 32) suf += t;
  }
  uint32_t above = suf - local, best_above = 0, best_eq = 0;
  int best = -1;
#pragma unroll
  for (int j = 7; j >= 0; --j) {
    if (best < 0 && above + c[j] >= k) {
      best = 8 * lane + j;
      best_above = above;
      best_eq = c[j];
    }
    above += c[j];
  }
  const int d = __reduce_max_sync(kFullMask, best);
  if (best == d) {
    sh->digit = d;
    sh->above = best_above;
    sh->eq = best_eq;
  }
}

// Warp 0, top-p: with A the mass above the bucket and T = ceil(Z * p), the
// lowest non-empty bin d with A + mass(bins > d) < T (-1 if none). With
// `total`, first sets thresh from Z, the sum of every bin.
__device__ void select_mass(Shared* sh, u64 A, float p, bool total) {
  const int lane = threadIdx.x;
  uint32_t c[8];
  u64 m[8], local = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j] = sh->mcnt[8 * lane + j];
    m[j] = sh->mmass[8 * lane + j];
    local += m[j];
  }
  u64 suf = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const u64 t = __shfl_down_sync(kFullMask, suf, o);
    if (lane + o < 32) suf += t;
  }
  if (total) {
    const u64 z = __shfl_sync(kFullMask, suf, 0);
    const double zp = fmax(__dmul_rn(__ull2double_rn(z), (double)p), 0.0);
    if (lane == 0) sh->thresh = __double2ull_ru(zp);
  }
  __syncwarp();
  const u64 T = sh->thresh;
  u64 above = A + (suf - local), best_above = 0;
  uint32_t best_eq = 0;
  unsigned best = kBins;
#pragma unroll
  for (int j = 7; j >= 0; --j) {
    if (c[j] > 0 && above < T) {
      best = 8 * lane + j;   // the lowest such bin of this lane
      best_above = above;
      best_eq = c[j];
    }
    above += m[j];
  }
  const unsigned d = __reduce_min_sync(kFullMask, best);
  if (d == kBins) {
    if (lane == 0) sh->digit = -1;
  } else if (best == d) {
    sh->digit = (int)d;
    sh->above = best_above;
    sh->eq = best_eq;
  }
}

// fixed-point weight of a kept logit: exp(l - mx) * 2^mass_bits, rounded
__device__ __forceinline__ u64 mass_of(float l, float mx, float scale) {
  return __float2ull_rn(expf(l - mx) * scale);
}

// element e of 16 loaded bytes as a float
__device__ __forceinline__ float elem(const uint4& raw, int e, float*) {
  return __uint_as_float((&raw.x)[e]);
}
__device__ __forceinline__ float elem(const uint4& raw, int e,
                                      __nv_bfloat16*) {
  const uint32_t w = (&raw.x)[e >> 1];
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}

// Visit the CTA's share [0, n) of a row at `src` (global, T) as
// f(i, x, y, valid), warp-uniformly (every lane of a warp calls f equally
// often): the 16-byte-aligned body by 16-byte loads, the head and tail by
// scalars. With `src2` (aligned as `src` is), y is its element i, loaded
// the same way; else y is 0.
template <typename T, class F>
__device__ __forceinline__ void for_loaded(const T* src, const T* src2, int n,
                                           F f) {
  constexpr int kVec = 16 / sizeof(T);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int head =
      min(n, (int)((16 - ((uintptr_t)src & 15)) & 15) / (int)sizeof(T));
  const int nvec = (n - head) / kVec;
  const int body_end = head + nvec * kVec;
  const int nscalar = head + (n - body_end);
  for (int b = warp * 32; b < nvec; b += kThreads) {
    const int v = b + lane;
    const bool valid = v < nvec;
    uint4 x = make_uint4(0, 0, 0, 0), y = make_uint4(0, 0, 0, 0);
    if (valid) {
      x = *reinterpret_cast<const uint4*>(src + head + v * kVec);
      if (src2) y = *reinterpret_cast<const uint4*>(src2 + head + v * kVec);
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      f(head + v * kVec + e, elem(x, e, (T*)nullptr),
        elem(y, e, (T*)nullptr), valid);
  }
  for (int b = warp * 32; b < nscalar; b += kThreads) {
    const int j = b + lane;
    const bool valid = j < nscalar;
    const int i = j < head ? j : body_end + (j - head);
    f(i, valid ? to_f(src[i]) : 0.f, valid && src2 ? to_f(src2[i]) : 0.f,
      valid);
  }
}

// the share's indices [0, n), warp-uniformly: f(i, valid)
template <class F>
__device__ __forceinline__ void for_share(int n, F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b = warp * 32; b < n; b += kThreads) f(b + lane, b + lane < n);
}

template <typename T, bool ROW_IN_SMEM>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
fused_sample_kernel(const T* __restrict__ logits, const T* __restrict__ gumbel,
                    const float* __restrict__ temps, int* __restrict__ out,
                    int* __restrict__ paths, int V, int share, int top_k,
                    float top_p, int mass_bits) {
  extern __shared__ float4 smem4[];
  Shared* sh = reinterpret_cast<Shared*>(smem4);
  float* row = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) +
                                        kFixedSmem);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int s = blockIdx.x / kCluster;
  const int tid = threadIdx.x, lane = tid & 31;
  const int lo = min(V, rank * share);
  const int n = min(V, lo + share) - lo;
  const int64_t off = (int64_t)s * V + lo;  // this CTA's first element
  const float t = fmaxf(temps[s], 1e-6f);
  const bool kon = top_k > 0 && top_k < V;
  const bool pon = top_p < 1.f;
  Shared* r0 = cluster.map_shared_rank(sh, 0);

  auto get = [&](int i) -> float {
    if constexpr (ROW_IN_SMEM)
      return row[i];
    else
      return scaled(to_f(logits[off + i]), t);
  };
  // each rank's draw to rank 0, then rank 0 merges them in rank order;
  // every rank's last access to another's shared memory precedes this
  auto finish = [&](float bv, int bi, int path) {
    block_argmax(sh, bv, bi);
    if (tid == 0) {
      r0->slot_v[rank] = bv;
      r0->slot_i[rank] = bi;
    }
    cluster.sync();
    if (rank == 0 && tid == 0) {
      float v = sh->slot_v[0];
      int i = sh->slot_i[0];
#pragma unroll
      for (int r = 1; r < kCluster; ++r)
        if (better(sh->slot_v[r], sh->slot_i[r], v, i)) {
          v = sh->slot_v[r];
          i = sh->slot_i[r];
        }
      out[s] = i == INT_MAX ? 0 : i;
      if (paths) paths[s] = path;
    }
  };
  // a cut keeps nothing: token 0, the argmax of an all-NEG_INF row
  auto nothing_kept = [&]() {
    cluster.sync();
    if (rank == 0 && tid == 0) {
      out[s] = 0;
      if (paths) paths[s] = kPathRadix;
    }
  };

  if (!kon && !pon) {
    // no cut: the draw is one pass over the logits and the noise, both by
    // 16-byte loads where the two rows share their alignment
    const T* g = gumbel + off;
    const bool gvec = (((uintptr_t)g ^ (uintptr_t)(logits + off)) & 15) == 0;
    float bv = -INFINITY;
    int bi = INT_MAX;
    for_loaded(logits + off, gvec ? g : nullptr, n,
               [&](int i, float x, float y, bool valid) {
                 if (!valid) return;
                 const float v = scaled(x, t) + (gvec ? y : to_f(g[i]));
                 if (better(v, lo + i, bv, bi)) {
                   bv = v;
                   bi = lo + i;
                 }
               });
    finish(bv, bi, kPathDraw);
    return;
  }

  for (int i = tid; i < 2 * kBins; i += kThreads) (&sh->cnt[0][0])[i] = 0;
  if (tid == 0) sh->ncand = 0;
  __syncthreads();

  // pass 1: scale and stage the share, its max and real count, and (top-k)
  // the counts of the keys' first digit
  float mx = -INFINITY;
  uint32_t nreal = 0;
  for_loaded(logits + off, (const T*)nullptr, n,
             [&](int i, float x, float, bool valid) {
    const float l = scaled(x, t);
    int d = -1;
    if (valid) {
      if constexpr (ROW_IN_SMEM) row[i] = l;
      mx = fmaxf(mx, l);
      if (l > kRealFloor) {
        ++nreal;
        d = (int)(key_of(l) >> 24);
      }
    }
    if (kon) hist_count(sh->cnt[0], d);
  });
  mx = block_max(sh, mx);
  const uint32_t nr = (uint32_t)block_sum(sh, nreal);
  if (tid == 0) {
    sh->mx = mx;
    sh->nreal = nr;
  }
  cluster.sync();
  if (tid < 32) {
    float m = -INFINITY;
    uint32_t c = 0;
    if (lane < kCluster) {
      const Shared* o = cluster.map_shared_rank(sh, lane);
      m = o->mx;
      c = o->nreal;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(kFullMask, m, o));
      c += __shfl_xor_sync(kFullMask, c, o);
    }
    if (lane == 0) {
      sh->gmx = m;
      sh->gnreal = c;
    }
  }
  __syncthreads();
  const float gmx = sh->gmx;
  const uint32_t gnreal = sh->gnreal;
  if (gnreal == 0) {
    nothing_kept();
    return;
  }

  int round = 0;  // cluster rounds so far: histogram buffer round & 1
  auto start_round = [&](bool zero) {
    const int buf = round & 1;
    if (zero) {
      for (int i = tid; i < kBins; i += kThreads) {
        sh->cnt[buf][i] = 0;
        sh->mlo[buf][i] = 0;
        sh->mhi[buf][i] = 0;
      }
      __syncthreads();
    }
    return buf;
  };

  // top-k: the k-th largest real key, 8 bits a round. Once the real
  // entries at or above the round's bucket number at most kEarly (at the
  // last round kSmall: the kept set itself), they go to rank 0, which
  // finishes both cuts on them alone (the small kept set).
  float ck = -INFINITY;
  int gather_shift = -1;  // the small set: keys whose bits >= it reach prefix
  if (kon) {
    uint32_t krem = min((uint32_t)top_k, gnreal), prefix = 0, gt = 0;
    for (int r = 0; r < 4; ++r) {
      const int shift = 24 - 8 * r;
      int buf = 0;
      if (r > 0) {
        buf = start_round(true);
        for_share(n, [&](int i, bool valid) {
          int d = -1;
          if (valid) {
            const float l = get(i);
            const uint32_t k = key_of(l);
            if (l > kRealFloor && (k >> (shift + 8)) == (prefix >> (shift + 8)))
              d = (int)((k >> shift) & 255u);
          }
          hist_count(sh->cnt[buf], d);
        });
        __syncthreads();
        cluster.sync();
      }
      merge_bins(cluster, sh, buf, false);
      if (tid < 32) select_count(sh, krem);
      __syncthreads();
      const int d = sh->digit;
      krem -= (uint32_t)sh->above;
      gt += (uint32_t)sh->above;
      const uint32_t at_or_above = gt + sh->eq;
      prefix |= (uint32_t)d << shift;
      ++round;
      if (at_or_above <= (uint32_t)(r < 3 ? kEarly : kSmall)) {
        gather_shift = shift;
        break;
      }
    }
    ck = value_of(prefix);  // the cut once all 4 rounds ran
    if (gather_shift >= 0) {
      // every real entry whose key's bits from gather_shift up reach the
      // prefix, to rank 0's shared memory
      const uint32_t reach = prefix >> gather_shift;
      for_share(n, [&](int i, bool valid) {
        const float l = valid ? get(i) : 0.f;
        const bool take = valid && l > kRealFloor &&
                          (key_of(l) >> gather_shift) >= reach;
        const unsigned b = __ballot_sync(kFullMask, take);
        if (b) {
          const int leader = __ffs(b) - 1;
          uint32_t base = 0;
          if (lane == leader)
            base = atomicAdd(&r0->ncand, (uint32_t)__popc(b));
          base = __shfl_sync(kFullMask, base, leader);
          if (take) {
            const uint32_t pos = base + __popc(b & ((1u << lane) - 1u));
            r0->cand_l[pos] = l;
            r0->cand_i[pos] = lo + i;
          }
        }
      });
      cluster.sync();
      if (rank != 0) return;
      // rank 0: a candidate is kept by top-k iff fewer than k candidates
      // are larger (every larger entry of the row is a candidate), and by
      // top-p iff the weight of the larger ones is under ceil(Z * p)
      const int nc = (int)sh->ncand;
      const bool mine = tid < nc;
      const float l = mine ? sh->cand_l[tid] : 0.f;
      const float scale = __int_as_float((127 + mass_bits) << 23);
      const u64 e = mine && pon ? mass_of(l, gmx, scale) : 0ull;
      if (mine) sh->cand_e[tid] = e;
      __syncthreads();
      uint32_t cgt = 0;
      u64 mgt = 0;
      if (mine)
        for (int j = 0; j < nc; ++j)
          if (sh->cand_l[j] > l) {
            ++cgt;
            mgt += sh->cand_e[j];
          }
      const bool keep_k = mine && cgt < (uint32_t)top_k;
      bool keep = keep_k;
      if (pon) {
        const u64 z = block_sum(sh, keep_k ? e : 0ull);
        const double zp = fmax(__dmul_rn(__ull2double_rn(z), (double)top_p),
                               0.0);
        keep = keep_k && mgt < __double2ull_ru(zp);
      }
      float bv = -INFINITY;
      int bi = INT_MAX;
      if (keep) {
        bi = sh->cand_i[tid];
        bv = l + to_f(gumbel[(int64_t)s * V + bi]);
      }
      block_argmax(sh, bv, bi);
      if (tid == 0) {
        out[s] = bi == INT_MAX ? 0 : bi;
        if (paths) paths[s] = kPathSmall;
      }
      return;
    }
  }

  // top-p over the cluster: the smallest kept value, 8 bits a round
  float cp = -INFINITY;
  if (pon) {
    const float scale = __int_as_float((127 + mass_bits) << 23);
    u64 A = 0;
    uint32_t prefix = 0;
    for (int r = 0; r < 4; ++r) {
      const int shift = 24 - 8 * r;
      const int buf = start_round(true);
      for_share(n, [&](int i, bool valid) {
        int d = -1;
        u64 m = 0;
        if (valid) {
          const float l = get(i);
          const uint32_t k = key_of(l);
          if (l >= ck && l > kRealFloor &&
              (r == 0 || (k >> (shift + 8)) == (prefix >> (shift + 8)))) {
            d = (int)((k >> shift) & 255u);
            m = mass_of(l, gmx, scale);
          }
        }
        hist_mass(sh->cnt[buf], sh->mlo[buf], sh->mhi[buf], d, m);
      });
      __syncthreads();
      cluster.sync();
      merge_bins(cluster, sh, buf, true);
      if (tid < 32) select_mass(sh, A, top_p, r == 0);
      __syncthreads();
      const int d = sh->digit;
      ++round;
      if (d < 0) {  // p <= 0: nothing is kept (uniform over the cluster)
        nothing_kept();
        return;
      }
      A = sh->above;  // the mass above the new bucket, A included
      prefix |= (uint32_t)d << shift;
    }
    cp = value_of(prefix);
  }

  // the draw over the kept entries, reading their noise alone
  const float cut = pon ? cp : ck;
  const T* g = gumbel + off;
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int i = tid; i < n; i += kThreads) {
    const float l = get(i);
    if (l >= cut) {
      const float v = l + to_f(g[i]);
      if (better(v, lo + i, bv, bi)) {
        bv = v;
        bi = lo + i;
      }
    }
  }
  finish(bv, bi, kPathRadix);
}

template <typename T>
cudaError_t launch(const void* logits, const void* gumbel, const float* temps,
                   int* out, int* paths, int S, int V, int top_k, float top_p,
                   int mass_bits, cudaStream_t stream) {
  const int share = (V + kCluster - 1) / kCluster;
  const bool in_smem = share <= kMaxShare;
  const int smem = kFixedSmem + (in_smem ? share * 4 : 0);
  auto kernel = in_smem ? fused_sample_kernel<T, true>
                        : fused_sample_kernel<T, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)S * kCluster, kThreads, smem, stream>>>(
      (const T*)logits, (const T*)gumbel, temps, out, paths, V, share, top_k,
      top_p, mass_bits);
  return cudaGetLastError();
}

}  // namespace
}  // namespace bigdl

// logits, gumbel: (S, V) of one dtype (0 float32, 1 bfloat16); temps: (S,)
// float32; out: (S,) int32; paths: null, or (S,) int32 that receives each
// row's path (0 no cut, 1 the small kept set, 2 the cluster's top-p
// rounds). top_k <= 0 or >= V disables top-k; top_p >= 1 disables top-p.
// mass_bits: the fixed-point weight's fraction bits, at most 40 and with
// V * 2^mass_bits < 2^63 (ops/sampling.py sample_plan). A row of up to
// 8 x 53,504 logits lives in the cluster's shared memory; a longer one is
// re-read from global memory on each pass. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int bigdl_fused_sample(const void* logits, const void* gumbel,
                                  const float* temps, int* out, int* paths,
                                  int S, int V, int top_k, float top_p,
                                  int mass_bits, int dtype, void* stream) {
  using namespace bigdl;
  if (V <= 0 || mass_bits < 0 || mass_bits > 40 ||
      (long long)S * kCluster > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (S <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return (int)launch<float>(logits, gumbel, temps, out, paths, S, V, top_k,
                              top_p, mass_bits, s);
  if (dtype == kBF16)
    return (int)launch<__nv_bfloat16>(logits, gumbel, temps, out, paths, S,
                                      V, top_k, top_p, mass_bits, s);
  return (int)cudaErrorInvalidValue;
}
