// Paged attention over a float32 or bfloat16 pool: the C entry of the
// kernel in paged_attention.cuh (which says what it computes and how).
// Replaces bigdl_tpu/ops/paged_attention.py `_decode_kernel`.

#include "paged_attention.cuh"

// q, out: (B, H, C, D); k, v: (N, H, PS, D), 16-byte aligned; table: (B,
// P) int32, entries >= N are the "no page" sentinel; start: (B,) int32,
// query c of row b sits at absolute position start[b] + c. dtype: 0
// float32, 1 bfloat16, for q, out and the pool. Supported (PS, D): pages of
// 8, 16 and 32 tokens (the sizes the reference serves with) at any D from 1
// to 256 (run on the built width 32, 64, 96, 128 or 256 at or above it).
// B*H and the query tiles ceil(C / 16) at most 65535 each.
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
