// Paged attention over an int8 pool with float32 scale planes: the C entry
// of the kernel in paged_attention.cuh (which says what it computes and
// how). Replaces bigdl_tpu/ops/paged_attention.py `_decode_kernel_quant`.

#include "paged_attention.cuh"

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
