// Shared helpers for the port's CUDA kernels (ops/csrc/*.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bigdl {

// the reference's NEG_INF (bigdl_tpu/ops/pallas_util.py): a finite -inf,
// so exp(x - m) never meets inf - inf
constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

// element types the kernels take: 0 = float32, 1 = bfloat16
enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

}  // namespace bigdl
