// Helpers shared by the flash-attention kernels (forward and backward):
// conversions between the input types and fp32, and the reference's
// masking constant.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash {

constexpr int kThreads = 256;       // 16 x 16: tx picks columns, ty rows
constexpr float kNegInf = -1e30f;   // the reference's NEG_INF, not -inf

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: the reference's `.astype(q.dtype)` before a
// matmul whose other operand is in T.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

}  // namespace flash
