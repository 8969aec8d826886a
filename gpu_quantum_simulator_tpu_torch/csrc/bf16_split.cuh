// Rounding fp32 operands to bf16 for the wgmma kernels: the mat step
// (wgmma_high.cuh) and the Karatsuba k-chunk body (karatsuba_high.cuh).
// A pair (x0, x1) becomes one bf16x2 register, x0 in the low 16 bits.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace bfround {

// (x0, x1) -> bf16x2 hi and bf16x2 lo, x - hi rounded ("high")
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// (x0, x1) -> bf16x2 hi alone: split2's hi ("default")
__device__ __forceinline__ uint32_t hi2(float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&h);
}

}  // namespace bfround
