// Shared pieces of the kernels that split an fp32 operand for the bf16
// tensor cores (the flash backward kernels, the training forward's
// flash_wgmma.cuh, split_bf16.cu): split_pack, and the flash kernels' bf16
// pair packing and mask value.
//
// Operands that the reference keeps in fp32 are split for the bf16 tensor
// cores into hi = bf16(x) and lo = bf16(x - hi): hi + lo carries 16 of x's 24
// mantissa bits (|x - hi - lo| <= 2^-17 |x|), and a product takes two MMAs.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace htog {
namespace fa {

using bf16 = __nv_bfloat16;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The pair (x0, x1) as bf16 pairs hi = bf16(x) and lo = bf16(x - hi).
__device__ __forceinline__ void split_pack(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l =
      __floats2bfloat162_rn(__fsub_rn(x0, hf.x), __fsub_rn(x1, hf.y));
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

}  // namespace fa
}  // namespace htog
