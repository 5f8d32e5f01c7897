// The packed int4 weight layout shared by the int4-weight kernels
// (w4a8_gemm.cu and w4a8_gemm_noc.cu through w4a8_wgmma.cuh; w4a8_gemv_fq.cu
// and the W4A16 kernels read the same layout and decode the nibbles their
// own way).
//
// P (Kp/2, N) int8, Kp a multiple of 512: K row k of the logical weight
// lives in packed row (k / 512) * 256 + (k % 512) % 256, in the low nibble
// in offset binary, (b & 0xF) - 8, when k % 512 < 256, else in the high
// nibble in two's complement, (int8)b >> 4 (ops/quant.py, pack_int4).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace htog {

// Four packed bytes (four N columns of one packed row) -> four int8
// weights, the low nibbles (offset binary) or the high nibbles.
__device__ __forceinline__ uint32_t decode_lo4(uint32_t w) {
  return __vsub4(w & 0x0F0F0F0Fu, 0x08080808u);
}

__device__ __forceinline__ uint32_t decode_hi4(uint32_t w) {
  uint32_t u = (w >> 4) & 0x0F0F0F0Fu;
  return __vsub4(u ^ 0x08080808u, 0x08080808u);
}

}  // namespace htog
