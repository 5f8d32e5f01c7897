// The packed int4 weight layout shared by the W4A8 kernels (w4a8_gemm.cu,
// w4a8_gemm_noc.cu, w4a8_gemv_fq.cu).
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

// The N-major B operand of gemm_nmajor_body (int8_mma.cuh) for packed
// weights: row(k) addresses K row k, decode(w, k) turns the loaded word
// into four int8 weights. A 64-deep K tile never straddles a half block,
// so one tile is all low or all high nibbles.
struct PackedW4 {
  const int8_t* base;
  int K;   // K rows of the logical weight that are read (<= Kp)
  int ld;  // row pitch in bytes (a multiple of 16, >= N)
  __device__ const int8_t* row(int k) const {
    int prow = (k >> 9) * 256 + ((k & 511) & 255);
    return base + (size_t)prow * ld;
  }
  __device__ uint32_t decode(uint32_t w, int k) const {
    return (k & 511) < 256 ? decode_lo4(w) : decode_hi4(w);
  }
};

}  // namespace htog
