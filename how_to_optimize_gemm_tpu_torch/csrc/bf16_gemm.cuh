// bf16 tensor-core products with fp32 accumulation on the int8 kernels'
// tiling (int8_mma.cuh): the bf16 product (MmaBf16) and the walk over a
// thread's fp32 accumulators, which rung 07's W4A16 kernel (w4a16_gemm.cuh)
// uses.
//
// A 64-byte K stage holds 32 bf16 values (BKE), and mma.m16n8k16.bf16
// reads its fragments at the byte offsets of the int8 m16n8k32, so a
// K-major bf16 operand goes through load_kmajor_async and mma_stage's
// fragment walk as it is.
#pragma once

#include <cuda_bf16.h>

#include "int8_mma.cuh"

namespace htog {

constexpr int BKE = BK / 2;     // bf16 K values per 64-byte stage

struct MmaBf16 {
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

__device__ __forceinline__ void zero_acc(float (&acc)[4][4][4]) {
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
}

// f(acc element, row, col) for each of this thread's accumulator
// elements inside M x N (rows g and g+8, columns 2t and 2t+1 of each
// m16n8 fragment of the warp's 64x32 sub-tile).
template <class F>
__device__ __forceinline__ void for_each_acc(float (&acc)[4][4][4], int M,
                                             int N, int m0, int n0, int wm,
                                             int wn, int lane, F f) {
  int g = lane >> 2;
  int t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int row = m0 + wm * 64 + mi * 16 + g + h * 8;
      if (row >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          int col = n0 + wn * 32 + ni * 8 + t * 2 + e;
          if (col >= N) continue;
          f(acc[mi][ni][h * 2 + e], row, col);
        }
      }
    }
  }
}

}  // namespace htog
