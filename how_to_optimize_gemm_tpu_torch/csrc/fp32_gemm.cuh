// fp32 GEMMs on the CUDA cores (FFMA) at full fp32 accuracy: the main loop
// of the grouped GEMM's fp32-stack instances (grouped_gemm.cu kind 3, B
// N-major; grouped_gemm_t.cu kind 3, B given as BT), and nothing else. The
// ladder's fp32 rungs 04 and 16 run three bf16 products of split operands
// on gemm_wgmma.cuh instead (fp32_gemm_nn.cu, fp32_gemm_nt.cu).
//
// The reference computes these at Precision.HIGHEST (a 6-pass bf16
// product on the TPU's MXU, about fp32 accurate; gate_rel 1e-4). On
// Hopper plain TF32 (10-bit mantissa) does not meet that gate; FFMA does,
// as do three bf16 products of split operands on the tensor cores.
//
// Design: the register-blocked SGEMM of the reference tutorial
// (MMult_cuda_12): one 128x128 output tile per block of 256 threads, each
// thread 8x8 outputs (rows ty*4 .. +3 and 64 + ty*4 .. +3, columns the
// same from tx*4, so its shared reads are float4s that neighbouring
// threads share or read side by side), K walked in steps of 16 staged in
// shared memory as [k][m] and [k][n] by cp.async, two stages. A K-major
// operand (A (M, K), or B given as BT (N, K)) is transposed on its way in:
// 4-byte copies, a warp's 32 lanes on 32 consecutive rows; an N-major B
// (K, N) is copied as it lies, 16 bytes a lane. Each output is one fmaf
// chain over k.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_mma.cuh"

namespace htog {

constexpr int FBM = 128;
constexpr int FBN = 128;
constexpr int FBK = 16;

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int src_bytes = valid ? 4 : 0;  // 0: no read, a zero written
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

// A K-major operand (rows x K row-major, pitch ld floats) into a [16][128]
// stage, transposed: 512 chunks of 4 K values of one row, a warp's lanes
// on consecutive rows. Rows >= rows and K >= K are zero-filled.
__device__ __forceinline__ void load_fp32_kmajor(float (*dst)[FBM],
                                                 const float* src, int row0,
                                                 int rows, int k0, int K,
                                                 int ld) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int chunk = threadIdx.x + i * THREADS;
    int r = chunk & (FBM - 1);
    int kc = (chunk >> 7) * 4;
    int gr = row0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int gk = k0 + kc + j;
      bool valid = gr < rows && gk < K;
      const float* p = valid ? src + (size_t)gr * ld + gk : src;
      cp_async4(&dst[kc + j][r], p, valid);
    }
  }
}

// An N-major operand (K x N row-major, pitch ld floats, a multiple of 4,
// >= N) into a [16][128] stage as it lies: 512 chunks of 4 columns; a
// chunk that starts below N ends inside the row pitch.
__device__ __forceinline__ void load_fp32_nmajor(float (*dst)[FBN],
                                                 const float* src, int n0,
                                                 int N, int k0, int K,
                                                 int ld) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int chunk = threadIdx.x + i * THREADS;
    int r = chunk >> 5;
    int c = (chunk & 31) * 4;
    int gk = k0 + r;
    int gn = n0 + c;
    bool valid = gk < K && gn < N;
    const float* p = valid ? src + (size_t)gk * ld + gn : src;
    cp_async16(&dst[r][c], p, valid);
  }
}

// One stage: A's 128 rows x 16 K and B's 16 K x 128 columns, one
// cp.async group. A is (M, K) K-major.
template <bool kBT>
__device__ __forceinline__ void load_fp32_stage(
    float (*sa)[FBM], float (*sb)[FBN], const float* a, const float* b,
    int m0, int n0, int M, int N, int k0, int K, int lda, int ldb) {
  load_fp32_kmajor(sa, a, m0, M, k0, K, lda);
  if constexpr (kBT) {
    load_fp32_kmajor(sb, b, n0, N, k0, K, ldb);
  } else {
    load_fp32_nmajor(sb, b, n0, N, k0, K, ldb);
  }
  cp_async_commit();
}

// Row (or column) of this thread's output i (0..7) within the tile.
__device__ __forceinline__ int ftile(int t, int i) {
  return (i >> 2) * 64 + t * 4 + (i & 3);
}

// acc[i][j] += sum over k of A[row i][k] * B[k][col j] for this thread's
// 8x8 outputs of the 128x128 tile at (m0, n0), one fmaf chain per output
// in k order. A (M, lda) fp32; B as BT (N, ldb) when kBT, else (K, ldb).
// The grouped GEMM's fp32-stack instances (grouped_gemm.cu,
// grouped_gemm_t.cu) run it on one expert's stack.
template <bool kBT>
__device__ __forceinline__ void fp32_gemm_mainloop(
    float (&acc)[8][8], const float* a, const float* b, int M, int N, int K,
    int lda, int ldb, int m0, int n0) {
  __shared__ __align__(16) float sa[2][FBK][FBM];
  __shared__ __align__(16) float sb[2][FBK][FBN];
  int tx = threadIdx.x & 15;
  int ty = threadIdx.x >> 4;
  int nk = (K + FBK - 1) / FBK;
  load_fp32_stage<kBT>(sa[0], sb[0], a, b, m0, n0, M, N, 0, K, lda, ldb);
  cp_async_wait_all();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    int s = kt & 1;
    if (kt + 1 < nk) {
      load_fp32_stage<kBT>(sa[s ^ 1], sb[s ^ 1], a, b, m0, n0, M, N,
                           (kt + 1) * FBK, K, lda, ldb);
    }
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      float4 a0 = *reinterpret_cast<const float4*>(&sa[s][k][ty * 4]);
      float4 a1 = *reinterpret_cast<const float4*>(&sa[s][k][64 + ty * 4]);
      float4 b0 = *reinterpret_cast<const float4*>(&sb[s][k][tx * 4]);
      float4 b1 = *reinterpret_cast<const float4*>(&sb[s][k][64 + tx * 4]);
      float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    cp_async_wait_all();
    __syncthreads();
  }
}

}  // namespace htog
