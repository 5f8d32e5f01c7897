// bf16_gemm_nn: out = C + A @ B with bf16 operands and fp32 accumulation,
// out of place: rung 05.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_tuned.py,
// _make_kernel(Precision.DEFAULT) (via mmult_bf16 / _mmult_impl). A (M, K)
// and B (K, N) bf16, both row-major, C (M, N) fp32 read, out (M, N) fp32
// written. The accumulator is seeded with C, as the reference's _init
// does (acc = C; acc += A.B).
//
// Bound on an H100 SXM at M = N = K = 4096: 1.37e11 operations (0.139 ms
// at the 989 TFLOP/s dense bf16 peak) against 201 MB of traffic (0.060 ms
// at 3.35 TB/s): the tensor cores bound it.
//
// Design (bf16_gemm.cuh): rung 15's kernel with B N-major. The B tile is
// staged by cp.async as it lies in memory (32 K rows x 128 columns, rows
// padded by 16 bytes) and its "col" fragments are read with
// ldmatrix.x4.trans, which transposes 16-bit elements (it does not
// transpose 8-bit ones, so the int8 kernels transpose in registers).
#include "bf16_gemm.cuh"

// a (M, lda) bf16 with K a multiple of 8 and K <= lda; b (K, ldb) bf16
// with ldb a multiple of 8, >= N; c, out (M, ldc) fp32. Returns
// cudaGetLastError() after the launch.
extern "C" int bf16_gemm_nn(const void* a, const void* b, const void* c,
                            void* out, int M, int N, int K, int lda,
                            int ldb, int ldc, void* stream) {
  return htog::launch_bf16_gemm<htog::BNMajor, true>(
      a, b, c, out, M, N, K, lda, ldb, ldc, stream);
}
