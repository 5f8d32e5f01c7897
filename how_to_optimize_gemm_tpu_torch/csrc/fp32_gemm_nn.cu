// fp32_gemm_nn: out = C + A @ B in fp32 at full fp32 accuracy, out of
// place: rung 04.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_tuned.py,
// _make_kernel(Precision.HIGHEST) (via mmult / _mmult_impl). A (M, K) and
// B (K, N) fp32, both row-major, C (M, N) fp32 read, out (M, N) fp32
// written. The accumulator is seeded with C, as the reference's _init
// does (acc = C; acc += A.B).
//
// Bound on an H100 SXM at M = N = K = 4096: 1.37e11 operations; the
// fastest route that meets the rung's gate (1e-4) is 3xTF32 at 495/3
// TFLOP/s, 0.833 ms; FFMA's ceiling is 67 TFLOP/s, 2.05 ms. Traffic (268
// MB, 0.080 ms at 3.35 TB/s) does not bound it.
//
// Design: fp32_gemm.cuh's kernel with B N-major, staged as it lies by
// 16-byte cp.async (only A is transposed into shared memory).
#include "fp32_gemm.cuh"

// a (M, lda) fp32 with K <= lda; b (K, ldb) fp32 with ldb a multiple of
// 4, >= N; c, out (M, ldc) fp32; bases 16-byte aligned. Returns
// cudaGetLastError() after the launch.
extern "C" int fp32_gemm_nn(const void* a, const void* b, const void* c,
                            void* out, int M, int N, int K, int lda,
                            int ldb, int ldc, void* stream) {
  return htog::launch_fp32_gemm<false, true>(a, b, c, out, M, N, K, lda,
                                             ldb, ldc, stream);
}
