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
// fastest route that meets the rung's gate (1e-4) and FP32_REL is three
// bf16 products of split operands at a third of the 989 TFLOP/s bf16 peak
// (rung 16's, fp32_gemm_nt.cu), 0.417 ms; FFMA's ceiling is 67 TFLOP/s,
// 2.05 ms. Traffic (268 MB, 0.080 ms at 3.35 TB/s) does not bound it.
//
// Design: fp32_gemm.cuh's main loop with B N-major, staged as it lies by
// 16-byte cp.async (only A is transposed into shared memory).
#include "fp32_gemm.cuh"

namespace htog {

// out = C + A.B, the accumulator seeded with C. A (M, lda) and B (K, ldb)
// fp32; c, out (M, ldc) fp32.
__global__ void __launch_bounds__(THREADS)
    fp32_gemm_kernel(const float* a, const float* b, const float* c,
                     float* out, int M, int N, int K, int lda, int ldb,
                     int ldc) {
  int m0 = blockIdx.y * FBM;
  int n0 = blockIdx.x * FBN;
  int tx = threadIdx.x & 15;
  int ty = threadIdx.x >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int row = m0 + ftile(ty, i);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int col = n0 + ftile(tx, j);
      acc[i][j] = row < M && col < N ? c[(size_t)row * ldc + col] : 0.0f;
    }
  }
  fp32_gemm_mainloop<false>(acc, a, b, M, N, K, lda, ldb, m0, n0);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int row = m0 + ftile(ty, i);
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int col = n0 + ftile(tx, j);
      if (col >= N) continue;
      out[(size_t)row * ldc + col] = acc[i][j];
    }
  }
}

// Launches fp32_gemm_kernel; returns cudaGetLastError().
int launch_fp32_gemm(const void* a, const void* b, const void* c, void* out,
                     int M, int N, int K, int lda, int ldb, int ldc,
                     void* stream) {
  dim3 grid((N + FBN - 1) / FBN, (M + FBM - 1) / FBM);
  fp32_gemm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<float*>(out), M, N, K, lda,
      ldb, ldc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace htog

// a (M, lda) fp32 with K <= lda; b (K, ldb) fp32 with ldb a multiple of
// 4, >= N; c, out (M, ldc) fp32; bases 16-byte aligned. Returns
// cudaGetLastError() after the launch.
extern "C" int fp32_gemm_nn(const void* a, const void* b, const void* c,
                            void* out, int M, int N, int K, int lda,
                            int ldb, int ldc, void* stream) {
  return htog::launch_fp32_gemm(a, b, c, out, M, N, K, lda, ldb, ldc,
                                stream);
}
