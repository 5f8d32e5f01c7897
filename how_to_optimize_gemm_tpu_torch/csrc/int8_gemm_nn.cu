// K1 int8_gemm_nn: C' = f32(QA @ QB as int32) * sa[i] * sb[j] + C, into a
// fresh output.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_int8.py, _kernel (via
// mmult_q, rung 06_pallas_int8). QA (M, K) int8 row-major, QB (K, N)
// int8 row-major (N-major), sa (M, 1) and sb (1, N) float32, C (M, N)
// float32.
//
// Bound on an H100 SXM: at M = N = K = 4096 the product is 1.37e11 int
// operations (69 us at the 1,979 TOP/s dense int8 peak) against 168 MB
// of traffic (A and B 16.8 MB each, C read and the output written 67 MB
// each; 50 us at 3.35 TB/s), so the tensor cores, not memory, bound it.
//
// Design: the int8 MMA takes B as K-major fragments and ldmatrix.trans
// cannot transpose 8-bit elements, so B is transposed on its way into
// shared memory: each thread loads 4 K rows x 4 N bytes, transposes the
// 4x4 bytes with __byte_perm and stores four K-major words. A streams
// through cp.async. 128x128 tiles amortise each staged byte over 128
// MMA columns. This is the simple first version: mma.sync rather than
// wgmma/TMA, two stages, no warp specialisation, so it cannot reach the
// wgmma peak; the C read and output write run after the K loop.
#include "int8_mma.cuh"

namespace {

using htog::RowMajorInt8;

__global__ void __launch_bounds__(htog::THREADS)
    int8_gemm_nn_kernel(const int8_t* qa, RowMajorInt8 qb, const float* sa,
                        const float* sb, const float* c, float* out, int M,
                        int N, int K, int lda, int ldc) {
  __shared__ __align__(16) htog::Smem sm;
  htog::gemm_nmajor_body(sm, qa, qb, sa, sb, c, out, M, N, K, lda, ldc);
}

}  // namespace

// K and lda, ldb are multiples of 16 and the int8 bases 16-byte aligned
// (the wrapper pads). Returns cudaGetLastError() after the launch.
extern "C" int int8_gemm_nn(const void* qa, const void* qb, const void* sa,
                            const void* sb, const void* c, void* out, int M,
                            int N, int K, int lda, int ldb, int ldc,
                            void* stream) {
  dim3 grid((N + htog::BN - 1) / htog::BN, (M + htog::BM - 1) / htog::BM);
  RowMajorInt8 b{static_cast<const int8_t*>(qb), K, ldb};
  int8_gemm_nn_kernel<<<grid, htog::THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qa), b, static_cast<const float*>(sa),
      static_cast<const float*>(sb), static_cast<const float*>(c),
      static_cast<float*>(out), M, N, K, lda, ldc);
  return static_cast<int>(cudaGetLastError());
}
