// int8_gemm_noc: out = f32(QA @ QB as int32) * sa[i] * sb[j], no C: the
// int8 serving linear at prefill widths (m >= 256).
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_int8.py, _kernel_noc (via
// mmult_q_noc; models/linear.apply_linear for int8 weights at m >= 256).
// QA (M, K) int8 row-major, QB (K, N) int8 row-major (N-major), sa (M, 1)
// and sb (1, N) float32, out (M, N) float32 written, never read. The
// reference's m <= 64 decode blocks (choose_blocks_q) are a VMEM rule and
// the route never sends m < 256 here, so one tiling serves every m.
//
// Bound on an H100 SXM, at the Llama-2-7B prefill shape M = 1024 (four
// slots of a 256-token bucket), K = 4096, N = 11008: 9.2e10 int
// operations (47 us at the 1,979 TOP/s dense int8 peak) against 94 MB of
// traffic (QA 4.2 MB, QB 45 MB, out 45 MB; 28 us at 3.35 TB/s): the
// tensor cores bound it.
//
// Design: K1 (int8_gemm_nn.cu) with the epilogue's "+ C" left out, the
// same template instantiated with kAddC = false: B transposed with
// __byte_perm while the tile is staged, 128x128 tiles, int8 mma.sync, two
// stages. Leaving out C saves reading M x N float32. The epilogue
// (float(acc) * sa) * sb is written with __fmul_rn, so the result equals
// the plain version bit for bit.
#include "int8_mma.cuh"

namespace {

using htog::RowMajorInt8;

__global__ void __launch_bounds__(htog::THREADS)
    int8_gemm_noc_kernel(const int8_t* qa, RowMajorInt8 qb, const float* sa,
                         const float* sb, float* out, int M, int N, int K,
                         int lda, int ldc) {
  __shared__ __align__(16) htog::Smem sm;
  htog::gemm_nmajor_body<false>(sm, qa, qb, sa, sb, nullptr, out, M, N, K,
                                lda, ldc);
}

}  // namespace

// K and lda, ldb are multiples of 16 and the int8 bases 16-byte aligned
// (the wrapper pads). Returns cudaGetLastError() after the launch.
extern "C" int int8_gemm_noc(const void* qa, const void* qb, const void* sa,
                             const void* sb, void* out, int M, int N, int K,
                             int lda, int ldb, int ldc, void* stream) {
  dim3 grid((N + htog::BN - 1) / htog::BN, (M + htog::BM - 1) / htog::BM);
  RowMajorInt8 b{static_cast<const int8_t*>(qb), K, ldb};
  int8_gemm_noc_kernel<<<grid, htog::THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qa), b, static_cast<const float*>(sa),
      static_cast<const float*>(sb), static_cast<float*>(out), M, N, K, lda,
      ldc);
  return static_cast<int>(cudaGetLastError());
}
