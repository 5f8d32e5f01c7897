// Kernel 2 w4a8_gemm_noc: out = f32(QA @ decode(P) as int32) * sa[i] *
// sw[j], no C: the W4A8 serving linear at prefill widths (m > 64).
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_int4.py,
// _kernel_w4a8_noc and its GEMV form _kernel_w4a8_noc_gemv (via
// mmult_q_w4a8_noc; models/linear.apply_linear at m > 64). The
// reference's GEMV-by-pack-algebra and its tiled form are two TPU
// schedules of one function; one kernel serves every m here. QA (M, K)
// int8, P (Kp/2, N) int8 packed nibbles (w4a8.cuh), sa (M, 1) and
// sw (1, N) float32, out (M, N) float32 written, never read.
//
// Bound on an H100 SXM, at the Llama-2-7B prefill shape M = 1024 (four
// slots of a 256-token bucket), K = 4096, N = 11008: 9.2e10 int
// operations (47 us at the 1,979 TOP/s dense int8 peak) against 72 MB of
// traffic (QA 4.2 MB, packed weights 22.5 MB, out 45 MB; 22 us at
// 3.35 TB/s): the tensor cores bound it.
//
// Design: K3 (w4a8_gemm.cu) with the epilogue's "+ C" left out, the same
// template instantiated with kAddC = false: nibbles decoded to s8 while
// the tile is staged, 128x128 tiles, int8 mma.sync, two stages. The
// epilogue (float(acc) * sa) * sw is written with __fmul_rn, so the result
// equals the plain version bit for bit.
#include "int8_mma.cuh"
#include "w4a8.cuh"

namespace {

using htog::PackedW4;

__global__ void __launch_bounds__(htog::THREADS)
    w4a8_gemm_noc_kernel(const int8_t* qa, PackedW4 w, const float* sa,
                         const float* sw, float* out, int M, int N, int K,
                         int lda, int ldc) {
  __shared__ __align__(16) htog::Smem sm;
  htog::gemm_nmajor_body<false>(sm, qa, w, sa, sw, nullptr, out, M, N, K,
                                lda, ldc);
}

}  // namespace

// K and lda, ldb are multiples of 16, K <= Kp, the int8 bases 16-byte
// aligned (the wrapper pads). c is not read (pass null).
extern "C" int w4a8_gemm_noc(const void* qa, const void* packed,
                             const void* sa, const void* sw, const void* c,
                             void* out, int M, int N, int K, int lda,
                             int ldb, int ldc, void* stream) {
  (void)c;
  dim3 grid((N + htog::BN - 1) / htog::BN, (M + htog::BM - 1) / htog::BM);
  PackedW4 w{static_cast<const int8_t*>(packed), K, ldb};
  w4a8_gemm_noc_kernel<<<grid, htog::THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qa), w, static_cast<const float*>(sa),
      static_cast<const float*>(sw), static_cast<float*>(out), M, N, K, lda,
      ldc);
  return static_cast<int>(cudaGetLastError());
}
