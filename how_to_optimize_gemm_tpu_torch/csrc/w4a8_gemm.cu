// K3 w4a8_gemm: C = f32(QA @ decode(P) as int32) * sa[i] * sw[j] + C, in
// place on C.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_int4.py, _kernel_w4a8
// and its _decode_w4 (via mmult_q_w4a8, rung 07b_pallas_w4a8). QA (M, K)
// int8, P (Kp/2, N) int8 packed nibbles in 512-row pack blocks
// (Kp = round_up(K, 512)), sa (M, 1) and sw (1, N) float32, C (M, N)
// float32 read and overwritten.
//
// Bound on an H100 SXM: at M = N = K = 4096, 1.37e11 int operations
// (69 us at the 1,979 TOP/s dense int8 peak) against 159 MB of traffic
// (A 16.8 MB, the packed weights 8.4 MB, C read and written 67 MB each;
// 48 us at 3.35 TB/s): the tensor cores bound it, as for K1.
//
// Design: Hopper has no int4 MMA, so the nibbles are decoded to s8 while
// the packed tile is staged into shared memory, then the K1 path runs
// unchanged (N-major -> K-major transpose, int8 mma.sync). The layout
// and its decode (two SIMD byte ops per word, __vsub4) are in w4a8.cuh.
// Each packed byte is fetched twice (once per half), the second time
// usually from L2.
#include "int8_mma.cuh"
#include "w4a8.cuh"

namespace {

using htog::PackedW4;

__global__ void __launch_bounds__(htog::THREADS)
    w4a8_gemm_kernel(const int8_t* qa, PackedW4 w, const float* sa,
                     const float* sw, const float* c, float* out, int M,
                     int N, int K, int lda, int ldc) {
  __shared__ __align__(16) htog::Smem sm;
  htog::gemm_nmajor_body<true>(sm, qa, w, sa, sw, c, out, M, N, K, lda,
                               ldc);
}

}  // namespace

// K and lda, ldb are multiples of 16, K <= Kp, the int8 bases 16-byte
// aligned (the wrapper pads). c and out are the same buffer.
extern "C" int w4a8_gemm(const void* qa, const void* packed, const void* sa,
                         const void* sw, const void* c, void* out, int M,
                         int N, int K, int lda, int ldb, int ldc,
                         void* stream) {
  dim3 grid((N + htog::BN - 1) / htog::BN, (M + htog::BM - 1) / htog::BM);
  PackedW4 w{static_cast<const int8_t*>(packed), K, ldb};
  w4a8_gemm_kernel<<<grid, htog::THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qa), w, static_cast<const float*>(sa),
      static_cast<const float*>(sw), static_cast<const float*>(c),
      static_cast<float*>(out), M, N, K, lda, ldc);
  return static_cast<int>(cudaGetLastError());
}
