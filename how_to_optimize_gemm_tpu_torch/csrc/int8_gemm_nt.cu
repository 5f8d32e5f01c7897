// K2 int8_gemm_nt: C = f32(QA @ QBT^T as int32) * sa[i] * sb[j] + C, in
// place on C.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_int8.py, _kernel_bt and
// its single-K-step form _kernel_bt_1k (via mmult_q_bt, rung
// 14_packed_alias_int8). QA (M, K) int8, QBT (N, K) int8 (B packed
// transposed offline), sa (M, 1) and sb (1, N) float32, C (M, N) float32
// read and overwritten (the reference aliases C into its output).
//
// Bound on an H100 SXM: the same as K1, 1.37e11 int operations (69 us at
// 1,979 TOP/s) against 168 MB of traffic (50 us at 3.35 TB/s) at
// M = N = K = 4096: the tensor cores bound it.
//
// Design: both operands are already K-major, so both stream straight
// into shared memory through cp.async (16 bytes per thread, zero-filled
// past the ragged edges) and feed the int8 mma.sync fragments with one
// 32-bit load each. The K loop runs inside the block, so the TPU's
// grid_k == 1 variant needs no separate kernel. Simple first version:
// two stages, no wgmma/TMA, no warp specialisation.
#include "int8_mma.cuh"

namespace {

__global__ void __launch_bounds__(htog::THREADS)
    int8_gemm_nt_kernel(const int8_t* qa, const int8_t* qbt, const float* sa,
                        const float* sb, const float* c, float* out, int M,
                        int N, int K, int lda, int ldb, int ldc) {
  using namespace htog;
  __shared__ __align__(16) Smem sm;
  gemm_nt_tile(sm, qa, qbt, sa, sb, c, out, M, N, K, lda, ldb, ldc,
               blockIdx.y * BM, blockIdx.x * BN);
}

}  // namespace

// K, lda and ldb are multiples of 16 and the int8 bases 16-byte aligned
// (the wrapper pads). c and out are the same buffer.
extern "C" int int8_gemm_nt(const void* qa, const void* qbt, const void* sa,
                            const void* sb, const void* c, void* out, int M,
                            int N, int K, int lda, int ldb, int ldc,
                            void* stream) {
  dim3 grid((N + htog::BN - 1) / htog::BN, (M + htog::BM - 1) / htog::BM);
  int8_gemm_nt_kernel<<<grid, htog::THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qa), static_cast<const int8_t*>(qbt),
      static_cast<const float*>(sa), static_cast<const float*>(sb),
      static_cast<const float*>(c), static_cast<float*>(out), M, N, K, lda,
      ldb, ldc);
  return static_cast<int>(cudaGetLastError());
}
