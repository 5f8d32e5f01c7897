// bf16_gemm_nt: C += A @ BT^T with bf16 operands and fp32 accumulation, in
// place: rung 15, the bf16 summit.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_tuned.py, _kernel_bf16_bt
// (via mmult_bf16_bt; C aliased into the output). A (M, K) bf16 and BT
// (N, K) bf16, both row-major (B packed transposed offline,
// prepare_bf16_bt), C (M, N) fp32 read and written in place. The
// accumulator starts at 0 and C is added at the flush, as the reference's
// _flush does.
//
// Bound on an H100 SXM at M = N = K = 4096: 1.37e11 operations (0.139 ms
// at the 989 TFLOP/s dense bf16 peak) against 201 MB of traffic (A and BT
// 33.6 MB each, C read and written 134 MB; 0.060 ms at 3.35 TB/s): the
// tensor cores bound it.
//
// Design (bf16_gemm.cuh): the int8 kernels' 128x128 tile, 8 warps of
// 64x32, two cp.async stages of 64 bytes of K (32 bf16 values) for both
// operands, mma.m16n8k16.bf16 on mma_stage's fragment walk. BT is
// K-major like A, so both are staged and read the same way, with no
// transpose. Simple first version: mma.sync rather than wgmma/TMA, no
// warp specialisation, a block barrier per K stage.
#include "bf16_gemm.cuh"

// a (M, lda) and bt (N, ldb) bf16 with K a multiple of 8 and K <= lda,
// ldb; c, out (M, ldc) fp32, which may be one buffer. Returns
// cudaGetLastError() after the launch.
extern "C" int bf16_gemm_nt(const void* a, const void* bt, const void* c,
                            void* out, int M, int N, int K, int lda,
                            int ldb, int ldc, void* stream) {
  return htog::launch_bf16_gemm<htog::BKMajor, false>(
      a, bt, c, out, M, N, K, lda, ldb, ldc, stream);
}
