// fp32_gemm_nt: C += A @ BT^T in fp32 at full fp32 accuracy, in place:
// rung 16, the fp32 summit.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_tuned.py,
// _make_kernel_bt(Precision.HIGHEST) (via mmult_fp32_bt; C aliased into
// the output). A (M, K) and BT (N, K) fp32, both row-major (B packed
// transposed offline, prepare_fp32_bt), C (M, N) fp32 read and written in
// place. The accumulator starts at 0 and C is added at the flush.
//
// Bound on an H100 SXM at M = N = K = 4096: 1.37e11 operations. The
// fastest route that meets the rung's gate (1e-4 against fp64) is a
// 3xTF32 split on the tensor cores, 495/3 TFLOP/s: 0.833 ms; this kernel's
// own route, FFMA, tops out at 67 TFLOP/s: 2.05 ms. Traffic, 268 MB (A and
// BT 67 MB each, C read and written 134 MB), takes 0.080 ms at 3.35 TB/s:
// the arithmetic bounds it.
//
// Design: fp32_gemm.cuh, the register-blocked FFMA SGEMM (128x128 tile,
// 8x8 outputs a thread, K steps of 16 staged by cp.async, two stages),
// with both operands K-major and transposed into shared memory.
#include "fp32_gemm.cuh"

// a (M, lda) and bt (N, ldb) fp32 with K <= lda, ldb; c, out (M, ldc)
// fp32, which may be one buffer. Returns cudaGetLastError() after the
// launch.
extern "C" int fp32_gemm_nt(const void* a, const void* bt, const void* c,
                            void* out, int M, int N, int K, int lda,
                            int ldb, int ldc, void* stream) {
  return htog::launch_fp32_gemm<true, false>(a, bt, c, out, M, N, K, lda,
                                             ldb, ldc, stream);
}
