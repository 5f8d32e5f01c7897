// w4a16_gemm: C = (A @ decode(P)) * sw[j] + C with bf16 A, int4 weights
// decoded to bf16 and fp32 accumulation, in place: rung 07, W4A16.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_int4.py, _kernel with
// _decode_w4 (via mmult_q; C aliased into the output). A (M, K) bf16
// row-major, P (Kp/2, N) int8 packed nibbles in 512-row pack blocks
// (w4a8.cuh), sw (1, N) float32, C (M, N) float32 read and written in
// place. The accumulator starts at 0; the flush is acc * sw + C, the
// reference's order.
//
// Bound on an H100 SXM at M = N = K = 4096: 1.37e11 operations (0.139 ms
// at the 989 TFLOP/s dense bf16 peak) against 176 MB of traffic (A 33.6
// MB, packed weights 8.4 MB, C read and written 134 MB; 0.053 ms at
// 3.35 TB/s): the tensor cores bound it.
//
// Design: w4a16_gemm.cuh's mma.sync kernel (128 x 128 tiles, the weights
// decoded through float and staged in shared memory). The serving linear
// without C, w4a16_gemm_noc.cu, runs w4a16_wgmma.cuh instead.
#include "w4a16_gemm.cuh"

// A (M, lda) bf16 with K a multiple of 8 and K <= lda (16-byte rows, the
// wrapper pads), K <= Kp; ldb (the packed pitch) a multiple of 16, >= N;
// c and out (M, ldc) float32, which may be one buffer; bases 16-byte
// aligned. Returns cudaGetLastError() after the launch.
extern "C" int w4a16_gemm(const void* a, const void* packed, const void* sw,
                          const void* c, void* out, int M, int N, int K,
                          int lda, int ldb, int ldc, void* stream) {
  return htog::launch_w4a16_gemm(a, packed, sw, c, out, M, N, K, lda, ldb,
                                 ldc, stream);
}
