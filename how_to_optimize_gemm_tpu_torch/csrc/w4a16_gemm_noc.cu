// w4a16_gemm_noc: out = (A @ decode(P)) * sw[j] with bf16 A, int4 weights
// decoded to bf16 and fp32 accumulation, no C: the W4A16 serving linear at
// prefill widths (m > 64).
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_int4.py, _kernel_noc with
// _decode_w4 (via mmult_q_noc; models/linear.apply_linear for int4
// weights at m > 64). A (M, K) bf16 row-major, P (Kp/2, N) int8 packed
// nibbles (w4a8.cuh), sw (1, N) float32, out (M, N) float32 written,
// never read. A has K <= Kp columns; weight rows >= K are not read.
//
// Bound on an H100 SXM, at the Llama-2-7B prefill shape M = 1024, K = 4096,
// N = 11008: 9.2e10 operations (93 us at the 989 TFLOP/s dense bf16 peak)
// against 76 MB of traffic (A 8.4 MB, packed weights 22.5 MB, out 45 MB;
// 23 us at 3.35 TB/s): the tensor cores bound it.
//
// Design: w4a16_gemm.cuh's kernel without "+ C" (kAddC = false), as
// int8_gemm_noc is K1's template without it.
#include "w4a16_gemm.cuh"

// A (M, lda) bf16 with K a multiple of 8 and K <= lda (16-byte rows, the
// wrapper pads), K <= Kp; ldb (the packed pitch) a multiple of 16, >= N;
// bases 16-byte aligned. Returns cudaGetLastError() after the launch.
extern "C" int w4a16_gemm_noc(const void* a, const void* packed,
                              const void* sw, void* out, int M, int N, int K,
                              int lda, int ldb, int ldc, void* stream) {
  return htog::launch_w4a16_gemm<false>(a, packed, sw, nullptr, out, M, N, K,
                                        lda, ldb, ldc, stream);
}
