// w4a16_gemm_noc: out = (A @ decode(P)) * sw[j] with bf16 A, int4 weights
// decoded to bf16 and fp32 accumulation, no C: the W4A16 serving linear at
// prefill widths (m > 64).
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_int4.py, _kernel_noc with
// _decode_w4 (via mmult_q_noc; models/linear.apply_linear for int4
// weights at m > 64). A (M, K) bf16 row-major, P (Kp/2, N) int8 packed
// nibbles (w4a8.cuh), sw (1, N) float32, out (M, N) float32 written,
// never read. A has K <= Kp columns; weight rows >= K add nothing.
//
// Bound on an H100 SXM, at the Llama-2-7B prefill shape M = 1024, K = 4096,
// N = 11008: 9.2e10 operations (93 us at the 989 TFLOP/s dense bf16 peak)
// against 76 MB of traffic (A 8.4 MB, packed weights 22.5 MB, out 45 MB;
// 23 us at 3.35 TB/s): the tensor cores bound it.
//
// Design: w4a16_wgmma.cuh, bf16 wgmma with the operands swapped (the
// decoded weights as A from registers, A's rows as B from their swizzled
// boxes), a persistent grid of BT-token x 256-column tiles (BT 128, or 64
// where that takes no more rounds of the grid: w4a8_wgmma.cuh's
// token_tile) fed by a TMA producer through a ring of stages that each
// pair a packed box's low and high nibbles, so every packed byte is read
// once per tile. Before it the kernel was rung 07's template with the
// "+ C" left out (mma.sync on 128 x 128 tiles, two stages of 32 K rows,
// the weights decoded through float and stored to shared memory), 0.7901
// ms at the shape above on an H100.
#include "w4a16_wgmma.cuh"

// Launches of each token tile's kernel (BT 64, 128) in this process.
static int tile_launches[2];

// A (M, lda) bf16 with K a multiple of 8 and K <= lda, lda a multiple of 8
// (16-byte rows, the wrapper pads; the columns past the caller's K are
// zeros), round_up(K, 512) / 2 packed rows exist, ldb (the packed pitch) a
// multiple of 16, >= N; bases 16-byte aligned. Returns cudaGetLastError()
// after the launch.
extern "C" int w4a16_gemm_noc(const void* a, const void* packed,
                              const void* sw, void* out, int M, int N, int K,
                              int lda, int ldb, int ldc, void* stream) {
  int bt = 0;
  int err = htog::w16::launch<false>(a, packed, sw, nullptr, out, M, N, K,
                                     lda, ldb, ldc,
                                     static_cast<cudaStream_t>(stream), &bt);
  if (err == 0) ++tile_launches[bt == 128];
  return err;
}

// How many times w4a16_gemm_noc launched the kernel of token tile bt (64
// or 128; -1 for another bt): the card tests read which tile ran.
extern "C" int w4a16_gemm_noc_tile_launches(int bt) {
  return bt == 64 ? tile_launches[0] : bt == 128 ? tile_launches[1] : -1;
}
