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
// Design: w4a16_gemm_noc's kernel (w4a16_wgmma.cuh: bf16 wgmma with the
// decoded weights as A in registers, A's rows as B from four swizzled
// boxes a stage, a stage pairing a packed box's low and high nibbles, so
// each packed byte is read once a tile; a persistent grid of 128- or
// 64-token x 256-column tiles) with the "+ C" epilogue in place: each
// consumer warp stages its __fmul_rn(acc, sw) for its 32 columns, 32
// tokens a pass in a shared-memory buffer of its own, and the tensor-map
// unit adds them into C in L2 (one round-to-nearest add: the plain
// version's y + C) while the consumers go on to the next tile; 32 KB of
// staging leave the ring 2 stages at BT = 128 (3 at 64). Each thread
// adding C itself (a float4 load, add and store a token) took 0.2879-
// 0.2910 ms at 4096 on an H100 against 0.2359-0.2365 for the tensor-map
// reductions (PERF.md); where C's rows are no 16-byte multiple each thread
// adds C an element at a time. Before it the kernel was
// w4a16_gemm.cuh's mma.sync template (128 x 128 tiles, two stages of 32 K
// rows, the nibbles decoded through float and stored back to shared
// memory), 0.9937 ms at 4096 on an H100.
#include "w4a16_wgmma.cuh"

static htog::w4::TileLaunches tile_launches;

// A (M, lda) bf16 with K a multiple of 8 and K <= lda, lda a multiple of 8
// (16-byte rows, the wrapper pads; the columns past the caller's K are
// zeros), round_up(K, 512) / 2 packed rows exist, ldb (the packed pitch) a
// multiple of 16, >= N; c and out (M, ldc) float32, one buffer; bases
// 16-byte aligned. Returns cudaGetLastError() after the launch.
extern "C" int w4a16_gemm(const void* a, const void* packed, const void* sw,
                          const void* c, void* out, int M, int N, int K,
                          int lda, int ldb, int ldc, void* stream) {
  int bt = 0;
  int err = htog::w16::launch<true>(a, packed, sw, c, out, M, N, K, lda,
                                    ldb, ldc,
                                    static_cast<cudaStream_t>(stream), &bt);
  tile_launches.add(err, bt);
  return err;
}

// How many times w4a16_gemm launched the kernel of token tile bt (64 or
// 128; -1 for another bt): the card tests read which tile ran.
extern "C" int w4a16_gemm_tile_launches(int bt) {
  return tile_launches.of(bt);
}
