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
// Design: w4a8_wgmma.cuh on packed weights with the store epilogue: int8
// wgmma with the operands swapped (the decoded weights as A from
// registers, QA as B from its swizzled box), a persistent grid of BT-token
// x 256-column tiles (BT 128, or 64 where that takes no more rounds of the
// grid: token_tile) fed by a TMA producer through a ring of stages that
// each pair a packed box's low and high nibbles, so every packed byte is
// read once per tile. Before it the kernel was K3's template with the
// "+ C" left out (int8_mma.cuh's gemm_nmajor_body: mma.sync on 128 x 128
// tiles, two stages, B through registers one nibble half a stage),
// 0.5742 ms at the shape above on an H100. The epilogue (float(acc) * sa)
// * sw is written with __fmul_rn, so the result equals the plain version
// bit for bit.
#include "w4a8_wgmma.cuh"

static htog::w4::TileLaunches tile_launches;

// lda and ldb are multiples of 16 and K <= lda (the wrapper pads; the
// columns past the caller's K are zeros), round_up(K, 512) / 2 packed rows
// exist, the int8 bases are 16-byte aligned. c is not read (pass null).
extern "C" int w4a8_gemm_noc(const void* qa, const void* packed,
                             const void* sa, const void* sw, const void* c,
                             void* out, int M, int N, int K, int lda,
                             int ldb, int ldc, void* stream) {
  (void)c;
  int bt = 0;
  int err = htog::w4::launch<htog::w4::Packed, false>(
      qa, packed, sa, sw, nullptr, out, M, N, K, lda, ldb, ldc,
      static_cast<cudaStream_t>(stream), &bt);
  tile_launches.add(err, bt);
  return err;
}

// How many times w4a8_gemm_noc launched the kernel of token tile bt (64 or
// 128; -1 for another bt): the card tests read which tile ran.
extern "C" int w4a8_gemm_noc_tile_launches(int bt) {
  return tile_launches.of(bt);
}
