// int8_gemm_noc: out = f32(QA @ QB as int32) * sa[i] * sb[j], no C: the
// int8 serving linear at prefill widths (m >= 256).
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_int8.py, _kernel_noc (via
// mmult_q_noc; models/linear.apply_linear for int8 weights at m >= 256).
// QA (M, K) int8 row-major, QB (K, N) int8 row-major (N-major), sa (M, 1)
// and sb (1, N) float32, out (M, N) float32 written, never read. The
// reference's m <= 64 decode blocks (choose_blocks_q) are a VMEM rule and
// the route never sends m < 256 here, so one tiling serves every m.
//
// Bound on an H100 SXM, at the Llama-2-7B prefill shape M = 1024 (four
// slots of a 256-token bucket), K = 4096, N = 11008: 9.2e10 int
// operations (47 us at the 1,979 TOP/s dense int8 peak) against 94 MB of
// traffic (QA 4.2 MB, QB 45 MB, out 45 MB; 28 us at 3.35 TB/s): the
// tensor cores bound it.
//
// Design: w4a8_gemm_noc's kernel (w4a8_wgmma.cuh) on plain int8 weights,
// with the store epilogue: int8 wgmma with the operands swapped, QB's
// (128 K x 128 column) swizzled boxes read into registers a 32-bit word of
// four columns a row and turned K-major with __byte_perm (no decode) as
// wgmma's A, QA as B from its swizzled box; BOXES boxes of 128 K a stage,
// as many stages as fit (2 at both token tiles); a persistent grid of
// 128- or 64-token x 256-column tiles. Before it the kernel was K1's
// mma.sync template with the "+ C" left out (int8_mma.cuh's
// gemm_nmajor_body: 128 x 128 tiles, two stages, B turned K-major with
// __byte_perm while the tile was staged), 0.3395 ms at the shape above on
// an H100. The epilogue (float(acc) * sa) * sb is written with __fmul_rn,
// so the result equals the plain version bit for bit.
#include "w4a8_wgmma.cuh"

// QB's boxes of 128 K rows a stage (and QA's), one or two: two (a ring of
// 2 stages at BT = 128) ran 7% faster than one (4 stages) at M = 1,024,
// 4,096 -> 11,008 and 11,008 -> 4,096 on an H100, 6% slower at (1,000,
// 1,100 -> 1,032); one box in rings of 3 or 2 stages lost 2% and 15%
// (harness/flash_variants.py --group int8, PERF.md).
constexpr int BOXES = 2;

static htog::w4::TileLaunches tile_launches;

// K and lda, ldb are multiples of 16, K <= lda, and the int8 bases
// 16-byte aligned (the wrapper pads; QB's rows past the caller's K are
// zeros). Returns a cudaError_t as an int.
extern "C" int int8_gemm_noc(const void* qa, const void* qb, const void* sa,
                             const void* sb, void* out, int M, int N, int K,
                             int lda, int ldb, int ldc, void* stream) {
  int bt = 0;
  int err = htog::w4::launch<htog::w4::PlainS8<BOXES>, false>(
      qa, qb, sa, sb, nullptr, out, M, N, K, lda, ldb, ldc,
      static_cast<cudaStream_t>(stream), &bt);
  tile_launches.add(err, bt);
  return err;
}

// How many times int8_gemm_noc launched the kernel of token tile bt (64 or
// 128; -1 for another bt): the card tests read which tile ran.
extern "C" int int8_gemm_noc_tile_launches(int bt) {
  return tile_launches.of(bt);
}
