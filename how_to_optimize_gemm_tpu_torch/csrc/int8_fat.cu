// Rungs 09 and 10, the fat-tile and ping-pong hand pipelines:
//   int8_fat_nn (rung 09): C' = f32(QA @ QB as int32) * sa * sb + C, B (K, N),
//     on manual_dma.cuh's persistent fat-tile kernel;
//   int8_fat_nt (rung 10): the same on B packed transposed, QBT (N, K), on
//     gemm_wgmma.cuh's int8 wgmma body with the accumulator ping-pong.
// Both write a fresh output.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_manual_dma.py,
// _make_fat_kernel (via mmult_q_fat, rung 09_fat_tile_int8) and
// _make_packed_kernel (via mmult_q_packed, rung 10_packed_fat_int8).
//
// Bound on an H100 SXM at M = N = K = 4096: 1.37e11 int operations (69 us
// at the 1,979 TOP/s dense int8 peak) against 168 MB of traffic (50 us at
// 3.35 TB/s): the tensor cores bound both.
//
// Design. Rung 09's three ideas on Hopper:
// - the largest C tile a block holds: operand traffic scales as
//   1/bm + 1/bn, and a warp's accumulator tile is capped by the 255
//   registers a thread (64 x 64 int32 = 128 registers), so 8 warps take
//   128 x 256. Its C/out buffer (128 x 256 fp32, 132 KB) and the two-slot
//   (A, B) ring (60 KB) fill 192 KB of the 227 KB a block may use: one
//   block an SM, and the kernel is persistent (a block per SM walks the
//   tiles);
// - C's fetch (bulk copies, one a row, paid off on an mbarrier) issued at
//   the tile's start and awaited at its flush;
// - the writeback overlapped with the next tile's K loop: the flush
//   computes the epilogue in place in the buffer and stores it with bulk
//   copies (cp.async.bulk.global.shared::cta), which drain while the next
//   tile's first chunks, issued before the flush, are multiplied. With
//   one buffer the next tile's C fetch must wait until that store has read
//   it (cp.async.bulk.wait_group.read 0).
// Rung 10 adds B^T (N, K), both operands K-major, and the reference's
// accumulator ping-pong: tile t sums into acc[t % 2] while tile t - 1's
// result leaves from acc[(t - 1) % 2]. On the card the accumulators are a
// consumer warpgroup's registers, so the ping-pong is two consumer
// warpgroups taking the block's tiles in turn: K2's int8 wgmma body
// (int8_gemm_nt.cu: QA and QBT K-major as they lie, fed by tensor maps
// through a warp-specialised ring, a persistent grouped walk) with
// PINGPONG (gemm_wgmma.cuh), each consumer computing a whole 128 x 128
// tile (two wgmma.m64n128k32 a 32-byte K step, 2 x 64 int32 sums a
// thread) while the other dequantizes and flushes its own. A stage is a
// 128-row A box and a 128-row B^T box, 32 KB, in a ring of six; a slot is
// released by the one warpgroup that read it. The output is fresh: each
// consumer loads C's boxes by tensor map into its staging, adds its
// dequantized sums there with __fadd_rn and the tensor-map unit stores the
// staging into out (rung 11's path), where C's rows are 16-byte multiples
// (the wrapper pads them); elsewhere each thread adds C. The int32 sums
// are exact and the epilogue is (float(acc) * sa) * sb with __fmul_rn
// each, then one __fadd_rn of C, so the output equals the plain version
// bit for bit.
#include "gemm_wgmma.cuh"
#include "manual_dma.cuh"

namespace htog {

struct Rung10 {
  static constexpr int BN = 128;         // output columns a tile
  static constexpr int CH = 0;           // stages a partial sum (0: one sum)
  static constexpr int ST = 6;           // stages of the ring
  static constexpr int PRODUCTS = 1;
  static constexpr bool B_MN = false;
  static constexpr bool SEED_C = false;
  static constexpr bool S8 = true;       // int8 operands, int32 sums
  static constexpr bool LOAD_C = true;   // a fresh output, C loaded
  static constexpr bool PINGPONG = true;   // a consumer's whole tiles
};

}  // namespace htog

// K and lda, ldb are multiples of 16, ldc (the row pitch of c and out, >=
// N) a multiple of 4, and every base 16-byte aligned (the wrapper pads).
// Returns a cudaError_t.
extern "C" int int8_fat_nn(const void* qa, const void* qb, const void* sa,
                           const void* sb, const void* c, void* out, int M,
                           int N, int K, int lda, int ldb, int ldc,
                           void* stream) {
  return htog::launch_fat<256>(qa, qb, sa, sb, c, out, M, N, K, lda, ldb,
                               ldc, stream);
}

// As int8_fat_nn, B as QBT (N, K); c and out two buffers. Returns a
// cudaError_t (cudaErrorInvalidValue for a tensor map the CUDA driver
// refuses).
extern "C" int int8_fat_nt(const void* qa, const void* qbt, const void* sa,
                           const void* sb, const void* c, void* out, int M,
                           int N, int K, int lda, int ldb, int ldc,
                           void* stream) {
  return htog::gw::launch_pingpong<htog::Rung10>(
      qa, qbt, sa, sb, c, out, M, N, K, lda, ldb, ldc,
      static_cast<cudaStream_t>(stream));
}
