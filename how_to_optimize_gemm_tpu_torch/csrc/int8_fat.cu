// Rungs 09 and 10, the fat-tile hand pipelines, two instances of
// manual_dma.cuh's persistent kernel:
//   int8_fat_nn (rung 09): C' = f32(QA @ QB as int32) * sa * sb + C, B (K, N);
//   int8_fat_nt (rung 10): the same on B packed transposed, QBT (N, K).
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
// Rung 10 adds B^T (N, K): both operands K-major, copied into shared
// memory as they are (cp.async), no transpose through registers; and two
// C/out buffers, the reference's accumulator ping-pong: tile j fetches
// its C into buffer j % 2 while tile j - 1's store still reads the other.
// Two 128 x 256 buffers (264 KB) exceed 227 KB, so with two buffers the
// largest tile is 128 x 128 (two 68 KB buffers and a 40 KB ring).
#include "manual_dma.cuh"

// K and lda, ldb are multiples of 16, ldc (the row pitch of c and out, >=
// N) a multiple of 4, and every base 16-byte aligned (the wrapper pads).
// Returns a cudaError_t.
extern "C" int int8_fat_nn(const void* qa, const void* qb, const void* sa,
                           const void* sb, const void* c, void* out, int M,
                           int N, int K, int lda, int ldb, int ldc,
                           void* stream) {
  return htog::launch_fat<false, 256, 1>(qa, qb, sa, sb, c, out, M, N, K,
                                         lda, ldb, ldc, stream);
}

extern "C" int int8_fat_nt(const void* qa, const void* qbt, const void* sa,
                           const void* sb, const void* c, void* out, int M,
                           int N, int K, int lda, int ldb, int ldc,
                           void* stream) {
  return htog::launch_fat<true, 128, 2>(qa, qbt, sa, sb, c, out, M, N, K,
                                        lda, ldb, ldc, stream);
}
