// K3 w4a8_gemm: C = f32(QA @ decode(P) as int32) * sa[i] * sw[j] + C, in
// place on C.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_int4.py, _kernel_w4a8
// and its _decode_w4 (via mmult_q_w4a8, rung 07b_pallas_w4a8). QA (M, K)
// int8, P (Kp/2, N) int8 packed nibbles in 512-row pack blocks
// (Kp = round_up(K, 512)), sa (M, 1) and sw (1, N) float32, C (M, N)
// float32 read and overwritten.
//
// Bound on an H100 SXM: at M = N = K = 4096, 1.37e11 int operations
// (69 us at the 1,979 TOP/s dense int8 peak) against 159 MB of traffic
// (A 16.8 MB, the packed weights 8.4 MB, C read and written 67 MB each;
// 48 us at 3.35 TB/s): the tensor cores bound it, as for K1.
//
// Design: w4a8_gemm_noc's kernel (w4a8_wgmma.cuh on packed weights: int8
// wgmma with the decoded weights as A in registers, QA as B from its
// swizzled box, a stage pairing a packed box's low and high nibbles, so
// each packed byte is read once a tile; a persistent grid of 128- or
// 64-token x 256-column tiles) with the "+ C" epilogue: each consumer warp
// stages its (float(acc) * sa) * sw (__fmul_rn, the plain version's order)
// for its 32 columns, 32 tokens at a time, in shared memory, and the
// tensor-map unit adds them into C in L2 (one round-to-nearest add: the
// plain version's + C bit for bit) while the consumers go on to the next
// tile; the ring holds 2 stages (3 at BT = 64) beside that staging. Each
// thread adding C itself (a float4 load, add and store a token, 3 stages)
// took 0.2192 ms at 4096 on an H100 against 0.1702 (PERF.md); where C's
// rows are no 16-byte multiple each thread adds C an element at a time.
// Before it the kernel was K1's mma.sync template (int8_mma.cuh's
// gemm_nmajor_body: 128 x 128 tiles, two stages, the nibbles decoded and
// turned K-major with __byte_perm while the tile was staged, each packed
// byte fetched twice, once a half), 0.6427 ms at 4096 on an H100.
#include "w4a8_wgmma.cuh"

static htog::w4::TileLaunches tile_launches;

// lda and ldb are multiples of 16 and K <= lda (the wrapper pads; the
// columns past the caller's K are zeros), round_up(K, 512) / 2 packed rows
// exist, the int8 bases are 16-byte aligned. c and out are the same
// buffer.
extern "C" int w4a8_gemm(const void* qa, const void* packed, const void* sa,
                         const void* sw, const void* c, void* out, int M,
                         int N, int K, int lda, int ldb, int ldc,
                         void* stream) {
  int bt = 0;
  int err = htog::w4::launch<htog::w4::Packed, true>(
      qa, packed, sa, sw, c, out, M, N, K, lda, ldb, ldc,
      static_cast<cudaStream_t>(stream), &bt);
  tile_launches.add(err, bt);
  return err;
}

// How many times w4a8_gemm launched the kernel of token tile bt (64 or
// 128; -1 for another bt): the card tests read which tile ran.
extern "C" int w4a8_gemm_tile_launches(int bt) {
  return tile_launches.of(bt);
}
