// K1 int8_gemm_nn: C' = f32(QA @ QB as int32) * sa[i] * sb[j] + C, into a
// fresh output.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_int8.py, _kernel (via
// mmult_q, rung 06_pallas_int8). QA (M, K) int8 row-major, QB (K, N)
// int8 row-major (N-major), sa (M, 1) and sb (1, N) float32, C (M, N)
// float32 read, never written.
//
// Bound on an H100 SXM: at M = N = K = 4096 the product is 1.37e11 int
// operations (69 us at the 1,979 TOP/s dense int8 peak) against 168 MB
// of traffic (A and B 16.8 MB each, C read and the output written 67 MB
// each; 50 us at 3.35 TB/s), so the tensor cores, not memory, bound it.
//
// Design: int8_gemm_noc's kernel (w4a8_wgmma.cuh's int8 wgmma body on
// plain int8 weights: QB's (128 K x 128 column) swizzled boxes turned
// K-major into registers as wgmma's A, QA as B from its swizzled box, a
// persistent grid of 128- or 64-token x 256-column tiles) with the "+ C"
// epilogue into a fresh output: before a tile's main loop each consumer
// warp's lane 0 loads the tile's first boxes of C (its 32 columns, OUT_T
// tokens a box) by tensor map into its staging buffers, under a barrier
// each; after the products the threads add C to their (float(acc) * sa) *
// sb (__fmul_rn, then __fadd_rn: the plain version's order, bit for bit)
// where they stage them, the tensor-map unit stores each buffer into the
// output, and the next box of C is loaded into a buffer as soon as its
// store has read it. Where C's rows are no 16-byte multiple each thread
// adds C. Before it the kernel was int8_mma.cuh's mma.sync template (128 x
// 128 tiles, two stages, no warp specialisation, B turned K-major with
// __byte_perm on its way into shared memory, C read after the K loop),
// 0.4896 ms at 4096 on an H100.
#include "w4a8_wgmma.cuh"

// QB's boxes of 128 K rows a stage (and QA's), and the staging of C: OUT_B
// buffers of OUT_T tokens a consumer warp. Two boxes (2 stages) with two
// 16-token buffers took 0.1572-0.1599 ms at M = N = K = 4,096 on an H100
// in two calls; one 32-token buffer 4% more, one box a stage (4 stages)
// 3-4% more, one box with two 32-token buffers (64 KB, 3 stages) 7% more,
// and each thread adding C from float4 loads (no staging) 34% more
// (harness/flash_variants.py --group int8; PERF.md).
constexpr int BOXES = 2;
constexpr int OUT_T = 16;
constexpr int OUT_B = 2;

using K1 =
    htog::w4::PlainS8<BOXES, htog::w4::Staging<OUT_T, OUT_B, true>>;

static htog::w4::TileLaunches tile_launches;

// K and lda, ldb are multiples of 16, K <= lda, and the int8 bases
// 16-byte aligned (the wrapper pads; QB's rows past the caller's K are
// zeros); c and out (M, ldc) float32, two buffers. Returns a cudaError_t
// as an int.
extern "C" int int8_gemm_nn(const void* qa, const void* qb, const void* sa,
                            const void* sb, const void* c, void* out, int M,
                            int N, int K, int lda, int ldb, int ldc,
                            void* stream) {
  int bt = 0;
  int err = htog::w4::launch<K1, true>(qa, qb, sa, sb, c, out, M, N, K, lda,
                                       ldb, ldc,
                                       static_cast<cudaStream_t>(stream),
                                       &bt);
  tile_launches.add(err, bt);
  return err;
}

// How many times int8_gemm_nn launched the kernel of token tile bt (64 or
// 128; -1 for another bt): the card tests read which tile ran.
extern "C" int int8_gemm_nn_tile_launches(int bt) {
  return tile_launches.of(bt);
}
