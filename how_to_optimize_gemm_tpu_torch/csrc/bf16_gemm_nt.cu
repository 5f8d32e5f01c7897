// bf16_gemm_nt: C += A @ BT^T with bf16 operands and fp32 accumulation, in
// place: rung 15, the bf16 summit.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_tuned.py, _kernel_bf16_bt
// (via mmult_bf16_bt; C aliased into the output). A (M, K) bf16 and BT
// (N, K) bf16, both row-major (B packed transposed offline,
// prepare_bf16_bt), C (M, N) fp32 read and written in place. The
// accumulator starts at 0 and C is added at the flush, as the reference's
// _flush does.
//
// Bound on an H100 SXM at M = N = K = 4096: 1.37e11 operations (0.139 ms
// at the 989 TFLOP/s dense bf16 peak) against 201 MB of traffic (A and BT
// 33.6 MB each, C read and written 134 MB; 0.060 ms at 3.35 TB/s): the
// tensor cores bound it, as long as C's read and write overlap the
// products.
//
// Design: gemm_wgmma.cuh's persistent kernel on 128 x 256 tiles,
// wgmma.m64n256k16 with A and BT both K-major (one 128-byte swizzled line
// holds 64 K values of a row), 128 fp32 accumulators a thread, a ring of
// four 48 KB stages. Where C is written in place and its rows are 16-byte
// multiples (the main path: rung 15 aliases C into the output), the
// tensor-map unit adds the sums into C in L2 while the consumers go on to
// the next tile: C's 134 MB at 4,096 move beside the products instead of
// after them (measured 1.36x faster than each thread adding C itself).
//
// Accumulation: the straight fp32 sum of the tensor cores over all of K
// (CH = 0), measured within W4A16_REL / 2 of the plain version at K up to
// 4,096 on an H100; CH > 0 adds partial sums into a second fp32 array,
// which only 128 x 128 tiles (BN 128) leave room for
// (harness/flash_variants.py --group gemm builds both).
#include "gemm_wgmma.cuh"

namespace htog {

struct Rung15 {
  static constexpr int BN = 256;         // output columns a tile
  static constexpr int CH = 0;           // stages a partial sum (0: one sum)
  static constexpr int ST = 4;           // stages of the ring
  static constexpr int PRODUCTS = 1;
  static constexpr bool B_MN = false;
  static constexpr bool SEED_C = false;
  static constexpr bool S8 = false;       // bf16 operands
};

}  // namespace htog

// a (M, lda) and bt (N, ldb) bf16 with K a multiple of 8 and K <= lda,
// ldb, lda and ldb multiples of 8, bases 16-byte aligned; c, out (M, ldc)
// fp32, which may be one buffer. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a tensor map the CUDA driver refuses).
extern "C" int bf16_gemm_nt(const void* a, const void* bt, const void* c,
                            void* out, int M, int N, int K, int lda,
                            int ldb, int ldc, void* stream) {
  using namespace htog;
  CUtensorMap ta, tb;
  if (!gw::kmajor_map(&ta, a, M, K, lda, gw::BM) ||
      !gw::kmajor_map(&tb, bt, N, K, ldb, Rung15::BN))
    return static_cast<int>(cudaErrorInvalidValue);
  return gw::launch<Rung15>(ta, tb, c, out, M, N, K, ldc,
                            static_cast<cudaStream_t>(stream));
}
