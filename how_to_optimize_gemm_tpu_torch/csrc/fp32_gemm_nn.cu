// fp32_gemm_nn: out = C + A @ B on fp32 operands as three bf16 products of
// their hi + lo splits (bf16x3, the precision of XLA's Precision.HIGH),
// within FP32_REL of the fp32 product, out of place: rung 04.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_tuned.py,
// _make_kernel(Precision.HIGHEST) (via mmult / _mmult_impl). A (M, K) and
// B (K, N) fp32, both row-major, C (M, N) fp32 read and left as it is, out
// (M, N) fp32 written. The sums start at C, as the reference's _init does
// (acc = C; acc += A.B).
//
// Precision: NOT the reference's. HIGHEST is six bf16 passes on the MXU,
// about fp32's own accuracy; this kernel takes three (hi.hi + hi.lo +
// lo.hi), HIGH's, as rung 16 (fp32_gemm_nt.cu) does. The wrapper
// (ops/tuned.mmult) splits A and B each into bf16 hi + lo planes
// (split_bf16.cu, |x - hi - lo| <= 2^-17 |x|) inside the call; every
// partial product is exact in fp32 and the dropped lo.lo is below 2^-16
// of each product. The rules it is held to: FP32_REL = 1e-5 of max |plain|
// (cuBLAS's fp32 product), FP32_REL / 2 at K 4,096, and the rung's gate
// (1e-4 against fp64). A time against cuBLAS's fp32 product is one at
// different precision.
//
// Bound on an H100 SXM at M = N = K = 4096: 1.37e11 operations at a third
// of the 989 TFLOP/s bf16 peak, 0.417 ms; traffic 268 MB (A and B 67 MB
// each, C read and out written 134 MB), 0.080 ms at 3.35 TB/s, plus the
// splits' 268 MB (fp32 read, two bf16 planes written), 0.080 ms: the
// arithmetic bounds it. FFMA's ceiling (67 TFLOP/s) is 2.05 ms, above
// cuBLAS's fp32 product, so no FFMA kernel reaches the library.
//
// Design: gemm_wgmma.cuh's persistent kernel on 128 x 128 tiles,
// wgmma.m64n128k16, rung 16's three products a stage with B read as it
// lies (rung 05's N-major B, wgmma's transposed B): a stage holds A hi and
// A lo (K-major, 128 rows x 64 K, 16 KB each) and B hi and B lo (64 K rows
// x 128 columns, each two tensor-map boxes of 64 columns, one 128-byte
// swizzled line a K row, 16 KB each), 64 KB a stage, three stages. Sums:
// CH stages in the wgmma accumulator, each partial added in fp32 into a
// second array that starts at C (SEED_C), in K's order: out = C + p1 + p2
// + ..., stored by the tensor-map unit where out's rows are 16-byte
// multiples. Measured on an H100 at M = N = K = 4,096, relative to max
// |plain| (harness/flash_variants.py --group gemm, variants nn_ch*): CH 1,
// 2, 4, 8, 16 and the straight sum (C in the wgmma accumulators) 4.1e-6,
// 4.1e-6, 4.3e-6, 5.0e-6, 6.1e-6 and 1.7e-5 (over FP32_REL); CH = 4 as
// rung 16, the largest under FP32_REL / 2, the time within 2% of each.
//
// On an H100 at 4,096 (the same harness, graph replays): 0.67 ms with the
// two splits, 0.58 alone, against 4.49 for the FFMA kernel before it and
// 2.70 for cuBLAS's fp32 product (full fp32 precision, not this route's);
// rung 16, the same products on a K-major BT, 0.64.
#include "gemm_wgmma.cuh"

namespace htog {

struct Rung04 {
  static constexpr int BN = 128;         // output columns a tile
  static constexpr int CH = 4;           // stages a partial sum
  static constexpr int ST = 3;           // stages of the ring
  static constexpr int PRODUCTS = 3;     // hi.hi + hi.lo + lo.hi a stage
  static constexpr bool B_MN = true;
  static constexpr bool SEED_C = true;
  static constexpr bool S8 = false;       // bf16 operands
};

}  // namespace htog

// a (2, M, lda): A split into bf16 hi then lo (split_bf16.cu), K <= lda;
// b (2, K, ldb): B split likewise, N <= ldb; lda and ldb multiples of 8,
// bases 16-byte aligned; c, out (M, ldc) fp32, two buffers. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a tensor
// map the CUDA driver refuses).
extern "C" int fp32_gemm_nn(const void* a, const void* b, const void* c,
                            void* out, int M, int N, int K, int lda,
                            int ldb, int ldc, void* stream) {
  using namespace htog;
  CUtensorMap ta, tb;
  if (!gw::split_map(&ta, a, M, K, lda, gw::BM) ||
      !gw::split_nmajor_map(&tb, b, K, N, ldb))
    return static_cast<int>(cudaErrorInvalidValue);
  return gw::launch<Rung04>(ta, tb, c, out, M, N, K, ldc,
                            static_cast<cudaStream_t>(stream));
}
