// fp32_gemm_nt: C += A @ BT^T on fp32 operands as three bf16 products of
// their hi + lo splits (bf16x3, the precision of XLA's Precision.HIGH),
// within FP32_REL of the fp32 product, in place: rung 16, the fp32 summit.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_tuned.py,
// _make_kernel_bt(Precision.HIGHEST) (via mmult_fp32_bt; C aliased into
// the output). A (M, K) and BT (N, K) fp32, both row-major (B packed
// transposed offline, prepare_fp32_bt), C (M, N) fp32 read and written in
// place. The accumulator starts at 0 and C is added at the flush.
//
// Precision: NOT the reference's. HIGHEST is six bf16 passes on the MXU,
// about fp32's own accuracy; this kernel takes three (hi.hi + hi.lo +
// lo.hi), HIGH's. The wrapper (ops/tuned.mmult_fp32_bt) splits A and BT
// each into bf16 hi + lo planes (split_bf16.cu, |x - hi - lo| <= 2^-17
// |x|) inside the call; every partial product is exact in fp32 and the
// dropped lo.lo is below 2^-16 of each product. Measured on an H100 at
// 1,000 to 4,096: 3.7e-6 to 4.6e-6 of max |plain| (cuBLAS's fp32
// product), about ten times an fp32 FFMA product's error (~4e-7), inside
// the function's rule (FP32_REL = 1e-5 of max |plain|) and the rung's gate
// (1e-4 against fp64). It is the fastest route that meets them: plain TF32
// does not, 3xTF32 runs at half its rate, FFMA at a fifth. A time against
// cuBLAS's fp32 product is one at different precision.
//
// Bound on an H100 SXM at M = N = K = 4096: 1.37e11 operations at a third
// of the 989 TFLOP/s bf16 peak, 0.417 ms; traffic 268 MB (A and BT 67 MB
// each, C read and written 134 MB), 0.080 ms at 3.35 TB/s, plus the split's
// 268 MB (fp32 read, two bf16 planes written), 0.080 ms: the arithmetic
// bounds it.
//
// Design: gemm_wgmma.cuh's persistent kernel on 128 x 128 tiles,
// wgmma.m64n128k16, both operands' planes K-major; a stage holds the four
// planes of 64 K values (A hi, A lo, BT hi, BT lo, 16 KB each), three
// stages, and takes the three products of each 16-deep step in turn.
// Sums: the tensor cores' fp32 sum truncates low bits over a long K, and
// three products a step add three times as often, so each consumer sums
// CH stages in its wgmma accumulator and adds that partial into a second
// fp32 array (64 + 64 accumulators a thread: 128 x 128 tiles), in K's
// order, the same bits every run. Measured on an H100 at M = N = K =
// 4,096, relative to max |plain| (harness/flash_variants.py --group gemm,
// variants fp32_ch*): CH 1, 2, 4, 8, 16 and the straight sum 4.2e-6,
// 4.0e-6, 4.3e-6, 5.0e-6, 6.1e-6 and 1.7e-5 (over FP32_REL); CH = 4 is the
// largest under FP32_REL / 2, and the choice moves the time by 2% at most.
// C is added by the tensor-map reductions where its rows are 16-byte
// multiples, else by each thread.
//
// On an H100 at 4,096 (chip_smoke.py): 0.66 ms with the two splits (0.10
// of it), 0.57 alone, against 6.62 for the FFMA kernel before it and 2.77
// for cuBLAS's fp32 product (full fp32 precision, not this route's); three
// walks of K with one plane pair a stage (32 KB stages) ran 1.25x slower.
#include "gemm_wgmma.cuh"

namespace htog {

struct Rung16 {
  static constexpr int BN = 128;         // output columns a tile
  static constexpr int CH = 4;           // stages a partial sum
  static constexpr int ST = 3;           // stages of the ring
  static constexpr int PRODUCTS = 3;     // hi.hi + hi.lo + lo.hi a stage
  static constexpr bool B_MN = false;
  static constexpr bool SEED_C = false;
  static constexpr bool S8 = false;       // bf16 operands
};

}  // namespace htog

// a (2, M, lda) and bt (2, N, ldb): A and BT split into bf16 hi then lo
// (split_bf16.cu), K <= lda, ldb, lda and ldb multiples of 8, bases
// 16-byte aligned; c, out (M, ldc) fp32, which may be one buffer. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a tensor
// map the CUDA driver refuses).
extern "C" int fp32_gemm_nt(const void* a, const void* bt, const void* c,
                            void* out, int M, int N, int K, int lda,
                            int ldb, int ldc, void* stream) {
  using namespace htog;
  CUtensorMap ta, tb;
  if (!gw::split_map(&ta, a, M, K, lda, gw::BM) ||
      !gw::split_map(&tb, bt, N, K, ldb, Rung16::BN))
    return static_cast<int>(cudaErrorInvalidValue);
  return gw::launch<Rung16>(ta, tb, c, out, M, N, K, ldc,
                            static_cast<cudaStream_t>(stream));
}
