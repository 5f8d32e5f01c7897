// bf16_gemm_nn: out = C + A @ B with bf16 operands and fp32 accumulation,
// out of place: rung 05.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_tuned.py,
// _make_kernel(Precision.DEFAULT) (via mmult_bf16 / _mmult_impl). A (M, K)
// and B (K, N) bf16, both row-major, C (M, N) fp32 read and left as it is,
// out (M, N) fp32 written.
//
// Sum order: the accumulators start at C, the reference's order (_init:
// acc = C; acc += A.B), and the sums are stored into out by the tensor-map
// unit (SEED_C). Copying C into out and having the tensor-map unit add the
// sums into it, the plain version's order C + sums, measured 1.3x slower
// at 4,096 on an H100 (C's 67 MB crossed twice more).
//
// Bound on an H100 SXM at M = N = K = 4096: 1.37e11 operations (0.139 ms
// at the 989 TFLOP/s dense bf16 peak) against 201 MB of traffic (0.060 ms
// at 3.35 TB/s): the tensor cores bound it.
//
// Design: rung 15's kernel (gemm_wgmma.cuh) with B read as it lies: a
// stage copies B's 64 K rows x 256 columns as four tensor-map boxes of 64
// columns (one 128-byte swizzled line a K row), which wgmma reads N-major
// (its transposed B); 128 x 256 tiles and the straight fp32 sum, which
// rung 15 measured within W4A16_REL / 2 at K 4,096. On an H100 at 4,096
// (chip_smoke.py): 0.21 ms, against 0.57 for the mma.sync kernel before
// it and 0.25 for cuBLAS's bf16 product and the add of C; the same bits
// as that kernel (tests/test_torch_cuda.py's digests).
#include "gemm_wgmma.cuh"

namespace htog {

struct Rung05 {
  static constexpr int BN = 256;         // output columns a tile
  static constexpr int CH = 0;           // stages a partial sum (0: one sum)
  static constexpr int ST = 4;           // stages of the ring
  static constexpr int PRODUCTS = 1;
  static constexpr bool B_MN = true;
  static constexpr bool SEED_C = true;
  static constexpr bool S8 = false;       // bf16 operands
};

}  // namespace htog

// a (M, lda) bf16 with K <= lda; b (K, ldb) bf16 with ldb >= N; lda and
// ldb multiples of 8, bases 16-byte aligned; c, out (M, ldc) fp32, two
// buffers. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a tensor map the CUDA driver refuses).
extern "C" int bf16_gemm_nn(const void* a, const void* b, const void* c,
                            void* out, int M, int N, int K, int lda,
                            int ldb, int ldc, void* stream) {
  using namespace htog;
  CUtensorMap ta, tb;
  if (!gw::kmajor_map(&ta, a, M, K, lda, gw::BM) ||
      !gw::nmajor_map(&tb, b, K, N, ldb))
    return static_cast<int>(cudaErrorInvalidValue);
  return gw::launch<Rung05>(ta, tb, c, out, M, N, K, ldc,
                            static_cast<cudaStream_t>(stream));
}
