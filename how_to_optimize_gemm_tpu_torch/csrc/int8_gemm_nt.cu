// K2 int8_gemm_nt: C = f32(QA @ QBT^T as int32) * sa[i] * sb[j] + C, in
// place on C.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_int8.py, _kernel_bt and
// its single-K-step form _kernel_bt_1k (via mmult_q_bt, rung
// 14_packed_alias_int8). QA (M, K) int8, QBT (N, K) int8 (B packed
// transposed offline), sa (M, 1) and sb (1, N) float32, C (M, N) float32
// read and overwritten (the reference aliases C into its output).
//
// Bound on an H100 SXM: the same as K1, 1.37e11 int operations (69 us at
// 1,979 TOP/s) against 168 MB of traffic (50 us at 3.35 TB/s) at
// M = N = K = 4096: the tensor cores bound it, as long as C's read and
// write overlap the products.
//
// Design: gemm_wgmma.cuh's persistent kernel (rung 15's) as its int8
// instance: wgmma.m64n256k32.s32.s8 with QA and QBT both K-major as they
// lie (the one layout 8-bit wgmma takes; one 128-byte swizzled line holds
// 128 K values of a row, and a product steps 32 bytes of it, as rung 15's
// bf16 step does), 128 int32 sums a thread, a ring of four 48 KB stages
// fed by tensor-map copies, one block an SM walking 128 x 256 tiles in
// groups of row tiles. The K loop runs inside the block, so the TPU's
// grid_k == 1 variant needs no separate kernel. Epilogue: each consumer
// turns its sums into (float(acc) * sa[i]) * sb[j] in its registers
// (__fmul_rn each, sb staged once a tile in shared memory), then adds C
// as rung 15 does: by tensor-map reductions where C's rows are 16-byte
// multiples, while the consumers go on to the next tile, else each thread
// adds its own elements with __fadd_rn. The int32 sum is exact in any
// order, so the output equals the plain version bit for bit.
#include "gemm_wgmma.cuh"

namespace htog {

struct K2 {
  static constexpr int BN = 256;         // output columns a tile
  static constexpr int CH = 0;           // stages a partial sum (0: one sum)
  static constexpr int ST = 4;           // stages of the ring
  static constexpr int PRODUCTS = 1;
  static constexpr bool B_MN = false;
  static constexpr bool SEED_C = false;
  static constexpr bool S8 = true;       // int8 operands, int32 sums
};

}  // namespace htog

// K, lda and ldb are multiples of 16 and the int8 bases 16-byte aligned
// (the wrapper pads). c and out are the same buffer. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a tensor
// map the CUDA driver refuses).
extern "C" int int8_gemm_nt(const void* qa, const void* qbt, const void* sa,
                            const void* sb, const void* c, void* out, int M,
                            int N, int K, int lda, int ldb, int ldc,
                            void* stream) {
  using namespace htog;
  CUtensorMap ta, tb;
  if (!gw::kmajor_map_s8(&ta, qa, M, K, lda, gw::BM) ||
      !gw::kmajor_map_s8(&tb, qbt, N, K, ldb, K2::BN))
    return static_cast<int>(cudaErrorInvalidValue);
  gw::GroupWalk<K2::BN> walk{(M + gw::BM - 1) / gw::BM,
                             (N + K2::BN - 1) / K2::BN};
  return gw::launch<K2>(ta, tb, c, out, sa, sb, M, N, K, ldc, walk,
                        static_cast<cudaStream_t>(stream));
}
