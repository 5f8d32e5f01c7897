// Rung 11 int8_strip_nt: C' = f32(QA @ QBT^T as int32) * sa * sb + C, B
// packed transposed (N, K), into a fresh output (c is not written): K2's
// int8 wgmma body with the A strip shared across a thread-block cluster.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_manual_dma.py,
// _make_strip_kernel (via mmult_q_strip, rung 11_strip_resident_int8):
// rung 10 with the (bm, K) A strip fetched once per row of C tiles and
// reused across the row.
//
// Bound on an H100 SXM at M = N = K = 4096: 1.37e11 int operations (69 us
// at the 1,979 TOP/s dense int8 peak) against 168 MB of traffic (50 us at
// 3.35 TB/s): the tensor cores bound it.
//
// Design: gemm_wgmma.cuh's int8 instance (K2's wgmma.m64n256k32 on QA and
// QBT K-major, fed by tensor maps through a warp-specialised ring of four
// 48 KB stages, a persistent grouped walk) with the rung's one idea in the
// card's form. A 128 x 4,096 strip (512 KB) fits no block, so the strip's
// reuse goes to a cluster of CL blocks along N: the cluster walks tiles of
// 128 x (CL x 256) in groups of row tiles, block rank r taking the
// 256-column tile n0 + 256 r, and each stage's 128-row A box is read once
// a cluster, rank r copying rows [r 128 / CL, (r + 1) 128 / CL) with one
// tensor-map multicast into every block's slot (whole 1,024-byte swizzle
// atoms). A slot is refilled once the consumers of all CL blocks have
// released it. Each block copies its own B^T box; a block whose tile lies
// past N copies zeros and stores nothing. The grid is CL x the clusters
// the card holds at once (cudaOccupancyMaxActiveClusters), at most one a
// cluster tile. The output is fresh: each consumer loads C's boxes by
// tensor map into its staging, adds its dequantized sums there with
// __fadd_rn and the tensor-map unit stores the staging into out (K1's
// path), where C's rows are 16-byte multiples (the wrapper pads them);
// elsewhere each thread adds C. The int32 sums are exact and the epilogue
// is (float(acc) * sa) * sb with __fmul_rn each, then one __fadd_rn of C,
// so the output equals the plain version bit for bit. CL = 1 (the control,
// harness/flash_variants.py --group strip) shares A through the L2 alone.
#include "gemm_wgmma.cuh"

namespace htog {

struct Rung11 {
  static constexpr int BN = 256;         // output columns a tile
  static constexpr int CH = 0;           // stages a partial sum (0: one sum)
  static constexpr int ST = 4;           // stages of the ring
  static constexpr int PRODUCTS = 1;
  static constexpr bool B_MN = false;
  static constexpr bool SEED_C = false;
  static constexpr bool S8 = true;       // int8 operands, int32 sums
  static constexpr int CL = 2;           // blocks of a cluster along N
  static constexpr bool LOAD_C = true;   // a fresh output, C loaded
};

using StripWalk = gw::GroupWalk<Rung11::CL * Rung11::BN>;

}  // namespace htog

// As int8_fat_nt: K, lda and ldb multiples of 16, the int8 bases 16-byte
// aligned, c and out (M, ldc) two buffers (the wrapper pads ldc to a
// multiple of 4). Returns a cudaError_t (cudaErrorInvalidValue for a
// tensor map the CUDA driver refuses).
extern "C" int int8_strip_nt(const void* qa, const void* qbt, const void* sa,
                             const void* sb, const void* c, void* out, int M,
                             int N, int K, int lda, int ldb, int ldc,
                             void* stream) {
  using namespace htog;
  constexpr int CL = Rung11::CL;
  CUtensorMap ta, tb;
  if (!gw::kmajor_map_s8(&ta, qa, M, K, lda, gw::BM / CL) ||
      !gw::kmajor_map_s8(&tb, qbt, N, K, ldb, Rung11::BN))
    return static_cast<int>(cudaErrorInvalidValue);
  int num_n = (N + Rung11::BN - 1) / Rung11::BN;
  StripWalk walk{(M + gw::BM - 1) / gw::BM, (num_n + CL - 1) / CL};
  return gw::launch<Rung11>(ta, tb, c, out, sa, sb, M, N, K, ldc, walk,
                            static_cast<cudaStream_t>(stream));
}

// The cluster's blocks (CL) and the clusters the card runs at once; a
// negative cudaError_t where the card cannot say.
extern "C" int int8_strip_nt_cluster() { return htog::Rung11::CL; }

extern "C" int int8_strip_nt_active_clusters() {
  using namespace htog;
  int blocks = 0;
  int err = gw::resident_blocks<Rung11, StripWalk>(&blocks);
  return err != 0 ? -err : blocks / Rung11::CL;
}
