// Rung 18 int8_ragged_nt: C = f32(QA @ QBT^T as int32) * sa[i] * sb[j] + C,
// in place on C, B packed transposed (N, K): K2's kernel walked over a
// ragged-M strip plan in one persistent launch.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_int8.py, _kernel_bt run
// under the strip plan ragged_m_plan (via mmult_q_bt_ragged, rung
// 18_ragged_m_int8): a tall uniform head of strips and at most one shorter
// tail strip, each strip one full read of B^T, as two aliased pallas_calls
// over the same buffers.
//
// Bound on an H100 SXM at M = N = K = 4096: 1.37e11 int operations (69 us
// at the 1,979 TOP/s dense int8 peak) against 168 MB (50 us at 3.35 TB/s):
// the tensor cores bound it.
//
// Design. The plan, at most two pieces, comes in as arguments: the head
// (bm1, g1, 0), g1 strips of bm1 rows from row 0, and the tail
// (bm2, g2, off2), g2 strips of bm2 rows from row off2 * bm2 (g2 = 0: no
// tail). One launch walks every 128 x 256 tile of the plan, persistent:
// the tiles are numbered strip by strip, in order, and within a strip
// N-major (the strip's bm / 128 row tiles of one 256-column B^T panel,
// then the next panel), so the blocks of a wave share a few B^T panels
// and each panel is read from device memory about once a strip while the
// strip's A rows stay in the L2. The tail is the same launch's last tiles,
// not a second call: the reference blamed its loss on the tail call's
// pipeline restart. The kernel is K2's (gemm_wgmma.cuh's int8 instance,
// the same constants) with this walk in place of K2's groups of row tiles,
// so the two differ by their walk alone and the output is bit for bit
// K2's.
#include "gemm_wgmma.cuh"

namespace htog {

struct Rung18 {
  static constexpr int BN = 256;         // output columns a tile
  static constexpr int CH = 0;           // stages a partial sum (0: one sum)
  static constexpr int ST = 4;           // stages of the ring
  static constexpr int PRODUCTS = 1;
  static constexpr bool B_MN = false;
  static constexpr bool SEED_C = false;
  static constexpr bool S8 = true;       // int8 operands, int32 sums
};

// The plan's walk: tile t -> its (m0, n0).
struct PlanWalk {
  int bm1, g1;        // head: g1 strips of bm1 rows from row 0
  int bm2, g2, off2;  // tail: g2 strips of bm2 rows from row off2 * bm2
  int num_n;          // 256-column panels of B^T

  __host__ __device__ int tiles() const {
    return (g1 * (bm1 / gw::BM) + g2 * (bm2 / gw::BM)) * num_n;
  }
  __device__ __forceinline__ void tile(int t, int& m0, int& n0) const {
    int bm = bm1;
    int row0 = 0;
    const int head = g1 * (bm1 / gw::BM) * num_n;
    if (t >= head) {
      t -= head;
      bm = bm2;
      row0 = off2 * bm2;
    }
    const int rt = bm / gw::BM;  // row tiles a strip
    const int strip = t / (rt * num_n);
    const int u = t - strip * rt * num_n;
    const int panel = u / rt;
    m0 = row0 + strip * bm + (u - panel * rt) * gw::BM;
    n0 = panel * Rung18::BN;
  }
};

}  // namespace htog

// As int8_gemm_nt (K, lda, ldb multiples of 16, int8 bases 16-byte aligned,
// c and out the same buffer), plus the plan: bm1, bm2 multiples of 128,
// g1 * bm1 + g2 * bm2 = M rounded up to 128, off2 * bm2 = g1 * bm1
// (ragged_m_plan's plans; g2 = 0 with bm2 = 128 for none). Returns a
// cudaError_t (cudaErrorInvalidValue for a tensor map the CUDA driver
// refuses).
extern "C" int int8_ragged_nt(const void* qa, const void* qbt, const void* sa,
                              const void* sb, const void* c, void* out, int M,
                              int N, int K, int lda, int ldb, int ldc,
                              int bm1, int g1, int bm2, int g2, int off2,
                              void* stream) {
  using namespace htog;
  CUtensorMap ta, tb;
  if (!gw::kmajor_map_s8(&ta, qa, M, K, lda, gw::BM) ||
      !gw::kmajor_map_s8(&tb, qbt, N, K, ldb, Rung18::BN))
    return static_cast<int>(cudaErrorInvalidValue);
  const PlanWalk walk{bm1, g1, bm2, g2, off2,
                      (N + Rung18::BN - 1) / Rung18::BN};
  return gw::launch<Rung18>(ta, tb, c, out, sa, sb, M, N, K, ldc, walk,
                            static_cast<cudaStream_t>(stream));
}
