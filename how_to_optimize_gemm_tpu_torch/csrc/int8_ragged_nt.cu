// Rung 18 int8_ragged_nt: C = f32(QA @ QBT^T as int32) * sa[i] * sb[j] + C,
// in place on C, B packed transposed (N, K): rung 14's tile math walked
// over a ragged-M strip plan in one persistent launch.
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
// tail). One launch walks every 128 x 128 tile of the plan, persistent: the
// tiles are numbered strip by strip, in order, and within a strip N-major
// (the strip's bm / 128 row tiles of one B^T panel, then the next panel),
// so the blocks of a wave share a few B^T panels and each panel is read
// from device memory about once a strip while the strip's A rows stay in
// the L2. The tail is the same launch's last tiles, not a second call:
// the reference blamed its loss on the tail call's pipeline restart. Each
// tile is int8_gemm_nt's (gemm_nt_tile: cp.async into two stages, mma.sync,
// the dequant epilogue in place), so the output is bit for bit K2's.
#include "int8_mma.cuh"

namespace {

using namespace htog;

struct Plan {
  int bm1, g1;        // head: g1 strips of bm1 rows from row 0
  int bm2, g2, off2;  // tail: g2 strips of bm2 rows from row off2 * bm2
};

// Tile t of the plan's walk -> its (m0, n0).
__device__ __forceinline__ void plan_tile(const Plan& pl, int ntn, int t,
                                          int& m0, int& n0) {
  int bm = pl.bm1;
  int row0 = 0;
  const int head = pl.g1 * (pl.bm1 / BM) * ntn;
  if (t >= head) {
    t -= head;
    bm = pl.bm2;
    row0 = pl.off2 * pl.bm2;
  }
  const int rt = bm / BM;  // row tiles a strip
  const int strip = t / (rt * ntn);
  const int u = t - strip * rt * ntn;
  const int panel = u / rt;
  m0 = row0 + strip * bm + (u - panel * rt) * BM;
  n0 = panel * BN;
}

__global__ void __launch_bounds__(THREADS)
    int8_ragged_nt_kernel(const int8_t* qa, const int8_t* qbt,
                          const float* sa, const float* sb, const float* c,
                          float* out, int M, int N, int K, int lda, int ldb,
                          int ldc, const Plan pl, int tiles) {
  __shared__ __align__(16) Smem sm;
  const int ntn = (N + BN - 1) / BN;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int m0, n0;
    plan_tile(pl, ntn, t, m0, n0);
    gemm_nt_tile(sm, qa, qbt, sa, sb, c, out, M, N, K, lda, ldb, ldc, m0,
                 n0);
  }
}

}  // namespace

// As int8_gemm_nt (K, lda, ldb multiples of 16, int8 bases 16-byte aligned,
// c and out the same buffer), plus the plan: bm1, bm2 multiples of 128,
// g1 * bm1 + g2 * bm2 = M rounded up to 128, off2 * bm2 = g1 * bm1
// (ragged_m_plan's plans; g2 = 0 with bm2 = 128 for none). Returns a
// cudaError_t.
extern "C" int int8_ragged_nt(const void* qa, const void* qbt, const void* sa,
                              const void* sb, const void* c, void* out, int M,
                              int N, int K, int lda, int ldb, int ldc,
                              int bm1, int g1, int bm2, int g2, int off2,
                              void* stream) {
  const Plan pl{bm1, g1, bm2, g2, off2};
  const int ntn = (N + BN - 1) / BN;
  const int tiles = (g1 * (bm1 / BM) + g2 * (bm2 / BM)) * ntn;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, int8_ragged_nt_kernel, THREADS, 0) != cudaSuccess ||
      per_sm < 1) {
    cudaGetLastError();  // clear it: a launch that cannot run says so below
    per_sm = 1;
  }
  const int grid = tiles < sms * per_sm ? tiles : sms * per_sm;
  if (grid < 1) return 0;  // no work
  int8_ragged_nt_kernel<<<grid, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qa), static_cast<const int8_t*>(qbt),
      static_cast<const float*>(sa), static_cast<const float*>(sb),
      static_cast<const float*>(c), static_cast<float*>(out), M, N, K, lda,
      ldb, ldc, pl, tiles);
  return static_cast<int>(cudaGetLastError());
}
