// Rung 08 int8_dma_nn: C' = f32(QA @ QB as int32) * sa[i] * sb[j] + C, into
// a fresh output, on a hand-built K-loop ring.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_manual_dma.py, _make_kernel
// (via mmult_q, rung 08_manual_dma_int8): a K loop of hand DMAs into two
// VMEM slots, one DMA semaphore per slot and operand, chunk t+1's copies
// started before chunk t is waited on. QA (M, K) int8, QB (K, N) int8
// row-major, sa (M, 1), sb (1, N), C (M, N) float32.
//
// Bound on an H100 SXM at M = N = K = 4096: 1.37e11 int operations (69 us
// at the 1,979 TOP/s dense int8 peak) against 168 MB of traffic (50 us at
// 3.35 TB/s): the tensor cores bound it.
//
// Design: K1's tile (int8_gemm_nn.cu: 128 x 128 a block of 8 warps, 64-byte
// K chunks, B transposed through registers into K-major shared memory,
// int8 mma.sync) with its one change: the two stages become a ring of two
// slots tracked per slot by mbarriers (manual_dma.cuh) instead of a
// cp.async.wait_group 0 and a block barrier every K step. full[s] completes
// when slot s's A copies (cp.async.mbarrier.arrive.noinc) and its B stores
// have landed; empty[s] when all 8 warps have finished their MMAs on it.
// A thread issues chunk t+1's A copies and B loads, then waits on chunk t
// alone (try_wait.parity), so no block-wide barrier sits in the K loop.
#include "manual_dma.cuh"

namespace {

using namespace htog;

__global__ void __launch_bounds__(THREADS)
    int8_dma_nn_kernel(const int8_t* qa, RowMajorInt8 qb, const float* sa,
                       const float* sb, const float* c, float* out, int M,
                       int N, int K, int lda, int ldc) {
  __shared__ __align__(16) int8_t as[RING_SLOTS][BM][LDS];
  __shared__ __align__(16) int8_t bs[RING_SLOTS][BN][LDS];
  __shared__ __align__(8) uint64_t full[RING_SLOTS];
  __shared__ __align__(8) uint64_t empty[RING_SLOTS];
  int m0 = blockIdx.y * BM;
  int n0 = blockIdx.x * BN;
  int warp = threadIdx.x >> 5;
  int lane = threadIdx.x & 31;
  int wm = warp >> 2;
  int wn = warp & 3;
  if (threadIdx.x == 0) {
    for (int s = 0; s < RING_SLOTS; ++s) {
      mbar_init(&full[s], 2 * THREADS);  // A copies landed + B stored
      mbar_init(&empty[s], WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  int acc[4][4][4];
  zero_acc(acc);
  uint32_t breg[2][4];
  int nk = (K + BK - 1) / BK;
  // chunk 0 into slot 0
  load_kmajor_async(as[0], qa, m0, M, 0, K, lda);
  cp_async_arrive_noinc(&full[0]);
  load_nmajor_regs(breg, qb, 0, n0);
  store_nmajor_regs(bs[0], breg);
  mbar_arrive(&full[0]);
  for (int t = 0; t < nk; ++t) {
    int s = t % RING_SLOTS;
    int s1 = (t + 1) % RING_SLOTS;
    bool more = t + 1 < nk;
    if (more) {
      // slot s1 last held chunk t + 1 - RING_SLOTS: wait until every warp
      // is done with it, then start chunk t + 1's copies into it
      int use = (t + 1) / RING_SLOTS;
      if (use > 0) mbar_wait(&empty[s1], (use - 1) & 1);
      load_kmajor_async(as[s1], qa, m0, M, (t + 1) * BK, K, lda);
      cp_async_arrive_noinc(&full[s1]);
      load_nmajor_regs(breg, qb, (t + 1) * BK, n0);
    }
    mbar_wait(&full[s], (t / RING_SLOTS) & 1);
    mma_stage<MmaS8>(acc, as[s], bs[s], wm, wn, lane);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (more) {
      store_nmajor_regs(bs[s1], breg);
      mbar_arrive(&full[s1]);
    }
  }
  dequant_epilogue(acc, sa, sb, c, out, M, N, ldc, m0, n0, wm, wn, lane);
}

}  // namespace

// K and lda, ldb are multiples of 16 and the int8 bases 16-byte aligned
// (the wrapper pads). Returns cudaGetLastError() after the launch.
extern "C" int int8_dma_nn(const void* qa, const void* qb, const void* sa,
                           const void* sb, const void* c, void* out, int M,
                           int N, int K, int lda, int ldb, int ldc,
                           void* stream) {
  dim3 grid((N + htog::BN - 1) / htog::BN, (M + htog::BM - 1) / htog::BM);
  htog::RowMajorInt8 b{static_cast<const int8_t*>(qb), K, ldb};
  int8_dma_nn_kernel<<<grid, htog::THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qa), b, static_cast<const float*>(sa),
      static_cast<const float*>(sb), static_cast<const float*>(c),
      static_cast<float*>(out), M, N, K, lda, ldc);
  return static_cast<int>(cudaGetLastError());
}
