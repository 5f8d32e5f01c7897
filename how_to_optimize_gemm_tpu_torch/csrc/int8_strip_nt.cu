// Rung 11 int8_strip_nt: C' = f32(QA @ QBT^T as int32) * sa * sb + C, B
// packed transposed (N, K), into a fresh output; rung 10 (int8_fat_nt)
// with A shared across a thread-block cluster.
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
// Design: a strip of 128 x 4,096 int8 is 512 KB, more than the 227 KB a
// block may use, so the strip's reuse goes to a thread-block cluster of
// CLUSTER blocks along N: the blocks of a cluster take CLUSTER neighbouring
// tiles of one row of C tiles, and every A chunk (128 rows x 64 bytes) is
// read from device memory once per cluster, not once per tile. Each block
// loads every CLUSTER-th row of the chunk with a 1-D bulk copy multicast to
// the whole cluster (cp.async.bulk ... .multicast::cluster), which lands at
// the same offset in every block's slot and pays off every block's full
// mbarrier. A slot is refilled only when all the cluster's warps have
// released it: each warp arrives on the empty barrier of every block, lane
// k on block k's (mapa + mbarrier.arrive.release.cluster; one lane
// arriving on every block in turn took half again as long, NVIDIA H100
// 80GB HBM3, 700.00 W, harness/ab.py). B^T, C's fetch, the staged
// epilogue, the two C/out buffers and the persistent walk are rung 10's.
// A block ends on a cluster barrier, so none leaves while a peer may still
// arrive on its barriers. When N's tiles are not a multiple of CLUSTER,
// the last cluster's surplus blocks multiply zeros and store nothing.
#include "manual_dma.cuh"

namespace {
constexpr int CLUSTER = 4;
}

// As int8_fat_nt. Returns a cudaError_t.
extern "C" int int8_strip_nt(const void* qa, const void* qbt, const void* sa,
                             const void* sb, const void* c, void* out, int M,
                             int N, int K, int lda, int ldb, int ldc,
                             void* stream) {
  return htog::launch_fat<true, 128, 2, CLUSTER>(qa, qbt, sa, sb, c, out, M,
                                                 N, K, lda, ldb, ldc, stream);
}
