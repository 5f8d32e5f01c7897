// Rung 17 int8_hand_pipe_nt: C = f32(QA @ QBT^T as int32) * sa[i] * sb[j] +
// C, in place on C, B packed transposed (N, K): rung 14's tile math under a
// hand-scheduled, warp-specialised stream pipeline.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_emit_pipeline.py, the
// pallas_call's `kernel` and its pipeline body `_scaled_body` (via
// mmult_q_bt_hand, rung 17_hand_pipeline_int8): rung 14's arithmetic with
// the stream schedule emitted by hand (emit_pipeline), three B^T buffers
// and lookahead on the A strip.
//
// Bound on an H100 SXM at M = N = K = 4096: 1.37e11 int operations (69 us
// at the 1,979 TOP/s dense int8 peak) against 168 MB (50 us at 3.35 TB/s):
// the tensor cores bound it.
//
// Design. The reference's knobs are a stream's buffer count and whether the
// pipeline may fetch the next block ahead; the card's form of a hand
// schedule is a warp-specialised ring:
// - one producer warp (warp 8) issues every copy: a chunk is 128 A rows and
//   128 B^T rows of 64 K bytes, 1,024 16-byte cp.async copies, 32 a lane,
//   zero-filled past M, N and K; each lane's cp.async.mbarrier.arrive.noinc
//   on the slot's full mbarrier (32 arrivals) fires when its copies have
//   landed. One 1-D bulk copy a row instead (256 a chunk, 64 bytes each)
//   took 3.98 ms at p = 4096 against K2's 0.41 (NVIDIA H100 80GB HBM3,
//   700 W): the copy engine's rate of small copies bounds it, as rung 11's
//   one-row A copies did;
// - eight consumer warps (rung 14's 2 x 4, 64 x 32 each) wait on full, run
//   mma_stage<MmaS8> on the slot and release it on its empty mbarrier;
//   after a tile's last chunk they apply dequant_epilogue<true> in place,
//   each thread storing its own elements (C needs no row padding);
// - the ring has NB = b_buffers (A, B^T) slots (2, 3 or 4): chunk q sits in
//   slot q % NB, the q / NB-th use of that slot, so every wait's parity is
//   (q / NB) & 1 from one counter q that runs across tiles (NB = 3 is no
//   power of two: never a per-tile counter);
// - the walk is persistent over rung 14's 128 x 128 tiles, row-major;
//   a_lookahead = true lets the producer run into the next tile while the
//   consumers finish this one (the reference's lookahead); false makes it
//   wait on a `done` mbarrier, on which every consumer warp arrives after
//   its epilogue, before it issues a tile's first chunk;
// - the producer leaves only after the consumers released its last NB
//   chunks, so no copy is in flight when it exits.
// The int32 sums are exact and the epilogue is rung 14's, so the output is
// bit for bit int8_gemm_nt's.
#include "manual_dma.cuh"

namespace {

using namespace htog;

constexpr int CONSUMERS = WARPS;            // rung 14's eight MMA warps
constexpr int PIPE_THREADS = THREADS + 32;  // and one producer warp
constexpr int SLOT = BM * LDS;              // one operand's chunk: 10,240 B

struct PipeArgs {
  const int8_t* a;   // (M, K), row pitch lda
  const int8_t* b;   // B^T (N, K), row pitch ldb
  const float* sa;   // (M,)
  const float* sb;   // (N,)
  const float* c;    // (M, ldc)
  float* out;        // (M, ldc): c itself, written in place
  int M, N, K, lda, ldb, ldc;
  int ntn, tiles;    // 128 x 128 tiles along N, in all
};

template <int NB>
constexpr int pipe_smem() {
  return NB * 2 * SLOT + 8 * (2 * NB + 1);
}

template <int NB, bool kLookahead>
__global__ void __launch_bounds__(PIPE_THREADS, 1)
    int8_hand_pipe_kernel(const PipeArgs p) {
  extern __shared__ __align__(128) uint8_t smem[];
  auto a_slot = [&](int s) {
    return reinterpret_cast<int8_t(*)[LDS]>(smem + s * 2 * SLOT);
  };
  auto b_slot = [&](int s) {
    return reinterpret_cast<int8_t(*)[LDS]>(smem + s * 2 * SLOT + SLOT);
  };
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + NB * 2 * SLOT);
  uint64_t* empty = full + NB;
  uint64_t* done = empty + NB;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NB; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init(done, CONSUMERS);
    mbar_fence_init();
  }
  __syncthreads();

  const int jobs =
      static_cast<int>(blockIdx.x) < p.tiles
          ? (p.tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1
          : 0;
  const int nk = (p.K + BK - 1) / BK;
  const int total = jobs * nk;
  auto tile_of = [&](int j, int& m0, int& n0) {
    int t = blockIdx.x + j * gridDim.x;
    m0 = (t / p.ntn) * BM;
    n0 = (t % p.ntn) * BN;
  };

  if (warp == CONSUMERS) {  // the producer
    for (int q = 0; q < total; ++q) {
      const int s = q % NB;
      const int use = q / NB;
      const int j = q / nk;
      const int kt = q - j * nk;
      if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
      if (!kLookahead && kt == 0 && j > 0) mbar_wait(done, (j - 1) & 1);
      int m0, n0;
      tile_of(j, m0, n0);
      load_kmajor_tile<32, false>(a_slot(s), p.a, m0, p.M, kt * BK, p.K,
                                  p.lda, lane, 0);
      load_kmajor_tile<32, false>(b_slot(s), p.b, n0, p.N, kt * BK, p.K,
                                  p.ldb, lane, 0);
      cp_async_arrive_noinc(&full[s]);
    }
    // every chunk landed and consumed before the producer leaves
    for (int q = total > NB ? total - NB : 0; q < total; ++q)
      mbar_wait(&empty[q % NB], (q / NB) & 1);
    return;
  }

  const int wm = warp >> 2;
  const int wn = warp & 3;
  int acc[4][4][4];
  for (int j = 0; j < jobs; ++j) {
    zero_acc(acc);
    for (int kt = 0; kt < nk; ++kt) {
      const int q = j * nk + kt;
      const int s = q % NB;
      mbar_wait(&full[s], (q / NB) & 1);
      mma_stage<MmaS8>(acc, a_slot(s), b_slot(s), wm, wn, lane);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    int m0, n0;
    tile_of(j, m0, n0);
    dequant_epilogue<true>(acc, p.sa, p.sb, p.c, p.out, p.M, p.N, p.ldc, m0,
                           n0, wm, wn, lane);
    if (!kLookahead) {
      __syncwarp();
      if (lane == 0) mbar_arrive(done);
    }
  }
}

// As many blocks as the card holds at once, at most one a tile.
template <int NB, bool kLookahead>
int launch_pipe(const PipeArgs& p, cudaStream_t stream) {
  constexpr int SMEM = pipe_smem<NB>();
  static_assert(SMEM <= 232448, "a block's shared memory is 227 KB");
  auto kernel = int8_hand_pipe_kernel<NB, kLookahead>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    PIPE_THREADS, SMEM) !=
          cudaSuccess ||
      per_sm < 1) {
    cudaGetLastError();  // clear it: a launch that cannot run says so below
    per_sm = 1;
  }
  int grid = p.tiles < sms * per_sm ? p.tiles : sms * per_sm;
  if (grid < 1) return 0;  // no work
  kernel<<<grid, PIPE_THREADS, SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K, lda and ldb are multiples of 16 and the int8 bases 16-byte aligned
// (the wrapper pads); c and out are the same buffer;
// b_buffers 2, 3 or 4; a_lookahead 0 or 1. Returns a cudaError_t
// (cudaErrorInvalidValue for another knob).
extern "C" int int8_hand_pipe_nt(const void* qa, const void* qbt,
                                 const void* sa, const void* sb, const void* c,
                                 void* out, int M, int N, int K, int lda,
                                 int ldb, int ldc, int b_buffers,
                                 int a_lookahead, void* stream) {
  int ntn = (N + BN - 1) / BN;
  PipeArgs p{static_cast<const int8_t*>(qa), static_cast<const int8_t*>(qbt),
             static_cast<const float*>(sa),  static_cast<const float*>(sb),
             static_cast<const float*>(c),   static_cast<float*>(out),
             M, N, K, lda, ldb, ldc, ntn, ((M + BM - 1) / BM) * ntn};
  auto st = static_cast<cudaStream_t>(stream);
  switch (b_buffers * 2 + (a_lookahead ? 1 : 0)) {
    case 4: return launch_pipe<2, false>(p, st);
    case 5: return launch_pipe<2, true>(p, st);
    case 6: return launch_pipe<3, false>(p, st);
    case 7: return launch_pipe<3, true>(p, st);
    case 8: return launch_pipe<4, false>(p, st);
    case 9: return launch_pipe<4, true>(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
