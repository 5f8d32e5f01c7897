// fp32_gemm_k_blocked: out = C + A @ B on fp32 operands as three bf16
// products of their hi + lo splits, K pipelined through a ring of shared
// memory, the sums seeded with C: rungs 03 (128 x 128 blocks) and 03b
// (64 x 64).
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_k_blocked.py, _kernel (via
// mmult): a (M/bm, N/bn, K/bk) grid with K innermost and an fp32 VMEM
// scratch accumulator that is set to C at the first K step and flushed to
// the output at the last; bm = bn = bk = 256 for rung 03, 128 for 03b
// (the reference's documented regression). A (M, K) and B (K, N) fp32,
// row-major, C (M, N) fp32 read, out (M, N) fp32 written.
//
// Precision: NOT the reference's (HIGHEST, six bf16 passes on the MXU):
// three bf16 products of operands split inside the kernel (hi.hi + hi.lo +
// lo.hi, XLA's HIGH; bf16x3_mma.cuh), as rung 02. The sums start at C, as
// the reference's _init does, and every 128 K (CH steps) the tensor cores'
// partial is added into them in fp32, in K's order as the reference adds
// one 256-deep dot a K step. Held to FP32_REL = 1e-5 of max |plain| (cuBLAS's
// fp32 product), FP32_REL / 2 at K 4,096 and the rungs' gate (1e-4 against
// fp64); a time against cuBLAS's fp32 product is one at different
// precision.
//
// Bound on an H100 SXM at M = N = K = 4096: 1.37e11 operations at a third
// of the 989 TFLOP/s bf16 peak, 0.417 ms; traffic (268 MB once) 0.080 ms at
// 3.35 TB/s: the arithmetic bounds it.
//
// Design: rung 02's products and warp fragments, plus the TPU rung's one
// idea: the sequential K axis pipelined (Mosaic's double buffer) into sums
// seeded with C. The TPU's K grid dimension becomes a loop inside the
// block; its scratch accumulator, the registers. K goes through a ring of
// ST stages of fp32 tiles (A's BM x 32 and B's 32 x BM, as they lie) filled
// by 16-byte cp.async, each step's copy issued ST steps ahead of its
// products, one barrier a step. After a stage lands the block splits it
// once into one of two buffers of bf16 planes, which the warps read by
// ldmatrix a step later: the split of step k + 1 beside the products of
// step k. (Each warp splitting the fp32 values it reads into its own
// fragments, every value split by every warp that reads it, measured
// 11-13% slower on rung 03: harness/flash_variants.py --group ladder.)
// The two rungs are one template at two block edges:
//   BM = 128  rung 03, 8 warps 4 x 2 of 32 x 64 (2 x 4 of 64 x 32: 3-4%
//             slower);
//   BM =  64  rung 03b, half the edge, 4 warps of 32 x 32: more blocks,
//             half the reuse of each staged tile.
// Stays on mma.sync and cp.async: wgmma, the tensor-map unit and a
// persistent grid are rung 04's lesson. Needs K, lda and ldb multiples of
// 4 and 16-byte aligned bases (the wrapper pads).
#include "bf16x3_mma.cuh"

namespace {

using namespace htog::x3;
using htog::cp_async_commit;
using htog::cp_async_wait;

constexpr int ST = 3;  // stages of the ring
static_assert(ST >= 2, "a ring");

using Rung03 = Tile<128, 4, 2>;
using Rung03b = Tile<64, 2, 2>;

template <class T>
constexpr int smem_bytes() {
  return static_cast<int>(ST * sizeof(Stage<T>) + 2 * sizeof(Planes<T>));
}
static_assert(smem_bytes<Rung03>() <= 232448, "227 KB a block");

template <class T>
__global__ void __launch_bounds__(T::THREADS, 1)
    fp32_gemm_k_blocked_kernel(const float* a, const float* b,
                               const float* c, float* out, int M, int N,
                               int K, int lda, int ldb, int ldc) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage<T>* ring = reinterpret_cast<Stage<T>*>(smem);
  const Operands op{a, b, M, N, K, lda, ldb,
                    static_cast<int>(blockIdx.y) * T::BM,
                    static_cast<int>(blockIdx.x) * T::BM};
  Sums<T> s;
  s.init(op.m0, op.n0);
  // Every step copies one cp.async group, past K zeros (never read), so
  // that cp_async_wait counts steps and a step's body has no branch: the
  // split, the copies and the products are one stretch that ptxas can
  // interleave. K is walked in partials of CH steps.
  const int nk = (K + BK - 1) / BK;
  const int per = partial_steps(nk);
  auto copy = [&](int j) { copy_stage(ring[j % ST], op, j * BK); };
  Planes<T>* planes =
      reinterpret_cast<Planes<T>*>(smem + ST * sizeof(Stage<T>));
  for (int j = 0; j < ST; ++j) copy(j);
  s.seed(c, M, N, ldc);
  cp_async_wait<ST - 1>();
  __syncthreads();
  split_stage(planes[0], ring[0]);
  for (int kt = 0; kt < nk; s.promote()) {
    for (const int end = min(nk, kt + per); kt < end; ++kt) {
      // step kt + 1 landed; step kt's planes written and step kt - 1's
      // read by every warp
      cp_async_wait<ST - 2>();
      __syncthreads();
      copy(kt + ST);  // into step kt's slot, split a step ago
      s.step_planes(planes[kt & 1]);
      split_stage(planes[(kt + 1) & 1], ring[(kt + 1) % ST]);
    }
  }
  s.store(out, nullptr, M, N, ldc);
}

template <class T>
int launch(const void* a, const void* b, const void* c, void* out, int M,
           int N, int K, int lda, int ldb, int ldc, cudaStream_t stream) {
  constexpr int smem = smem_bytes<T>();
  auto kernel = fp32_gemm_k_blocked_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + T::BM - 1) / T::BM, (M + T::BM - 1) / T::BM);
  kernel<<<grid, T::THREADS, smem, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<float*>(out), M, N, K, lda,
      ldb, ldc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (M, lda) fp32 with K <= lda; b (K, ldb) fp32 with N <= ldb; K, lda
// and ldb multiples of 4, bases 16-byte aligned; c, out (M, ldc) fp32.
// block: the C tile edge, 128 (rung 03) or 64 (rung 03b); any other value
// returns cudaErrorInvalidValue and launches nothing. Returns
// cudaGetLastError() after the launch.
extern "C" int fp32_gemm_k_blocked(const void* a, const void* b,
                                   const void* c, void* out, int M, int N,
                                   int K, int lda, int ldb, int ldc,
                                   int block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block == 128)
    return launch<Rung03>(a, b, c, out, M, N, K, lda, ldb, ldc, s);
  if (block == 64)
    return launch<Rung03b>(a, b, c, out, M, N, K, lda, ldb, ldc, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
