// fp32_gemm_mn_tile: out = A @ B + C on fp32 operands as three bf16
// products of their hi + lo splits, one C tile a block: rung 02.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_mn_tile.py, _kernel (via
// mmult): a (M/128, N/128) grid, each program one (128, 128) C tile from a
// (128, K) strip of A and a (K, 128) strip of B held whole in VMEM, one
// dot at Precision.HIGHEST on the MXU, then + C. A (M, K) and B (K, N)
// fp32, row-major, C (M, N) fp32 read, out (M, N) fp32 written. The sums
// start at 0 and C is added once at the end, as the reference's
// jnp.dot(...) + c_ref does.
//
// Precision: NOT the reference's. HIGHEST is six bf16 passes on the MXU;
// this kernel takes three (hi.hi + hi.lo + lo.hi, XLA's HIGH), as rungs 04
// and 16 do, with A and B split inside the kernel (bf16x3_mma.cuh). It is
// held to FP32_REL = 1e-5 of max |plain| (cuBLAS's fp32 product), to
// FP32_REL / 2 at K 4,096, and to the rung's gate (1e-4 against fp64). A
// time against cuBLAS's fp32 product is one at different precision.
//
// Bound on an H100 SXM at M = N = K = 4096: 1.37e11 operations at a third
// of the 989 TFLOP/s bf16 peak, 0.417 ms; traffic (268 MB once) 0.080 ms at
// 3.35 TB/s: the arithmetic bounds it.
//
// Design: the rung's lesson is the matrix unit with nothing overlapped. A
// block of 8 warps owns a 128 x 128 C tile (the TPU rung's tile), the
// warps 4 x 2, each 32 x 64 of it (bf16x3_mma.cuh's tiling; 2 x 4 warps of
// 64 x 32 take the same time). K is walked in steps of 32:
// every thread loads its 4 float4s of A's 128 x 32 and 4 of B's 32 x 128 by
// plain synchronous loads (masked at the edges: zeros add nothing), splits
// them in registers, stores the four bf16 planes to padded shared memory;
// a barrier; the warps read their fragments by ldmatrix (A) and
// ldmatrix.trans (B, N-major as it lies) and issue the three products a
// fragment pair; a barrier. No copy is in flight during the products, so
// only the other warps of the SM hide a load's latency. The TPU kernel's
// full-K strips cannot be copied: a 128-wide strip of A and of B at K =
// 4,096 is 4 MB, and a Hopper block has 227 KB of shared memory. The
// wrapper pads K and B's rows to multiples of 4 values (ops/mn_tile.py).
#include "bf16x3_mma.cuh"

namespace {

using htog::x3::BK;
using Rung02 = htog::x3::Tile<128, 4, 2>;

__global__ void __launch_bounds__(Rung02::THREADS, 1)
    fp32_gemm_mn_tile_kernel(const float* a, const float* b, const float* c,
                             float* out, int M, int N, int K, int lda,
                             int ldb, int ldc) {
  using namespace htog::x3;
  constexpr int PER = Rung02::CHUNKS / Rung02::THREADS;
  __shared__ Planes<Rung02> pl;
  const Operands op{a, b, M, N, K, lda, ldb,
                    static_cast<int>(blockIdx.y) * Rung02::BM,
                    static_cast<int>(blockIdx.x) * Rung02::BM};
  Sums<Rung02> s;
  s.init(op.m0, op.n0);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int nk = (K + BK - 1) / BK;
  for (int kt = 0; kt < nk; s.promote()) {
    for (const int end = min(nk, kt + partial_steps(nk)); kt < end; ++kt) {
      const int k0 = kt * BK;
      float4 va[PER], vb[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        int r, q;
        a_chunk<Rung02>(i, r, q);
        va[i] = op.a_valid(r, k0, q)
                    ? *reinterpret_cast<const float4*>(op.a_at(r, k0, q))
                    : zero;
        b_chunk<Rung02>(i, r, q);
        vb[i] = op.b_valid(r, k0, q)
                    ? *reinterpret_cast<const float4*>(op.b_at(r, k0, q))
                    : zero;
      }
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        store_a(pl, i, va[i]);
        store_b(pl, i, vb[i]);
      }
      __syncthreads();
      s.step_planes(pl);
      __syncthreads();
    }
  }
  s.store(out, c, M, N, ldc);
}

}  // namespace

// a (M, lda) fp32 with K <= lda; b (K, ldb) fp32 with N <= ldb; K, lda and
// ldb multiples of 4, bases 16-byte aligned; c, out (M, ldc) fp32, two
// buffers. Returns cudaGetLastError() after the launch.
extern "C" int fp32_gemm_mn_tile(const void* a, const void* b,
                                 const void* c, void* out, int M, int N,
                                 int K, int lda, int ldb, int ldc,
                                 void* stream) {
  constexpr int bm = Rung02::BM;
  dim3 grid((N + bm - 1) / bm, (M + bm - 1) / bm);
  fp32_gemm_mn_tile_kernel<<<grid, Rung02::THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<float*>(out), M, N, K, lda,
      ldb, ldc);
  return static_cast<int>(cudaGetLastError());
}
