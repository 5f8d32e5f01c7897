// fp32_gemm_k_blocked: out = C + A @ B in fp32, register-blocked with K
// staged through shared memory: rungs 03 (128 x 128 blocks) and 03b
// (64 x 64).
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_k_blocked.py, _kernel (via
// mmult): a (M/bm, N/bn, K/bk) grid with K innermost and an fp32 VMEM
// scratch accumulator that is set to C at the first K step and flushed to
// the output at the last; bm = bn = bk = 256 for rung 03, 128 for 03b
// (the reference's documented regression). A (M, K) and B (K, N) fp32,
// row-major, C (M, N) fp32 read, out (M, N) fp32 written.
//
// Bound on an H100 SXM at M = N = K = 4096: 1.37e11 operations; three
// bf16 products of split operands at 989/3 TFLOP/s, 0.417 ms, are the
// fastest route that meets the rungs' gate (1e-4); FFMA's ceiling is 67
// TFLOP/s, 2.05 ms. Traffic (268 MB once) takes 0.080 ms at 3.35 TB/s:
// the arithmetic bounds it.
//
// Design: the tutorial's register-blocked SGEMM (MMult_cuda_9), one step
// below fp32_gemm.cuh's FFMA main loop (rung 04's kernel until it moved to
// bf16 products of split operands). A block owns a BM x BM C tile
// and each thread an 8 x 8 micro-tile of it (rows ty*8 .. +7, columns
// tx*8 .. +7), held in registers and seeded with C before the first K
// step. K is walked in steps of 8: the block loads A's BM x 8 and B's
// 8 x BM by plain synchronous 16-byte loads (A transposed to [k][m] on its
// way into shared memory, B as it lies), a barrier, 8 x 64 fmaf per
// thread from float4 reads of shared memory, a barrier. One stage, no
// cp.async: fp32_gemm.cuh adds those. The TPU's sequential K grid dimension
// becomes this loop inside the block; its scratch accumulator, the
// registers. The two rungs are one template at two block edges:
//   BM = 128  rung 03, 256 threads;
//   BM =  64  rung 03b, half the edge, 64 threads: the same work per
//             thread, half the reuse of each staged tile.
// Each output is one fmaf chain over k, started at C. Needs K, lda and ldb
// multiples of 4 and 16-byte aligned bases (the wrapper pads).
#include <cuda_runtime.h>

namespace {

constexpr int BK = 8;  // K step
constexpr int TM = 8;  // micro-tile edge (rows and columns a thread)

template <int BM>
__global__ void __launch_bounds__((BM / TM) * (BM / TM))
    fp32_gemm_k_blocked_kernel(const float* a, const float* b,
                               const float* c, float* out, int M, int N,
                               int K, int lda, int ldb, int ldc) {
  constexpr int TX = BM / TM;          // threads along N (and along M)
  constexpr int THREADS = TX * TX;
  constexpr int QK = BK / 4;           // float4 chunks in one A row step
  constexpr int QN = BM / 4;           // float4 chunks in one B row
  static_assert(BM * QK % THREADS == 0 && BK * QN % THREADS == 0,
                "every thread stages the same number of chunks");
  __shared__ __align__(16) float sa[BK][BM];  // A transposed: [k][m]
  __shared__ __align__(16) float sb[BK][BM];  // B as it lies: [k][n]
  int tid = threadIdx.x;
  int tx = tid % TX;
  int ty = tid / TX;
  int m0 = blockIdx.y * BM;
  int n0 = blockIdx.x * BM;
  float acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    int row = m0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      int col = n0 + tx * TM + j;
      acc[i][j] = row < M && col < N ? c[(size_t)row * ldc + col] : 0.0f;
    }
  }
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int k0 = 0; k0 < K; k0 += BK) {
    // out-of-range chunks are zeros: they add nothing to a sum
#pragma unroll
    for (int i = 0; i < BM * QK / THREADS; ++i) {
      int q = tid + i * THREADS;
      int r = q / QK;
      int kq = (q % QK) * 4;
      int gr = m0 + r;
      int gk = k0 + kq;
      float4 v = gr < M && gk < K
                     ? *reinterpret_cast<const float4*>(
                           a + (size_t)gr * lda + gk)
                     : zero;
      sa[kq][r] = v.x;
      sa[kq + 1][r] = v.y;
      sa[kq + 2][r] = v.z;
      sa[kq + 3][r] = v.w;
    }
#pragma unroll
    for (int i = 0; i < BK * QN / THREADS; ++i) {
      int q = tid + i * THREADS;
      int kr = q / QN;
      int cn = (q % QN) * 4;
      int gk = k0 + kr;
      int gn = n0 + cn;
      *reinterpret_cast<float4*>(&sb[kr][cn]) =
          gk < K && gn < N ? *reinterpret_cast<const float4*>(
                                 b + (size_t)gk * ldb + gn)
                           : zero;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float4 a0 = *reinterpret_cast<const float4*>(&sa[k][ty * TM]);
      float4 a1 = *reinterpret_cast<const float4*>(&sa[k][ty * TM + 4]);
      float4 b0 = *reinterpret_cast<const float4*>(&sb[k][tx * TM]);
      float4 b1 = *reinterpret_cast<const float4*>(&sb[k][tx * TM + 4]);
      float av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float bv[TM] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    int row = m0 + ty * TM + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      int col = n0 + tx * TM + j;
      if (col < N) out[(size_t)row * ldc + col] = acc[i][j];
    }
  }
}

template <int BM>
int launch(const void* a, const void* b, const void* c, void* out, int M,
           int N, int K, int lda, int ldb, int ldc, cudaStream_t stream) {
  dim3 grid((N + BM - 1) / BM, (M + BM - 1) / BM);
  constexpr int threads = (BM / TM) * (BM / TM);
  fp32_gemm_k_blocked_kernel<BM><<<grid, threads, 0, stream>>>(
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
    return launch<128>(a, b, c, out, M, N, K, lda, ldb, ldc, s);
  if (block == 64)
    return launch<64>(a, b, c, out, M, N, K, lda, ldb, ldc, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
