// fp32_gemm_mn_tile: out = A @ B + C in fp32, one C tile a block: rung 02.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_mn_tile.py, _kernel (via
// mmult): a (M/128, N/128) grid, each program one (128, 128) C tile from a
// (128, K) strip of A and a (K, 128) strip of B held whole in VMEM, one
// dot at Precision.HIGHEST, then + C. A (M, K) and B (K, N) fp32,
// row-major, C (M, N) fp32 read, out (M, N) fp32 written. The accumulator
// starts at 0 and C is added once at the end, as the reference's
// jnp.dot(...) + c_ref does.
//
// Bound on an H100 SXM at M = N = K = 4096: 1.37e11 operations; three
// bf16 products of split operands at 989/3 TFLOP/s, 0.417 ms, are the
// fastest route that meets the rung's gate (1e-4); FFMA's ceiling is 67
// TFLOP/s, 2.05 ms. Traffic (268 MB once) takes 0.080 ms at 3.35 TB/s.
// This kernel reads two floats from shared memory for every FMA, so
// shared-memory bandwidth sets its pace.
//
// Design: the tutorial's first shared-memory kernel (MMult_cuda_3/4): a
// block of 32 x 32 threads (1,024) owns a 32 x 32 C tile, one output a
// thread, no register blocking. K is walked in tiles of 32: each thread
// stages one A and one B value by a plain load, a barrier, 32 fmaf from
// shared memory, a barrier. A warp is one row of the tile: its A reads are
// broadcasts and its B reads 32 consecutive words, both free of bank
// conflicts. The TPU kernel's full-K strips cannot be copied: a 128-wide
// strip of A and of B at K = 4,096 is 4 MB, and a Hopper block has 227 KB
// of shared memory, so K is walked in tiles here.
#include <cuda_runtime.h>

namespace {

constexpr int T = 32;  // tile edge: threads along M and N, K step

__global__ void __launch_bounds__(T * T)
    fp32_gemm_mn_tile_kernel(const float* a, const float* b, const float* c,
                             float* out, int M, int N, int K, int lda,
                             int ldb, int ldc) {
  __shared__ float sa[T][T];  // [row][k]
  __shared__ float sb[T][T];  // [k][col]
  int tx = threadIdx.x;
  int ty = threadIdx.y;
  int row = blockIdx.y * T + ty;
  int col = blockIdx.x * T + tx;
  float acc = 0.0f;
  for (int k0 = 0; k0 < K; k0 += T) {
    // out-of-range elements are zeros: they add nothing to a sum
    sa[ty][tx] = row < M && k0 + tx < K ? a[(size_t)row * lda + k0 + tx]
                                        : 0.0f;
    sb[ty][tx] = k0 + ty < K && col < N ? b[(size_t)(k0 + ty) * ldb + col]
                                        : 0.0f;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < T; ++k) acc = fmaf(sa[ty][k], sb[k][tx], acc);
    __syncthreads();
  }
  if (row < M && col < N) {
    size_t idx = (size_t)row * ldc + col;
    out[idx] = __fadd_rn(acc, c[idx]);
  }
}

}  // namespace

// a (M, lda) fp32 with K <= lda; b (K, ldb) fp32 with N <= ldb; c, out
// (M, ldc) fp32. Returns cudaGetLastError() after the launch.
extern "C" int fp32_gemm_mn_tile(const void* a, const void* b,
                                 const void* c, void* out, int M, int N,
                                 int K, int lda, int ldb, int ldc,
                                 void* stream) {
  dim3 grid((N + T - 1) / T, (M + T - 1) / T);
  fp32_gemm_mn_tile_kernel<<<grid, dim3(T, T), 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<float*>(out), M, N, K, lda,
      ldb, ldc);
  return static_cast<int>(cudaGetLastError());
}
