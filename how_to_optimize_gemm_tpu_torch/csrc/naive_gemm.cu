// naive_gemm: out = C + A @ B in fp32, one thread per output: rung 00, the
// floor the ladder climbs from.
//
// Replaces: how_to_optimize_gemm_tpu/ops/naive_vpu.py, mmult (array code,
// no Pallas: K rank-1 updates C += outer(A[:, p], B[p, :]) on the TPU's
// vector unit, its matrix unit idle). A (M, K) and B (K, N) fp32,
// row-major, C (M, N) fp32 read, out (M, N) fp32 written. The accumulator
// starts at C, as the reference's loop carry does.
//
// Bound on an H100 SXM at M = N = K = 4096: 1.37e11 operations; the
// fastest route that meets the rung's gate (1e-4) is three bf16 products
// of split operands at 989/3 TFLOP/s, 0.417 ms; FFMA's ceiling is 67
// TFLOP/s, 2.05 ms. Traffic (268 MB once, 0.080 ms at 3.35 TB/s) does not
// bound it. This kernel is bound by neither: it reads two floats from
// global memory (L1/L2) for every FMA, so the load units, not the
// arithmetic, set its pace.
//
// Design: the tutorial's naive kernel (MMult_cuda_1/2): one thread per
// output element, its own fmaf chain over K started at C, A and B read
// straight from global memory, no shared memory, no tensor cores. A block
// is 32 x 8 threads; the 32 lanes of a warp take 32 consecutive columns
// of one row, so each B read of a warp is one coalesced 128-byte line and
// each A read one broadcast. No row pitch alignment is needed.
#include <cuda_runtime.h>

namespace {

constexpr int NX = 32;  // threads of a block along N: one warp
constexpr int NY = 8;   // along M

__global__ void __launch_bounds__(NX * NY)
    naive_gemm_kernel(const float* a, const float* b, const float* c,
                      float* out, int M, int N, int K, int lda, int ldb,
                      int ldc) {
  int col = blockIdx.x * NX + threadIdx.x;
  int row = blockIdx.y * NY + threadIdx.y;
  if (row >= M || col >= N) return;
  size_t idx = (size_t)row * ldc + col;
  const float* arow = a + (size_t)row * lda;
  const float* bcol = b + col;
  float acc = c[idx];
  for (int p = 0; p < K; ++p) {
    acc = fmaf(arow[p], bcol[(size_t)p * ldb], acc);
  }
  out[idx] = acc;
}

}  // namespace

// a (M, lda) fp32 with K <= lda; b (K, ldb) fp32 with N <= ldb; c, out
// (M, ldc) fp32. Returns cudaGetLastError() after the launch.
extern "C" int naive_gemm(const void* a, const void* b, const void* c,
                          void* out, int M, int N, int K, int lda, int ldb,
                          int ldc, void* stream) {
  dim3 grid((N + NX - 1) / NX, (M + NY - 1) / NY);
  naive_gemm_kernel<<<grid, dim3(NX, NY), 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<float*>(out), M, N, K, lda,
      ldb, ldc);
  return static_cast<int>(cudaGetLastError());
}
