// grouped_dw: the dW of the grouped GEMM's backward, a segment sum of the
// per-block outer products over each expert's rows:
//     dW[e] = sum over the blocks i with be[i] = e of x_i^T dy_i
// for the expert-sorted rows x (Tp, d) and dy (Tp, f) fp32 in bt-row
// blocks, be the sorted block -> expert map; dW (E, d, f) fp32. An expert
// with no block gets zeros.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_grouped_gemm.py,
// _dw_kernel :255 (_grouped_dw :277, pl.pallas_call :297). The TPU kernel
// runs its grid in order, token blocks innermost, and adds each block's
// product into an output tile that stays resident across the consecutive
// blocks of one expert (the first block writes it). Hopper runs its blocks
// in parallel and in no order, so that design does not carry over: here
// each block of threads owns one (expert, 128-row d tile, 128-column f
// tile) of dW and walks that expert's rows itself, in order, and writes the
// tile once. No atomics and no second pass, so the result does not depend
// on the schedule (training's resume stays bit-exact).
//
// The expert's rows are one contiguous range: be is sorted (the layout's
// experts in order), so expert e owns the blocks [lower_bound(be, e),
// lower_bound(be, e + 1)), found by a binary search over be; the range's
// x rows are A given transposed (K = the rows, M = d, d contiguous) and its
// dy rows B (K, N = f), both staged as they lie.
//
// Bound on an H100 SXM at Mixtral-8x7B's prefill (8,192 routed rows, Tp =
// 9,216), w_gate's dW (8 experts of 4,096 x 14,336): 2 x 8,192 x 4,096 x
// 14,336 = 0.962 TFLOP, the forward's. Both operands are fp32, which the
// bf16 tensor cores cannot take whole; the fastest route at fp32 accuracy
// is a 3xTF32 split at a third of the 495 TFLOP/s TF32 peak: 5.83 ms,
// against ~2.6 GB of traffic (x 151 MB, dy 528 MB, dW 1.88 GB), 0.78 ms at
// 3.35 TB/s: the operations bound it.
//
// Design. Simple first version: fp32_gemm.cuh's FFMA main loop (full fp32,
// 67 TFLOP/s at most; 21.8 ms, 44 TFLOP/s, at the shape above on an H100)
// with A given transposed (its kAT form): one 128 x 128 tile per block of 256 threads,
// 8 x 8 outputs a thread, each one fmaf chain over the expert's rows in
// order; K in steps of 16 rows, two cp.async stages. Against the plain
// version (one cuBLAS fp32 product over the expert's rows, TF32 off) it
// read equal on an H100 at Mixtral's shapes: cuBLAS's fp32 SIMT kernel
// also chains each output's fmaf over the rows in order; a sum in another
// order would differ by about 1e-6 relative over a few thousand rows. Not
// yet: the tensor cores (three bf16 products hi.hi + hi.lo + lo.hi, or
// 3xTF32), and balancing the load of experts with many rows against
// experts with few.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fp32_gemm.cuh"

namespace htog {

// First index i of the sorted be[0 .. nb) with be[i] >= e.
__device__ __forceinline__ int lower_bound(const int* be, int nb, int e) {
  int lo = 0;
  int hi = nb;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (be[mid] < e) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
    grouped_dw_ffma(const float* x, const float* dy, const int* be,
                    float* out, int nb, int M, int N, int ldx, int ldy,
                    int bt) {
  int n0 = blockIdx.x * FBN;
  int m0 = blockIdx.y * FBM;
  int e = blockIdx.z;
  int first = lower_bound(be, nb, e) * bt;
  int rows = lower_bound(be, nb, e + 1) * bt - first;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  fp32_gemm_mainloop<false, true>(acc, x + (size_t)first * ldx,
                                  dy + (size_t)first * ldy, M, N, rows, ldx,
                                  ldy, m0, n0);
  float* oe = out + (size_t)e * M * N;
  int tx = threadIdx.x & 15;
  int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int row = m0 + ftile(ty, i);
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int col = n0 + ftile(tx, j);
      if (col < N) oe[(size_t)row * N + col] = acc[i][j];
    }
  }
}

}  // namespace htog

// x (nb * bt, ldx) and dy (nb * bt, ldy) fp32, ldx >= M and ldy >= N
// multiples of 4; block_expert (nb,) int32, sorted; out (E, M, N) fp32.
// Bases 16-byte aligned. Returns cudaGetLastError() after the launch.
extern "C" int grouped_dw(const void* x, const void* dy,
                          const void* block_expert, void* out, int nb,
                          int M, int N, int E, int ldx, int ldy, int bt,
                          void* stream) {
  using namespace htog;
  dim3 grid((N + FBN - 1) / FBN, (M + FBM - 1) / FBM, E);
  grouped_dw_ffma<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy),
      static_cast<const int*>(block_expert), static_cast<float*>(out), nb, M,
      N, ldx, ldy, bt);
  return static_cast<int>(cudaGetLastError());
}
