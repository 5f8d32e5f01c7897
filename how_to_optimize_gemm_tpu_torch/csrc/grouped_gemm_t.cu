// grouped_gemm_t, grouped_gemm_t4: the grouped GEMM's transposed product,
// the dx of the MoE expert FFN's backward:
//     dx[i*bt:(i+1)*bt] = dy[i*bt:(i+1)*bt] @ W[be[i]]^T
// for every bt-row block i of the expert-sorted rows dy (Tp, f) fp32, W an
// (E, dout, f) expert stack and be the block -> expert map; dx (Tp, dout)
// fp32. The contraction runs over the stack's last dim in place: no
// transposed copy of the stack.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_grouped_gemm.py,
// _kernel_t :152 (dense and int8 stacks, _gmm_call_t :163, pl.pallas_call
// :187) with grouped_gemm_t, and _kernel_t4 :198 (packed int4 stacks,
// _gmm_call_t4 :218, pl.pallas_call :244) with grouped_gemm_t4. The TPU
// grid reads be by scalar prefetch; here each block reads be[row0 / bt].
//
// Stack kinds of grouped_gemm_t (the `kind` argument): 0 bf16, 1 int8,
// 3 fp32 (E, dout, f). grouped_gemm_t4 takes the packed int4 stack
// (E, dout/2, f) of ops/quant.pack_int4 with block_k = dout, as the
// forward decodes it with block_k = d: output column n < dout/2 reads the
// low nibble of packed row n, (b & 0xF) - 8, and n >= dout/2 the high
// nibble of packed row n - dout/2, the arithmetic b >> 4 of the signed byte
// (the reference's int32 p >> 4 at :211) -- not the int4 linears' 512-row
// pack blocks (w4a8.cuh).
//
// Bound on an H100 SXM at Mixtral-8x7B's prefill (8,192 routed rows, Tp =
// 9,216), w_gate's dx, dy (Tp, 14,336) -> dx (Tp, 4,096): 2 x 8,192 x
// 14,336 x 4,096 = 0.962 TFLOP, the forward's, 0.973 ms at the 989 TFLOP/s
// bf16 peak, against ~1.2 GB of traffic (dy 528 MB, stack 470 MB in int8,
// dx 151 MB), 0.36 ms at 3.35 TB/s: the tensor cores bound it. This design
// takes two bf16 products a tile, so its own floor is 1.95 ms.
//
// Design, kinds 0-2: grouped_gemm.cuh's wgmma kernel, its dx form. The
// wrapper splits dy once into bf16 hi + lo (split_bf16.cu; the dense
// backward hands the same planes to dW, grouped_dw.cu), and each 128 x 128
// output tile takes two wgmma products a K step, hi . B and lo . B, fp32
// sums promoted to fp32 registers every 1,024 K. The stack's rows are the
// output columns with the contraction contiguous, so B is K-major: a bf16
// stack's 64 K x 128-column tile comes straight from its tensor map in
// A's swizzled layout, an int8 or packed stack's raw bytes (128 rows x 64
// bytes) are decoded by the converter warps into it. The mma.sync kernel
// before it (dy split in registers for every column tile, the stack staged
// through registers, two blocks an SM) took 8.9 ms on a bf16 stack, 8.6 on
// int8 and 9.1 on packed int4 at the shape above on an H100. Kind 3 (fp32
// stacks, not exact in bf16) runs fp32_gemm.cuh's FFMA main loop with B
// given transposed (its kBT form) on the expert's stack: full fp32.
#include <cuda_bf16.h>
#include <stdint.h>

#include "fp32_gemm.cuh"
#include "grouped_gemm.cuh"

namespace htog {
namespace gg {

// Kind 3: fp32 stacks, B = the expert's (N, K) stack given transposed.
__global__ void __launch_bounds__(THREADS)
    grouped_gemm_t_ffma(const float* dy, const float* w, const int* be,
                        float* out, int Tp, int N, int K, int ldx, int ldw,
                        int bt) {
  int m0, n0;
  tile_of_block(blockIdx.x, Tp, N, m0, n0);
  int e = be[m0 / bt];
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  fp32_gemm_mainloop<true>(acc, dy, w + (size_t)e * N * ldw, Tp, N, K, ldx,
                           ldw, m0, n0);
  int tx = threadIdx.x & 15;
  int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int row = m0 + ftile(ty, i);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int col = n0 + ftile(tx, j);
      if (col < N) out[(size_t)row * N + col] = acc[i][j];
    }
  }
}

}  // namespace gg
}  // namespace htog

// Kinds 0, 1: a is dy split, (2, Tp, lda) bf16 (hi then lo; split_bf16.cu),
// lda a multiple of 8; kind 3: a is dy (Tp, lda) fp32, lda a multiple of 4
// with zero columns from K to lda. Tp a multiple of bt and bt of 128; w
// the stack (E, N, ldw), ldw >= K with rows of a multiple of 16 bytes
// (kind 3: of 4 floats), E experts; block_expert (Tp / bt,) int32 in
// [0, E); out (Tp, N) fp32. Bases 16-byte aligned. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unknown kind or a tensor map the driver refuses).
extern "C" int grouped_gemm_t(const void* a, const void* w,
                              const void* block_expert, void* out, int Tp,
                              int N, int K, int lda, int ldw, int bt, int E,
                              int kind, void* stream) {
  using namespace htog;
  auto be = static_cast<const int*>(block_expert);
  auto of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      return gg::launch_wgmma<0, true>(a, w, be, nullptr, of, Tp, N, K, lda,
                                       ldw, bt, E, st);
    case 1:
      return gg::launch_wgmma<1, true>(a, w, be, nullptr, of, Tp, N, K, lda,
                                       ldw, bt, E, st);
    case 3:
      gg::grouped_gemm_t_ffma<<<(Tp / BM) * ((N + BN - 1) / BN), THREADS, 0,
                                st>>>(
          static_cast<const float*>(a), static_cast<const float*>(w), be, of,
          Tp, N, K, lda, ldw, bt);
      return static_cast<int>(cudaGetLastError());
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The same on a packed int4 stack (E, N / 2, ldw) int8 bytes, N even, ldw
// >= K a multiple of 16; a is dy split.
extern "C" int grouped_gemm_t4(const void* a, const void* w,
                               const void* block_expert, void* out, int Tp,
                               int N, int K, int lda, int ldw, int bt, int E,
                               void* stream) {
  using namespace htog;
  return gg::launch_wgmma<2, true>(a, w, static_cast<const int*>(block_expert),
                                   nullptr, static_cast<float*>(out), Tp, N, K,
                                   lda, ldw, bt, E,
                                   static_cast<cudaStream_t>(stream));
}
