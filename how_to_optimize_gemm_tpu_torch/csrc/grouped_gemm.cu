// grouped_gemm: the ragged (grouped) GEMM of the MoE expert FFN, forward:
//     y[i*bt:(i+1)*bt] = (x[i*bt:(i+1)*bt] @ W[be[i]]) (* s[be[i], 0, :])
// for every bt-row block i of the expert-sorted rows x (Tp, d) fp32, W an
// (E, d, f) expert stack and be the block -> expert map; y (Tp, f) fp32.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_grouped_gemm.py,
// _kernel :71 (int8 stack + scales), _kernel_noscale :83 (bf16 and fp32
// stacks), _kernel_q4 :87 (packed int4 stack + scales) and
// _kernel_q4_noscale :104 (the backward's unscaled recompute), all
// launched by _gmm_call :108 (pl.pallas_call :141). The TPU reads be by
// scalar prefetch in the weight BlockSpec's index map; here each block
// reads be[row0 / bt] itself and addresses that expert's stack.
//
// Stack kinds (the `kind` argument), each with or without the per-column
// scale epilogue (s null: none):
//   0 bf16 (E, d, f);  1 int8 (E, d, f);  2 packed int4 (E, d/2, f), two
//   weights a byte packed with block_k = d (ops/quant.pack_int4 over the
//   whole contraction): K rows [0, d/2) in the low nibbles, offset binary
//   (b & 0xF) - 8, rows [d/2, d) in the high nibbles, two's complement --
//   not the 512-row pack blocks of the int4 linears (w4a8.cuh);
//   3 fp32 (E, d, f).
//
// Bound on an H100 SXM at Mixtral-8x7B's prefill (T = 4,096 tokens, top-2:
// 8,192 routed rows, Tp = 9,216), w_gate d 4,096 -> f 14,336 on an int8
// stack: 2 x 8,192 x 4,096 x 14,336 = 0.962 TFLOP, 0.973 ms at the 989
// TFLOP/s bf16 peak, against 1.15 GB of traffic (stack 470 MB, x 151 MB, y
// 528 MB), 0.34 ms at 3.35 TB/s: the tensor cores bound it. This design
// takes two bf16 products a tile, so its own floor is 1.95 ms.
//
// Design, kinds 0-2: grouped_gemm.cuh's wgmma kernel, its forward form
// (B, the expert's (K, N) stack tile as it lies, MN-major). Every stack
// value is exact in bf16 (bf16 values, int8 in [-128, 127], nibbles in
// [-8, 7]) but x is fp32. The wrapper splits x once into hi = bf16(x) and
// lo = bf16(x - hi) (split_bf16.cu, a kernel of its own: |x - hi - lo| <=
// 2^-17 |x|; one more read and write of x, ~0.1 ms at (9,216, 4,096), and
// 4 bytes an element of scratch: 1.9 GB at S-moe's w_out, Tp ~33.8k x
// 14,336). A pre-pass, not a split in registers, because it keeps both
// wgmma operands in shared memory, where the tensor-map copies put them,
// and dx and dW (grouped_gemm_t.cu, grouped_dw.cu) need the same split of
// dy. Each 128 x 128 output tile takes two wgmma products a K step, hi . B
// and lo . B, fp32 sums promoted to fp32 registers every 1,024 K.
// On an H100 at the shape above (chip_smoke.py): int8 4.6 ms, int4 4.6,
// bf16 3.8, the pre-pass included, against 8.7, 9.3 and 9.2 for the
// mma.sync kernel before it; error ~3e-6 of max |plain| at both K. A stage
// moves 48 KB (bf16) or 40 KB (int8) from L2 into the block, so the L2's
// rate, and for int8 and int4 the decode, set the time.
// Tried on an H100 at the shape above and dropped, each slower: the
// decode done by the consumers themselves between their wgmma issues;
// 128 x 256 tiles (only two stages fit); x's tiles multicast to a 2-block
// cluster. Summing without the fp32 promotion took the same time at
// several times the error.
// The scales multiply in the epilogue. Kind 3 (fp32 stacks, not exact in
// bf16) runs fp32_gemm.cuh's FFMA main loop on the expert's stack instead,
// full fp32, on the same tile walk.
#include <cuda_bf16.h>
#include <stdint.h>

#include "fp32_gemm.cuh"
#include "grouped_gemm.cuh"

namespace htog {
namespace gg {

// Kind 3: fp32 stacks on fp32_gemm.cuh's FFMA main loop.
__global__ void __launch_bounds__(THREADS)
    grouped_gemm_ffma(const float* x, const float* w, const int* be,
                      const float* s, float* out, int Tp, int N, int K,
                      int ldx, int ldw, int bt) {
  int m0, n0;
  tile_of_block(blockIdx.x, Tp, N, m0, n0);
  int e = be[m0 / bt];
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  fp32_gemm_mainloop<false>(acc, x, w + (size_t)e * K * ldw, Tp, N, K, ldx,
                            ldw, m0, n0);
  const float* se = s == nullptr ? nullptr : s + (size_t)e * N;
  int tx = threadIdx.x & 15;
  int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int row = m0 + ftile(ty, i);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int col = n0 + ftile(tx, j);
      if (col >= N) continue;
      out[(size_t)row * N + col] =
          se == nullptr ? acc[i][j] : __fmul_rn(acc[i][j], se[col]);
    }
  }
}

}  // namespace gg
}  // namespace htog

// Kinds 0-2: a is x split, (2, Tp, lda) bf16 (hi then lo; split_bf16.cu),
// lda a multiple of 8; kind 3: a is x (Tp, lda) fp32, lda a multiple of 4
// with zero columns from K to lda. Tp a multiple of bt and bt of 128; K
// even for kind 2; w the stack, (E, K, ldw) or for kind 2 (E, K/2, ldw),
// ldw >= N with rows of a multiple of 16 bytes (kind 3: of 4 floats), E
// experts; block_expert (Tp / bt,) int32 in [0, E); s (E, 1, N) fp32 or
// null; out (Tp, N) fp32. Bases 16-byte aligned. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unknown kind or a tensor map the driver refuses).
extern "C" int grouped_gemm(const void* a, const void* w,
                            const void* block_expert, const void* s,
                            void* out, int Tp, int N, int K, int lda,
                            int ldw, int bt, int E, int kind,
                            void* stream) {
  using namespace htog;
  int blocks = (Tp / BM) * ((N + BN - 1) / BN);
  auto be = static_cast<const int*>(block_expert);
  auto sf = static_cast<const float*>(s);
  auto of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      return gg::launch_wgmma<0, false>(a, w, be, sf, of, Tp, N, K, lda,
                                        ldw, bt, E, st);
    case 1:
      return gg::launch_wgmma<1, false>(a, w, be, sf, of, Tp, N, K, lda,
                                        ldw, bt, E, st);
    case 2:
      return gg::launch_wgmma<2, false>(a, w, be, sf, of, Tp, N, K, lda,
                                        ldw, bt, E, st);
    case 3:
      gg::grouped_gemm_ffma<<<blocks, THREADS, 0, st>>>(
          static_cast<const float*>(a), static_cast<const float*>(w), be, sf,
          of, Tp, N, K, lda, ldw, bt);
      return static_cast<int>(cudaGetLastError());
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
