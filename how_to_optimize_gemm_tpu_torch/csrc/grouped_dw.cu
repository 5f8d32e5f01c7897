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
// lower_bound(be, e + 1)), found by a binary search over be.
//
// Bound on an H100 SXM at Mixtral-8x7B's prefill (8,192 routed rows, Tp =
// 9,216), w_gate's dW (8 experts of 4,096 x 14,336): 2 x 8,192 x 4,096 x
// 14,336 = 0.962 TFLOP, the forward's. Both operands are fp32, which the
// bf16 tensor cores cannot take whole; three bf16 products of split
// operands meet the function's rule (FP32_REL), so the card's rate for it
// is a third of the 989 TFLOP/s bf16 peak: 2.92 ms (3xTF32, at a third of
// the 495 TFLOP/s TF32 peak, would take 5.83), against ~2.6 GB of traffic
// (x 151 MB, dy 528 MB, dW 1.88 GB), 0.78 ms at 3.35 TB/s: the operations
// bound it.
//
// Design: three bf16 products on wgmma (wgmma.cuh). The wrapper splits x
// and dy each into bf16 hi + lo (split_bf16.cu, |v - hi - lo| <= 2^-17 |v|)
// and the tile takes hi.hi + hi.lo + lo.hi, every partial product exact in
// fp32; the dropped lo.lo is below 2^-16 of each product. Its floor is
// the bound above.
// Both operands are copied as they lie, MN-major (wgmma's transposed forms,
// legal for 16-bit types): the x rows of a stage are (64 rows, 128 d) with
// d contiguous, so A = x^T is M-major; dy's (64 rows, 128 f) are an N-major
// B. A stage is 64 rows: x_hi, x_lo, dy_hi, dy_lo tiles of 16 KB by tensor
// map, three stages. The tensor cores' fp32 sum loses low bits over a long
// K (here the expert's rows: ~1,170 at Mixtral's layout, thousands under
// skew), so each consumer sums 4 stages (256 rows) in its wgmma accumulator
// and adds that into fp32 registers with ordinary adds, in the rows' order:
// a fixed order, the same bits on every run. Tiles are walked expert by
// expert, each expert's tiles as the forward walks its own (grouped_gemm.cuh's
// tile_of_block: groups of 8 d tiles, the f tile slowest inside a group), so
// the blocks running at once share rows of x and dy in L2. The block has
// the forward's shape (wgmma.cuh); dW has no stack to convert, so warps 1-3
// leave at once. Load balance across experts of different sizes: not yet (a
// heavy expert's tiles take longer; the grid's tail waits on them). On an
// H100 at the shape above (chip_smoke.py): 6.2 ms, the two splits
// included, against 22.3 for the FFMA kernel before it; error ~5e-6 of
// max |plain|.
#include <cuda_runtime.h>
#include <stdint.h>

#include "grouped_gemm.cuh"
#include "wgmma.cuh"

namespace htog {

constexpr int DW_STAGES = 3;
constexpr int DW_CH = 4;        // stages summed in wgmma before adding

// Shared memory of one stage: x_hi, x_lo, dy_hi, dy_lo, each two 64-value
// halves of (64 rows, 64 values).
struct DwStage {
  static constexpr int X_HI = 0;
  static constexpr int X_LO = wg::TILE_BYTES;
  static constexpr int DY_HI = 2 * wg::TILE_BYTES;
  static constexpr int DY_LO = 3 * wg::TILE_BYTES;
  static constexpr int BYTES = 4 * wg::TILE_BYTES;
  static constexpr int SMEM = DW_STAGES * BYTES +
                              static_cast<int>(sizeof(wg::Ring<DW_STAGES>)) +
                              wg::ATOM;
};

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

// tx: x split, the (2 Tp, M) bf16 hi/lo map; ty: dy split, (2 Tp, N); both
// in boxes of 64 rows x 64 values, swizzled.
__global__ void __launch_bounds__(wg::BLOCK, 1)
    grouped_dw_wgmma(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap ty, const int* be,
                     float* out, int nb, int M, int N, int bt) {
  constexpr int ST = DW_STAGES;
  using L = DwStage;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = wg::align_1024(smem_raw);
  auto& ring = *reinterpret_cast<wg::Ring<ST>*>(smem + ST * L::BYTES);
  // (expert, d tile, f tile) of this block: experts in order
  int per_e = ((M + wg::TILE - 1) / wg::TILE) * ((N + wg::TILE - 1) / wg::TILE);
  int e = blockIdx.x / per_e;
  int m0, n0;
  gg::tile_of_block(blockIdx.x % per_e, M, N, m0, n0);
  int Tp = nb * bt;
  int row0 = lower_bound(be, nb, e) * bt;
  int nk = (lower_bound(be, nb, e + 1) * bt - row0) / wg::KT;
  int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (warp < 4) {
    if (threadIdx.x != 0) return;
    for (int q = 0; q < nk; ++q) {
      int si = q % ST;
      uint8_t* st = smem + si * L::BYTES;
      uint64_t* full = &ring.full[si];
      int row = row0 + q * wg::KT;
      wg::wait_empty(ring, q);
      mbar_arrive_expect_tx(full, L::BYTES);
      for (int h = 0; h < 2; ++h) {
        int off = h * wg::HALF_TILE;
        wg::tma_2d(st + L::X_HI + off, &tx, m0 + 64 * h, row, full);
        wg::tma_2d(st + L::X_LO + off, &tx, m0 + 64 * h, Tp + row, full);
        wg::tma_2d(st + L::DY_HI + off, &ty, n0 + 64 * h, row, full);
        wg::tma_2d(st + L::DY_LO + off, &ty, n0 + 64 * h, Tp + row, full);
      }
    }
    return;
  }

  int cw = (warp >> 2) - 1;  // consumer warpgroup: d rows 64 cw ..
  float acc[wg::ACC], tot[wg::ACC];
  wg::zero(tot);
  uint32_t base = smem_u32(smem);
  wg::consume<ST, DW_CH>(
      ring, nk, acc,
      [&](int si, int q) { wg::wait(&ring.full[si], (q / ST) & 1); },
      [&](int si, int q, bool first) {
        uint32_t st = base + si * L::BYTES;
        uint32_t x_hi = st + L::X_HI + cw * wg::HALF_TILE;
        uint32_t x_lo = st + L::X_LO + cw * wg::HALF_TILE;
#pragma unroll
        for (int k = 0; k < wg::KT / 16; ++k) {
          uint64_t a_hi = wg::mnmajor_desc(x_hi, k);
          uint64_t b_hi = wg::mnmajor_desc(st + L::DY_HI, k);
          wg::Wgmma<128>::ss<1, 1>(acc, a_hi, b_hi,
                                   first && k == 0 ? 0 : 1);
          wg::Wgmma<128>::ss<1, 1>(acc, a_hi,
                                   wg::mnmajor_desc(st + L::DY_LO, k), 1);
          wg::Wgmma<128>::ss<1, 1>(acc, wg::mnmajor_desc(x_lo, k), b_hi,
                                   1);
        }
      },
      [&] { wg::add_into(tot, acc); });
  float* oe = out + (size_t)e * M * N;
  wg::for_each_pair(tot, m0 + 64 * cw, n0,
                    [&](float v0, float v1, int row, int col) {
                      if (row < M) wg::store_pair(oe, row, col, N, v0, v1);
                    });
}

}  // namespace htog

// x (2, nb * bt, ldx) and dy (2, nb * bt, ldy): x and dy split into bf16
// hi then lo (split_bf16.cu), ldx >= M and ldy >= N multiples of 8;
// block_expert (nb,) int32, sorted, bt a multiple of 128; out (E, M, N)
// fp32. Bases 16-byte aligned. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a tensor map the driver refuses).
extern "C" int grouped_dw(const void* x, const void* dy,
                          const void* block_expert, void* out, int nb,
                          int M, int N, int E, int ldx, int ldy, int bt,
                          void* stream) {
  using namespace htog;
  CUtensorMap tx, ty;
  if (!wg::make_split_map(&tx, x, nb * bt, M, ldx, wg::KT) ||
      !wg::make_split_map(&ty, dy, nb * bt, N, ldy, wg::KT))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncSetAttribute(grouped_dw_wgmma,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       DwStage::SMEM);
  int tiles = ((M + wg::TILE - 1) / wg::TILE) * ((N + wg::TILE - 1) / wg::TILE);
  grouped_dw_wgmma<<<tiles * E, wg::BLOCK, DwStage::SMEM,
                     static_cast<cudaStream_t>(stream)>>>(
      tx, ty, static_cast<const int*>(block_expert), static_cast<float*>(out),
      nb, M, N, bt);
  return static_cast<int>(cudaGetLastError());
}
