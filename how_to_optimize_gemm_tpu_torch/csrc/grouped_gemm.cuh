// The tile walk of the grouped GEMM's transposed dx product
// (grouped_gemm_t.cu; its order of tiles, tile_of_block, also the
// forward's in grouped_gemm.cu): one 128 x 128 tile of
//     out[m0.., n0..] = split(A[m0.., :K]) . B_e[:K, n0..]
// where A (Tp, K) fp32 rows are expert-sorted, a 128-row tile lies in one
// bt-row block of the layout (bt a multiple of 128), so one expert e serves
// the whole tile, and B_e is that expert's stack, given by a policy that
// stages 32 K values x 128 columns as bf16, K-major (KMajorFrags' layout).
//
// A is fp32 and not exact in bf16, so it is split into hi = bf16(a) and
// lo = bf16(a - hi) (flash_common.cuh's split_pack) as its fragments are
// read, and each product takes two mma.sync.m16n8k16 bf16 -> fp32: the
// fp32 product to about 2^-17 relative. Every stack value the policies
// stage (bf16, int8, int4) is exact in bf16. 256 threads (8 warps of
// 64 x 32), K in steps of 32 values, two stages; A by cp.async (row pitch
// 40 floats: the float2 fragment reads of a half warp hit 32 distinct
// banks), the stack through registers, loaded before the MMAs of the
// stage in flight and stored after them.
//
// A policy B provides: a Regs type; load(Regs&, k0, n0) const, reading K
// values k0 .. k0 + 31 of columns n0 .. n0 + 127 (zeros outside the
// stack); store(int8_t (*)[LDS], const Regs&), writing them as bf16 at byte
// 2 (k - k0) of row n - n0.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "bf16_gemm.cuh"
#include "flash_common.cuh"

namespace htog {
namespace gg {

constexpr int KV = 32;        // K values per stage
constexpr int LDX = KV + 8;   // fp32 row pitch of the A stage
constexpr int GROUP_M = 8;    // row tiles per group of the tile walk

struct Smem {
  float x[2][BM][LDX];
  int8_t w[2][BN][LDS];       // 32 bf16 K values a column, K-major
};

// 128 rows x 32 fp32 K values of A from (m0, k0): 1,024 chunks of 16
// bytes, four a thread. A's columns from K up to lda (a multiple of 4) are
// zeros (the wrapper pads them); chunks from K on are zero-filled.
__device__ __forceinline__ void load_x(float (*dst)[LDX], const float* x,
                                       int m0, int k0, int K, int ldx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int chunk = threadIdx.x + i * THREADS;
    int r = chunk >> 3;
    int kc = (chunk & 7) * 4;
    bool valid = k0 + kc < K;
    const float* p = valid ? x + (size_t)(m0 + r) * ldx + k0 + kc : x;
    cp_async16(&dst[r][kc], p, valid);
  }
}

// The A fragment of rows r, r + 8 and K values kk .. kk + 15 of the A
// stage, split into bf16 hi and lo.
__device__ __forceinline__ void x_frags(const float (*xs)[LDX], int r,
                                        int kk, int t, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  float2 v[4] = {*reinterpret_cast<const float2*>(&xs[r][kk + 2 * t]),
                 *reinterpret_cast<const float2*>(&xs[r + 8][kk + 2 * t]),
                 *reinterpret_cast<const float2*>(&xs[r][kk + 8 + 2 * t]),
                 *reinterpret_cast<const float2*>(&xs[r + 8][kk + 8 + 2 * t])};
#pragma unroll
  for (int j = 0; j < 4; ++j) fa::split_pack(v[j].x, v[j].y, hi[j], lo[j]);
}

// (row tile, column tile) of tile `bid` of an M x N output: groups of
// GROUP_M row tiles, the row tile fastest inside a group, so the blocks
// running at once share one expert's stack columns and a few A tiles in L2.
__device__ __forceinline__ void tile_of_block(int bid, int M, int N,
                                              int& m0, int& n0) {
  int num_m = (M + BM - 1) / BM;
  int num_n = (N + BN - 1) / BN;
  int per_group = GROUP_M * num_n;
  int first_m = (bid / per_group) * GROUP_M;
  int gm = min(num_m - first_m, GROUP_M);
  int in_group = bid % per_group;
  m0 = (first_m + in_group % gm) * BM;
  n0 = (in_group / gm) * BN;
}

// The tile of this block of the (Tp, N) output.
__device__ __forceinline__ void tile_of_block(int Tp, int N, int& m0,
                                              int& n0) {
  tile_of_block(blockIdx.x, Tp, N, m0, n0);
}

// acc += split(A[m0 .. m0 + 127, :K]) . B[:K, n0 .. n0 + 127].
template <class B>
__device__ __forceinline__ void split_mma_tile(float (&acc)[4][4][4],
                                               Smem& sm, const float* x,
                                               int m0, int K, int ldx,
                                               const B& b, int n0) {
  int warp = threadIdx.x >> 5;
  int lane = threadIdx.x & 31;
  int wm = warp >> 2;
  int wn = warp & 3;
  int g = lane >> 2;
  int t = lane & 3;
  typename B::Regs breg;
  int nk = (K + KV - 1) / KV;
  load_x(sm.x[0], x, m0, 0, K, ldx);
  cp_async_commit();
  b.load(breg, 0, n0);
  B::store(sm.w[0], breg);
  cp_async_wait_all();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    int st = kt & 1;
    bool more = kt + 1 < nk;
    if (more) {
      load_x(sm.x[st ^ 1], x, m0, (kt + 1) * KV, K, ldx);
      cp_async_commit();
      b.load(breg, (kt + 1) * KV, n0);
    }
    KMajorFrags bfr{sm.w[st]};
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t bf[4][2];
      bfr(bf, ks * 32, wn, lane);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        uint32_t hi[4], lo[4];
        x_frags(sm.x[st], wm * 64 + mi * 16 + g, ks * 16, t, hi, lo);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          MmaBf16::mma(acc[mi][ni], hi, bf[ni]);
          MmaBf16::mma(acc[mi][ni], lo, bf[ni]);
        }
      }
    }
    if (more) B::store(sm.w[st ^ 1], breg);
    cp_async_wait_all();
    __syncthreads();
  }
}

}  // namespace gg
}  // namespace htog
