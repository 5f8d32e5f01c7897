// Shared pieces of the flash attention kernels. For the dQ kernel
// (flash_attention_bwd_dq.cu): bf16 tiles staged in shared memory with rows
// padded by 16 bytes (so the 8 rows of an ldmatrix hit 32 distinct banks),
// mma.sync.m16n8k16 bf16 -> fp32 and its fragments. For every kernel that
// splits an fp32 operand (the backward kernels, the training forward's
// flash_wgmma.cuh, split_bf16.cu): split_pack.
//
// Operands that the reference keeps in fp32 are split for the bf16 tensor
// cores into hi = bf16(x) and lo = bf16(x - hi): hi + lo carries 16 of x's 24
// mantissa bits (|x - hi - lo| <= 2^-17 |x|), and a product takes two MMAs.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = threadIdx.x % 32):
// accumulator c[4]: rows lane/4 (e = 0, 1) and lane/4 + 8 (e = 2, 3), columns
// 2 * (lane % 4) + (e % 2); an accumulator tile of 16 rows and 16 * n columns,
// held as c[2n][4], is the A fragment of the next product as it stands
// (acc_to_a_split).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "int8_mma.cuh"

namespace htog {
namespace fa {

using bf16 = __nv_bfloat16;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p,
                                            bool trans) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if (trans) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The pair (x0, x1) as bf16 pairs hi = bf16(x) and lo = bf16(x - hi).
__device__ __forceinline__ void split_pack(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l =
      __floats2bfloat162_rn(__fsub_rn(x0, hf.x), __fsub_rn(x1, hf.y));
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// A fragment of columns 16 kk .. 16 kk + 15 of an accumulator tile, split
// into bf16 hi and lo fragments.
template <int NT>
__device__ __forceinline__ void acc_to_a_split(float (&c)[NT][4], int kk,
                                               uint32_t (&hi)[4],
                                               uint32_t (&lo)[4]) {
  split_pack(c[2 * kk][0], c[2 * kk][1], hi[0], lo[0]);
  split_pack(c[2 * kk][2], c[2 * kk][3], hi[1], lo[1]);
  split_pack(c[2 * kk + 1][0], c[2 * kk + 1][1], hi[2], lo[2]);
  split_pack(c[2 * kk + 1][2], c[2 * kk + 1][3], hi[3], lo[3]);
}

// A fragment (rows row0 .. row0 + 15, columns k0 .. k0 + 15) of a tile stored
// [row][k].
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], bf16 (*t)[LD],
                                       int row0, int k0) {
  int lane = threadIdx.x & 31;
  ldmatrix_x4(a, &t[row0 + (lane & 15)][k0 + (lane >> 4) * 8], false);
}

// B fragments of two 8-column tiles n0 .. n0 + 15 (b[0], b[1]: the first;
// b[2], b[3]: the second) at depth k0 .. k0 + 15, of a tile stored [n][k]
// (the product's B^T row-major: K in Q K^T).
template <int LD>
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], bf16 (*t)[LD],
                                       int n0, int k0) {
  int lane = threadIdx.x & 31;
  ldmatrix_x4(b, &t[n0 + (lane & 7) + (lane >> 4) * 8]
                   [k0 + ((lane >> 3) & 1) * 8],
              false);
}

// The same for a tile stored [k][n] (B row-major: V in P V).
template <int LD>
__device__ __forceinline__ void frag_bt(uint32_t (&b)[4], bf16 (*t)[LD],
                                        int k0, int n0) {
  int lane = threadIdx.x & 31;
  ldmatrix_x4(b, &t[k0 + (lane & 7) + ((lane >> 3) & 1) * 8]
                   [n0 + (lane >> 4) * 8],
              true);
}

// ROWS rows x D bf16 of a matrix whose row r starts at base + r * stride,
// from row row0 on, copied with cp.async; rows at or past n are zero-filled.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(bf16 (*dst)[D + 8], const bf16* base,
                                          long long stride, int row0, int n) {
  constexpr int CHUNKS = D / 8;   // 16-byte chunks of a row
  static_assert(ROWS * CHUNKS % THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < ROWS * CHUNKS / THREADS; ++i) {
    int c = threadIdx.x + i * THREADS;
    int r = c / CHUNKS;
    int col = (c % CHUNKS) * 8;
    int gr = row0 + r;
    bool valid = gr < n;
    const bf16* p = valid ? base + gr * stride + col : base;
    cp_async16(&dst[r][col], p, valid);
  }
}

// ROWS rows x D fp32 of a matrix (as load_rows), each value times scale in
// fp32, split into the bf16 tiles hi and lo; plain loads and stores, rows at
// or past n zero.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_split_rows(bf16 (*hi)[D + 8],
                                                bf16 (*lo)[D + 8],
                                                const float* base,
                                                long long stride, int row0,
                                                int n, float scale) {
  constexpr int CHUNKS = D / 4;   // float4 chunks of a row
  for (int c = threadIdx.x; c < ROWS * CHUNKS; c += THREADS) {
    int r = c / CHUNKS;
    int col = (c % CHUNKS) * 4;
    int gr = row0 + r;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (gr < n) x = *reinterpret_cast<const float4*>(base + gr * stride + col);
    uint32_t h0, l0, h1, l1;
    split_pack(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale), h0, l0);
    split_pack(__fmul_rn(x.z, scale), __fmul_rn(x.w, scale), h1, l1);
    *reinterpret_cast<uint2*>(&hi[r][col]) = make_uint2(h0, h1);
    *reinterpret_cast<uint2*>(&lo[r][col]) = make_uint2(l0, l1);
  }
}

}  // namespace fa
}  // namespace htog
