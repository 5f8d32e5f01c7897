// The float ladder's rungs 02 and 03/03b on the tensor cores
// (fp32_gemm_mn_tile.cu, fp32_gemm_k_blocked.cu): fp32 operands split
// inside the kernel into bf16 hi = bf16(x) and lo = bf16(x - hi)
// (flash_common.cuh's split_pack, split_bf16.cu's arithmetic: |x - hi -
// lo| <= 2^-17 |x| for |x| >= 2^-117), three mma.sync.m16n8k16 products a
// fragment pair (hi.hi + hi.lo + lo.hi: bf16x3, XLA's Precision.HIGH) with
// fp32 sums. Every partial product is exact in fp32; the dropped lo.lo is
// below 2^-16 of each product.
//
// Sums: the tensor cores' fp32 sum over CH K steps (128 K), then that
// partial added in fp32 (round to nearest) into a second array in K's
// order. Measured on an H100 at M = N = K = 4,096, rung 03, relative to
// max |plain| (harness/flash_variants.py --group ladder): partials of 64,
// 128, 256 and 512 K read 4.1e-6, 4.1e-6, 4.3e-6 and 5.0e-6 (the last
// over FP32_REL / 2), one sum over all of K 1.7e-5 (over FP32_REL); the
// times within 4% of each other. CH = 4 leaves the most room.
//
// Tiling: a BM x BM C tile a block, its WM x WN warps each owning a
// (BM / WM) x (BM / WN) sub-tile of MI x NI fragments (m16 x n8); K walked
// in steps of BK = 32 values.
//
// Shared layouts, their pitches padded so that each access below meets 32
// distinct banks:
// - bf16 planes (Planes), hi then lo: A [m][k] at BK + 8 values (80 bytes:
//   ldmatrix's 8 rows of 16 bytes on 8 distinct 4-bank groups); B [k][n] as
//   B lies at BM + 8 values (272 or 528 bytes: ldmatrix.trans's 8 rows 16
//   bytes apart in bank space);
// - fp32 stages (Stage), as the operands lie: A [m][k] at BK + 8 floats, B
//   [k][n] at BM + 4 floats (16-byte rows for cp.async and the split's
//   float4 reads; a warp reading its fragments from them, float2s of A
//   and columns of B, would meet 32 banks too).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "int8_mma.cuh"

namespace htog {
namespace x3 {

constexpr int BK = 32;        // K values a step
constexpr int CH = 4;         // K steps a partial sum (128 K)
constexpr int PA = BK + 8;    // A plane pitch, bf16 values
constexpr int PAF = BK + 8;   // A stage pitch, floats

template <int kBM, int kWM, int kWN>
struct Tile {
  static constexpr int BM = kBM;                // C tile edge (M and N)
  static constexpr int WM = kWM;                // warps along M
  static constexpr int WN = kWN;                // warps along N
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int MI = BM / WM / 16;       // m16 fragments a warp
  static constexpr int NI = BM / WN / 8;        // n8 fragments a warp
  static constexpr int PB = BM + 8;             // B plane pitch, bf16
  static constexpr int PBF = BM + 4;            // B stage pitch, floats
  static constexpr int CHUNKS = BM * BK / 4;    // float4s of A (or B) a step
  static_assert(MI * WM * 16 == BM && NI * WN * 8 == BM && NI % 2 == 0,
                "whole fragments, B's in pairs");
  static_assert(CHUNKS % THREADS == 0, "every thread stages as many");
};

template <class T>
struct __align__(16) Planes {
  uint16_t a[2][T::BM][PA];     // hi, lo: [m][k]
  uint16_t b[2][BK][T::PB];     // hi, lo: [k][n]
};

template <class T>
struct __align__(16) Stage {
  float a[T::BM][PAF];          // [m][k]
  float b[BK][T::PBF];          // [k][n]
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four consecutive values as their hi and lo bf16 quads.
__device__ __forceinline__ void split4(const float4& v, uint2& hi,
                                       uint2& lo) {
  fa::split_pack(v.x, v.y, hi.x, lo.x);
  fa::split_pack(v.z, v.w, hi.y, lo.y);
}

// The A chunk (float4) i of a step this thread stages: row r, column c.
template <class T>
__device__ __forceinline__ void a_chunk(int i, int& r, int& c) {
  int q = threadIdx.x + i * T::THREADS;
  r = q / (BK / 4);
  c = (q % (BK / 4)) * 4;
}

// The B chunk i: K row r, column c.
template <class T>
__device__ __forceinline__ void b_chunk(int i, int& r, int& c) {
  int q = threadIdx.x + i * T::THREADS;
  r = q / (T::BM / 4);
  c = (q % (T::BM / 4)) * 4;
}

// A chunk i's hi and lo quads into the planes.
template <class T>
__device__ __forceinline__ void store_a(Planes<T>& pl, int i,
                                        const float4& v) {
  int r, c;
  a_chunk<T>(i, r, c);
  uint2 hi, lo;
  split4(v, hi, lo);
  *reinterpret_cast<uint2*>(&pl.a[0][r][c]) = hi;
  *reinterpret_cast<uint2*>(&pl.a[1][r][c]) = lo;
}

template <class T>
__device__ __forceinline__ void store_b(Planes<T>& pl, int i,
                                        const float4& v) {
  int r, c;
  b_chunk<T>(i, r, c);
  uint2 hi, lo;
  split4(v, hi, lo);
  *reinterpret_cast<uint2*>(&pl.b[0][r][c]) = hi;
  *reinterpret_cast<uint2*>(&pl.b[1][r][c]) = lo;
}

// The operands and the block's place: A (M, lda) and B (K, ldb) fp32
// row-major, K, lda and ldb multiples of 4, bases 16-byte aligned, B's
// rows readable up to ldb >= N; the C tile at (m0, n0).
struct Operands {
  const float* a;
  const float* b;
  int M, N, K, lda, ldb, m0, n0;

  __device__ __forceinline__ bool a_valid(int r, int k0, int c) const {
    return m0 + r < M && k0 + c < K;
  }
  __device__ __forceinline__ bool b_valid(int r, int k0, int c) const {
    return k0 + r < K && n0 + c < N;
  }
  __device__ __forceinline__ const float* a_at(int r, int k0, int c) const {
    return a + static_cast<size_t>(m0 + r) * lda + k0 + c;
  }
  __device__ __forceinline__ const float* b_at(int r, int k0, int c) const {
    return b + static_cast<size_t>(k0 + r) * ldb + n0 + c;
  }
};

// Step k0's A and B into an fp32 stage by 16-byte cp.async, one group;
// chunks past M, N or K are zero-filled (zeros add nothing to a sum).
template <class T>
__device__ __forceinline__ void copy_stage(Stage<T>& st, const Operands& op,
                                           int k0) {
#pragma unroll
  for (int i = 0; i < T::CHUNKS / T::THREADS; ++i) {
    int r, c;
    a_chunk<T>(i, r, c);
    bool ok = op.a_valid(r, k0, c);
    cp_async16(&st.a[r][c], ok ? op.a_at(r, k0, c) : op.a, ok);
    b_chunk<T>(i, r, c);
    ok = op.b_valid(r, k0, c);
    cp_async16(&st.b[r][c], ok ? op.b_at(r, k0, c) : op.b, ok);
  }
  cp_async_commit();
}

// An fp32 stage split into bf16 planes: each float4 read once.
template <class T>
__device__ __forceinline__ void split_stage(Planes<T>& pl,
                                            const Stage<T>& st) {
#pragma unroll
  for (int i = 0; i < T::CHUNKS / T::THREADS; ++i) {
    int r, c;
    a_chunk<T>(i, r, c);
    store_a(pl, i, *reinterpret_cast<const float4*>(&st.a[r][c]));
    b_chunk<T>(i, r, c);
    store_b(pl, i, *reinterpret_cast<const float4*>(&st.b[r][c]));
  }
}

// The K steps of one partial out of nk: CH (CH 0: all of them).
__device__ __forceinline__ int partial_steps(int nk) {
  return CH > 0 ? CH : nk;
}

// The warp's sums: acc, the tensor cores' over the current partial of up
// to CH steps; tot, the partials added in K's order (from 0, or seeded
// with C). Element e of fragment (mi, ni) is row r0 + mi*16 + g + (e/2)*8,
// column c0 + ni*8 + 2t + e%2 of the output (lane = 4g + t).
template <class T>
struct Sums {
  float acc[T::MI][T::NI][4];
  float tot[T::MI][T::NI][4];
  int r0, c0;  // the warp's sub-tile in the output

  __device__ __forceinline__ void init(int m0, int n0) {
    int warp = threadIdx.x >> 5;
    r0 = m0 + (warp / T::WN) * T::MI * 16;
    c0 = n0 + (warp % T::WN) * T::NI * 8;
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = tot[mi][ni][e] = 0.0f;
  }

  __device__ __forceinline__ int row(int mi, int e) const {
    return r0 + mi * 16 + ((threadIdx.x & 31) >> 2) + (e >> 1) * 8;
  }
  __device__ __forceinline__ int col(int ni, int e) const {
    return c0 + ni * 8 + (threadIdx.x & 3) * 2 + (e & 1);
  }

  // tot = C (the masked tile): the reference's _init.
  __device__ __forceinline__ void seed(const float* c, int M, int N,
                                       int ldc) {
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int r = row(mi, e), q = col(ni, e);
          tot[mi][ni][e] =
              r < M && q < N ? c[static_cast<size_t>(r) * ldc + q] : 0.0f;
        }
  }

  // tot += acc, acc = 0: a partial goes into the sums.
  __device__ __forceinline__ void promote() {
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          tot[mi][ni][e] = __fadd_rn(tot[mi][ni][e], acc[mi][ni][e]);
          acc[mi][ni][e] = 0.0f;
        }
  }

  // hi.hi + hi.lo + lo.hi for every fragment pair of one 16-deep slice,
  // each product over all fragments before the next (the three into one
  // accumulator are dependent).
  __device__ __forceinline__ void products(const uint32_t (&a)[2][T::MI][4],
                                           const uint32_t (&b)[2][T::NI][2]) {
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < T::NI; ++ni)
          mma(acc[mi][ni], a[p == 2][mi], b[p == 1][ni]);
  }

  // One K step from bf16 planes: A by ldmatrix, B by ldmatrix.trans.
  __device__ __forceinline__ void step_planes(const Planes<T>& pl) {
    int lane = threadIdx.x & 31;
    int warp = threadIdx.x >> 5;
    int wr = (warp / T::WN) * T::MI * 16;
    int wc = (warp % T::WN) * T::NI * 8;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][T::MI][4];
      uint32_t b[2][T::NI][2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
#pragma unroll
        for (int mi = 0; mi < T::MI; ++mi)
          ldsm_x4(a[p][mi], &pl.a[p][wr + mi * 16 + (lane & 15)]
                                 [kk + (lane >> 4) * 8]);
#pragma unroll
        for (int nj = 0; nj < T::NI / 2; ++nj) {
          uint32_t r[4];
          ldsm_x4_trans(r, &pl.b[p][kk + (lane & 15)]
                                [wc + nj * 16 + (lane >> 4) * 8]);
          b[p][2 * nj][0] = r[0];
          b[p][2 * nj][1] = r[1];
          b[p][2 * nj + 1][0] = r[2];
          b[p][2 * nj + 1][1] = r[3];
        }
      }
      products(a, b);
    }
  }

  // out = tot (+ c when c is given), masked to M x N.
  __device__ __forceinline__ void store(float* out, const float* c, int M,
                                        int N, int ldc) {
    promote();
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int r = row(mi, e), q = col(ni, e);
          if (r >= M || q >= N) continue;
          size_t idx = static_cast<size_t>(r) * ldc + q;
          float v = tot[mi][ni][e];
          out[idx] = c != nullptr ? __fadd_rn(v, c[idx]) : v;
        }
  }
};

}  // namespace x3
}  // namespace htog
