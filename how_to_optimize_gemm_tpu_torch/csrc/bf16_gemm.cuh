// bf16 tensor-core GEMMs with fp32 accumulation on the int8 kernels'
// tiling (int8_mma.cuh): the bf16 product (MmaBf16), the walk over a
// thread's fp32 accumulators, and the bf16 GEMM kernel of
// bf16_gemm_nt.cu (rung 15) and bf16_gemm_nn.cu (rung 05). The W4A16
// kernels (w4a16_gemm.cuh) use the first two.
//
// A 64-byte K stage holds 32 bf16 values, and mma.m16n8k16.bf16 reads its
// fragments at the byte offsets of the int8 m16n8k32, so A (M, K) goes
// through load_kmajor_async and mma_stage_with's A walk as it is. B is
// one of two layouts:
//   BKMajor  B given transposed, BT (N, K) row-major: K-major like A,
//            staged by cp.async and read by KMajorFrags, no transpose;
//   BNMajor  B (K, N) row-major: staged as it is, 32 K rows x 128 columns
//            (row pitch 136 bf16 = 272 bytes, so the 8 rows of an
//            ldmatrix hit 32 distinct banks), and its "col" fragments read
//            with ldmatrix.trans, which transposes 16-bit elements.
// C enters in one of two orders, each the reference's:
//   kSeedC   the accumulator starts at C (pallas_tuned._make_kernel:
//            acc = C, then acc += A.B), and out = acc;
//   !kSeedC  the accumulator starts at 0 and out = acc + C at the flush
//            (pallas_tuned._kernel_bf16_bt), c and out may be one buffer.
// Each output element is read and written by the thread that owns it.
#pragma once

#include <cuda_bf16.h>

#include "int8_mma.cuh"

namespace htog {

constexpr int BKE = BK / 2;     // bf16 K values per 64-byte stage
constexpr int LDB16 = BN + 8;   // N-major bf16 stage row pitch, elements

struct MmaBf16 {
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

__device__ __forceinline__ void zero_acc(float (&acc)[4][4][4]) {
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
}

// f(acc element, row, col) for each of this thread's accumulator
// elements inside M x N (rows g and g+8, columns 2t and 2t+1 of each
// m16n8 fragment of the warp's 64x32 sub-tile).
template <class F>
__device__ __forceinline__ void for_each_acc(float (&acc)[4][4][4], int M,
                                             int N, int m0, int n0, int wm,
                                             int wn, int lane, F f) {
  int g = lane >> 2;
  int t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int row = m0 + wm * 64 + mi * 16 + g + h * 8;
      if (row >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          int col = n0 + wn * 32 + ni * 8 + t * 2 + e;
          if (col >= N) continue;
          f(acc[mi][ni][h * 2 + e], row, col);
        }
      }
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// B given as BT (N, K) bf16 row-major (ldb elements, 16-byte rows).
struct BKMajor {
  struct Stage {
    int8_t t[BN][LDS];
  };
  static __device__ __forceinline__ void load(Stage& st, const uint16_t* b,
                                              int n0, int N, int k0, int K,
                                              int ldb) {
    load_kmajor_async(st.t, reinterpret_cast<const int8_t*>(b), n0, N,
                      k0 * 2, K * 2, ldb * 2);
  }
  static __device__ __forceinline__ KMajorFrags frags(const Stage& st) {
    return KMajorFrags{st.t};
  }
};

// The "col" fragments of a 32(k) x 128(n) N-major stage: for each pair of
// the warp's 8-column tiles, one ldmatrix.x4.trans; lanes 0-7 address K
// rows 0-7 and lanes 8-15 rows 8-15 of the 16-deep step at the pair's
// first tile, lanes 16-31 the same rows at its second tile, so r[0..1]
// are (b0, b1) of the first tile and r[2..3] of the second.
struct NMajorFrags {
  const uint16_t (*bs)[LDB16];
  __device__ __forceinline__ void operator()(uint32_t (&b)[4][2], int kk,
                                             int wn, int lane) const {
    int k = kk / 2 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int ni = 0; ni < 4; ni += 2) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, &bs[k][wn * 32 + ni * 8 + (lane >> 4) * 8]);
      b[ni][0] = r[0];
      b[ni][1] = r[1];
      b[ni + 1][0] = r[2];
      b[ni + 1][1] = r[3];
    }
  }
};

// B given as (K, N) bf16 row-major (ldb elements, a multiple of 8, >= N).
struct BNMajor {
  struct Stage {
    uint16_t t[BKE][LDB16];
  };
  // 32 rows x 16 chunks of 8 values; a chunk that starts below N ends
  // inside the row pitch. Rows >= K and chunks >= N are zero-filled.
  static __device__ __forceinline__ void load(Stage& st, const uint16_t* b,
                                              int n0, int N, int k0, int K,
                                              int ldb) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int chunk = threadIdx.x + i * THREADS;
      int r = chunk >> 4;
      int c = (chunk & 15) * 8;
      int gk = k0 + r;
      int gn = n0 + c;
      bool valid = gk < K && gn < N;
      const uint16_t* p = valid ? b + (size_t)gk * ldb + gn : b;
      cp_async16(&st.t[r][c], p, valid);
    }
  }
  static __device__ __forceinline__ NMajorFrags frags(const Stage& st) {
    return NMajorFrags{st.t};
  }
};

// out = C + A.B (kSeedC) or A.B + C (!kSeedC) over one 128x128 tile per
// block: A (M, lda) and B bf16 with K a multiple of 8 (16-byte rows, the
// wrapper pads with zeros), bases 16-byte aligned; c, out (M, ldc) fp32.
// Two stages, every operand through cp.async.
template <class BL, bool kSeedC>
__global__ void __launch_bounds__(THREADS)
    bf16_gemm_kernel(const uint16_t* a, const uint16_t* b, const float* c,
                     float* out, int M, int N, int K, int lda, int ldb,
                     int ldc) {
  __shared__ __align__(16) int8_t sa[2][BM][LDS];
  __shared__ __align__(16) typename BL::Stage sb[2];
  int m0 = blockIdx.y * BM;
  int n0 = blockIdx.x * BN;
  int warp = threadIdx.x >> 5;
  int lane = threadIdx.x & 31;
  int wm = warp >> 2;
  int wn = warp & 3;
  float acc[4][4][4];
  zero_acc(acc);
  if constexpr (kSeedC) {
    for_each_acc(acc, M, N, m0, n0, wm, wn, lane,
                 [&](float& v, int row, int col) {
                   v = c[(size_t)row * ldc + col];
                 });
  }
  const int8_t* a8 = reinterpret_cast<const int8_t*>(a);
  int kbytes = K * 2;
  int ldab = lda * 2;
  int nk = (K + BKE - 1) / BKE;
  load_kmajor_async(sa[0], a8, m0, M, 0, kbytes, ldab);
  BL::load(sb[0], b, n0, N, 0, K, ldb);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    int s = kt & 1;
    if (kt + 1 < nk) {
      load_kmajor_async(sa[s ^ 1], a8, m0, M, (kt + 1) * BK, kbytes, ldab);
      BL::load(sb[s ^ 1], b, n0, N, (kt + 1) * BKE, K, ldb);
      cp_async_commit();
    }
    mma_stage_with<MmaBf16>(acc, sa[s], BL::frags(sb[s]), wm, wn, lane);
    cp_async_wait_all();
    __syncthreads();
  }
  for_each_acc(acc, M, N, m0, n0, wm, wn, lane,
               [&](float& v, int row, int col) {
                 size_t idx = (size_t)row * ldc + col;
                 out[idx] = kSeedC ? v : __fadd_rn(v, c[idx]);
               });
}

// Launches bf16_gemm_kernel; returns cudaGetLastError().
template <class BL, bool kSeedC>
int launch_bf16_gemm(const void* a, const void* b, const void* c, void* out,
                     int M, int N, int K, int lda, int ldb, int ldc,
                     void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  bf16_gemm_kernel<BL, kSeedC>
      <<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint16_t*>(a), static_cast<const uint16_t*>(b),
          static_cast<const float*>(c), static_cast<float*>(out), M, N, K,
          lda, ldb, ldc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace htog
