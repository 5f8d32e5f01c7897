// Shared building blocks of the GEMM kernels (int8_gemm_nn.cu,
// int8_gemm_nt.cu, int8_ragged_nt.cu, int8_gemm_noc.cu, w4a8_gemm.cu,
// w4a8_gemm_noc.cu, the hand-pipeline record's manual_dma.cuh and,
// for their tiling, staging and fragment walk, the bf16 tensor-core
// kernels of bf16_gemm.cuh and w4a16_gemm.cuh): block tiling,
// shared-memory staging, the warp-level tensor-core product and the
// dequant epilogue.
//
// Tiling: one 128x128 output tile per block of 256 threads (8 warps laid
// out 2 x 4, each owning a 64x32 sub-tile = 4 x 4 fragments of
// mma.sync.m16n8k32.s8), K walked in steps of 64 inside the block. Both
// operands sit in shared memory K-major (row = an M or N index, 64 K
// bytes + 16 bytes of padding), which is the layout the int8 MMA reads
// its A ("row") and B ("col") fragments from with one 32-bit load each;
// the 80-byte row pitch puts the 8 rows x 4 words of a fragment load on
// 32 distinct banks. Two stages: the loads of tile k+1 are issued before
// the MMAs of tile k.
//
// The epilogue is the reference's order, written with explicit rounding
// intrinsics so nvcc cannot contract it into an FMA:
//     out[i,j] = (float(acc) * sa[i]) * sb[j] + c[i,j]
// (without the "+ c" for the no-C serving form, kAddC = false).
// The int32 accumulation is exact, so each kernel equals its plain
// PyTorch version bit for bit. c and out may be the same buffer (in-place
// accumulate): each element is read and written by the same thread.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace htog {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int LDS = BK + 16;  // shared row pitch in bytes (20 words)

struct Smem {
  int8_t a[2][BM][LDS];  // A tile, K-major, two stages
  int8_t b[2][BN][LDS];  // B tile as B^T (K-major), two stages
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int src_bytes = valid ? 16 : 0;  // 0: no read, 16 zero bytes written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

// cp_async16 under an L2 cache policy (a createpolicy value).
__device__ __forceinline__ void cp_async16_l2(void* smem, const void* gmem,
                                              bool valid, uint64_t policy) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int src_bytes = valid ? 16 : 0;
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::
          "r"(dst),
      "l"(gmem), "r"(src_bytes), "l"(policy));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage a 128-row x 64-byte K-major tile of a row-major int8 matrix
// (rows x K, row pitch ld bytes, ld and the base 16-byte aligned, K a
// multiple of 16) by kThreads threads, thread tid taking 16-byte chunks
// tid, tid + kThreads, ... of the 512. Rows >= rows and K chunks >= K are
// zero-filled. kHint: every copy under the L2 cache `policy`.
template <int kThreads, bool kHint>
__device__ __forceinline__ void load_kmajor_tile(int8_t (*dst)[LDS],
                                                 const int8_t* src, int row0,
                                                 int rows, int k0, int K,
                                                 int ld, int tid,
                                                 uint64_t policy) {
#pragma unroll
  for (int i = 0; i < 512 / kThreads; ++i) {
    int chunk = tid + i * kThreads;
    int r = chunk >> 2;
    int kc = (chunk & 3) * 16;
    int gr = row0 + r;
    int gk = k0 + kc;
    bool valid = gr < rows && gk < K;
    const int8_t* p = valid ? src + (size_t)gr * ld + gk : src;
    if constexpr (kHint)
      cp_async16_l2(&dst[r][kc], p, valid, policy);
    else
      cp_async16(&dst[r][kc], p, valid);
  }
}

// load_kmajor_tile by the block's THREADS threads, no cache policy.
__device__ __forceinline__ void load_kmajor_async(int8_t (*dst)[LDS],
                                                  const int8_t* src, int row0,
                                                  int rows, int k0, int K,
                                                  int ld) {
  load_kmajor_tile<THREADS, false>(dst, src, row0, rows, k0, K, ld,
                                   threadIdx.x, 0);
}

// N-major operand (B stored K rows x N columns, row-major): each thread
// owns two 4(k) x 4(n) byte groups. A warp covers 8 k-groups x 4
// n-groups, so each global load instruction reads 16 contiguous bytes in
// 8 rows and each transposed shared store hits 16 banks twice.
__device__ __forceinline__ void nmajor_group(int i, int& k, int& n) {
  int g = threadIdx.x + i * THREADS;  // 512 groups per 64 x 128 tile
  int lane = g & 31;
  int w = g >> 5;
  n = ((w & 7) * 4 + (lane & 3)) * 4;
  k = ((w >> 3) * 8 + (lane >> 2)) * 4;
}

// Load the 64(k) x 128(n) tile starting at (k0, n0) into registers,
// four 32-bit words (k, k+1, k+2, k+3; bytes = n..n+3) per group. The
// Src policy maps a K row to its address and decodes the loaded word
// into four int8 values; out-of-range words are zero, never decoded.
template <class Src>
__device__ __forceinline__ void load_nmajor_regs(uint32_t (&r)[2][4],
                                                 const Src& src, int k0,
                                                 int n0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int k, n;
    nmajor_group(i, k, n);
    bool nvalid = n0 + n < src.ld;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int gk = k0 + k + j;
      uint32_t v = 0;
      if (nvalid && gk < src.K) {
        v = src.decode(
            *reinterpret_cast<const uint32_t*>(src.row(gk) + n0 + n), gk);
      }
      r[i][j] = v;
    }
  }
}

// Transpose each 4x4 byte group in registers and store it K-major:
// column n+c of the group becomes the word dst[n + c][k .. k+3].
__device__ __forceinline__ void store_nmajor_regs(int8_t (*dst)[LDS],
                                                  const uint32_t (&r)[2][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int k, n;
    nmajor_group(i, k, n);
    uint32_t lo01 = __byte_perm(r[i][0], r[i][1], 0x5140);
    uint32_t lo23 = __byte_perm(r[i][2], r[i][3], 0x5140);
    uint32_t hi01 = __byte_perm(r[i][0], r[i][1], 0x7362);
    uint32_t hi23 = __byte_perm(r[i][2], r[i][3], 0x7362);
    *reinterpret_cast<uint32_t*>(&dst[n + 0][k]) =
        __byte_perm(lo01, lo23, 0x5410);
    *reinterpret_cast<uint32_t*>(&dst[n + 1][k]) =
        __byte_perm(lo01, lo23, 0x7632);
    *reinterpret_cast<uint32_t*>(&dst[n + 2][k]) =
        __byte_perm(hi01, hi23, 0x5410);
    *reinterpret_cast<uint32_t*>(&dst[n + 3][k]) =
        __byte_perm(hi01, hi23, 0x7632);
  }
}

__device__ __forceinline__ void zero_acc(int (&acc)[4][4][4]) {
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct MmaS8 {
  static __device__ __forceinline__ void mma(int (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    mma_s8(d, a, b);
  }
};

// B fragments of one 32-byte-deep step (bytes kk..kk+31) from a K-major
// stage: for each of the warp's four 8-column tiles, (col g, bytes
// 4t..4t+3) and (col g, bytes 16+).
struct KMajorFrags {
  const int8_t (*bs)[LDS];
  __device__ __forceinline__ void operator()(uint32_t (&b)[4][2], int kk,
                                             int wn, int lane) const {
    int g = lane >> 2;
    int t = lane & 3;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      int n = wn * 32 + ni * 8 + g;
      b[ni][0] = lds32(&bs[n][kk + t * 4]);
      b[ni][1] = lds32(&bs[n][kk + 16 + t * 4]);
    }
  }
};

// One 64-byte K step of the warp's 64x32 sub-tile from one stage, the
// product issued by Op::mma on 32-byte-deep fragments, the B fragments
// given by BFrags (KMajorFrags for a K-major stage). Fragment layouts
// (PTX ISA, mma.m16n8k32 .s8; lane = 4*g + t): A regs: (row g, bytes
// 4t..4t+3), (row g+8, same bytes), then both at byte 16+; B regs:
// (col g, bytes 4t..4t+3), (col g, bytes 16+); acc: rows g and g+8,
// columns 2t and 2t+1. mma.m16n8k16 .bf16 reads the same bytes (two
// bf16 per register, k = 2t, 2t+1 and k + 8) into the same accumulator
// layout, so the walk serves both.
template <class Op, class Acc, class BFrags>
__device__ __forceinline__ void mma_stage_with(Acc (&acc)[4][4][4],
                                               const int8_t (*as)[LDS],
                                               const BFrags& bfrags, int wm,
                                               int wn, int lane) {
  int g = lane >> 2;
  int t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 32) {
    uint32_t a[4][4];
    uint32_t b[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      int r = wm * 64 + mi * 16 + g;
      a[mi][0] = lds32(&as[r][kk + t * 4]);
      a[mi][1] = lds32(&as[r + 8][kk + t * 4]);
      a[mi][2] = lds32(&as[r][kk + 16 + t * 4]);
      a[mi][3] = lds32(&as[r + 8][kk + 16 + t * 4]);
    }
    bfrags(b, kk, wn, lane);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) Op::mma(acc[mi][ni], a[mi], b[ni]);
    }
  }
}

// mma_stage_with on a K-major B stage.
template <class Op, class Acc>
__device__ __forceinline__ void mma_stage(Acc (&acc)[4][4][4],
                                          const int8_t (*as)[LDS],
                                          const int8_t (*bs)[LDS], int wm,
                                          int wn, int lane) {
  mma_stage_with<Op>(acc, as, KMajorFrags{bs}, wm, wn, lane);
}

// out[i,j] = (float(acc) * sa[i]) * sb[j] (+ c[i,j] when kAddC), masked
// to M x N. c and out may alias (no __restrict__ on either); c is not read
// when kAddC is false.
template <bool kAddC>
__device__ __forceinline__ void dequant_epilogue(
    const int (&acc)[4][4][4], const float* sa, const float* sb,
    const float* c, float* out, int M, int N, int ldc, int m0, int n0,
    int wm, int wn, int lane) {
  int g = lane >> 2;
  int t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int row = m0 + wm * 64 + mi * 16 + g + h * 8;
      if (row >= M) continue;
      float s_row = sa[row];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          int col = n0 + wn * 32 + ni * 8 + t * 2 + e;
          if (col >= N) continue;
          size_t idx = (size_t)row * ldc + col;
          float v = __fmul_rn(
              __fmul_rn(__int2float_rn(acc[mi][ni][h * 2 + e]), s_row),
              sb[col]);
          out[idx] = kAddC ? __fadd_rn(v, c[idx]) : v;
        }
      }
    }
  }
}

// One 128x128 tile of K2 (int8_gemm_nt, and rung 18's persistent walk):
// both operands K-major through cp.async into two stages, the loads of K
// step k+1 issued before the MMAs of step k, then the dequant epilogue
// with C. Ends with every warp past its last read of `sm`, so a
// persistent block may start its next tile at once.
__device__ __forceinline__ void gemm_nt_tile(Smem& sm, const int8_t* qa,
                                             const int8_t* qbt,
                                             const float* sa, const float* sb,
                                             const float* c, float* out,
                                             int M, int N, int K, int lda,
                                             int ldb, int ldc, int m0,
                                             int n0) {
  int warp = threadIdx.x >> 5;
  int lane = threadIdx.x & 31;
  int wm = warp >> 2;
  int wn = warp & 3;
  int acc[4][4][4];
  zero_acc(acc);
  int nk = (K + BK - 1) / BK;
  load_kmajor_async(sm.a[0], qa, m0, M, 0, K, lda);
  load_kmajor_async(sm.b[0], qbt, n0, N, 0, K, ldb);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    int s = kt & 1;
    if (kt + 1 < nk) {
      load_kmajor_async(sm.a[s ^ 1], qa, m0, M, (kt + 1) * BK, K, lda);
      load_kmajor_async(sm.b[s ^ 1], qbt, n0, N, (kt + 1) * BK, K, ldb);
      cp_async_commit();
    }
    mma_stage<MmaS8>(acc, sm.a[s], sm.b[s], wm, wn, lane);
    cp_async_wait_all();
    __syncthreads();
  }
  dequant_epilogue<true>(acc, sa, sb, c, out, M, N, ldc, m0, n0, wm, wn, lane);
}

// The N-major B operand of gemm_nmajor_body for a plain row-major int8
// (K, N) matrix.
struct RowMajorInt8 {
  const int8_t* base;
  int K;   // rows
  int ld;  // row pitch in bytes (a multiple of 16, >= N)
  __device__ const int8_t* row(int k) const {
    return base + (size_t)k * ld;
  }
  __device__ uint32_t decode(uint32_t w, int) const { return w; }
};

// The whole kernel for an N-major B operand (K1 and its no-C form, K3
// and its no-C form): A through cp.async, B through registers (load,
// decode, transpose, store), two stages, the dequant epilogue at the end.
template <bool kAddC, class Src>
__device__ __forceinline__ void gemm_nmajor_body(
    Smem& sm, const int8_t* A, const Src& bsrc, const float* sa,
    const float* sb, const float* c, float* out, int M, int N, int K,
    int lda, int ldc) {
  int m0 = blockIdx.y * BM;
  int n0 = blockIdx.x * BN;
  int warp = threadIdx.x >> 5;
  int lane = threadIdx.x & 31;
  int wm = warp >> 2;
  int wn = warp & 3;
  int acc[4][4][4];
  zero_acc(acc);
  uint32_t breg[2][4];
  int nk = (K + BK - 1) / BK;
  load_kmajor_async(sm.a[0], A, m0, M, 0, K, lda);
  cp_async_commit();
  load_nmajor_regs(breg, bsrc, 0, n0);
  store_nmajor_regs(sm.b[0], breg);
  cp_async_wait_all();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    int s = kt & 1;
    bool more = kt + 1 < nk;
    if (more) {
      load_kmajor_async(sm.a[s ^ 1], A, m0, M, (kt + 1) * BK, K, lda);
      cp_async_commit();
      load_nmajor_regs(breg, bsrc, (kt + 1) * BK, n0);
    }
    mma_stage<MmaS8>(acc, sm.a[s], sm.b[s], wm, wn, lane);
    if (more) store_nmajor_regs(sm.b[s ^ 1], breg);
    cp_async_wait_all();
    __syncthreads();
  }
  dequant_epilogue<kAddC>(acc, sa, sb, c, out, M, N, ldc, m0, n0, wm, wn,
                          lane);
}

}  // namespace htog
