// Shared building blocks of the mma.sync GEMM kernels (the hand-pipeline
// record's manual_dma.cuh, int8_dma_nn.cu and int8_hand_pipe.cu; K1, K2
// and rung 18 run gemm_wgmma.cuh's or w4a8_wgmma.cuh's wgmma bodies):
// block tiling, shared-memory staging, the warp-level tensor-core product
// and the dequant epilogue.
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Waits until at most N of this thread's newest cp.async groups are
// still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage a 128-row x 64-byte K-major tile of a row-major int8 matrix
// (rows x K, row pitch ld bytes, ld and the base 16-byte aligned, K a
// multiple of 16) by the block's THREADS threads, thread t taking 16-byte
// chunks t, t + THREADS, ... of the 512. Rows >= rows and K chunks >= K
// are zero-filled.
__device__ __forceinline__ void load_kmajor_async(int8_t (*dst)[LDS],
                                                  const int8_t* src, int row0,
                                                  int rows, int k0, int K,
                                                  int ld) {
#pragma unroll
  for (int i = 0; i < 512 / THREADS; ++i) {
    int chunk = threadIdx.x + i * THREADS;
    int r = chunk >> 2;
    int kc = (chunk & 3) * 16;
    int gr = row0 + r;
    int gk = k0 + kc;
    bool valid = gr < rows && gk < K;
    const int8_t* p = valid ? src + (size_t)gr * ld + gk : src;
    cp_async16(&dst[r][kc], p, valid);
  }
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

// out[i,j] = (float(acc) * sa[i]) * sb[j] + c[i,j], masked to M x N. c
// and out may alias (no __restrict__ on either).
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
          out[idx] = __fadd_rn(v, c[idx]);
        }
      }
    }
  }
}

// The N-major B operand of load_nmajor_regs (manual_dma.cuh's rung 08
// loads) for a plain row-major int8 (K, N) matrix.
struct RowMajorInt8 {
  const int8_t* base;
  int K;   // rows
  int ld;  // row pitch in bytes (a multiple of 16, >= N)
  __device__ const int8_t* row(int k) const {
    return base + (size_t)k * ld;
  }
  __device__ uint32_t decode(uint32_t w, int) const { return w; }
};

}  // namespace htog
