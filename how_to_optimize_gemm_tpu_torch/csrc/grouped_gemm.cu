// grouped_gemm: the ragged (grouped) GEMM of the MoE expert FFN, forward:
//     y[i*bt:(i+1)*bt] = (x[i*bt:(i+1)*bt] @ W[be[i]]) (* s[be[i], 0, :])
// for every bt-row block i of the expert-sorted rows x (Tp, d) fp32, W an
// (E, d, f) expert stack and be the block -> expert map; y (Tp, f) fp32.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_grouped_gemm.py,
// _kernel :71 (int8 stack + scales), _kernel_noscale :83 (bf16 and fp32
// stacks) and _kernel_q4 :87 (packed int4 stack + scales), all launched by
// _gmm_call :108 (pl.pallas_call :141). The TPU reads be by scalar
// prefetch in the weight BlockSpec's index map; here each block reads
// be[row0 / bt] itself and offsets into that expert's stack.
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
// 528 MB), 0.34 ms at 3.35 TB/s: the tensor cores bound it.
//
// Design. Kinds 0-2: every stack value is exact in bf16 (bf16 values, int8
// in [-128, 127], nibbles in [-8, 7]) but x is fp32, which a bf16 mma.sync
// cannot take; x is split into hi = bf16(x) and lo = bf16(x - hi)
// (flash_common.cuh's split_pack; |x - hi - lo| <= 2^-18 |x|) and each
// product takes two mma.sync.m16n8k16 bf16 -> fp32: the fp32 product to
// about 2^-17 relative, summed in the tensor cores' order. Against the
// plain version (cuBLAS fp32) it reads up to 3.7e-5 of max |y| at K =
// 14,336 on an H100; a three-part split (x exact, every partial product
// exact) read the same (up to 4.1e-5) at 1.4x the time, so the tensor
// cores' fp32 accumulation, not the split, sets the error.
// The tile walk (grouped_gemm.cuh, shared with the backward's dx kernel,
// grouped_gemm_t.cu) is the bf16 GEMM's (bf16_gemm.cuh, int8_mma.cuh): one
// 128 x 128 output tile per block of 256 threads (8 warps of 64 x 32), K in
// steps of 32 values, two stages. x is staged as fp32 by cp.async (row pitch
// 40 floats: the float2 fragment reads of a half warp hit 32 distinct
// banks) and split as the A fragments are read; the stack goes through
// registers (4 K rows x 4 columns a thread), is converted or decoded to bf16
// and stored K-major, as the W4A16 kernels do (w4a16_gemm.cuh), and read by
// KMajorFrags. Kind 3 (fp32 stacks, not exact in bf16) runs fp32_gemm.cuh's
// FFMA main loop on the expert's stack instead, full fp32. A tile of rows
// belongs to one block of the layout (bt a multiple of 128), so one expert
// serves the whole tile. Tiles are walked in groups of 8 row tiles, the
// column tile slowest inside a group, so the blocks running at once share
// one expert's stack columns and a few x tiles in L2. The scales multiply in
// the epilogue; the ragged column edge (f not a multiple of 128) is masked.
// Simple first version: mma.sync, not wgmma or TMA, no persistent
// scheduler over the ragged blocks.
#include <cuda_bf16.h>
#include <stdint.h>

#include "fp32_gemm.cuh"
#include "grouped_gemm.cuh"
#include "w4a8.cuh"

namespace htog {
namespace gg {

// Four stack values (K row k, columns n .. n+3) as int8 or bf16 bits. A
// source's rows are `ld` elements apart (a multiple of 4); `base` is the
// expert's stack, of K / kRowsDiv stored rows of kElt-byte elements.
struct Bf16Src {
  using T = uint16_t;
  static constexpr int kRowsDiv = 1;
  static constexpr int kElt = 2;
  const uint16_t* base;
  int K, ld;
  __device__ uint2 load(int k, int n) const {
    return *reinterpret_cast<const uint2*>(base + (size_t)k * ld + n);
  }
  // column c of the four, as bf16 bits
  static __device__ uint32_t bits(uint2 v, int c) {
    uint32_t w = c < 2 ? v.x : v.y;
    return (c & 1) ? (w >> 16) : (w & 0xFFFFu);
  }
};

struct Int8Src {
  using T = int8_t;
  static constexpr int kRowsDiv = 1;
  static constexpr int kElt = 1;
  const int8_t* base;
  int K, ld;
  __device__ uint2 load(int k, int n) const {
    return make_uint2(
        *reinterpret_cast<const uint32_t*>(base + (size_t)k * ld + n), 0u);
  }
  static __device__ uint32_t bits(uint2 v, int c) {
    int q = static_cast<int8_t>(v.x >> (8 * c));
    return __bfloat16_as_ushort(__float2bfloat16_rn(static_cast<float>(q)));
  }
};

// block_k = K: K row k lives in packed row k % (K / 2), in the low nibble
// for k < K / 2, else in the high nibble.
struct Int4Src {
  using T = int8_t;
  static constexpr int kRowsDiv = 2;
  static constexpr int kElt = 1;
  const int8_t* base;
  int K, ld;
  __device__ uint2 load(int k, int n) const {
    int half = K >> 1;
    bool lo = k < half;
    uint32_t w = *reinterpret_cast<const uint32_t*>(
        base + (size_t)(lo ? k : k - half) * ld + n);
    return make_uint2(lo ? decode_lo4(w) : decode_hi4(w), 0u);
  }
  static __device__ uint32_t bits(uint2 v, int c) {
    return Int8Src::bits(v, c);
  }
};

// This thread's group of the 32(k) x 128(n) stack tile: 4 K rows from k,
// 4 columns from n (w4a16_gemm.cuh's w4_group).
__device__ __forceinline__ void w_group(int& k, int& n) {
  int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;
  n = (warp * 4 + (lane & 3)) * 4;
  k = (lane >> 2) * 4;
}

template <class Src>
__device__ __forceinline__ void load_w(uint2 (&r)[4], const Src& w, int k0,
                                       int n0) {
  int k, n;
  w_group(k, n);
  bool nvalid = n0 + n < w.ld;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int gk = k0 + k + j;
    r[j] = nvalid && gk < w.K ? w.load(gk, n0 + n) : make_uint2(0u, 0u);
  }
}

// Column n + c of the group becomes the bf16 values of K rows k .. k+3 in
// stage row n + c.
template <class Src>
__device__ __forceinline__ void store_w(int8_t (*dst)[LDS],
                                        const uint2 (&r)[4]) {
  int k, n;
  w_group(k, n);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint2 pair;
    pair.x = Src::bits(r[0], c) | (Src::bits(r[1], c) << 16);
    pair.y = Src::bits(r[2], c) | (Src::bits(r[3], c) << 16);
    *reinterpret_cast<uint2*>(&dst[n + c][k * 2]) = pair;
  }
}

// The forward's stack policy (grouped_gemm.cuh): the expert's (K, N) stack
// read as it lies, 4 K rows x 4 columns a thread, and transposed K-major
// into the stage as bf16.
template <class Src>
struct KNStack {
  struct Regs {
    uint2 r[4];
  };
  Src src;
  __device__ void load(Regs& regs, int k0, int n0) const {
    load_w(regs.r, src, k0, n0);
  }
  static __device__ void store(int8_t (*dst)[LDS], const Regs& regs) {
    store_w<Src>(dst, regs.r);
  }
};

// Kinds 0-2: bf16 tensor cores on split x. Two blocks an SM: at most 128
// registers a thread (one instance spills 4 bytes). At 134, one block an
// SM, the int8 instance took 10.8 ms at the shape above on an H100, 8.7
// with two; int4 13.4 against 9.4, bf16 10.3 against 9.3.
template <class Src>
__global__ void __launch_bounds__(THREADS, 2)
    grouped_gemm_mma(const float* x, const int8_t* w, const int* be,
                     const float* s, float* out, int Tp, int N, int K,
                     int ldx, int ldw, int bt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  int m0, n0;
  tile_of_block(Tp, N, m0, n0);
  int e = be[m0 / bt];
  KNStack<Src> stack{Src{reinterpret_cast<const typename Src::T*>(
                             w + (size_t)e * (K / Src::kRowsDiv) * ldw *
                                     Src::kElt),
                         K, ldw}};
  int warp = threadIdx.x >> 5;
  int lane = threadIdx.x & 31;
  float acc[4][4][4];
  zero_acc(acc);
  split_mma_tile(acc, sm, x, m0, K, ldx, stack, n0);
  const float* se = s == nullptr ? nullptr : s + (size_t)e * N;
  for_each_acc(acc, Tp, N, m0, n0, warp >> 2, warp & 3, lane,
               [&](float& v, int row, int col) {
                 out[(size_t)row * N + col] =
                     se == nullptr ? v : __fmul_rn(v, se[col]);
               });
}

// Kind 3: fp32 stacks on fp32_gemm.cuh's FFMA main loop.
__global__ void __launch_bounds__(THREADS)
    grouped_gemm_ffma(const float* x, const float* w, const int* be,
                      const float* s, float* out, int Tp, int N, int K,
                      int ldx, int ldw, int bt) {
  int m0, n0;
  tile_of_block(Tp, N, m0, n0);
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

template <class Src>
int launch_mma(const float* x, const int8_t* w, const int* be,
               const float* s, float* out, int Tp, int N, int K, int ldx,
               int ldw, int bt, int blocks, cudaStream_t stream) {
  static bool configured = false;
  int bytes = static_cast<int>(sizeof(Smem));
  if (!configured) {
    cudaFuncSetAttribute(grouped_gemm_mma<Src>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    configured = true;
  }
  grouped_gemm_mma<Src><<<blocks, THREADS, bytes, stream>>>(
      x, w, be, s, out, Tp, N, K, ldx, ldw, bt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gg
}  // namespace htog

// x (Tp, ldx) fp32 with ldx a multiple of 4 and zero columns from K to
// ldx, Tp a multiple of bt and bt of 128; K even for kind 2; w the stack, (E, K, ldw) or for kind 2
// (E, K/2, ldw), ldw a multiple of 4 and >= N; block_expert (Tp / bt,)
// int32; s (E, 1, N) fp32 or null; out (Tp, N) fp32. Bases 16-byte
// aligned. Returns cudaGetLastError() after the launch (cudaErrorInvalidValue
// for an unknown kind).
extern "C" int grouped_gemm(const void* x, const void* w,
                            const void* block_expert, const void* s,
                            void* out, int Tp, int N, int K, int ldx,
                            int ldw, int bt, int kind, void* stream) {
  using namespace htog;
  int blocks = (Tp / BM) * ((N + BN - 1) / BN);
  auto xf = static_cast<const float*>(x);
  auto w8 = static_cast<const int8_t*>(w);
  auto be = static_cast<const int*>(block_expert);
  auto sf = static_cast<const float*>(s);
  auto of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      return gg::launch_mma<gg::Bf16Src>(xf, w8, be, sf, of, Tp, N, K, ldx,
                                         ldw, bt, blocks, st);
    case 1:
      return gg::launch_mma<gg::Int8Src>(xf, w8, be, sf, of, Tp, N, K, ldx,
                                         ldw, bt, blocks, st);
    case 2:
      return gg::launch_mma<gg::Int4Src>(xf, w8, be, sf, of, Tp, N, K, ldx,
                                         ldw, bt, blocks, st);
    case 3:
      gg::grouped_gemm_ffma<<<blocks, THREADS, 0, st>>>(
          xf, static_cast<const float*>(w), be, sf, of, Tp, N, K, ldx, ldw,
          bt);
      return static_cast<int>(cudaGetLastError());
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
