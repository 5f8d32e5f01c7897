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
// The tile walk is the bf16 GEMM's (bf16_gemm.cuh, int8_mma.cuh): one
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

#include "bf16_gemm.cuh"
#include "flash_common.cuh"
#include "fp32_gemm.cuh"
#include "w4a8.cuh"

namespace htog {
namespace gg {

constexpr int KV = 32;        // K values per stage
constexpr int LDX = KV + 8;   // fp32 row pitch of the x stage
constexpr int GROUP_M = 8;    // row tiles per group of the tile walk

struct Smem {
  float x[2][BM][LDX];
  int8_t w[2][BN][LDS];       // 32 bf16 K values a column, K-major
};

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

// 128 rows x 32 fp32 K values of x from (m0, k0): 1,024 chunks of 16
// bytes, four a thread. x's columns from K up to ldx (a multiple of 4) are
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

// The A fragment of rows r, r + 8 and K values kk .. kk + 15 of the x
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

// (row tile, column tile) of this block: groups of GROUP_M row tiles, the
// row tile fastest inside a group.
__device__ __forceinline__ void tile_of_block(int Tp, int N, int& m0,
                                              int& n0) {
  int num_m = Tp / BM;
  int num_n = (N + BN - 1) / BN;
  int per_group = GROUP_M * num_n;
  int bid = blockIdx.x;
  int first_m = (bid / per_group) * GROUP_M;
  int gm = min(num_m - first_m, GROUP_M);
  int in_group = bid % per_group;
  m0 = (first_m + in_group % gm) * BM;
  n0 = (in_group / gm) * BN;
}

// Kinds 0-2: bf16 tensor cores on split x.
template <class Src>
__global__ void __launch_bounds__(THREADS)
    grouped_gemm_mma(const float* x, const int8_t* w, const int* be,
                     const float* s, float* out, int Tp, int N, int K,
                     int ldx, int ldw, int bt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  int m0, n0;
  tile_of_block(Tp, N, m0, n0);
  int e = be[m0 / bt];
  Src src{reinterpret_cast<const typename Src::T*>(
              w + (size_t)e * (K / Src::kRowsDiv) * ldw * Src::kElt),
          K, ldw};
  int warp = threadIdx.x >> 5;
  int lane = threadIdx.x & 31;
  int wm = warp >> 2;
  int wn = warp & 3;
  int g = lane >> 2;
  int t = lane & 3;
  float acc[4][4][4];
  zero_acc(acc);
  uint2 breg[4];
  int nk = (K + KV - 1) / KV;
  load_x(sm.x[0], x, m0, 0, K, ldx);
  cp_async_commit();
  load_w(breg, src, 0, n0);
  store_w<Src>(sm.w[0], breg);
  cp_async_wait_all();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    int st = kt & 1;
    bool more = kt + 1 < nk;
    if (more) {
      load_x(sm.x[st ^ 1], x, m0, (kt + 1) * KV, K, ldx);
      cp_async_commit();
      load_w(breg, src, (kt + 1) * KV, n0);
    }
    KMajorFrags bfr{sm.w[st]};
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t b[4][2];
      bfr(b, ks * 32, wn, lane);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        uint32_t hi[4], lo[4];
        x_frags(sm.x[st], wm * 64 + mi * 16 + g, ks * 16, t, hi, lo);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          MmaBf16::mma(acc[mi][ni], hi, b[ni]);
          MmaBf16::mma(acc[mi][ni], lo, b[ni]);
        }
      }
    }
    if (more) store_w<Src>(sm.w[st ^ 1], breg);
    cp_async_wait_all();
    __syncthreads();
  }
  const float* se = s == nullptr ? nullptr : s + (size_t)e * N;
  for_each_acc(acc, Tp, N, m0, n0, wm, wn, lane,
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
