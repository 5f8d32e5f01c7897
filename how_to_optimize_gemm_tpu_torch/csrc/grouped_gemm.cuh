// The grouped GEMM's wgmma kernel (wgmma.cuh), one template for the
// forward (grouped_gemm.cu, kinds 0-2) and for the transposed dx product of
// the backward (grouped_gemm_t.cu, kinds 0-2), and the tile walk that both
// and dW (grouped_dw.cu) share. One 128 x 128 output tile a block:
//     forward  out[m0.., n0..] = (x_hi + x_lo)[m0.., :K] . W_e[:K, n0..]
//     dx       out[m0.., n0..] = (dy_hi + dy_lo)[m0.., :K] . W_e[n0.., :K]^T
// where the fp32 operand's rows are expert-sorted and split beforehand
// into two bf16 planes (split_bf16.cu), and a 128-row tile lies in one
// bt-row block of the layout (bt a multiple of 128), so one expert e
// serves the whole tile.
//
// Every stack value is exact in bf16 (bf16 values, int8 in [-128, 127],
// nibbles in [-8, 7]), so the two bf16 products hi . B + lo . B are the
// fp32 product to about 2^-17 relative. Block (wgmma.cuh): 384 threads, a
// 4-stage ring of 64 K values, two consumer warpgroups; A's hi and lo
// tiles (128 rows x 64 K, K-major) by tensor map. B, by kind:
//   bf16   straight from a 3-D tensor map (columns, rows, expert; the K
//          edge reads zeros), no conversion;
//   int8, packed int4   raw bytes by tensor map (8 KB a stage, not
//          swizzled), decoded to bf16 by three converter warps into the
//          swizzled B tile and fenced for the async proxy
//          (fence.proxy.async) before the consumers' wgmma reads it: 16
//          bytes a thread, no conversion instructions (bf16x4_of_int8,
//          _nibbles). Each stack byte is read from device memory once per
//          output tile.
// The two products differ only in B's layout. The forward's stack (E, K,
// f) has the output columns contiguous: B is MN-major (wgmma's transposed
// form, 64-column halves 8 KB apart). The dx product contracts the stack
// (E, dout, f) over its last dim in place: each output column n is a
// stack row with its K values contiguous, so B is K-major, the swizzled
// layout of A (one 128-byte line a column, k-steps 32 bytes into the
// line), and wgmma reads it without the transpose bit.
// Packed int4 stacks hold two weights a byte with block_k = the unpacked
// row count h (ops/quant.pack_int4): unpacked row u < h/2 is the low
// nibble of packed row u, offset binary (b & 0xF) - 8; row u >= h/2 the
// high nibble of packed row u - h/2, two's complement. The forward's
// unpacked rows are K (h = d), so a K stage takes one nibble except where
// it straddles d/2; dx's are the output columns (h = dout), so a column
// tile takes one nibble except where it straddles dout/2. A straddling
// stage or tile lands a second box of packed rows 0.. in the B tile's
// upper half, which the converters read before they write B. Neither
// straddles at Mixtral's widths.
//
// Accumulation: each consumer sums CH = 16 stages (K = 1,024) in its
// wgmma accumulator, then adds that into fp32 registers (wgmma.cuh); the
// scales, where given, multiply in the epilogue; the ragged column edge
// (N not a multiple of 128) is masked. The fixed order of a fixed tiling:
// the same bits on every run.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace htog {
namespace gg {

constexpr int GROUP_M = 8;      // row tiles per group of the tile walk
constexpr int CH = 16;          // stages summed in wgmma before adding
constexpr int STAGES = 4;       // of the ring
constexpr int CONVERTERS = 96;  // warps 1-3

// (row tile, column tile) of tile `bid` of an M x N output: groups of
// GROUP_M row tiles, the row tile fastest inside a group, so the blocks
// running at once share one expert's stack columns and a few A tiles in L2.
__device__ __forceinline__ void tile_of_block(int bid, int M, int N,
                                              int& m0, int& n0) {
  constexpr int T = wg::TILE;
  int num_m = (M + T - 1) / T;
  int num_n = (N + T - 1) / T;
  int per_group = GROUP_M * num_n;
  int first_m = (bid / per_group) * GROUP_M;
  int gm = min(num_m - first_m, GROUP_M);
  int in_group = bid % per_group;
  m0 = (first_m + in_group % gm) * T;
  n0 = (in_group / gm) * T;
}

// The ring's barriers and ready[s]: the converters' arrivals (one a
// thread) once they wrote stage s's bf16 B tile and fenced it for the async
// proxy (integer stacks only).
struct Bars {
  wg::Ring<STAGES> ring;
  uint64_t ready[STAGES];

  // by one thread, before the block's __syncthreads
  __device__ void init() {
    for (int s = 0; s < STAGES; ++s) mbar_init(&ready[s], CONVERTERS);
    ring.init();
  }
};

// Shared memory of one stage: A's hi and lo tiles, the bf16 B tile, then
// for an integer stack its raw bytes (one box of 8 KB: forward 64 K rows x
// 128 columns, dx 128 columns x 64 K values). A straddling packed stage
// lands its second box in the upper half of the B tile.
template <int KIND>
struct Stage {
  static constexpr int A_HI = 0;
  static constexpr int A_LO = wg::TILE_BYTES;
  static constexpr int B = 2 * wg::TILE_BYTES;
  static constexpr int RAW = 3 * wg::TILE_BYTES;
  static constexpr int BOX = wg::KT * wg::TILE;  // a raw box, 8 KB
  static constexpr int SECOND = B + BOX;         // the straddle's box
  static constexpr int BYTES = RAW + (KIND == 0 ? 0 : BOX);
  static constexpr int SMEM =
      STAGES * BYTES + static_cast<int>(sizeof(Bars)) + wg::ATOM;
};

// bf16 pairs of small integers from their bytes, exact, on the integer
// and half-precision pipes (no conversion instructions): a byte v < 128
// placed under the bf16 exponent of 128 (bits 0x43 in the high byte) is
// the bf16 of 128 + v, and one bf16x2 subtraction of exact values takes
// the bias off. Bytes 0 and 1 of a word (pair 0), 2 and 3 (pair 1), the
// lower byte in the lower half.
__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t under_128(uint32_t w, int pair) {
  return __byte_perm(w, 0x43u, pair ? 0x4342 : 0x4140);
}

// Four int8 weights q (a word) as two bf16 pairs: 128 + (q & 127) less 128,
// or 256 where q's sign bit is set.
__device__ __forceinline__ uint2 bf16x4_of_int8(uint32_t w) {
  uint32_t low = w & 0x7F7F7F7Fu;
  uint32_t sign = w & 0x80808080u;
  return make_uint2(bf16x2_sub(under_128(low, 0), under_128(sign, 0)),
                    bf16x2_sub(under_128(low, 1), under_128(sign, 1)));
}

// Four nibbles v = q + 8 (a word of bytes < 16) as two bf16 pairs of q:
// 128 + v less 136.
__device__ __forceinline__ uint2 bf16x4_of_nibbles(uint32_t v) {
  constexpr uint32_t kBias = 0x43084308u;  // bf16 136, twice
  return make_uint2(bf16x2_sub(under_128(v, 0), kBias),
                    bf16x2_sub(under_128(v, 1), kBias));
}

// The converter warps' own barrier (named barrier 2; 0 is
// __syncthreads').
__device__ __forceinline__ void converters_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(CONVERTERS) : "memory");
}

// Stores 16 bf16 at values c .. c + 15 of line `line` of a swizzled tile
// (two 16-byte chunks of the line's 128 bytes; c >= 64 is the next 64-value
// half, HALF_TILE on). A line is a K row of the forward's MN-major B and
// an output column of dx's K-major B.
__device__ __forceinline__ void store16(uint8_t* b, int line, int c,
                                        const uint2 (&o)[4]) {
  uint32_t off = (c >> 6) * wg::HALF_TILE + line * wg::LINE + (c & 63) * 2;
  uint32_t x = (line & 7) << 4;
  *reinterpret_cast<uint4*>(b + (off ^ x)) =
      make_uint4(o[0].x, o[0].y, o[1].x, o[1].y);
  *reinterpret_cast<uint4*>(b + ((off + 16) ^ x)) =
      make_uint4(o[2].x, o[2].y, o[3].x, o[3].y);
}

// 16 raw bytes as 16 bf16: int8 weights, or packed bytes' low or high
// nibbles (the high nibble's two's complement ^ 8 is q + 8).
template <int KIND>
__device__ __forceinline__ void decode_chunk(uint4 v, bool high,
                                             uint2 (&o)[4]) {
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (KIND == 1) {
      o[j] = bf16x4_of_int8(w[j]);
    } else {
      uint32_t n = high ? ((w[j] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u
                        : w[j] & 0x0F0F0F0Fu;
      o[j] = bf16x4_of_nibbles(n);
    }
  }
}

// The converter warps' decode of one stage's raw stack bytes -> the bf16
// B tile, swizzled as the tensor map would write it: one 16-byte chunk (16
// values of one line) a thread at a time (t: the thread's index of the
// 96), one 16-byte load, two 16-byte stores. The raw box holds kLines
// lines of kLineBytes bytes (forward: 64 K rows of 128 columns; dx: 128
// columns of 64 K values); line l is unpacked row u0 + l, which takes the
// high nibble from `half` on, read from the second box (packed rows 0..)
// where the stage straddles `half`. A straddling stage's second box lies
// in B's upper half, so then every converter loads all its chunks first
// and the converters meet (named barrier 2) before any stores.
template <int KIND, int kLines, int kLineBytes>
__device__ __forceinline__ void convert_stage(uint8_t* st, int u0, int half,
                                              int t) {
  using L = Stage<KIND>;
  constexpr int CHUNKS = kLineBytes / 16;  // 16-byte chunks of a raw line
  constexpr int TOTAL = kLines * CHUNKS;
  constexpr int PER = (TOTAL + CONVERTERS - 1) / CONVERTERS;
  const uint8_t* raw = st + L::RAW;
  uint8_t* b = st + L::B;
  if (KIND == 2 && u0 < half && u0 + kLines > half) {
    uint4 v[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      int i = t + j * CONVERTERS;
      int l = i / CHUNKS;
      int c = (i % CHUNKS) * 16;
      if (i < TOTAL)
        v[j] = *reinterpret_cast<const uint4*>(
            u0 + l < half ? raw + l * kLineBytes + c
                          : st + L::SECOND + (u0 + l - half) * kLineBytes + c);
    }
    converters_sync();
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      int i = t + j * CONVERTERS;
      int l = i / CHUNKS;
      if (i < TOTAL) {
        uint2 o[4];
        decode_chunk<KIND>(v[j], u0 + l >= half, o);
        store16(b, l, (i % CHUNKS) * 16, o);
      }
    }
    return;
  }
  bool high = KIND == 2 && u0 >= half;
#pragma unroll
  for (int i = t; i < TOTAL; i += CONVERTERS) {
    int l = i / CHUNKS;
    int c = (i % CHUNKS) * 16;
    uint2 o[4];
    decode_chunk<KIND>(
        *reinterpret_cast<const uint4*>(raw + l * kLineBytes + c), high, o);
    store16(b, l, c, o);
  }
}

// Kinds 0-2, forward (kT false) or dx (kT true): ta the (2 Tp, K) bf16
// hi/lo map of the fp32 operand split; tw the stack's (columns, rows,
// expert) map: bf16 in swizzled boxes of 64 values x 64 K rows (forward)
// or 64 K values x 128 rows (dx), integer bytes in plain boxes of 128
// columns x 64 K rows (forward) or 64 K bytes x 128 rows (dx). s (E, 1, N)
// or null (dx: null).
template <int KIND, bool kT>
__global__ void __launch_bounds__(wg::BLOCK, 1)
    grouped_wgmma(const __grid_constant__ CUtensorMap ta,
                  const __grid_constant__ CUtensorMap tw, const int* be,
                  const float* s, float* out, int Tp, int N, int K, int bt) {
  using L = Stage<KIND>;
  constexpr int ST = STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = wg::align_1024(smem_raw);
  auto& bars = *reinterpret_cast<Bars*>(smem + ST * L::BYTES);
  auto& ring = bars.ring;
  int m0, n0;
  tile_of_block(blockIdx.x, Tp, N, m0, n0);
  int e = be[m0 / bt];
  int nk = (K + wg::KT - 1) / wg::KT;
  int half = (kT ? N : K) / 2;  // the packed stack's nibble boundary
  int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) bars.init();
  __syncthreads();

  if (warp == 0) {
    if ((threadIdx.x & 31) != 0) return;
    for (int q = 0; q < nk; ++q) {
      int si = q % ST;
      uint8_t* st = smem + si * L::BYTES;
      uint64_t* full = &ring.full[si];
      int k0 = q * wg::KT;
      // the packed rows this stage reads start at u0 (forward: K rows;
      // dx: output columns)
      int u0 = kT ? n0 : k0;
      int lines = kT ? wg::TILE : wg::KT;
      bool straddle = KIND == 2 && u0 < half && u0 + lines > half;
      wg::wait_empty(ring, q);
      // A's hi and lo tiles and the bf16 stack tile, or one or two raw
      // boxes
      mbar_arrive_expect_tx(full, 2 * wg::TILE_BYTES +
                                      (KIND == 0  ? wg::TILE_BYTES
                                       : straddle ? 2 * L::BOX
                                                  : L::BOX));
      wg::tma_2d(st + L::A_HI, &ta, k0, m0, full);
      wg::tma_2d(st + L::A_LO, &ta, k0, Tp + m0, full);
      int packed = u0 < half ? u0 : u0 - half;
      if (KIND == 0 && kT) {
        wg::tma_3d(st + L::B, &tw, k0, n0, e, full);
      } else if (KIND == 0) {
        wg::tma_3d(st + L::B, &tw, n0, k0, e, full);
        wg::tma_3d(st + L::B + wg::HALF_TILE, &tw, n0 + 64, k0, e, full);
      } else if (kT) {
        wg::tma_3d(st + L::RAW, &tw, k0, KIND == 2 ? packed : n0, e, full);
        if (straddle) wg::tma_3d(st + L::SECOND, &tw, k0, 0, e, full);
      } else {
        wg::tma_3d(st + L::RAW, &tw, n0, KIND == 2 ? packed : k0, e, full);
        if (straddle) wg::tma_3d(st + L::SECOND, &tw, n0, 0, e, full);
      }
    }
    return;
  }
  if (warp < 4) {
    if constexpr (KIND != 0) {
      for (int q = 0; q < nk; ++q) {
        int si = q % ST;
        uint8_t* st = smem + si * L::BYTES;
        wg::wait(&ring.full[si], (q / ST) & 1);
        if constexpr (kT) {
          convert_stage<KIND, wg::TILE, wg::KT>(st, n0, half,
                                                threadIdx.x - 32);
        } else {
          convert_stage<KIND, wg::KT, wg::TILE>(st, q * wg::KT, half,
                                                threadIdx.x - 32);
        }
        fence_proxy_async();
        mbar_arrive(&bars.ready[si]);
      }
    }
    return;
  }

  int cw = (warp >> 2) - 1;  // consumer warpgroup: rows 64 cw ..
  float acc[wg::ACC], tot[wg::ACC];
  wg::zero(tot);
  uint32_t base = smem_u32(smem);
  wg::consume<ST, CH>(
      ring, nk, acc,
      [&](int si, int q) {
        wg::wait(&ring.full[si], (q / ST) & 1);
        if (KIND != 0) wg::wait(&bars.ready[si], (q / ST) & 1);
      },
      [&](int si, int q, bool first) {
        uint32_t st = base + si * L::BYTES;
        uint32_t a_hi = st + L::A_HI + cw * wg::HALF_TILE;
        uint32_t a_lo = st + L::A_LO + cw * wg::HALF_TILE;
#pragma unroll
        for (int k = 0; k < wg::KT / 16; ++k) {
          uint64_t db = kT ? wg::kmajor_desc(st + L::B, k)
                           : wg::mnmajor_desc(st + L::B, k);
          wg::Wgmma<128>::ss<0, kT ? 0 : 1>(
              acc, wg::kmajor_desc(a_hi, k), db, first && k == 0 ? 0 : 1);
          wg::Wgmma<128>::ss<0, kT ? 0 : 1>(acc, wg::kmajor_desc(a_lo, k),
                                            db, 1);
        }
      },
      [&] { wg::add_into(tot, acc); });
  const float* se = s == nullptr ? nullptr : s + (size_t)e * N;
  wg::for_each_pair(tot, m0 + 64 * cw, n0,
                    [&](float v0, float v1, int row, int col) {
                      if (se != nullptr) {
                        if (col < N) v0 = __fmul_rn(v0, se[col]);
                        if (col + 1 < N) v1 = __fmul_rn(v1, se[col + 1]);
                      }
                      wg::store_pair(out, row, col, N, v0, v1);
                    });
}

// Encodes both tensor maps and launches grouped_wgmma<KIND, kT> over the
// (Tp, N) output: a the (2, Tp, lda) bf16 planes, lda a multiple of 8; w
// the stack (E, rows, ldw), its rows of a multiple of 16 bytes: forward
// rows K (K/2 packed) of N columns, dx rows N (N/2 packed) of K values.
// Returns cudaGetLastError() after the launch, cudaErrorInvalidValue for a
// map the driver refuses.
template <int KIND, bool kT>
int launch_wgmma(const void* a, const void* w, const int* be, const float* s,
                 float* out, int Tp, int N, int K, int lda, int ldw, int bt,
                 int E, cudaStream_t stream) {
  CUtensorMap ta, tw;
  if (!wg::make_split_map(&ta, a, Tp, K, lda, wg::TILE))
    return static_cast<int>(cudaErrorInvalidValue);
  int unpacked = kT ? N : K;  // the stack's rows before packing
  cuuint64_t rows = KIND == 2 ? unpacked / 2 : unpacked;
  cuuint64_t dims[3] = {static_cast<cuuint64_t>(kT ? K : N), rows,
                        static_cast<cuuint64_t>(E)};
  cuuint64_t pitch = static_cast<cuuint64_t>(ldw) * (KIND == 0 ? 2 : 1);
  cuuint64_t strides[2] = {pitch, pitch * rows};
  bool ok;
  if (KIND == 0) {
    cuuint32_t box[3] = {64, kT ? wg::TILE : wg::KT, 1};
    ok = wg::make_map(&tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, w, dims,
                      strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  } else {
    cuuint32_t box[3] = {kT ? wg::KT : wg::TILE, kT ? wg::TILE : wg::KT, 1};
    ok = wg::make_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, w, dims,
                      strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = Stage<KIND>::SMEM;
  cudaFuncSetAttribute(grouped_wgmma<KIND, kT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  int tiles = (Tp / wg::TILE) * ((N + wg::TILE - 1) / wg::TILE);
  grouped_wgmma<KIND, kT><<<tiles, wg::BLOCK, bytes, stream>>>(
      ta, tw, be, s, out, Tp, N, K, bt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gg
}  // namespace htog
