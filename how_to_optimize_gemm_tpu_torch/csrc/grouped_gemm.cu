// grouped_gemm: the ragged (grouped) GEMM of the MoE expert FFN, forward:
//     y[i*bt:(i+1)*bt] = (x[i*bt:(i+1)*bt] @ W[be[i]]) (* s[be[i], 0, :])
// for every bt-row block i of the expert-sorted rows x (Tp, d) fp32, W an
// (E, d, f) expert stack and be the block -> expert map; y (Tp, f) fp32.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_grouped_gemm.py,
// _kernel :71 (int8 stack + scales), _kernel_noscale :83 (bf16 and fp32
// stacks), _kernel_q4 :87 (packed int4 stack + scales) and
// _kernel_q4_noscale :104 (the backward's unscaled recompute), all
// launched by _gmm_call :108 (pl.pallas_call :141). The TPU reads be by
// scalar prefetch in the weight BlockSpec's index map; here each block
// reads be[row0 / bt] itself and addresses that expert's stack.
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
// 528 MB), 0.34 ms at 3.35 TB/s: the tensor cores bound it. This design
// takes two bf16 products a tile, so its own floor is 1.95 ms.
//
// Design, kinds 0-2. Every stack value is exact in bf16 (bf16 values, int8
// in [-128, 127], nibbles in [-8, 7]) but x is fp32. The wrapper splits x
// once into hi = bf16(x) and lo = bf16(x - hi) (split_bf16.cu, a kernel of
// its own: |x - hi - lo| <= 2^-17 |x|; one more read and write of x, ~0.1
// ms at (9,216, 4,096), and 4 bytes an element of scratch: 1.9 GB at
// S-moe's w_out, Tp ~33.8k x 14,336). A pre-pass, not a split in
// registers, because it keeps both wgmma operands in shared memory, where
// the tensor-map copies put them, and the dW kernel (grouped_dw.cu) needs
// the same split of x and dy. Each 128 x 128 output tile takes two
// wgmma products a K step, hi . B and lo . B, fp32 sums (wgmma.cuh: 384
// threads, a 4-stage ring of 64 K values, 2 consumer warpgroups):
//   A   x_hi and x_lo tiles, 128 rows x 64 K, K-major, by tensor map;
//   B   the expert's (K, N) stack tile as it lies, N-major: a bf16 stack
//       straight from its tensor map (3-D: f, d, expert; the K edge reads
//       zeros), no conversion; an int8 or packed stack's raw bytes by
//       tensor map (64 K rows x 128 bytes, no swizzle), decoded to bf16 by
//       three converter warps into the swizzled N-major B tile and fenced
//       for the async proxy (fence.proxy.async) before the consumers'
//       wgmma reads it. The decode takes 16 bytes a thread and no
//       conversion instructions (bf16x4_of_int8, _nibbles). Each stack byte
//       is read from device memory once per output tile. A packed stack's
//       K tile at k0 reads packed rows k0 mod d/2 in one nibble, except
//       where it straddles d/2 (d/2 not a multiple of 64, never at
//       Mixtral's widths): then a second box of packed rows 0.. lands in
//       the B tile's upper half for its high-nibble rows.
// On an H100 at the shape above (chip_smoke.py): int8 4.6 ms, int4 4.6,
// bf16 3.8, the pre-pass included, against 8.7, 9.3 and 9.2 for the
// mma.sync kernel before it; error ~3e-6 of max |plain| at both K. A stage
// moves 48 KB (bf16) or 40 KB (int8) from L2 into the block, so the L2's
// rate, and for int8 and int4 the decode, set the time.
// Tried on an H100 at the shape above and dropped, each slower: the
// decode done by the consumers themselves between their wgmma issues;
// 128 x 256 tiles (only two stages fit); x's tiles multicast to a 2-block
// cluster. Summing without the fp32 promotion below took the same time at
// several times the error.
// A 128-row tile lies in one bt-block (bt a multiple of 128), so one expert
// serves it; tiles are walked as before (grouped_gemm.cuh's tile_of_block:
// groups of 8 row tiles, the column tile slowest inside a group). Each
// consumer adds its wgmma sums into fp32 registers every 16 stages (K =
// 1,024). The scales multiply in the epilogue; the ragged column edge (f
// not a multiple of 128) is masked. Kind 3 (fp32 stacks, not exact in
// bf16) runs fp32_gemm.cuh's FFMA main loop on the expert's stack instead,
// full fp32.
#include <cuda_bf16.h>
#include <stdint.h>

#include "fp32_gemm.cuh"
#include "grouped_gemm.cuh"
#include "wgmma.cuh"

namespace htog {
namespace gg {

constexpr int FWD_CH = 16;    // stages summed in wgmma before adding
constexpr int STAGES = 4;     // of the ring
constexpr int CONVERTERS = 96;  // warps 1-3

// The ring's barriers and ready[s]: the converters' arrivals (one a
// thread) once they wrote stage s's bf16 B tile and fenced it for the async
// proxy (integer stacks only).
struct FwdBars {
  wg::Ring<STAGES> ring;
  uint64_t ready[STAGES];

  // by one thread, before the block's __syncthreads
  __device__ void init() {
    for (int s = 0; s < STAGES; ++s) mbar_init(&ready[s], CONVERTERS);
    ring.init();
  }
};

// Shared memory of one stage: x_hi and x_lo tiles, the bf16 B tile, then
// for an integer stack its raw bytes (a box of 64 rows x 128 bytes). A
// packed stack's tile that straddles d/2 lands its second box in the upper
// half of the B tile, which the converters read before they write B.
template <int KIND>
struct FwdStage {
  static constexpr int A_HI = 0;
  static constexpr int A_LO = wg::TILE_BYTES;
  static constexpr int B = 2 * wg::TILE_BYTES;
  static constexpr int RAW = 3 * wg::TILE_BYTES;
  static constexpr int BOX = wg::KT * wg::TILE;  // a raw box, 8 KB
  static constexpr int SECOND = B + BOX;         // the straddle's box
  static constexpr int BYTES = RAW + (KIND == 0 ? 0 : BOX);
  static constexpr int SMEM =
      STAGES * BYTES + static_cast<int>(sizeof(FwdBars)) + wg::ATOM;
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

// Stores 16 bf16 of K row k from column c (two 16-byte chunks of row k's
// 128-byte line, swizzled).
__device__ __forceinline__ void store16(uint8_t* b, int k, int c,
                                        const uint2 (&o)[4]) {
  uint32_t off = (c >> 6) * wg::HALF_TILE + k * wg::LINE + (c & 63) * 2;
  uint32_t x = (k & 7) << 4;
  *reinterpret_cast<uint4*>(b + (off ^ x)) =
      make_uint4(o[0].x, o[0].y, o[1].x, o[1].y);
  *reinterpret_cast<uint4*>(b + ((off + 16) ^ x)) =
      make_uint4(o[2].x, o[2].y, o[3].x, o[3].y);
}

// 16 raw bytes as 16 bf16: int8 weights, or packed bytes' low or high
// nibbles.
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
// N-major B tile, swizzled as the tensor map would write it: 16 columns of
// one K row a thread at a time (t: the thread's index of the 96), one
// 16-byte load, two 16-byte stores. int8 bytes as they are. Kind 2: K row
// k0 + k takes the low nibble of packed row k0 + k below d/2 (offset
// binary: the nibble is q + 8), else the high nibble of packed row k0 + k
// - d/2 (two's complement: nibble ^ 8 = q + 8), from the second box where
// the tile straddles d/2; that box lies in B's upper half, so then every
// converter loads all its chunks first and the converters meet (named
// barrier 2) before any stores.
template <int KIND>
__device__ __forceinline__ void convert_stage(uint8_t* st, int k0, int half,
                                              int t) {
  using L = FwdStage<KIND>;
  constexpr int CHUNKS = wg::TILE / 16;  // 16-byte chunks of a raw K row
  constexpr int PER = (wg::KT * CHUNKS + CONVERTERS - 1) / CONVERTERS;
  const uint8_t* raw = st + L::RAW;
  uint8_t* b = st + L::B;
  if (KIND == 2 && k0 < half && k0 + wg::KT > half) {
    uint4 v[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      int i = t + j * CONVERTERS;
      int k = i / CHUNKS;
      int c = (i % CHUNKS) * 16;
      if (i < wg::KT * CHUNKS)
        v[j] = *reinterpret_cast<const uint4*>(
            k0 + k < half ? raw + k * wg::TILE + c
                          : st + L::SECOND + (k0 + k - half) * wg::TILE + c);
    }
    converters_sync();
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      int i = t + j * CONVERTERS;
      int k = i / CHUNKS;
      if (i < wg::KT * CHUNKS) {
        uint2 o[4];
        decode_chunk<KIND>(v[j], k0 + k >= half, o);
        store16(b, k, (i % CHUNKS) * 16, o);
      }
    }
    return;
  }
  bool high = KIND == 2 && k0 >= half;
#pragma unroll
  for (int i = t; i < wg::KT * CHUNKS; i += CONVERTERS) {
    int k = i / CHUNKS;
    int c = (i % CHUNKS) * 16;
    uint2 o[4];
    decode_chunk<KIND>(
        *reinterpret_cast<const uint4*>(raw + k * wg::TILE + c), high, o);
    store16(b, k, c, o);
  }
}

// Kinds 0-2: x split (ta: the (2 Tp, K) bf16 hi/lo map), the stack by tw
// (bf16: 64 x 64 boxes, swizzled; int8 and packed bytes: 128 x 64 boxes,
// not swizzled; dims f, K or K/2, E).
template <int KIND>
__global__ void __launch_bounds__(wg::BLOCK, 1)
    grouped_gemm_wgmma(const __grid_constant__ CUtensorMap ta,
                       const __grid_constant__ CUtensorMap tw,
                       const int* be, const float* s, float* out, int Tp,
                       int N, int K, int bt) {
  using L = FwdStage<KIND>;
  constexpr int ST = STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = wg::align_1024(smem_raw);
  auto& bars = *reinterpret_cast<FwdBars*>(smem + ST * L::BYTES);
  auto& ring = bars.ring;
  int m0, n0;
  tile_of_block(Tp, N, m0, n0);
  int e = be[m0 / bt];
  int nk = (K + wg::KT - 1) / wg::KT;
  int half = K / 2;
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
      bool straddle = KIND == 2 && k0 < half && k0 + wg::KT > half;
      wg::wait_empty(ring, q);
      // x_hi, x_lo and the bf16 stack tile, or one or two raw boxes
      mbar_arrive_expect_tx(full, 2 * wg::TILE_BYTES +
                                      (KIND == 0  ? wg::TILE_BYTES
                                       : straddle ? 2 * L::BOX
                                                  : L::BOX));
      wg::tma_2d(st + L::A_HI, &ta, k0, m0, full);
      wg::tma_2d(st + L::A_LO, &ta, k0, Tp + m0, full);
      if (KIND == 0) {
        wg::tma_3d(st + L::B, &tw, n0, k0, e, full);
        wg::tma_3d(st + L::B + wg::HALF_TILE, &tw, n0 + 64, k0, e, full);
      } else if (KIND == 1) {
        wg::tma_3d(st + L::RAW, &tw, n0, k0, e, full);
      } else {
        wg::tma_3d(st + L::RAW, &tw, n0, k0 < half ? k0 : k0 - half, e,
                   full);
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
        convert_stage<KIND>(st, q * wg::KT, half, threadIdx.x - 32);
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
  wg::consume<ST, FWD_CH>(
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
          uint64_t db = wg::mnmajor_desc(st + L::B, k);
          wg::wgmma_m64n128<0, 1>(acc, wg::kmajor_desc(a_hi, k), db,
                                  first && k == 0 ? 0 : 1);
          wg::wgmma_m64n128<0, 1>(acc, wg::kmajor_desc(a_lo, k), db, 1);
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

template <int KIND>
int launch_wgmma(const void* a, const void* w, const int* be, const float* s,
                 float* out, int Tp, int N, int K, int lda, int ldw, int bt,
                 int E, cudaStream_t stream) {
  CUtensorMap ta, tw;
  if (!wg::make_split_map(&ta, a, Tp, K, lda, wg::TILE))
    return static_cast<int>(cudaErrorInvalidValue);
  cuuint64_t rows = KIND == 2 ? K / 2 : K;  // stored rows an expert
  cuuint64_t dims[3] = {static_cast<cuuint64_t>(N), rows,
                        static_cast<cuuint64_t>(E)};
  cuuint64_t pitch = static_cast<cuuint64_t>(ldw) * (KIND == 0 ? 2 : 1);
  cuuint64_t strides[2] = {pitch, pitch * rows};
  bool ok;
  if (KIND == 0) {
    cuuint32_t box[3] = {64, wg::KT, 1};
    ok = wg::make_map(&tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, w, dims,
                      strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  } else {
    cuuint32_t box[3] = {wg::TILE, wg::KT, 1};
    ok = wg::make_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, w, dims,
                      strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = FwdStage<KIND>::SMEM;
  cudaFuncSetAttribute(grouped_gemm_wgmma<KIND>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  int tiles = (Tp / wg::TILE) * ((N + wg::TILE - 1) / wg::TILE);
  grouped_gemm_wgmma<KIND><<<tiles, wg::BLOCK, bytes, stream>>>(
      ta, tw, be, s, out, Tp, N, K, bt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gg
}  // namespace htog

// Kinds 0-2: a is x split, (2, Tp, lda) bf16 (hi then lo; split_bf16.cu),
// lda a multiple of 8; kind 3: a is x (Tp, lda) fp32, lda a multiple of 4
// with zero columns from K to lda. Tp a multiple of bt and bt of 128; K
// even for kind 2; w the stack, (E, K, ldw) or for kind 2 (E, K/2, ldw),
// ldw >= N with rows of a multiple of 16 bytes (kind 3: of 4 floats), E
// experts; block_expert (Tp / bt,) int32 in [0, E); s (E, 1, N) fp32 or
// null; out (Tp, N) fp32. Bases 16-byte aligned. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unknown kind or a tensor map the driver refuses).
extern "C" int grouped_gemm(const void* a, const void* w,
                            const void* block_expert, const void* s,
                            void* out, int Tp, int N, int K, int lda,
                            int ldw, int bt, int E, int kind,
                            void* stream) {
  using namespace htog;
  int blocks = (Tp / BM) * ((N + BN - 1) / BN);
  auto be = static_cast<const int*>(block_expert);
  auto sf = static_cast<const float*>(s);
  auto of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      return gg::launch_wgmma<0>(a, w, be, sf, of, Tp, N, K, lda, ldw, bt,
                                 E, st);
    case 1:
      return gg::launch_wgmma<1>(a, w, be, sf, of, Tp, N, K, lda, ldw, bt,
                                 E, st);
    case 2:
      return gg::launch_wgmma<2>(a, w, be, sf, of, Tp, N, K, lda, ldw, bt,
                                 E, st);
    case 3:
      gg::grouped_gemm_ffma<<<blocks, THREADS, 0, st>>>(
          static_cast<const float*>(a), static_cast<const float*>(w), be, sf,
          of, Tp, N, K, lda, ldw, bt);
      return static_cast<int>(cudaGetLastError());
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
