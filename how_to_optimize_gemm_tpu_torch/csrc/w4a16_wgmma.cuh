// The W4A16 GEMMs on Hopper's bf16 warpgroup MMA, one body for two
// kernels: out = (A @ decode(P)) * sw[j] with fp32 sums (w4a16_gemm_noc.cu,
// the serving linear), and C = (A @ decode(P)) * sw[j] + C in place
// (w4a16_gemm.cu, rung 07). A (M, K) bf16 row-major, P (Kp/2, N) int8
// packed nibbles (w4a8.cuh), sw (1, N) float32, out (M, N) float32, C
// (M, N) float32 read by the "+ C" epilogue. Also the bit decode of packed
// nibbles into bf16 pairs, which the decode GEMV (w4a16_gemv.cu) shares.
//
// w4a8_wgmma.cuh's walk in bf16. Operands swapped: each output tile is
// computed as out^T = W^T . A^T, so the decoded weights are wgmma's A, held
// in registers, and never go back to shared memory; A is wgmma's B, K-major
// as it lies, read from its 128-byte-swizzled boxes by descriptor.
// wgmma.m64nBTk16.f32.bf16.bf16: a 64-row slab of W^T (64 output columns)
// times BT tokens, 16 K values deep. A 128-byte line holds 64 bf16 K
// values, so a stage's 128 + 128 K rows take four activation boxes.
//
// Block: w4a8_wgmma.cuh's. 288 threads, one block an SM, a persistent grid
// walking tiles of BT tokens x 256 output columns in groups of GROUP_T
// token tiles (w4::tile_of), the token tile chosen as there (w4::token_tile).
// Warps 0-7 are two consumer warpgroups, 128 output columns (two slabs)
// each; warp 8's lane 0 is the producer.
//
// Ring (wgmma.cuh's full and empty barriers, as many stages as fit beside
// the "+ C" epilogue's staging: 2 at BT = 128, 3 at 64, with the staging
// or without): stage st of a tile takes the packed rows
// 256 (st / 2) + 128 (st % 2) .. + 127, one 128 x 128 box for each
// consumer's columns. Their low nibbles are K rows
// k = 512 (st / 2) + 128 (st % 2) .. + 127 and their high nibbles K rows
// k + 256 .. k + 383 (w4a8.cuh), so the stage also takes the four
// activation boxes of those K columns (k, k + 64, k + 256, k + 320), and
// each packed byte is read once per tile. The activation map's K extent is
// K: columns past it, and boxes wholly past it, arrive as zeros, so packed
// rows past K add nothing whatever they hold; rows past M and columns past
// N are zeros and are not stored.
//
// Consumer thread (warp w of its warpgroup, lane = 4 g + t): its A
// fragments hold slab rows g and g + 8 of both slabs, which are the four
// adjacent output columns c = 4 (8 w + g) .. + 3 of its warpgroup's 128
// (column c + 2 s + h is slab s's row g + 8 h), at K rows 2 t, 2 t + 1 and
// 2 t + 8, 2 t + 9 of each 16-deep step. So per step it loads one 32-bit
// word (those four columns) from each of the packed rows 2 t, 2 t + 1,
// 2 t + 8 and 2 t + 9 (32 distinct banks under the swizzle), pairs a
// column's bytes of two rows with __byte_perm and decodes each pair's low
// nibbles (this step's fragments for both slabs) and high nibbles (the
// matching step 256 K rows on) into bf16 pairs with bit operations: four
// fragments, four wgmmas, issued while the step before is still in flight.
// The same layout makes the epilogue's stores whole: a thread's four
// columns of a token are one float4, eight lanes a 128-byte line.
//
// Epilogue: __fmul_rn(acc, sw[j]), the plain version's order. The products
// are exact in fp32 (bf16 A times weights in [-8, 7]); the tensor cores sum
// them in another order than the plain version (and do not round each add
// as IEEE does), so the two agree to a stated tolerance. Each thread stores
// its own sums while the producer fills the ring with the next tile's
// stages. Adding C (ADD_C, w4a8_wgmma.cuh's Epilogue), each consumer warp
// stages its 32 columns a pass of C_STAGING::T tokens in one of its
// C_STAGING::B buffers and the tensor-map unit adds each into C in L2 (one
// round-to-nearest add: the plain version's y + C; each thread adds C
// where its rows are no 16-byte multiple). K3's staging (two buffers of 32
// tokens, 64 KB) would leave one 96 KB stage at BT = 128, so rung 07's
// staging takes 32 KB.
#pragma once

#include <cuda_bf16.h>

#include "w4a8_wgmma.cuh"

namespace htog {

// Byte c (0..3) of x and byte c of y in the low bytes of a word's two
// 16-bit halves, x's in the low half (the bytes above are not read).
__device__ __forceinline__ uint32_t byte_pair(uint32_t x, uint32_t y,
                                              int c) {
  return __byte_perm(x, y, c | (c << 4) | ((4 + c) << 8) | ((4 + c) << 12));
}

// v - 136 in both bf16 halves, exact for the values below.
__device__ __forceinline__ uint32_t bf16x2_minus_136(uint32_t v) {
  __nv_bfloat162 r = __hsub2(
      *reinterpret_cast<const __nv_bfloat162*>(&v),
      __halves2bfloat162(__ushort_as_bfloat16(0x4308),
                         __ushort_as_bfloat16(0x4308)));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// The weights of a byte_pair word as a bf16 pair: the low nibbles (offset
// binary: u | 0x4300 is the bf16 128 + u, minus 136 exactly u - 8), or the
// high nibbles (two's complement: ^ 8 makes them offset binary). Integers
// up to 256 are exact in bf16.
__device__ __forceinline__ uint32_t bf16x2_lo(uint32_t p) {
  return bf16x2_minus_136((p & 0x000F000Fu) | 0x43004300u);
}
__device__ __forceinline__ uint32_t bf16x2_hi(uint32_t p) {
  return bf16x2_minus_136(((p >> 4) & 0x000F000Fu) ^ 0x43084308u);
}

namespace w16 {

using w4::PACK_ROWS;
using w4::PK_BYTES;
using w4::SMEM_LIMIT;
using w4::THREADS;
using w4::TILE_N;

// Rung 07's "+ C" staging: one buffer of 32 tokens a consumer warp (32 KB
// in all). It ran 0.3-1.0% faster than two buffers of 16 tokens at M = N =
// K = 4,096 on an H100 in two calls, within their spread at 2,048
// (harness/flash_variants.py --group w4a16, variant c16x2; PERF.md).
using C_STAGING = w4::Staging<32, 1>;

// Stage layout: A's four boxes (BT lines of 64 K values each: the low
// range's K rows k .. k + 63 and k + 64 .., the high range's k + 256 ..
// and k + 320 ..), then the two consumers' packed boxes (128 lines of 128
// columns); the ring's stages, then, adding C, the staging, then the
// barriers.
template <int BT, bool ADD_C>
struct Layout {
  static constexpr int A_BYTES = BT * wg::LINE;
  static constexpr int STAGE = 4 * A_BYTES + 2 * PK_BYTES;
  static constexpr int OUT = ADD_C ? C_STAGING::BYTES : 0;
  static constexpr int ST =
      (SMEM_LIMIT - wg::ATOM - 256 - OUT) / STAGE;   // stages of the ring
  static constexpr int BARS = static_cast<int>(sizeof(wg::Ring<ST>));
  static constexpr int SMEM = ST * STAGE + OUT + wg::ATOM + BARS +
                              (ADD_C ? C_STAGING::BARS : 0);
  static_assert(BARS + C_STAGING::BARS <= 256, "the barriers' bytes");
  static_assert(ST >= 2, "a stage in flight while one is read");
  static_assert(SMEM <= SMEM_LIMIT, "the ring fits a block's shared memory");
  static_assert(BT % 8 == 0 && BT <= 256, "a wgmma N");
};

// The four A fragments of 16-deep step I of a stage from the consumer's
// packed box: f[0], f[1] the low nibbles for slabs 0 and 1 (K rows
// 16 I .. of the stage's low range), f[2], f[3] the high ones (the same
// rows of its high range). off[j]: the byte offset of this thread's word
// in the box's row 2 t + (j & 1) + 8 (j >> 1) (swizzled: the 16-byte chunk
// index XORed with the row's index mod 8, which step I's rows 16 I + ...
// keep).
template <int I>
__device__ __forceinline__ void fragments(const uint8_t* box,
                                          const int (&off)[4],
                                          uint32_t (&f)[4][4]) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    w[j] = *reinterpret_cast<const uint32_t*>(box + 16 * I * wg::LINE +
                                              off[j]);
  // column 2 s + h: rows 2 t, 2 t + 1 (p0) and 2 t + 8, 2 t + 9 (p1)
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t p0 = byte_pair(w[0], w[1], 2 * s + h);
      uint32_t p1 = byte_pair(w[2], w[3], 2 * s + h);
      f[s][h] = bf16x2_lo(p0);
      f[s][2 + h] = bf16x2_lo(p1);
      f[2 + s][h] = bf16x2_hi(p0);
      f[2 + s][2 + h] = bf16x2_hi(p1);
    }
}

// One consumer's wgmmas of step I: f's low fragments against A's low
// boxes, the high ones against its high boxes, each slab into its sums.
template <int BT, int I>
__device__ __forceinline__ void issue(float (&acc)[2][BT / 2],
                                      const uint32_t (&f)[4][4],
                                      uint32_t a_stage, int accumulate) {
  constexpr int A_BYTES = BT * wg::LINE;
  uint64_t dlo = wg::kmajor_desc(a_stage + (I / 4) * A_BYTES, I % 4);
  uint64_t dhi = wg::kmajor_desc(a_stage + (2 + I / 4) * A_BYTES, I % 4);
  wg::Wgmma<BT>::template rs<0>(acc[0], f[0], dlo, accumulate);
  wg::Wgmma<BT>::template rs<0>(acc[1], f[1], dlo, accumulate);
  wg::Wgmma<BT>::template rs<0>(acc[0], f[2], dhi, 1);
  wg::Wgmma<BT>::template rs<0>(acc[1], f[3], dhi, 1);
}

// ta: A (M, K) bf16, boxes of 64 K x BT tokens; tw: P (rows, N) int8,
// boxes of 128 columns x 128 packed rows; tc and tcin (read where the
// path needs them): out and C (M, ldc) fp32, boxes of 32 columns x
// C_STAGING::T tokens; all with the 128-byte swizzle. c is read only where
// ADD_C, along `path` (w4::CPath).
template <int BT, bool ADD_C>
__global__ void __launch_bounds__(THREADS, 1)
    w4a16_wgmma(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tw,
                const __grid_constant__ CUtensorMap tc,
                const __grid_constant__ CUtensorMap tcin, const float* sw,
                const float* c, float* out, int M, int N, int K, int ldc,
                int path) {
  using L = Layout<BT, ADD_C>;
  using S = C_STAGING;
  constexpr int ST = L::ST;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = wg::align_1024(smem_raw);
  auto& ring =
      *reinterpret_cast<wg::Ring<ST>*>(smem + ST * L::STAGE + L::OUT);
  uint64_t* cbars = reinterpret_cast<uint64_t*>(
      smem + ST * L::STAGE + L::OUT + L::BARS);
  int num_t = (M + BT - 1) / BT;
  int num_n = (N + TILE_N - 1) / TILE_N;
  int tiles = num_t * num_n;
  int nst = w4::stages(K);
  int warp = threadIdx.x >> 5;
  int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    if (ADD_C)
      for (int b = 0; b < 8 * S::B; ++b) mbar_init(&cbars[b], 1);
    ring.init();
  }
  __syncthreads();

  if (warp == 8) {
    if (lane != 0) return;
    int q = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int ti, tj;
      w4::tile_of(t, num_t, num_n, ti, tj);
      for (int st = 0; st < nst; ++st, ++q) {
        int s = q % ST;
        uint8_t* stage = smem + s * L::STAGE;
        uint64_t* full = &ring.full[s];
        int k0 = (st >> 1) * 512 + (st & 1) * 128;
        int prow = (st >> 1) * 256 + (st & 1) * 128;
        wg::wait_empty(ring, q);
        mbar_arrive_expect_tx(full, L::STAGE);
#pragma unroll
        for (int b = 0; b < 4; ++b)
          wg::tma_2d(stage + b * L::A_BYTES, &ta,
                     k0 + 256 * (b >> 1) + 64 * (b & 1), ti * BT, full);
        wg::tma_2d(stage + 4 * L::A_BYTES, &tw, tj * TILE_N, prow, full);
        wg::tma_2d(stage + 4 * L::A_BYTES + PK_BYTES, &tw,
                   tj * TILE_N + 128, prow, full);
      }
    }
    return;
  }

  int cw = warp >> 2;                  // consumer warpgroup
  int g = lane >> 2;
  int tq = lane & 3;
  int col = 4 * (8 * (warp & 3) + g);  // this thread's 4 columns of 128
  int off[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int r = 2 * tq + (j & 1) + 8 * (j >> 1);
    off[j] = r * wg::LINE + ((((col >> 4) ^ (r & 7)) << 4) | (col & 15));
  }
  w4::Epilogue<BT, S, ADD_C> epi{
      &tc, &tcin, c, out, M, N, ldc, path,
      !ADD_C && (ldc & 3) == 0 &&
          (reinterpret_cast<uintptr_t>(out) & 15) == 0,
      smem + ST * L::STAGE + warp * S::B * S::BOX, cbars + warp * S::B,
      lane, g, tq, 0u};
  uint32_t base = smem_u32(smem);
  float acc[2][BT / 2];
  uint32_t f[2][4][4];
  int q = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int ti, tj;
    w4::tile_of(t, num_t, num_n, ti, tj);
    epi.prefetch(ti * BT, tj * TILE_N + 128 * cw + col);
    int prev = -1;   // the slot whose last products may still be in flight
    for (int st = 0; st < nst; ++st, ++q) {
      int s = q % ST;
      uint32_t a_stage = base + s * L::STAGE;
      const uint8_t* box = smem + s * L::STAGE + 4 * L::A_BYTES +
                           cw * PK_BYTES;
      int fresh = st == 0 ? 0 : 1;
      wg::wait(&ring.full[s], (q / ST) & 1);
      // step i's fragments are decoded while step i - 1's products run;
      // step i's wait<1> frees the fragments of step i - 1
#define W16_STEP(I)                                                    \
  fragments<I>(box, off, f[(I) & 1]);                                  \
  wg::wgmma_fence();                                                   \
  issue<BT, I>(acc, f[(I) & 1], a_stage, (I) == 0 ? fresh : 1);        \
  wg::wgmma_commit();                                                  \
  wg::wgmma_wait<1>();                                                 \
  wg::fence_regs(f[((I) + 1) & 1]);
      W16_STEP(0)
      if (prev >= 0) wg::release(ring, prev);
      W16_STEP(1)
      W16_STEP(2)
      W16_STEP(3)
      W16_STEP(4)
      W16_STEP(5)
      W16_STEP(6)
      W16_STEP(7)
#undef W16_STEP
      prev = s;
    }
    wg::wgmma_wait<0>();
    wg::fence_regs(acc[0]);
    wg::fence_regs(acc[1]);
    wg::fence_regs(f[1]);
    wg::release(ring, prev);

    // epilogue: token tok's columns n .. n + 3 are
    // acc[0][4j + e], acc[0][4j + 2 + e], acc[1][4j + e], acc[1][4j + 2 + e]
    // for tok = 8 j + 2 t + e
    int n = tj * TILE_N + 128 * cw + col;
    float w4[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) w4[x] = n + x < N ? sw[n + x] : 0.0f;
    epi.tile(ti * BT, n, [&](int j, int e, int, float (&y)[4]) {
      float v[4] = {acc[0][4 * j + e], acc[0][4 * j + 2 + e],
                    acc[1][4 * j + e], acc[1][4 * j + 2 + e]};
#pragma unroll
      for (int x = 0; x < 4; ++x) y[x] = __fmul_rn(v[x], w4[x]);
    });
  }
  epi.finish();
}

// Launches w4a16_wgmma<BT, ADD_C> over the (M, N) output: one block an
// SM, at most one a tile. a (M, lda) bf16 with K <= lda valid columns, lda
// a multiple of 8 (16-byte rows), packed (Kp/2, ldb) int8 with
// round_up(K, 512) <= Kp, c and out (M, ldc) float32 (c is out where
// ADD_C, rung 07 in place; null where not); bases 16-byte aligned.
// Returns a cudaError_t as an int.
template <int BT, bool ADD_C>
int launch_bt(const void* a, const void* packed, const float* sw,
              const float* c, float* out, int M, int N, int K, int lda,
              int ldb, int ldc, int sms, cudaStream_t stream) {
  using L = Layout<BT, ADD_C>;
  CUtensorMap ta, tw, tc, tcin;
  cuuint64_t adims[2] = {static_cast<cuuint64_t>(K),
                         static_cast<cuuint64_t>(M)};
  cuuint64_t astrides[1] = {static_cast<cuuint64_t>(lda) * 2};
  cuuint32_t abox[2] = {64, BT};
  int rows = (K + 511) / 512 * 256;
  cuuint64_t wdims[2] = {static_cast<cuuint64_t>(N),
                         static_cast<cuuint64_t>(rows)};
  cuuint64_t wstrides[1] = {static_cast<cuuint64_t>(ldb)};
  cuuint32_t wbox[2] = {128, PACK_ROWS};
  if (!wg::make_map(&ta, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a, adims,
                    astrides, abox, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !wg::make_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, packed, wdims,
                    wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  int path = ADD_C ? w4::c_path<C_STAGING>(c, out, M, N, ldc, &tc, &tcin)
                   : w4::C_THREADS;
  if (path != w4::C_LOAD_STORE) tcin = ta;   // not read
  if (path == w4::C_THREADS) tc = ta;
  cudaError_t err = cudaFuncSetAttribute(
      w4a16_wgmma<BT, ADD_C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  int tiles = (M + BT - 1) / BT * ((N + TILE_N - 1) / TILE_N);
  w4a16_wgmma<BT, ADD_C>
      <<<tiles < sms ? tiles : sms, THREADS, L::SMEM, stream>>>(
          ta, tw, tc, tcin, sw, c, out, M, N, K, ldc, path);
  return static_cast<int>(cudaGetLastError());
}

// Launches w4a16_wgmma<w4::token_tile(M, N, SMs), ADD_C>; *bt is set to
// that tile.
template <bool ADD_C>
int launch(const void* a, const void* packed, const void* sw, const void* c,
           void* out, int M, int N, int K, int lda, int ldb, int ldc,
           cudaStream_t stream, int* bt) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  *bt = w4::token_tile(M, N, sms);
  auto run = *bt == 64 ? launch_bt<64, ADD_C> : launch_bt<128, ADD_C>;
  return run(a, packed, static_cast<const float*>(sw),
             static_cast<const float*>(c), static_cast<float*>(out), M, N, K,
             lda, ldb, ldc, sms, stream);
}

}  // namespace w16
}  // namespace htog
