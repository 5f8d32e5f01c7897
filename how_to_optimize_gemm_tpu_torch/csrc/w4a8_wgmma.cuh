// The int8 prefill GEMMs on Hopper's int8 warpgroup MMA, one body for
// three kernels: out = f32(QA @ W as int32) * sa[i] * sw[j] (+ C), W
// either the packed int4 weights decoded (w4a8.cuh; w4a8_gemm_noc.cu, and
// K3 w4a8_gemm.cu with C) or a plain (K, N) int8 matrix (int8_gemm_noc.cu).
// QA (M, K) int8 row-major, sa (M, 1) and sw (1, N) float32, out (M, N)
// float32, C (M, N) float32 read by the "+ C" epilogue (it may be out).
//
// Operands swapped: each output tile is computed as out^T = W^T . QA^T,
// so the weights are wgmma's A, held in registers, and never go back to
// shared memory; QA is wgmma's B, K-major as it lies (8-bit types have no
// transposed form), read from its swizzled box by descriptor. The N-major
// weights are turned around on their way into the registers, which is
// where the packed ones are decoded too. wgmma.m64nBTk32.s32.s8.s8: a
// 64-row slab of W^T (64 output columns) times BT tokens, 32 K values deep.
//
// Block: 288 threads, one block an SM, a persistent grid walking tiles of
// BT tokens x 256 output columns in groups of GROUP_T token tiles (the
// blocks running at once share a few token tiles of QA and the weights in
// L2). Warps 0-7 are two consumer warpgroups, 128 output columns (two
// slabs) each; warp 8's lane 0 is the producer. Registers bound the tile:
// nine warps put three on one of the SM's four schedulers, whose quarter
// of the register file leaves a thread 168, as 384 threads would; BT = 128
// (128 int32 sums, two sets of A fragments) takes all 168 with a 4-byte
// spill on the packed weights. ptxas serializes the products where a
// step's fragments are written while the step before is in flight (its
// note C7513); on an H100 that still ran faster than draining each step
// first (wait<0>, which clears C7513 but not the register limit), by 2-3%,
// and than 96-token tiles (145 registers), which lose rounds of the grid
// (harness/flash_variants.py --group w4a8; PERF.md).
//
// Ring (wgmma.cuh's full and empty barriers, as many stages as fit beside
// the "+ C" epilogue's staging). A weight box is 128 rows (packed rows, or
// K rows) x 128 columns, one for each consumer's columns; a QA box is BT
// tokens x 128 K. A stage holds BOXES QA boxes, then consumer 0's weight
// boxes, then consumer 1's:
// - Packed (3 stages at BT = 128, 4 at 64, two ran as fast; adding C 2
//   and 3): stage st of a tile takes the packed rows 256 (st / 2) +
//   128 (st % 2) .. + 127. Their low nibbles are K rows k = 512 (st / 2)
//   + 128 (st % 2) .. + 127 and their high nibbles K rows k + 256 ..
//   k + 383 (w4a8.cuh), so the stage also takes the two QA boxes of those
//   K columns, and each packed byte is read once per tile.
// - PlainS8<B> (B = 1: 4 stages at BT = 128, 5 at 64; B = 2: 2 at both):
//   stage st takes K rows 128 B st .. + 128 B - 1 of QA and of W, B boxes
//   of each.
// The int32 sums are exact in any order. The QA map's K extent is K:
// columns past it, and boxes wholly past it, arrive as zeros, so weight
// rows past K add nothing whatever they hold; rows past M and columns past
// N are zeros and are not stored.
//
// Consumer thread (warp w of its warpgroup, lane = 4 g + t): its A
// fragments hold slab rows g and g + 8 of both slabs, which are the four
// adjacent output columns c = 4 (8 w + g) .. + 3 of its warpgroup's 128
// (column c + 2 s + h is slab s's row g + 8 h), at K bytes 4 t .. 4 t + 3
// and 16 + 4 t .. of each 32-deep step. So per step it loads one 32-bit
// word (those four columns) from each of the 8 box rows 4 t + j and
// 16 + 4 t + j of each of its weight boxes, for packed weights decodes
// the low nibbles (this step's fragments for both slabs) and the high ones
// (the matching step 256 K rows on), and turns each 4 x 4 byte group
// around with __byte_perm: two fragments a QA box, as many wgmmas, issued
// while the step before is still in flight. The same layout makes the
// epilogue's stores whole: a thread's four columns of a token are one
// float4, eight lanes a 128-byte line.
//
// Epilogue: (float(acc) * sa[i]) * sw[j] with __fmul_rn, the plain
// version's order, each thread storing its own four columns of a token
// as one float4 while the producer fills the ring with the next tile's
// stages. Adding C (class Epilogue below, which w4a16_wgmma.cuh's body
// shares), a consumer warp owns 32 whole columns of the tile and stages
// its sums a pass of S::T tokens at a time in one of its S::B
// shared-memory buffers (the instance's Staging). In place (c is out,
// rows of 16-byte multiples: K3), the tensor-map unit adds each buffer
// into C in L2 (cp.reduce.async.bulk.tensor .add, one round-to-nearest
// add, so C + y is the plain version's y + C bit for bit) while the
// consumers go on; C is not read into registers, nor held across the main
// loop. Into a fresh output (K1), the warp's lane 0 loads C's box of the
// pass into the buffer by tensor map under a barrier of its own (the
// tile's first S::B passes before its main loop, each later one as soon
// as the store S::B passes before has read the buffer), the threads add
// it to their sums with __fadd_rn where they stage them, and the
// tensor-map unit stores the buffer into out. Elsewhere (C's rows no
// 16-byte multiple) each thread adds c[i, j] with __fadd_rn an element at
// a time. So out equals the plain version bit for bit.
#pragma once

#include "w4a8.cuh"
#include "wgmma.cuh"

namespace htog {
namespace w4 {

constexpr int THREADS = 288;       // two consumer warpgroups, a producer
constexpr int TILE_N = 256;        // output columns a tile, 128 a consumer
constexpr int PACK_ROWS = 128;     // rows of a weight box
constexpr int GROUP_T = 8;         // token tiles a group of the walk
constexpr int PK_BYTES = PACK_ROWS * wg::LINE;   // one weight box
constexpr int SMEM_LIMIT = 232448;

// Stages of a tile on packed weights: pack block b's halves h with K rows
// from 512 b + 128 h below K.
__device__ __forceinline__ int stages(int K) {
  int rest = K % 512;
  return 2 * (K / 512) + (rest > 128 ? 2 : rest > 0 ? 1 : 0);
}

// The "+ C" epilogue's staging: per consumer warp BUFS buffers of TOKENS
// tokens x the warp's 32 columns fp32 (one 128-byte swizzled line a
// token), each the source of one tensor-map reduction into C in place, or
// (LOAD: C into a fresh output) the target of one load of C and the
// source of one store into out, with a barrier each for those loads
// (after the ring's barriers).
constexpr int OUT_TOKENS = 32;   // K3's pass (two buffers a warp)

template <int TOKENS, int BUFS, bool LOAD = false>
struct Staging {
  static constexpr int T = TOKENS;
  static constexpr int B = BUFS;
  static constexpr bool LOAD_C = LOAD;
  static constexpr int BOX = TOKENS * wg::LINE;
  static constexpr int BYTES = 8 * BUFS * BOX;
  static constexpr int BARS = 8 * BUFS * 8;
  static_assert(TOKENS % 8 == 0 && BUFS >= 1, "whole 8-token groups");
};

// The weight sources. BOXES: QA boxes a stage (two fragments each);
// W_BOXES: weight boxes a stage and consumer; rows(K): the weight map's
// rows; nst(K): stages of a tile; qa_k(st, b): the K column of QA box b of
// stage st; w_row(st, b): the map row of weight box b; Out: the staging
// of the "+ C" epilogue.
struct Packed {
  static constexpr bool PACKED = true;
  static constexpr int BOXES = 2;
  static constexpr int W_BOXES = 1;
  static int rows(int K) { return (K + 511) / 512 * 256; }
  static __device__ int nst(int K) { return stages(K); }
  static __device__ int qa_k(int st, int b) {
    return (st >> 1) * 512 + (st & 1) * 128 + 256 * b;
  }
  static __device__ int w_row(int st, int) {
    return (st >> 1) * 256 + (st & 1) * 128;
  }
  using Out = Staging<OUT_TOKENS, 2>;
};

template <int B, class O = Staging<OUT_TOKENS, 2>>
struct PlainS8 {
  static constexpr bool PACKED = false;
  static constexpr int BOXES = B;
  static constexpr int W_BOXES = B;
  using Out = O;
  static int rows(int K) { return K; }
  static __device__ int nst(int K) { return (K + 128 * B - 1) / (128 * B); }
  static __device__ int qa_k(int st, int b) { return 128 * (B * st + b); }
  static __device__ int w_row(int st, int b) { return 128 * (B * st + b); }
};

// Shared memory: the ring's stages, each QA's boxes (BT lines of 128 K
// each) then the two consumers' weight boxes (128 lines of 128 columns);
// then, adding C, the epilogue's staging; then the ring's barriers (and
// C's, within the 256 bytes kept for barriers).
template <int BT, class Src, bool ADD_C>
struct Layout {
  static constexpr int QA_BYTES = BT * wg::LINE;
  static constexpr int W_OFF = Src::BOXES * QA_BYTES;
  static constexpr int STAGE = W_OFF + 2 * Src::W_BOXES * PK_BYTES;
  static constexpr int OUT = ADD_C ? Src::Out::BYTES : 0;
  static constexpr int ST =
      (SMEM_LIMIT - wg::ATOM - 256 - OUT) / STAGE;   // stages of the ring
  static constexpr int BARS = static_cast<int>(sizeof(wg::Ring<ST>));
  static constexpr int SMEM = ST * STAGE + OUT + wg::ATOM + BARS +
                              (ADD_C ? Src::Out::BARS : 0);
  static_assert(BARS + Src::Out::BARS <= 256, "the barriers' bytes");
  static_assert(ST >= 2, "a stage in flight while one is read");
  static_assert(SMEM <= SMEM_LIMIT, "the ring fits a block's shared memory");
  static_assert(BT % 16 == 0 && BT <= 256, "a wgmma N for 8-bit types");
};

// Token tile (BT) for an (M, N) output on `sms` SMs: 64 where its tiles
// take no more rounds of the persistent grid than 128's, else 128. A
// 64-token tile decodes as many packed bytes as a 128-token one and took
// 0.78 of its time on an H100, so 64 wins only where 128 leaves SMs idle
// in its one round (chunks of 65-256 tokens: 0.031 against 0.040 ms) and
// lost at m = 512 x 11,008 (3 rounds against 2: 0.091 against 0.080 ms;
// harness/flash_variants.py --group w4a8, PERF.md).
inline int token_tile(int M, int N, int sms) {
  int num_n = (N + TILE_N - 1) / TILE_N;
  auto rounds = [&](int bt) {
    return ((M + bt - 1) / bt * num_n + sms - 1) / sms;
  };
  return rounds(64) <= rounds(128) ? 64 : 128;
}

// (token tile, column tile) of tile t of a num_t x num_n grid: groups of
// GROUP_T token tiles, the token tile fastest inside a group
// (ops/tuned.nt_tile_walk on (BT, TILE_N) tiles is the same walk).
__device__ __forceinline__ void tile_of(int t, int num_t, int num_n, int& i,
                                        int& j) {
  int per_group = GROUP_T * num_n;
  int first = (t / per_group) * GROUP_T;
  int gt = min(num_t - first, GROUP_T);
  int in_group = t % per_group;
  i = first + in_group % gt;
  j = in_group / gt;
}

// wgmma.m64nNk32.s32.s8.s8 with A from registers: a (four registers of
// four int8 each) in mma.m16n8k32's A layout within each warp's 16 rows
// ((row g, K bytes 4c ..), (g + 8, 4c ..), (g, 16 + 4c ..), (g + 8,
// 16 + 4c ..), g = lane / 4, c = lane % 4), B K-major from shared memory
// by descriptor, d holding N / 2 int32 sums a thread in wgmma.cuh's
// accumulator layout (for_each_pair). accumulate = 0 ignores d's old
// value. The A registers are read asynchronously: keep them (fence_regs)
// until the wgmma_wait that covers the product.
template <int N>
struct WgmmaS8;

template <>
struct WgmmaS8<64> {
  static __device__ __forceinline__ void rs(int (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate));
  }
};

template <>
struct WgmmaS8<128> {
  static __device__ __forceinline__ void rs(int (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
          "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
          "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
          "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate));
  }
};


// A 4 x 4 byte group turned around: w[j] holds row j's four bytes (one
// per column); column c becomes the word of its four rows, row 0 lowest.
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4],
                                           uint32_t (&c)[4]) {
  uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);
  uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
  uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);
  uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
  c[0] = __byte_perm(lo01, lo23, 0x5410);
  c[1] = __byte_perm(lo01, lo23, 0x7632);
  c[2] = __byte_perm(hi01, hi23, 0x5410);
  c[3] = __byte_perm(hi01, hi23, 0x7632);
}

// The A fragments of slabs 0 and 1 (f[0], f[1]) from the turned-around
// groups of box rows 4 t .. (g[0]) and 16 + 4 t .. (g[1]): column 2 s + h
// is slab s's row g + 8 h.
__device__ __forceinline__ void slab_fragments(const uint32_t (&g)[2][4],
                                               uint32_t (*f)[4]) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    f[s][0] = g[0][2 * s];
    f[s][1] = g[0][2 * s + 1];
    f[s][2] = g[1][2 * s];
    f[s][3] = g[1][2 * s + 1];
  }
}

// The 2 x BOXES A fragments of 32-deep step I of a stage from the
// consumer's weight boxes (PK_BYTES apart): for packed weights f[0], f[1]
// the low nibbles for slabs 0 and 1 (K rows 32 I .. of the stage's low
// range), f[2], f[3] the high ones (the same rows of its high range); for
// int8 weights f[2 b], f[2 b + 1] from box b. off[j]: the byte offset of
// this thread's word in the box's row 4 t + j (swizzled: the 16-byte chunk
// index XORed with the row's index mod 8, which is (4 t + j) mod 8 for
// every row read).
template <class Src, int I>
__device__ __forceinline__ void fragments(const uint8_t* box,
                                          const int (&off)[4],
                                          uint32_t (&f)[2 * Src::BOXES][4]) {
#pragma unroll
  for (int b = 0; b < Src::W_BOXES; ++b) {
    uint32_t lo[2][4], hi[2][4];
#pragma unroll
    for (int grp = 0; grp < 2; ++grp) {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[j] = *reinterpret_cast<const uint32_t*>(
            box + b * PK_BYTES + (32 * I + 16 * grp) * wg::LINE + off[j]);
      if constexpr (Src::PACKED) {
        uint32_t dl[4], dh[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dl[j] = decode_lo4(w[j]);
          dh[j] = decode_hi4(w[j]);
        }
        transpose4(dl, lo[grp]);
        transpose4(dh, hi[grp]);
      } else {
        transpose4(w, lo[grp]);
      }
    }
    slab_fragments(lo, f + 2 * b);
    if constexpr (Src::PACKED) slab_fragments(hi, f + 2);
  }
}

// One consumer's wgmmas of step I: f[2 b] and f[2 b + 1] against QA box b
// (QA_BYTES apart from qa), each slab into its own sums.
template <int BT, int BOXES, int I>
__device__ __forceinline__ void issue(int (&acc)[2][BT / 2],
                                      const uint32_t (&f)[2 * BOXES][4],
                                      uint32_t qa, int accumulate) {
#pragma unroll
  for (int b = 0; b < BOXES; ++b) {
    uint64_t d = wg::kmajor_desc(qa + b * BT * wg::LINE, I);
    WgmmaS8<BT>::rs(acc[0], f[2 * b], d, b == 0 ? accumulate : 1);
    WgmmaS8<BT>::rs(acc[1], f[2 * b + 1], d, b == 0 ? accumulate : 1);
  }
}

// Keeps the compiler from reading the sums before the wgmma_wait that
// covers their last product (wgmma.cuh's fence_regs).
template <int N>
__device__ __forceinline__ void fence_acc(int (&acc)[2][N]) {
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(acc[s][i])::"memory");
}

// How the "+ C" epilogue meets C (the launch picks one): each thread adds
// c itself; the tensor-map unit adds the staged sums into C in place; or C
// is loaded into the staging by tensor map and the sums stored from it
// (a staging with LOAD_C).
enum CPath { C_THREADS = 0, C_REDUCE = 1, C_LOAD_STORE = 2 };

// A consumer thread's epilogue of its tiles (int8_wgmma and
// w4a16_wgmma.cuh's body): for each token tok = tok0 + 8 j + 2 t + e of
// the tile, y(j, e, tok, v) gives the thread's four products of columns
// n .. n + 3 (n - 4 g is its warp's first column), which go to out, with C
// added where ADD_C along `path`. S: the staging; bufs, bars: the warp's
// buffers and their load barriers.
template <int BT, class S, bool ADD_C>
struct Epilogue {
  static constexpr int P = BT / S::T;   // staged passes a tile
  const CUtensorMap* tc;     // out: reductions or stores of the staging
  const CUtensorMap* tcin;   // C: loads into the staging
  const float* c;
  float* out;
  int M, N, ldc, path;
  bool vec;                  // out's rows whole float4s (no C)
  uint8_t* bufs;
  uint64_t* bars;
  int lane, g, tq;
  uint32_t phase;            // bit b: the parity of buffer b's next load

  // lane 0: C's box of pass p of the tile (tok0, n0) into buffer p % S::B
  // once the store out of it has read it
  __device__ __forceinline__ void load(int p, int tok0, int n0) {
    int b = p % S::B;
    bulk_wait_read<0>();
    mbar_arrive_expect_tx(bars + b, S::BOX);
    wg::tma_2d(bufs + b * S::BOX, tcin, n0, tok0 + S::T * p, bars + b);
  }

  // before a tile's main loop: C's first passes in flight
  __device__ __forceinline__ void prefetch(int tok0, int n) {
    if (ADD_C && S::LOAD_C && path == C_LOAD_STORE && lane == 0) {
#pragma unroll
      for (int p = 0; p < (S::B < P ? S::B : P); ++p)
        load(p, tok0, n - 4 * g);
    }
  }

  template <class Y>
  __device__ __forceinline__ void tile(int tok0, int n, Y y) {
    if (ADD_C && path != C_THREADS) {
      // the warp's 32 columns, S::T tokens a pass, in buffer p % S::B
      // (swizzled as the maps read it: the thread's float4 is 16-byte
      // chunk g of the token's line); lane 0 hands each to the tensor-map
      // unit, which adds it into C in L2 or stores it over out (clipped at
      // M and N) while the consumers go on. fp32 addition commutes, so
      // C + y is the plain version's y + C bit for bit.
      int n0 = n - 4 * g;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        int b = p % S::B;
        uint8_t* buf = bufs + b * S::BOX;
        if constexpr (S::LOAD_C) {
          wg::wait(bars + b, (phase >> b) & 1);   // C's box is in buf
          phase ^= 1u << b;
        } else {
          if (lane == 0) bulk_wait_read<S::B - 1>();   // buf's last copy
          __syncwarp();
        }
#pragma unroll
        for (int jj = 0; jj < S::T / 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            int j = p * (S::T / 8) + jj;
            int r = 8 * jj + 2 * tq + e;
            float v[4];
            y(j, e, tok0 + 8 * j + 2 * tq + e, v);
            float4* at = reinterpret_cast<float4*>(buf + r * wg::LINE +
                                                   ((g ^ (r & 7)) << 4));
            if constexpr (S::LOAD_C) {
              float4 cv = *at;
              v[0] = __fadd_rn(v[0], cv.x);
              v[1] = __fadd_rn(v[1], cv.y);
              v[2] = __fadd_rn(v[2], cv.z);
              v[3] = __fadd_rn(v[3], cv.w);
            }
            *at = make_float4(v[0], v[1], v[2], v[3]);
          }
        }
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) {
          wg::tma_out_2d<!S::LOAD_C>(tc, buf, n0, tok0 + S::T * p);
          bulk_commit();
          if (S::LOAD_C && p + S::B < P) load(p + S::B, tok0, n0);
        }
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        int tok = tok0 + 8 * j + 2 * tq + e;
        if (tok >= M) continue;
        float v[4];
        y(j, e, tok, v);
        size_t at = static_cast<size_t>(tok) * ldc + n;
        if (vec && n + 3 < N) {
          *reinterpret_cast<float4*>(out + at) =
              make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int x = 0; x < 4; ++x)
            if (n + x < N) out[at + x] = ADD_C ? __fadd_rn(v[x], c[at + x])
                                               : v[x];
        }
      }
    }
  }

  // the tensor-map unit done with the staging before the block ends
  __device__ __forceinline__ void finish() {
    if (ADD_C && path != C_THREADS && lane == 0) bulk_wait_all();
  }
};

// The epilogue's C path for c and out (M, ldc) fp32 and a staging S, and
// the maps it needs, boxes of 32 columns x S::T tokens with the 128-byte
// swizzle: the loads of C and the stores into out where S loads C, the
// reductions into out where c is out, wherever the rows are 16-byte
// multiples on 16-byte bases; else each thread adds C.
template <class S>
int c_path(const float* c, float* out, int M, int N, int ldc,
           CUtensorMap* tc, CUtensorMap* tcin) {
  if (c == nullptr || ldc % 4 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(c) % 16 != 0)
    return C_THREADS;
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(N),
                        static_cast<cuuint64_t>(M)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(ldc) * 4};
  cuuint32_t box[2] = {32, static_cast<cuuint32_t>(S::T)};
  if (!wg::make_map(tc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, out, dims,
                    strides, box, CU_TENSOR_MAP_SWIZZLE_128B))
    return C_THREADS;
  if (!S::LOAD_C) return c == out ? C_REDUCE : C_THREADS;
  if (!wg::make_map(tcin, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, c, dims,
                    strides, box, CU_TENSOR_MAP_SWIZZLE_128B))
    return C_THREADS;
  return C_LOAD_STORE;
}

// tqa: QA (M, K) int8, boxes of 128 K x BT tokens; tw: the weights (rows,
// N) int8, boxes of 128 columns x 128 rows; tc and tcin (read where the
// path needs them): out and C (M, ldc) fp32, boxes of 32 columns x
// Src::Out::T tokens; all with the 128-byte swizzle. c is read only where
// ADD_C, along `path` (CPath).
template <int BT, class Src, bool ADD_C>
__global__ void __launch_bounds__(THREADS, 1)
    int8_wgmma(const __grid_constant__ CUtensorMap tqa,
               const __grid_constant__ CUtensorMap tw,
               const __grid_constant__ CUtensorMap tc,
               const __grid_constant__ CUtensorMap tcin, const float* sa,
               const float* sw, const float* c, float* out, int M, int N,
               int K, int ldc, int path) {
  using L = Layout<BT, Src, ADD_C>;
  using S = typename Src::Out;
  constexpr int ST = L::ST;
  constexpr int NF = 2 * Src::BOXES;   // A fragments a step
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = wg::align_1024(smem_raw);
  auto& ring =
      *reinterpret_cast<wg::Ring<ST>*>(smem + ST * L::STAGE + L::OUT);
  int num_t = (M + BT - 1) / BT;
  int num_n = (N + TILE_N - 1) / TILE_N;
  int tiles = num_t * num_n;
  int nst = Src::nst(K);
  uint64_t* cbars = reinterpret_cast<uint64_t*>(
      smem + ST * L::STAGE + L::OUT + L::BARS);
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
      tile_of(t, num_t, num_n, ti, tj);
      for (int st = 0; st < nst; ++st, ++q) {
        int s = q % ST;
        uint8_t* stage = smem + s * L::STAGE;
        uint64_t* full = &ring.full[s];
        wg::wait_empty(ring, q);
        mbar_arrive_expect_tx(full, L::STAGE);
#pragma unroll
        for (int b = 0; b < Src::BOXES; ++b)
          wg::tma_2d(stage + b * L::QA_BYTES, &tqa, Src::qa_k(st, b),
                     ti * BT, full);
#pragma unroll
        for (int cw = 0; cw < 2; ++cw)
#pragma unroll
          for (int b = 0; b < Src::W_BOXES; ++b)
            wg::tma_2d(stage + L::W_OFF + (cw * Src::W_BOXES + b) * PK_BYTES,
                       &tw, tj * TILE_N + 128 * cw, Src::w_row(st, b), full);
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
    int r = 4 * tq + j;
    off[j] = r * wg::LINE + ((((col >> 4) ^ (r & 7)) << 4) | (col & 15));
  }
  Epilogue<BT, S, ADD_C> epi{
      &tc, &tcin, c, out, M, N, ldc, path,
      !ADD_C && (ldc & 3) == 0 &&
          (reinterpret_cast<uintptr_t>(out) & 15) == 0,
      smem + ST * L::STAGE + warp * S::B * S::BOX, cbars + warp * S::B,
      lane, g, tq, 0u};
  uint32_t base = smem_u32(smem);
  int acc[2][BT / 2];
  uint32_t f[2][NF][4];
  int q = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int ti, tj;
    tile_of(t, num_t, num_n, ti, tj);
    epi.prefetch(ti * BT, tj * TILE_N + 128 * cw + col);
    int prev = -1;   // the slot whose last products may still be in flight
    for (int st = 0; st < nst; ++st, ++q) {
      int s = q % ST;
      uint32_t qa = base + s * L::STAGE;
      const uint8_t* box = smem + s * L::STAGE + L::W_OFF +
                           cw * Src::W_BOXES * PK_BYTES;
      int fresh = st == 0 ? 0 : 1;
      wg::wait(&ring.full[s], (q / ST) & 1);
      // step i's fragments are made while step i - 1's products run;
      // step i's wait<1> frees the fragments of step i - 1
#define W4_STEP(I)                                                     \
  fragments<Src, I>(box, off, f[(I) & 1]);                             \
  wg::wgmma_fence();                                                   \
  issue<BT, Src::BOXES, I>(acc, f[(I) & 1], qa, (I) == 0 ? fresh : 1); \
  wg::wgmma_commit();                                                  \
  wg::wgmma_wait<1>();                                                 \
  wg::fence_regs(f[((I) + 1) & 1]);
      W4_STEP(0)
      if (prev >= 0) wg::release(ring, prev);
      W4_STEP(1)
      W4_STEP(2)
      W4_STEP(3)
#undef W4_STEP
      prev = s;
    }
    wg::wgmma_wait<0>();
    fence_acc(acc);
    wg::fence_regs(f[1]);
    wg::release(ring, prev);

    // epilogue: token tok's columns n .. n + 3 are
    // acc[0][4j + e], acc[0][4j + 2 + e], acc[1][4j + e], acc[1][4j + 2 + e]
    // for tok = 8 j + 2 t + e
    int n = tj * TILE_N + 128 * cw + col;
    float w4[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) w4[x] = n + x < N ? sw[n + x] : 0.0f;
    // (float(acc) * sa[tok]) * sw[n + x] of the thread's token j, e (0
    // past M)
    epi.tile(ti * BT, n, [&](int j, int e, int tok, float (&y)[4]) {
      float s_row = tok < M ? sa[tok] : 0.0f;
      int v[4] = {acc[0][4 * j + e], acc[0][4 * j + 2 + e],
                  acc[1][4 * j + e], acc[1][4 * j + 2 + e]};
#pragma unroll
      for (int x = 0; x < 4; ++x)
        y[x] = __fmul_rn(__fmul_rn(__int2float_rn(v[x]), s_row), w4[x]);
    });
  }
  epi.finish();
}

// Launches int8_wgmma<BT, Src, ADD_C> over the (M, N) output: one block an
// SM, at most one a tile. qa (M, lda) int8 with K <= lda valid columns (a
// 16-byte pitch); w (Src::rows(K), ldb) int8: packed rows (round_up(K,
// 512) / 2 of them) or K rows of the plain matrix; c and out (M, ldc)
// float32 (c may be out; null where not ADD_C); bases 16-byte aligned.
// Returns a cudaError_t as an int.
template <int BT, class Src, bool ADD_C>
int launch_bt(const void* qa, const void* w, const float* sa,
              const float* sw, const float* c, float* out, int M, int N,
              int K, int lda, int ldb, int ldc, int sms,
              cudaStream_t stream) {
  using L = Layout<BT, Src, ADD_C>;
  CUtensorMap tqa, tw, tc, tcin;
  cuuint64_t qdims[2] = {static_cast<cuuint64_t>(K),
                         static_cast<cuuint64_t>(M)};
  cuuint64_t qstrides[1] = {static_cast<cuuint64_t>(lda)};
  cuuint32_t qbox[2] = {128, BT};
  cuuint64_t wdims[2] = {static_cast<cuuint64_t>(N),
                         static_cast<cuuint64_t>(Src::rows(K))};
  cuuint64_t wstrides[1] = {static_cast<cuuint64_t>(ldb)};
  cuuint32_t wbox[2] = {128, PACK_ROWS};
  if (!wg::make_map(&tqa, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, qa, qdims,
                    qstrides, qbox, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !wg::make_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, wdims,
                    wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  int path = ADD_C ? c_path<typename Src::Out>(c, out, M, N, ldc, &tc, &tcin)
                   : C_THREADS;
  if (path != C_LOAD_STORE) tcin = tqa;   // not read
  if (path == C_THREADS) tc = tqa;
  cudaError_t err = cudaFuncSetAttribute(
      int8_wgmma<BT, Src, ADD_C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  int tiles = (M + BT - 1) / BT * ((N + TILE_N - 1) / TILE_N);
  int8_wgmma<BT, Src, ADD_C>
      <<<tiles < sms ? tiles : sms, THREADS, L::SMEM, stream>>>(
          tqa, tw, tc, tcin, sa, sw, c, out, M, N, K, ldc, path);
  return static_cast<int>(cudaGetLastError());
}

// Launches int8_wgmma<token_tile(M, N, SMs), Src, ADD_C>; *bt is set to
// that tile.
template <class Src, bool ADD_C>
int launch(const void* qa, const void* w, const void* sa, const void* sw,
           const void* c, void* out, int M, int N, int K, int lda, int ldb,
           int ldc, cudaStream_t stream, int* bt) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  *bt = token_tile(M, N, sms);
  auto run = *bt == 64 ? launch_bt<64, Src, ADD_C>
                       : launch_bt<128, Src, ADD_C>;
  return run(qa, w, static_cast<const float*>(sa),
             static_cast<const float*>(sw), static_cast<const float*>(c),
             static_cast<float*>(out), M, N, K, lda, ldb, ldc, sms, stream);
}

// Launches of each token tile's kernel (BT 64, 128) in this process, one
// count a kernel file: the card tests read which tile ran.
struct TileLaunches {
  int n[2] = {0, 0};
  void add(int err, int bt) {
    if (err == 0) ++n[bt == 128];
  }
  int of(int bt) const { return bt == 64 ? n[0] : bt == 128 ? n[1] : -1; }
};

}  // namespace w4
}  // namespace htog
