// One persistent wgmma GEMM body fed by tensor maps: the kernel of rung 15
// (bf16_gemm_nt.cu), rung 16 (fp32_gemm_nt.cu, three bf16 products on
// split operands), rung 05 (bf16_gemm_nn.cu, B read N-major), rung 04
// (fp32_gemm_nn.cu, three bf16 products on split operands with B read
// N-major, the partial sums seeded with C), and the int8 summit K2
// (int8_gemm_nt.cu, rung 14), rung 18 (int8_ragged_nt.cu, K2 walked
// over a strip plan), rung 11 (int8_strip_nt.cu, K2's body in clusters
// sharing A, into a fresh output), rung 17 (int8_hand_pipe.cu, K2's
// body under two schedule knobs), rung 10 (int8_fat.cu, K2's body with
// each consumer warpgroup taking whole tiles, into a fresh output), rung
// 12 (int8_resident.cu, rung 10's instance with the operands kept in the
// L2) and rung 13 (int8_resident.cu, rung 12's instance fed by 1-D bulk
// copies of pretiled stage images). Each of those files names its
// instance's constants in a struct P:
//   S8        int8 operands (QA and QBT, K-major): wgmma.m64nBNk32.s32.s8,
//             int32 sums, 128 K values a stage, and K2's dequant epilogue
//             (below); else bf16 operands, fp32 sums, 64 K values a stage
//   BN        output columns a tile (256: 128 accumulators a thread;
//             128: 64, which leaves room for a second array of partial sums)
//   CH        stages a partial sum (0: one wgmma sum over all of K)
//   ST        stages of the ring
//   PRODUCTS  products a stage: 1, or 3 on operands split into bf16 hi and
//             lo planes (split_bf16.cu), hi.hi + hi.lo + lo.hi, the four
//             planes in one stage
//   B_MN      B given (K, N), N-major (wgmma's transposed B, legal for
//             bf16; with PRODUCTS 3 both of its split planes), else BT
//             (N, K), K-major like A
//   SEED_C    the sums start at C and out = sums (the reference's
//             _make_kernel: acc = C; acc += A.B): the wgmma accumulators
//             with CH = 0, the partial-sum array with CH > 0; else they
//             start at 0 and out = sums + C at the flush (its _flush /
//             _make_kernel_bt)
// and, where it names them (else 1, true, false, false and false):
//   CL        blocks of a thread-block cluster along N (below)
//   LOOKAHEAD the producer may run into a tile's stages while the
//             consumers finish the tile before; false: it waits on the
//             `done` barrier, on which both consumer warpgroups arrive once
//             their flush has been issued
//   LOAD_C    out is a fresh output (never c): C is loaded by tensor map
//             into the epilogue's staging (below), the C_LOAD path, in
//             place of the in-place paths
//   PINGPONG  int8: each consumer warpgroup computes whole BM x 128 tiles,
//             the two taking the block's tiles in turn (below)
//   RESIDENT  with PINGPONG: the operands kept in the L2 (rung 12, below)
//   TILED     with RESIDENT: the operands come as int8_pretile's stage
//             images, one 1-D bulk copy a stage and operand (rung 13,
//             below)
//
// Block (wgmma.cuh's shape, 384 threads): a persistent grid, one block an
// SM, walking BM x BN output tiles in an order the launch passes as a
// walk (the tile index -> its origin): GroupWalk, groups of GROUP_M row
// tiles (the blocks running at once share a few A row tiles and B in L2),
// or rung 18's strip plan (int8_ragged_nt.cu). Warp 0's
// lane 0 is the producer: it copies each K stage's tiles by tensor map into
// a ring of ST stages (rows past M or N and K values past K arrive as the
// copies' zero fill) and runs on into the next tile's stages while the
// consumers finish a tile. Warpgroups 1 and 2 are the consumers, 64 rows of
// the tile each, wgmma.m64nBNk16 (k32 for int8: the same 32 bytes of each
// 128-byte line a product) from shared memory; one stage's products
// stay in flight while the next stage is awaited, and a slot goes back to
// the producer (the ring's empty barrier) once the products that read it
// have completed. No block barrier in the main loop, and no wgmma wait on a
// branch: ptxas serializes the products of a loop shaped like wgmma.cuh's
// consume() (its note C7518; rung 15 ran 1.15x slower in that shape).
//
// Sums: CH = 0 is the tensor cores' straight fp32 sum over K (int8: the
// exact int32 sum, the same in any order). CH > 0 sums
// CH stages in the wgmma accumulator, then adds that partial into a second
// fp32 array (0, or C with SEED_C) with __fadd_rn in K's order and
// restarts the wgmma sum: the fixed order of a fixed tiling, the same bits
// on every run.
//
// Clusters (CL > 1, int8 only): the CL blocks of a cluster take CL
// neighbouring tiles of one row of output tiles (block rank r the tile
// n0 + BN r of a cluster tile of BM x CL BN, the walk's unit) and share
// each stage's A box: rank r copies rows [r BM / CL, (r + 1) BM / CL) of
// it, whole 1,024-byte swizzle atoms, with one tensor-map multicast that
// lands at the same offset in every block's slot and pays off each
// block's own full barrier, so A is read from L2 once a cluster. Each
// block still copies its own BT box; a block whose tile lies past N (N's
// tiles no multiple of CL) copies zeros and stores nothing. A slot is
// refilled once the consumers of every block have released it (Ring's
// and release's cluster forms in wgmma.cuh: CL x 8 warp arrivals); the
// blocks meet at a cluster barrier after their barriers' init and before
// any leaves.
//
// Ping-pong (PINGPONG, int8, CL 1): the reference's accumulator ping-pong
// (rung 10: tile t sums into one accumulator while tile t - 1's result
// leaves from the other) in the card's form, the accumulators being the
// consumers' registers. Consumer cw takes the block's tiles j (its j-th
// of first, first + step, ...) with j % 2 == cw, the whole BM x 128 tile,
// two m64n128k32 products a 32-byte K step (2 x 64 int32 sums a thread,
// as K2's 128), so one consumer's dequant and flush overlap the other's
// products. The producer
// fills the ring in the block's tile order as before; tile j's stages are
// ring uses j x stages .. (j + 1) x stages - 1, so a consumer starts each
// of its tiles at ring use j x stages, and a slot is released by the one
// warpgroup that read it (4 warp arrivals). Each consumer has a full
// barrier of its own a slot (the ring's for consumer 0, full1 for 1), on
// which the producer pays off the stages of that consumer's tiles, and
// keeps each one's parity in a bit of its own (fphase): a wait names only
// the parity of a phase, so on one shared barrier consumer 1's wait for
// use u of a slot, made as it starts its tile while use u - 1 (consumer
// 0's) has not landed, would pass on phase u - 2. The ring's order
// staggers the two product loops: tile j + 1's first stage lands only as
// tile j's last stages are released (CUTLASS's ordering barrier, which
// makes the loops take turns, moved rung 10 by under 1% on an H100:
// flash_variants.py's `order`).
//
// Resident (RESIDENT, rung 12, its walk a ResidentWalk that carries the
// operands' ranges): before the walk the grid prefetches A and
// B^T into the L2 under evict_last (cp.async.bulk.prefetch.L2 over their
// rows, 16 KB pieces, piece i by block i % gridDim.x), every stage's copy
// carries evict_last and C's loads and out's stores evict_first, so C and
// out stream past the operands; at its end each block's consumers set its
// share of the operands' lines back to evict_normal. No process-wide
// state is set.
//
// Tiled (TILED, rung 13): the operands come as int8_pretile's images
// (int8_resident.cu), each stage's 128 rows x 128 K bytes laid out as the
// 16 KB the tensor-map copy would land (the 128-byte swizzle, zeros past
// the edges), the images of a row tile in K order. The producer copies a
// stage with one 1-D bulk copy an operand (cp.async.bulk, under
// evict_last) in place of the tensor-map copies; the walk's ranges are
// the images, so the prefetch and the evict_normal pass cover exactly the
// bytes the stages read. The consumers are rung 12's.
//
// Epilogue: where out's rows are 16-byte multiples (and, adding C, C is out
// itself), each consumer stages its sums in shared memory 32 columns at a
// time and the tensor-map unit adds them into C (cp.reduce.async.bulk.tensor
// .add) or stores them, in L2, while the consumers go on to the next tile.
// Into a fresh output (C_LOAD: c is not out, rows of 16-byte multiples),
// before a tile's main loop each consumer's first thread loads C's first
// two boxes (64 rows x OUT_COLS) into its two staging buffers by tensor
// map, each under a barrier of its own; at the flush the threads add their
// sums to C there with __fadd_rn and the tensor-map unit stores each
// buffer into out, the next box loaded once that store has read the
// buffer (K1's path, w4a8_wgmma.cuh). Elsewhere each element is read and
// written by the thread that owns it.
// int8 (K2): first each int32 sum becomes (float(acc) * sa[i]) * sb[j] in
// its own registers, __fmul_rn each (the plain version's order, never an
// FMA), sb's values of the tile staged once in shared memory; the add of
// C is then the one above, a single round-to-nearest add, so the output
// equals the plain version bit for bit.
#pragma once

#include <type_traits>

#include "wgmma.cuh"

namespace htog {
namespace gw {

constexpr int BM = 128;         // output rows a tile, 64 a consumer
constexpr int GROUP_M = 8;      // row tiles a group of the walk
constexpr int A_BYTES = BM * wg::LINE;   // an A plane of a stage

// the epilogue's staging: per consumer two buffers of 64 rows x OUT_COLS
// fp32 (one 128-byte swizzled line a row), each the source of one
// tensor-map reduction or store
constexpr int OUT_COLS = 32;
constexpr int OUT_BOX = 64 * OUT_COLS * 4;
constexpr int OUT_BYTES = 2 * 2 * OUT_BOX;
// int8: a consumer's staging of sb, SB_COLS of the tile's columns at a
// time (at most one a consumer thread)
constexpr int SB_COLS = 128;

// How the epilogue meets C and out (the launch picks one): each thread
// writes its own elements; the tensor-map unit adds the staged sums into
// C in place (or stores them, SEED_C); C loaded into the staging by tensor
// map and the sums stored from it (a fresh output).
enum CPath { C_THREADS = 0, C_TMA = 1, C_LOAD = 2 };

// An instance's CL, LOOKAHEAD, LOAD_C, PINGPONG, RESIDENT and TILED where
// it names them, else 1, true, false, false, false and false.
template <class P, class = void>
constexpr int cl_of = 1;
template <class P>
constexpr int cl_of<P, std::void_t<decltype(P::CL)>> = P::CL;
template <class P, class = void>
constexpr bool lookahead_of = true;
template <class P>
constexpr bool lookahead_of<P, std::void_t<decltype(P::LOOKAHEAD)>> =
    P::LOOKAHEAD;
template <class P, class = void>
constexpr bool load_c_of = false;
template <class P>
constexpr bool load_c_of<P, std::void_t<decltype(P::LOAD_C)>> = P::LOAD_C;
template <class P, class = void>
constexpr bool pingpong_of = false;
template <class P>
constexpr bool pingpong_of<P, std::void_t<decltype(P::PINGPONG)>> =
    P::PINGPONG;
template <class P, class = void>
constexpr bool resident_of = false;
template <class P>
constexpr bool resident_of<P, std::void_t<decltype(P::RESIDENT)>> =
    P::RESIDENT;
template <class P, class = void>
constexpr bool tiled_of = false;
template <class P>
constexpr bool tiled_of<P, std::void_t<decltype(P::TILED)>> = P::TILED;

// ------------------------------------------------------------- host side

// A (rows, cols) bf16 matrix of row pitch ld elements, K-major: boxes of
// box_rows rows x 64 values, 128-byte swizzle.
inline bool kmajor_map(CUtensorMap* map, const void* base, int rows, int cols,
                       int ld, int box_rows) {
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                        static_cast<cuuint64_t>(rows)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  return wg::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, dims,
                      strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// A (rows, cols) int8 matrix of row pitch ld bytes, K-major: boxes of
// box_rows rows x 128 values (one 128-byte swizzled line a row, as
// kmajor_map's 64 bf16 values).
inline bool kmajor_map_s8(CUtensorMap* map, const void* base, int rows,
                          int cols, int ld, int box_rows) {
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                        static_cast<cuuint64_t>(rows)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld)};
  cuuint32_t box[2] = {wg::LINE, static_cast<cuuint32_t>(box_rows)};
  return wg::make_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, base, dims,
                      strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// split_bf16.cu's (2, rows, ld) bf16 planes, hi then lo, as one 3-D map
// (cols, rows, plane): boxes of box_rows rows x 64 values of one plane, so
// rows past `rows` read as zeros in both planes.
inline bool split_map(CUtensorMap* map, const void* base, int rows, int cols,
                      int ld, int box_rows) {
  cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                        static_cast<cuuint64_t>(rows), 2};
  cuuint64_t pitch = static_cast<cuuint64_t>(ld) * 2;
  cuuint64_t strides[2] = {pitch, pitch * rows};
  cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  return wg::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims,
                      strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// B (K, N) bf16 of row pitch ld elements as it lies, N-major: boxes of 64
// columns x 64 K rows, 128-byte swizzle (one line holds 64 columns of a K
// row).
inline bool nmajor_map(CUtensorMap* map, const void* base, int K, int N,
                       int ld) {
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(N),
                        static_cast<cuuint64_t>(K)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  cuuint32_t box[2] = {64, wg::KT};
  return wg::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, dims,
                      strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// split_bf16.cu's planes of B (2, K, ld), hi then lo, as one 3-D map
// (cols N, rows K, plane), N-major: boxes of 64 columns x 64 K rows of one
// plane, so rows past K and columns past N read as zeros in both planes.
inline bool split_nmajor_map(CUtensorMap* map, const void* base, int K,
                             int N, int ld) {
  cuuint64_t dims[3] = {static_cast<cuuint64_t>(N),
                        static_cast<cuuint64_t>(K), 2};
  cuuint64_t pitch = static_cast<cuuint64_t>(ld) * 2;
  cuuint64_t strides[2] = {pitch, pitch * K};
  cuuint32_t box[3] = {64, wg::KT, 1};
  return wg::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims,
                      strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// ----------------------------------------------------------- device side

// (row, column) origin of tile t of a num_m x num_n grid of BM x BN tiles:
// groups of GROUP_M row tiles, the row tile fastest inside a group
// (ops/tuned.nt_tile_walk is the same walk).
template <int BN>
__device__ __forceinline__ void tile_of(int t, int num_m, int num_n, int& m0,
                                        int& n0) {
  int per_group = GROUP_M * num_n;
  int first_m = (t / per_group) * GROUP_M;
  int gm = min(num_m - first_m, GROUP_M);
  int in_group = t % per_group;
  m0 = (first_m + in_group % gm) * BM;
  n0 = (in_group / gm) * BN;
}

// The grouped walk of a num_m x num_n grid of BM x BN tiles (tile_of):
// the walk of every instance but rung 18.
template <int BN>
struct GroupWalk {
  int num_m, num_n;
  __host__ __device__ int tiles() const { return num_m * num_n; }
  __device__ __forceinline__ void tile(int t, int& m0, int& n0) const {
    tile_of<BN>(t, num_m, num_n, m0, n0);
  }
};

// RESIDENT's walk: the grouped walk and the operands as they lie (their
// rows, pitch included; TILED: their images), whose L2 lines the kernel
// prefetches and sets back to evict_normal.
template <int BN>
struct ResidentWalk : GroupWalk<BN> {
  const void* a;
  const void* b;
  size_t a_bytes, b_bytes;
};

template <class T, int N>
__device__ __forceinline__ void zero(T (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = T(0);
}

// A sum as fp32: itself, or (int8, after dequant) the fp32 bits it holds.
__device__ __forceinline__ float as_f32(float x) { return x; }
__device__ __forceinline__ float as_f32(int x) { return __int_as_float(x); }

// K2's dequant of a consumer's int32 sums, in place: d[h][i] becomes the
// bits of (float(d[h][i]) * sa[row]) * sb[col], __fmul_rn each (the plain
// version's order, never an FMA), in wgmma's accumulator layout: rows from
// row0 + 64 h (the consumer's MH products of 64 rows), columns from col0.
// sa's two values a thread and product are read once; sb's values are
// staged in the consumer's buffer sbuf, SB_COLS columns at a time, for
// all MH products (named barrier 1 + cw, the one flush_tma takes: the pass
// before has been read). 0 past M and N (those rows and columns are not
// stored).
template <int MH, int NA>
__device__ __forceinline__ void dequant(int (&d)[MH][NA], const float* sa,
                                        const float* sb, float* sbuf, int M,
                                        int N, int row0, int col0, int cw) {
  constexpr int PASS = SB_COLS / 2;   // accumulators a pass, 4 a block of 8
  static_assert(NA % PASS == 0, "whole passes of SB_COLS columns");
  int t = threadIdx.x & 127;
  int lane = t & 31;
  int r = row0 + 16 * (t >> 5) + (lane >> 2);
  float s0[MH], s1[MH];
#pragma unroll
  for (int h = 0; h < MH; ++h) {
    s0[h] = r + 64 * h < M ? sa[r + 64 * h] : 0.0f;
    s1[h] = r + 64 * h + 8 < M ? sa[r + 64 * h + 8] : 0.0f;
  }
  const float* sbt = sbuf + 2 * (lane & 3);
#pragma unroll
  for (int pass = 0; pass < NA / PASS; ++pass) {
    int col = col0 + SB_COLS * pass + t;
    wg::bar_sync(1 + cw, 128);
    if (t < SB_COLS) sbuf[t] = col < N ? sb[col] : 0.0f;
    wg::bar_sync(1 + cw, 128);
#pragma unroll
    for (int jj = 0; jj < PASS / 4; ++jj) {
      int j = PASS / 4 * pass + jj;
      float2 b = *reinterpret_cast<const float2*>(sbt + 8 * jj);
      auto deq = [](int acc, float s, float sc) {
        return __float_as_int(__fmul_rn(__fmul_rn(__int2float_rn(acc), s),
                                        sc));
      };
#pragma unroll
      for (int h = 0; h < MH; ++h) {
        d[h][4 * j] = deq(d[h][4 * j], s0[h], b.x);
        d[h][4 * j + 1] = deq(d[h][4 * j + 1], s0[h], b.y);
        d[h][4 * j + 2] = deq(d[h][4 * j + 2], s1[h], b.x);
        d[h][4 * j + 3] = deq(d[h][4 * j + 3], s1[h], b.y);
      }
    }
  }
}

// out += d (kAdd) or out = d over a consumer's 64 rows from row0 and the
// tile's columns from col0 (wgmma's accumulator layout), OUT_COLS columns
// at a time: the warpgroup writes them into one of its two buffers
// (swizzled as the map reads them), fences them for the async proxy and
// meets (named barrier 1 + cw), and its first thread hands them to the
// tensor-map unit, which adds or stores them in L2 while the consumers go
// on to the next tile; a buffer is written again once its copy has read
// it. Rows and columns past out's edges are not written. fp32 addition
// commutes, so C + d is the reference's d + C bit for bit.
template <bool kAdd, class T, int NA>
__device__ __forceinline__ void flush_tma(const T (&d)[NA], uint8_t* bufs,
                                          const CUtensorMap* tc, int row0,
                                          int col0, int cw) {
  int t = threadIdx.x & 127;
  int lane = t & 31;
  int r0 = 16 * (t >> 5) + (lane >> 2);
#pragma unroll
  for (int ch = 0; ch < NA / 16; ++ch) {   // 4 accumulator blocks a box
    uint8_t* buf = bufs + (ch & 1) * OUT_BOX;
    if (t == 0) bulk_wait_read<1>();
    wg::bar_sync(1 + cw, 128);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      int j = 4 * ch + jj;
      int col = 8 * jj + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int r = r0 + 8 * h;
        uint32_t off = r * wg::LINE + ((((col >> 2) ^ (r & 7)) << 4) |
                                       ((col & 3) << 2));
        *reinterpret_cast<float2*>(buf + off) = make_float2(
            as_f32(d[4 * j + 2 * h]), as_f32(d[4 * j + 2 * h + 1]));
      }
    }
    fence_proxy_async();
    wg::bar_sync(1 + cw, 128);
    if (t == 0) {
      wg::tma_out_2d<kAdd>(tc, buf, col0 + OUT_COLS * ch, row0);
      bulk_commit();
    }
  }
}

// A consumer's first thread: C's box i (NB boxes a 64-row product: rows
// from row0 + 64 (i / NB), OUT_COLS columns from col0 + OUT_COLS (i % NB))
// into its staging buffer i % 2 by tensor map under that buffer's barrier,
// once every store out of the staging has read it; kHint: under the L2
// `policy`.
template <int NB, bool kHint>
__device__ __forceinline__ void load_c(const CUtensorMap* tcin,
                                       uint8_t* bufs, uint64_t* cbar, int i,
                                       int row0, int col0, uint64_t policy) {
  int b = i & 1;
  int c0 = col0 + OUT_COLS * (i % NB), c1 = row0 + 64 * (i / NB);
  bulk_wait_read<0>();
  mbar_arrive_expect_tx(cbar + b, OUT_BOX);
  if constexpr (kHint)
    wg::tma_2d_hint(bufs + b * OUT_BOX, tcin, c0, c1, cbar + b, policy);
  else
    wg::tma_2d(bufs + b * OUT_BOX, tcin, c0, c1, cbar + b);
}

// out = d + C into a fresh output over a consumer's MH products of 64 rows
// (rows from row0 + 64 h) and the tile's columns from col0, OUT_COLS
// columns at a time: box i of C (load_c's numbering) is in buffer i % 2
// (its first two loaded before the tile's main loop; `phase` bit b the
// parity of buffer b's next load), each thread adds its sums to C where
// they lie with __fadd_rn (the plain version's d + C, one round-to-nearest
// add), the warpgroup meets (named barrier 1 + cw) and its first thread
// hands the buffer to the tensor-map unit to store over out (clipped at M
// and N), then loads box i + 2 into it. kHint: C's loads and out's stores
// under the L2 `policy`.
template <bool kHint, class T, int MH, int NA>
__device__ __forceinline__ void flush_load(const T (&d)[MH][NA],
                                           uint8_t* bufs, uint64_t* cbar,
                                           uint32_t& phase,
                                           const CUtensorMap* tc,
                                           const CUtensorMap* tcin, int row0,
                                           int col0, int cw,
                                           uint64_t policy) {
  constexpr int NB = NA / 16;   // boxes a product: 4 accumulator blocks
  int t = threadIdx.x & 127;
  int lane = t & 31;
  int r0 = 16 * (t >> 5) + (lane >> 2);
#pragma unroll
  for (int i = 0; i < MH * NB; ++i) {
    int hm = i / NB, ch = i % NB;
    int b = i & 1;
    uint8_t* buf = bufs + b * OUT_BOX;
    wg::wait(cbar + b, (phase >> b) & 1);   // C's box is in buf
    phase ^= 1u << b;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      int j = 4 * ch + jj;
      int col = 8 * jj + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int r = r0 + 8 * h;
        uint32_t off = r * wg::LINE + ((((col >> 2) ^ (r & 7)) << 4) |
                                       ((col & 3) << 2));
        float2* at = reinterpret_cast<float2*>(buf + off);
        float2 cv = *at;
        *at = make_float2(__fadd_rn(as_f32(d[hm][4 * j + 2 * h]), cv.x),
                          __fadd_rn(as_f32(d[hm][4 * j + 2 * h + 1]), cv.y));
      }
    }
    fence_proxy_async();
    wg::bar_sync(1 + cw, 128);
    if (t == 0) {
      int c0 = col0 + OUT_COLS * ch, c1 = row0 + 64 * hm;
      if constexpr (kHint)
        wg::tma_store_2d_hint(tc, buf, c0, c1, policy);
      else
        wg::tma_out_2d<false>(tc, buf, c0, c1);
      bulk_commit();
      if (i + 2 < MH * NB)
        load_c<NB, kHint>(tcin, bufs, cbar, i + 2, row0, col0, policy);
    }
  }
}

// f(v0, v1, crow, orow, col) for each pair of a consumer's accumulators
// with row < M: rows from row0, columns col, col + 1 from col0 (wgmma's
// accumulator layout), crow and orow that row of c and out.
template <int NA, class V, class F>
__device__ __forceinline__ void for_each_row_pair(V (&d)[NA], const float* c,
                                                  float* out, int M, int ldc,
                                                  int row0, int col0, F f) {
  int lane = threadIdx.x & 31;
  int row = row0 + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  col0 += 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int r = row + 8 * h;
    if (r >= M) continue;
    const float* crow = c + static_cast<size_t>(r) * ldc;
    float* orow = out + static_cast<size_t>(r) * ldc;
#pragma unroll
    for (int j = 0; j < NA / 4; ++j)
      f(d[4 * j + 2 * h], d[4 * j + 2 * h + 1], crow, orow, col0 + 8 * j);
  }
}

__device__ __forceinline__ bool pair_ok(const float* p, int col, int N) {
  return col + 1 < N && (reinterpret_cast<uintptr_t>(p + col) & 7) == 0;
}

// out = d + C (kAdd) or out = d, rows below M and columns below N, each
// element by the thread that owns it (c and out may be one buffer).
template <bool kAdd, class T, int NA>
__device__ __forceinline__ void flush_threads(const T (&d)[NA],
                                              const float* c, float* out,
                                              int M, int N, int ldc, int row0,
                                              int col0) {
  for_each_row_pair(d, c, out, M, ldc, row0, col0,
                    [&](T d0, T d1, const float* crow, float* orow,
                        int col) {
    float v0 = as_f32(d0), v1 = as_f32(d1);
    if (pair_ok(crow, col, N) && pair_ok(orow, col, N)) {
      if constexpr (kAdd) {
        float2 cv = *reinterpret_cast<const float2*>(crow + col);
        v0 = __fadd_rn(v0, cv.x);
        v1 = __fadd_rn(v1, cv.y);
      }
      *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
    } else {
      if (col < N) orow[col] = kAdd ? __fadd_rn(v0, crow[col]) : v0;
      if (col + 1 < N) orow[col + 1] = kAdd ? __fadd_rn(v1, crow[col + 1]) : v1;
    }
  });
}

// d = C over a consumer's 64 rows from row0 and the tile's columns from
// col0; 0 past C's edges.
template <int NA>
__device__ __forceinline__ void seed_c(float (&d)[NA], const float* c, int M,
                                       int N, int ldc, int row0, int col0) {
  zero(d);
  for_each_row_pair(d, c, const_cast<float*>(c), M, ldc, row0, col0,
                    [&](float& v0, float& v1, const float* crow, float*,
                        int col) {
    if (pair_ok(crow, col, N)) {
      float2 cv = *reinterpret_cast<const float2*>(crow + col);
      v0 = cv.x;
      v1 = cv.y;
    } else {
      if (col < N) v0 = crow[col];
      if (col + 1 < N) v1 = crow[col + 1];
    }
  });
}

template <class P>
struct Layout {
  static constexpr int CL = cl_of<P>;
  static constexpr bool LOOKAHEAD = lookahead_of<P>;
  static constexpr bool LOAD_C = load_c_of<P>;
  static constexpr bool PP = pingpong_of<P>;
  static constexpr bool RES = resident_of<P>;
  static constexpr bool TILED = tiled_of<P>;
  // products of 64 rows a consumer takes each K step (its rows of a tile:
  // all BM with PINGPONG, else half) and the warps that release a slot
  static constexpr int MH = PP ? 2 : 1;
  static constexpr int WARPS = (PP ? 1 : 2) * 4;
  static constexpr int NP = P::PRODUCTS == 3 ? 2 : 1;   // planes of A, of B
  // a B plane: BN K-major rows, or BN / 64 N-major boxes of HALF_TILE
  static constexpr int B_BYTES = P::BN * wg::LINE;
  static constexpr int B = NP * A_BYTES;                // B's offset
  static constexpr int STAGE = NP * (A_BYTES + B_BYTES);
  static constexpr int ACC = P::BN / 2;                 // accumulators
  using Acc = std::conditional_t<P::S8, int, float>;
  // K values a stage (one 128-byte line a row) and 32-byte products a
  // stage (k16 bf16, k32 int8)
  static constexpr int KV = P::S8 ? wg::LINE : wg::KT;
  static constexpr int STEPS = wg::LINE / 32;
  // after the stages: the epilogue's staging, sb's (int8), the ring, then
  // C's loads' barriers (two a consumer) and `done`
  static constexpr int SB = P::ST * STAGE + OUT_BYTES;
  static constexpr int RING = SB + (P::S8 ? 2 * SB_COLS * 4 : 0);
  // PINGPONG: consumer 1's full barriers after the ring's
  static constexpr int FULL1 =
      RING + static_cast<int>(sizeof(wg::Ring<P::ST, CL>));
  static constexpr int BARS = FULL1 + (PP ? 8 * P::ST : 0);
  static constexpr int SMEM = BARS + 5 * 8 + wg::ATOM;
  // a block's share of an A box (CL > 1: one multicast each)
  static constexpr int A_SLICE = A_BYTES / CL;
  static_assert(SMEM <= 232448, "the ring fits a block's shared memory");
  static_assert(A_SLICE % wg::ATOM == 0,
                "a block's slice of A is whole 1,024-byte swizzle atoms");
  static_assert(CL == 1 || (P::S8 && CL <= 8),
                "clusters (of at most 8) share the int8 A box");
  static_assert(!LOAD_C || !P::SEED_C, "C loaded where it is added last");
  static_assert(P::PRODUCTS == 1 || P::PRODUCTS == 3,
                "one product, or three of split planes");
  static_assert(P::BN % 64 == 0, "an N-major B is whole 64-column boxes");
  static_assert(!P::S8 || (P::BN == (PP ? 128 : 256) && P::CH == 0 &&
                           P::PRODUCTS == 1 && !P::B_MN && !P::SEED_C),
                "int8: K2's tile (BM x 128 a ping-pong consumer), both "
                "operands K-major, C added at the end");
  static_assert(!PP || (P::S8 && CL == 1 && LOOKAHEAD && P::ST <= 32),
                "ping-pong: int8, no cluster, the producer running ahead, "
                "a parity bit a slot");
  static_assert(!RES || PP, "the resident operands: the ping-pong instance");
  static_assert(!TILED || RES, "pretiled images: the resident instance");
  static_assert(!TILED || P::BN == BM, "pretiled images are BM-row tiles");
};

// ta: A (M, K) K-major, or its split planes (3-D); tb: BT (N, K) K-major,
// or B (K, N) N-major, or the split planes of either; tc: out (M, ldc)
// fp32 in boxes of 64 rows x OUT_COLS, read on the tensor-map paths; tcin:
// C the same, read on C_LOAD; path: CPath; sa (M), sb (N): int8's scales
// (not read otherwise); walk: the order of the tiles (CL > 1: of the
// cluster tiles, BM x CL BN; RESIDENT: a ResidentWalk). TILED reads
// neither ta nor tb: the stages come from walk.a and walk.b.
template <class P, class Walk>
__global__ void __launch_bounds__(wg::BLOCK, 1)
    gemm_wgmma(const __grid_constant__ CUtensorMap ta,
               const __grid_constant__ CUtensorMap tb,
               const __grid_constant__ CUtensorMap tc,
               const __grid_constant__ CUtensorMap tcin, const float* c,
               float* out, const float* sa, const float* sb, int M, int N,
               int K, int ldc, int path, const Walk walk) {
  using L = Layout<P>;
  constexpr int BN = P::BN;
  constexpr int ST = P::ST;
  constexpr int CL = L::CL;
  constexpr int MH = L::MH;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = wg::align_1024(smem_raw);
  auto& ring = *reinterpret_cast<wg::Ring<ST, CL>*>(smem + L::RING);
  uint64_t* full1 = reinterpret_cast<uint64_t*>(smem + L::FULL1);
  uint64_t* cbars = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* done = cbars + 4;
  int tiles = walk.tiles();
  int stages = (K + L::KV - 1) / L::KV;     // ring uses a tile
  int warp = threadIdx.x >> 5;
  // the block's rank in its cluster, its tiles' column offset in the
  // walk's unit, the first unit and the units' stride
  int rank = 0;
  if constexpr (CL > 1) rank = static_cast<int>(cluster_rank());
  int first = blockIdx.x / CL, step = gridDim.x / CL;
  // L2 policies (RESIDENT): the operands' copies, C's and out's
  uint64_t keep = 0, pass = 0;
  if constexpr (L::RES) {
    keep = l2_evict_last();
    pass = l2_evict_first();
    l2_prefetch_grid(walk.a, walk.a_bytes, keep);
    l2_prefetch_grid(walk.b, walk.b_bytes, keep);
  }
  if (threadIdx.x == 0) {
    for (int b = 0; b < 4; ++b) mbar_init(&cbars[b], 1);
    mbar_init(done, 2);
    if constexpr (L::PP)
      for (int s = 0; s < ST; ++s) mbar_init(&full1[s], 1);
    ring.init(L::WARPS);
  }
  if constexpr (CL > 1)
    cluster_sync();   // every block's barriers exist before peers use them
  else
    __syncthreads();

  if (warp < 4) {
    if (threadIdx.x == 0) {
      int q = 0, j = 0;
      for (int t = first; t < tiles; t += step, ++j) {
        int m0, n0;
        walk.tile(t, m0, n0);
        n0 += BN * rank;
        if (!L::LOOKAHEAD && j > 0)   // the consumers' flush of tile j - 1
          wg::wait(done, (j - 1) & 1);
        for (int kq = 0; kq < stages; ++kq, ++q) {
          int s = q % ST;
          uint8_t* st = smem + s * L::STAGE;
          // PINGPONG: the full barrier of the tile's consumer
          uint64_t* full = L::PP && (j & 1) ? &full1[s] : &ring.full[s];
          int k0 = kq * L::KV;
          wg::wait_empty(ring, q);
          mbar_arrive_expect_tx(full, L::STAGE);
          if constexpr (P::PRODUCTS == 3) {        // hi, lo of A; of B
            wg::tma_3d(st, &ta, k0, m0, 0, full);
            wg::tma_3d(st + A_BYTES, &ta, k0, m0, 1, full);
#pragma unroll
            for (int p = 0; p < 2; ++p) {
              uint8_t* bp = st + L::B + p * L::B_BYTES;
              if constexpr (P::B_MN) {
#pragma unroll
                for (int jb = 0; jb < BN / 64; ++jb)
                  wg::tma_3d(bp + jb * wg::HALF_TILE, &tb, n0 + 64 * jb, k0,
                             p, full);
              } else {
                wg::tma_3d(bp, &tb, k0, n0, p, full);
              }
            }
          } else if constexpr (L::TILED) {   // one image an operand
            const auto* ia = static_cast<const uint8_t*>(walk.a) +
                (static_cast<size_t>(m0 / BM) * stages + kq) * A_BYTES;
            const auto* ib = static_cast<const uint8_t*>(walk.b) +
                (static_cast<size_t>(n0 / BN) * stages + kq) * L::B_BYTES;
            bulk_g2s_l2(st, ia, A_BYTES, full, keep);
            bulk_g2s_l2(st + L::B, ib, L::B_BYTES, full, keep);
          } else if constexpr (L::RES) {   // both under evict_last
            wg::tma_2d_hint(st, &ta, k0, m0, full, keep);
            wg::tma_2d_hint(st + L::B, &tb, k0, n0, full, keep);
          } else {
            if constexpr (CL > 1)   // this block's slice, to every block
              wg::tma_2d_multicast(st + rank * L::A_SLICE, &ta, k0,
                                   m0 + rank * (BM / CL), full,
                                   static_cast<uint16_t>((1u << CL) - 1));
            else
              wg::tma_2d(st, &ta, k0, m0, full);
            if constexpr (P::B_MN) {
#pragma unroll
              for (int jb = 0; jb < BN / 64; ++jb)
                wg::tma_2d(st + L::B + jb * wg::HALF_TILE, &tb, n0 + 64 * jb,
                           k0, full);
            } else {
              wg::tma_2d(st + L::B, &tb, k0, n0, full);
            }
          }
        }
      }
    }
    if constexpr (CL > 1) {
      __syncwarp();
      cluster_sync();   // no block leaves while peers may still reach it
    }
    return;
  }

  int cw = (warp >> 2) - 1;
  uint32_t base = smem_u32(smem);
  uint8_t* bufs = smem + ST * L::STAGE + cw * 2 * OUT_BOX;
  float* sbuf = reinterpret_cast<float*>(smem + L::SB) + cw * SB_COLS;
  uint64_t* cbar = cbars + 2 * cw;
  uint32_t phase = 0;   // bit b: the parity of buffer b's next load of C
  bool lead = (threadIdx.x & 127) == 0;
  int chunk = P::CH > 0 ? P::CH : stages;
  int q = 0;
  // PINGPONG: this consumer's full barriers and (bit s) each one's parity
  uint64_t* fulls = L::PP && cw == 1 ? full1 : ring.full;
  uint32_t fphase = 0;
  typename L::Acc acc[MH][L::ACC];
  float tot[P::CH > 0 ? MH : 1][P::CH > 0 ? L::ACC : 1];   // CH > 0: the
                                                           // partials' sum
  int j = 0;   // the tile's place in the block's walk
  for (int t = first; t < tiles; t += step, ++j) {
    if (L::PP && (j & 1) != cw) continue;   // the other consumer's tile
    int m0, n0;
    walk.tile(t, m0, n0);
    n0 += BN * rank;
    // the consumer's first row: the tile's (ping-pong) or its half's
    int row0 = m0 + (L::PP ? 0 : 64 * cw);
    if constexpr (L::PP) q = j * stages;   // the tile's first ring use
    // a tile past N (a cluster's surplus) stores nothing
    bool live = CL == 1 || n0 < N;
    if constexpr (L::LOAD_C) {
      if (path == C_LOAD && live && lead) {   // C's first boxes in flight
        load_c<L::ACC / 16, L::RES>(&tcin, bufs, cbar, 0, row0, n0, pass);
        load_c<L::ACC / 16, L::RES>(&tcin, bufs, cbar, 1, row0, n0, pass);
      }
    }
#pragma unroll
    for (int h = 0; h < MH; ++h) {
      if constexpr (P::SEED_C && P::CH == 0)
        seed_c(acc[h], c, M, N, ldc, row0 + 64 * h, n0);
      else
        zero(acc[h]);
      if constexpr (P::CH > 0) {
        if constexpr (P::SEED_C)
          seed_c(tot[h], c, M, N, ldc, row0 + 64 * h, n0);
        else
          zero(tot[h]);
      }
    }
    for (int kc = 0; kc < stages; kc += chunk) {
      int kend = min(stages, kc + chunk);
      int prev = -1;   // the slot of the products still in flight
      for (int kq = kc; kq < kend; ++kq, ++q) {
        int s = q % ST;
        uint32_t a = base + s * L::STAGE + (L::PP ? 0 : cw * (64 * wg::LINE));
        uint32_t b = base + s * L::STAGE + L::B;
        if constexpr (L::PP) {
          wg::wait(&fulls[s], (fphase >> s) & 1);
          fphase ^= 1u << s;
        } else {
          wg::wait(&ring.full[s], (q / ST) & 1);
        }
        // (acc unfenced: the group before still writes it)
        wg::wgmma_fence();
        bool fresh = P::CH > 0 && kq == kc;
#pragma unroll
        for (int k = 0; k < L::STEPS; ++k) {
          constexpr int TB = P::B_MN ? 1 : 0;
          uint64_t db = P::B_MN ? wg::mnmajor_desc(b, k)
                                : wg::kmajor_desc(b, k);
#pragma unroll
          for (int h = 0; h < MH; ++h) {
            uint32_t ah = a + h * (64 * wg::LINE);   // the product's rows
            uint64_t da = wg::kmajor_desc(ah, k);
            if constexpr (P::S8)
              wg::WgmmaS8<BN>::ss(acc[h], da, db, 1);
            else
              wg::Wgmma<BN>::template ss<0, TB>(acc[h], da, db,
                                                fresh && k == 0 ? 0 : 1);
            if constexpr (P::PRODUCTS == 3) {
              uint64_t db_lo = P::B_MN ? wg::mnmajor_desc(b + L::B_BYTES, k)
                                       : wg::kmajor_desc(b + L::B_BYTES, k);
              wg::Wgmma<BN>::template ss<0, TB>(acc[h], da, db_lo, 1);
              wg::Wgmma<BN>::template ss<0, TB>(
                  acc[h], wg::kmajor_desc(ah + A_BYTES, k), db, 1);
            }
          }
        }
        wg::wgmma_commit();
        wg::wgmma_wait<1>();
        if (prev >= 0) wg::release(ring, prev);
        prev = s;
      }
      wg::wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < MH; ++h) wg::fence_regs(acc[h]);
      wg::release(ring, prev);
      if constexpr (P::CH > 0) {
#pragma unroll
        for (int h = 0; h < MH; ++h)
#pragma unroll
          for (int i = 0; i < L::ACC; ++i)
            tot[h][i] = __fadd_rn(tot[h][i], acc[h][i]);
      }
    }
    if (live) {
      if constexpr (P::S8) dequant(acc, sa, sb, sbuf, M, N, row0, n0, cw);
      auto finish = [&](const auto& d) {
        constexpr bool kAdd = !P::SEED_C;
        if (L::LOAD_C && path == C_LOAD) {
          flush_load<L::RES>(d, bufs, cbar, phase, &tc, &tcin, row0, n0, cw,
                             pass);
          return;
        }
#pragma unroll
        for (int h = 0; h < MH; ++h) {
          if (!L::LOAD_C && path == C_TMA)
            flush_tma<kAdd>(d[h], bufs, &tc, row0 + 64 * h, n0, cw);
          else
            flush_threads<kAdd>(d[h], c, out, M, N, ldc, row0 + 64 * h, n0);
        }
      };
      if constexpr (P::CH > 0)
        finish(tot);
      else
        finish(acc);
    }
    if (!L::LOOKAHEAD && lead) mbar_arrive(done);   // the flush is issued
  }
  if (lead) bulk_wait_all();
  if constexpr (L::RES) {   // this block's share of the lines, by consumers
    int tid = static_cast<int>(threadIdx.x) - (wg::BLOCK - wg::CONSUMERS);
    l2_evict_normal_grid(walk.a, walk.a_bytes, tid, wg::CONSUMERS);
    l2_evict_normal_grid(walk.b, walk.b_bytes, tid, wg::CONSUMERS);
  }
  if constexpr (CL > 1) {
    __syncwarp();
    cluster_sync();   // no block leaves while peers may still reach it
  }
}

// The epilogue's path (CPath) for c and out (M, ldc) fp32 and the maps it
// reads, boxes of 64 rows x OUT_COLS with the 128-byte swizzle: tc over
// out where out's rows are 16-byte multiples on a 16-byte base; C_TMA
// where out is C (or SEED_C stores it), C_LOAD with tcin over C where the
// instance loads C (LOAD_C, c on a 16-byte base); else C_THREADS.
template <class P>
int c_path(const void* c, void* out, int M, int N, int ldc, CUtensorMap* tc,
           CUtensorMap* tcin) {
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(N),
                        static_cast<cuuint64_t>(M)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(ldc) * 4};
  cuuint32_t box[2] = {OUT_COLS, 64};
  auto map = [&](CUtensorMap* m, const void* base) {
    return reinterpret_cast<uintptr_t>(base) % 16 == 0 &&
           wg::make_map(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, base, dims,
                        strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  };
  int tma_out = ldc % 4 == 0 && map(tc, out);
  if (!tma_out) return C_THREADS;
  if (Layout<P>::LOAD_C) return map(tcin, c) ? C_LOAD : C_THREADS;
  return P::SEED_C || c == out ? C_TMA : C_THREADS;
}

// Blocks of gemm_wgmma<P, Walk> the card runs at once: one an SM, or CL x
// the clusters of CL it holds at once (cudaOccupancyMaxActiveClusters:
// clusters of 4 need not fill every GPC). Sets the kernel's shared memory
// first. Returns a cudaError_t as an int.
template <class P, class Walk>
int resident_blocks(int* blocks) {
  using L = Layout<P>;
  auto kernel = gemm_wgmma<P, Walk>;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = sms;
  if constexpr (L::CL > 1) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = L::CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(L::CL * (sms / L::CL));
    cfg.blockDim = dim3(wg::BLOCK);
    cfg.dynamicSmemBytes = L::SMEM;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(
        &clusters, reinterpret_cast<const void*>(kernel), &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    *blocks = L::CL * clusters;
  }
  return 0;
}

// Launches gemm_wgmma<P> over the (M, N) output in the order of `walk`
// (its units: tiles, or with CL > 1 cluster tiles), as many blocks as the
// card runs at once (resident_blocks), at most CL a unit, on the maps of A
// (with CL > 1 its boxes BM / CL rows, a block's slice) and B. c and out
// (M, ldc) fp32: with SEED_C, out = C + A.B (C + p1 + p2 + ... with
// CH > 0); else out = A.B + C (int8: dequant(A.B) + C, with sa and sb),
// c and out one buffer or two. The epilogue's path is c_path's. Returns a
// cudaError_t as an int.
template <class P, class Walk>
int launch(const CUtensorMap& ta, const CUtensorMap& tb, const void* c,
           void* out, const void* sa, const void* sb, int M, int N, int K,
           int ldc, const Walk& walk, cudaStream_t stream) {
  using L = Layout<P>;
  CUtensorMap tc, tcin;
  int path = c_path<P>(c, out, M, N, ldc, &tc, &tcin);
  if (path == C_THREADS) tc = ta;   // not read
  if (path != C_LOAD) tcin = ta;
  int slots = 0;
  int err = resident_blocks<P, Walk>(&slots);
  if (err != 0) return err;
  int units = walk.tiles();
  if (units < 1) return 0;   // no work
  int grid = L::CL * (units < slots / L::CL ? units : slots / L::CL);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L::CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(wg::BLOCK);
  cfg.dynamicSmemBytes = L::SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = L::CL > 1 ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, gemm_wgmma<P, Walk>, ta, tb, tc, tcin,
      static_cast<const float*>(c), static_cast<float*>(out),
      static_cast<const float*>(sa), static_cast<const float*>(sb), M, N, K,
      ldc, path, walk);
  cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

// An int8 ping-pong instance (rungs 10 and 12) on QA (M, K) and QBT (N,
// K) K-major, row pitches lda and ldb, on the grouped walk of its BM x BN
// tiles (RESIDENT: with the operands' ranges): cudaErrorInvalidValue for
// a tensor map the CUDA driver refuses, else launch's result.
template <class P>
int launch_pingpong(const void* qa, const void* qbt, const void* sa,
                    const void* sb, const void* c, void* out, int M, int N,
                    int K, int lda, int ldb, int ldc, cudaStream_t stream) {
  CUtensorMap ta, tb;
  if (!kmajor_map_s8(&ta, qa, M, K, lda, BM) ||
      !kmajor_map_s8(&tb, qbt, N, K, ldb, P::BN))
    return static_cast<int>(cudaErrorInvalidValue);
  GroupWalk<P::BN> grid{(M + BM - 1) / BM, (N + P::BN - 1) / P::BN};
  if constexpr (resident_of<P>) {
    ResidentWalk<P::BN> walk{grid, qa, qbt, static_cast<size_t>(M) * lda,
                             static_cast<size_t>(N) * ldb};
    return launch<P>(ta, tb, c, out, sa, sb, M, N, K, ldc, walk, stream);
  } else {
    return launch<P>(ta, tb, c, out, sa, sb, M, N, K, ldc, grid, stream);
  }
}

// Rung 13's instance (TILED) on int8_pretile's images of QA and QBT
// (ceil(M / BM), nk, BM, 128) and (ceil(N / BN), nk, BN, 128), nk =
// ceil(K / 128): the walk's ranges are the images; no tensor map of them
// is made (ta and tb are not read). Returns launch's result.
template <class P>
int launch_tiled(const void* at, const void* bt, const void* sa,
                 const void* sb, const void* c, void* out, int M, int N,
                 int K, int ldc, cudaStream_t stream) {
  static_assert(tiled_of<P>, "the pretiled instance");
  CUtensorMap none{};
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + P::BN - 1) / P::BN;
  const size_t nk = (K + wg::LINE - 1) / wg::LINE;
  ResidentWalk<P::BN> walk{{tiles_m, tiles_n}, at, bt,
                           tiles_m * nk * A_BYTES,
                           tiles_n * nk * Layout<P>::B_BYTES};
  return launch<P>(none, none, c, out, sa, sb, M, N, K, ldc, walk, stream);
}

// launch on the grouped walk, no scales (the bf16 and fp32 rungs)
template <class P>
int launch(const CUtensorMap& ta, const CUtensorMap& tb, const void* c,
           void* out, int M, int N, int K, int ldc, cudaStream_t stream) {
  GroupWalk<P::BN> walk{(M + BM - 1) / BM, (N + P::BN - 1) / P::BN};
  return launch<P>(ta, tb, c, out, nullptr, nullptr, M, N, K, ldc, walk,
                   stream);
}

}  // namespace gw
}  // namespace htog
