// The W4A8 prefill GEMM on Hopper's int8 warpgroup MMA: the body of
// w4a8_gemm_noc.cu, out = f32(QA @ decode(P) as int32) * sa[i] * sw[j].
// QA (M, K) int8 row-major, P (Kp/2, N) int8 packed nibbles (w4a8.cuh),
// sa (M, 1) and sw (1, N) float32, out (M, N) float32.
//
// Operands swapped: each output tile is computed as out^T = W^T . QA^T,
// so the decoded weights are wgmma's A, held in registers, and never go
// back to shared memory; QA is wgmma's B, K-major as it lies (8-bit types
// have no transposed form), read from its swizzled box by descriptor.
// wgmma.m64nBTk32.s32.s8.s8: a 64-row slab of W^T (64 output columns) times
// BT tokens, 32 K values deep.
//
// Block: 288 threads, one block an SM, a persistent grid walking tiles of
// BT tokens x 256 output columns in groups of GROUP_T token tiles (the
// blocks running at once share a few token tiles of QA and the weights in
// L2). Warps 0-7 are two consumer warpgroups, 128 output columns (two
// slabs) each; warp 8's lane 0 is the producer. Registers bound the tile:
// nine warps put three on one of the SM's four schedulers, whose quarter
// of the register file leaves a thread 168, as 384 threads would; BT = 128
// (128 int32 sums, two sets of A fragments) takes all 168 with a 4-byte
// spill. ptxas serializes the products where a step's fragments are
// written while the step before is in flight (its note C7513); on an H100
// that still ran faster than draining each step first (wait<0>, which
// clears C7513 but not the register limit), by 2-3%, and than 96-token
// tiles (145 registers), which lose rounds of the grid
// (harness/flash_variants.py --group w4a8; PERF.md).
//
// Ring (wgmma.cuh's full and empty barriers, as many stages as fit: 3 at
// BT = 128, 4 at 64; two ran as fast): stage st of a tile takes the
// packed rows 256 (st / 2) + 128 (st % 2) .. + 127, one 128 x 128 box for
// each consumer's columns. Their low nibbles are K rows
// k = 512 (st / 2) + 128 (st % 2) .. + 127 and their high nibbles K rows
// k + 256 .. k + 383 (w4a8.cuh), so the stage also takes the two QA boxes
// of those K columns, and each packed byte is read once per tile. The
// int32 sums are exact in any order. The QA map's K extent is K: columns
// past it, and boxes wholly past it, arrive as zeros, so packed rows past K
// add nothing whatever they hold; rows past M and columns past N are zeros
// and are not stored.
//
// Consumer thread (warp w of its warpgroup, lane = 4 g + t): its A
// fragments hold slab rows g and g + 8 of both slabs, which are the four
// adjacent output columns c = 4 (8 w + g) .. + 3 of its warpgroup's 128
// (column c + 2 s + h is slab s's row g + 8 h), at K bytes 4 t .. 4 t + 3
// and 16 + 4 t .. of each 32-deep step. So per step it loads one 32-bit
// word (those four columns) from each of the 8 packed rows 4 t + j and
// 16 + 4 t + j, decodes the low nibbles (this step's fragments for both
// slabs) and the high ones (the matching step 256 K rows on), and turns
// each 4 x 4 byte group around with __byte_perm: four fragments, four
// wgmmas, issued while the step before is still in flight. The same
// layout makes the epilogue's stores whole: a thread's four columns of a
// token are one float4, eight lanes a 128-byte line.
//
// Epilogue: (float(acc) * sa[i]) * sw[j] with __fmul_rn, the plain
// version's order, so out equals it bit for bit; each thread stores its
// own sums while the producer fills the ring with the next tile's stages.
#pragma once

#include "w4a8.cuh"
#include "wgmma.cuh"

namespace htog {
namespace w4 {

constexpr int THREADS = 288;       // two consumer warpgroups, a producer
constexpr int TILE_N = 256;        // output columns a tile, 128 a consumer
constexpr int PACK_ROWS = 128;     // packed rows a stage
constexpr int GROUP_T = 8;         // token tiles a group of the walk
constexpr int PK_BYTES = PACK_ROWS * wg::LINE;   // one consumer's box
constexpr int SMEM_LIMIT = 232448;

// Stage layout: QA's low-K box, its high-K box (BT lines of 128 K each),
// then the two consumers' packed boxes (128 lines of 128 columns).
template <int BT>
struct Layout {
  static constexpr int QA_BYTES = BT * wg::LINE;
  static constexpr int STAGE = 2 * QA_BYTES + 2 * PK_BYTES;
  static constexpr int ST =
      (SMEM_LIMIT - wg::ATOM - 256) / STAGE;   // stages of the ring
  static constexpr int SMEM = ST * STAGE + wg::ATOM +
                              static_cast<int>(sizeof(wg::Ring<ST>));
  static_assert(SMEM <= SMEM_LIMIT, "the ring fits a block's shared memory");
  static_assert(BT % 16 == 0 && BT <= 256, "a wgmma N for 8-bit types");
};

// Stages of a tile: pack block b's halves h with K rows from
// 512 b + 128 h below K.
__device__ __forceinline__ int stages(int K) {
  int rest = K % 512;
  return 2 * (K / 512) + (rest > 128 ? 2 : rest > 0 ? 1 : 0);
}

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

// The four A fragments of 32-deep step i of a stage from the consumer's
// packed box: f[0], f[1] the low nibbles for slabs 0 and 1 (K rows
// 32 i .. of the stage's low range), f[2], f[3] the high ones (the same
// rows of its high range). off[j]: the byte offset of this thread's word
// in the box's row 4 t + j (swizzled: the 16-byte chunk index XORed with
// the row's index mod 8, which is (4 t + j) mod 8 for every row read).
template <int I>
__device__ __forceinline__ void fragments(const uint8_t* box,
                                          const int (&off)[4],
                                          uint32_t (&f)[4][4]) {
  uint32_t lo[2][4], hi[2][4];
#pragma unroll
  for (int grp = 0; grp < 2; ++grp) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = *reinterpret_cast<const uint32_t*>(
          box + (32 * I + 16 * grp) * wg::LINE + off[j]);
    uint32_t dl[4], dh[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dl[j] = decode_lo4(w[j]);
      dh[j] = decode_hi4(w[j]);
    }
    transpose4(dl, lo[grp]);
    transpose4(dh, hi[grp]);
  }
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    f[s][0] = lo[0][2 * s];
    f[s][1] = lo[0][2 * s + 1];
    f[s][2] = lo[1][2 * s];
    f[s][3] = lo[1][2 * s + 1];
    f[2 + s][0] = hi[0][2 * s];
    f[2 + s][1] = hi[0][2 * s + 1];
    f[2 + s][2] = hi[1][2 * s];
    f[2 + s][3] = hi[1][2 * s + 1];
  }
}

// One consumer's wgmmas of step I: f's low fragments against QA's low box,
// the high ones against its high box, each slab into its own sums.
template <int BT, int I>
__device__ __forceinline__ void issue(int (&acc)[2][BT / 2],
                                      const uint32_t (&f)[4][4],
                                      uint32_t qa_lo, uint32_t qa_hi,
                                      int accumulate) {
  uint64_t dlo = wg::kmajor_desc(qa_lo, I);
  uint64_t dhi = wg::kmajor_desc(qa_hi, I);
  WgmmaS8<BT>::rs(acc[0], f[0], dlo, accumulate);
  WgmmaS8<BT>::rs(acc[1], f[1], dlo, accumulate);
  WgmmaS8<BT>::rs(acc[0], f[2], dhi, 1);
  WgmmaS8<BT>::rs(acc[1], f[3], dhi, 1);
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

// tqa: QA (M, K) int8, boxes of 128 K x BT tokens; tw: P (rows, N) int8,
// boxes of 128 columns x 128 packed rows; both with the 128-byte swizzle.
template <int BT>
__global__ void __launch_bounds__(THREADS, 1)
    w4a8_wgmma(const __grid_constant__ CUtensorMap tqa,
               const __grid_constant__ CUtensorMap tw, const float* sa,
               const float* sw, float* out, int M, int N, int K, int ldc) {
  using L = Layout<BT>;
  constexpr int ST = L::ST;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = wg::align_1024(smem_raw);
  auto& ring = *reinterpret_cast<wg::Ring<ST>*>(smem + ST * L::STAGE);
  int num_t = (M + BT - 1) / BT;
  int num_n = (N + TILE_N - 1) / TILE_N;
  int tiles = num_t * num_n;
  int nst = stages(K);
  int warp = threadIdx.x >> 5;
  int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) ring.init();
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
        int k0 = (st >> 1) * 512 + (st & 1) * 128;
        int prow = (st >> 1) * 256 + (st & 1) * 128;
        wg::wait_empty(ring, q);
        mbar_arrive_expect_tx(full, L::STAGE);
        wg::tma_2d(stage, &tqa, k0, ti * BT, full);
        wg::tma_2d(stage + L::QA_BYTES, &tqa, k0 + 256, ti * BT, full);
        wg::tma_2d(stage + 2 * L::QA_BYTES, &tw, tj * TILE_N, prow, full);
        wg::tma_2d(stage + 2 * L::QA_BYTES + PK_BYTES, &tw,
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
    int r = 4 * tq + j;
    off[j] = r * wg::LINE + ((((col >> 4) ^ (r & 7)) << 4) | (col & 15));
  }
  bool vec = (ldc & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  uint32_t base = smem_u32(smem);
  int acc[2][BT / 2];
  uint32_t f[2][4][4];
  int q = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int ti, tj;
    tile_of(t, num_t, num_n, ti, tj);
    int prev = -1;   // the slot whose last products may still be in flight
    for (int st = 0; st < nst; ++st, ++q) {
      int s = q % ST;
      uint32_t qa_lo = base + s * L::STAGE;
      uint32_t qa_hi = qa_lo + L::QA_BYTES;
      const uint8_t* box = smem + s * L::STAGE + 2 * L::QA_BYTES +
                           cw * PK_BYTES;
      int fresh = st == 0 ? 0 : 1;
      wg::wait(&ring.full[s], (q / ST) & 1);
      // step i's fragments are decoded while step i - 1's products run;
      // step i's wait<1> frees the fragments of step i - 1
#define W4_STEP(I)                                                     \
  fragments<I>(box, off, f[(I) & 1]);                                  \
  wg::wgmma_fence();                                                   \
  issue<BT, I>(acc, f[(I) & 1], qa_lo, qa_hi, (I) == 0 ? fresh : 1);   \
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
    for (int c = 0; c < 4; ++c) w4[c] = n + c < N ? sw[n + c] : 0.0f;
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        int tok = ti * BT + 8 * j + 2 * tq + e;
        if (tok >= M) continue;
        float s_row = sa[tok];
        int v[4] = {acc[0][4 * j + e], acc[0][4 * j + 2 + e],
                    acc[1][4 * j + e], acc[1][4 * j + 2 + e]};
        float y[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          y[c] = __fmul_rn(__fmul_rn(__int2float_rn(v[c]), s_row), w4[c]);
        float* o = out + static_cast<size_t>(tok) * ldc + n;
        if (vec && n + 3 < N) {
          *reinterpret_cast<float4*>(o) = make_float4(y[0], y[1], y[2], y[3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (n + c < N) o[c] = y[c];
        }
      }
    }
  }
}

// Launches w4a8_wgmma<BT> over the (M, N) output: one block an SM, at most
// one a tile. qa (M, lda) int8 with K <= lda
// valid columns (a 16-byte pitch), packed (Kp/2, ldb) int8 with
// round_up(K, 512) <= Kp, out (M, ldc) float32; bases 16-byte aligned.
// Returns a cudaError_t as an int.
template <int BT>
int launch_bt(const void* qa, const void* packed, const float* sa,
              const float* sw, float* out, int M, int N, int K, int lda,
              int ldb, int ldc, int sms, cudaStream_t stream) {
  using L = Layout<BT>;
  CUtensorMap tqa, tw;
  cuuint64_t qdims[2] = {static_cast<cuuint64_t>(K),
                         static_cast<cuuint64_t>(M)};
  cuuint64_t qstrides[1] = {static_cast<cuuint64_t>(lda)};
  cuuint32_t qbox[2] = {128, BT};
  int rows = (K + 511) / 512 * 256;
  cuuint64_t wdims[2] = {static_cast<cuuint64_t>(N),
                         static_cast<cuuint64_t>(rows)};
  cuuint64_t wstrides[1] = {static_cast<cuuint64_t>(ldb)};
  cuuint32_t wbox[2] = {128, PACK_ROWS};
  if (!wg::make_map(&tqa, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, qa, qdims,
                    qstrides, qbox, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !wg::make_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, packed, wdims,
                    wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      w4a8_wgmma<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  int tiles = (M + BT - 1) / BT * ((N + TILE_N - 1) / TILE_N);
  w4a8_wgmma<BT><<<tiles < sms ? tiles : sms, THREADS, L::SMEM, stream>>>(
      tqa, tw, sa, sw, out, M, N, K, ldc);
  return static_cast<int>(cudaGetLastError());
}

// Launches w4a8_wgmma<token_tile(M, N, SMs)>; *bt is set to that tile.
inline int launch(const void* qa, const void* packed, const void* sa,
                  const void* sw, void* out, int M, int N, int K, int lda,
                  int ldb, int ldc, cudaStream_t stream, int* bt) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  *bt = token_tile(M, N, sms);
  auto run = *bt == 64 ? launch_bt<64> : launch_bt<128>;
  return run(qa, packed, static_cast<const float*>(sa),
             static_cast<const float*>(sw), static_cast<float*>(out), M, N,
             K, lda, ldb, ldc, sms, stream);
}

}  // namespace w4
}  // namespace htog
