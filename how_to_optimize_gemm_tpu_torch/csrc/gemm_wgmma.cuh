// One persistent wgmma GEMM body fed by tensor maps: the kernel of rung 15
// (bf16_gemm_nt.cu), rung 16 (fp32_gemm_nt.cu, three bf16 products on
// split operands), rung 05 (bf16_gemm_nn.cu, B read N-major) and rung 04
// (fp32_gemm_nn.cu, three bf16 products on split operands with B read
// N-major, the partial sums seeded with C). Each of those files names its
// instance's constants in a struct P:
//   BN        output columns a tile (256: 128 fp32 accumulators a thread;
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
//
// Block (wgmma.cuh's shape, 384 threads): a persistent grid, one block an
// SM, walking BM x BN output tiles in groups of GROUP_M row tiles (the
// blocks running at once share a few A row tiles and B in L2). Warp 0's
// lane 0 is the producer: it copies each K stage's tiles by tensor map into
// a ring of ST stages (rows past M or N and K values past K arrive as the
// copies' zero fill) and runs on into the next tile's stages while the
// consumers finish a tile. Warpgroups 1 and 2 are the consumers, 64 rows of
// the tile each, wgmma.m64nBNk16 from shared memory; one stage's products
// stay in flight while the next stage is awaited, and a slot goes back to
// the producer (the ring's empty barrier) once the products that read it
// have completed. No block barrier in the main loop, and no wgmma wait on a
// branch: ptxas serializes the products of a loop shaped like wgmma.cuh's
// consume() (its note C7518; rung 15 ran 1.15x slower in that shape).
//
// Sums: CH = 0 is the tensor cores' straight fp32 sum over K. CH > 0 sums
// CH stages in the wgmma accumulator, then adds that partial into a second
// fp32 array (0, or C with SEED_C) with __fadd_rn in K's order and
// restarts the wgmma sum: the fixed order of a fixed tiling, the same bits
// on every run.
//
// Epilogue: where out's rows are 16-byte multiples (and, adding C, C is out
// itself), each consumer stages its sums in shared memory 32 columns at a
// time and the tensor-map unit adds them into C (cp.reduce.async.bulk.tensor
// .add) or stores them, in L2, while the consumers go on to the next tile.
// Elsewhere each element is read and written by the thread that owns it.
#pragma once

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

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.0f;
}

// The shared-memory box at src (OUT_COLS x 64 fp32) added into (kAdd) or
// stored over the global tensor at (c0, c1), by the tensor-map unit,
// tracked by this thread's bulk groups.
template <bool kAdd>
__device__ __forceinline__ void tma_out_2d(const CUtensorMap* map,
                                           const void* src, int c0, int c1) {
  if constexpr (kAdd) {
    asm volatile(
        "cp.reduce.async.bulk.tensor.2d.global.shared::cta.add.bulk_group"
        " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_u32(src)), "r"(c0), "r"(c1)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
        " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_u32(src)), "r"(c0), "r"(c1)
        : "memory");
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
template <bool kAdd, int NA>
__device__ __forceinline__ void flush_tma(const float (&d)[NA], uint8_t* bufs,
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
        *reinterpret_cast<float2*>(buf + off) =
            make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      }
    }
    fence_proxy_async();
    wg::bar_sync(1 + cw, 128);
    if (t == 0) {
      tma_out_2d<kAdd>(tc, buf, col0 + OUT_COLS * ch, row0);
      bulk_commit();
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
template <bool kAdd, int NA>
__device__ __forceinline__ void flush_threads(const float (&d)[NA],
                                              const float* c, float* out,
                                              int M, int N, int ldc, int row0,
                                              int col0) {
  for_each_row_pair(d, c, out, M, ldc, row0, col0,
                    [&](float v0, float v1, const float* crow, float* orow,
                        int col) {
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
  static constexpr int NP = P::PRODUCTS == 3 ? 2 : 1;   // planes of A, of B
  // a B plane: BN K-major rows, or BN / 64 N-major boxes of HALF_TILE
  static constexpr int B_BYTES = P::BN * wg::LINE;
  static constexpr int B = NP * A_BYTES;                // B's offset
  static constexpr int STAGE = NP * (A_BYTES + B_BYTES);
  static constexpr int ACC = P::BN / 2;                 // accumulators
  static constexpr int SMEM = P::ST * STAGE + OUT_BYTES +
                              static_cast<int>(sizeof(wg::Ring<P::ST>)) +
                              wg::ATOM;
  static_assert(SMEM <= 232448, "the ring fits a block's shared memory");
  static_assert(P::PRODUCTS == 1 || P::PRODUCTS == 3,
                "one product, or three of split planes");
  static_assert(P::BN % 64 == 0, "an N-major B is whole 64-column boxes");
};

// ta: A (M, K) K-major, or its split planes (3-D); tb: BT (N, K) K-major,
// or B (K, N) N-major, or the split planes of either; tc: out (M, ldc)
// fp32 in boxes of 64 rows x OUT_COLS, read when tma_out (else each thread
// writes out).
template <class P>
__global__ void __launch_bounds__(wg::BLOCK, 1)
    gemm_wgmma(const __grid_constant__ CUtensorMap ta,
               const __grid_constant__ CUtensorMap tb,
               const __grid_constant__ CUtensorMap tc, const float* c,
               float* out, int M, int N, int K, int ldc, int tma_out) {
  using L = Layout<P>;
  constexpr int BN = P::BN;
  constexpr int ST = P::ST;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = wg::align_1024(smem_raw);
  auto& ring = *reinterpret_cast<wg::Ring<ST>*>(smem + ST * L::STAGE +
                                                OUT_BYTES);
  int num_m = (M + BM - 1) / BM;
  int num_n = (N + BN - 1) / BN;
  int tiles = num_m * num_n;
  int stages = (K + wg::KT - 1) / wg::KT;     // ring uses a tile
  int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (warp < 4) {
    if (threadIdx.x != 0) return;
    int q = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int m0, n0;
      tile_of<BN>(t, num_m, num_n, m0, n0);
      for (int kq = 0; kq < stages; ++kq, ++q) {
        int s = q % ST;
        uint8_t* st = smem + s * L::STAGE;
        uint64_t* full = &ring.full[s];
        int k0 = kq * wg::KT;
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
              for (int j = 0; j < BN / 64; ++j)
                wg::tma_3d(bp + j * wg::HALF_TILE, &tb, n0 + 64 * j, k0, p,
                           full);
            } else {
              wg::tma_3d(bp, &tb, k0, n0, p, full);
            }
          }
        } else {
          wg::tma_2d(st, &ta, k0, m0, full);
          if constexpr (P::B_MN) {
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              wg::tma_2d(st + L::B + j * wg::HALF_TILE, &tb, n0 + 64 * j, k0,
                         full);
          } else {
            wg::tma_2d(st + L::B, &tb, k0, n0, full);
          }
        }
      }
    }
    return;
  }

  int cw = (warp >> 2) - 1;
  uint32_t base = smem_u32(smem);
  uint8_t* bufs = smem + ST * L::STAGE + cw * 2 * OUT_BOX;
  int chunk = P::CH > 0 ? P::CH : stages;
  int q = 0;
  float acc[L::ACC];
  float tot[P::CH > 0 ? L::ACC : 1];   // CH > 0: the sum of the partials
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int m0, n0;
    tile_of<BN>(t, num_m, num_n, m0, n0);
    int row0 = m0 + 64 * cw;
    if constexpr (P::SEED_C && P::CH == 0)
      seed_c(acc, c, M, N, ldc, row0, n0);
    else
      zero(acc);
    if constexpr (P::CH > 0) {
      if constexpr (P::SEED_C)
        seed_c(tot, c, M, N, ldc, row0, n0);
      else
        zero(tot);
    }
    for (int kc = 0; kc < stages; kc += chunk) {
      int kend = min(stages, kc + chunk);
      int prev = -1;   // the slot of the products still in flight
      for (int kq = kc; kq < kend; ++kq, ++q) {
        int s = q % ST;
        uint32_t a = base + s * L::STAGE + cw * (A_BYTES / 2);
        uint32_t b = base + s * L::STAGE + L::B;
        wg::wait(&ring.full[s], (q / ST) & 1);
        // (acc unfenced: the group before still writes it)
        wg::wgmma_fence();
        bool fresh = P::CH > 0 && kq == kc;
#pragma unroll
        for (int k = 0; k < wg::KT / 16; ++k) {
          constexpr int TB = P::B_MN ? 1 : 0;
          uint64_t da = wg::kmajor_desc(a, k);
          uint64_t db = P::B_MN ? wg::mnmajor_desc(b, k)
                                : wg::kmajor_desc(b, k);
          wg::Wgmma<BN>::template ss<0, TB>(acc, da, db,
                                            fresh && k == 0 ? 0 : 1);
          if constexpr (P::PRODUCTS == 3) {
            uint64_t db_lo = P::B_MN ? wg::mnmajor_desc(b + L::B_BYTES, k)
                                     : wg::kmajor_desc(b + L::B_BYTES, k);
            wg::Wgmma<BN>::template ss<0, TB>(acc, da, db_lo, 1);
            wg::Wgmma<BN>::template ss<0, TB>(
                acc, wg::kmajor_desc(a + A_BYTES, k), db, 1);
          }
        }
        wg::wgmma_commit();
        wg::wgmma_wait<1>();
        if (prev >= 0) wg::release(ring, prev);
        prev = s;
      }
      wg::wgmma_wait<0>();
      wg::fence_regs(acc);
      wg::release(ring, prev);
      if constexpr (P::CH > 0) {
#pragma unroll
        for (int i = 0; i < L::ACC; ++i) tot[i] = __fadd_rn(tot[i], acc[i]);
      }
    }
    auto finish = [&](const float(&d)[L::ACC]) {
      constexpr bool kAdd = !P::SEED_C;
      if (tma_out)
        flush_tma<kAdd>(d, bufs, &tc, row0, n0, cw);
      else
        flush_threads<kAdd>(d, c, out, M, N, ldc, row0, n0);
    };
    if constexpr (P::CH > 0)
      finish(tot);
    else
      finish(acc);
  }
  if ((threadIdx.x & 127) == 0) bulk_wait_all();
}

// Launches gemm_wgmma<P> over the (M, N) output, one block an SM, at most
// one a tile, on the maps of A and B. c and out (M, ldc) fp32: with
// SEED_C, out = C + A.B (C + p1 + p2 + ... with CH > 0); else out = A.B +
// C, c and out one buffer or two.
// The epilogue goes through the tensor-map unit where out's rows are
// 16-byte multiples on a 16-byte base (and, adding C, c is out). Returns a
// cudaError_t as an int.
template <class P>
int launch(const CUtensorMap& ta, const CUtensorMap& tb, const void* c,
           void* out, int M, int N, int K, int ldc, cudaStream_t stream) {
  using L = Layout<P>;
  CUtensorMap tc;
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(N),
                        static_cast<cuuint64_t>(M)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(ldc) * 4};
  cuuint32_t box[2] = {OUT_COLS, 64};
  int tma_out = (P::SEED_C || c == out) && ldc % 4 == 0 &&
                reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                wg::make_map(&tc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, out,
                             dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!tma_out) tc = ta;   // not read
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gemm_wgmma<P>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  int tiles = ((M + BM - 1) / BM) * ((N + P::BN - 1) / P::BN);
  gemm_wgmma<P><<<tiles < sms ? tiles : sms, wg::BLOCK, L::SMEM, stream>>>(
      ta, tb, tc, static_cast<const float*>(c), static_cast<float*>(out), M,
      N, K, ldc, tma_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gw
}  // namespace htog
