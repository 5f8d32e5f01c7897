// bf16_gemm_nt: C += A @ BT^T with bf16 operands and fp32 accumulation, in
// place: rung 15, the bf16 summit.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_tuned.py, _kernel_bf16_bt
// (via mmult_bf16_bt; C aliased into the output). A (M, K) bf16 and BT
// (N, K) bf16, both row-major (B packed transposed offline,
// prepare_bf16_bt), C (M, N) fp32 read and written in place. The
// accumulator starts at 0 and C is added at the flush, as the reference's
// _flush does.
//
// Bound on an H100 SXM at M = N = K = 4096: 1.37e11 operations (0.139 ms
// at the 989 TFLOP/s dense bf16 peak) against 201 MB of traffic (A and BT
// 33.6 MB each, C read and written 134 MB; 0.060 ms at 3.35 TB/s): the
// tensor cores bound it, as long as C's read and write overlap the
// products.
//
// Design (wgmma.cuh's building blocks): a persistent grid, one block an
// SM, walking 128 x 256 output tiles in groups of GROUP_M row tiles (the
// blocks running at once share a few A row tiles and B in L2). Warp 0's
// lane 0 is the producer: it copies A's 128 x 64 and BT's 256 x 64 tile of
// each K stage by tensor map into a ring of ST stages (48 KB a stage;
// rows past M or N and K values past K arrive as the copies' zero fill),
// and runs on into the next tile's stages while the consumers finish a
// tile. Warpgroups 1 and 2 are the consumers, 64 rows of the tile each:
// wgmma.m64n256k16 from shared memory, A and BT both K-major (one 128-byte
// swizzled line holds 64 K values of a row), 128 fp32 accumulators a
// thread; one stage's products stay in flight while the next stage is
// awaited, and a slot goes back to the producer (the ring's empty barrier)
// once the products that read it have completed. No block barrier in the
// main loop, and no wgmma wait on a branch: ptxas serializes the products
// of a loop shaped like wgmma.cuh's consume() (its note C7518).
//
// Epilogue: out = sums + C. Where C is written in place and its rows are
// 16-byte multiples (the main path: rung 15 aliases C into the output),
// each consumer stages its sums in shared memory 32 columns at a time and
// the tensor-map unit adds them into C (cp.reduce.async.bulk.tensor .add,
// reduce_c), in L2, while the consumers go on to the next tile: C's 134
// MB at 4,096 move beside the products instead of after them (measured
// 1.36x faster than each thread adding C itself). Elsewhere each element
// is read and written by the thread that owns it (add_c: c and out may be
// one buffer; plain stores with bounds checks).
//
// Accumulation: the straight fp32 sum of the tensor cores over all of K
// (CH = 0), measured within W4A16_REL / 2 of the plain version at K up to
// 4,096 on an H100; CH > 0 sums CH stages in the wgmma accumulator and
// adds each partial into a second fp32 array (wgmma.cuh), which only 128 x
// 128 tiles (BN 128) leave room for (harness/flash_variants.py --group
// gemm builds both).
#include "wgmma.cuh"

namespace htog {
namespace nt {

constexpr int BM = 128;         // output rows a block, 64 a consumer
constexpr int BN = 256;         // output columns a tile
constexpr int CH = 0;           // stages a partial sum (0: one sum over K)
constexpr int ST = 4;           // stages of the ring
constexpr int GROUP_M = 8;      // row tiles a group of the walk
constexpr int ACC = BN / 2;     // accumulators a thread
constexpr int A_BYTES = BM * wg::LINE;
constexpr int STAGE = (BM + BN) * wg::LINE;

// the epilogue's staging: per consumer two buffers of 64 rows x OUT_COLS
// fp32 (one 128-byte swizzled line a row), each the source of one
// tensor-map reduction into C
constexpr int OUT_COLS = 32;
constexpr int OUT_BOX = 64 * OUT_COLS * 4;
constexpr int OUT_BYTES = 2 * 2 * OUT_BOX;

constexpr int SMEM = ST * STAGE + OUT_BYTES +
                     static_cast<int>(sizeof(wg::Ring<ST>)) + wg::ATOM;
static_assert(SMEM <= 232448, "the ring fits a block's shared memory");

// (row, column) origin of tile t of a num_m x num_n grid of tiles: groups
// of GROUP_M row tiles, the row tile fastest inside a group
// (ops/tuned.nt_tile_walk is the same walk).
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

// C += the shared-memory box at src (OUT_COLS x 64 fp32) at (c0, c1), by
// the tensor-map unit, tracked by this thread's bulk groups.
__device__ __forceinline__ void tma_reduce_add_2d(const CUtensorMap* map,
                                                  const void* src, int c0,
                                                  int c1) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.2d.global.shared::cta.add.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

// C += d over a consumer's 64 rows from row0 and the tile's columns from
// col0 (wgmma's accumulator layout), OUT_COLS columns at a time: the
// warpgroup writes them into one of its two buffers (swizzled as the map
// reads them), fences them for the async proxy and meets (named barrier 1
// + cw), and its first thread hands them to the tensor-map unit, which
// adds them into C in L2 while the consumers go on to the next tile; a
// buffer is written again once its reduction has read it. Rows and
// columns past C's edges are not written. fp32 addition commutes, so C +
// d is the reference's d + C bit for bit.
template <int NA>
__device__ __forceinline__ void reduce_c(const float (&d)[NA],
                                         uint8_t* bufs,
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
      tma_reduce_add_2d(tc, buf, col0 + OUT_COLS * ch, row0);
      bulk_commit();
    }
  }
}

// out = d + C over a consumer's 64 rows from row0 and the tile's columns
// from col0 (wgmma's accumulator layout), rows below M and columns below N.
template <int NA>
__device__ __forceinline__ void add_c(const float (&d)[NA], const float* c,
                                      float* out, int M, int N, int ldc,
                                      int row0, int col0) {
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
    for (int j = 0; j < NA / 4; ++j) {
      int col = col0 + 8 * j;
      float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
      if (col + 1 < N &&
          (reinterpret_cast<uintptr_t>(crow + col) & 7) == 0 &&
          (reinterpret_cast<uintptr_t>(orow + col) & 7) == 0) {
        float2 cv = *reinterpret_cast<const float2*>(crow + col);
        *reinterpret_cast<float2*>(orow + col) =
            make_float2(__fadd_rn(v0, cv.x), __fadd_rn(v1, cv.y));
      } else {
        if (col < N) orow[col] = __fadd_rn(v0, crow[col]);
        if (col + 1 < N) orow[col + 1] = __fadd_rn(v1, crow[col + 1]);
      }
    }
  }
}

__global__ void __launch_bounds__(wg::BLOCK, 1)
    bf16_nt_wgmma(const __grid_constant__ CUtensorMap ta,
                  const __grid_constant__ CUtensorMap tb,
                  const __grid_constant__ CUtensorMap tc, const float* c,
                  float* out, int M, int N, int K, int ldc, int reduce) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = wg::align_1024(smem_raw);
  auto& ring = *reinterpret_cast<wg::Ring<ST>*>(smem + ST * STAGE + OUT_BYTES);
  int num_m = (M + BM - 1) / BM;
  int num_n = (N + BN - 1) / BN;
  int tiles = num_m * num_n;
  int nk = (K + wg::KT - 1) / wg::KT;
  int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (warp < 4) {
    if (threadIdx.x != 0) return;
    int q = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int m0, n0;
      tile_of(t, num_m, num_n, m0, n0);
      for (int kq = 0; kq < nk; ++kq, ++q) {
        int s = q % ST;
        uint8_t* st = smem + s * STAGE;
        wg::wait_empty(ring, q);
        mbar_arrive_expect_tx(&ring.full[s], STAGE);
        wg::tma_2d(st, &ta, kq * wg::KT, m0, &ring.full[s]);
        wg::tma_2d(st + A_BYTES, &tb, kq * wg::KT, n0, &ring.full[s]);
      }
    }
    return;
  }

  int cw = (warp >> 2) - 1;
  uint32_t base = smem_u32(smem);
  int q = 0;
  float acc[ACC];
  float tot[ACC];   // CH > 0: the sum of the partials
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int m0, n0;
    tile_of(t, num_m, num_n, m0, n0);
    zero(acc);
    if constexpr (CH > 0) zero(tot);
    int prev = -1;   // the slot of the products still in flight
    for (int kq = 0; kq < nk; ++kq, ++q) {
      int s = q % ST;
      uint32_t a = base + s * STAGE + cw * (A_BYTES / 2);
      uint32_t b = base + s * STAGE + A_BYTES;
      wg::wait(&ring.full[s], (q / ST) & 1);
      // (acc unfenced: the group before still writes it)
      wg::wgmma_fence();
      bool fresh = CH > 0 && kq % CH == 0;
#pragma unroll
      for (int k = 0; k < wg::KT / 16; ++k)
        wg::Wgmma<BN>::ss<0, 0>(acc, wg::kmajor_desc(a, k),
                                wg::kmajor_desc(b, k), fresh && k == 0 ? 0 : 1);
      wg::wgmma_commit();
      if constexpr (CH > 0) {
        if ((kq + 1) % CH == 0 || kq + 1 == nk) {
          wg::wgmma_wait<0>();
          wg::fence_regs(acc);
#pragma unroll
          for (int i = 0; i < ACC; ++i) tot[i] = __fadd_rn(tot[i], acc[i]);
        }
      }
      wg::wgmma_wait<1>();
      if (prev >= 0) wg::release(ring, prev);
      prev = s;
    }
    wg::wgmma_wait<0>();
    wg::fence_regs(acc);
    wg::release(ring, prev);
    uint8_t* bufs = smem + ST * STAGE + cw * 2 * OUT_BOX;
    auto finish = [&](const float(&d)[ACC]) {
      if (reduce)
        reduce_c(d, bufs, &tc, m0 + 64 * cw, n0, cw);
      else
        add_c(d, c, out, M, N, ldc, m0 + 64 * cw, n0);
    };
    if constexpr (CH > 0)
      finish(tot);
    else
      finish(acc);
  }
  if ((threadIdx.x & 127) == 0) bulk_wait_all();
}

// A (rows, cols) bf16 matrix of row pitch ld elements as a 2-D map, boxes
// of box_rows rows x 64 values, 128-byte swizzle.
bool make_kmajor_map(CUtensorMap* map, const void* base, int rows, int cols,
                     int ld, int box_rows) {
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                        static_cast<cuuint64_t>(rows)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  return wg::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, dims,
                      strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// Encodes the maps and launches one block an SM, at most one a tile.
// Returns a cudaError_t as an int.
int launch(const void* a, const void* bt, const void* c, void* out, int M,
           int N, int K, int lda, int ldb, int ldc, cudaStream_t stream) {
  CUtensorMap ta, tb, tc;
  if (!make_kmajor_map(&ta, a, M, K, lda, BM) ||
      !make_kmajor_map(&tb, bt, N, K, ldb, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  // C in place, its rows 16-byte multiples: the epilogue hands the sums to
  // the tensor-map unit to add into C (reduce_c); else each thread adds C
  // itself (add_c)
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(N),
                        static_cast<cuuint64_t>(M)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(ldc) * 4};
  cuuint32_t box[2] = {OUT_COLS, 64};
  int reduce = c == out && ldc % 4 == 0 &&
               reinterpret_cast<uintptr_t>(c) % 16 == 0 &&
               wg::make_map(&tc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, out,
                            dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!reduce) tc = ta;   // not read
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        bf16_nt_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  bf16_nt_wgmma<<<tiles < sms ? tiles : sms, wg::BLOCK, SMEM, stream>>>(
      ta, tb, tc, static_cast<const float*>(c), static_cast<float*>(out), M,
      N, K, ldc, reduce);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nt
}  // namespace htog

// a (M, lda) and bt (N, ldb) bf16 with K a multiple of 8 and K <= lda,
// ldb, lda and ldb multiples of 8, bases 16-byte aligned; c, out (M, ldc)
// fp32, which may be one buffer. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a tensor map the CUDA driver refuses).
extern "C" int bf16_gemm_nt(const void* a, const void* bt, const void* c,
                            void* out, int M, int N, int K, int lda,
                            int ldb, int ldc, void* stream) {
  return htog::nt::launch(a, bt, c, out, M, N, K, lda, ldb, ldc,
                          static_cast<cudaStream_t>(stream));
}
