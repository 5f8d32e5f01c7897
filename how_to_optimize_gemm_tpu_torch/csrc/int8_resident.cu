// Rungs 12 and 13, the operand-resident hand pipelines, each into a fresh
// output, both on rung 10's ping-pong instance of gemm_wgmma.cuh's int8
// wgmma body:
//   int8_resident_nt (rung 12): C' = f32(QA @ QBT^T as int32) * sa * sb + C
//     with A and B^T held in the L2;
//   int8_pretile (rung 13's first launch): an int8 matrix (rows, K) into
//     stage images (tiles, nk, 128, 128), each the 16 KB a tensor-map copy
//     of its 128 x 128 box would land (the 128-byte swizzle);
//   int8_tiled_resident_nt (rung 13): rung 12's function on the pretiled
//     operands, each stage one 1-D bulk copy an operand (TILED).
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_manual_dma.py,
// _make_resident_kernel (via mmult_q_resident, rung 12_resident_int8) and
// _make_tiled_resident_kernel (via mmult_q_tiled_resident, rung
// 13_tiled_resident_int8). Both keep the two operands on chip for the whole
// walk, so device-memory traffic falls to A + B + C + out (168 MB at
// p = 4096 instead of the streaming rungs' re-reads of every A strip and
// B^T panel).
//
// Bound on an H100 SXM at M = N = K = 4096: 1.37e11 int operations (69 us
// at the 1,979 TOP/s dense int8 peak) against 168 MB (50 us at 3.35 TB/s):
// the tensor cores bound both; int8_pretile moves bytes only (an operand
// read and its image written: 33.5 MB, 10 us).
//
// Design. On the TPU the resident store is VMEM (the reference keeps 96 MB
// there). A block's 227 KB of shared memory holds no 16 MB operand, and a
// cluster's shared memory (at most 16 x 227 KB) would fall back at every
// sweep size; the card's on-chip store of that size is the 50 MB L2. So:
// - rung 12 is rung 10's walk with the L2 told what to keep (RESIDENT,
//   gemm_wgmma.cuh): before its walk the grid prefetches A and B^T into
//   the L2 (cp.async.bulk.prefetch.L2 under an evict_last policy, each
//   block its share: the reference's "DMA each operand once"), every
//   stage's tensor-map copy carries evict_last, and C's loads and the
//   output's stores carry evict_first, so 128 MB of C and out stream past
//   the 33.5 MB of operands. No process-wide state is set (no persisting-L2
//   limit, no access-policy window): the policy rides on each copy, and
//   each block sets its share of the lines back to evict_normal at its
//   end. Its sums and epilogue are rung 10's: the output equals the plain
//   version bit for bit;
// - rung 13 repacks first (int8_pretile), writing each operand once into
//   scratch laid out as the stage's exact image, the reference's packA /
//   packB ("the layout the micro-kernel consumes"): on this card that is
//   the 128-byte-swizzled box the tensor-map copy lands, 16-byte chunk c
//   of row r at chunk c ^ (r & 7), zeros past the rows and K. A stage is
//   then one 1-D bulk copy of 16,384 bytes an operand (TILED), the tensor
//   map's address walk spared; the prefetch, the policies and the
//   consumers are rung 12's. The repack gives a 128-byte image line to 8
//   consecutive threads, thread c' loading the source's chunk c' ^ (r & 7)
//   and storing chunk c', so a warp reads 4 whole 128-byte source segments
//   and writes 4 whole lines; its stores carry evict_last, so the images
//   are written into the L2 they are read from. The stream orders the
//   launches, the card's form of the reference's per-chunk waits: no grid
//   barrier, no cooperative launch.
// The wrapper routes a call whose resident bytes exceed RESIDENT_BUDGET (a
// share of the L2) to rung 11, as the reference does above its VMEM budget.
#include "gemm_wgmma.cuh"

namespace htog {

// rung 10's instance (int8_fat.cu) with the operands kept in the L2
struct Rung12 {
  static constexpr int BN = 128;         // output columns a tile
  static constexpr int CH = 0;           // stages a partial sum (0: one sum)
  static constexpr int ST = 6;           // stages of the ring
  static constexpr int PRODUCTS = 1;
  static constexpr bool B_MN = false;
  static constexpr bool SEED_C = false;
  static constexpr bool S8 = true;       // int8 operands, int32 sums
  static constexpr bool LOAD_C = true;   // a fresh output, C loaded
  static constexpr bool PINGPONG = true;   // a consumer's whole tiles
  static constexpr bool RESIDENT = true;   // A and B^T kept in the L2
};

// rung 12's instance fed by 1-D bulk copies of int8_pretile's images
struct Rung13 : Rung12 {
  static constexpr bool TILED = true;
};

}  // namespace htog

namespace {

// 16-byte words of the (tiles, nk, 128, 128) image a thread, their loads
// in flight together
constexpr int PRETILE_WORDS = 4;

// Word w of the image: chunk c' = w % 8 of line r of image (t, kq) holds
// source row t * 128 + r, K bytes kq * 128 + 16 (c' ^ (r & 7)) .. + 16;
// zero past rows or K. A block takes THREADS x PRETILE_WORDS consecutive
// words, thread x words x, x + THREADS, ...
__global__ void __launch_bounds__(htog::THREADS)
    int8_pretile_kernel(const int8_t* src, int8_t* dst, int rows, int K,
                        int ld, unsigned nk, size_t words) {
  using namespace htog;
  const uint64_t keep = l2_evict_last();
  const size_t w0 = static_cast<size_t>(blockIdx.x) * THREADS *
                        PRETILE_WORDS + threadIdx.x;
  uint4 v[PRETILE_WORDS];
#pragma unroll
  for (int i = 0; i < PRETILE_WORDS; ++i) {
    const size_t w = w0 + static_cast<size_t>(i) * THREADS;
    const int c = static_cast<int>(w & 7);
    const size_t line = w >> 3;
    const int r = static_cast<int>(line % BM);
    const unsigned img = static_cast<unsigned>(line / BM);   // t nk + kq
    const int gr = static_cast<int>(img / nk) * BM + r;
    const int gk = static_cast<int>(img % nk) * wg::LINE + 16 * (c ^ (r & 7));
    v[i] = make_uint4(0, 0, 0, 0);
    if (w < words && gr < rows && gk < K)
      v[i] = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(gr) * ld + gk);
  }
#pragma unroll
  for (int i = 0; i < PRETILE_WORDS; ++i) {
    const size_t w = w0 + static_cast<size_t>(i) * THREADS;
    if (w < words)
      asm volatile(
          "st.global.L2::cache_hint.v4.b32 [%0], {%1, %2, %3, %4}, %5;\n" ::
              "l"(dst + w * 16),
          "r"(v[i].x), "r"(v[i].y), "r"(v[i].z), "r"(v[i].w), "l"(keep)
          : "memory");
  }
}

}  // namespace

// As int8_fat_nt: K and lda, ldb multiples of 16, ldc (the row pitch of c
// and out, >= N) a multiple of 4, every base 16-byte aligned. Returns a
// cudaError_t (cudaErrorInvalidValue for a tensor map the CUDA driver
// refuses).
extern "C" int int8_resident_nt(const void* qa, const void* qbt,
                                const void* sa, const void* sb, const void* c,
                                void* out, int M, int N, int K, int lda,
                                int ldb, int ldc, void* stream) {
  return htog::gw::launch_pingpong<htog::Rung12>(
      qa, qbt, sa, sb, c, out, M, N, K, lda, ldb, ldc,
      static_cast<cudaStream_t>(stream));
}

// src (rows, K) int8 with row pitch ld (K and ld multiples of 16, src
// 16-byte aligned) -> dst (tiles, nk, 128, 128), tiles = ceil(rows / 128),
// nk = ceil(K / 128), dst 16-byte aligned. Returns a cudaError_t.
extern "C" int int8_pretile(const void* src, void* dst, int rows, int K,
                            int ld, int tiles, int nk, void* stream) {
  using namespace htog;
  const size_t words = static_cast<size_t>(tiles) * nk * BM * 8;
  const size_t per_block = static_cast<size_t>(THREADS) * PRETILE_WORDS;
  const size_t blocks = (words + per_block - 1) / per_block;
  if (blocks == 0) return 0;
  int8_pretile_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(src), static_cast<int8_t*>(dst), rows, K, ld,
      nk, words);
  return static_cast<int>(cudaGetLastError());
}

// at, bt: int8_pretile's images of QA (ceil(M / 128), nk, 128, 128) and
// QBT (ceil(N / 128), nk, 128, 128), nk = ceil(K / 128); lda and ldb are
// not read. c and out as int8_resident_nt. Returns a cudaError_t.
extern "C" int int8_tiled_resident_nt(const void* at, const void* bt,
                                      const void* sa, const void* sb,
                                      const void* c, void* out, int M, int N,
                                      int K, int lda, int ldb, int ldc,
                                      void* stream) {
  return htog::gw::launch_tiled<htog::Rung13>(
      at, bt, sa, sb, c, out, M, N, K, ldc,
      static_cast<cudaStream_t>(stream));
}
