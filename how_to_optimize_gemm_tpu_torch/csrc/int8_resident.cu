// Rungs 12 and 13, the operand-resident hand pipelines, each into a fresh
// output:
//   int8_resident_nt (rung 12): C' = f32(QA @ QBT^T as int32) * sa * sb + C
//     with A and B^T held in the L2, on rung 10's ping-pong instance of
//     gemm_wgmma.cuh's int8 wgmma body;
//   int8_pretile (rung 13's first launch): an int8 matrix (rows, K) into
//     tile-contiguous slot images (tiles, nk, 128, LDS);
//   int8_tiled_resident_nt (rung 13): rung 12's function on the pretiled
//     operands, on manual_dma.cuh's persistent fat-tile kernel (128 x 128
//     tiles, a two-slot ring, two C/out buffers).
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
// the tensor cores bound both; int8_pretile moves bytes only (A and B^T
// read, 1.25 times their bytes written: 76 MB, 23 us).
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
//   scratch laid out as the ring slot's exact image: 128 rows of 64 K
//   bytes in the padded 80-byte pitch, edges zero-filled. A chunk is then
//   ONE 1-D bulk copy of 10,240 bytes, not 512 16-byte cp.async copies or
//   128 row copies (the reference's packA/packB: operands repacked into the
//   layout the inner kernel consumes). The repack's stores carry
//   evict_last, so the scratch is written into the L2 it is read from. The
//   stream orders the two launches, the card's form of the reference's
//   per-chunk waits: no grid barrier, no cooperative launch.
// The wrapper routes a call whose resident bytes exceed RESIDENT_BUDGET (a
// share of the L2) to rung 11, as the reference does above its VMEM budget.
#include "gemm_wgmma.cuh"
#include "manual_dma.cuh"

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

}  // namespace htog

namespace {

// Each 16 bytes of the (tiles, nk, 128, LDS) image: bytes [16 s, 16 s + 16)
// of slot row r of chunk kt of tile t, source row t * 128 + r and K bytes
// kt * 64 + 16 s; segment 4 of a row (bytes 64-79) and anything past rows
// or K is zero. Grid-stride over the image's 16-byte words.
__global__ void __launch_bounds__(htog::THREADS)
    int8_pretile_kernel(const int8_t* src, int8_t* dst, int rows, int K,
                        int ld, int tiles, int nk) {
  using namespace htog;
  constexpr int SEGS = LDS / 16;  // 5
  const uint64_t keep = l2_evict_last();
  const size_t words = static_cast<size_t>(tiles) * nk * BM * SEGS;
  for (size_t w = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       w < words; w += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int seg = static_cast<int>(w % SEGS);
    const int r = static_cast<int>((w / SEGS) % BM);
    const size_t tk = w / (SEGS * BM);
    const int kt = static_cast<int>(tk % nk);
    const int t = static_cast<int>(tk / nk);
    const int gr = t * BM + r;
    const int gk = kt * BK + seg * 16;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (seg < 4 && gr < rows && gk < K)
      v = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(gr) * ld +
                                          gk);
    asm volatile(
        "st.global.L2::cache_hint.v4.b32 [%0], {%1, %2, %3, %4}, %5;\n" ::"l"(
            dst + w * 16),
        "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "l"(keep)
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
// 16-byte aligned) -> dst (tiles, nk, 128, LDS), tiles = ceil(rows / 128),
// nk = ceil(K / 64), dst 16-byte aligned. Returns a cudaError_t.
extern "C" int int8_pretile(const void* src, void* dst, int rows, int K,
                            int ld, int tiles, int nk, void* stream) {
  using namespace htog;
  const size_t words = static_cast<size_t>(tiles) * nk * BM * (LDS / 16);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  size_t blocks = (words + THREADS - 1) / THREADS;
  const size_t cap = static_cast<size_t>(sms) * 8;
  if (blocks > cap) blocks = cap;
  if (blocks == 0) return 0;
  int8_pretile_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(src), static_cast<int8_t*>(dst), rows, K, ld,
      tiles, nk);
  return static_cast<int>(cudaGetLastError());
}

// at, bt: int8_pretile's images of QA (ceil(M / 128), nk, 128, LDS) and
// QBT (ceil(N / 128), nk, 128, LDS), nk = ceil(K / 64); lda and ldb are
// not read. c and out as int8_resident_nt. Returns a cudaError_t.
extern "C" int int8_tiled_resident_nt(const void* at, const void* bt,
                                      const void* sa, const void* sb,
                                      const void* c, void* out, int M, int N,
                                      int K, int lda, int ldb, int ldc,
                                      void* stream) {
  return htog::launch_fat<true, 128, 2, htog::FEED_TILED>(
      at, bt, sa, sb, c, out, M, N, K, lda, ldb, ldc, stream);
}
