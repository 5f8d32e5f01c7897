// The hand-pipeline record's rungs on shared-memory rings (int8_dma_nn.cu,
// int8_fat.cu): rings tracked per slot by mbarriers, bulk copies, L2 cache
// policies (also gemm_wgmma.cuh's, rungs 12 and 13's, and int8_pretile's),
// and the persistent fat-tile kernel of rung 09, the one rung left on it.
// (Rungs 10, 11, 12, 13 and 17 run on gemm_wgmma.cuh's int8 body.)
//
// Every thread of a block is a producer and a consumer; there is no warp
// specialisation. A ring slot has two mbarriers:
//   full[s]:  completes when chunk q's bytes have landed in slot s = q % S.
//             Arrivals: each thread's cp.async.mbarrier.arrive.noinc (fires
//             when that thread's cp.async copies are done) and each
//             thread's arrive after storing B bytes it staged through
//             registers (rungs 08 and 09).
//   empty[s]: completes when every warp has finished its MMAs on slot s;
//             a producer waits on it before writing the slot again.
// The q-th use of a slot is phase q / S of its barriers, so a wait names
// the parity (q / S) & 1. A wait on the wrong parity passes a phase early:
// every wait below derives its parity from the chunk counter q alone.
#pragma once

#include "int8_mma.cuh"

namespace htog {

constexpr int WARPS = THREADS / 32;
constexpr int RING_SLOTS = 2;  // the reference's two DMA slots per operand

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the barrier inits visible to the cluster (and to the async proxy)
// before any thread or bulk copy uses them.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// One arrival that also adds `bytes` to the phase's pending transactions.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// An arrival, counted in the barrier's init, that fires once every
// cp.async this thread has issued so far has landed.
__device__ __forceinline__ void cp_async_arrive_noinc(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(addr), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t addr = smem_u32(bar);
  while (!mbar_try_wait(addr, parity)) {
  }
}

// 1-D bulk copy global -> this block's shared memory; `bytes` (a multiple
// of 16, both addresses 16-byte aligned) are paid off on `bar`.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 1-D bulk copy shared -> global, tracked by this thread's bulk groups.
__device__ __forceinline__ void bulk_s2g(void* dst, const void* src,
                                         uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::
                   "l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's bulk groups still read their
// shared-memory source.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Orders this thread's shared-memory writes before later bulk copies
// (the async proxy) read them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// L2 cache policies (createpolicy, all of a copy's lines): evict_last lines
// leave the L2 after every evict_normal and evict_first line, evict_first
// lines before them.
__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// bulk_g2s under an L2 policy.
__device__ __forceinline__ void bulk_g2s_l2(void* dst, const void* src,
                                            uint32_t bytes, uint64_t* bar,
                                            uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes."
      "L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

// Prefetch [src, src + bytes) into the L2 under `policy` (bytes a multiple
// of 16, src 16-byte aligned): 16 KB pieces, piece i taken by block
// i % gridDim.x, so every block issues its share.
__device__ __forceinline__ void l2_prefetch_grid(const void* src, size_t bytes,
                                                 uint64_t policy) {
  constexpr size_t PIECE = 16384;
  const size_t pieces = (bytes + PIECE - 1) / PIECE;
  const size_t step = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = blockIdx.x + static_cast<size_t>(gridDim.x) * threadIdx.x;
       i < pieces; i += step) {
    size_t off = i * PIECE;
    uint32_t n = static_cast<uint32_t>(bytes - off < PIECE ? bytes - off
                                                           : PIECE);
    asm volatile(
        "cp.async.bulk.prefetch.L2.global.L2::cache_hint [%0], %1, %2;\n" ::
            "l"(static_cast<const char*>(src) + off),
        "r"(n), "l"(policy)
        : "memory");
  }
}

// Set the L2 lines of [src, src + bytes) back to evict_normal, the grid's
// blocks taking lines in turn (line i: block i % gridDim.x, its thread tid
// of `threads` taking part): an evict_last line left behind would keep its
// place against the next kernel's data.
__device__ __forceinline__ void l2_evict_normal_grid(const void* src,
                                                     size_t bytes, int tid,
                                                     int threads) {
  const uintptr_t lo = reinterpret_cast<uintptr_t>(src) & ~uintptr_t(127);
  const uintptr_t hi = reinterpret_cast<uintptr_t>(src) + bytes;
  const size_t lines = (hi - lo + 127) / 128;
  const size_t step = static_cast<size_t>(gridDim.x) * threads;
  for (size_t i = blockIdx.x + static_cast<size_t>(gridDim.x) * tid;
       i < lines; i += step)
    asm volatile("applypriority.global.L2::evict_normal [%0], 128;\n" ::"l"(
                     lo + i * 128)
                 : "memory");
}

// mma_stage's fragment walk for a warp tile of 64 x (NI x 8): one 64-byte
// K chunk from a K-major A slot and a K-major B slot (NI = 4 is exactly
// mma_stage<MmaS8>; NI = 8 serves the 128 x 256 fat tile, whose warps own
// 64 x 64).
template <int NI>
__device__ __forceinline__ void mma_chunk(int (&acc)[4][NI][4],
                                          const int8_t (*as)[LDS],
                                          const int8_t (*bs)[LDS], int wm,
                                          int wn, int lane) {
  int g = lane >> 2;
  int t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 32) {
    uint32_t a[4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      int r = wm * 64 + mi * 16 + g;
      a[mi][0] = lds32(&as[r][kk + t * 4]);
      a[mi][1] = lds32(&as[r + 8][kk + t * 4]);
      a[mi][2] = lds32(&as[r][kk + 16 + t * 4]);
      a[mi][3] = lds32(&as[r + 8][kk + 16 + t * 4]);
    }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      int n = wn * NI * 8 + ni * 8 + g;
      uint32_t b[2] = {lds32(&bs[n][kk + t * 4]),
                       lds32(&bs[n][kk + 16 + t * 4])};
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) mma_s8(acc[mi][ni], a[mi], b);
    }
  }
}


// The fat-tile kernel's shared memory at a BM x BN tile: a ring of
// RING_SLOTS (A, B) chunk slots, one C/out buffer of BM x BN fp32 (row
// pitch padded by 32 bytes against bank conflicts, 16-byte aligned for the
// bulk copies), then the barriers.
template <int BN>
struct FatLayout {
  static constexpr int CPITCH = BN * 4 + 32;   // bytes a C/out buffer row
  static constexpr int A_BYTES = BM * LDS;
  static constexpr int B_BYTES = BN * LDS;
  static constexpr int C_BYTES = BM * CPITCH;
  static constexpr int RING = RING_SLOTS * (A_BYTES + B_BYTES);
  static constexpr int BARS = RING + C_BYTES;
  static constexpr int SMEM = BARS + 8 * (2 * RING_SLOTS + 1);
};

struct FatArgs {
  const int8_t* a;   // (M, K) int8, row pitch lda
  const int8_t* b;   // B (K, N), row pitch ldb
  const float* sa;   // (M,)
  const float* sb;   // (N,)
  const float* c;    // (M, ldc)
  float* out;        // (M, ldc), fresh
  int M, N, K, lda, ldb, ldc;
  int ntm, ntn;      // C tiles along M and N
};

// out[i,j] = (float(acc) * sa[i]) * sb[j] + c[i,j], computed in place in a
// C/out buffer that holds the tile's C (masked to M x N).
template <int NI>
__device__ __forceinline__ void staged_epilogue(const int (&acc)[4][NI][4],
                                                float* buf, int pitch,
                                                const FatArgs& p, int m0,
                                                int n0, int wm, int wn,
                                                int lane) {
  int g = lane >> 2;
  int t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int r = wm * 64 + mi * 16 + g + h * 8;
      if (m0 + r >= p.M) continue;
      float s_row = p.sa[m0 + r];
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          int cc = wn * NI * 8 + ni * 8 + t * 2 + e;
          if (n0 + cc >= p.N) continue;
          float* x = buf + r * pitch + cc;
          float v = __fmul_rn(
              __fmul_rn(__int2float_rn(acc[mi][ni][h * 2 + e]), s_row),
              p.sb[n0 + cc]);
          *x = __fadd_rn(v, *x);
        }
      }
    }
  }
}

// The persistent fat-tile kernel (rung 09, BNT 256). Each block walks the
// BM x BNT tiles blockIdx.x, blockIdx.x + gridDim.x, ... in row-major
// order. The K chunks of all the block's tiles form one stream
// q = 0, 1, ...: chunk q + 1 is issued before chunk q is waited on, also
// across a tile boundary, so the next tile's first chunks load while this
// tile's epilogue runs. A comes by cp.async; B (K, N) is transposed through
// registers (int8_gemm_nn's way). A tile's C is fetched into the one
// C/out buffer with bulk copies at the tile's start and awaited at its
// flush; the flush computes the epilogue in place and stores the buffer
// with bulk copies, which drain while the next tile's chunks are
// multiplied; the next tile's C fetch waits until that store has read the
// buffer.
template <int BNT>
__global__ void __launch_bounds__(THREADS, 1)
    int8_fat_kernel(const FatArgs p) {
  using L = FatLayout<BNT>;
  constexpr int NI = BNT / 32;   // 8-column fragments a warp, 4 warps on N
  constexpr int NH = BNT / 128;  // 128-row halves of a B slot
  constexpr int PITCH = L::CPITCH / 4;
  extern __shared__ __align__(128) uint8_t smem[];
  auto a_slot = [&](int s) {
    return reinterpret_cast<int8_t(*)[LDS]>(smem + s * L::A_BYTES);
  };
  auto b_slot = [&](int s) {
    return reinterpret_cast<int8_t(*)[LDS]>(smem + RING_SLOTS * L::A_BYTES +
                                            s * L::B_BYTES);
  };
  float* cb = reinterpret_cast<float*>(smem + L::RING);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + RING_SLOTS;
  uint64_t* cbar = empty + RING_SLOTS;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp >> 2;
  const int wn = warp & 3;
  if (threadIdx.x == 0) {
    for (int s = 0; s < RING_SLOTS; ++s) {
      mbar_init(&full[s], 2 * THREADS);
      mbar_init(&empty[s], WARPS);
    }
    mbar_init(cbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int units = p.ntm * p.ntn;
  const int unit0 = blockIdx.x;
  const int stride = gridDim.x;
  const int jobs = unit0 < units ? (units - 1 - unit0) / stride + 1 : 0;
  const int nk = (p.K + BK - 1) / BK;
  const int total = jobs * nk;
  auto tile_of = [&](int j, int& m0, int& n0) {
    int u = unit0 + j * stride;
    m0 = (u / p.ntn) * BM;
    n0 = (u % p.ntn) * BNT;
  };

  uint32_t breg[NH][2][4];  // the next B chunk on its way to its slot
  auto issue = [&](int q) {
    int s = q % RING_SLOTS;
    int use = q / RING_SLOTS;
    if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
    int m0, n0;
    tile_of(q / nk, m0, n0);
    int k0 = (q % nk) * BK;
    load_kmajor_async(a_slot(s), p.a, m0, p.M, k0, p.K, p.lda);
#pragma unroll
    for (int h = 0; h < NH; ++h)
      load_nmajor_regs(breg[h], RowMajorInt8{p.b, p.K, p.ldb}, k0,
                       n0 + 128 * h);
    cp_async_arrive_noinc(&full[s]);
  };
  auto store_b = [&](int q) {  // chunk q's B registers into its slot
    int s = q % RING_SLOTS;
#pragma unroll
    for (int h = 0; h < NH; ++h) store_nmajor_regs(b_slot(s) + 128 * h, breg[h]);
    mbar_arrive(&full[s]);
  };

  int acc[4][NI][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  if (total > 0) {
    issue(0);
    store_b(0);
  }
  for (int q = 0; q < total; ++q) {
    const int j = q / nk;
    const int kt = q - j * nk;
    int m0, n0;
    tile_of(j, m0, n0);
    const int rows = min(BM, p.M - m0);
    const int cols = n0 < p.N ? min(BNT, p.ldc - n0) : 0;
    const uint32_t cbytes = static_cast<uint32_t>(cols) * 4;
    if (kt == 0 && warp == 0) {
      // C's fetch at the tile's start, once the last store has read the
      // buffer. Lane l stores and fetches rows l, l + 32, ...; its bulk
      // groups are its own rows' stores.
      bulk_wait_read<0>();
      if (lane == 0) mbar_arrive_expect_tx(cbar, rows * cbytes);
      __syncwarp();
      if (cols > 0)
        for (int r = lane; r < rows; r += 32)
          bulk_g2s(cb + r * PITCH,
                   p.c + static_cast<size_t>(m0 + r) * p.ldc + n0, cbytes,
                   cbar);
    }
    if (q + 1 < total) issue(q + 1);
    const int s = q % RING_SLOTS;
    mbar_wait(&full[s], (q / RING_SLOTS) & 1);
    mma_chunk<NI>(acc, a_slot(s), b_slot(s), wm, wn, lane);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (q + 1 < total) store_b(q + 1);
    if (kt == nk - 1) {
      // the flush: C has landed, epilogue in place, bulk store
      mbar_wait(cbar, j & 1);
      staged_epilogue<NI>(acc, cb, PITCH, p, m0, n0, wm, wn, lane);
      fence_proxy_async();
      __syncthreads();
      if (warp == 0) {
        if (cols > 0)
          for (int r = lane; r < rows; r += 32)
            bulk_s2g(p.out + static_cast<size_t>(m0 + r) * p.ldc + n0,
                     cb + r * PITCH, cbytes);
        bulk_commit();
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
    }
  }
  if (warp == 0) bulk_wait_all();
}

// Launch the fat-tile kernel at BM x BNT tiles: as many blocks as the card
// holds at once (one an SM), at most one a tile. Returns a cudaError_t as
// an int.
template <int BNT>
int launch_fat(const void* qa, const void* b, const void* sa, const void* sb,
               const void* c, void* out, int M, int N, int K, int lda,
               int ldb, int ldc, void* stream) {
  using L = FatLayout<BNT>;
  static_assert(L::SMEM <= 232448, "a block's shared memory is 227 KB");
  auto kernel = int8_fat_kernel<BNT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  FatArgs p{static_cast<const int8_t*>(qa), static_cast<const int8_t*>(b),
            static_cast<const float*>(sa),  static_cast<const float*>(sb),
            static_cast<const float*>(c),   static_cast<float*>(out),
            M, N, K, lda, ldb, ldc, (M + BM - 1) / BM, (N + BNT - 1) / BNT};
  int units = p.ntm * p.ntn;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int grid = units < sms ? units : sms;
  if (grid < 1) return 0;  // no work
  kernel<<<grid, THREADS, L::SMEM, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace htog
