// flash_attention_bwd_dq: dq of causal or non-causal GQA self-attention,
// recomputed against the forward's logsumexp rows. q, do and dq (B, H, S, D)
// fp32, k and v (B, KVH, S, D) bf16, each through its own (b, h, row) element
// strides with the D elements of a row contiguous; lse and delta =
// sum(do * out) (B, H, S) fp32, contiguous. Query head h attends KV head
// h / REP (REP = H / KVH); query i sits at position i.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_attention.py, _bwd_dq_kernel
// (via _flash_bwd and the custom VJP of flash_attention_train).
//
// Arithmetic (the reference's, in fp32, key tile by key tile of BK keys):
// s = fl(q * scale) . k; p = exp(s - lse), 0 for keys past S and, causal,
// past the query's position; dp = do . v; ds = p (dp - delta); dq += ds . k;
// the result dq * scale. The fp32 operands of the products (q times scale,
// do and ds) are each split into bf16 hi + lo (two products into one sum,
// |error| <= 2^-17 |x|, flash_common.cuh); k and v are bf16 and exact. exp
// is ex2.approx with log2(e) folded in, p = 2^(s log2(e) - lse log2(e)), as
// the forward and dK/dV fold it. Sums run in another order than the plain
// version's (ops/attention.flash_attention_bwd_dq_ref), so the two agree to
// rounding. Every output row belongs to one block: no atomics, the same bits
// every run.
//
// Bound on an H100 SXM at the soak's shape (B 8, H 32, KVH 4, D 64, S 1,024,
// causal): 5.2e10 FLOPs of the three products over 524,800 query-key pairs a
// head, 0.052 ms at the 989 TFLOP/s dense bf16 peak, against 210 MB moved (q,
// do read and dq written in fp32, k and v in bf16, lse and delta), 0.063 ms at
// 3.35 TB/s: the memory bounds it. The splits make the three products six,
// 1.04e11 FLOPs of tensor-core issue (0.105 ms at the peak): a cost of this
// kernel, not of the work, and what its time is made of.
//
// Design: the forward's (flash_wgmma.cuh) with do beside q, on a persistent
// grid. An item is a query tile of 128 rows, a head and a batch; one block
// an SM walks the items in rounds, the last query tile (the longest causal
// walk) first, a round's order reversed every other round so that the
// blocks' causal work evens out (walk_item; ops/attention.dq_walk). Thread
// 0 is the producer: per item it copies the fp32 q and do rows (at D 64
// into one of two buffers, the next item's once this one's first key tiles
// are in the ring, so that they land while this item runs; at D 128, 128
// KB an item, into one), then K and V tiles of BK keys into a ring of ST
// stages, all by 4-D tensor maps (D, rows, heads, batch) over the operands
// as they lie; rows and keys past S arrive as zeros. Warpgroups 1 and 2
// are the consumers, 64 query rows each; per item each splits its q
// (times scale) and do rows into bf16 hi and lo in place (fw::split_q),
// then per key tile
//     S = Q K^T, dP = dO V^T   wgmma from shared memory, both K-major, hi
//                              and lo into one sum each (one group)
//     dS = P (dP - delta)      in registers, masked by position only on
//                              the diagonal and S's tail tile
//     dQ += dS K               wgmma with A from registers (dS split into
//                              bf16 hi and lo fragments), K MN-major
// and stores its dq rows from registers. Overlap: the two consumers take
// turns at the tensor cores (named barriers, as the forward's), so one's
// exps and splits run beside the other's products. Registers: at 384
// threads ptxas gives a thread 168; S, dP and dQ take 96 at D 64 and 128
// at D 128, and dS's fragments replace S and dP before dS K. Issuing tile
// j's S and dP beside tile j - 1's dS K (the forward's overlap within a
// consumer) would hold all four and spills; a 256-thread block of one
// consumer with that overlap and 255 registers runs slower at both D
// (harness/flash_variants.py --group dq; PERF.md, section 6).
#include "flash_wgmma.cuh"

namespace htog {
namespace bdq {

using fa::split_pack;
using fw::ex2;
using fw::LOG2E;

constexpr int SMEM_LIMIT = 232448;

template <int ST>
struct Bars {
  wg::Ring<ST> ring;
  uint64_t rows_full[2];    // an item's q and do rows, in buffer it % BUFS
  uint64_t rows_empty[2];

  // by one thread, before the block's __syncthreads: the empty barriers
  // take every consumer warp
  __device__ void init(int consumer_warps) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], consumer_warps);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&rows_full[i], 1);
      mbar_init(&rows_empty[i], consumer_warps);
    }
    mbar_fence_init();
  }
};

// Shared memory, every tile 1024-byte aligned: BUFS buffers of an item's
// rows (each consumer's q rows, then its do rows, fp32 as copied: D / 32
// plain boxes of 64 rows x 32 values, then in place the split's bf16 hi and
// lo, fw::split_q), then the ring: a stage holds K, then V, each D / 64
// swizzled halves of BK rows x 64 values. Two buffers where they fit beside
// a ring of two stages (D 64), so that the next item's rows land during
// this one.
template <int D>
struct Cfg {
  static constexpr int NC = 2;                    // consumer warpgroups
  static constexpr int BK = 64;                   // keys a tile
  static constexpr int BQ = 64 * NC;              // query rows an item
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int HALF = 64 * wg::LINE;      // 64 rows x 128 bytes
  static constexpr int ROWS = 4 * 64 * D;         // 64 fp32 rows
  static constexpr int LO = 2 * 64 * D;           // lo's offset after the split
  static constexpr int BUF = 2 * NC * ROWS;       // an item's q and do
  static constexpr int KV_HALF = BK * wg::LINE;
  static constexpr int KV = D / 64 * KV_HALF;
  static constexpr int STAGE = 2 * KV;
  static constexpr int BUFS =
      2 * BUF + 2 * STAGE + 2 * wg::ATOM <= SMEM_LIMIT ? 2 : 1;
  static constexpr int RING = BUFS * BUF;
  static constexpr int FIT = (SMEM_LIMIT - RING - 2 * wg::ATOM) / STAGE;
  static constexpr int ST = FIT < 4 ? FIT : 4;
  static constexpr int BARS = RING + ST * STAGE;
  static constexpr int SMEM =
      BARS + static_cast<int>(sizeof(Bars<ST>)) + wg::ATOM;
  static_assert(ST >= 2, "a ring of two stages at least");
  static_assert(NC == 1 || NC == 2, "one or two consumers");
};

struct Params {
  const float* lse;
  const float* delta;
  float* dq;
  int B, S, H, rep, causal;
  long long g_b, g_h, g_s;
  float scale;
};

// Work item w: a query tile, a head and a batch; the last query tile (the
// longest causal walk) first, heads fastest, then batches
// (ops/attention.dq_walk describes the walk). n: the key tiles any of its
// rows sees.
template <int D>
struct Item {
  int q0, h, b, n;

  __device__ __forceinline__ Item(int w, const Params& p) {
    using C = Cfg<D>;
    int hb = p.H * p.B;
    int nq = (p.S + C::BQ - 1) / C::BQ;
    q0 = (nq - 1 - w / hb) * C::BQ;
    h = w % hb % p.H;
    b = w % hb / p.H;
    int last = p.causal ? min(q0 + C::BQ - 1, p.S - 1) : p.S - 1;
    n = last / C::BK + 1;
  }
};

template <int D>
__device__ __forceinline__ int items(const Params& p) {
  return (p.S + Cfg<D>::BQ - 1) / Cfg<D>::BQ * p.H * p.B;
}

// The item this block takes at its it-th turn, -1 past its walk: rounds of
// gridDim.x items, taken in block order in even rounds and in reverse in
// odd ones, so that a block given a round's longest item gets the next
// round's shortest (causal walks shorten item by item).
__device__ __forceinline__ int walk_item(int it, int total) {
  int g = gridDim.x;
  int w = it * g + (it & 1 ? g - 1 - blockIdx.x : blockIdx.x);
  return w < total ? w : -1;
}

// The producer (one thread) over the block's items: each item's q and do,
// then its key tiles. The next item's rows are copied once this item's
// first tiles are in the ring (with one buffer, after its last tile).
template <int D>
__device__ __forceinline__ void produce(uint8_t* smem,
                                        Bars<Cfg<D>::ST>& bars,
                                        const CUtensorMap* tq,
                                        const CUtensorMap* tdo,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv,
                                        const Params& p) {
  using C = Cfg<D>;
  constexpr int ST = C::ST;
  int total = items<D>(p);
  auto rows = [&](int it, int w) {
    Item<D> x(w, p);
    int buf = it % C::BUFS;
    if (it >= C::BUFS)
      wg::wait(&bars.rows_empty[buf], ((it / C::BUFS) - 1) & 1);
    uint64_t* full = &bars.rows_full[buf];
    mbar_arrive_expect_tx(full, C::BUF);
    for (int c = 0; c < C::NC; ++c) {
      uint8_t* qs = smem + buf * C::BUF + 2 * c * C::ROWS;
      for (int i = 0; i < D / 32; ++i) {
        wg::tma_4d(qs + i * C::HALF, tq, 32 * i, x.q0 + 64 * c, x.h, x.b,
                   full);
        wg::tma_4d(qs + C::ROWS + i * C::HALF, tdo, 32 * i, x.q0 + 64 * c,
                   x.h, x.b, full);
      }
    }
  };
  int r = 0;   // uses of the ring so far
  rows(0, walk_item(0, total));
  for (int it = 0, w; (w = walk_item(it, total)) >= 0; ++it) {
    Item<D> x(w, p);
    int g = x.h / p.rep;
    int next = (C::BUFS == 2 ? min(ST, x.n) : x.n) - 1;
    for (int j = 0; j < x.n; ++j, ++r) {
      int s = r % ST;
      uint8_t* st = smem + C::RING + s * C::STAGE;
      uint64_t* full = &bars.ring.full[s];
      wg::wait_empty(bars.ring, r);
      mbar_arrive_expect_tx(full, C::STAGE);
      for (int i = 0; i < D / 64; ++i) {
        wg::tma_4d(st + i * C::KV_HALF, tk, 64 * i, j * C::BK, g, x.b, full);
        wg::tma_4d(st + C::KV + i * C::KV_HALF, tv, 64 * i, j * C::BK, g,
                   x.b, full);
      }
      if (j == next && walk_item(it + 1, total) >= 0)
        rows(it + 1, walk_item(it + 1, total));
    }
  }
}

// acc = (A_hi + A_lo) B^T over one key tile: A a consumer's split rows (q
// or do), B the tile's K (or V), both K-major.
template <int D>
__device__ __forceinline__ void issue_nt(float (&acc)[Cfg<D>::BK / 2],
                                         uint32_t a, uint32_t kv) {
  using C = Cfg<D>;
#pragma unroll
  for (int k = 0; k < D / 16; ++k) {
    uint64_t db = wg::kmajor_desc(kv + (k / 4) * C::KV_HALF, k % 4);
    uint32_t ah = a + (k / 4) * C::HALF;
    if (k == 0)
      wg::Wgmma<C::BK>::template ss0<0, 0>(acc, wg::kmajor_desc(ah, 0), db);
    else
      wg::Wgmma<C::BK>::template ss<0, 0>(acc, wg::kmajor_desc(ah, k % 4),
                                          db, 1);
    wg::Wgmma<C::BK>::template ss<0, 0>(
        acc, wg::kmajor_desc(ah + C::LO, k % 4), db, 1);
  }
}

// dQ += (dS_hi + dS_lo) K over one key tile: dS from registers, K MN-major.
template <int D>
__device__ __forceinline__ void issue_dq(float (&dq)[D / 2],
                                         uint32_t (&sh)[Cfg<D>::BK / 16][4],
                                         uint32_t (&sl)[Cfg<D>::BK / 16][4],
                                         uint32_t ka) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < C::BK / 16; ++kk) {
    uint64_t db = wg::mnmajor_desc(ka, kk, C::KV_HALF);
    wg::Wgmma<D>::template rs<1>(dq, sh[kk], db, 1);
    wg::Wgmma<D>::template rs<1>(dq, sl[kk], db, 1);
  }
}

// One consumer warpgroup (cw: rows q0 + 64 cw .. of each item) over the
// block's items, of whose n key tiles its rows see the first my_n. With two
// consumers each turn at the tensor cores (named barrier BAR_TURN + cw,
// passed on to the other) issues a tile's S and dP, and both consumers
// take n + 1 turns an item, whatever my_n is: a tile a consumer's rows do
// not reach is awaited and released without products. A consumer issues
// its dS K once its dS is formed, and that product completes before the
// consumer's next tile: the other consumer's products fill the tensor
// cores meanwhile, and only S and dP, or dS's fragments, live beside dQ.
template <int D>
__device__ __forceinline__ void consume(uint8_t* smem,
                                        Bars<Cfg<D>::ST>& bars,
                                        const Params& p) {
  using C = Cfg<D>;
  constexpr int ST = C::ST;
  constexpr int BK = C::BK;
  int cw = (threadIdx.x >> 7) - 1;
  int lane = threadIdx.x & 31;
  int warp = (threadIdx.x >> 5) & 3;
  bool causal = p.causal != 0;
  auto& ring = bars.ring;
  uint32_t ring0 = smem_u32(smem + C::RING);
  int total = items<D>(p);
  int r0 = 0;   // uses of the ring before this item
  auto k_at = [&](int j) { return ring0 + ((r0 + j) % ST) * C::STAGE; };
  auto wait_full = [&](int j) {
    wg::wait(&ring.full[(r0 + j) % ST], ((r0 + j) / ST) & 1);
  };
  auto release = [&](int j) { wg::release(ring, (r0 + j) % ST); };
  auto turn = [&] {
    if constexpr (C::NC == 2) wg::bar_sync(fw::BAR_TURN + cw, 256);
  };

  for (int it = 0, w; (w = walk_item(it, total)) >= 0; ++it) {
    Item<D> x(w, p);
    int n = x.n;
    int first = x.q0 + 64 * cw;              // this consumer's first row
    int my_last = causal ? min(first + 63, p.S - 1) : p.S - 1;
    int my_n = my_last / BK + 1;
    int row0 = first + 16 * warp + (lane >> 2);   // this thread's: +0, +8
    int qpos[2] = {row0, row0 + 8};
    // lse (times log2(e)) and delta of this thread's rows; 0 past S, where
    // q and do are zeros: p = 1, dp = 0, ds = 0
    float lse2[2], delta[2];
    size_t rows = (static_cast<size_t>(x.b) * p.H + x.h) * p.S;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      bool in = qpos[r] < p.S;
      lse2[r] = in ? __fmul_rn(p.lse[rows + qpos[r]], LOG2E) : 0.0f;
      delta[r] = in ? p.delta[rows + qpos[r]] : 0.0f;
    }
    int buf = it % C::BUFS;
    uint8_t* qs = smem + buf * C::BUF + 2 * cw * C::ROWS;
    uint8_t* dos = qs + C::ROWS;
    uint32_t qa = smem_u32(qs), da = smem_u32(dos);
    auto pass = [&](int t) {
      if constexpr (C::NC == 2)
        if (cw == 0 || t < n) wg::bar_arrive(fw::BAR_TURN + (cw ^ 1), 256);
    };
    auto mask = [&](int j) {
      int k0 = j * BK;
      return k0 + BK > p.S || (causal && k0 + BK - 1 > first);
    };

    wg::wait(&bars.rows_full[buf], (it / C::BUFS) & 1);
    fw::split_q<D>(qs, p.scale, cw);
    fw::split_q<D>(dos, 1.0f, cw);
    if (C::NC == 2 && cw == 1)
      wg::bar_arrive(fw::BAR_TURN, 256);   // consumer 0 goes first

    float dq[D / 2], s[BK / 2], dp[BK / 2];
    uint32_t sh[BK / 16][4], sl[BK / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.0f;
    auto products = [&](int j) {
      wg::wgmma_fence();
      issue_nt<D>(s, qa, k_at(j));
      issue_nt<D>(dp, da, k_at(j) + C::KV);
      wg::wgmma_commit();
    };
    auto dq_product = [&](int j) {
      wg::fence_regs(dq);
      wg::fence_regs(sh);
      wg::fence_regs(sl);
      wg::wgmma_fence();
      issue_dq<D>(dq, sh, sl, k_at(j));
      wg::wgmma_commit();
    };
    auto dq_done = [&](int j) {
      wg::fence_regs(dq);
      wg::fence_regs(sh);
      wg::fence_regs(sl);
      release(j);
    };
    // dS = P (dP - delta) into s, P = 2^(S log2(e) - lse log2(e)), 0 where
    // masked (accumulators 4 i + e: row qpos[e / 2], key k0 + 8 i +
    // 2 (lane % 4) + e % 2)
    auto scores = [&](int j) {
      wg::fence_regs(s);
      wg::fence_regs(dp);
      bool m = mask(j);
      int k0 = j * BK;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pe = ex2(__fmaf_rn(s[4 * i + e], LOG2E, -lse2[e >> 1]));
          if (m) {
            int kpos = k0 + 8 * i + 2 * (lane & 3) + (e & 1);
            if (kpos >= p.S || (causal && kpos > qpos[e >> 1])) pe = 0.0f;
          }
          s[4 * i + e] =
              __fmul_rn(pe, __fsub_rn(dp[4 * i + e], delta[e >> 1]));
        }
      }
    };
    // dS as dS K's A fragments, split into bf16 hi and lo (the
    // accumulator's columns 16 kk .. are fragment kk as they stand)
    auto pack = [&] {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f)
          split_pack(s[8 * kk + 2 * f], s[8 * kk + 2 * f + 1], sh[kk][f],
                     sl[kk][f]);
    };

    for (int j = 0; j < my_n; ++j) {
      wait_full(j);
      turn();
      products(j);
      pass(j);
      wg::wgmma_wait<0>();
      scores(j);
      pack();
      dq_product(j);
      wg::wgmma_wait<0>();
      dq_done(j);
    }
    turn();
    pass(my_n);
    // tiles past this consumer's rows
    for (int j = my_n; j < n; ++j) {
      wait_full(j);
      release(j);
      turn();
      pass(j + 1);
    }
    // this item's rows go back to the producer (its products are done)
    __syncwarp();
    if (lane == 0) mbar_arrive(&bars.rows_empty[buf]);
    r0 += n;

    // dq * scale, rows below S (wgmma's accumulator layout: columns
    // 8 i + 2 (lane % 4), + 1, rows row0 and row0 + 8)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      int row = qpos[r];
      if (row >= p.S) continue;
      float* grow = p.dq + x.b * p.g_b + x.h * p.g_h + row * p.g_s +
                    2 * (lane & 3);
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<float2*>(grow + 8 * i) =
            make_float2(__fmul_rn(dq[4 * i + 2 * r], p.scale),
                        __fmul_rn(dq[4 * i + 2 * r + 1], p.scale));
    }
  }
}

// A persistent grid walking the items in rounds (walk_item).
template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
    bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, Params p) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = wg::align_1024(smem_raw);
  auto& bars = *reinterpret_cast<Bars<C::ST>*>(smem + C::BARS);
  if (threadIdx.x == 0) bars.init(4 * C::NC);
  __syncthreads();
  if (threadIdx.x < 128) {
    if (threadIdx.x == 0) produce<D>(smem, bars, &tq, &tdo, &tk, &tv, p);
  } else {
    consume<D>(smem, bars, p);
  }
}

// Encodes the four maps and launches bwd_dq_wgmma<D>, one block an SM (or
// an item): q and do (B, H, S, D) fp32 in boxes of 32 values x 64 rows, k
// and v (B, KVH, S, D) bf16 in boxes of 64 values x BK rows, each through
// element strides {batch, head, row}.
template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const Params& p, int KVH, const long long (&qs)[3],
           const long long (&ks)[3], const long long (&vs)[3],
           const long long (&ds)[3], cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tq, tdo, tk, tv;
  if (!fw::make_rows_map(&tq, true, q, D, p.S, p.H, p.B, qs[2], qs[1],
                         qs[0], 32, 64) ||
      !fw::make_rows_map(&tdo, true, dout, D, p.S, p.H, p.B, ds[2], ds[1],
                         ds[0], 32, 64) ||
      !fw::make_rows_map(&tk, false, k, D, p.S, KVH, p.B, ks[2], ks[1],
                         ks[0], 64, C::BK) ||
      !fw::make_rows_map(&tv, false, v, D, p.S, KVH, p.B, vs[2], vs[1],
                         vs[0], 64, C::BK))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_dq_wgmma<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long work = static_cast<long long>(p.S + C::BQ - 1) / C::BQ * p.H *
                   p.B;
  int grid = work < sms ? static_cast<int>(work) : sms;
  bwd_dq_wgmma<D><<<grid, C::THREADS, C::SMEM, stream>>>(tq, tdo, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bdq
}  // namespace htog

// q, do, dq: fp32; k, v: bf16; rows of D contiguous elements, each 16-byte
// aligned; *_b, *_h, *_s: element strides of batch, head and row (the wrapper
// checks; multiples of 16 bytes for q, do, k and v). lse, delta: (B, H, S)
// fp32, contiguous. D in {64, 128}, H a multiple of KVH, B, H, S >= 1.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unknown D or a tensor map the CUDA driver refuses).
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int B, int H, int KVH, int S,
                                      int D, int causal, int q_b, int q_h,
                                      int q_s, int k_b, int k_h, int k_s,
                                      int v_b, int v_h, int v_s, int d_b,
                                      int d_h, int d_s, int g_b, int g_h,
                                      int g_s, float scale, void* stream) {
  using namespace htog::bdq;
  Params p{static_cast<const float*>(lse), static_cast<const float*>(delta),
           static_cast<float*>(dq), B, S, H, H / KVH, causal, g_b, g_h, g_s,
           scale};
  const long long qs[3] = {q_b, q_h, q_s};
  const long long ks[3] = {k_b, k_h, k_s};
  const long long vs[3] = {v_b, v_h, v_s};
  const long long ds[3] = {d_b, d_h, d_s};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(q, k, v, dout, p, KVH, qs, ks, vs, ds, st);
    case 128: return launch<128>(q, k, v, dout, p, KVH, qs, ks, vs, ds, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
