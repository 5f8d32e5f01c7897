// The flash forward on Hopper: the body of flash_attention.cu (bf16 q,
// bf16 out) and flash_attention_fwd_lse.cu (fp32 q scaled and split in the
// kernel, fp32 out and the logsumexp rows). Both compute, for query head h
// over KV head h / rep, the reference's online softmax over key tiles of
// BK = 64 keys (see the two kernels' notes for their arithmetic).
//
// Block: 384 threads, one block per (128-query tile, head, batch), the
// tiles of the longest causal rows launched first. Thread 0 is the
// producer (the rest of warpgroup 0 leaves at once): it copies the q tile
// once, then K and V tiles of BK keys x D into a ring of ST stages
// (wgmma.cuh's full and empty barriers), all by 4-D tensor maps (D, rows,
// heads, batch) over the operands as they lie, so the (B, S, H, D) views
// of the model's layout are read without copies. Rows past S and keys past
// T arrive as the copies' zero fill; keys past T are masked by position.
// Warpgroups 1 and 2 are the consumers, 64 query rows each: per key tile
//     S = Q K^T      wgmma from shared memory, both K-major (D contiguous)
//     softmax        mask, row max and sum in registers; P = bf16(p) is
//                    the accumulator's layout, so it stays in registers
//     O += P V       wgmma with A from registers, V MN-major (keys x D)
// Overlap, the answer to the exps' cost (1.1e9 at the 7B prefill, about
// 70% of the tensor cores' bound on the SFU): the two consumers take
// turns at the tensor cores (named barriers 1 and 2), so one's softmax
// runs while the other's products do; and within a consumer, tile j's
// S = Q K^T is issued together with tile j - 1's O += P V, and tile j's
// softmax runs while that P V is still in flight.
//
// Registers bound the design: 384 threads leave a thread 168, and ptxas
// allocates no more to the consumers after setmaxnreg (measured: the same
// spills with or without it; harness/flash_variants.py). S, P and O of a
// 128-key tile at D 128 take 160 registers, so 128-key tiles (FA3's
// choice, with 240 registers) spill, or lose the overlap within a
// consumer; both measured slower than 64-key tiles with it.
//
// exp is ex2.approx with log2(e) folded into the score's scale: scores
// times scale * log2(e) (fp32), the running max m in those units,
// alpha = 2^(m - m_new), p = 2^(x - m_new), the same function as the
// reference's exp(s * scale - m) in another rounding; the logsumexp is
// m ln 2 + log(l).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "wgmma.cuh"

namespace htog {
namespace fw {

using fa::bf16;
using fa::NEG_INF;
using fa::pack_bf16;
using fa::split_pack;

constexpr int BQ = 128;             // query rows a block, 64 a consumer
constexpr int BK = 64;              // keys a tile
constexpr int THREADS = 384;        // producer warpgroup, two consumers
constexpr int SMEM_LIMIT = 232448;  // a block's dynamic shared memory
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// named barriers: BAR_TURN + c is consumer c's turn at the tensor cores,
// BAR_OWN + c consumer c's own (0 is __syncthreads')
constexpr int BAR_TURN = 1;
constexpr int BAR_OWN = 3;

struct Params {
  void* out;          // bf16 (flash_attention) or fp32 (fwd_lse)
  float* lse;         // (B, H, S) fp32, fwd_lse only
  int S, T, H, rep, causal;
  long long o_b, o_h, o_s;
  float score_scale;  // a score times this is in log2 units
  float q_scale;      // fwd_lse: q times this before the split
};

template <int ST>
struct Bars {
  wg::Ring<ST> ring;
  uint64_t q;

  __device__ void init() {
    mbar_init(&q, 1);
    ring.init();
  }
};

// Shared memory, every tile 1024-byte aligned: each consumer's q rows
// (bf16: D / 64 swizzled 64 x 64 halves; kSplit: the fp32 rows as copied,
// D / 32 plain boxes of 64 rows x 32 values, then in place the split's hi
// and lo halves), then the ring: a stage holds K, then V, each D / 64
// swizzled halves of BK rows x 64 values.
template <int D, bool kSplit>
struct Layout {
  static constexpr int HALF = 64 * wg::LINE;          // 64 rows x 128 bytes
  static constexpr int Q_WG = (kSplit ? 4 : 2) * 64 * D;
  static constexpr int LO = 2 * 64 * D;               // kSplit: lo's offset
  static constexpr int KV_HALF = BK * wg::LINE;
  static constexpr int KV = D / 64 * KV_HALF;
  static constexpr int STAGE = 2 * KV;
  static constexpr int RING = 2 * Q_WG;
  static constexpr int FIT = (SMEM_LIMIT - RING - 2 * wg::ATOM) / STAGE;
  static constexpr int ST = FIT < 4 ? FIT : 4;
  static constexpr int BARS = RING + ST * STAGE;
  static constexpr int SMEM =
      BARS + static_cast<int>(sizeof(Bars<ST>)) + wg::ATOM;
  static_assert(ST >= 2, "a ring of two stages at least");
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The producer (one thread): the q tile, then every key tile the block
// walks.
template <int D, bool kSplit>
__device__ __forceinline__ void produce(uint8_t* smem,
                                        Bars<Layout<D, kSplit>::ST>& bars,
                                        const CUtensorMap* tq,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv, int q0, int h,
                                        int g, int b, int n) {
  using L = Layout<D, kSplit>;
  constexpr int ST = L::ST;
  mbar_arrive_expect_tx(&bars.q, 2 * L::Q_WG);
  for (int c = 0; c < 2; ++c) {
    uint8_t* dst = smem + c * L::Q_WG;
    if (kSplit) {
      for (int i = 0; i < D / 32; ++i)
        wg::tma_4d(dst + i * L::HALF, tq, 32 * i, q0 + 64 * c, h, b, &bars.q);
    } else {
      for (int i = 0; i < D / 64; ++i)
        wg::tma_4d(dst + i * L::HALF, tq, 64 * i, q0 + 64 * c, h, b, &bars.q);
    }
  }
  for (int j = 0; j < n; ++j) {
    int s = j % ST;
    uint8_t* st = smem + L::RING + s * L::STAGE;
    uint64_t* full = &bars.ring.full[s];
    wg::wait_empty(bars.ring, j);
    mbar_arrive_expect_tx(full, L::STAGE);
    for (int i = 0; i < D / 64; ++i) {
      wg::tma_4d(st + i * L::KV_HALF, tk, 64 * i, j * BK, g, b, full);
      wg::tma_4d(st + L::KV + i * L::KV_HALF, tv, 64 * i, j * BK, g, b, full);
    }
  }
}

// A consumer's 64 fp32 q rows (as copied: D / 32 boxes of 64 rows x 32
// values) -> fl(q * scale) split into swizzled bf16 hi and lo tiles in the
// same bytes: every thread loads its values, the warpgroup meets, then
// stores, fences its stores for the async proxy (wgmma reads them), and
// the warpgroup meets again.
template <int D>
__device__ __forceinline__ void split_q(uint8_t* qs, float scale, int cw) {
  using L = Layout<D, true>;
  constexpr int UNITS = 64 * D / 8;   // 8 values a unit
  constexpr int PER = UNITS / 128;
  int t = threadIdx.x & 127;
  float4 x[PER][2];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    int u = t + 128 * i;
    int r = u / (D / 8);
    int col = (u % (D / 8)) * 8;
    const float4* src = reinterpret_cast<const float4*>(
        qs + (col / 32) * L::HALF + r * wg::LINE + (col % 32) * 4);
    x[i][0] = src[0];
    x[i][1] = src[1];
  }
  wg::bar_sync(BAR_OWN + cw, 128);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    int u = t + 128 * i;
    int r = u / (D / 8);
    int col = (u % (D / 8)) * 8;
    float v[8] = {x[i][0].x, x[i][0].y, x[i][0].z, x[i][0].w,
                  x[i][1].x, x[i][1].y, x[i][1].z, x[i][1].w};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_pack(__fmul_rn(v[2 * e], scale), __fmul_rn(v[2 * e + 1], scale),
                 hi[e], lo[e]);
    int off = (col / 64) * L::HALF + r * wg::LINE +
              ((((col % 64) / 8) ^ (r & 7)) << 4);
    *reinterpret_cast<uint4*>(qs + off) = make_uint4(hi[0], hi[1], hi[2],
                                                     hi[3]);
    *reinterpret_cast<uint4*>(qs + L::LO + off) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
  fence_proxy_async();
  wg::bar_sync(BAR_OWN + cw, 128);
}

// S = Q K^T over one key tile (kSplit: (Qhi + Qlo) K^T, two products into
// one sum).
template <int D, bool kSplit>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], uint32_t qa,
                                         uint32_t ka) {
  using L = Layout<D, kSplit>;
#pragma unroll
  for (int k = 0; k < D / 16; ++k) {
    uint64_t db = wg::kmajor_desc(ka + (k / 4) * L::KV_HALF, k % 4);
    uint32_t a = qa + (k / 4) * L::HALF;
    if (k == 0)
      wg::Wgmma<BK>::template ss0<0, 0>(s, wg::kmajor_desc(a, 0), db);
    else
      wg::Wgmma<BK>::template ss<0, 0>(s, wg::kmajor_desc(a, k % 4), db, 1);
    if (kSplit)
      wg::Wgmma<BK>::template ss<0, 0>(
          s, wg::kmajor_desc(a + L::LO, k % 4), db, 1);
  }
}

// O += P V over one key tile: P from registers, V MN-major.
template <int D, bool kSplit>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         uint32_t (&pa)[BK / 16][4],
                                         uint32_t va) {
  using L = Layout<D, kSplit>;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wg::Wgmma<D>::template rs<1>(o, pa[kk],
                                    wg::mnmajor_desc(va, kk, L::KV_HALF), 1);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// A consumer's running softmax over its 64 rows; this thread holds rows
// row0 and row0 + 8, the columns of wgmma's accumulator layout.
struct Softmax {
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.0f, 0.0f};   // this thread's share of each row's sum
  float alpha[2], sum[2];

  // s (the raw scores of key tile k0 ..) -> p = 2^(x - m_new) in place,
  // with alpha and the tile's fp32 sums kept for rescale(). mask: some
  // key of the tile is past T or, causal, past a row's position qpos.
  __device__ __forceinline__ void scores(float (&s)[BK / 2], float c,
                                         bool mask, int k0, int T,
                                         bool causal, const int (&qpos)[2]) {
    int lane = threadIdx.x & 31;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(s[4 * i + e], c);
        if (mask) {
          int kpos = k0 + 8 * i + 2 * (lane & 3) + (e & 1);
          if (kpos >= T || (causal && kpos > qpos[e >> 1])) x = NEG_INF;
        }
        s[4 * i + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = ex2(__fsub_rn(m[r], m_new));
      m[r] = m_new;
      sum[r] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = ex2(__fsub_rn(s[4 * i + e], m[e >> 1]));
        sum[e >> 1] = __fadd_rn(sum[e >> 1], pe);
        s[4 * i + e] = pe;
      }
    }
  }

  // l = l alpha + sum, o = o alpha, and P = bf16(p) as P V's A fragments.
  template <int D>
  __device__ __forceinline__ void rescale(float (&o)[D / 2],
                                          const float (&s)[BK / 2],
                                          uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      l[r] = __fadd_rn(__fmul_rn(l[r], alpha[r]), sum[r]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i)
      o[i] = __fmul_rn(o[i], alpha[(i >> 1) & 1]);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f)
        pa[kk][f] = pack_bf16(s[8 * kk + 2 * f], s[8 * kk + 2 * f + 1]);
  }
};

// One consumer warpgroup (cw 0 or 1: rows q0 + 64 cw ..) over the block's
// n key tiles, of which its rows see the first my_n. A turn at the tensor
// cores (named barrier BAR_TURN + cw, passed on to the other) issues tile
// j's S with tile j - 1's P V (a last turn the last P V), and tile j's
// softmax runs while that P V does: S, P and O live at once, 112 registers
// at D 128. Both consumers take n + 1 turns, whatever my_n is: a tile a
// consumer's rows do not reach is awaited and released without products.
template <int D, bool kSplit>
__device__ __forceinline__ void consume(uint8_t* smem,
                                        Bars<Layout<D, kSplit>::ST>& bars,
                                        const Params& p, int q0, int h,
                                        int b, int n) {
  using L = Layout<D, kSplit>;
  constexpr int ST = L::ST;
  int cw = (threadIdx.x >> 7) - 1;
  int lane = threadIdx.x & 31;
  int warp = (threadIdx.x >> 5) & 3;
  int off = p.T - p.S;
  int first = off + q0 + 64 * cw;          // this consumer's first position
  int my_last = p.causal ? min(first + 63, p.T - 1) : p.T - 1;
  int my_n = my_last / BK + 1;
  int row0 = q0 + 64 * cw + 16 * warp + (lane >> 2);
  int qpos[2] = {off + row0, off + row0 + 8};
  bool causal = p.causal != 0;
  auto& ring = bars.ring;
  uint8_t* qs = smem + cw * L::Q_WG;
  uint32_t qa = smem_u32(qs);
  uint32_t ring0 = smem_u32(smem + L::RING);
  auto k_at = [&](int j) { return ring0 + (j % ST) * L::STAGE; };
  auto wait_full = [&](int j) {
    wg::wait(&ring.full[j % ST], (j / ST) & 1);
  };
  auto turn = [&] { wg::bar_sync(BAR_TURN + cw, 256); };
  auto pass = [&](int t) {
    if (cw == 0 || t < n) wg::bar_arrive(BAR_TURN + (cw ^ 1), 256);
  };
  auto mask = [&](int j) {
    int k0 = j * BK;
    return k0 + BK > p.T || (causal && k0 + BK - 1 > first);
  };

  wg::wait(&bars.q, 0);
  if constexpr (kSplit) split_q<D>(qs, p.q_scale, cw);
  if (cw == 1) wg::bar_arrive(BAR_TURN, 256);   // consumer 0 goes first

  float o[D / 2], s[BK / 2];
  uint32_t pa[BK / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  Softmax sm;
  auto qk = [&](int j) {
    wg::wgmma_fence();
    issue_qk<D, kSplit>(s, qa, k_at(j));
    wg::wgmma_commit();
  };
  auto pv = [&](int j) {
    wg::fence_regs(o);
    wg::fence_regs(pa);
    wg::wgmma_fence();
    issue_pv<D, kSplit>(o, pa, k_at(j) + L::KV);
    wg::wgmma_commit();
  };
  auto pv_done = [&](int j) {
    wg::fence_regs(o);
    wg::fence_regs(pa);
    wg::release(ring, j % ST);
  };
  auto softmax = [&](int j) {
    wg::fence_regs(s);
    sm.scores(s, p.score_scale, mask(j), j * BK, p.T, causal, qpos);
  };

  wait_full(0);
  turn();
  qk(0);
  pass(0);
  wg::wgmma_wait<0>();
  softmax(0);
  sm.rescale<D>(o, s, pa);
  for (int j = 1; j < my_n; ++j) {
    wait_full(j);
    turn();
    qk(j);
    pv(j - 1);
    pass(j);
    wg::wgmma_wait<1>();
    softmax(j);
    wg::wgmma_wait<0>();
    pv_done(j - 1);
    sm.rescale<D>(o, s, pa);
  }
  turn();
  pv(my_n - 1);
  pass(my_n);
  wg::wgmma_wait<0>();
  pv_done(my_n - 1);
  // tiles past this consumer's rows
  for (int j = my_n; j < n; ++j) {
    wait_full(j);
    wg::release(ring, j % ST);
    turn();
    pass(j + 1);
  }

  // out = o / max(l, 1e-30) (and lse = m ln 2 + log(max(l, 1e-30))), rows
  // below S only
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = fmaxf(quad_sum(sm.l[r]), 1e-30f);
    int row = row0 + 8 * r;
    if (row >= p.S) continue;
    size_t base = b * p.o_b + h * p.o_h + row * p.o_s + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      float v0 = __fdiv_rn(o[4 * i + 2 * r], l);
      float v1 = __fdiv_rn(o[4 * i + 2 * r + 1], l);
      if constexpr (kSplit) {
        *reinterpret_cast<float2*>(static_cast<float*>(p.out) + base +
                                   8 * i) = make_float2(v0, v1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.out) + base +
                                           8 * i) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
    if (kSplit && (lane & 3) == 0)
      p.lse[(static_cast<size_t>(b) * p.H + h) * p.S + row] =
          __fadd_rn(__fmul_rn(sm.m[r], LN2), logf(l));
  }
}

template <int D, bool kSplit>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, Params p) {
  using L = Layout<D, kSplit>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = wg::align_1024(smem_raw);
  auto& bars = *reinterpret_cast<Bars<L::ST>*>(smem + L::BARS);
  int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest causal rows first
  int h = blockIdx.y;
  int b = blockIdx.z;
  // the last key any row of this block sees
  int last = p.causal ? min(p.T - p.S + q0 + BQ - 1, p.T - 1) : p.T - 1;
  int n = last / BK + 1;
  if (threadIdx.x == 0) bars.init();
  __syncthreads();
  if (threadIdx.x < 128) {
    if (threadIdx.x == 0)
      produce<D, kSplit>(smem, bars, &tq, &tk, &tv, q0, h, h / p.rep, b, n);
  } else {
    consume<D, kSplit>(smem, bars, p, q0, h, b, n);
  }
}

// A 4-D map (D, rows, heads, batch) over a tensor read through element
// strides (row, head, batch), boxes of box0 values x box_rows rows.
inline bool make_rows_map(CUtensorMap* map, bool fp32, const void* base,
                          int D, int rows, int heads, int batch,
                          long long s_row, long long s_head,
                          long long s_batch, int box0, int box_rows) {
  cuuint64_t es = fp32 ? 4 : 2;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                        static_cast<cuuint64_t>(rows),
                        static_cast<cuuint64_t>(heads),
                        static_cast<cuuint64_t>(batch)};
  cuuint64_t strides[3] = {s_row * es, s_head * es, s_batch * es};
  cuuint32_t box[4] = {static_cast<cuuint32_t>(box0),
                       static_cast<cuuint32_t>(box_rows), 1, 1};
  return wg::make_map(map,
                      fp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                      4, base, dims, strides, box,
                      fp32 ? CU_TENSOR_MAP_SWIZZLE_NONE
                           : CU_TENSOR_MAP_SWIZZLE_128B);
}

// Encodes the three maps and launches flash_fwd<D, kSplit>: q (B, H, S,
// D), k and v (B, KVH, T, D), each through element strides {batch, head,
// row}. Returns cudaGetLastError() after the launch, cudaErrorInvalidValue
// for a map the driver refuses.
template <int D, bool kSplit>
int launch(const void* q, const void* k, const void* v, const Params& p,
           int B, int KVH, const long long (&qs)[3],
           const long long (&ks)[3], const long long (&vs)[3],
           cudaStream_t stream) {
  using L = Layout<D, kSplit>;
  CUtensorMap tq, tk, tv;
  if (!make_rows_map(&tq, kSplit, q, D, p.S, p.H, B, qs[2], qs[1], qs[0],
                     kSplit ? 32 : 64, 64) ||
      !make_rows_map(&tk, false, k, D, p.T, KVH, B, ks[2], ks[1], ks[0], 64,
                     BK) ||
      !make_rows_map(&tv, false, v, D, p.T, KVH, B, vs[2], vs[1], vs[0], 64,
                     BK))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<D, kSplit>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.S + BQ - 1) / BQ, p.H, B);
  flash_fwd<D, kSplit><<<grid, THREADS, L::SMEM, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fw
}  // namespace htog
