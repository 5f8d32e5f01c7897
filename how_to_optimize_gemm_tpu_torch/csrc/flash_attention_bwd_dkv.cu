// flash_attention_bwd_dkv: dk and dv of causal or non-causal GQA
// self-attention, recomputed against the forward's logsumexp rows. q and do
// (B, H, S, D) bf16 (the wrapper rounds them, as the reference does before
// its kernel), k and v (B, KVH, S, D) bf16, dk and dv (B, KVH, S, D) fp32,
// each through its own (b, h, row) element strides with the D elements of a
// row contiguous; lse and delta = sum(do * out) (B, H, S) fp32, contiguous.
// KV head g serves query heads g * REP .. g * REP + REP - 1 (REP = H / KVH);
// query i sits at position i.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_attention.py, _bwd_dkv_kernel
// (via _flash_bwd and the custom VJP of flash_attention_train).
//
// Arithmetic (the reference's, in fp32, query tile by query tile and, inside
// each, query head by query head of the group): s = q . k times scale,
// masked past S and, for causal, where the key is past the query;
// p = exp(s - lse); dv += p^T . do; dp = do . v; ds = p (dp - delta);
// dk += ds^T . q, and at the end dk times scale (the reference scales q
// first: the same to rounding). exp is ex2.approx with log2(e) folded in:
// p = 2^(s * scale * log2(e) - lse * log2(e)). p and ds are fp32 and each
// split into bf16 hi + lo for their products (two MMAs, |error| <= 2^-17
// |x|, flash_common.cuh); q, do, k and v are bf16 and exact. Sums run in
// another order than the plain version's
// (ops/attention.flash_attention_bwd_dkv_ref), so the two agree to
// rounding. Every output row belongs to one block, which sums its group's
// query heads itself in a fixed order: no atomics, the same bits every run.
//
// Bound on an H100 SXM at the soak's shape (B 8, H 32, KVH 4, D 64, S 1,024,
// causal): 6.9e10 FLOPs of the four products over 524,800 query-key pairs a
// head, 0.070 ms at the 989 TFLOP/s dense bf16 peak, against 128 MB moved
// (q and do in bf16 read once, k and v read and dk and dv written in fp32,
// lse and delta), 0.038 ms at 3.35 TB/s: the tensor cores bound it. The
// splits of p and ds make the four products six, a cost of this kernel, not
// of the work.
//
// Design (wgmma.cuh's building blocks, flash_wgmma.cuh's vocabulary): one
// block of 128 (NC + 1) threads per (64 NC keys, KV head, batch), the
// key tiles with the longest causal walks launched first. Warp 0 is the
// producer: its lane 0 copies the block's K and V rows once, then per step
// the q and do tiles of QT queries of one query head, all by 4-D tensor maps
// (D, rows, heads, batch) over the operands as they lie (rows past S arrive
// as zeros), into a ring of ST stages; its 32 lanes copy the step's lse
// rows (times log2(e)) and delta rows beside them, and every lane arrives on
// the stage's full barrier. The walk goes query tile by query tile from the
// diagonal on (all of them when not causal) and, inside each, over the REP
// query heads of the group. Warpgroups 1 .. NC are the consumers, 64 keys
// each; per step a consumer
//     S^T = K q^T, dP^T = V do^T   wgmma from shared memory, all K-major
//     P^T, dS^T                    in registers (masked by position where
//                                  a key or query is past S or, causal,
//                                  a key past a query)
//     dV += P^T do, dK += dS^T q   wgmma with A from registers (the
//                                  accumulators' layout: P^T and dS^T split
//                                  into bf16 hi and lo), do and q MN-major
// and skips the products of a step whose queries all precede its keys. The
// consumers of a block read the same stages; a slot goes back to the
// producer once every consumer warp has released it. Registers set NC: at
// D = 64 two consumers (384 threads, 168 registers a thread: dk, dv, S^T
// and dP^T of 64 queries take 128); at D = 128 one (256 threads, 240
// registers: dk and dv alone take 128), measured faster than two
// consumers on 32-query steps, which spill (harness/flash_variants.py
// --group dkv builds the options).
#include "flash_common.cuh"
#include "wgmma.cuh"

namespace htog {
namespace dkv {

using fa::split_pack;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int SMEM_LIMIT = 232448;

template <int D>
struct Cfg {
  static constexpr int NC = D == 64 ? 2 : 1;      // consumer warpgroups
  static constexpr int QT = 64;                   // queries a step
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int BKV = 64 * NC;             // keys a block
  static constexpr int HALVES = D / 64;           // 64-value column halves
  static constexpr int SUB = 64 * wg::LINE;       // 64 rows x 64 values
  static constexpr int KV = NC * HALVES * SUB;    // the block's K (or V)
  static constexpr int Q_HALF = QT * wg::LINE;
  static constexpr int Q = HALVES * Q_HALF;       // a step's q (or do)
  static constexpr int ROWS = 2 * Q;              // lse, then delta
  static constexpr int STAGE =
      (ROWS + 2 * QT * 4 + wg::ATOM - 1) / wg::ATOM * wg::ATOM;
  static constexpr int RING = 2 * KV;
  static constexpr int FIT = (SMEM_LIMIT - RING - 2 * wg::ATOM) / STAGE;
  static constexpr int ST = FIT < 4 ? FIT : 4;
  static constexpr int BARS = RING + ST * STAGE;
  static_assert(ST >= 2, "a ring of two stages at least");
};

template <int ST>
struct Bars {
  uint64_t full[ST];
  uint64_t empty[ST];
  uint64_t kv;

  // by one thread, before the block's __syncthreads: full takes the
  // producer's 32 lanes and lane 0's expect_tx, empty every consumer warp
  __device__ void init(int consumer_warps) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 33);
      mbar_init(&empty[s], consumer_warps);
    }
    mbar_init(&kv, 1);
    mbar_fence_init();
  }
};

template <int D>
constexpr int smem_bytes() {
  return Cfg<D>::BARS + static_cast<int>(sizeof(Bars<Cfg<D>::ST>)) +
         wg::ATOM;
}

struct Params {
  const float* lse;
  const float* delta;
  float* dk;
  float* dv;
  int S, H, rep, causal;
  long long dk_b, dk_h, dk_s, dv_b, dv_h, dv_s;
  float scale;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two fp32 values from shared memory where the code asks for them (a
// volatile load: the compiler keeps the step's rows out of registers
// until they are used).
__device__ __forceinline__ float2 ld_pair(const float* p) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(smem_u32(p)));
  return v;
}

// A bf16 pair (the lower half first) as two fp32 values, exactly.
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xFFFF0000u));
}

// The producer warp: K and V once, then every step's q, do, lse and delta.
template <int D>
__device__ __forceinline__ void produce(uint8_t* smem, Bars<Cfg<D>::ST>& bars,
                                        const CUtensorMap* tq,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv,
                                        const CUtensorMap* tdo,
                                        const Params& p, int k0, int g, int b,
                                        int qt_first, int n_it) {
  using C = Cfg<D>;
  constexpr int ST = C::ST;
  int lane = threadIdx.x & 31;
  if (lane == 0) {
    mbar_arrive_expect_tx(&bars.kv, 2 * C::KV);
    for (int c = 0; c < C::NC; ++c)
      for (int i = 0; i < C::HALVES; ++i) {
        int off = (c * C::HALVES + i) * C::SUB;
        wg::tma_4d(smem + off, tk, 64 * i, k0 + 64 * c, g, b, &bars.kv);
        wg::tma_4d(smem + C::KV + off, tv, 64 * i, k0 + 64 * c, g, b,
                   &bars.kv);
      }
  }
  for (int it = 0; it < n_it; ++it) {
    int s = it % ST;
    int q0 = (qt_first + it / p.rep) * C::QT;
    int h = g * p.rep + it % p.rep;
    uint8_t* st = smem + C::RING + s * C::STAGE;
    if (it >= ST) wg::wait(&bars.empty[s], ((it / ST) - 1) & 1);
    if (lane == 0) {
      mbar_arrive_expect_tx(&bars.full[s], 2 * C::Q);
      for (int i = 0; i < C::HALVES; ++i) {
        wg::tma_4d(st + i * C::Q_HALF, tq, 64 * i, q0, h, b, &bars.full[s]);
        wg::tma_4d(st + C::Q + i * C::Q_HALF, tdo, 64 * i, q0, h, b,
                   &bars.full[s]);
      }
    }
    float* rows = reinterpret_cast<float*>(st + C::ROWS);
    size_t base = (static_cast<size_t>(b) * p.H + h) * p.S;
    for (int r = lane; r < C::QT; r += 32) {
      int row = q0 + r;
      bool in = row < p.S;
      rows[r] = in ? __fmul_rn(p.lse[base + row], LOG2E) : 0.0f;
      rows[C::QT + r] = in ? p.delta[base + row] : 0.0f;
    }
    mbar_arrive(&bars.full[s]);
  }
}

// One consumer warpgroup (cw: keys k0 + 64 cw ..) over the block's steps.
template <int D>
__device__ __forceinline__ void consume(uint8_t* smem, Bars<Cfg<D>::ST>& bars,
                                        const Params& p, int k0, int g, int b,
                                        int qt_first, int n_it) {
  using C = Cfg<D>;
  constexpr int ST = C::ST;
  constexpr int QT = C::QT;
  int cw = (threadIdx.x >> 7) - 1;
  int warp = (threadIdx.x >> 5) & 3;
  int lane = threadIdx.x & 31;
  int kc = k0 + 64 * cw;                       // this consumer's first key
  int key0 = kc + 16 * warp + (lane >> 2);     // this thread's keys: +0, +8
  bool causal = p.causal != 0;
  uint32_t ka = smem_u32(smem) + cw * C::HALVES * C::SUB;
  uint32_t va = ka + C::KV;
  uint32_t ring0 = smem_u32(smem + C::RING);
  float c2 = __fmul_rn(p.scale, LOG2E);

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.0f;
  wg::wait(&bars.kv, 0);

  for (int it = 0; it < n_it; ++it) {
    int s = it % ST;
    int q0 = (qt_first + it / p.rep) * QT;
    uint32_t qs = ring0 + s * C::STAGE;
    uint32_t dos = qs + C::Q;
    // the addresses opaque to the compiler, so that it derives each
    // descriptor where it is used instead of keeping them all across steps
    uint32_t kb = ka, vb = va;
    asm volatile("" : "+r"(kb), "+r"(vb), "+r"(qs), "+r"(dos));
    const float* rows =
        reinterpret_cast<const float*>(smem + C::RING + s * C::STAGE + C::ROWS);
    wg::wait(&bars.full[s], (it / ST) & 1);
    bool live = kc < p.S && (!causal || q0 + QT - 1 >= kc);
    if (live) {
      // S^T = K q^T and dP^T = V do^T (64 keys x QT queries each), two
      // groups: P^T's exps run while dP^T's products do
      float st[QT / 2], dpt[QT / 2];
      wg::wgmma_fence();
#pragma unroll
      for (int k = 0; k < D / 16; ++k) {
        uint64_t dq = wg::kmajor_desc(qs + (k / 4) * C::Q_HALF, k % 4);
        uint64_t dk_ = wg::kmajor_desc(kb + (k / 4) * C::SUB, k % 4);
        if (k == 0)
          wg::Wgmma<QT>::template ss0<0, 0>(st, dk_, dq);
        else
          wg::Wgmma<QT>::template ss<0, 0>(st, dk_, dq, 1);
      }
      wg::wgmma_commit();
#pragma unroll
      for (int k = 0; k < D / 16; ++k) {
        uint64_t ddo = wg::kmajor_desc(dos + (k / 4) * C::Q_HALF, k % 4);
        uint64_t dv_ = wg::kmajor_desc(vb + (k / 4) * C::SUB, k % 4);
        if (k == 0)
          wg::Wgmma<QT>::template ss0<0, 0>(dpt, dv_, ddo);
        else
          wg::Wgmma<QT>::template ss<0, 0>(dpt, dv_, ddo, 1);
      }
      wg::wgmma_commit();
      wg::wgmma_wait<1>();
      wg::fence_regs(st);
      // P^T = 2^(S^T c2 - lse2), 0 where masked, split into bf16 hi and lo
      // A fragments, 16 queries a k-step (accumulators 8 kk + 2 f, + 1: row
      // key0 + 8 (f & 1), columns 16 kk + 8 (f >> 1) + 2 (lane % 4), + 1)
      bool mask = q0 + QT > p.S || kc + 64 > p.S || (causal && q0 < kc + 63);
      uint32_t ph[QT / 16][4], pl[QT / 16][4], sh[QT / 16][4], sl[QT / 16][4];
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          int i = 8 * kk + 2 * f;
          int col = 16 * kk + 8 * (f >> 1) + 2 * (lane & 3);
          int key = key0 + 8 * (f & 1);
          float2 lse2 = ld_pair(rows + col);
          float pe[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float pv = ex2(__fmaf_rn(st[i + e], c2, -(e ? lse2.y : lse2.x)));
            if (mask) {
              int qpos = q0 + col + e;
              if (qpos >= p.S || key >= p.S || (causal && key > qpos))
                pv = 0.0f;
            }
            pe[e] = pv;
          }
          split_pack(pe[0], pe[1], ph[kk][f], pl[kk][f]);
        }
      }
      // dV += P^T do (hi and lo), do MN-major, while dS^T is formed
      wg::fence_regs(dv);
      wg::fence_regs(ph);
      wg::fence_regs(pl);
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk) {
        uint64_t ddo = wg::mnmajor_desc(dos, kk, C::Q_HALF);
        wg::Wgmma<D>::template rs<1>(dv, ph[kk], ddo, 1);
        wg::Wgmma<D>::template rs<1>(dv, pl[kk], ddo, 1);
      }
      wg::wgmma_commit();
      wg::wgmma_wait<1>();
      wg::fence_regs(dpt);
      // dS^T = P^T (dP^T - delta), P^T as its products see it (hi + lo)
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          int i = 8 * kk + 2 * f;
          int col = 16 * kk + 8 * (f >> 1) + 2 * (lane & 3);
          float2 del = ld_pair(rows + QT + col);
          float2 h = unpack_bf16(ph[kk][f]), l = unpack_bf16(pl[kk][f]);
          float d0 = __fmul_rn(__fadd_rn(h.x, l.x), __fsub_rn(dpt[i], del.x));
          float d1 =
              __fmul_rn(__fadd_rn(h.y, l.y), __fsub_rn(dpt[i + 1], del.y));
          split_pack(d0, d1, sh[kk][f], sl[kk][f]);
        }
      }
      // dK += dS^T q (hi and lo), q MN-major
      wg::fence_regs(dk);
      wg::fence_regs(sh);
      wg::fence_regs(sl);
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk) {
        uint64_t dq = wg::mnmajor_desc(qs, kk, C::Q_HALF);
        wg::Wgmma<D>::template rs<1>(dk, sh[kk], dq, 1);
        wg::Wgmma<D>::template rs<1>(dk, sl[kk], dq, 1);
      }
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::fence_regs(dk);
      wg::fence_regs(dv);
      wg::fence_regs(ph);
      wg::fence_regs(pl);
      wg::fence_regs(sh);
      wg::fence_regs(sl);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&bars.empty[s]);
  }

  // dk * scale and dv, keys below S (wgmma's accumulator layout: columns
  // 8 j + 2 (lane % 4), + 1, rows key0 and key0 + 8)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int key = key0 + 8 * r;
    if (key >= p.S) continue;
    float* krow =
        p.dk + b * p.dk_b + g * p.dk_h + key * p.dk_s + 2 * (lane & 3);
    float* vrow =
        p.dv + b * p.dv_b + g * p.dv_h + key * p.dv_s + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(krow + 8 * j) =
          make_float2(__fmul_rn(dk[4 * j + 2 * r], p.scale),
                      __fmul_rn(dk[4 * j + 2 * r + 1], p.scale));
      *reinterpret_cast<float2*>(vrow + 8 * j) =
          make_float2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
    bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo, Params p) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = wg::align_1024(smem_raw);
  auto& bars = *reinterpret_cast<Bars<C::ST>*>(smem + C::BARS);
  int k0 = blockIdx.z * C::BKV;    // key tiles slowest: the first, whose
  int g = blockIdx.x;              // causal walks are longest, go first
  int b = blockIdx.y;
  int qt_first = p.causal ? k0 / C::QT : 0;
  int n_it = ((p.S + C::QT - 1) / C::QT - qt_first) * p.rep;
  if (threadIdx.x == 0) bars.init(4 * C::NC);
  __syncthreads();
  if (threadIdx.x < 128) {
    if (threadIdx.x < 32)
      produce<D>(smem, bars, &tq, &tk, &tv, &tdo, p, k0, g, b, qt_first,
                 n_it);
  } else {
    consume<D>(smem, bars, p, k0, g, b, qt_first, n_it);
  }
}

// A 4-D bf16 map (D, rows, heads, batch) over a tensor read through element
// strides (row, head, batch), boxes of 64 values x box_rows rows, 128-byte
// swizzle.
bool make_rows_map(CUtensorMap* map, const void* base, int D, int rows,
                   int heads, int batch, long long s_row, long long s_head,
                   long long s_batch, int box_rows) {
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                        static_cast<cuuint64_t>(rows),
                        static_cast<cuuint64_t>(heads),
                        static_cast<cuuint64_t>(batch)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_row) * 2,
                           static_cast<cuuint64_t>(s_head) * 2,
                           static_cast<cuuint64_t>(s_batch) * 2};
  cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_rows), 1, 1};
  return wg::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims,
                      strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const Params& p, int B, int KVH, const long long (&qs)[3],
           const long long (&ks)[3], const long long (&vs)[3],
           const long long (&ds)[3], cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_rows_map(&tq, q, D, p.S, p.H, B, qs[2], qs[1], qs[0], C::QT) ||
      !make_rows_map(&tk, k, D, p.S, KVH, B, ks[2], ks[1], ks[0], 64) ||
      !make_rows_map(&tv, v, D, p.S, KVH, B, vs[2], vs[1], vs[0], 64) ||
      !make_rows_map(&tdo, dout, D, p.S, p.H, B, ds[2], ds[1], ds[0], C::QT))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkv_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(KVH, B, (p.S + C::BKV - 1) / C::BKV);
  bwd_dkv_wgmma<D><<<grid, C::THREADS, smem, stream>>>(tq, tk, tv, tdo, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dkv
}  // namespace htog

// q, do, k, v: bf16; dk, dv: fp32; rows of D contiguous elements, each
// 16-byte aligned; *_b, *_h, *_s: element strides of batch, head and row
// (the wrapper checks; multiples of 16 bytes for the bf16 operands). lse,
// delta: (B, H, S) fp32, contiguous. D in {64, 128}, H a multiple of KVH,
// B, KVH, S >= 1. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unknown D or a tensor map the CUDA
// driver refuses).
extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int KVH, int S, int D, int causal, int q_b, int q_h, int q_s, int k_b,
    int k_h, int k_s, int v_b, int v_h, int v_s, int d_b, int d_h, int d_s,
    int dk_b, int dk_h, int dk_s, int dv_b, int dv_h, int dv_s, float scale,
    void* stream) {
  using namespace htog::dkv;
  Params p{static_cast<const float*>(lse), static_cast<const float*>(delta),
           static_cast<float*>(dk), static_cast<float*>(dv), S, H, H / KVH,
           causal, dk_b, dk_h, dk_s, dv_b, dv_h, dv_s, scale};
  const long long qs[3] = {q_b, q_h, q_s};
  const long long ks[3] = {k_b, k_h, k_s};
  const long long vs[3] = {v_b, v_h, v_s};
  const long long ds[3] = {d_b, d_h, d_s};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(q, k, v, dout, p, B, KVH, qs, ks, vs, ds, st);
    case 128: return launch<128>(q, k, v, dout, p, B, KVH, qs, ks, vs, ds, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
