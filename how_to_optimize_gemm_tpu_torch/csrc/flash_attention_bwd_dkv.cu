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
// first: the same to rounding). p and ds are fp32 and each split into bf16
// hi + lo for their products (two MMAs, |error| <= 2^-17 |x|,
// flash_common.cuh); q, do, k and v are bf16 and exact. Sums run in another
// order than the plain version's (ops/attention.flash_attention_bwd_dkv_ref),
// so the two agree to rounding. Every output row belongs to one block, which
// sums its group's query heads itself: no atomics, the same bits every run.
//
// Bound on an H100 SXM at the soak's shape (B 8, H 32, KVH 4, D 64, S 1,024,
// causal): 6.9e10 FLOPs of the four products over 524,800 query-key pairs a
// head, 0.070 ms at the 989 TFLOP/s dense bf16 peak, against 128 MB moved
// (q and do in bf16 read once, k and v read and dk and dv written in fp32,
// lse and delta), 0.038 ms at 3.35 TB/s: the tensor cores bound it. The
// splits of p and ds make the four products six MMAs, a cost of this kernel,
// not of the work.
//
// Design: one block of 4 warps per (64-key tile, KV head, batch), keys in the
// order of their causal work (the first keys have the most queries); each
// warp owns 16 keys, whose K and V rows stay in shared memory for the whole
// walk. The block walks the query tiles from the diagonal on (all of them
// when not causal), and in each the REP query heads of its group, q and do
// tiles (and their lse and delta rows) double-buffered with cp.async. The
// scores are formed transposed, S^T = K Q^T and dP^T = V dO^T, so that P^T
// and dS^T come out of the accumulators as the A fragments of P^T dO and
// dS^T Q, with dO and Q through ldmatrix.trans. The query tile is 64 rows at
// D = 64 and 32 at D = 128, where the dk and dv accumulators take 128
// registers. Simple first version: mma.sync, cp.async, no warp
// specialisation.
#include "flash_common.cuh"

namespace {

using namespace htog::fa;

constexpr int BKV = 64;         // keys per block, 16 per warp
constexpr int THREADS = BKV / 16 * 32;

template <int D>
struct Tile {
  static constexpr int QT = D == 64 ? 64 : 32;   // queries per step
};

template <int D>
struct Smem {
  static constexpr int QT = Tile<D>::QT;
  bf16 k[BKV][D + 8];
  bf16 v[BKV][D + 8];
  bf16 q[2][QT][D + 8];
  bf16 dout[2][QT][D + 8];
  float lse[2][QT];
  float delta[2][QT];
};

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;
  const float* delta;
  float* dk;
  float* dv;
  int S, H, rep, causal;
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, d_b, d_h, d_s, dk_b,
      dk_h, dk_s, dv_b, dv_h, dv_s;
  float scale;
};

// Step ``it`` of the walk: query tile qt_first + it / rep of query head
// g * rep + it % rep, staged into buffer ``buf``.
template <int D>
__device__ __forceinline__ void stage(Smem<D>& sm, const Params& p, int b,
                                      int g, int qt_first, int it, int buf) {
  constexpr int QT = Tile<D>::QT;
  int q0 = (qt_first + it / p.rep) * QT;
  int h = g * p.rep + it % p.rep;
  load_rows<D, QT, THREADS>(sm.q[buf], p.q + b * p.q_b + h * p.q_h, p.q_s, q0,
                            p.S);
  load_rows<D, QT, THREADS>(sm.dout[buf], p.dout + b * p.d_b + h * p.d_h,
                            p.d_s, q0, p.S);
  if (threadIdx.x < QT) {
    int row = q0 + threadIdx.x;
    long long i = (static_cast<long long>(b) * p.H + h) * p.S + row;
    bool in = row < p.S;
    sm.lse[buf][threadIdx.x] = in ? p.lse[i] : 0.0f;
    sm.delta[buf][threadIdx.x] = in ? p.delta[i] : 0.0f;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) bwd_dkv_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw);
  constexpr int QT = Tile<D>::QT;
  constexpr int KS = D / 16;    // k-steps of K Q^T and V dO^T
  constexpr int DN = D / 8;     // 8-column tiles of dk and dv
  constexpr int NT = QT / 8;    // 8-query tiles of the scores
  int k0 = blockIdx.x * BKV;
  int g = blockIdx.y;
  int b = blockIdx.z;
  int warp = threadIdx.x >> 5;
  int lane = threadIdx.x & 31;
  int qt_first = p.causal ? k0 / QT : 0;
  int n_it = ((p.S + QT - 1) / QT - qt_first) * p.rep;

  load_rows<D, BKV, THREADS>(sm.k, p.k + b * p.k_b + g * p.k_h, p.k_s, k0,
                             p.S);
  load_rows<D, BKV, THREADS>(sm.v, p.v + b * p.v_b + g * p.v_h, p.v_s, k0,
                             p.S);
  stage(sm, p, b, g, qt_first, 0, 0);
  htog::cp_async_commit();

  int kpos[2];
  kpos[0] = k0 + warp * 16 + (lane >> 2);
  kpos[1] = kpos[0] + 8;
  float dk[DN][4], dv[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dn][e] = dv[dn][e] = 0.0f;
  htog::cp_async_wait_all();
  __syncthreads();

  for (int it = 0; it < n_it; ++it) {
    int cur = it & 1;
    if (it + 1 < n_it) {
      stage(sm, p, b, g, qt_first, it + 1, cur ^ 1);
      htog::cp_async_commit();
    }
    int q0 = (qt_first + it / p.rep) * QT;
    // S^T = K Q^T and dP^T = V dO^T
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ka[4], va[4];
      frag_a(ka, sm.k, warp * 16, ks * 16);
      frag_a(va, sm.v, warp * 16, ks * 16);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t qf[4], df[4];
        frag_b(qf, sm.q[cur], nt * 8, ks * 16);
        mma_bf16(st[nt], ka, qf[0], qf[1]);
        mma_bf16(st[nt + 1], ka, qf[2], qf[3]);
        frag_b(df, sm.dout[cur], nt * 8, ks * 16);
        mma_bf16(dpt[nt], va, df[0], df[1]);
        mma_bf16(dpt[nt + 1], va, df[2], df[3]);
      }
    }
    // P^T = exp(S^T scale - lse) (0 where masked), dS^T = P^T (dP^T - delta)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int col = nt * 8 + 2 * (lane & 3) + (e & 1);
        int qpos = q0 + col;
        int key = kpos[e >> 1];
        bool dead = qpos >= p.S || key >= p.S || (p.causal && key > qpos);
        float pe = dead ? 0.0f
                        : expf(__fsub_rn(__fmul_rn(st[nt][e], p.scale),
                                         sm.lse[cur][col]));
        st[nt][e] = pe;
        dpt[nt][e] =
            __fmul_rn(pe, __fsub_rn(dpt[nt][e], sm.delta[cur][col]));
      }
    }
    // dV += (P^T_hi + P^T_lo) dO, dK += (dS^T_hi + dS^T_lo) Q, 16 queries at
    // a time
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      acc_to_a_split(st, kk, ph, pl);
      acc_to_a_split(dpt, kk, sh, sl);
#pragma unroll
      for (int dn = 0; dn < DN; dn += 2) {
        uint32_t df[4], qf[4];
        frag_bt(df, sm.dout[cur], kk * 16, dn * 8);
        mma_bf16(dv[dn], ph, df[0], df[1]);
        mma_bf16(dv[dn], pl, df[0], df[1]);
        mma_bf16(dv[dn + 1], ph, df[2], df[3]);
        mma_bf16(dv[dn + 1], pl, df[2], df[3]);
        frag_bt(qf, sm.q[cur], kk * 16, dn * 8);
        mma_bf16(dk[dn], sh, qf[0], qf[1]);
        mma_bf16(dk[dn], sl, qf[0], qf[1]);
        mma_bf16(dk[dn + 1], sh, qf[2], qf[3]);
        mma_bf16(dk[dn + 1], sl, qf[2], qf[3]);
      }
    }
    htog::cp_async_wait_all();
    __syncthreads();
  }

  // dk * scale and dv, rows below S
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int row = kpos[r];
    if (row >= p.S) continue;
    float* krow =
        p.dk + b * p.dk_b + g * p.dk_h + row * p.dk_s + 2 * (lane & 3);
    float* vrow =
        p.dv + b * p.dv_b + g * p.dv_h + row * p.dv_s + 2 * (lane & 3);
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      *reinterpret_cast<float2*>(krow + dn * 8) =
          make_float2(__fmul_rn(dk[dn][2 * r], p.scale),
                      __fmul_rn(dk[dn][2 * r + 1], p.scale));
      *reinterpret_cast<float2*>(vrow + dn * 8) =
          make_float2(dv[dn][2 * r], dv[dn][2 * r + 1]);
    }
  }
}

template <int D>
int launch(const Params& p, int B, int KVH, cudaStream_t stream) {
  constexpr int smem = sizeof(Smem<D>);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.S + BKV - 1) / BKV, KVH, B);
  bwd_dkv_kernel<D><<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, do, k, v: bf16; dk, dv: fp32; rows of D contiguous elements, each
// 16-byte aligned; *_b, *_h, *_s: element strides of batch, head and row (the
// wrapper checks). lse, delta: (B, H, S) fp32, contiguous. D in {64, 128}, H
// a multiple of KVH, B, KVH, S >= 1. Returns cudaGetLastError() after the
// launch.
extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int KVH, int S, int D, int causal, int q_b, int q_h, int q_s, int k_b,
    int k_h, int k_s, int v_b, int v_h, int v_s, int d_b, int d_h, int d_s,
    int dk_b, int dk_h, int dk_s, int dv_b, int dv_h, int dv_s, float scale,
    void* stream) {
  Params p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
           static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
           static_cast<const float*>(lse), static_cast<const float*>(delta),
           static_cast<float*>(dk), static_cast<float*>(dv), S, H, H / KVH,
           causal, q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, d_b, d_h,
           d_s, dk_b, dk_h, dk_s, dv_b, dv_h, dv_s, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(p, B, KVH, s);
    case 128: return launch<128>(p, B, KVH, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
