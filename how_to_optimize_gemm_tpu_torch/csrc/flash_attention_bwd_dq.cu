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
// Arithmetic (the reference's, all in fp32, key tile by key tile):
// s = fl(q * scale) . k, masked to -1e30 past S and, for causal, past the
// query's position; p = exp(s - lse); dp = do . v; ds = p (dp - delta);
// dq += ds . k; the result dq * scale. The fp32 operands of the products (q
// times scale, do and ds) are each split into bf16 hi + lo (two MMAs each,
// |error| <= 2^-17 |x|, flash_common.cuh); k and v are bf16 and exact. Sums
// run in another order than the plain version's
// (ops/attention.flash_attention_bwd_dq_ref), so the two agree to rounding.
// Every output row belongs to one block: no atomics, the same bits every run.
//
// Bound on an H100 SXM at the soak's shape (B 8, H 32, KVH 4, D 64, S 1,024,
// causal): 5.2e10 FLOPs of the three products over 524,800 query-key pairs a
// head, 0.052 ms at the 989 TFLOP/s dense bf16 peak, against 210 MB moved (q,
// do read and dq written in fp32, k and v in bf16, lse and delta), 0.063 ms at
// 3.35 TB/s: the memory bounds it. The splits make the three products six
// MMAs, a cost of this kernel, not of the work.
//
// Design: the forward's (flash_attention_fwd_lse.cu): one block of 4 warps
// per (64-query tile, head, batch), the longest causal rows first, each warp
// 16 rows. q (scaled) and do are split once into bf16 tiles in shared memory;
// K and V tiles of 64 keys are double-buffered with cp.async. Per tile the
// warp forms S and dP in registers, turns them into dS in place, and feeds dS
// split from its accumulators as the A fragments of dS K (K through
// ldmatrix.trans). Simple first version: mma.sync, cp.async, no warp
// specialisation.
#include "flash_common.cuh"

namespace {

using namespace htog::fa;

constexpr int BQ = 64;          // query rows per block, 16 per warp
constexpr int BKV = 64;         // keys per tile
constexpr int THREADS = BQ / 16 * 32;

template <int D>
struct Smem {
  bf16 qh[BQ][D + 8];
  bf16 ql[BQ][D + 8];
  bf16 dh[BQ][D + 8];
  bf16 dl[BQ][D + 8];
  bf16 k[2][BKV][D + 8];
  bf16 v[2][BKV][D + 8];
};

struct Params {
  const float* q;
  const bf16* k;
  const bf16* v;
  const float* dout;
  const float* lse;
  const float* delta;
  float* dq;
  int S, H, rep, causal;
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, d_b, d_h, d_s, g_b,
      g_h, g_s;
  float scale;
};

template <int D>
__global__ void __launch_bounds__(THREADS) bwd_dq_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw);
  constexpr int KS = D / 16;    // k-steps of Q K^T and dO V^T
  constexpr int DN = D / 8;     // 8-column tiles of dq
  constexpr int NT = BKV / 8;   // 8-key tiles of the scores
  int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest causal rows first
  int h = blockIdx.y;
  int b = blockIdx.z;
  int warp = threadIdx.x >> 5;
  int lane = threadIdx.x & 31;
  int g = h / p.rep;
  const bf16* kb = p.k + b * p.k_b + g * p.k_h;
  const bf16* vb = p.v + b * p.v_b + g * p.v_h;
  int last = p.causal ? min(q0 + BQ - 1, p.S - 1) : p.S - 1;
  int n_tiles = last / BKV + 1;

  load_rows<D, BKV, THREADS>(sm.k[0], kb, p.k_s, 0, p.S);
  load_rows<D, BKV, THREADS>(sm.v[0], vb, p.v_s, 0, p.S);
  htog::cp_async_commit();
  load_split_rows<D, BQ, THREADS>(sm.qh, sm.ql, p.q + b * p.q_b + h * p.q_h,
                                  p.q_s, q0, p.S, p.scale);
  load_split_rows<D, BQ, THREADS>(sm.dh, sm.dl,
                                  p.dout + b * p.d_b + h * p.d_h, p.d_s, q0,
                                  p.S, 1.0f);

  int row0 = q0 + warp * 16 + (lane >> 2);
  int qpos[2] = {row0, row0 + 8};
  int warp_first = q0 + warp * 16;
  long long rows = (static_cast<long long>(b) * p.H + h) * p.S;
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bool in = qpos[r] < p.S;
    lse[r] = in ? p.lse[rows + qpos[r]] : 0.0f;
    delta[r] = in ? p.delta[rows + qpos[r]] : 0.0f;
  }
  float dq[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[dn][e] = 0.0f;
  htog::cp_async_wait_all();
  __syncthreads();

  for (int j = 0; j < n_tiles; ++j) {
    int cur = j & 1;
    if (j + 1 < n_tiles) {
      load_rows<D, BKV, THREADS>(sm.k[cur ^ 1], kb, p.k_s, (j + 1) * BKV, p.S);
      load_rows<D, BKV, THREADS>(sm.v[cur ^ 1], vb, p.v_s, (j + 1) * BKV, p.S);
      htog::cp_async_commit();
    }
    // S = fl(Q scale) K^T and dP = dO V^T over this tile
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ah[4], al[4], dh[4], dl[4];
      frag_a(ah, sm.qh, warp * 16, ks * 16);
      frag_a(al, sm.ql, warp * 16, ks * 16);
      frag_a(dh, sm.dh, warp * 16, ks * 16);
      frag_a(dl, sm.dl, warp * 16, ks * 16);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t kf[4], vf[4];
        frag_b(kf, sm.k[cur], nt * 8, ks * 16);
        mma_bf16(s[nt], ah, kf[0], kf[1]);
        mma_bf16(s[nt], al, kf[0], kf[1]);
        mma_bf16(s[nt + 1], ah, kf[2], kf[3]);
        mma_bf16(s[nt + 1], al, kf[2], kf[3]);
        frag_b(vf, sm.v[cur], nt * 8, ks * 16);
        mma_bf16(dp[nt], dh, vf[0], vf[1]);
        mma_bf16(dp[nt], dl, vf[0], vf[1]);
        mma_bf16(dp[nt + 1], dh, vf[2], vf[3]);
        mma_bf16(dp[nt + 1], dl, vf[2], vf[3]);
      }
    }
    // dS = P (dP - delta), P = exp(S - lse), masked keys giving P = 0
    int k0 = j * BKV;
    bool mask = k0 + BKV > p.S || (p.causal && k0 + BKV - 1 > warp_first);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e];
        if (mask) {
          int kpos = k0 + nt * 8 + 2 * (lane & 3) + (e & 1);
          if (kpos >= p.S || (p.causal && kpos > qpos[e >> 1])) x = NEG_INF;
        }
        float pe = expf(__fsub_rn(x, lse[e >> 1]));
        s[nt][e] = __fmul_rn(pe, __fsub_rn(dp[nt][e], delta[e >> 1]));
      }
    }
    // dQ += (dS_hi + dS_lo) K, 16 keys at a time
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t sh[4], sl[4];
      acc_to_a_split(s, kk, sh, sl);
#pragma unroll
      for (int dn = 0; dn < DN; dn += 2) {
        uint32_t kf[4];
        frag_bt(kf, sm.k[cur], kk * 16, dn * 8);
        mma_bf16(dq[dn], sh, kf[0], kf[1]);
        mma_bf16(dq[dn], sl, kf[0], kf[1]);
        mma_bf16(dq[dn + 1], sh, kf[2], kf[3]);
        mma_bf16(dq[dn + 1], sl, kf[2], kf[3]);
      }
    }
    htog::cp_async_wait_all();
    __syncthreads();
  }

  // dq * scale, rows below S
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int row = qpos[r];
    if (row >= p.S) continue;
    float* grow = p.dq + b * p.g_b + h * p.g_h + row * p.g_s + 2 * (lane & 3);
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      *reinterpret_cast<float2*>(grow + dn * 8) =
          make_float2(__fmul_rn(dq[dn][2 * r], p.scale),
                      __fmul_rn(dq[dn][2 * r + 1], p.scale));
    }
  }
}

template <int D>
int launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int smem = sizeof(Smem<D>);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.S + BQ - 1) / BQ, p.H, B);
  bwd_dq_kernel<D><<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, do, dq: fp32; k, v: bf16; rows of D contiguous elements, each 16-byte
// aligned; *_b, *_h, *_s: element strides of batch, head and row (the wrapper
// checks). lse, delta: (B, H, S) fp32, contiguous. D in {64, 128}, H a
// multiple of KVH, B, H, S >= 1. Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int B, int H, int KVH, int S,
                                      int D, int causal, int q_b, int q_h,
                                      int q_s, int k_b, int k_h, int k_s,
                                      int v_b, int v_h, int v_s, int d_b,
                                      int d_h, int d_s, int g_b, int g_h,
                                      int g_s, float scale, void* stream) {
  Params p{static_cast<const float*>(q), static_cast<const bf16*>(k),
           static_cast<const bf16*>(v), static_cast<const float*>(dout),
           static_cast<const float*>(lse), static_cast<const float*>(delta),
           static_cast<float*>(dq), S, H, H / KVH, causal, q_b, q_h, q_s,
           k_b, k_h, k_s, v_b, v_h, v_s, d_b, d_h, d_s, g_b, g_h, g_s, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(p, B, s);
    case 128: return launch<128>(p, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
