// flash_attention_fwd_lse: the training forward of causal or non-causal GQA
// self-attention, which also writes the logsumexp of every row for the
// backward. q (B, H, S, D) fp32, k and v (B, KVH, S, D) bf16, out (B, H, S, D)
// fp32, each read or written through its own (b, h, row) element strides with
// the D elements of a row contiguous; lse (B, H, S) fp32, contiguous. Query
// head h attends KV head h / REP (REP = H / KVH); query i sits at position i.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_attention.py, _fwd_kernel_lse
// (via _flash_fwd_lse, flash_attention_train and mha_flash_train;
// models/llama._block for training with flash_train at s >= 512 and d_head 64
// or 128).
//
// Arithmetic (the reference's, key tile by key tile): q times scale in fp32,
// not rounded to bf16 (the reference keeps q in fp32 here, unlike the
// inference kernel); the scores fl(q * scale) . k in fp32, the fp32 q split
// into bf16 hi + lo (two MMAs, |error| <= 2^-17 |q|, flash_common.cuh); keys
// past S, and for causal keys past the query's position, set to -1e30; per
// tile m_new = max(m, max s), alpha = exp(m - m_new), p = exp(s - m_new) in
// fp32; l = l * alpha + sum of the fp32 p; o = o * alpha + bf16(p) @ V
// accumulated in fp32; out = o / max(l, 1e-30) and lse = m + log(max(l,
// 1e-30)), both fp32. Sums run in another order than the plain version's
// (ops/attention.flash_attention_fwd_lse_ref), so the two agree to rounding.
// A causal query tile skips the key tiles wholly past its last row. S needs
// not be a tile multiple: rows and keys past S are zero in shared memory, and
// only rows below S are written.
//
// Bound on an H100 SXM at the training shape of the TinyLlama-1.1B soak
// (B 8, H 32, KVH 4, D 64, S 1,024, causal): 3.44e10 FLOPs of the two
// products over the 524,800 query-key pairs of a head, 0.035 ms at the
// 989 TFLOP/s dense bf16 peak, against 144 MB moved (q read and out written
// in fp32, k and v read in bf16, lse written), 0.043 ms at 3.35 TB/s: the
// memory bounds it, the fp32 q and out being most of the bytes. The split of
// q doubles the MMAs of Q K^T, a cost of this kernel and not of the work.
//
// Design: the inference kernel's (flash_attention.cu): one block of 4 warps
// per (64-query tile, head, batch), the tiles of the longest causal rows
// first; each warp owns 16 query rows. The block loads its q tile once,
// scales and splits it into two bf16 tiles in shared memory, whose A
// fragments each k-step reloads (kept in registers they would spill beside
// the output accumulators at D = 128). K and V tiles of 64 keys are
// double-buffered with cp.async. The online softmax stays in registers; P is
// rounded to bf16 straight out of the S accumulators. Simple first version:
// mma.sync rather than wgmma, cp.async rather than TMA, no warp
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
  bf16 k[2][BKV][D + 8];
  bf16 v[2][BKV][D + 8];
};

struct Params {
  const float* q;
  const bf16* k;
  const bf16* v;
  float* o;
  float* lse;
  int S, H, rep, causal;
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s;
  float scale;
};

template <int D>
__global__ void __launch_bounds__(THREADS) fwd_lse_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw);
  constexpr int KS = D / 16;    // k-steps of Q K^T
  constexpr int DN = D / 8;     // 8-column tiles of the output
  constexpr int NT = BKV / 8;   // 8-key tiles of the scores
  int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest causal rows first
  int h = blockIdx.y;
  int b = blockIdx.z;
  int warp = threadIdx.x >> 5;
  int lane = threadIdx.x & 31;
  int g = h / p.rep;
  const float* qb = p.q + b * p.q_b + h * p.q_h;
  const bf16* kb = p.k + b * p.k_b + g * p.k_h;
  const bf16* vb = p.v + b * p.v_b + g * p.v_h;
  // the last key any row of this block sees
  int last = p.causal ? min(q0 + BQ - 1, p.S - 1) : p.S - 1;
  int n_tiles = last / BKV + 1;

  load_rows<D, BKV, THREADS>(sm.k[0], kb, p.k_s, 0, p.S);
  load_rows<D, BKV, THREADS>(sm.v[0], vb, p.v_s, 0, p.S);
  htog::cp_async_commit();
  load_split_rows<D, BQ, THREADS>(sm.qh, sm.ql, qb, p.q_s, q0, p.S, p.scale);
  htog::cp_async_wait_all();
  __syncthreads();

  float o[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.0f;
  float m_row[2] = {NEG_INF, NEG_INF};
  float l_part[2] = {0.0f, 0.0f};   // this lane's share of each row's sum
  int row0 = q0 + warp * 16 + (lane >> 2);
  int qpos[2] = {row0, row0 + 8};
  int warp_first = q0 + warp * 16;

  for (int j = 0; j < n_tiles; ++j) {
    int cur = j & 1;
    if (j + 1 < n_tiles) {
      load_rows<D, BKV, THREADS>(sm.k[cur ^ 1], kb, p.k_s, (j + 1) * BKV, p.S);
      load_rows<D, BKV, THREADS>(sm.v[cur ^ 1], vb, p.v_s, (j + 1) * BKV, p.S);
      htog::cp_async_commit();
    }
    // S = (Qhi + Qlo) K^T over this tile
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ah[4], al[4];
      frag_a(ah, sm.qh, warp * 16, ks * 16);
      frag_a(al, sm.ql, warp * 16, ks * 16);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t kf[4];
        frag_b(kf, sm.k[cur], nt * 8, ks * 16);
        mma_bf16(s[nt], ah, kf[0], kf[1]);
        mma_bf16(s[nt], al, kf[0], kf[1]);
        mma_bf16(s[nt + 1], ah, kf[2], kf[3]);
        mma_bf16(s[nt + 1], al, kf[2], kf[3]);
      }
    }
    // mask, and the online-softmax statistics
    int k0 = j * BKV;
    bool mask = k0 + BKV > p.S || (p.causal && k0 + BKV - 1 > warp_first);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e];
        if (mask) {
          int kpos = k0 + nt * 8 + 2 * (lane & 3) + (e & 1);
          if (kpos >= p.S || (p.causal && kpos > qpos[e >> 1])) x = NEG_INF;
        }
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      float m_new = fmaxf(m_row[r], mx[r]);
      alpha[r] = expf(__fsub_rn(m_row[r], m_new));
      m_row[r] = m_new;
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = expf(__fsub_rn(s[nt][e], m_row[e >> 1]));
        sum[e >> 1] = __fadd_rn(sum[e >> 1], pe);
        s[nt][e] = pe;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_part[r] = __fadd_rn(__fmul_rn(l_part[r], alpha[r]), sum[r]);
    }
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dn][e] = __fmul_rn(o[dn][e], alpha[e >> 1]);
    }
    // O += bf16(P) V, 16 keys at a time
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(s, kk, pa);
#pragma unroll
      for (int dn = 0; dn < DN; dn += 2) {
        uint32_t vf[4];
        frag_bt(vf, sm.v[cur], kk * 16, dn * 8);
        mma_bf16(o[dn], pa, vf[0], vf[1]);
        mma_bf16(o[dn + 1], pa, vf[2], vf[3]);
      }
    }
    htog::cp_async_wait_all();
    __syncthreads();
  }

  // out = o / max(l, 1e-30) and lse = m + log(max(l, 1e-30)), rows below S
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_part[r];
    l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, 1));
    l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, 2));
    l = fmaxf(l, 1e-30f);
    int row = row0 + r * 8;
    if (row >= p.S) continue;
    float* orow = p.o + b * p.o_b + h * p.o_h + row * p.o_s + 2 * (lane & 3);
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      *reinterpret_cast<float2*>(orow + dn * 8) = make_float2(
          __fdiv_rn(o[dn][2 * r], l), __fdiv_rn(o[dn][2 * r + 1], l));
    }
    if ((lane & 3) == 0) {
      p.lse[(static_cast<long long>(b) * p.H + h) * p.S + row] =
          __fadd_rn(m_row[r], logf(l));
    }
  }
}

template <int D>
int launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int smem = sizeof(Smem<D>);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_lse_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.S + BQ - 1) / BQ, p.H, B);
  fwd_lse_kernel<D><<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: fp32; k, v: bf16; rows of D contiguous elements, each 16-byte
// aligned; *_b, *_h, *_s: element strides of batch, head and row (the wrapper
// checks). lse: (B, H, S) fp32, contiguous. D in {64, 128}, H a multiple of
// KVH, B, H, S >= 1. Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd_lse(const void* q, const void* k,
                                       const void* v, void* out, void* lse,
                                       int B, int H, int KVH, int S, int D,
                                       int causal, int q_b, int q_h, int q_s,
                                       int k_b, int k_h, int k_s, int v_b,
                                       int v_h, int v_s, int o_b, int o_h,
                                       int o_s, float scale, void* stream) {
  Params p{static_cast<const float*>(q), static_cast<const bf16*>(k),
           static_cast<const bf16*>(v), static_cast<float*>(out),
           static_cast<float*>(lse), S, H, H / KVH, causal, q_b, q_h, q_s,
           k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(p, B, s);
    case 128: return launch<128>(p, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
