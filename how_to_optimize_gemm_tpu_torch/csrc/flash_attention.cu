// flash_attention: causal or non-causal GQA attention forward with an online
// softmax. q (B, H, S, D), k and v (B, KVH, T, D), out (B, H, S, D), all
// bf16, each read or written through its own (b, h, row) element strides
// with the D elements of a row contiguous. Query head h attends KV head
// h / REP (REP = H / KVH); query i sits at position T - S + i.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_attention.py,
// _stream_kernel (via flash_attention, flash_attention_packed and
// mha_flash; models/llama._block for the causal self-attention of a prompt
// of s >= 512 tokens with d_head 64 or 128).
//
// Arithmetic (the reference's, key tile by key tile): the scores q . k in
// fp32 (bf16 products, fp32 sums by the tensor cores), times scale in fp32
// (q is never pre-scaled and rounded back to bf16); keys past T, and for
// causal keys past the query's position, set to -1e30; per tile
// m_new = max(m, max s), alpha = exp(m - m_new), p = exp(s - m_new) in
// fp32; l = l * alpha + sum of the fp32 p; o = o * alpha + bf16(p) @ V
// accumulated in fp32; out = bf16(o / max(l, 1e-30)). Sums run in another
// order than the plain version's (ops/attention.flash_attention_ref), so
// the two agree to rounding. A causal query tile skips the key tiles wholly
// past its last row's position. S and T need not be tile multiples: rows
// past S and keys past T are zero-filled in shared memory, and only rows
// below S are written.
//
// Bound on an H100 SXM at the Llama-2-7B prefill shape (B 4, H = KVH = 32,
// D 128, S = T = 4096, causal): 5.50e11 FLOPs, 0.556 ms at the 989 TFLOP/s
// dense bf16 peak, against 537 MB (q, k, v read once, out written once),
// 0.160 ms at 3.35 TB/s: the tensor cores bound it, and the exps (1.1e9)
// run beside them on the multifunction units.
//
// Design: one block of 4 warps per (64-query tile, head, batch), the tiles
// of the longest causal rows launched first. Each warp owns 16 query rows,
// whose Q fragments it keeps in registers for the whole walk. K and V
// tiles of 64 keys x D are double-buffered in shared memory with cp.async
// (rows padded by 16 bytes, so the 8 rows of an ldmatrix hit 32 distinct
// banks): the next tile's copy is in flight while this one is used.
// S = Q K^T and O += P V run on mma.sync.m16n8k16 bf16 -> fp32; K's B
// fragments come from ldmatrix, V's from ldmatrix.trans; P is rounded to
// bf16 straight out of the S accumulators, which have the layout of the
// next product's A fragments. The online softmax stays in registers, a
// row's max and sum reduced over its quad of lanes. Simple first version:
// mma.sync rather than wgmma, cp.async rather than TMA, no warp
// specialisation, the output written from the accumulators without
// staging.
#include "flash_common.cuh"

namespace {

using namespace htog::fa;

constexpr int BQ = 64;          // query rows per block, 16 per warp
constexpr int BKV = 64;         // keys per tile
static_assert(BQ == BKV, "load_tile stages tiles of BQ rows");
constexpr int WARPS = BQ / 16;
constexpr int FA_THREADS = WARPS * 32;

template <int D>
struct Smem {
  bf16 q[BQ][D + 8];
  bf16 k[2][BKV][D + 8];
  bf16 v[2][BKV][D + 8];
};

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  int S, T, rep, causal;
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s;
  float scale;
};

// 64 rows x D of a matrix whose row r starts at base + r * stride; rows
// >= rows are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16 (*dst)[D + 8], const bf16* base,
                                          long long stride, int row0,
                                          int rows) {
  constexpr int CHUNKS = D / 8;   // 16-byte chunks of a row
#pragma unroll
  for (int i = 0; i < BQ * CHUNKS / FA_THREADS; ++i) {
    int c = threadIdx.x + i * FA_THREADS;
    int r = c / CHUNKS;
    int col = (c % CHUNKS) * 8;
    int gr = row0 + r;
    bool valid = gr < rows;
    const bf16* p = valid ? base + gr * stride + col : base;
    htog::cp_async16(&dst[r][col], p, valid);
  }
}

// Accumulator layout of an m16n8 tile (and of each 8 columns below): lane
// holds rows lane/4 (e = 0, 1) and lane/4 + 8 (e = 2, 3), columns
// 2 * (lane % 4) + (e % 2).
template <int D>
__global__ void __launch_bounds__(FA_THREADS)
    flash_attention_kernel(Params p) {
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
  const bf16* qb = p.q + b * p.q_b + h * p.q_h;
  const bf16* kb = p.k + b * p.k_b + g * p.k_h;
  const bf16* vb = p.v + b * p.v_b + g * p.v_h;
  int off = p.T - p.S;
  // the last key any row of this block sees
  int last = p.causal ? min(off + q0 + BQ - 1, p.T - 1) : p.T - 1;
  int n_tiles = last / BKV + 1;

  load_tile<D>(sm.q, qb, p.q_s, q0, p.S);
  load_tile<D>(sm.k[0], kb, p.k_s, 0, p.T);
  load_tile<D>(sm.v[0], vb, p.v_s, 0, p.T);
  htog::cp_async_commit();
  htog::cp_async_wait_all();
  __syncthreads();

  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    ldmatrix_x4(qf[ks], &sm.q[warp * 16 + (lane & 15)][ks * 16 + (lane >> 4) * 8],
                false);
  }
  float o[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.0f;
  float m_row[2] = {NEG_INF, NEG_INF};
  float l_part[2] = {0.0f, 0.0f};   // this lane's share of each row's sum
  // positions of this lane's two rows, and of the warp's first row
  int row0 = q0 + warp * 16 + (lane >> 2);
  int qpos[2] = {off + row0, off + row0 + 8};
  int warp_first = off + q0 + warp * 16;

  for (int j = 0; j < n_tiles; ++j) {
    int cur = j & 1;
    if (j + 1 < n_tiles) {
      load_tile<D>(sm.k[cur ^ 1], kb, p.k_s, (j + 1) * BKV, p.T);
      load_tile<D>(sm.v[cur ^ 1], vb, p.v_s, (j + 1) * BKV, p.T);
      htog::cp_async_commit();
    }
    // S = Q K^T over this tile
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t kf[4];
        ldmatrix_x4(kf,
                    &sm.k[cur][nt * 8 + (lane & 7) + (lane >> 4) * 8]
                          [ks * 16 + ((lane >> 3) & 1) * 8],
                    false);
        mma_bf16(s[nt], qf[ks], kf[0], kf[1]);
        mma_bf16(s[nt + 1], qf[ks], kf[2], kf[3]);
      }
    }
    // scale, mask, and the online-softmax statistics
    int k0 = j * BKV;
    bool mask = k0 + BKV > p.T || (p.causal && k0 + BKV - 1 > warp_first);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(s[nt][e], p.scale);
        if (mask) {
          int kpos = k0 + nt * 8 + 2 * (lane & 3) + (e & 1);
          if (kpos >= p.T || (p.causal && kpos > qpos[e >> 1])) x = NEG_INF;
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
      uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                        pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                        pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                        pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < DN; dn += 2) {
        uint32_t vf[4];
        ldmatrix_x4(vf,
                    &sm.v[cur][kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8]
                          [dn * 8 + (lane >> 4) * 8],
                    true);
        mma_bf16(o[dn], pa, vf[0], vf[1]);
        mma_bf16(o[dn + 1], pa, vf[2], vf[3]);
      }
    }
    htog::cp_async_wait_all();
    __syncthreads();
  }

  // out = bf16(o / max(l, 1e-30)), rows below S only
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_part[r];
    l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, 1));
    l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, 2));
    l = fmaxf(l, 1e-30f);
    int row = row0 + r * 8;
    if (row >= p.S) continue;
    bf16* orow = p.o + b * p.o_b + h * p.o_h + row * p.o_s + 2 * (lane & 3);
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      *reinterpret_cast<__nv_bfloat162*>(orow + dn * 8) = __floats2bfloat162_rn(
          __fdiv_rn(o[dn][2 * r], l), __fdiv_rn(o[dn][2 * r + 1], l));
    }
  }
}

template <int D>
int launch(const Params& p, int B, int H, cudaStream_t stream) {
  constexpr int smem = sizeof(Smem<D>);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.S + BQ - 1) / BQ, H, B);
  flash_attention_kernel<D><<<grid, FA_THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out: bf16 with the D elements of a row contiguous, every row
// 16-byte aligned; *_b, *_h, *_s: element strides of batch, head and row
// (the wrapper checks). D in {64, 128}, H a multiple of KVH, S <= T when
// causal, B, H, S >= 1 and T >= 1. Returns cudaGetLastError() after the
// launch.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int H, int KVH, int S, int T,
                               int D, int causal, int q_b, int q_h, int q_s,
                               int k_b, int k_h, int k_s, int v_b, int v_h,
                               int v_s, int o_b, int o_h, int o_s, float scale,
                               void* stream) {
  Params p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
           static_cast<const bf16*>(v), static_cast<bf16*>(out),
           S, T, H / KVH, causal, q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s,
           o_b, o_h, o_s, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(p, B, H, s);
    case 128: return launch<128>(p, B, H, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
