// Kernel 5 decode_attention: length-aware single-query GQA attention over a
// contiguous time-major bf16 KV cache.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_decode_attention.py,
// _kernel_v3 (per-slot, per-head, wide MHA) and _kernel_v4 (fused-head,
// GQA widths): one function at two TPU widths, one kernel here for any
// (kvh, rep, d) with d in {32, 64, 128} (via decode_attention;
// models/llama._block at s == 1). q (B, KVH*REP, D) float32, head
// h = g*REP + r; k, v (B, T, KVH, D) bf16; lengths (B) int32, the valid
// cache rows of each slot; out (B, KVH*REP*D) float32.
//
// Arithmetic (the reference's, chunk by chunk): q in fp32 times
// D^-0.5; K cast to fp32; fp32 scores; keys at positions >= len set to
// -1e30; an online softmax in fp32 over chunks of bk keys
// (m_new = max(m, max s), alpha = exp(m - m_new), p = exp(s - m_new),
// l = l * alpha + sum p); p rounded to bf16 before the PV product, which
// accumulates in fp32; o = o * alpha + pv; out = o / max(l, 1e-30). Only
// ceil(len / bk) chunks of a slot are read. Sums are taken in another
// order than the plain version's, so the two agree to rounding.
//
// Bound on an H100 SXM: the cache rows that exist, read once. At the
// Llama-2-7B shape (4 slots, T = 4096, 32 heads of 128) with lengths
// (1, 300, 1000, 4096), 5,397 rows x 8 KB of K and of V = 88 MB: 26 us at
// 3.35 TB/s.
//
// Design: one block of 128 threads (4 warps) per (kv head, slot), walking
// the slot's live chunks. Per chunk: (1) each warp takes keys in runs of
// U = 4 (four rows in flight); a lane reads D/32 elements of a key row in
// one vector load and dots them with the rep queries held in shared
// memory, a shuffle tree sums each score; (2) one warp per query row
// finds the chunk max and the exp-sum and leaves p (bf16-rounded) in
// shared memory; (3) each warp rescales its partial output by alpha and
// adds p * V over its own keys, a lane owning D/32 columns, again four V
// rows in flight. The four partial outputs are summed once, at the end.
// Every K and V element of a live row is read once.
// Simple first version: no cp.async staging, no split of long slots
// across blocks (one block per (head, slot) leaves SMs idle when B * KVH
// is small).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int U = 4;               // key rows in flight per warp
constexpr int MAX_SCORES = 8192;   // rep * bk, and WARPS * rep * D
constexpr int MAX_QELEMS = 2048;   // rep * d
constexpr float NEG_INF = -1e30f;

// PER_LANE consecutive bf16 of a row (8, 4 or 2 bytes, aligned) -> float
template <int PER_LANE>
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* p,
                                          float (&f)[PER_LANE]) {
  if constexpr (PER_LANE == 4) {
    uint2 w = *reinterpret_cast<const uint2*>(p);
    __nv_bfloat162 a = *reinterpret_cast<__nv_bfloat162*>(&w.x);
    __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&w.y);
    f[0] = __low2float(a);
    f[1] = __high2float(a);
    f[2] = __low2float(b);
    f[3] = __high2float(b);
  } else if constexpr (PER_LANE == 2) {
    __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(p);
    f[0] = __low2float(a);
    f[1] = __high2float(a);
  } else {
    f[0] = __bfloat162float(*p);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    decode_attention_kernel(const float* __restrict__ q,
                            const __nv_bfloat16* __restrict__ kc,
                            const __nv_bfloat16* __restrict__ vc,
                            const int* __restrict__ lengths,
                            float* __restrict__ out, int T, int KVH, int REP,
                            int bk, float scale) {
  constexpr int PER_LANE = D / 32;     // elements of a row per lane
  constexpr int MAXR = MAX_QELEMS / D; // query rows a block can hold
  __shared__ float qs[MAX_QELEMS];     // [REP][D], scaled
  __shared__ float sc[MAX_SCORES];     // [REP][bk]: scores, then bf16(p);
                                       // at the end [WARPS][REP][D]
  __shared__ float m_s[MAXR], l_s[MAXR], alpha_s[MAXR];
  int g = blockIdx.x;
  int b = blockIdx.y;
  int warp = threadIdx.x >> 5;
  int lane = threadIdx.x & 31;
  int len = lengths[b];
  int nk_max = (T + bk - 1) / bk;
  int nk = len > 0 ? min((len + bk - 1) / bk, nk_max) : 0;

  const float* qb = q + ((size_t)b * KVH + g) * REP * D;
  for (int e = threadIdx.x; e < REP * D; e += THREADS) {
    qs[e] = __fmul_rn(qb[e], scale);
  }
  for (int r = threadIdx.x; r < REP; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.0f;
  }
  float o[MAXR][PER_LANE];             // this warp's partial output
#pragma unroll
  for (int r = 0; r < MAXR; ++r)
#pragma unroll
    for (int e = 0; e < PER_LANE; ++e) o[r][e] = 0.0f;
  __syncthreads();

  size_t row_stride = (size_t)KVH * D;   // elements between time rows
  const __nv_bfloat16* kb = kc + (size_t)b * T * row_stride + (size_t)g * D
                            + lane * PER_LANE;
  const __nv_bfloat16* vb = vc + (size_t)b * T * row_stride + (size_t)g * D
                            + lane * PER_LANE;

  for (int t = 0; t < nk; ++t) {
    int t0 = t * bk;
    int nvalid = min(bk, len - t0);   // >= 1 for a live chunk
    // (1) scores; keys past the slot's length are -1e30
    for (int j0 = warp * U; j0 < bk; j0 += WARPS * U) {
      float kf[U][PER_LANE];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j0 + u < nvalid) {
          load_bf16<PER_LANE>(kb + (size_t)(t0 + j0 + u) * row_stride,
                              kf[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        int j = j0 + u;
        if (j >= bk) break;
        if (j >= nvalid) {
          if (lane == 0) {
            for (int r = 0; r < REP; ++r) sc[r * bk + j] = NEG_INF;
          }
          continue;
        }
        for (int r = 0; r < REP; ++r) {
          const float* qr = qs + r * D + lane * PER_LANE;
          float part = 0.0f;
#pragma unroll
          for (int e = 0; e < PER_LANE; ++e) {
            part = __fadd_rn(part, __fmul_rn(qr[e], kf[u][e]));
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
          }
          if (lane == 0) sc[r * bk + j] = part;
        }
      }
    }
    __syncthreads();
    // (2) online-softmax statistics, one warp per query row
    for (int r = warp; r < REP; r += WARPS) {
      float* srow = sc + r * bk;
      float mb = NEG_INF;
      for (int j = lane; j < bk; j += 32) mb = fmaxf(mb, srow[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off));
      }
      float m_old = m_s[r];
      float m_new = fmaxf(m_old, mb);
      float sum = 0.0f;
      for (int j = lane; j < bk; j += 32) {
        float p = expf(srow[j] - m_new);
        sum = __fadd_rn(sum, p);
        srow[j] = __bfloat162float(__float2bfloat16_rn(p));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
      }
      if (lane == 0) {
        float alpha = expf(m_old - m_new);
        alpha_s[r] = alpha;
        l_s[r] = __fadd_rn(__fmul_rn(l_s[r], alpha), sum);
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    // (3) o = o * alpha + bf16(p) @ V over this warp's valid keys
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      if (r >= REP) break;
      float a = alpha_s[r];
#pragma unroll
      for (int e = 0; e < PER_LANE; ++e) o[r][e] = __fmul_rn(o[r][e], a);
    }
    for (int j0 = warp * U; j0 < nvalid; j0 += WARPS * U) {
      float vf[U][PER_LANE];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j0 + u < nvalid) {
          load_bf16<PER_LANE>(vb + (size_t)(t0 + j0 + u) * row_stride,
                              vf[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        int j = j0 + u;
        if (j >= nvalid) break;
#pragma unroll
        for (int r = 0; r < MAXR; ++r) {
          if (r >= REP) break;
          float p = sc[r * bk + j];
#pragma unroll
          for (int e = 0; e < PER_LANE; ++e) {
            o[r][e] = __fadd_rn(o[r][e], __fmul_rn(p, vf[u][e]));
          }
        }
      }
    }
    __syncthreads();
  }
  // sum the warps' partial outputs, then out = o / max(l, 1e-30)
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    if (r >= REP) break;
#pragma unroll
    for (int e = 0; e < PER_LANE; ++e) {
      sc[(warp * REP + r) * D + lane * PER_LANE + e] = o[r][e];
    }
  }
  __syncthreads();
  float* ob = out + ((size_t)b * KVH + g) * REP * D;
  for (int i = threadIdx.x; i < REP * D; i += THREADS) {
    float sum = sc[i];
    for (int w = 1; w < WARPS; ++w) sum = __fadd_rn(sum, sc[w * REP * D + i]);
    ob[i] = __fdiv_rn(sum, fmaxf(l_s[i / D], 1e-30f));
  }
}

}  // namespace

// q (B, KVH*REP, D) float32; k, v (B, T, KVH, D) bf16; lengths (B) int32;
// out (B, KVH*REP*D) float32; all contiguous. D in {32, 64, 128},
// REP * bk <= 8192 and REP * D <= 2048 (the wrapper checks).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* lengths, void* out, int B, int T,
                                int KVH, int REP, int D, int bk, float scale,
                                void* stream) {
  dim3 grid(KVH, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<const int*>(lengths), static_cast<float*>(out), T, KVH,
        REP, bk, scale);
  };
  switch (D) {
    case 32: args(decode_attention_kernel<32>); break;
    case 64: args(decode_attention_kernel<64>); break;
    case 128: args(decode_attention_kernel<128>); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
