// The decode-attention kernel template shared by decode_attention.cu (bf16
// cache), decode_attention_q8.cu (int8 cache with fp32 scales per (token,
// head)) and their paged forms paged_decode_attention.cu and
// paged_decode_attention_q8.cu. Each source states what it replaces and its
// bound.
//
// q (B, KVH*REP, D) float32, head h = g*REP + r; the cache rows (R, KVH, D),
// bf16 or int8; for int8, sk and sv (R, KVH) float32; lengths (B) int32,
// the valid cache rows of each slot; out (B, KVH*REP*D) float32. D in
// {32, 64, 128}. Key j of chunk t of slot b lives in cache row
// chunks.row0(b, t) + j, the policy being where the sources differ:
// - ContiguousChunks: a time-major (B, T, KVH, D) cache, R = B*T, row
//   b*T + t*bk + j, ceil(T / bk) chunks;
// - PagedChunks: a page pool (NP, PS, KVH, D), R = NP*PS, bk = PS, row
//   min(table[b*np_max + t], NP - 1) * PS + j (the reference's clamp),
//   np_max chunks. A chunk is one page.
//
// Arithmetic (the reference's, chunk by chunk): q in fp32 times D^-0.5;
// K cast to fp32; fp32 scores, times sk[t, g] for an int8 cache; keys at
// positions >= len set to -1e30; an online softmax in fp32 over chunks of
// bk keys (m_new = max(m, max s), alpha = exp(m - m_new),
// p = exp(s - m_new), l = l * alpha + sum p); the PV operand is p rounded
// to bf16 (for int8: p * sv[t, g] rounded to bf16), times V cast to fp32,
// accumulated in fp32; o = o * alpha + pv; out = o / max(l, 1e-30). Only
// min(ceil(len / bk), chunks.count()) chunks of a slot are read, and a slot
// of length 0 outputs 0. Sums are taken in another order than the plain
// version's, so the two agree to rounding.
//
// Design: one block of 128 threads (4 warps) per (kv head, slot), walking
// the slot's live chunks. Per chunk: (1) each warp takes keys in runs of
// U = 4 (four rows in flight); a lane reads D/32 elements of a key row in
// one vector load and dots them with the rep queries held in shared
// memory, a shuffle tree sums each score; (2) one warp per query row
// finds the chunk max and the exp-sum and leaves the PV operand in shared
// memory; (3) each warp rescales its partial output by alpha and adds
// p * V over its own keys, a lane owning D/32 columns, again four V rows
// in flight. The four partial outputs are summed once, at the end. Every
// K and V element of a live row is read once, and for int8 each scale
// once. Simple first version: no cp.async staging, no split of long slots
// across blocks (one block per (head, slot) leaves SMs idle when B * KVH
// is small).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace htog {

constexpr int ATTN_THREADS = 128;
constexpr int ATTN_WARPS = ATTN_THREADS / 32;
constexpr int ATTN_U = 4;              // key rows in flight per warp
constexpr int MAX_SCORES = 8192;       // rep * bk, and WARPS * rep * D
constexpr int MAX_QELEMS = 2048;       // rep * d
constexpr float ATTN_NEG_INF = -1e30f;

// Where each chunk of a slot starts among the cache rows.
struct ContiguousChunks {
  int T, bk;
  __device__ int count() const { return (T + bk - 1) / bk; }
  __device__ size_t row0(int b, int t) const {
    return (size_t)b * T + (size_t)t * bk;
  }
};

struct PagedChunks {
  const int* table;   // (B, np_max) int32
  int np_max, n_pages, bk;   // bk = PS
  __device__ int count() const { return np_max; }
  __device__ size_t row0(int b, int t) const {
    return (size_t)min(table[(size_t)b * np_max + t], n_pages - 1) * bk;
  }
};

// PER_LANE consecutive elements of a cache row (aligned) -> float
template <int PER_LANE>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
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

template <int PER_LANE>
__device__ __forceinline__ void load_row(const int8_t* p,
                                         float (&f)[PER_LANE]) {
  if constexpr (PER_LANE == 4) {
    uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      f[e] = static_cast<float>(static_cast<int8_t>(w >> (8 * e)));
    }
  } else if constexpr (PER_LANE == 2) {
    uint16_t w = *reinterpret_cast<const uint16_t*>(p);
    f[0] = static_cast<float>(static_cast<int8_t>(w));
    f[1] = static_cast<float>(static_cast<int8_t>(w >> 8));
  } else {
    f[0] = static_cast<float>(*p);
  }
}

// Elem: __nv_bfloat16, or int8_t with the scales sk, sv (null for bf16).
// Chunks: ContiguousChunks or PagedChunks.
template <int D, class Elem, class Chunks>
__global__ void __launch_bounds__(ATTN_THREADS)
    decode_attention_kernel(const float* __restrict__ q,
                            const Elem* __restrict__ kc,
                            const float* __restrict__ sk,
                            const Elem* __restrict__ vc,
                            const float* __restrict__ sv,
                            const int* __restrict__ lengths,
                            float* __restrict__ out, Chunks chunks, int KVH,
                            int REP, float scale) {
  constexpr bool kScaled = std::is_same<Elem, int8_t>::value;
  constexpr int THREADS = ATTN_THREADS;
  constexpr int WARPS = ATTN_WARPS;
  constexpr int U = ATTN_U;
  constexpr float NEG_INF = ATTN_NEG_INF;
  constexpr int PER_LANE = D / 32;     // elements of a row per lane
  constexpr int MAXR = MAX_QELEMS / D; // query rows a block can hold
  __shared__ float qs[MAX_QELEMS];     // [REP][D], scaled
  __shared__ float sc[MAX_SCORES];     // [REP][bk]: scores, then the PV
                                       // operand; at the end [WARPS][REP][D]
  __shared__ float m_s[MAXR], l_s[MAXR], alpha_s[MAXR];
  int g = blockIdx.x;
  int b = blockIdx.y;
  int warp = threadIdx.x >> 5;
  int lane = threadIdx.x & 31;
  int len = lengths[b];
  const int bk = chunks.bk;
  int nk = len > 0 ? min((len + bk - 1) / bk, chunks.count()) : 0;

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

  size_t row_stride = (size_t)KVH * D;   // elements between cache rows
  const Elem* kg = kc + (size_t)g * D + lane * PER_LANE;
  const Elem* vg = vc + (size_t)g * D + lane * PER_LANE;

  for (int t = 0; t < nk; ++t) {
    int t0 = t * bk;
    int nvalid = min(bk, len - t0);   // >= 1 for a live chunk
    size_t r0 = chunks.row0(b, t);    // the chunk's first cache row
    const Elem* kb = kg + r0 * row_stride;
    const Elem* vb = vg + r0 * row_stride;
    // scale of (cache row r0 + j, head g) at scale_b[j * KVH]
    size_t scale_b = r0 * KVH + g;
    // (1) scores; keys past the slot's length are -1e30
    for (int j0 = warp * U; j0 < bk; j0 += WARPS * U) {
      float kf[U][PER_LANE];
      float s_k[U];   // the keys' scales, loaded beside their rows
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j0 + u < nvalid) {
          load_row<PER_LANE>(kb + (size_t)(j0 + u) * row_stride, kf[u]);
          if constexpr (kScaled) {
            s_k[u] = sk[scale_b + (size_t)(j0 + u) * KVH];
          }
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
          if constexpr (kScaled) part = __fmul_rn(part, s_k[u]);
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
        float operand = p;
        if constexpr (kScaled) {
          // rows past the length are never read (their p is 0)
          operand = j < nvalid
              ? __fmul_rn(p, sv[scale_b + (size_t)j * KVH]) : 0.0f;
        }
        srow[j] = __bfloat162float(__float2bfloat16_rn(operand));
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
    // (3) o = o * alpha + operand @ V over this warp's valid keys
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
          load_row<PER_LANE>(vb + (size_t)(j0 + u) * row_stride, vf[u]);
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

// Launch over grid (KVH, B) on ``stream``; D in {32, 64, 128}, REP * bk <=
// 8192 and REP * D <= 2048 (the wrappers check). Returns the launch error.
template <class Elem, class Chunks>
int launch_decode_attention(const void* q, const void* k, const void* sk,
                            const void* v, const void* sv,
                            const void* lengths, void* out, int B, int KVH,
                            int REP, int D, Chunks chunks, float scale,
                            void* stream) {
  dim3 grid(KVH, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<grid, ATTN_THREADS, 0, s>>>(
        static_cast<const float*>(q), static_cast<const Elem*>(k),
        static_cast<const float*>(sk), static_cast<const Elem*>(v),
        static_cast<const float*>(sv), static_cast<const int*>(lengths),
        static_cast<float*>(out), chunks, KVH, REP, scale);
  };
  switch (D) {
    case 32: args(decode_attention_kernel<32, Elem, Chunks>); break;
    case 64: args(decode_attention_kernel<64, Elem, Chunks>); break;
    case 128: args(decode_attention_kernel<128, Elem, Chunks>); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace htog
