// The decode-attention kernel templates: the one-block walk shared by
// decode_attention_q8.cu (int8 cache with fp32 scales per (token, head))
// and paged_decode_attention.cu (bf16 pool), and the split walk of
// decode_attention.cu (bf16 cache) and paged_decode_attention_q8.cu (int8
// pool with fp32 scales). Each source states what it replaces and its
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
// The one-block walk (decode_attention_kernel): one block of 128 threads
// (4 warps) per (kv head, slot), walking the slot's live chunks. Per
// chunk: (1) each warp takes keys in runs of U = 4 (four rows in flight);
// a lane reads D/32 elements of a key row in
// one vector load and dots them with the rep queries held in shared
// memory, a shuffle tree sums each score; (2) one warp per query row
// finds the chunk max and the exp-sum and leaves the PV operand in shared
// memory; (3) each warp rescales its partial output by alpha and adds
// p * V over its own keys, a lane owning D/32 columns, again four V rows
// in flight. The four partial outputs are summed once, at the end. Every
// K and V element of a live row is read once, and for int8 each scale
// once. No cp.async staging and no split of long slots across blocks: the
// longest slot sets the time, and a warp keeps 4 rows in flight (the split
// walk below does both).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "int8_mma.cuh"

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
  __host__ __device__ int count() const { return (T + bk - 1) / bk; }
  __device__ size_t row0(int b, int t) const {
    return (size_t)b * T + (size_t)t * bk;
  }
};

struct PagedChunks {
  const int* table;   // (B, np_max) int32
  int np_max, n_pages, bk;   // bk = PS
  __host__ __device__ int count() const { return np_max; }
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

// ------------------------------------------------------------ split walk
//
// decode_attention_split_kernel: the same function and arithmetic, one
// block per (kv head, slot, split), of 128 threads at REP 1 and 256 from
// REP 2 on (launch_split_rep). A split is a fixed run
// of C whole chunks (the host picks C from T and bk alone, never from the
// lengths: ops/decode_attention.split_plan), so the grid's third dimension
// is S = ceil(chunks.count() / C); a split that starts at or past the
// slot's live chunks exits at once. A long slot is walked by many blocks
// at once instead of one.
//
// Staging: each block copies its chunks' K and V rows into a shared-memory
// ring of SPLIT_DEPTH slots of SPLIT_PIECE bytes ("pieces": 64 rows at D
// 128) with cp.async 16-byte copies, in the order it uses them (a chunk's
// K pieces, then its V pieces, then the next chunk's), SPLIT_DEPTH - 1
// pieces in flight while one is used: the next rows' reads overlap this
// piece's scores or p . V. A piece, not a chunk, because a 512-key chunk's
// K and V rows at D 128 are 256 KB, more than a block's shared memory.
// Only rows below the slot's length are copied. Per chunk: the scores of
// each K piece (each warp U keys at a time, their shuffle trees
// interleaved), the online-softmax statistics after its last K piece, then
// p . V over each V piece. Tried on an H100 at the smoke's shapes and
// dropped, each slower at kvh 32: a fourth ring slot, 8 KB pieces five
// deep, the shuffle trees of four query rows interleaved.
//
// Combine: each live split writes its partial (m, l and the unnormalised o
// of its REP query rows) to the workspace `part`, __threadfence, and one
// atomicAdd on count[slot, head]; the split that sees the count reach the
// slot's live splits less one is the last to arrive: it reads every
// partial (through L2), combines them in split order (m = max m_s, l =
// sum l_s exp(m_s - m), o = sum o_s exp(m_s - m)), writes out = o /
// max(l, 1e-30) and resets the count to 0 for the next call and for graph
// replays. The order is fixed, so the output's bits do not depend on which
// split arrives last. A slot with one live split writes out itself; a slot
// of length 0 has none, and split 0 writes its zeros. p is rounded to bf16
// against its split's running max, not the slot's: the same function to
// rounding.
constexpr int SPLIT_PIECE = 16384;   // bytes of a ring slot
constexpr int SPLIT_DEPTH = 3;       // ring slots

// Shared memory of a split block, beside its static arrays: the ring, q
// (REP * D floats) and the scores, sized for REP * bk scores and for the
// warps' partial outputs at the end.
inline int split_smem_bytes(int REP, int D, int bk, int warps) {
  int scores = REP * bk > warps * REP * D ? REP * bk : warps * REP * D;
  return SPLIT_DEPTH * SPLIT_PIECE + 4 * (REP * D + scores);
}

// part (B, KVH, S, REP * (D + 2)) float32, a split's m[REP], l[REP] and
// o[REP][D]; count (B, KVH) int32, 0 between calls.
template <int D, int THREADS, class Elem, class Chunks>
__global__ void __launch_bounds__(THREADS)
    decode_attention_split_kernel(const float* __restrict__ q,
                                  const Elem* __restrict__ kc,
                                  const float* __restrict__ sk,
                                  const Elem* __restrict__ vc,
                                  const float* __restrict__ sv,
                                  const int* __restrict__ lengths,
                                  float* __restrict__ out,
                                  float* __restrict__ part,
                                  int* __restrict__ count, Chunks chunks,
                                  int KVH, int REP, int C, float scale) {
  constexpr bool kScaled = std::is_same<Elem, int8_t>::value;
  constexpr int WARPS = THREADS / 32;
  constexpr int U = ATTN_U;
  constexpr float NEG_INF = ATTN_NEG_INF;
  constexpr int PER_LANE = D / 32;     // elements of a row per lane
  constexpr int MAXR = MAX_QELEMS / D; // query rows a block can hold
  constexpr int ROW_BYTES = D * static_cast<int>(sizeof(Elem));
  constexpr int ROWS = SPLIT_PIECE / ROW_BYTES;  // cache rows a ring slot
  constexpr int CPR = ROW_BYTES / 16;            // 16-byte copies a row
  extern __shared__ __align__(16) uint8_t smem[];
  float* qs = reinterpret_cast<float*>(smem + SPLIT_DEPTH * SPLIT_PIECE);
  float* sc = qs + REP * D;            // [REP][bk]: scores, then the PV
                                       // operand; at the end [WARPS][REP][D]
  __shared__ float m_s[MAXR], l_s[MAXR], alpha_s[MAXR];
  __shared__ int last;
  int g = blockIdx.x;
  int b = blockIdx.y;
  int split = blockIdx.z;
  int warp = threadIdx.x >> 5;
  int lane = threadIdx.x & 31;
  int len = lengths[b];
  const int bk = chunks.bk;
  int nk = len > 0 ? min((len + bk - 1) / bk, chunks.count()) : 0;
  int live = (nk + C - 1) / C;         // live splits of this slot
  float* ob = out + ((size_t)b * KVH + g) * REP * D;
  if (split >= max(live, 1)) return;
  if (live == 0) {
    for (int i = threadIdx.x; i < REP * D; i += THREADS) ob[i] = 0.0f;
    return;
  }
  int c0 = split * C;                  // this split's first chunk
  int P = (bk + ROWS - 1) / ROWS;      // pieces of a chunk's K (or V)
  int npieces = min(C, nk - c0) * 2 * P;

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

  size_t row_stride = (size_t)KVH * D;   // elements between cache rows
  // Piece i: chunk c0 + i / (2P); K for i % 2P < P, else V; rows
  // (i % P) * ROWS .. of the chunk's valid rows.
  auto issue = [&](int i) {
    if (i < npieces) {
      int c = c0 + i / (2 * P);
      int h = i % (2 * P);
      int r0 = (h % P) * ROWS;
      int r1 = min(r0 + ROWS, min(bk, len - c * bk));
      const uint8_t* src = reinterpret_cast<const uint8_t*>(
          (h < P ? kc : vc) + chunks.row0(b, c) * row_stride + (size_t)g * D);
      uint8_t* dst = smem + (i % SPLIT_DEPTH) * SPLIT_PIECE;
      for (int x = threadIdx.x; x < (r1 - r0) * CPR; x += THREADS) {
        int r = x / CPR;
        int off = (x % CPR) * 16;
        cp_async16(dst + r * ROW_BYTES + off,
                   src + (size_t)(r0 + r) * row_stride * sizeof(Elem) + off,
                   true);
      }
    }
    cp_async_commit();   // an empty group past the last piece
  };
#pragma unroll
  for (int i = 0; i < SPLIT_DEPTH - 1; ++i) issue(i);

  for (int i = 0; i < npieces; ++i) {
    cp_async_wait<SPLIT_DEPTH - 2>();  // this thread's copies of piece i
    __syncthreads();                   // everyone's; piece i - 1 used
    issue(i + SPLIT_DEPTH - 1);
    int c = c0 + i / (2 * P);
    int h = i % (2 * P);
    int nvalid = min(bk, len - c * bk);   // >= 1 for a live chunk
    int r0 = (h % P) * ROWS;
    int r1 = min(r0 + ROWS, nvalid);
    const Elem* rows = reinterpret_cast<const Elem*>(
        smem + (i % SPLIT_DEPTH) * SPLIT_PIECE) + lane * PER_LANE;
    // scale of (cache row r0 + j, head g) at scale_b[j * KVH]
    size_t scale_b = chunks.row0(b, c) * KVH + g;
    if (h < P) {
      // (1) scores of keys r0 .. r1 - 1
      for (int j0 = r0 + warp * U; j0 < r1; j0 += WARPS * U) {
        float kf[U][PER_LANE];
        float s_k[U];   // the keys' scales
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int e = 0; e < PER_LANE; ++e) kf[u][e] = 0.0f;
          if (j0 + u < r1) {
            load_row<PER_LANE>(rows + (size_t)(j0 + u - r0) * D, kf[u]);
            if constexpr (kScaled) {
              s_k[u] = sk[scale_b + (size_t)(j0 + u) * KVH];
            }
          }
        }
        for (int r = 0; r < REP; ++r) {
          const float* qr = qs + r * D + lane * PER_LANE;
          float part_u[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            part_u[u] = 0.0f;
#pragma unroll
            for (int e = 0; e < PER_LANE; ++e) {
              part_u[u] = __fadd_rn(part_u[u], __fmul_rn(qr[e], kf[u][e]));
            }
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
            for (int u = 0; u < U; ++u) {
              part_u[u] = __fadd_rn(
                  part_u[u], __shfl_xor_sync(0xffffffffu, part_u[u], off));
            }
          }
          if (lane == 0) {
#pragma unroll
            for (int u = 0; u < U; ++u) {
              if (j0 + u >= r1) break;
              float v = part_u[u];
              if constexpr (kScaled) v = __fmul_rn(v, s_k[u]);
              sc[r * bk + j0 + u] = v;
            }
          }
        }
      }
      if (h == P - 1) {
        __syncthreads();
        // (2) online-softmax statistics over the chunk's valid keys, one
        // warp per query row
        for (int r = warp; r < REP; r += WARPS) {
          float* srow = sc + r * bk;
          float mb = NEG_INF;
          for (int j = lane; j < nvalid; j += 32) mb = fmaxf(mb, srow[j]);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off));
          }
          float m_old = m_s[r];
          float m_new = fmaxf(m_old, mb);
          float sum = 0.0f;
          for (int j = lane; j < nvalid; j += 32) {
            float p = expf(srow[j] - m_new);
            sum = __fadd_rn(sum, p);
            float operand = p;
            if constexpr (kScaled) {
              operand = __fmul_rn(p, sv[scale_b + (size_t)j * KVH]);
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
#pragma unroll
        for (int r = 0; r < MAXR; ++r) {
          if (r >= REP) break;
          float a = alpha_s[r];
#pragma unroll
          for (int e = 0; e < PER_LANE; ++e) o[r][e] = __fmul_rn(o[r][e], a);
        }
      }
    } else {
      // (3) o += operand @ V over this warp's keys of the piece
      for (int j0 = r0 + warp * U; j0 < r1; j0 += WARPS * U) {
        float vf[U][PER_LANE];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (j0 + u < r1) {
            load_row<PER_LANE>(rows + (size_t)(j0 + u - r0) * D, vf[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          int j = j0 + u;
          if (j >= r1) break;
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
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  // the warps' partial outputs, summed in warp order
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    if (r >= REP) break;
#pragma unroll
    for (int e = 0; e < PER_LANE; ++e) {
      sc[(warp * REP + r) * D + lane * PER_LANE + e] = o[r][e];
    }
  }
  __syncthreads();
  if (live == 1) {
    for (int i = threadIdx.x; i < REP * D; i += THREADS) {
      float sum = sc[i];
      for (int w = 1; w < WARPS; ++w) {
        sum = __fadd_rn(sum, sc[w * REP * D + i]);
      }
      ob[i] = __fdiv_rn(sum, fmaxf(l_s[i / D], 1e-30f));
    }
    return;
  }
  const int rec = REP * (D + 2);       // a split's floats in `part`
  const int S = (chunks.count() + C - 1) / C;
  float* pb = part + ((size_t)b * KVH + g) * S * rec;
  float* mine = pb + (size_t)split * rec;
  for (int i = threadIdx.x; i < REP * D; i += THREADS) {
    float sum = sc[i];
    for (int w = 1; w < WARPS; ++w) sum = __fadd_rn(sum, sc[w * REP * D + i]);
    mine[2 * REP + i] = sum;
  }
  for (int r = threadIdx.x; r < REP; r += THREADS) {
    mine[r] = m_s[r];
    mine[REP + r] = l_s[r];
  }
  __threadfence();   // the partial is visible before the count moves
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(&count[(size_t)b * KVH + g], 1) == live - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last split: every partial, in split order
  for (int r = threadIdx.x; r < REP; r += THREADS) {
    float m = NEG_INF;
    for (int s = 0; s < live; ++s) m = fmaxf(m, __ldcg(pb + s * rec + r));
    float l = 0.0f;
    for (int s = 0; s < live; ++s) {
      l = __fadd_rn(l, __fmul_rn(__ldcg(pb + s * rec + REP + r),
                                 expf(__ldcg(pb + s * rec + r) - m)));
    }
    m_s[r] = m;
    l_s[r] = l;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < REP * D; i += THREADS) {
    int r = i / D;
    float sum = 0.0f;
    for (int s = 0; s < live; ++s) {
      sum = __fadd_rn(sum, __fmul_rn(__ldcg(pb + s * rec + 2 * REP + i),
                                     expf(__ldcg(pb + s * rec + r) - m_s[r])));
    }
    ob[i] = __fdiv_rn(sum, fmaxf(l_s[r], 1e-30f));
  }
  if (threadIdx.x == 0) count[(size_t)b * KVH + g] = 0;
}

// Internal linkage: a template's function-local static is one object for
// the whole process (STB_GNU_UNIQUE) when it has external linkage, so two
// kernel libraries instantiating the same launcher would share `configured`.
template <int D, int THREADS, class Elem, class Chunks>
static int launch_split_d(dim3 grid, int REP, cudaStream_t s, const void* q,
                          const void* k, const void* sk, const void* v,
                          const void* sv, const void* lengths, void* out,
                          void* part, void* count, Chunks chunks, int KVH,
                          int C, float scale) {
  auto kernel = decode_attention_split_kernel<D, THREADS, Elem, Chunks>;
  int bytes = split_smem_bytes(REP, D, chunks.bk, THREADS / 32);
  static int configured = 0;   // the dynamic shared memory allowed so far
  if (bytes > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = bytes;
  }
  kernel<<<grid, THREADS, bytes, s>>>(
      static_cast<const float*>(q), static_cast<const Elem*>(k),
      static_cast<const float*>(sk), static_cast<const Elem*>(v),
      static_cast<const float*>(sv), static_cast<const int*>(lengths),
      static_cast<float*>(out), static_cast<float*>(part),
      static_cast<int*>(count), chunks, KVH, REP, C, scale);
  return static_cast<int>(cudaGetLastError());
}

// The block's threads: 128 at REP 1 (a split's 256 keys of short chunks;
// three blocks an SM fit the registers, and the 7B shape has 736 live
// blocks), 256 from REP 2 on (GQA: 512-key chunks and few blocks, whose
// four warps alone leave their shuffle trees' latency exposed). On an
// H100 at the smoke's shapes each was the faster at its own REP and the
// slower at the other's.
template <int D, class Elem, class Chunks>
static int launch_split_rep(dim3 grid, int REP, cudaStream_t s,
                            const void* q, const void* k, const void* sk,
                            const void* v, const void* sv,
                            const void* lengths, void* out, void* part,
                            void* count, Chunks chunks, int KVH, int C,
                            float scale) {
  auto launch = REP > 1 ? launch_split_d<D, 256, Elem, Chunks>
                        : launch_split_d<D, 128, Elem, Chunks>;
  return launch(grid, REP, s, q, k, sk, v, sv, lengths, out, part, count,
                chunks, KVH, C, scale);
}

// Launch over grid (KVH, B, S), S = ceil(chunks.count() / C), on
// ``stream``; D in {32, 64, 128}, REP * bk <= 8192 and REP * D <= 2048
// (the wrappers check); part and count as the kernel states. Returns the
// launch error.
template <class Elem, class Chunks>
int launch_decode_attention_split(const void* q, const void* k,
                                  const void* sk, const void* v,
                                  const void* sv, const void* lengths,
                                  void* out, void* part, void* count, int B,
                                  int KVH, int REP, int D, Chunks chunks,
                                  int C, float scale, void* stream) {
  dim3 grid(KVH, B, (chunks.count() + C - 1) / C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_split_rep<32, Elem>(grid, REP, s, q, k, sk, v, sv,
                                        lengths, out, part, count, chunks,
                                        KVH, C, scale);
    case 64:
      return launch_split_rep<64, Elem>(grid, REP, s, q, k, sk, v, sv,
                                        lengths, out, part, count, chunks,
                                        KVH, C, scale);
    case 128:
      return launch_split_rep<128, Elem>(grid, REP, s, q, k, sk, v, sv,
                                         lengths, out, part, count, chunks,
                                         KVH, C, scale);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace htog
