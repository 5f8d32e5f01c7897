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
// Arithmetic and design: decode_attention.cuh (the template this file
// instantiates for a bf16 cache).
//
// Bound on an H100 SXM: the cache rows that exist, read once. At the
// Llama-2-7B shape (4 slots, T = 4096, 32 heads of 128) with lengths
// (1, 300, 1000, 4096), 5,397 rows x 8 KB of K and of V = 88 MB: 26 us at
// 3.35 TB/s. The design reads only those rows: each block walks the live
// chunks of one (head, slot).
#include "decode_attention.cuh"

// q (B, KVH*REP, D) float32; k, v (B, T, KVH, D) bf16; lengths (B) int32;
// out (B, KVH*REP*D) float32; all contiguous. D in {32, 64, 128},
// REP * bk <= 8192 and REP * D <= 2048 (the wrapper checks).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* lengths, void* out, int B, int T,
                                int KVH, int REP, int D, int bk, float scale,
                                void* stream) {
  return htog::launch_decode_attention<__nv_bfloat16>(
      q, k, nullptr, v, nullptr, lengths, out, B, KVH, REP, D,
      htog::ContiguousChunks{T, bk}, scale, stream);
}
