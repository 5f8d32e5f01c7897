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
// Arithmetic and design: decode_attention.cuh, its split walk
// (decode_attention_split_kernel) instantiated for a bf16 cache: one block
// per (head, slot, split of C chunks), chunks staged by cp.async into a
// shared-memory ring, the splits' partials combined by the last to arrive.
//
// Bound on an H100 SXM: the cache rows that exist, read once. At the
// Llama-2-7B shape (4 slots, T = 4096, 32 heads of 128) with lengths
// (1, 300, 1000, 4096), 5,397 rows x 8 KB of K and of V = 88 MB: 26 us at
// 3.35 TB/s. The design reads only those rows, and spreads them over 736
// blocks there (C = 2 chunks of 128 keys; ops/decode_attention.split_plan)
// instead of the one-block walk's 128, whose slot of 4,096 keys took
// 0.54 ms on an H100 (its one block's loads in flight bound it).
#include "decode_attention.cuh"

// q (B, KVH*REP, D) float32; k, v (B, T, KVH, D) bf16; lengths (B) int32;
// out (B, KVH*REP*D) float32; all contiguous. part (B, KVH, S,
// REP*(D+2)) float32 and count (B, KVH) int32, zero, the workspace
// (S = ceil(ceil(T / bk) / C)); count is zero again after the call. D in
// {32, 64, 128}, REP * bk <= 8192 and REP * D <= 2048 (the wrapper
// checks).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* lengths, void* out, void* part,
                                void* count, int B, int T, int KVH, int REP,
                                int D, int bk, int C, float scale,
                                void* stream) {
  return htog::launch_decode_attention_split<__nv_bfloat16>(
      q, k, nullptr, v, nullptr, lengths, out, part, count, B, KVH, REP, D,
      htog::ContiguousChunks{T, bk}, C, scale, stream);
}
