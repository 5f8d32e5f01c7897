// decode_attention_q8: length-aware single-query GQA attention over a
// contiguous time-major int8 KV cache (KV8) with fp32 scales per (token,
// head).
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_decode_attention.py,
// _kernel_q8_v3 (per-slot, wide MHA) and _kernel_q8_v4 (fused-head, GQA
// widths; via decode_attention_q8; models/llama._block at s == 1 on a KV8
// cache). Their head-pairing view and one-hot selector dot are TPU lane
// tricks; one kernel serves every width here. q (B, KVH*REP, D) float32;
// qk, qv (B, T, KVH, D) int8; sk, sv (B, T, KVH) float32 (no lane
// padding); lengths (B) int32; out (B, KVH*REP*D) float32.
//
// Arithmetic and design: decode_attention.cuh's split walk
// (decode_attention_split_kernel), instantiated for an int8 cache with the
// ContiguousChunks address policy, as decode_attention.cu runs it for bf16
// and paged_decode_attention_q8.cu for the KV8 pool: one block per (kv
// head, slot, split of C chunks), the chunks' live rows staged by cp.async
// into a shared-memory ring, the splits' partials combined in split order
// by the last to arrive. Scores (q * D^-0.5) . f32(k) times sk[t, g]; the
// PV operand bf16(p * sv[t, g]), p against the split's running max, times
// f32(v) (int8 values are exact in bf16), accumulated in fp32. C comes from
// T and bk alone (ops/decode_attention.split_plan): at the 7B cache (bk 256
// for a 1-byte cache at kvh 32) a split is one chunk, 16 splits of which
// 736 blocks are live at the smoke's lengths, where the one-block walk
// before it ran 128 blocks and its 4,096-row slot set the time (0.7697 ms
// on an H100, chip_smoke's check).
//
// Bound on an H100 SXM: the cache rows that exist and their scales, read
// once. At the Llama-2-7B shape (4 slots, T = 4096, 32 heads of 128) with
// lengths (1, 300, 1000, 4096), 5,397 rows x (4 KB of int8 + 128 B of
// scales) for K and for V = 45 MB: 13.6 us at 3.35 TB/s, half the bf16
// cache's 26 us.
#include "decode_attention.cuh"

// q (B, KVH*REP, D) float32; qk, qv (B, T, KVH, D) int8, bases 16-byte
// aligned; sk, sv (B, T, KVH) float32; lengths (B) int32; out
// (B, KVH*REP*D) float32; all contiguous. part (B, KVH, S, REP*(D+2))
// float32 and count (B, KVH) int32, zero, the workspace
// (S = ceil(ceil(T / bk) / C)); count is zero again after the call. D in
// {32, 64, 128}, REP * bk <= 8192 and REP * D <= 2048 (the wrapper
// checks).
extern "C" int decode_attention_q8(const void* q, const void* qk,
                                   const void* sk, const void* qv,
                                   const void* sv, const void* lengths,
                                   void* out, void* part, void* count, int B,
                                   int T, int KVH, int REP, int D, int bk,
                                   int C, float scale, void* stream) {
  return htog::launch_decode_attention_split<int8_t>(
      q, qk, sk, qv, sv, lengths, out, part, count, B, KVH, REP, D,
      htog::ContiguousChunks{T, bk}, C, scale, stream);
}
