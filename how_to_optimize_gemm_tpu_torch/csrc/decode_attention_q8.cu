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
// Arithmetic and design: decode_attention.cuh, instantiated for an int8
// cache: scores (q * D^-0.5) . f32(k) times sk[t, g]; the PV operand
// bf16(p * sv[t, g]) times f32(v) (int8 values are exact in bf16),
// accumulated in fp32.
//
// Bound on an H100 SXM: the cache rows that exist and their scales, read
// once. At the Llama-2-7B shape (4 slots, T = 4096, 32 heads of 128) with
// lengths (1, 300, 1000, 4096), 5,397 rows x (4 KB of int8 + 128 B of
// scales) for K and for V = 45 MB: 13 us at 3.35 TB/s, half the bf16
// cache's 26 us. The design reads only those rows: each block walks the
// live chunks of one (head, slot), a lane loading 4 int8 values of a row
// in one 32-bit load.
#include "decode_attention.cuh"

// q (B, KVH*REP, D) float32; qk, qv (B, T, KVH, D) int8; sk, sv (B, T, KVH)
// float32; lengths (B) int32; out (B, KVH*REP*D) float32; all contiguous.
// D in {32, 64, 128}, REP * bk <= 8192 and REP * D <= 2048 (the wrapper
// checks).
extern "C" int decode_attention_q8(const void* q, const void* qk,
                                   const void* sk, const void* qv,
                                   const void* sv, const void* lengths,
                                   void* out, int B, int T, int KVH, int REP,
                                   int D, int bk, float scale, void* stream) {
  return htog::launch_decode_attention<int8_t>(
      q, qk, sk, qv, sv, lengths, out, B, KVH, REP, D,
      htog::ContiguousChunks{T, bk}, scale, stream);
}
