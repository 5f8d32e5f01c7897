// paged_decode_attention_q8: length-aware single-query GQA attention over a
// paged int8 KV pool (KV8) with fp32 scales per (token, head), each slot's
// chunks looked up through its block table.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_paged_attention.py,
// _kernel_q8_v4_paged (fused-head, GQA widths) and _kernel_q8_v3_paged
// (per-slot, wide MHA; via paged_decode_attention_q8; models/llama._block
// at s == 1 over a KV8 paged cache). Their one-hot selector dot and
// head-pairing view are TPU lane tricks; one kernel serves every width
// here. q (B, KVH*REP, D) float32; qk, qv pools (NP, PS, KVH, D) int8; sk,
// sv pools (NP, PS, KVH) float32 (no lane padding); table (B, np_max)
// int32; lengths (B) int32; out (B, KVH*REP*D) float32.
//
// Arithmetic and design: decode_attention.cuh, instantiated for an int8
// cache with the PagedChunks address policy (bk = PS; chunk t of slot b at
// pool row min(table[b, t], NP - 1) * PS): scores (q * D^-0.5) . f32(k)
// times sk; the PV operand bf16(p * sv) times f32(v), accumulated in fp32.
//
// Bound on an H100 SXM: the cache rows that exist and their scales, read
// once. At the Llama-2-7B shape (4 slots, 32 heads of 128, page 384) with
// lengths (1, 300, 1000, 4096), 5,397 rows x (4 KB of int8 + 128 B of
// scales) for K and for V = 45 MB: 13.6 us at 3.35 TB/s. np_max * PS may
// pass max_seq (11 pages of 384 = 4,224 rows at 7B); a slot reads only its
// live pages.
#include "decode_attention.cuh"

// q (B, KVH*REP, D) float32; qk, qv (NP, PS, KVH, D) int8; sk, sv
// (NP, PS, KVH) float32; table (B, np_max) int32; lengths (B) int32; out
// (B, KVH*REP*D) float32; all contiguous. D in {32, 64, 128},
// REP * PS <= 8192 and REP * D <= 2048 (the wrapper checks).
extern "C" int paged_decode_attention_q8(const void* q, const void* qk,
                                         const void* sk, const void* qv,
                                         const void* sv, const void* table,
                                         const void* lengths, void* out,
                                         int B, int NP, int PS, int np_max,
                                         int KVH, int REP, int D,
                                         float scale, void* stream) {
  return htog::launch_decode_attention<int8_t>(
      q, qk, sk, qv, sv, lengths, out, B, KVH, REP, D,
      htog::PagedChunks{static_cast<const int*>(table), np_max, NP, PS},
      scale, stream);
}
