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
// Arithmetic and design: decode_attention.cuh's split walk
// (decode_attention_split_kernel), instantiated for an int8 cache with the
// PagedChunks address policy (bk = PS; chunk t of slot b at pool row
// min(table[b, t], NP - 1) * PS): one block per (kv head, slot, split of C
// pages), the pages' live rows staged by cp.async into a shared-memory
// ring, the splits' partials combined in split order by the last to
// arrive. Scores (q * D^-0.5) . f32(k) times sk; the PV operand
// bf16(p * sv), p against the split's running max, times f32(v),
// accumulated in fp32. C comes from np_max and PS alone
// (ops/decode_attention.split_plan): at the 7B pool (PS 384, more than a
// split's 256 keys) a split is one page, 11 splits of which 512 blocks are
// live at the smoke's lengths, where the one-block walk before it ran 128
// blocks and its 11-page slot set the time. On an H100 there (chip_smoke's
// check, graph replays): 0.061 ms against the one-block walk's 0.82. The
// per-key scales are read from global memory, 4 bytes of a 32-byte sector
// at KVH 32: a probe that reads one scale a page instead ran 0.057 ms
// (harness/flash_variants.py --group paged, scales_once), so staging them
// would buy at most 6%, and they stay where they are.
//
// Bound on an H100 SXM: the cache rows that exist and their scales, read
// once. At the Llama-2-7B shape (4 slots, 32 heads of 128, page 384) with
// lengths (1, 300, 1000, 4096), 5,397 rows x (4 KB of int8 + 128 B of
// scales) for K and for V = 45 MB: 13.6 us at 3.35 TB/s. np_max * PS may
// pass max_seq (11 pages of 384 = 4,224 rows at 7B); a slot reads only its
// live pages, and of its last page only the rows below its length.
#include "decode_attention.cuh"

// q (B, KVH*REP, D) float32; qk, qv (NP, PS, KVH, D) int8, bases 16-byte
// aligned; sk, sv (NP, PS, KVH) float32; table (B, np_max) int32; lengths
// (B) int32; out (B, KVH*REP*D) float32; all contiguous. part (B, KVH, S,
// REP*(D+2)) float32 and count (B, KVH) int32, zero, the workspace
// (S = ceil(np_max / C)); count is zero again after the call. D in
// {32, 64, 128}, REP * PS <= 8192 and REP * D <= 2048 (the wrapper
// checks).
extern "C" int paged_decode_attention_q8(const void* q, const void* qk,
                                         const void* sk, const void* qv,
                                         const void* sv, const void* table,
                                         const void* lengths, void* out,
                                         void* part, void* count, int B,
                                         int NP, int PS, int np_max, int KVH,
                                         int REP, int D, int C, float scale,
                                         void* stream) {
  return htog::launch_decode_attention_split<int8_t>(
      q, qk, sk, qv, sv, lengths, out, part, count, B, KVH, REP, D,
      htog::PagedChunks{static_cast<const int*>(table), np_max, NP, PS}, C,
      scale, stream);
}
