// paged_decode_attention: length-aware single-query GQA attention over a
// paged bf16 KV pool, each slot's chunks looked up through its block table.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_paged_attention.py,
// _kernel_v4_paged (fused-head, GQA widths) and _kernel_v3_paged (per-slot,
// wide MHA): one function at two TPU widths, one kernel here (via
// paged_decode_attention; models/llama._block at s == 1 over a paged
// cache). q (B, KVH*REP, D) float32; k, v pools (NP, PS, KVH, D) bf16, page
// 0 the trash page; table (B, np_max) int32, the physical page of each
// chunk of each slot (unallocated entries 0); lengths (B) int32; out
// (B, KVH*REP*D) float32.
//
// Arithmetic and design: decode_attention.cuh's split walk
// (decode_attention_split_kernel), instantiated for a bf16 cache with the
// PagedChunks address policy (bk = PS; chunk t of slot b at pool row
// min(table[b, t], NP - 1) * PS), as paged_decode_attention_q8.cu is for
// the KV8 pool: one block per (kv head, slot, split of C pages), the
// pages' live rows staged by cp.async into a shared-memory ring, the
// splits' partials combined in split order by the last to arrive. C comes
// from np_max and PS alone (ops/paged_attention.paged_split_plan): at the
// 7B pool (PS 128, np_max 32) a split is two pages, 16 splits, the
// contiguous bf16 kernel's 256-key split on the same logical cache. The
// PV operand is p rounded to bf16 against its split's running max: the
// plain version's function to rounding.
//
// Bound on an H100 SXM: the cache rows that exist, read once. At the
// Llama-2-7B shape (4 slots, 32 heads of 128, page 128) with lengths
// (1, 300, 1000, 4096), 5,397 rows x 8 KB of K and of V = 88 MB: 26 us at
// 3.35 TB/s, as for the contiguous cache. A slot reads only its live
// pages, and of its last page only the rows below its length.
#include "decode_attention.cuh"

// q (B, KVH*REP, D) float32; k, v (NP, PS, KVH, D) bf16, bases 16-byte
// aligned; table (B, np_max) int32; lengths (B) int32; out (B, KVH*REP*D)
// float32; all contiguous. part (B, KVH, S, REP*(D+2)) float32 and count
// (B, KVH) int32, zero, the workspace (S = ceil(np_max / C)); count is
// zero again after the call. D in {32, 64, 128}, REP * PS <= 8192 and
// REP * D <= 2048 (the wrapper checks).
extern "C" int paged_decode_attention(const void* q, const void* k,
                                      const void* v, const void* table,
                                      const void* lengths, void* out,
                                      void* part, void* count, int B, int NP,
                                      int PS, int np_max, int KVH, int REP,
                                      int D, int C, float scale,
                                      void* stream) {
  return htog::launch_decode_attention_split<__nv_bfloat16>(
      q, k, nullptr, v, nullptr, lengths, out, part, count, B, KVH, REP, D,
      htog::PagedChunks{static_cast<const int*>(table), np_max, NP, PS}, C,
      scale, stream);
}
