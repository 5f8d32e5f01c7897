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
// Arithmetic and design: decode_attention.cuh, the template of the
// contiguous kernel, instantiated with the PagedChunks address policy: a
// chunk is one page (bk = PS), chunk t of slot b starts at pool row
// min(table[b, t], NP - 1) * PS, and a slot walks min(ceil(len / PS),
// np_max) pages. The walk, the online softmax and the roundings are the
// contiguous kernel's.
//
// Bound on an H100 SXM: the cache rows that exist, read once. At the
// Llama-2-7B shape (4 slots, 32 heads of 128, page 128) with lengths
// (1, 300, 1000, 4096), 5,397 rows x 8 KB of K and of V = 88 MB: 26 us at
// 3.35 TB/s, as for the contiguous cache. The design reads only the live
// pages: each block walks the live chunks of one (head, slot), reading its
// page number from the table once per chunk.
#include "decode_attention.cuh"

// q (B, KVH*REP, D) float32; k, v (NP, PS, KVH, D) bf16; table (B, np_max)
// int32; lengths (B) int32; out (B, KVH*REP*D) float32; all contiguous.
// D in {32, 64, 128}, REP * PS <= 8192 and REP * D <= 2048 (the wrapper
// checks).
extern "C" int paged_decode_attention(const void* q, const void* k,
                                      const void* v, const void* table,
                                      const void* lengths, void* out, int B,
                                      int NP, int PS, int np_max, int KVH,
                                      int REP, int D, float scale,
                                      void* stream) {
  return htog::launch_decode_attention<__nv_bfloat16>(
      q, k, nullptr, v, nullptr, lengths, out, B, KVH, REP, D,
      htog::PagedChunks{static_cast<const int*>(table), np_max, NP, PS},
      scale, stream);
}
