// flash_attention: causal or non-causal GQA attention forward with an online
// softmax. q (B, H, S, D), k and v (B, KVH, T, D), out (B, H, S, D), all
// bf16, each read or written through its own (b, h, row) element strides
// with the D elements of a row contiguous. Query head h attends KV head
// h / REP (REP = H / KVH); query i sits at position T - S + i.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_attention.py,
// _stream_kernel (via flash_attention, flash_attention_packed and
// mha_flash; models/llama._block for the causal self-attention of a prompt
// of s >= 512 tokens with d_head 64 or 128).
//
// Arithmetic (the reference's, key tile by key tile of 64 keys): the
// scores q . k in fp32 (bf16 products, fp32 sums by the tensor cores), times
// scale * log2(e) in fp32 (q is never pre-scaled and rounded back to bf16);
// keys past T, and for causal keys past the query's position, set to
// -1e30; per tile m_new = max(m, max s), alpha = 2^(m - m_new),
// p = 2^(s - m_new) in fp32 (ex2.approx: the reference's exp with log2(e)
// folded into the scale); l = l * alpha + sum of the fp32 p;
// o = o * alpha + bf16(p) @ V accumulated in fp32; out = bf16(o / max(l,
// 1e-30)). Sums run in another order than the plain version's
// (ops/attention.flash_attention_ref at bk = KERNEL_BK), so the two agree
// to rounding. A causal query tile skips the key tiles wholly past its
// last row's position. S and T need not be tile multiples: rows past S and
// keys past T arrive as zeros, and only rows below S are written.
//
// Bound on an H100 SXM at the Llama-2-7B prefill shape (B 4, H = KVH = 32,
// D 128, S = T = 4096, causal): 5.50e11 FLOPs, 0.556 ms at the 989 TFLOP/s
// dense bf16 peak, against 537 MB (q, k, v read once, out written once),
// 0.160 ms at 3.35 TB/s: the tensor cores bound it, and the exps (1.1e9)
// run beside them on the multifunction units.
//
// Design: flash_wgmma.cuh's body (one block per 128-query tile, head and
// batch; a producer warp copying q, K and V by tensor maps into an
// mbarrier ring; two consumer warpgroups of 64 rows on wgmma, taking turns
// at the tensor cores so that one's softmax overlaps the other's
// products), with bf16 q and a bf16 output written from registers.
#include "flash_wgmma.cuh"

// q, k, v, out: bf16 with the D elements of a row contiguous, every row
// 16-byte aligned; *_b, *_h, *_s: element strides of batch, head and row
// (the wrapper checks; multiples of 8). D in {64, 128}, H a multiple of
// KVH, S <= T when causal, B, H, S >= 1 and T >= 1. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unknown D or a tensor map the driver refuses).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int H, int KVH, int S, int T,
                               int D, int causal, int q_b, int q_h, int q_s,
                               int k_b, int k_h, int k_s, int v_b, int v_h,
                               int v_s, int o_b, int o_h, int o_s, float scale,
                               void* stream) {
  using namespace htog::fw;
  Params p{out, nullptr, S, T, H, H / KVH, causal, o_b, o_h, o_s,
           scale * LOG2E, 1.0f};
  const long long qs[3] = {q_b, q_h, q_s};
  const long long ks[3] = {k_b, k_h, k_s};
  const long long vs[3] = {v_b, v_h, v_s};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64, false>(q, k, v, p, B, KVH, qs, ks, vs, st);
    case 128: return launch<128, false>(q, k, v, p, B, KVH, qs, ks, vs, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
