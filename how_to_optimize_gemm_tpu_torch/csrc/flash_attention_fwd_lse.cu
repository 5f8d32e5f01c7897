// flash_attention_fwd_lse: the training forward of causal or non-causal GQA
// self-attention, which also writes the logsumexp of every row for the
// backward. q (B, H, S, D) fp32, k and v (B, KVH, S, D) bf16, out (B, H, S, D)
// fp32, each read or written through its own (b, h, row) element strides with
// the D elements of a row contiguous; lse (B, H, S) fp32, contiguous. Query
// head h attends KV head h / REP (REP = H / KVH); query i sits at position i.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_attention.py, _fwd_kernel_lse
// (via _flash_fwd_lse, flash_attention_train and mha_flash_train;
// models/llama._block for training with flash_train at s >= 512 and d_head 64
// or 128).
//
// Arithmetic (the reference's, key tile by key tile of 64 keys): q times
// scale in fp32, not rounded to bf16 (the reference keeps q in fp32 here,
// unlike the inference kernel); the scores fl(q * scale) . k in fp32, the
// fp32 q split into bf16 hi + lo (two products into one sum, |error| <=
// 2^-17 |q|), times log2(e); keys past S, and for causal keys past the
// query's position, set to -1e30; per tile m_new = max(m, max s),
// alpha = 2^(m - m_new), p = 2^(s - m_new) in fp32 (ex2.approx: the
// reference's exp with log2(e) folded in); l = l * alpha + sum of the fp32
// p; o = o * alpha + bf16(p) @ V accumulated in fp32; out = o / max(l,
// 1e-30) and lse = m ln 2 + log(max(l, 1e-30)), both fp32. Sums run in
// another order than the plain version's
// (ops/attention.flash_attention_fwd_lse_ref at bk = KERNEL_BK_LSE), so the
// two agree to rounding. A causal query tile skips the key tiles wholly past
// its last row. S needs not be a tile multiple: rows and keys past S arrive
// as zeros, and only rows below S are written.
//
// Bound on an H100 SXM at the training shape of the TinyLlama-1.1B soak
// (B 8, H 32, KVH 4, D 64, S 1,024, causal): 3.44e10 FLOPs of the two
// products over the 524,800 query-key pairs of a head, 0.035 ms at the
// 989 TFLOP/s dense bf16 peak, against 144 MB moved (q read and out written
// in fp32, k and v read in bf16, lse written), 0.043 ms at 3.35 TB/s: the
// memory bounds it, the fp32 q and out being most of the bytes. The split of
// q doubles the MMAs of Q K^T, a cost of this kernel and not of the work.
//
// Design: flash_wgmma.cuh's body, as flash_attention.cu's, with the q tile
// copied once a block in fp32 by a tensor map and split by each consumer
// warpgroup in shared memory, in place: no pre-pass launch and no round
// trip through device memory.
#include "flash_wgmma.cuh"

// q, out: fp32; k, v: bf16; rows of D contiguous elements, each 16-byte
// aligned; *_b, *_h, *_s: element strides of batch, head and row (the wrapper
// checks; multiples of 16 bytes). lse: (B, H, S) fp32, contiguous. D in
// {64, 128}, H a multiple of KVH, B, H, S >= 1. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for an unknown D or a tensor map
// the driver refuses).
extern "C" int flash_attention_fwd_lse(const void* q, const void* k,
                                       const void* v, void* out, void* lse,
                                       int B, int H, int KVH, int S, int D,
                                       int causal, int q_b, int q_h, int q_s,
                                       int k_b, int k_h, int k_s, int v_b,
                                       int v_h, int v_s, int o_b, int o_h,
                                       int o_s, float scale, void* stream) {
  using namespace htog::fw;
  Params p{out, static_cast<float*>(lse), S, S, H, H / KVH, causal, o_b, o_h,
           o_s, LOG2E, scale};
  const long long qs[3] = {q_b, q_h, q_s};
  const long long ks[3] = {k_b, k_h, k_s};
  const long long vs[3] = {v_b, v_h, v_s};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64, true>(q, k, v, p, B, KVH, qs, ks, vs, st);
    case 128: return launch<128, true>(q, k, v, p, B, KVH, qs, ks, vs, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
