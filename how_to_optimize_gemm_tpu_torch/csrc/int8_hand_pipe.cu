// Rung 17 int8_hand_pipe_nt: C = f32(QA @ QBT^T as int32) * sa[i] * sb[j] +
// C, in place on C, B packed transposed (N, K): rung 14's arithmetic under
// a hand-scheduled, warp-specialised stream pipeline with the reference's
// two schedule knobs.
//
// Replaces: how_to_optimize_gemm_tpu/ops/pallas_emit_pipeline.py, the
// pallas_call's `kernel` and its pipeline body `_scaled_body` (via
// mmult_q_bt_hand, rung 17_hand_pipeline_int8): rung 14's arithmetic with
// the stream schedule emitted by hand (emit_pipeline), b_buffers B^T
// buffers and, with a_lookahead, the A stream fetching into the next block.
//
// Bound on an H100 SXM at M = N = K = 4096: 1.37e11 int operations (69 us
// at the 1,979 TOP/s dense int8 peak) against 168 MB (50 us at 3.35 TB/s):
// the tensor cores bound it.
//
// Design. K2's kernel (gemm_wgmma.cuh's int8 instance, int8_gemm_nt.cu)
// already is a hand-scheduled, warp-specialised ring: one producer thread
// issues every tensor-map copy of a stage (a 128-row QA box and a 256-row
// QBT box of 128 K bytes, 48 KB) into the ring, two consumer warpgroups
// take wgmma.m64n256k32 products from it and release each slot on its
// empty barrier, a persistent grid walking 128 x 256 tiles in groups of
// row tiles, C added in place by tensor-map reductions. Rung 17 is that
// body with the two knobs exposed, one instance each (the switch below):
// - b_buffers (2, 3, 4) is the ring's depth ST: stages in flight;
// - a_lookahead = true lets the producer run on into the next tile's stages
//   while the consumers finish this tile (K2's schedule); false makes it
//   wait, before each tile's first stage after the block's first tile, on
//   a `done` barrier on which both consumer warpgroups arrive once their
//   flush has been issued, so the ring empties at every tile start.
// b_buffers 4 with a_lookahead is exactly K2. The int32 sums are exact and
// the epilogue is K2's, so every instance's output is bit for bit
// int8_gemm_nt's.
#include "gemm_wgmma.cuh"

namespace htog {

template <int NB, bool LA>
struct Rung17 {
  static constexpr int BN = 256;         // output columns a tile
  static constexpr int CH = 0;           // stages a partial sum (0: one sum)
  static constexpr int ST = NB;          // stages of the ring: b_buffers
  static constexpr int PRODUCTS = 1;
  static constexpr bool B_MN = false;
  static constexpr bool SEED_C = false;
  static constexpr bool S8 = true;       // int8 operands, int32 sums
  static constexpr bool LOOKAHEAD = LA;  // a_lookahead
};

}  // namespace htog

namespace {

template <int NB, bool LA>
int launch_knobs(const CUtensorMap& ta, const CUtensorMap& tb, const void* c,
                 void* out, const void* sa, const void* sb, int M, int N,
                 int K, int ldc, cudaStream_t stream) {
  using namespace htog;
  using P = Rung17<NB, LA>;
  gw::GroupWalk<P::BN> walk{(M + gw::BM - 1) / gw::BM,
                            (N + P::BN - 1) / P::BN};
  return gw::launch<P>(ta, tb, c, out, sa, sb, M, N, K, ldc, walk, stream);
}

}  // namespace

// As int8_gemm_nt (K, lda and ldb multiples of 16, the int8 bases 16-byte
// aligned, c and out the same buffer), plus b_buffers 2, 3 or 4 and
// a_lookahead 0 or 1. Returns a cudaError_t (cudaErrorInvalidValue for
// another knob or a tensor map the CUDA driver refuses).
extern "C" int int8_hand_pipe_nt(const void* qa, const void* qbt,
                                 const void* sa, const void* sb, const void* c,
                                 void* out, int M, int N, int K, int lda,
                                 int ldb, int ldc, int b_buffers,
                                 int a_lookahead, void* stream) {
  using namespace htog;
  CUtensorMap ta, tb;
  if (!gw::kmajor_map_s8(&ta, qa, M, K, lda, gw::BM) ||
      !gw::kmajor_map_s8(&tb, qbt, N, K, ldb, 256))
    return static_cast<int>(cudaErrorInvalidValue);
  decltype(&launch_knobs<4, true>) run = nullptr;
  switch (b_buffers * 2 + (a_lookahead ? 1 : 0)) {
    case 4: run = launch_knobs<2, false>; break;
    case 5: run = launch_knobs<2, true>; break;
    case 6: run = launch_knobs<3, false>; break;
    case 7: run = launch_knobs<3, true>; break;
    case 8: run = launch_knobs<4, false>; break;
    case 9: run = launch_knobs<4, true>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return run(ta, tb, c, out, sa, sb, M, N, K, ldc,
             static_cast<cudaStream_t>(stream));
}
