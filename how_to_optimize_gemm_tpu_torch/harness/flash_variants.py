"""Variant builds of the port's wgmma kernels and of the KV8 decode
attention, timed against each other on the card in one process.

A variant is a copy of the port's ``csrc/`` under
``build/flash_variants/<group>/<name>/`` with textual substitutions applied
(each must match exactly once, so a variant that no longer fits the source
fails), or another tree's ``csrc/`` given with ``--tree NAME=DIR[:BK]`` (a
parent commit unpacked by ``git archive``; for the forward group its key
tile BK). Thirteen groups of kernels, one a run (``--group``):

- ``forward``: ``flash_attention`` at the 7B prefill row (B 4, H = KVH = 32,
  D 128, S = T = 4,096, causal, (B, S, H, D) views) and
  ``flash_attention_fwd_lse`` at the soak's shape (B 8, H 32, KVH 4,
  S 1,024, D 64, causal, views), each output held to its plain version at
  the variant's key tile (``bf16_row_ulps``; ``row_rel_err`` and the lse's
  max abs) and to the bits of the first tree checked at that key tile;
- ``dkv``: ``flash_attention_bwd_dkv`` at the soak's shape, at the 7B
  training row (B 2, H = KVH = 32, S 2,048, D 128, causal) and at T-moe's
  (B 2, H 32, KVH 8, S 1,025, D 128, causal), dk and dv held to the plain
  version (``row_rel_err``) and to the first tree's bits; SDPA's whole
  backward beside them, timed as
  the difference of two graph replays (forward and backward, forward);
- ``dq``: ``flash_attention_bwd_dq`` at the same three shapes, dq held to
  the plain version (``row_rel_err``) and two calls bit-equal. An older
  tree's kernel (``mma.sync``) takes the same arguments. The variants give
  a consumer tile j's S and dP with tile j - 1's dS K (``overlap``),
  give a block one consumer (``one_consumer``, ``one_consumer_overlap``),
  take 32-key tiles at D 128 (``d128_bk32``), keep one buffer of rows at
  D 64 or copy the next item's rows after this item's
  last tile (``one_buffer``, ``rows_late``), take every round of items
  in block order (``round_robin``), let the consumers issue
  without taking turns (``no_pingpong``), or compute p by expf on natural
  units (``expf``, the ``mma.sync`` kernel's arithmetic); the ``diag_``
  ones (wrong answers, timing probes) leave out the lo halves' products
  or the exps;
- ``gemm``: ``bf16_gemm_nt`` (rung 15), ``fp32_gemm_nt`` (rung 16) and
  ``fp32_gemm_nn`` (rung 04: each its wrapper with the two splits, and the
  kernel alone on planes split beforehand) and ``bf16_gemm_nn`` (rung 05)
  at M = N = K = 4,096 and 2,048, each held to its plain version relative
  to max |plain|, two calls bit-equal, rungs 05's and 04's C unchanged;
  01b's two calls (15, 05) and 01's (16, 04) beside them. An older tree's
  ``fp32_gemm_nt`` or ``fp32_gemm_nn`` (the FFMA kernels before the split
  route) takes fp32 operands and is launched on them;
- ``paged``: ``paged_decode_attention_q8`` on the split walk at the
  smoke's two shapes (the 7B KV8 pool: 4 slots, 32 heads of 128, pages
  of 384, lengths 1, 300, 1,000 and 4,096; kvh 3, rep 2, D 32, pages of
  96), held to its plain version; the variant ``scales_once`` (wrong
  answers, a timing probe) reads every key's scales at the page's first
  row, which times what the per-key scale reads cost. This tree only:
  an older tree's kernel takes other arguments;
- ``w4a8``: ``w4a8_gemm_noc`` at the 7B prefill widths (M = 1,024, 4,096
  -> 11,008 and 11,008 -> 4,096; m = 16,384, 4,096 -> 11,008) and at
  the chunks of 65-512 tokens (m = 65, 128, 256, 512 at 4,096 ->
  11,008; 128 at 11,008 -> 4,096; 256 at 4,096 -> 4,096), each EQUAL to
  its plain version, K3 ``w4a8_gemm`` (rung 07b, the same body with C
  added in place) at M = N = K = 4,096 and 2,048, each on a C of its
  own, EQUAL to its plain version and two calls bit-equal, and
  ``decode_attention_q8`` at the smoke's three shapes (the 7B KV8 cache:
  4 slots, 32 heads of 128, T 4,096, lengths 1, 300, 1,000 and 4,096;
  kvh 8, rep 4; kvh 3, rep 2, D 64, T 1,000), held to its plain version.
  An older tree's ``decode_attention_q8`` (the one-block walk, no
  workspace) is launched with its own arguments; an older tree's
  ``w4a8_gemm`` (the ``mma.sync`` tile) takes the same arguments. The
  variants force a token tile, decode the nibbles in three integer
  operations a word, shorten the ring to two stages, or (wrong answers,
  a timing probe) skip the decode;
- ``int8``: ``int8_gemm_nt`` (K2, rung 14) at M = N = K = 4,096, 2,048 and
  3,584 (the headline's sizes), ``int8_ragged_nt`` (rung 18) at 4,096
  on its default plan and on the two-piece plan of cap 1,664, K1
  ``int8_gemm_nn`` (a fresh output, C checked unchanged) at 4,096 and
  2,048, and ``int8_gemm_noc`` at the 7B prefill widths (M = 1,024, 4,096
  -> 11,008 and 11,008 -> 4,096) and at (1,000, 1,100 -> 1,032), each
  EQUAL to its plain version and two calls bit-equal; ``torch._int_mm``
  and the epilogue beside them. An older tree's kernels (the ``mma.sync``
  tile) take the same arguments. The variants shorten K2's ring to three
  or two stages, add C in each thread instead of by tensor-map
  reductions, walk groups of 4 or 16 row tiles, stage sb 64 columns a
  pass, give ``int8_gemm_noc`` one box of 128 K a stage (in its ring of
  4, or of 3), or give K1 another staging of C (one buffer of 32 tokens;
  one box a stage with two buffers of 32 or 16 tokens) or each thread
  adding C from float4 loads;
- ``gemv``: ``w4a8_gemv_fq`` at the 7B decode widths (4,096 -> 11,008,
  4,096 -> 4,096, 11,008 -> 4,096) at m = 1, 4, 16 and 64, and at m = 4
  on four copies of the 4,096 -> 11,008 weights taken in turn (90 MB, past
  the 50 MB L2: each call reads its weights from device memory), each
  EQUAL to its plain version and two calls bit-equal; and
  ``paged_decode_attention`` at the smoke's two shapes (the 7B bf16 pool:
  4 slots, 32 heads of 128, pages of 128, lengths 1, 300, 1,000 and
  4,096; kvh 3, rep 2, D 32, pages of 96), held to its plain version. An
  older tree's kernels (the two-launch GEMV with its quantize pass, and
  the one-block walk) are launched with their own arguments, the GEMV's
  x padded to Kp and its scratch allocated as their wrapper did. The
  variants ``cl1``, ``cl2``, ``cl4`` and ``cl8`` are the shipped source
  with the cluster forced to 1, 2, 4 or 8 blocks at every shape (the
  plan's where it does not fit); the ``diag_`` ones
  (wrong answers, timing probes) leave out the quantization or the
  products (or only their tensor-core part), or (right answers) record
  each block's phases. Each tree's host operations a call (torch.profiler's top-level
  aten ops and runtime launches) are printed for the GEMV at m = 4;
- ``w4a16``: the W4A16 serving pair. ``w4a16_gemv`` at the 7B decode
  widths (4,096 -> 11,008 at m = 1, 4, 16 and 64; 4,096 -> 4,096 and
  11,008 -> 4,096 at m = 4) and at m = 4 on four copies of the 4,096 ->
  11,008 weights taken in turn (past the L2), and ``w4a16_gemm_noc`` at
  the 7B prefill widths (M = 1,024, 4,096 -> 11,008 and 11,008 -> 4,096),
  at chunks of 128 and 256 tokens and at the ragged (1,000, 1,100 ->
  1,032), and rung 07 ``w4a16_gemm`` (C in place, timed on a C of its
  own) at M = N = K = 4,096 and 2,048, each held to its plain version
  within 2e-5 of max |plain| and two calls bit-equal. An older tree's GEMV
  (no cluster argument) is launched with its own arguments; its GEMMs take
  the same. The variants ``cl1``, ``cl2``, ``cl4`` and ``cl8`` force the
  GEMV's cluster (the plan's where it does not fit), ``bt64`` and
  ``bt128`` the GEMMs' token tile, ``c16x2`` stages rung 07's C in two
  buffers of 16 tokens a warp and ``c_threads`` has each thread add it;
  ``diag_timeline`` (right answers) records each GEMV block's phases. Each tree's host operations a call are printed for the GEMV at
  m = 4;
- ``strip``: rung 11 ``int8_strip_nt`` (the A box multicast across a
  cluster of ``CL`` blocks along N, C loaded into a fresh output) at
  M = N = K = 4,096 and 2,048, EQUAL to its plain version, C unchanged,
  two calls bit-equal; rung 17 ``int8_hand_pipe_nt`` at 4,096 in its six
  knob instances (``b_buffers`` 2, 3, 4 x ``a_lookahead``), each EQUAL to
  ``int8_gemm_nt``'s output, which is timed beside them; ``torch._int_mm``
  and the epilogue beside all. An older tree's kernels (the ``mma.sync``
  ones) take the same arguments. The variants build rung 11 at ``CL`` 1
  (no multicast: the L2 alone shares A, the lesson's control) and 4, or
  with each thread adding C (``c_threads``);
- ``pingpong``: rungs 10 ``int8_fat_nt`` and 12 ``int8_resident_nt`` (K2's
  body with each consumer warpgroup taking whole tiles in turn; 12 with
  the operands kept in the L2) and rung 11 ``int8_strip_nt`` at M = N = K
  = 4,096 and 2,048, EQUAL to their plain version, C unchanged, two calls
  bit-equal, and ``int8_gemm_nt`` at 4,096; ``torch._int_mm`` and the
  epilogue beside all. An older tree's kernels (the ``mma.sync`` ones)
  take the same arguments. The variants order the two consumers' product
  loops (``order``), give each consumer 64 x 256 tiles (``tile64x256``),
  drop rung 12's prefetch (``no_prefetch``), or build rung 11 at ``CL`` 1
  (``cl1``: the cooperative body into a fresh output, rung 10's control);
- ``tiled``: rung 13 ``int8_tiled_resident_nt`` (rung 12's ping-pong fed
  by 1-D bulk copies of ``int8_pretile``'s stage images) at M = N = K =
  4,096 and 2,048, the whole call (two repacks and the GEMM) and the GEMM
  alone on images made beforehand, each EQUAL to the plain version and two
  calls bit-equal, with rung 12 ``int8_resident_nt``'s call in the same
  run; the repack alone on A at both sizes (EQUAL to ``pretile_ref``); and
  ``paged_kv_update`` at the 7B pools (4 slots, one token each: the bf16
  pool of 128-token pages, the KV8 pool's int8 values and fp32 scales of
  384-token pages) beside ``kv_update`` into a contiguous cache of the same
  rows, each EQUAL to its plain version; ``torch._int_mm`` and the
  epilogue, and ``index_put_``, beside them. An older tree's rung 13 (the
  ``mma.sync`` fat kernel) reads its own images ((tiles, ceil(K / 64), 128,
  80)), made by its own ``int8_pretile`` (the same arguments); its
  ``paged_kv_update`` (a stacked (B, S, 2) table) is timed as its wrapper
  called it, the stack included. The variants drop the prefetch of rungs
  12 and 13 (``no_prefetch``) or repack by the copy engine
  (``tma_repack``: a tensor-map load of each 128 x 128 box into shared
  memory, then one bulk store of its 16 KB image);
- ``ladder``: the float ladder's rungs 02 (``fp32_gemm_mn_tile``), 03 and
  03b (``fp32_gemm_k_blocked`` at blocks of 128 and 64), each its
  wrapper at M = N = K = 4,096 and 2,048, held to its plain version
  relative to max |plain| and to the fp64 product, two calls bit-equal,
  C unchanged; 01's call (cuBLAS's fp32 product) beside them. An older
  tree's kernels (the FFMA kernels before the bf16x3 route) take the
  same arguments. The variants give rung 03 a ring of 2 or 4 stages,
  split in each warp's fragments instead of in a pass into bf16 planes
  (at 3 and 4 stages), add the tensor cores' partials every 2, 8 or 16
  K steps instead of 4 or only at the end (``straight``), or lay the
  128-wide blocks' 8 warps out 2 x 4 (64 x 32 each) instead of 4 x 2;
  the ``diag_`` ones (wrong answers, timing probes) leave out rung 03's
  split pass or the lo products.

Each variant's ptxas lines (registers, spills) are printed after the
build; the cases run as CUDA-graph replays in rounds that walk the
variants forwards and then backwards.

    python -m how_to_optimize_gemm_tpu_torch.harness.flash_variants \\
        [--group forward|dkv|dq|gemm|paged|w4a8|int8|gemv|w4a16|strip|pingpong|tiled|ladder] \\
        [--variants shipped ...] \\
        [--tree parent=build/parent/how_to_optimize_gemm_tpu_torch/csrc:64]
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import pathlib
import shutil

import torch

from how_to_optimize_gemm_tpu_torch import _build
from how_to_optimize_gemm_tpu_torch.harness import profiling
from how_to_optimize_gemm_tpu_torch.ops import (attention, decode_attention,
                                               grouped_gemm, hand_pipeline,
                                               int4, int8, k_blocked,
                                               kv_update,
                                               manual_dma, mn_tile,
                                               paged_attention, tuned,
                                               vendor)
from how_to_optimize_gemm_tpu_torch.utils.timing import time_calls

OUT_DIR = _build.BUILD_DIR.parent / "flash_variants"
_BODY = "flash_wgmma.cuh"
# name -> ((file, old, new), ...), and the key tile where it differs
_BK128 = (_BODY, "constexpr int BK = 64; ", "constexpr int BK = 128;")
_SETMAXNREG = (
    (_BODY, "  if (threadIdx.x < 128) {\n",
     "  if (threadIdx.x < 128) {\n"
     "    asm volatile(\"setmaxnreg.dec.sync.aligned.u32 24;\\n\");\n"),
    (_BODY, "  } else {\n    consume<D, kSplit>",
     "  } else {\n"
     "    asm volatile(\"setmaxnreg.inc.sync.aligned.u32 240;\\n\");\n"
     "    consume<D, kSplit>"))
# a consumer's products in turn with its softmax: a turn issues S, then
# P V follows the softmax (only S or P live at once besides O)
_SERIAL = (
    (_BODY, """  wait_full(0);
  turn();
  qk(0);
  pass(0);
  wg::wgmma_wait<0>();
  softmax(0);
  sm.rescale<D>(o, s, pa);
  for (int j = 1; j < my_n; ++j) {
    wait_full(j);
    turn();
    qk(j);
    pv(j - 1);
    pass(j);
    wg::wgmma_wait<1>();
    softmax(j);
    wg::wgmma_wait<0>();
    pv_done(j - 1);
    sm.rescale<D>(o, s, pa);
  }
  turn();
  pv(my_n - 1);
  pass(my_n);
""", """  for (int j = 0; j < my_n; ++j) {
    wait_full(j);
    turn();
    if (j > 0) {
      wg::wgmma_wait<0>();
      pv_done(j - 1);
    }
    qk(j);
    pass(j);
    wg::wgmma_wait<0>();
    softmax(j);
    sm.rescale<D>(o, s, pa);
    pv(j);
  }
  turn();
  pass(my_n);
"""),)
FORWARD_VARIANTS = {
    "shipped": (),
    # 128-key tiles (FA3's choice): S, P and O spill at D 128
    "bk128": (_BK128,),
    # the same with the producer's registers handed to the consumers
    # (setmaxnreg 24 / 240)
    "bk128_setmaxnreg": (_BK128, *_SETMAXNREG),
    # the same compiled for 256 threads a block, where ptxas gives the
    # consumers 240 registers; a launch of 384 threads is refused
    "bk128_lb256": (_BK128, *_SETMAXNREG,
                    (_BODY, "__launch_bounds__(THREADS, 1)",
                     "__launch_bounds__(256, 1)")),
    # no overlap within a consumer, at 64- and 128-key tiles
    "serial": _SERIAL,
    "bk128_serial": (_BK128, *_SERIAL),
    # the consumers do not take turns at the tensor cores
    "no_pingpong": (
        (_BODY, "auto turn = [&] { wg::bar_sync(BAR_TURN + cw, 256); };",
         "auto turn = [&] {};"),
        (_BODY, "if (cw == 0 || t < n) wg::bar_arrive(BAR_TURN + (cw ^ 1), "
         "256);", "(void)t;"),
        (_BODY, "if (cw == 1) wg::bar_arrive(BAR_TURN, 256);", "")),
    # exp as expf on scores in natural units
    "expf": (
        (_BODY, 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
         "y = expf(x);"),
        (_BODY, "constexpr float LOG2E = 1.4426950408889634f;",
         "constexpr float LOG2E = 1.0f;"),
        (_BODY, "constexpr float LN2 = 0.6931471805599453f;",
         "constexpr float LN2 = 1.0f;")),
    # o left as it is where neither of a thread's rows moved its max
    # (alpha = 1: o * 1 is o)
    "rescale_skip": (
        (_BODY, "    for (int i = 0; i < D / 2; ++i)\n      o[i] = ",
         "    for (int i = 0; i < D / 2; ++i)\n      if (alpha[0] != 1.0f || "
         "alpha[1] != 1.0f) o[i] = "),),
    # diagnostics, other functions: fwd_lse without q's lo product; both
    # kernels without their output stores (a condition the compiler cannot
    # see is always true)
    "diag_hi_only": ((_BODY, "    if (kSplit)\n      wg::Wgmma<BK>",
                      "    if (false)\n      wg::Wgmma<BK>"),),
    "diag_no_store": ((_BODY, "if (row >= p.S) continue;",
                       "if (row >= p.S || p.causal < 5) continue;"),),
}
KEY_TILE = dict.fromkeys(("bk128", "bk128_setmaxnreg", "bk128_lb256",
                          "bk128_serial"), 128)

_DKV = "flash_attention_bwd_dkv.cu"
_NC = "  static constexpr int NC = D == 64 ? 2 : 1;      // consumer warpgroups"
_QT = "  static constexpr int QT = 64;                   // queries a step"
DKV_VARIANTS = {
    "shipped": (),
    # at D 128 two consumers (128-key blocks of 384 threads, 168 registers
    # a thread) on 32-query steps: dk and dv take 128, and it spills
    "d128_two_consumers": (
        (_DKV, _NC, "  static constexpr int NC = 2;"),
        (_DKV, _QT, "  static constexpr int QT = D == 64 ? 64 : 32;")),
    # one consumer at both D (64-key blocks of 256 threads)
    "one_consumer": ((_DKV, _NC, "  static constexpr int NC = 1;"),),
    # 32-query steps at both D
    "qt32": ((_DKV, _QT, "  static constexpr int QT = 32;"),),
    # exp as expf on scores in natural units
    "expf": (
        (_DKV, 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
         "y = expf(x);"),
        (_DKV, "constexpr float LOG2E = 1.4426950408889634f;",
         "constexpr float LOG2E = 1.0f;")),
}

_DQ = "flash_attention_bwd_dq.cu"
_DQ_NC = ("  static constexpr int NC = 2;                    "
          "// consumer warpgroups")
_DQ_BK = "  static constexpr int BK = 64;                   // keys a tile"
# a consumer's tile j's S and dP issued with its tile j - 1's dS K, which
# runs beside tile j's exps (the forward's overlap within a consumer): S,
# dP, dQ and dS's fragments live at once
_DQ_LAG = (_DQ, """    for (int j = 0; j < my_n; ++j) {
      wait_full(j);
      turn();
      products(j);
      pass(j);
      wg::wgmma_wait<0>();
      scores(j);
      pack();
      dq_product(j);
      wg::wgmma_wait<0>();
      dq_done(j);
    }
    turn();
    pass(my_n);
""", """    wait_full(0);
    turn();
    products(0);
    pass(0);
    wg::wgmma_wait<0>();
    scores(0);
    pack();
    for (int j = 1; j < my_n; ++j) {
      wait_full(j);
      turn();
      products(j);
      dq_product(j - 1);
      pass(j);
      wg::wgmma_wait<1>();
      scores(j);
      wg::wgmma_wait<0>();
      dq_done(j - 1);
      pack();
    }
    turn();
    dq_product(my_n - 1);
    pass(my_n);
    wg::wgmma_wait<0>();
    dq_done(my_n - 1);
""")
_DQ_ONE = (_DQ, _DQ_NC, "  static constexpr int NC = 1;")
DQ_VARIANTS = {
    "shipped": (),
    "overlap": (_DQ_LAG,),
    # one consumer (64-query items, blocks of 256 threads: 255 registers),
    # without and with the overlap within it
    "one_consumer": (_DQ_ONE,),
    "one_consumer_overlap": (_DQ_ONE, _DQ_LAG),
    # 32-key tiles at D 128 (two buffers of rows fit beside them)
    "d128_bk32": ((_DQ, _DQ_BK,
                   "  static constexpr int BK = D == 64 ? 64 : 32;"),),
    # 32-key tiles at both D, without and with the overlap within a
    # consumer (S, dP, dQ and dS's fragments take 80 registers at D 64)
    "bk32": ((_DQ, _DQ_BK, "  static constexpr int BK = 32;"),),
    "bk32_overlap": ((_DQ, _DQ_BK, "  static constexpr int BK = 32;"),
                     _DQ_LAG),
    # one buffer of rows: the next item's rows copied after this one's
    "one_buffer": ((_DQ, "      2 * BUF + 2 * STAGE + 2 * wg::ATOM <= "
                    "SMEM_LIMIT ? 2 : 1;", "      1;"),),
    # two buffers, the next item's rows copied after this item's last tile
    "rows_late": ((_DQ, "    int next = (C::BUFS == 2 ? min(ST, x.n) : "
                   "x.n) - 1;", "    int next = x.n - 1;"),),
    # the rounds of items all taken in block order (block i: items i,
    # i + blocks, ...)
    "round_robin": ((_DQ, "  int w = it * g + (it & 1 ? g - 1 - blockIdx.x : "
                     "blockIdx.x);", "  int w = it * g + blockIdx.x;"),),
    # the consumers do not take turns at the tensor cores
    "no_pingpong": (
        (_DQ, "    if constexpr (C::NC == 2) wg::bar_sync(fw::BAR_TURN + cw, "
         "256);\n", ""),
        (_DQ, "        if (cw == 0 || t < n) wg::bar_arrive(fw::BAR_TURN + "
         "(cw ^ 1), 256);", "        (void)t;"),
        (_DQ, "      wg::bar_arrive(fw::BAR_TURN, 256);   // consumer 0 goes "
         "first", "      (void)0;")),
    # diagnostics, wrong answers: without the lo halves' products (S, dP
    # and dS K on the hi halves alone), or without the exps (p = s)
    "diag_no_lo": (
        (_DQ, """    wg::Wgmma<C::BK>::template ss<0, 0>(
        acc, wg::kmajor_desc(ah + C::LO, k % 4), db, 1);
""", ""),
        (_DQ, "    wg::Wgmma<D>::template rs<1>(dq, sl[kk], db, 1);\n", "")),
    "diag_no_exp": ((_DQ, "float pe = ex2(__fmaf_rn(s[4 * i + e], LOG2E, "
                     "-lse2[e >> 1]));", "float pe = s[4 * i + e];"),),
    # p = expf(s - lse) on natural units (the mma.sync kernel's arithmetic)
    "expf": (
        (_DQ, "ex2(__fmaf_rn(s[4 * i + e], LOG2E, -lse2[e >> 1]))",
         "expf(__fsub_rn(s[4 * i + e], lse2[e >> 1]))"),
        (_DQ, "__fmul_rn(p.lse[rows + qpos[r]], LOG2E)",
         "p.lse[rows + qpos[r]]")),
}

_GEMM = "bf16_gemm_nt.cu"
_FP32 = "fp32_gemm_nt.cu"
_NN = "bf16_gemm_nn.cu"
_FP32_NN = "fp32_gemm_nn.cu"
_GW = "gemm_wgmma.cuh"
_TILE128 = (_GEMM, "constexpr int BN = 256; ", "constexpr int BN = 128;")
_CH = "  static constexpr int CH = 4; "


def _fp32_chunk(stages: int, source: str = _FP32):
    return ((source, _CH, f"  static constexpr int CH = {stages}; "),)


GEMM_VARIANTS = {
    "shipped": (),
    # the loop in wgmma.cuh's consume() shape: the accumulators fenced
    # before every stage's products, the last stage's wait, fence and
    # releases on a branch of their own; ptxas serializes its products (its
    # note C7518)
    "consume_shape": (
        (_GW, """        // (acc unfenced: the group before still writes it)
        wg::wgmma_fence();""", """        for (int h = 0; h < MH; ++h) wg::fence_regs(acc[h]);
        wg::wgmma_fence();"""),
        (_GW, """        wg::wgmma_wait<1>();
        if (prev >= 0) wg::release(ring, prev);
        prev = s;
      }
      wg::wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < MH; ++h) wg::fence_regs(acc[h]);
      wg::release(ring, prev);
""", """        if (kq + 1 == kend) {
          wg::wgmma_wait<0>();
          for (int h = 0; h < MH; ++h) wg::fence_regs(acc[h]);
          if (prev >= 0) wg::release(ring, prev);
          wg::release(ring, s);
        } else {
          wg::wgmma_wait<1>();
          if (prev >= 0) wg::release(ring, prev);
          prev = s;
        }
      }
""")),
    # each consumer thread adds C to its sums (or stores them) itself, as
    # it does where the tensor-map unit cannot (out's rows no 16-byte
    # multiple)
    "register_epilogue": ((_GW, "  int tma_out = ldc % 4 == 0 && ",
                           "  int tma_out = false && "),),
    # rung 15 on 128 x 128 tiles, the straight sum
    "tile128": (_TILE128,),
    # the same with partial sums of 16 stages (K 1,024) added into a
    # second fp32 array
    "tile128_chunk16": (_TILE128, (_GEMM, "constexpr int CH = 0; ",
                                   "constexpr int CH = 16;")),
    # rung 16's partial sums of 1, 2, 8 and 16 stages, and its straight sum
    "fp32_ch1": _fp32_chunk(1),
    "fp32_ch2": _fp32_chunk(2),
    "fp32_ch8": _fp32_chunk(8),
    "fp32_ch16": _fp32_chunk(16),
    "fp32_straight": _fp32_chunk(0),
    # rung 04's partial sums (seeded with C) of 1, 2, 8 and 16 stages, and
    # its straight sum (C in the wgmma accumulators)
    "nn_ch1": _fp32_chunk(1, _FP32_NN),
    "nn_ch2": _fp32_chunk(2, _FP32_NN),
    "nn_ch8": _fp32_chunk(8, _FP32_NN),
    "nn_ch16": _fp32_chunk(16, _FP32_NN),
    "nn_straight": _fp32_chunk(0, _FP32_NN),
}
_PAGED = "paged_decode_attention_q8.cu"
_DA = "decode_attention.cuh"
PAGED_VARIANTS = {
    "shipped": (),
    # the split walk's scale reads, K's and V's, at the page's first row
    "scales_once": (
        (_DA, "              s_k[u] = sk[scale_b + (size_t)(j0 + u) * KVH];",
         "              s_k[u] = sk[scale_b];"),
        (_DA, "operand = __fmul_rn(p, sv[scale_b + (size_t)j * KVH]);",
         "operand = __fmul_rn(p, sv[scale_b]);")),
}
_W4 = "w4a8_wgmma.cuh"
_TOKEN_RULE = "  return rounds(64) <= rounds(128) ? 64 : 128;"
_DECODE = ("          dl[j] = decode_lo4(w[j]);\n"
           "          dh[j] = decode_hi4(w[j]);")
_DECODE3 = (_W4, _DECODE,
            "          dl[j] = (((w[j] & 0x0F0F0F0Fu) | 0x80808080u) - "
            "0x08080808u) ^ 0x80808080u;\n"
            "          dh[j] = (((((w[j] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u) "
            "| 0x80808080u) - 0x08080808u) ^ 0x80808080u;")
_NOC = "int8_gemm_noc.cu"


def _w4_ring(n: int):
    """w4a8_wgmma.cuh's ring cut to n stages."""
    return ((_W4, "  static constexpr int ST =\n      (SMEM_LIMIT - "
             "wg::ATOM - 256 - OUT) / STAGE;   // stages of the ring",
             f"  static constexpr int ST = {n};   // stages of the ring"),)


_DRAIN = (_W4, "  wg::wgmma_wait<1>();                                 "
          "                \\\n  wg::fence_regs(f[((I) + 1) & 1]);",
          "  wg::wgmma_wait<0>();                                 "
          "                \\\n  wg::fence_regs(f[(I) & 1]);")
W4A8_VARIANTS = {
    "shipped": (),
    # one token tile at every shape
    "bt64": ((_W4, _TOKEN_RULE, "  return rounds(64) >= 0 ? 64 : 128;"),),
    "bt128": ((_W4, _TOKEN_RULE, "  return rounds(64) < 0 ? 64 : 128;"),),
    # the nibbles decoded in three integer operations a word (the bits
    # of decode_lo4 / decode_hi4: x - 8 per byte as ((x | 0x80) - 8) ^ 0x80)
    "decode3": (_DECODE3,),
    # each step's products completed before the next step's fragments are
    # written (wait<0>; the two consumers interleave at the tensor cores)
    "drain": (_DRAIN,),
    # a ring of two stages
    "st2": _w4_ring(2),
    # diagnostics, wrong answers: the packed bytes go to the tensor cores
    # undecoded; fixed A fragments (no loads, decode or register writes in
    # the loop: the products and the ring alone)
    "diag_no_decode": ((_W4, _DECODE,
                        "          dl[j] = w[j];\n          dh[j] = w[j];"),),
    "diag_fixed_a": (
        (_W4, "  fragments<Src, I>(box, off, f[(I) & 1]);", "  (void)box;"),
        (_W4, "  uint32_t f[2][NF][4];", "  uint32_t f[2][NF][4] = {};")),
}
_K2 = "int8_gemm_nt.cu"
_R18 = "int8_ragged_nt.cu"
_NN1 = "int8_gemm_nn.cu"


def _float4_c(kernel_file: str):
    """The epilogue's threads adding C from float4 loads where C's and
    out's rows are whole float4s (the shipped epilogue stores float4s only
    where no C is added), in the kernel of ``kernel_file``."""
    return ((kernel_file, "      !ADD_C && (ldc & 3) == 0 &&\n"
             "          (reinterpret_cast<uintptr_t>(out) & 15) == 0,",
             "      (ldc & 3) == 0 && (reinterpret_cast<uintptr_t>(c) & 15) "
             "== 0 &&\n"
             "          (reinterpret_cast<uintptr_t>(out) & 15) == 0,"),
            (_W4, "          *reinterpret_cast<float4*>(out + at) =\n",
             "          if (ADD_C) {\n"
             "            float4 cv = *reinterpret_cast<const float4*>(c + "
             "at);\n"
             "            v[0] = __fadd_rn(v[0], cv.x);\n"
             "            v[1] = __fadd_rn(v[1], cv.y);\n"
             "            v[2] = __fadd_rn(v[2], cv.z);\n"
             "            v[3] = __fadd_rn(v[3], cv.w);\n"
             "          }\n"
             "          *reinterpret_cast<float4*>(out + at) =\n"))


def _int8_stages(n: int):
    return tuple((src, "  static constexpr int ST = 4; ",
                  f"  static constexpr int ST = {n}; ") for src in (_K2, _R18))


def _group_m(n: int):
    return ((_GW, "constexpr int GROUP_M = 8; ",
             f"constexpr int GROUP_M = {n}; "),)


INT8_VARIANTS = {
    "shipped": (),
    # a ring of three or two 48 KB stages
    "st3": _int8_stages(3),
    "st2": _int8_stages(2),
    # each consumer thread adds C to its dequantized sums itself, as it
    # does where C's rows are no 16-byte multiple
    "register_epilogue": GEMM_VARIANTS["register_epilogue"],
    # K2's walk in groups of 4 or 16 row tiles
    "group4": _group_m(4),
    "group16": _group_m(16),
    # sb staged 64 columns a pass (four passes a tile)
    "sb64": ((_GW, "constexpr int SB_COLS = 128;",
              "constexpr int SB_COLS = 64;"),),
    # int8_gemm_noc: one box of 128 K a stage (half the wgmmas a stage, a
    # ring of 4 at BT 128), alone or in a ring of three
    "noc_boxes1": ((_NOC, "constexpr int BOXES = 2;",
                    "constexpr int BOXES = 1;"),),
    "noc_boxes1_st3": ((_NOC, "constexpr int BOXES = 2;",
                        "constexpr int BOXES = 1;"), *_w4_ring(3)),
    # K1 (int8_gemm_nn): C staged in one buffer of 32 tokens a warp (two
    # boxes of 128 K a stage, 2 stages); one box a stage with two buffers
    # of 32 tokens (64 KB, 3 stages) or of 16 (4 stages); each thread
    # adding C from float4 loads of it (2 stages, no staging read)
    "nn_c32x1": ((_NN1, "constexpr int OUT_T = 16;",
                  "constexpr int OUT_T = 32;"),
                 (_NN1, "constexpr int OUT_B = 2;",
                  "constexpr int OUT_B = 1;")),
    "nn_boxes1_c32x2": ((_NN1, "constexpr int BOXES = 2;",
                         "constexpr int BOXES = 1;"),
                        (_NN1, "constexpr int OUT_T = 16;",
                         "constexpr int OUT_T = 32;")),
    "nn_boxes1": ((_NN1, "constexpr int BOXES = 2;",
                   "constexpr int BOXES = 1;"),),
    "nn_threads": ((_W4, "  return C_LOAD_STORE;\n}",
                    "  return C_THREADS;\n}"), *_float4_c(_W4)),
}
_STRIP = "int8_strip_nt.cu"
_WG = "wgmma.cuh"
_STRIP_CL = "  static constexpr int CL = 2; "
STRIP_VARIANTS = {
    "shipped": (),
    # rung 11's cluster of 1 (no multicast, the L2 alone sharing A) or 4
    "cl1": ((_STRIP, _STRIP_CL, "  static constexpr int CL = 1; "),),
    "cl4": ((_STRIP, _STRIP_CL, "  static constexpr int CL = 4; "),),
    # each consumer thread adds C to its dequantized sums and stores them
    # itself, as where C's rows are no 16-byte multiple
    "c_threads": ((_GW, "  if (Layout<P>::LOAD_C) return map(tcin, c) ? "
                   "C_LOAD : C_THREADS;",
                   "  if (Layout<P>::LOAD_C) return C_THREADS;"),),
    # the consumers' arrivals on the cluster's empty barriers at
    # release.cluster (the mma.sync rung 11's form) in place of the default
    # release.cta
    "release_cluster": ((_WG, "mbarrier.arrive.shared::cluster.b64",
                         "mbarrier.arrive.release.cluster.shared::cluster"
                         ".b64"),),
    # each block copies the whole A box itself (no multicast), the cluster
    # still releasing each slot together
    "own_a": ((_GW, "if constexpr (CL > 1)   // this block's slice, to every "
               "block", "if constexpr (false)"),
              (_STRIP, "lda, gw::BM / CL)", "lda, gw::BM)")),
}
_FAT = "int8_fat.cu"
_RES = "int8_resident.cu"


def _pingpong(old: str, new: str):
    """The same change to rung 10's instance and rung 12's."""
    return tuple((src, old, new) for src in (_FAT, _RES))


# the ping-pong tile's rows a consumer (64 in tile64x256): the walk's
# origins, A's box and plane, the products a K step
_PP_HALF = """template <int BN>
struct ResidentWalk : GroupWalk<BN> {"""
_HALF_WALK = """// the grouped walk of 64-row tiles: tile_of's origins, rows halved
template <int BN>
struct HalfWalk : GroupWalk<BN> {
  __device__ __forceinline__ void tile(int t, int& m0, int& n0) const {
    GroupWalk<BN>::tile(t, m0, n0);
    m0 /= 2;
  }
};
template <int BN>
struct ResidentWalk : HalfWalk<BN> {"""

PINGPONG_VARIANTS = {
    "shipped": (),
    # the two consumers' product loops taking turns (CUTLASS's ordering
    # barrier): consumer cw waits before tile j > 0's products until the
    # other has issued tile j - 1's (named barrier 3 + cw, 256 threads),
    # and arrives on the other's once it has issued its own
    "order": (
        (_GW, "    for (int kc = 0; kc < stages; kc += chunk) {\n",
         "    if (L::PP && j > 0) wg::bar_sync(3 + cw, 2 * 128);\n"
         "    for (int kc = 0; kc < stages; kc += chunk) {\n"),
        (_GW, "        prev = s;\n      }\n      wg::wgmma_wait<0>();\n",
         "        prev = s;\n      }\n"
         "      if (L::PP && t + step < tiles)\n"
         "        wg::bar_arrive(3 + (cw ^ 1), 2 * 128);\n"
         "      wg::wgmma_wait<0>();\n")),
    # 64 x 256 a consumer (one m64n256k32 a K step, 40 KB stages, 4 of
    # them) in place of 128 x 128
    "tile64x256": (
        *_pingpong("  static constexpr int BN = 128; ",
                   "  static constexpr int BN = 256; "),
        *_pingpong("  static constexpr int ST = 6; ",
                   "  static constexpr int ST = 4; "),
        (_GW, _PP_HALF, _HALF_WALK),
        (_GW, "  static constexpr int MH = PP ? 2 : 1;",
         "  static constexpr int MH = 1;"),
        (_GW, "  static constexpr int B = NP * A_BYTES; ",
         "  static constexpr int B = NP * (PP ? A_BYTES / 2 : A_BYTES); "),
        (_GW, "  static constexpr int STAGE = NP * (A_BYTES + B_BYTES);",
         "  static constexpr int STAGE = NP * ((PP ? A_BYTES / 2 : A_BYTES)"
         " + B_BYTES);"),
        (_GW, "P::BN == (PP ? 128 : 256)", "P::BN == 256"),
        (_GW, "  if (!kmajor_map_s8(&ta, qa, M, K, lda, BM) ||",
         "  if (!kmajor_map_s8(&ta, qa, M, K, lda, BM / 2) ||"),
        (_GW, "  GroupWalk<P::BN> grid{(M + BM - 1) / BM,",
         "  HalfWalk<P::BN> grid{{(M + BM / 2 - 1) / (BM / 2),"),
        (_GW, "(N + P::BN - 1) / P::BN};\n  if constexpr (resident_of<P>)",
         "(N + P::BN - 1) / P::BN}};\n  if constexpr (resident_of<P>)")),
    # rung 12 without its prefetch of the operands (the copies' evict_last
    # and C's and out's evict_first kept)
    "no_prefetch": ((_GW, "    l2_prefetch_grid(walk.a, walk.a_bytes, keep);\n"
                     "    l2_prefetch_grid(walk.b, walk.b_bytes, keep);\n",
                     ""),),
    # the control: rung 11's body cooperative (no cluster) into a fresh
    # output, read off rung 11's rows
    "cl1": ((_STRIP, _STRIP_CL, "  static constexpr int CL = 1; "),),
}
_TMA_REPACK = """// the copy engine's repack: block i takes image i, one tensor-map load of
// its 128 x 128 box (the 128-byte swizzle, zeros past the edges) into
// shared memory, then one bulk store of the 16 KB under evict_last
__global__ void __launch_bounds__(32)
    int8_pretile_tma(const __grid_constant__ CUtensorMap map, int8_t* dst,
                     int nk) {
  using namespace htog;
  extern __shared__ uint8_t raw[];
  __shared__ uint64_t bar;
  uint8_t* img = wg::align_1024(raw);
  if (threadIdx.x != 0) return;
  mbar_init(&bar, 1);
  mbar_fence_init();
  mbar_arrive_expect_tx(&bar, BM * wg::LINE);
  wg::tma_2d(img, &map, (blockIdx.x % nk) * wg::LINE,
             (blockIdx.x / nk) * BM, &bar);
  mbar_wait(&bar, 0);
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], "
      "[%1], %2, %3;\\n" ::"l"(dst + static_cast<size_t>(blockIdx.x) * BM *
                                   wg::LINE),
      "r"(smem_u32(img)), "r"(BM * wg::LINE), "l"(l2_evict_last())
      : "memory");
  bulk_commit();
  bulk_wait_all();
}

int pretile_tma(const void* src, void* dst, int rows, int K, int ld,
                int tiles, int nk, void* stream) {
  using namespace htog;
  const int images = tiles * nk;
  if (images == 0) return 0;
  CUtensorMap map;
  if (!gw::kmajor_map_s8(&map, src, rows, K, ld, BM))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int SMEM = BM * wg::LINE + wg::ATOM;
  cudaFuncSetAttribute(int8_pretile_tma,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  int8_pretile_tma<<<images, 32, SMEM, static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<int8_t*>(dst), nk);
  return static_cast<int>(cudaGetLastError());
}

"""

TILED_VARIANTS = {
    "shipped": (),
    # rungs 12 and 13 without the prefetch of their operands (the copies'
    # evict_last and C's and out's evict_first kept)
    "no_prefetch": PINGPONG_VARIANTS["no_prefetch"],
    # int8_pretile by the copy engine (its threads' form left unlaunched)
    "tma_repack": (
        (_RES, "// src (rows, K) int8 with row pitch ld",
         _TMA_REPACK + "// src (rows, K) int8 with row pitch ld"),
        (_RES, "  const size_t words = static_cast<size_t>(tiles) * nk * BM"
         " * 8;\n",
         "  return pretile_tma(src, dst, rows, K, ld, tiles, nk, stream);\n"
         "  const size_t words = static_cast<size_t>(tiles) * nk * BM"
         " * 8;\n")),
}
_GEMV = "w4a8_gemv_fq.cu"
# the timeline probes' device side: each block's %globaltimer at phase i
# (0-8) and its SM (9), and the C entry that reads and clears them
_STAMP = ("__device__ unsigned long long gemv_t[4096 * 10];\n"
          "__device__ __forceinline__ void stamp(int i) {\n"
          "  if (threadIdx.x == 0) {\n"
          "    unsigned long long t;\n"
          "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
          "    int b = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * "
          "blockIdx.z);\n"
          "    gemv_t[b * 10 + i] = t;\n"
          "    unsigned sm;\n"
          "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
          "    gemv_t[b * 10 + 9] = sm;\n"
          "  }\n}\n\n")
_TIMES = ('extern "C" int gemv_times(void* dst, int n) {\n'
          '  cudaError_t err = cudaMemcpyFromSymbol(\n'
          '      dst, htog::fq::gemv_t, n * sizeof(unsigned long long));\n'
          '  void* t = nullptr;\n'
          '  if (err == cudaSuccess)\n'
          '    err = cudaGetSymbolAddress(&t, htog::fq::gemv_t);\n'
          '  if (err == cudaSuccess)\n'
          '    err = cudaMemset(t, 0, n * sizeof(unsigned long long));\n'
          '  return static_cast<int>(err);\n'
          '}\n\n')
GEMV_VARIANTS = {
    "shipped": (),
    # the shipped source, its plan's cluster forced (gemv_call)
    "cl1": (), "cl2": (), "cl4": (), "cl8": (),
    # diagnostics, wrong answers: no quantization (x never read), no
    # products (each stage released as it lands), no tensor-core products
    "diag_no_quant": ((_GEMV, "  const int chunks = (2 * nst + CHUNK / 4 "
                       "- 1) / (CHUNK / 4);", "  const int chunks = 0;"),),
    "diag_no_mma": ((_GEMV, "      const uint8_t* stage = ring + (q % ST) * "
                     "STAGE;\n",
                     "      const uint8_t* stage = ring + (q % ST) * "
                     "STAGE;\n      if (q >= 0) {\n        __syncwarp();\n"
                     "        if (lane == 0) mbar_arrive(&empty[q % ST]);\n"
                     "        continue;\n      }\n"),),
    # the fragments made, their products not taken (the tensor cores idle)
    "diag_no_tensor": ((_GEMV, "          mma_s8(acc[pc], alo, blo);\n"
                        "          mma_s8(acc[pc], ahi, bhi);",
                        "          acc[pc][0] ^= alo[0] ^ alo[1] ^ alo[2] ^ "
                        "alo[3] ^ ahi[0] ^ ahi[1] ^ ahi[2] ^ ahi[3] ^ blo[0] "
                        "^ blo[1] ^ bhi[0] ^ bhi[1];"),),
    # two stages' copies before the absmax
    "early2": ((_GEMV, "    for (int q = 0; q < min(held ? 1 : ST, nst); "
                "++q) load(q);",
                "    for (int q = 0; q < min(held ? 2 : ST, nst); ++q) "
                "load(q);"),
               (_GEMV, "      for (int q = 1; q < min(ST, nst); ++q) load(q);",
                "      for (int q = 2; q < min(ST, nst); ++q) load(q);")),
    # no stage's copy before the cluster has its maxima
    "early0": ((_GEMV, "    for (int q = 0; q < min(held ? 1 : ST, nst); "
                "++q) load(q);",
                "    for (int q = 0; q < min(held ? 0 : ST, nst); ++q) "
                "load(q);"),
               (_GEMV, "      for (int q = 1; q < min(ST, nst); ++q) load(q);",
                "      for (int q = 0; q < min(ST, nst); ++q) load(q);")),
    # a timing probe (right answers): each block's %globaltimer at its
    # phases' ends and its SM, read back through gemv_times()
    "diag_timeline": (
        (_GEMV, "// Three blocks an SM (72 registers a thread)",
         _STAMP + "// Three blocks an SM (72 registers a thread)"),
        (_GEMV, "  auto load = [&](int q) {", "  stamp(0);\n"
         "  auto load = [&](int q) {"),
        (_GEMV, "  cluster_sync();   // every block's maxima are in place",
         "  stamp(1);\n  cluster_sync();\n  stamp(2);"),
        (_GEMV, "  int acc[2][4] = {};", "  stamp(3);\n  int acc[2][4] = {};"),
        (_GEMV, "  // (3) the partials (16 x the int32 sums): the second",
         "  stamp(4);\n  // (3) the partials (16 x the int32 sums): the "
         "second"),
        (_GEMV, "      wg::wait(&full[q % ST], (q / ST) & 1);",
         "      wg::wait(&full[q % ST], (q / ST) & 1);\n"
         "      if (q == nst - 1) stamp(8);"),
        (_GEMV, "  cluster_sync();   // every block's partials are in their "
         "owners' parts", "  stamp(5);\n  cluster_sync();\n  stamp(6);"),
        (_GEMV, "          __fmul_rn(__fmul_rn(__int2float_rn(sum >> 4), "
         "scale_s[r]),\n                    __ldg(p.sw + n));\n    }\n  }\n",
         "          __fmul_rn(__fmul_rn(__int2float_rn(sum >> 4), "
         "scale_s[r]),\n                    __ldg(p.sw + n));\n    }\n  }\n"
         "  stamp(7);\n"),
        (_GEMV, 'extern "C" int w4a8_gemv_fq(',
         _TIMES + 'extern "C" int w4a8_gemv_fq(')),
}
_W16V = "w4a16_gemv.cu"
_W16G = "w4a16_wgmma.cuh"
_BT = "  *bt = w4::token_tile(M, N, sms);"
W4A16_VARIANTS = {
    "shipped": (),
    # the shipped source, the GEMV's cluster forced (w4a16_gemv_call)
    "cl1": (), "cl2": (), "cl4": (), "cl8": (),
    # the GEMM's token tile forced
    "bt64": ((_W16G, _BT, "  *bt = 64;"),),
    "bt128": ((_W16G, _BT, "  *bt = 128;"),),
    # rung 07 (w4a16_gemm): C staged in two buffers of 16 tokens a warp
    # (the same 32 KB), or each thread adding C itself (float4 loads and
    # stores, 2 stages)
    "c16x2": ((_W16G, "using C_STAGING = w4::Staging<32, 1>;",
               "using C_STAGING = w4::Staging<16, 2>;"),),
    "c_threads": ((_W4, "  if (!S::LOAD_C) return c == out ? C_REDUCE : "
                   "C_THREADS;", "  if (!S::LOAD_C) return C_THREADS;"),
                  *_float4_c(_W16G)),
    # a timing probe (right answers): each GEMV block's %globaltimer at
    # its phases' ends and its SM, read back through gemv_times()
    "diag_timeline": (
        (_W16V, "// Three blocks an SM where their shared memory allows",
         _STAMP + "// Three blocks an SM where their shared memory allows"),
        (_W16V, "  if (!producer) load_x(threadIdx.x);",
         "  stamp(0);\n  if (!producer) load_x(threadIdx.x);"),
        (_W16V, "    wg::bar_sync(1, CONSUMERS);   // A's slice is in place\n",
         "    wg::bar_sync(1, CONSUMERS);\n    stamp(1);\n"),
        (_W16V, "      const uint8_t* stage = ring + (q % ST) * STAGE;\n",
         "      const uint8_t* stage = ring + (q % ST) * STAGE;\n"
         "      if (q == nst - 1) stamp(2);\n"),
        (_W16V, "  cluster_sync();   // every block is done with its ring "
         "and its A", "  stamp(3);\n  cluster_sync();\n  stamp(4);"),
        (_W16V, "  cluster_sync();   // every block's partials are in their "
         "owners' rings", "  stamp(5);\n  cluster_sync();\n  stamp(6);"),
        (_W16V, "          __fmul_rn(sum, __ldg(p.sw + n));\n    }\n  }\n",
         "          __fmul_rn(sum, __ldg(p.sw + n));\n    }\n  }\n"
         "  stamp(7);\n"),
        (_W16V, 'extern "C" int w4a16_gemv(',
         _TIMES.replace("htog::fq::", "htog::gv::")
         + 'extern "C" int w4a16_gemv(')),
}
_MN = "fp32_gemm_mn_tile.cu"
_KB = "fp32_gemm_k_blocked.cu"
_X3 = "bf16x3_mma.cuh"
_KB_ST = (_KB, "constexpr int ST = 3; ")
_PLANES_LOOP = """  Planes<T>* planes =
      reinterpret_cast<Planes<T>*>(smem + ST * sizeof(Stage<T>));
  for (int j = 0; j < ST; ++j) copy(j);
  s.seed(c, M, N, ldc);
  cp_async_wait<ST - 1>();
  __syncthreads();
  split_stage(planes[0], ring[0]);
  for (int kt = 0; kt < nk; s.promote()) {
    for (const int end = min(nk, kt + per); kt < end; ++kt) {
      // step kt + 1 landed; step kt's planes written and step kt - 1's
      // read by every warp
      cp_async_wait<ST - 2>();
      __syncthreads();
      copy(kt + ST);  // into step kt's slot, split a step ago
      s.step_planes(planes[kt & 1]);
      split_stage(planes[(kt + 1) & 1], ring[(kt + 1) % ST]);
    }
  }
"""
# rung 03 with no split pass and no planes: each warp splits the fp32
# values it reads from the ring into its own fragments (A by float2, B
# down its columns), one step ahead of ST - 1 copies
_KB_FRAGMENTS = (
    (_X3, "  // out = tot (+ c when c is given), masked to M x N.",
     """  // One K step from an fp32 stage, each warp splitting the values it
  // reads into its fragments.
  __device__ __forceinline__ void step_fp32(const Stage<T>& st) {
    int lane = threadIdx.x & 31;
    int g = lane >> 2, t = lane & 3;
    int warp = threadIdx.x >> 5;
    int wr = (warp / T::WN) * T::MI * 16;
    int wc = (warp % T::WN) * T::NI * 8;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][T::MI][4];
      uint32_t b[2][T::NI][2];
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // registers a0..a3: (g, k), (g + 8, k), (g, k + 8), (g + 8, k + 8)
          int r = wr + mi * 16 + g + (j & 1) * 8;
          int k = kk + 2 * t + (j >> 1) * 8;
          const float2 v = *reinterpret_cast<const float2*>(&st.a[r][k]);
          fa::split_pack(v.x, v.y, a[0][mi][j], a[1][mi][j]);
        }
      }
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni) {
        int n = wc + ni * 8 + g;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          int k = kk + 2 * t + j * 8;
          fa::split_pack(st.b[k][n], st.b[k + 1][n], b[0][ni][j],
                         b[1][ni][j]);
        }
      }
      products(a, b);
    }
  }

  // out = tot (+ c when c is given), masked to M x N."""),
    (_KB, "ST * sizeof(Stage<T>) + 2 * sizeof(Planes<T>)",
     "ST * sizeof(Stage<T>)"),
    (_KB, _PLANES_LOOP, """  for (int j = 0; j < ST - 1; ++j) copy(j);
  s.seed(c, M, N, ldc);
  for (int kt = 0; kt < nk; s.promote()) {
    for (const int end = min(nk, kt + per); kt < end; ++kt) {
      // step kt landed; step kt - 1's slot read by every warp
      cp_async_wait<ST - 2>();
      __syncthreads();
      copy(kt + ST - 1);
      s.step_fp32(ring[kt % ST]);
    }
  }
"""))


def _ladder_ch(steps: int):
    return ((_X3, "constexpr int CH = 4; ", f"constexpr int CH = {steps}; "),)


LADDER_VARIANTS = {
    "shipped": (),
    # rung 03's ring of 2 or 4 stages
    "st2": ((*_KB_ST, "constexpr int ST = 2; "),),
    "st4": ((*_KB_ST, "constexpr int ST = 4; "),),
    # each warp splits the fp32 values it reads into its fragments (no
    # split pass, no planes), at 3 and 4 stages
    "split_in_fragments": _KB_FRAGMENTS,
    "split_in_fragments_st4": (*_KB_FRAGMENTS,
                               (*_KB_ST, "constexpr int ST = 4; ")),
    # the tensor cores' partials of 2, 8 or 16 K steps (64, 256, 512 K),
    # and one sum over all of K (CH 0: never promoted before the end)
    "ch2": _ladder_ch(2),
    "ch8": _ladder_ch(8),
    "ch16": _ladder_ch(16),
    "straight": _ladder_ch(0),
    # the 128-wide blocks' 8 warps 2 x 4 (64 x 32 each, int8_mma.cuh's
    # layout), rungs 02 and 03
    "warps_2x4": ((_MN, "Tile<128, 4, 2>", "Tile<128, 2, 4>"),
                  (_KB, "Tile<128, 4, 2>", "Tile<128, 2, 4>")),
    # diagnostics, wrong answers: rung 03 without its split pass (the
    # planes left as they were), and every rung with hi.hi alone
    "diag_no_split": ((_KB, "      split_stage(planes[(kt + 1) & 1], "
                       "ring[(kt + 1) % ST]);\n", ""),),
    "diag_hi_only": ((_X3, "for (int p = 0; p < 3; ++p)",
                      "for (int p = 0; p < 1; ++p)"),),
}
# the headers the variants may change besides the groups' sources
HEADERS = (_BODY, _GW, _DA, _W4, _W16G, _X3, _WG)

GROUPS = {
    "forward": (("flash_attention.cu", "flash_attention_fwd_lse.cu"),
                FORWARD_VARIANTS),
    "dkv": ((_DKV,), DKV_VARIANTS),
    "dq": ((_DQ,), DQ_VARIANTS),
    "gemm": ((_GEMM, _FP32, _NN, _FP32_NN), GEMM_VARIANTS),
    "paged": ((_PAGED,), PAGED_VARIANTS),
    "w4a8": (("w4a8_gemm_noc.cu", "w4a8_gemm.cu", "decode_attention_q8.cu"),
             W4A8_VARIANTS),
    "int8": ((_K2, _R18, _NOC, _NN1), INT8_VARIANTS),
    "gemv": ((_GEMV, "paged_decode_attention.cu"), GEMV_VARIANTS),
    "w4a16": ((_W16V, "w4a16_gemm_noc.cu", "w4a16_gemm.cu"),
              W4A16_VARIANTS),
    "strip": ((_STRIP, "int8_hand_pipe.cu", _K2), STRIP_VARIANTS),
    "pingpong": ((_FAT, _RES, _STRIP, _K2), PINGPONG_VARIANTS),
    "tiled": ((_RES, "paged_kv_update.cu", "kv_update.cu"), TILED_VARIANTS),
    "ladder": ((_MN, _KB), LADDER_VARIANTS),
}
# the csrc/ tree in use (set by use())
_ACTIVE: list = [None]


def prepare(group: str, name: str, subs) -> pathlib.Path:
    """The port's csrc/ copied under OUT_DIR/group/name with ``subs``
    applied."""
    dst = OUT_DIR / group / name / "csrc"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(_build.CSRC, dst)
    for file, old, new in subs:
        path = dst / file
        text = path.read_text()
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} occurs "
                             f"{text.count(old)} times in {file}")
        path.write_text(text.replace(old, new))
    return dst


def use(csrc: pathlib.Path, sources) -> None:
    """Point the build at ``csrc`` (the next launch loads its library)."""
    _build.CSRC = csrc
    _ACTIVE[0] = csrc
    for src in sources:
        _build._LIBS.pop(src, None)


def build(trees: dict, sources) -> None:
    """The group's sources of every tree, one nvcc each, all at once (a
    source whose library another tree already builds -- the same text and
    headers -- once); then each build's ptxas lines."""
    started, libs = [], set()
    for csrc in trees.values():
        use(csrc, sources)
        for src in sources:
            if _build._lib_path(src) not in libs:
                libs.add(_build._lib_path(src))
                started.append((csrc, src, _build._start_build(src)))
    for csrc, src, s in started:
        if s is not None:
            use(csrc, sources)
            _build._finish_build(src, s)
    kernels = [k for k, spec in _build.KERNELS.items()
               if spec.source in sources]
    for name, csrc in trees.items():
        use(csrc, sources)
        for kernel in kernels:
            lines = [ln for ln in _build.build_log(kernel).splitlines()
                     if "Compiling" in ln or "registers" in ln
                     or "spill" in ln or "arning" in ln
                     or "Performance" in ln]
            print(f"[{name}] {kernel} build:\n  " + "\n  ".join(lines))


def _same_bits(seen: dict, key: str, *outs) -> str:
    """Whether ``outs`` equal bit for bit those of the first tree checked
    under ``key`` (that tree's are kept)."""
    if key not in seen:
        seen[key] = outs
        return "the first tree's bits"
    same = all(torch.equal(a, b) for a, b in zip(seen[key], outs))
    return ("bits equal to the first tree's" if same
            else "bits DIFFER from the first tree's")


def _views(b, n, heads, d, gen, dtype):
    return torch.randn((b, n, heads, d), generator=gen, device="cuda").to(
        dtype).transpose(1, 2)


def forward_cases(gen, tiles):
    """{case: fn}, {key tile: plain outputs}, and the check of a variant."""
    q, k, v = (_views(4, 4096, 32, 128, gen, torch.bfloat16) for _ in "qkv")
    tq = _views(8, 1024, 32, 64, gen, torch.float32)
    tk, tv = (_views(8, 1024, 4, 64, gen, torch.bfloat16) for _ in "kv")
    cases = {
        "flash_attention": lambda: attention.flash_attention(q, k, v),
        "flash_attention_fwd_lse": lambda: attention.flash_attention_fwd_lse(
            tq, tk, tv)}
    refs = {bk: (attention.flash_attention_ref(q, k, v, bk=bk),
                 attention.flash_attention_fwd_lse_ref(tq, tk, tv, bk=bk))
            for bk in sorted(set(tiles.values()))}
    seen = {}

    def check(name):
        out = cases["flash_attention"]()
        o2, lse = cases["flash_attention_fwd_lse"]()
        ref, (ref2, ref_lse) = refs[tiles[name]]
        return (f"key tile {tiles[name]}: flash_attention "
                f"{float(attention.bf16_row_ulps(out, ref).max()):.3f} bf16 "
                f"ulps of its row's max |plain|; fwd_lse out "
                f"{float(attention.row_rel_err(o2, ref2).max()):.3e} of its "
                f"row's max, lse {float((lse - ref_lse).abs().max()):.3e}; "
                f"{_same_bits(seen, tiles[name], out, o2, lse)}")

    sdpa = torch.nn.functional.scaled_dot_product_attention
    library = {
        "flash_attention": lambda: sdpa(q, k, v, is_causal=True),
        "flash_attention_fwd_lse": lambda: sdpa(
            tq.to(torch.bfloat16), tk, tv, is_causal=True, enable_gqa=True)}
    return cases, check, {c: time_calls(fn, graph=True) * 1e3
                          for c, fn in library.items()}


# (B, H, KVH, S, D): the soak's row, the 7B training row, T-moe's row
DKV_SHAPES = ((8, 32, 4, 1024, 64), (2, 32, 32, 2048, 128),
              (2, 32, 8, 1025, 128))


def sdpa_backward_ms(q16, k, v, do16, causal: bool = True) -> float:
    """SDPA's whole backward (dq, dk, dv) on bf16 operands as CUDA-graph
    replays: the replay of its forward and backward less the replay of its
    forward (the backward cannot be captured without the forward that
    records it)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gqa = q16.shape[1] != k.shape[1]
    qb, kb, vb = (x.detach().requires_grad_() for x in (q16, k, v))

    def fwd():
        return sdpa(qb, kb, vb, is_causal=causal, enable_gqa=gqa)

    def fwd_bwd():
        return torch.autograd.grad(fwd(), (qb, kb, vb), do16)
    return (time_calls(fwd_bwd, graph=True)
            - time_calls(fwd, graph=True)) * 1e3


def dkv_cases(gen, tiles):
    cases, refs, library = {}, {}, {}
    for b, h, kvh, s, d in DKV_SHAPES:
        q, do = (_views(b, s, h, d, gen, torch.float32) for _ in "qd")
        k, v = (_views(b, s, kvh, d, gen, torch.bfloat16) for _ in "kv")
        out, lse = attention.flash_attention_fwd_lse_ref(q, k, v, bk=64)
        args = (q, k, v, do, lse, (do * out).sum(dim=-1))
        case = f"dkv B={b} H={h} KVH={kvh} S={s} D={d}"
        cases[case] = (lambda a=args: attention.flash_attention_bwd_dkv(*a))
        refs[case] = attention.flash_attention_bwd_dkv_ref(*args)
        library[case] = sdpa_backward_ms(q.to(torch.bfloat16), k, v,
                                         do.to(torch.bfloat16))

    seen = {}

    def check(name):
        rel = attention.row_rel_err
        parts = []
        for case, fn in cases.items():
            dk, dv = fn()
            again = fn()
            same = torch.equal(dk, again[0]) and torch.equal(dv, again[1])
            ek = float(rel(dk, refs[case][0]).max())
            ev = float(rel(dv, refs[case][1]).max())
            parts.append(f"{case}: dk {ek:.3e}, dv {ev:.3e} of the row's "
                         f"max, repeat {'equal' if same else 'DIFFERS'}, "
                         f"{_same_bits(seen, case, dk, dv)}")
        return "; ".join(parts)
    return cases, check, library


def dq_cases(gen, tiles):
    """dq at ``DKV_SHAPES``, held to its plain version (``row_rel_err``),
    two calls bit-equal."""
    cases, refs = {}, {}
    for b, h, kvh, s, d in DKV_SHAPES:
        q, do = (_views(b, s, h, d, gen, torch.float32) for _ in "qd")
        k, v = (_views(b, s, kvh, d, gen, torch.bfloat16) for _ in "kv")
        out, lse = attention.flash_attention_fwd_lse_ref(q, k, v, bk=64)
        args = (q, k, v, do, lse, (do * out).sum(dim=-1))
        case = f"dq B={b} H={h} KVH={kvh} S={s} D={d}"
        cases[case] = (lambda a=args: attention.flash_attention_bwd_dq(*a))
        refs[case] = attention.flash_attention_bwd_dq_ref(*args)

    def check(name):
        parts = []
        for case, fn in cases.items():
            dq = fn()
            same = torch.equal(dq, fn())
            err = float(attention.row_rel_err(dq, refs[case]).max())
            parts.append(f"{case}: {err:.3e} of the row's max, repeat "
                         f"{'equal' if same else 'DIFFERS'}")
        return "; ".join(parts)
    return cases, check, {}


def _split_route(source: str = _FP32) -> bool:
    """Whether the tree in use computes rung 16 (``source`` ``_FP32_NN``:
    rung 04) from split bf16 planes (this tree); an older tree's kernel
    takes the fp32 operands (the FFMA kernel before the split route)."""
    marker = "split_nmajor_map" if source == _FP32_NN else "split_map"
    return marker in (_build.CSRC / source).read_text()


def fp32_bt(a, bt, c):
    """Rung 16 on the tree in use: its wrapper, or the older trees' direct
    launch on fp32 operands."""
    if _split_route():
        return tuned.mmult_fp32_bt(a, bt, c)
    return tuned.launch_gemm("mmult_fp32_bt", "fp32_gemm_nt", a, bt, c, c,
                             torch.float32, bt=True)


def fp32_product(a2, b2, a, bt, c):
    """Rung 16's kernel alone on planes split beforehand (an older tree:
    its kernel on the fp32 operands)."""
    if not _split_route():
        return fp32_bt(a, bt, c)
    m, n = c.shape
    k = a2.shape[2]
    _build.launch("fp32_gemm_nt", c.device, a2, b2, c, c, m, n, k, k, k, n)
    return c


def fp32_nn(a, b, c):
    """Rung 04 on the tree in use: its wrapper, or the older trees' direct
    launch on fp32 operands (a fresh output)."""
    if _split_route(_FP32_NN):
        return tuned.mmult(a, b, c)
    return tuned.launch_gemm("mmult", "fp32_gemm_nn", a, b, c,
                             torch.empty_like(c), torch.float32, bt=False)


def fp32_nn_product(a2, b2, a, b, c):
    """Rung 04's kernel alone on planes split beforehand, into a fresh
    output (an older tree: its kernel on the fp32 operands)."""
    if not _split_route(_FP32_NN):
        return fp32_nn(a, b, c)
    m, n = c.shape
    out = torch.empty_like(c)
    _build.launch("fp32_gemm_nn", c.device, a2, b2, c, out, m, n,
                  a.shape[1], a2.shape[2], b2.shape[2], n)
    return out


def gemm_cases(gen, tiles):
    """Rungs 15, 16 and 04 (the wrapper with its splits, and the kernel
    alone on planes split beforehand) and 05 at 4,096 and 2,048; each held
    to its plain version relative to max |plain|, two calls bit-equal,
    rungs 05's and 04's C left as it was; 01b's two calls (rungs 15 and
    05) and 01's (16 and 04) beside them."""
    cases, rows, library = {}, {}, {}
    for p in (4096, 2048):
        a, b, c = (torch.rand((p, p), generator=gen, device="cuda") * 2 - 1
                   for _ in "abc")
        a16, bt16 = tuned.prepare_bf16_bt(a, b)
        b16 = b.to(torch.bfloat16)
        bt = b.t().contiguous()
        a2, b2 = grouped_gemm.split_bf16(a), grouped_gemm.split_bf16(bt)
        bn2 = grouped_gemm.split_bf16(b)
        # name: (run(c), plain(c), library(c)), each on a C of its own
        for name, row in {
                "bf16_gemm_nt": (
                    lambda c, a16=a16, bt16=bt16:
                    tuned.mmult_bf16_bt(a16, bt16, c),
                    lambda c, a16=a16, bt16=bt16:
                    tuned.mmult_bf16_bt_ref(a16, bt16, c),
                    lambda c, a16=a16, bt16=bt16:
                    vendor.mmult_bf16(a16, bt16.t(), c)),
                "fp32_gemm_nt": (
                    lambda c, a=a, bt=bt: fp32_bt(a, bt, c),
                    lambda c, a=a, bt=bt: tuned.mmult_fp32_bt_ref(a, bt, c),
                    lambda c, a=a, bt=bt: vendor.mmult(a, bt.t(), c)),
                "fp32_gemm_nt alone": (
                    lambda c, a2=a2, b2=b2, a=a, bt=bt:
                    fp32_product(a2, b2, a, bt, c), None, None),
                "fp32_gemm_nn": (
                    lambda c, a=a, b=b: fp32_nn(a, b, c),
                    lambda c, a=a, b=b: tuned.mmult_ref(a, b, c),
                    lambda c, a=a, b=b: vendor.mmult(a, b, c)),
                "fp32_gemm_nn alone": (
                    lambda c, a2=a2, bn2=bn2, a=a, b=b:
                    fp32_nn_product(a2, bn2, a, b, c), None, None),
                "bf16_gemm_nn": (
                    lambda c, a16=a16, b16=b16: tuned.mmult_bf16(a16, b16, c),
                    lambda c, a16=a16, b16=b16:
                    tuned.mmult_bf16_ref(a16, b16, c),
                    lambda c, a16=a16, b16=b16:
                    vendor.mmult_bf16(a16, b16, c))}.items():
            case = f"{name} p={p}"
            run, plain, lib = row
            work = c.clone()
            cases[case] = lambda run=run, work=work: run(work)
            if plain is not None:
                rows[case] = (run, plain, c)
            if lib is not None:
                library[case] = time_calls(lambda lib=lib, c=c: lib(c),
                                           graph=True) * 1e3

    def check(name):
        parts = []
        for case, (run, plain, c) in rows.items():
            ref = plain(c)
            cin = c.clone()
            out = run(cin)
            again = run(c.clone())
            err = float((out - ref).abs().max() / ref.abs().max())
            same = torch.equal(out, again)
            kept = ("" if out.data_ptr() == cin.data_ptr() else
                    f", C {'unchanged' if torch.equal(cin, c) else 'CHANGED'}")
            parts.append(f"{case}: {err:.3e} of max |plain|, repeat "
                         f"{'equal' if same else 'DIFFERS'}{kept}")
        return "; ".join(parts)
    return cases, check, library


def paged_cases(gen, tiles):
    """The paged KV8 kernel at the smoke's two shapes over shuffled block
    tables, each held to its plain version (max abs)."""
    from how_to_optimize_gemm_tpu_torch.models import llama
    cases, refs = {}, {}
    for kvh, rep, d, ps, lens in ((32, 1, 128, 384, [1, 300, 1000, 4096]),
                                  (3, 2, 32, 96, [1, 999, 1000, 517])):
        np_max = -(-max(lens) // ps)
        n_pages = len(lens) * np_max + 1
        free = (torch.randperm(n_pages - 1, generator=gen, device="cuda")
                + 1).tolist()
        table = torch.zeros((len(lens), np_max), dtype=torch.int32)
        for b, n in enumerate(lens):
            for c in range(-(-n // ps)):
                table[b, c] = free.pop()
        q = torch.randn((len(lens), kvh * rep, d), generator=gen,
                        device="cuda")
        pools = []
        for _ in "kv":
            pools += llama.quantize_kv(torch.randn(
                (n_pages, ps, kvh, d), generator=gen, device="cuda"))
        args = (q, *pools, table.cuda(),
                torch.tensor(lens, dtype=torch.int32, device="cuda"))
        case = f"paged_decode_attention_q8 kvh={kvh} rep={rep} d={d} ps={ps}"
        cases[case] = (lambda a=args:
                       paged_attention.paged_decode_attention_q8(*a))
        refs[case] = paged_attention.paged_decode_attention_q8_ref(*args)

    def check(name):
        return "; ".join(f"{case}: max|kernel - plain| "
                         f"{float((fn() - refs[case]).abs().max()):.3e}"
                         for case, fn in cases.items())
    return cases, check, {}


# an older tree's decode_attention_q8 (the one-block walk): (q, qk, sk,
# qv, sv, lengths, out, B, T, KVH, REP, D, bk, scale, stream)
_ONE_BLOCK_Q8 = ((ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 6
                 + (ctypes.c_float, ctypes.c_void_p))


def decode_q8(q, qk, sk, qv, sv, lengths):
    """decode_attention_q8 on the tree in use: its wrapper, or an older
    tree's one-block kernel launched with its own arguments."""
    name = "decode_attention_q8"
    if "launch_decode_attention_split" in (
            _build.CSRC / _build.KERNELS[name].source).read_text():
        return decode_attention.decode_attention_q8(q, qk, sk, qv, sv,
                                                    lengths)
    b, h, d = q.shape
    t, kvh = qk.shape[1], qk.shape[2]
    bk = decode_attention.pick_block(t, kvh, d, 1)
    out = torch.empty((b, h * d), device=q.device)
    fn = _build.c_function(_build.KERNELS[name].source, name, _ONE_BLOCK_Q8)
    err = fn(*(x.data_ptr() for x in (q, qk, sk, qv, sv, lengths, out)), b,
             t, kvh, h // kvh, d, bk, d ** -0.5,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} (one-block walk) launch failed: "
                           f"cudaError {err}")
    return out


def _w4a8_fresh_c(args, c):
    """K3 on a copy of c."""
    return int4.mmult_q_w4a8(*args, c.clone())


def w4a8_cases(gen, tiles):
    """w4a8_gemm_noc at the 7B prefill widths and at chunks of 65-512
    tokens (where the token-tile rule picks 64 and where it picks 128) and
    K3 at 4,096 and 2,048 (timed on a C of its own, checked on fresh
    copies of C), each EQUAL to its plain version (and two calls
    bit-equal), and decode_attention_q8 at the smoke's three shapes, held
    to its plain version (max abs)."""
    from how_to_optimize_gemm_tpu_torch.models import llama
    cases, refs = {}, {}
    for m, k, n in ((1024, 4096, 11008), (1024, 11008, 4096),
                    (16384, 4096, 11008), (256, 4096, 11008),
                    (65, 4096, 11008), (128, 4096, 11008),
                    (128, 11008, 4096), (256, 4096, 4096),
                    (512, 4096, 11008)):
        x = torch.randn((m, k), generator=gen, device="cuda")
        w = torch.randn((k, n), generator=gen, device="cuda")
        args = int4.prepare_w4a8(x, w)[:4]
        case = f"w4a8_gemm_noc M={m} {k}->{n}"
        cases[case] = lambda a=args: int4.mmult_q_w4a8_noc(*a)
        refs[case] = (True, int4.mmult_q_w4a8_noc_ref(*args))
        del x, w
    for p in (4096, 2048):
        a, b, c = (torch.rand((p, p), generator=gen, device="cuda") * 2 - 1
                   for _ in "abc")
        args = int4.prepare_w4a8(a, b)[:4]
        case = f"w4a8_gemm p={p}"
        work = c.clone()
        cases[case] = lambda a=args, work=work: int4.mmult_q_w4a8(*a, work)
        refs[case] = (True, int4.mmult_q_w4a8_ref(*args, c), args, c)
    for kvh, rep, d, t, lens in ((32, 1, 128, 4096, [1, 300, 1000, 4096]),
                                 (8, 4, 128, 4096, [1, 300, 1000, 4096]),
                                 (3, 2, 64, 1000, [1, 999, 1000, 517])):
        q = torch.randn((len(lens), kvh * rep, d), generator=gen,
                        device="cuda")
        cache = []
        for _ in "kv":
            cache += llama.quantize_kv(torch.randn(
                (len(lens), t, kvh, d), generator=gen, device="cuda"))
        args = (q, *cache, torch.tensor(lens, dtype=torch.int32,
                                        device="cuda"))
        case = f"decode_attention_q8 kvh={kvh} rep={rep} d={d} T={t}"
        cases[case] = lambda a=args: decode_q8(*a)
        refs[case] = (False, decode_attention.decode_attention_q8_ref(*args))

    def check(name):
        parts = []
        for case, fn in cases.items():
            exact, ref, *in_place = refs[case]
            if in_place:   # K3: each call on a fresh copy of its C
                fn = functools.partial(_w4a8_fresh_c, *in_place)
            out = fn()
            if exact:
                equal = torch.equal(out, ref)
                same = torch.equal(out, fn())
                parts.append(f"{case}: {'EQUAL' if equal else 'DIFFERS'}, "
                             f"repeat {'equal' if same else 'DIFFERS'}")
            else:
                parts.append(f"{case}: max|kernel - plain| "
                             f"{float((out - ref).abs().max()):.3e}")
        return "; ".join(parts)
    return cases, check, {}


def int8_cases(gen, tiles):
    """K2 at 4,096, 2,048 and 3,584 and rung 18 at 4,096 on its default
    plan and at cap 1,664 (two pieces), each on a C of its own, K1
    (``int8_gemm_nn``, a fresh output, C unchanged) at 4,096 and 2,048, and
    int8_gemm_noc at the 7B prefill widths and a ragged shape, EQUAL to
    the plain version and two calls bit-equal; ``torch._int_mm`` and the
    epilogue beside them (graph replays)."""
    cases, rows, library = {}, {}, {}
    for p in (4096, 2048):
        a, b, c = (torch.rand((p, p), generator=gen, device="cuda") * 2 - 1
                   for _ in "abc")
        ops = int8.prepare(a, b)
        case = f"int8_gemm_nn p={p}"
        cases[case] = lambda o=ops, c=c: int8.mmult_q(*o, c)
        rows[case] = (lambda cc, o=ops: int8.mmult_q(*o, cc), ops, c)
        library[case] = time_calls(
            lambda o=ops, c=c: int8.dequant_epilogue(
                torch._int_mm(o[0], o[2]), o[1], o[3], c), graph=True) * 1e3
    for p in (4096, 2048, 3584):
        a, b, c = (torch.rand((p, p), generator=gen, device="cuda") * 2 - 1
                   for _ in "abc")
        ops = int8.prepare_packed(a, b)
        runs = {f"int8_gemm_nt p={p}": lambda cc, o=ops:
                int8.mmult_q_bt(*o, cc)}
        if p == 4096:
            runs[f"int8_ragged_nt p={p}"] = (
                lambda cc, o=ops: int8.mmult_q_bt_ragged(*o, cc))
            runs[f"int8_ragged_nt p={p} cap 1664"] = (
                lambda cc, o=ops: int8.mmult_q_bt_ragged(*o, cc, cap=1664))
        qa, sa, qbt, sb = ops
        lib = time_calls(lambda: int8.dequant_epilogue(
            torch._int_mm(qa, qbt.t()), sa, sb, c), graph=True) * 1e3
        for case, run in runs.items():
            work = c.clone()
            cases[case] = lambda run=run, work=work: run(work)
            rows[case] = (run, ops, c)
            library[case] = lib

    for m, k, n in ((1024, 4096, 11008), (1024, 11008, 4096),
                    (1000, 1100, 1032)):
        x = torch.randn((m, k), generator=gen, device="cuda")
        w = torch.randn((k, n), generator=gen, device="cuda")
        ops = int8.prepare(x, w)
        case = f"int8_gemm_noc M={m} {k}->{n}"
        cases[case] = lambda o=ops: int8.mmult_q_noc(*o)
        rows[case] = (lambda _, o=ops: int8.mmult_q_noc(*o), ops, None)
        if k % 8 == 0 and n % 8 == 0:   # torch._int_mm's rule
            library[case] = time_calls(
                lambda o=ops: torch._int_mm(o[0], o[2]).to(torch.float32)
                * o[1] * o[3], graph=True) * 1e3

    def check(name):
        parts = []
        for case, (run, ops, c) in rows.items():
            if c is None:   # int8_gemm_noc: no C
                out, again = run(None), run(None)
                ref = int8.mmult_q_noc_ref(*ops)
            elif case.startswith("int8_gemm_nn"):   # K1: C unchanged
                kept = c.clone()
                out, again = run(c), run(c)
                ref = int8.mmult_q_ref(*ops, c)
                if not torch.equal(c, kept):
                    parts.append(f"{case}: C CHANGED")
            else:
                out, again = run(c.clone()), run(c.clone())
                ref = int8.mmult_q_bt_ref(*ops, c)
            equal = torch.equal(out, ref)
            same = torch.equal(out, again)
            parts.append(f"{case}: {'EQUAL' if equal else 'DIFFERS'}, "
                         f"repeat {'equal' if same else 'DIFFERS'}")
        return "; ".join(parts)
    return cases, check, library


def strip_cases(gen, tiles):
    """Rung 11 at 4,096 and 2,048 (a fresh output: EQUAL to its plain
    version, C unchanged, two calls bit-equal) and rung 17's six knobs
    and K2 at 4,096, each on a C of its own (EQUAL to K2's output and to
    the plain version); ``torch._int_mm`` and the epilogue beside them
    (graph replays)."""
    cases, rows, library = {}, {}, {}
    knobs = [(nb, la) for nb in hand_pipeline.B_BUFFERS
             for la in (False, True)]
    for p in (4096, 2048):
        a, b, c = (torch.rand((p, p), generator=gen, device="cuda") * 2 - 1
                   for _ in "abc")
        ops = int8.prepare_packed(a, b)
        qa, sa, qbt, sb = ops
        lib = time_calls(lambda: int8.dequant_epilogue(
            torch._int_mm(qa, qbt.t()), sa, sb, c), graph=True) * 1e3
        case = f"int8_strip_nt p={p}"
        cases[case] = lambda o=ops, c=c: manual_dma.mmult_q_strip(*o, c)
        rows[case] = (None, ops, c)
        library[case] = lib
        if p != 4096:
            continue
        runs = {f"int8_gemm_nt p={p}": lambda cc, o=ops:
                int8.mmult_q_bt(*o, cc)}
        for nb, la in knobs:
            runs[f"int8_hand_pipe_nt p={p} b_buffers={nb} a_lookahead="
                 f"{la}"] = (lambda cc, o=ops, nb=nb, la=la:
                             hand_pipeline.mmult_q_bt_hand(
                                 *o, cc, b_buffers=nb, a_lookahead=la))
        for case, run in runs.items():
            work = c.clone()
            cases[case] = lambda run=run, work=work: run(work)
            rows[case] = (run, ops, c)
            library[case] = lib

    def check(name):
        parts = []
        src = (_build.CSRC / _STRIP).read_text()
        if "int8_strip_nt_active_clusters" in src:
            parts.append("rung 11: clusters of {} blocks, {} at once".format(
                *manual_dma.strip_clusters()))
        k2 = {}
        for case, (run, ops, c) in rows.items():
            ref = int8.mmult_q_bt_ref(*ops, c)
            if run is None:   # rung 11: a fresh output, C unchanged
                kept = c.clone()
                out = manual_dma.mmult_q_strip(*ops, c)
                again = manual_dma.mmult_q_strip(*ops, c)
                torch.cuda.synchronize()
                if not torch.equal(c, kept):
                    parts.append(f"{case}: C CHANGED")
            else:
                out, again = run(c.clone()), run(c.clone())
                if case.startswith("int8_gemm_nt"):
                    k2[case.split()[1]] = out
                elif not torch.equal(out, k2[case.split()[1]]):
                    parts.append(f"{case}: DIFFERS from int8_gemm_nt")
            parts.append(f"{case}: "
                         f"{'EQUAL' if torch.equal(out, ref) else 'DIFFERS'}"
                         f", repeat "
                         f"{'equal' if torch.equal(out, again) else 'DIFFERS'}")
        return "; ".join(parts)
    return cases, check, library


def pingpong_cases(gen, tiles):
    """Rungs 10 and 12 (fresh outputs) and rung 11 at 4,096 and 2,048, and
    K2 at 4,096 on a C of its own: each EQUAL to the plain version, rungs
    10-12 with C unchanged, two calls bit-equal; ``torch._int_mm`` and the
    epilogue beside them (graph replays)."""
    cases, rows, library = {}, {}, {}
    fresh = {"int8_fat_nt": manual_dma.mmult_q_packed,
             "int8_resident_nt": manual_dma.mmult_q_resident,
             "int8_strip_nt": manual_dma.mmult_q_strip}
    for p in (4096, 2048):
        a, b, c = (torch.rand((p, p), generator=gen, device="cuda") * 2 - 1
                   for _ in "abc")
        ops = int8.prepare_packed(a, b)
        qa, sa, qbt, sb = ops
        lib = time_calls(lambda: int8.dequant_epilogue(
            torch._int_mm(qa, qbt.t()), sa, sb, c), graph=True) * 1e3
        for kernel, fn in fresh.items():
            case = f"{kernel} p={p}"
            cases[case] = lambda fn=fn, o=ops, c=c: fn(*o, c)
            rows[case] = (fn, ops, c, False)
            library[case] = lib
        if p == 4096:
            case = f"int8_gemm_nt p={p}"
            work = c.clone()
            cases[case] = lambda o=ops, work=work: int8.mmult_q_bt(*o, work)
            rows[case] = (int8.mmult_q_bt, ops, c, True)
            library[case] = lib

    def check(name):
        parts = []
        for case, (fn, ops, c, in_place) in rows.items():
            ref = int8.mmult_q_bt_ref(*ops, c)
            kept = c.clone()
            if in_place:
                out, again = fn(*ops, c.clone()), fn(*ops, c.clone())
            else:
                out, again = fn(*ops, c), fn(*ops, c)
            torch.cuda.synchronize()
            if not torch.equal(c, kept):
                parts.append(f"{case}: C CHANGED")
            parts.append(f"{case}: "
                         f"{'EQUAL' if torch.equal(out, ref) else 'DIFFERS'}"
                         f", repeat "
                         f"{'equal' if torch.equal(out, again) else 'DIFFERS'}")
        return "; ".join(parts)
    return cases, check, library


# an older tree's w4a8_gemv_fq (a quantize pass, then the GEMV): (x,
# packed, sw, qa, sa, out, M, N, Kp, ldp, stream); its paged bf16 kernel
# (the one-block walk): (q, k, v, table, lengths, out, B, NP, PS, np_max,
# KVH, REP, D, scale, stream)
_TWO_LAUNCH_GEMV = ((ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 4
                    + (ctypes.c_void_p,))
_ONE_BLOCK_PAGED = ((ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 7
                    + (ctypes.c_float, ctypes.c_void_p))


def _older(name: str) -> bool:
    """Whether the tree in use holds an older ABI of ``name``."""
    text = (_build.CSRC / _build.KERNELS[name].source).read_text()
    marker = {"w4a8_gemv_fq": "int ldx, int Kp, int ldp, int cluster,",
              "paged_decode_attention": "launch_decode_attention_split",
              "w4a16_gemv": "int ldp, int cluster, void* stream",
              "int8_tiled_resident_nt": "launch_tiled<htog::Rung13>",
              "paged_kv_update": "const void* pages, const void* offs,"}
    return marker[name] not in text


def tiled_images(x):
    """x (rows, K) int8 as the tree in use's int8_pretile lays it out:
    (tiles, ceil(K / 128), 128, 128) stage images, or an older tree's
    (tiles, ceil(K / 64), 128, 80) slot images."""
    rows, k = x.shape
    kq, width = ((64, 80) if _older("int8_tiled_resident_nt")
                 else (int8.STAGE_K, int8.STAGE_K))
    tiles, nk = -(-rows // manual_dma.BM), -(-k // kq)
    out = torch.empty((tiles, nk, manual_dma.BM, width), dtype=torch.int8,
                      device=x.device)
    _build.launch("int8_pretile", x.device, x, out, rows, k, k, tiles, nk)
    return out


def tiled_gemm(at, bt, sa, sb, c, k):
    """Rung 13's GEMM on images of the tree in use (lda, ldb not read;
    N a multiple of 4 and K of 16: no padding), a fresh output."""
    m, n = c.shape
    out = torch.empty_like(c)
    _build.launch("int8_tiled_resident_nt", c.device, at, bt, sa, sb, c,
                  out, m, n, k, 0, 0, n)
    return out


# an older tree's paged_kv_update: (pool, new, tab, mask, B, S, NP, PS,
# row_bytes, stream), tab the (B, S, 2) stack of pages and offs
_STACKED_PAGED = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 5
                  + (ctypes.c_void_p,))


def paged_update_call(pool, new, pages, offs, tab=None):
    """paged_kv_update on the tree in use: its wrapper, or an older tree's
    kernel on a stacked table as its wrapper called it (the stack made in
    the call, or ``tab`` made beforehand)."""
    name = "paged_kv_update"
    if not _older(name):
        return kv_update.paged_kv_update(pool, new, pages, offs)
    if tab is None:
        tab = torch.stack([pages, offs], -1)
    fn = _build.c_function(_build.KERNELS[name].source, name,
                           _STACKED_PAGED)
    b, s = new.shape[:2]
    row = new[0, 0].numel() * new.element_size()
    err = fn(pool.data_ptr(), new.data_ptr(), tab.data_ptr(), None, b, s,
             pool.shape[0], pool.shape[1], row,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return pool


def tiled_cases(gen, tiles):
    """Rung 13 (the call, and the GEMM alone on images made beforehand by
    the tree's own repack) and rung 12 at 4,096 and 2,048, the repack alone
    on A, and paged_kv_update beside kv_update at the 7B pools (graph
    replays); each held to its plain version, two calls bit-equal."""
    from how_to_optimize_gemm_tpu_torch.models import llama
    cases, checks, library = {}, {}, {}
    for p in (4096, 2048):
        a, b, c = (torch.rand((p, p), generator=gen, device="cuda") * 2 - 1
                   for _ in "abc")
        ops = int8.prepare_packed(a, b)
        qa, sa, qbt, sb = ops
        ref = int8.mmult_q_bt_ref(*ops, c)
        lib = time_calls(lambda: int8.dequant_epilogue(
            torch._int_mm(qa, qbt.t()), sa, sb, c), graph=True) * 1e3
        imgs = {}

        def call(o=ops, c=c, p=p):
            return tiled_gemm(tiled_images(o[0]), tiled_images(o[2]), o[1],
                              o[3], c, p)

        def gemm(o=ops, c=c, p=p, imgs=imgs):
            return tiled_gemm(*imgs[_ACTIVE[0]], o[1], o[3], c, p)

        def prepare_images(o=ops, imgs=imgs):
            imgs[_ACTIVE[0]] = (tiled_images(o[0]), tiled_images(o[2]))
        rows = {f"int8_tiled_resident_nt call p={p}": call,
                f"int8_tiled_resident_nt gemm p={p}": gemm,
                f"int8_resident_nt call p={p}":
                    lambda o=ops, c=c: manual_dma.mmult_q_resident(*o, c)}
        for case, fn in rows.items():
            cases[case] = fn
            library[case] = lib
            checks[case] = (fn, ref, prepare_images if "gemm" in case
                            else None)
        case = f"int8_pretile A p={p}"
        cases[case] = lambda x=qa: tiled_images(x)
        checks[case] = (cases[case], manual_dma.pretile_ref(qa), None)
    heads = (32, 128)
    for label, ps in (("bf16", 128), ("int8", 384), ("fp32 scales", 384)):
        n_pages = 4 * -(-4096 // ps) + 1
        pool = torch.randn((n_pages, ps, *heads), generator=gen,
                           device="cuda")
        new = torch.randn((4, 1, *heads), generator=gen, device="cuda")
        cache = torch.randn((4, 4096, *heads), generator=gen, device="cuda")
        if label == "bf16":
            pool, new, cache = (x.to(torch.bfloat16)
                                for x in (pool, new, cache))
        else:
            (pool, spool), (new, snew), (cache, scache) = (
                llama.quantize_kv(x) for x in (pool, new, cache))
            if label == "fp32 scales":
                pool, new, cache = spool, snew, scache
        pages = torch.tensor([[7], [0], [n_pages - 1], [3]],
                             dtype=torch.int32, device="cuda")
        offs = torch.tensor([[5], [9], [ps - 1], [0]], dtype=torch.int32,
                            device="cuda")
        pos = torch.tensor([5, 300, 4095, 1000], dtype=torch.int32,
                           device="cuda")
        tab = torch.stack([pages, offs], -1)
        ref = kv_update.paged_kv_update_ref(pool.clone(), new, pages, offs)
        work = pool.clone()
        case = f"paged_kv_update {label} pool {tuple(pool.shape)}"
        cases[case] = (lambda w=work, n=new, pg=pages, of=offs:
                       paged_update_call(w, n, pg, of))
        checks[case] = (lambda w=work, n=new, pg=pages, of=offs:
                        paged_update_call(w, n, pg, of), ref, None)
        case = f"paged_kv_update {label} kernel alone"
        cases[case] = (lambda w=work, n=new, pg=pages, of=offs, t=tab:
                       paged_update_call(w, n, pg, of, t))
        rows_b = torch.tensor([0, 2, 3], device="cuda")
        idx = (pages[rows_b, 0].long(), offs[rows_b, 0].long())
        vals = new[rows_b, 0]
        library[case] = time_calls(
            lambda: work.index_put_(idx, vals), graph=True) * 1e3
        ccache = cache.clone()
        case = f"kv_update {label} cache {tuple(cache.shape)}"
        cases[case] = (lambda w=ccache, n=new, q=pos:
                       kv_update.kv_update(w, n, q))
        checks[case] = (cases[case], kv_update.kv_update_ref(
            cache.clone(), new, pos), None)

    def check(name):
        parts = []
        for case, (fn, ref, setup) in checks.items():
            if setup is not None:
                setup()
            out, again = fn(), fn()
            torch.cuda.synchronize()
            if "int8_pretile" in case and _older("int8_tiled_resident_nt"):
                verdict = "its own layout"     # an older tree's images
            else:
                verdict = "EQUAL" if torch.equal(out, ref) else "DIFFERS"
            parts.append(f"{case}: {verdict}, repeat "
                         f"{'equal' if torch.equal(out, again) else 'DIFFERS'}")
        return "; ".join(parts)
    return cases, check, library


def gemv_call(x, packed, sw):
    """w4a8_gemv_fq on the tree in use: its wrapper (the variants' forced
    cluster in its plan), or an older tree's two kernels with the
    operands its wrapper made (x padded to Kp, qa and sa scratch)."""
    name = "w4a8_gemv_fq"
    m, k = x.shape
    n = sw.shape[1]
    kp = packed.shape[0] * 2
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if _older(name):
        from how_to_optimize_gemm_tpu_torch.ops import bounds
        xp = bounds.pad_dim(x.to(torch.float32).contiguous(), 1, kp)
        out = torch.empty((m, n), dtype=torch.float32, device=x.device)
        qa = torch.empty((m, kp), dtype=torch.int8, device=x.device)
        sa = torch.empty((m, 1), dtype=torch.float32, device=x.device)
        fn = _build.c_function(_build.KERNELS[name].source, name,
                               _TWO_LAUNCH_GEMV)
        args = (xp, packed, sw, qa, sa, out)
        err = fn(*(t.data_ptr() for t in args), m, n, kp, packed.shape[1],
                 stream)
    else:
        forced = {"cl1": 1, "cl2": 2, "cl4": 4, "cl8": 8}.get(
            _ACTIVE[0].parent.name)
        if forced is None:
            return int4.mmult_w4a8_fused_noc(x, packed, sw)
        out = torch.empty((m, n), dtype=torch.float32, device=x.device)
        spc = -(-int4.gemv_stages(k) // forced)
        cluster = forced
        if int4.gemv_smem(min(m, int4.GEMV_ROWS), spc, forced) \
                > int4.GEMV_SMEM:   # the plan's, where this does not fit
            cluster = int4.gemv_plan(m, k, n, int4._sm_count(x.device))
        _build.launch(name, x.device, x, packed, sw, out, m, n, k,
                      x.stride(0), kp, packed.shape[1], cluster)
        err = 0
    if err != 0:
        raise RuntimeError(f"{name} (older tree) launch failed: "
                           f"cudaError {err}")
    return out


def paged_call(q, k, v, table, lengths):
    """paged_decode_attention on the tree in use: its wrapper, or an older
    tree's one-block kernel launched with its own arguments."""
    name = "paged_decode_attention"
    if not _older(name):
        return paged_attention.paged_decode_attention(q, k, v, table,
                                                      lengths)
    b, h, d = q.shape
    n_pages, ps, kvh, _ = k.shape
    out = torch.empty((b, h * d), device=q.device)
    fn = _build.c_function(_build.KERNELS[name].source, name,
                           _ONE_BLOCK_PAGED)
    err = fn(*(t.data_ptr() for t in (q, k, v, table, lengths, out)), b,
             n_pages, ps, table.shape[1], kvh, h // kvh, d, d ** -0.5,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} (one-block walk) launch failed: "
                           f"cudaError {err}")
    return out


# the phases each timeline probe stamps
_PHASES = {_GEMV: ("start", "absmax", "cluster", "quantized", "products",
                   "partials stored", "cluster", "end", "last stage landed"),
           _W16V: ("start", "A stored", "last stage landed", "products",
                   "cluster", "partials stored", "cluster", "end")}


def _timeline(fn, source: str = _GEMV) -> str:
    """One call of ``fn`` on a diag_timeline tree of ``source``: each
    phase's end (us after the first block's start) over the blocks, min /
    median / max, and the blocks an SM."""
    n = 4096 * 10
    buf = (ctypes.c_ulonglong * n)()
    times = _build.c_function(source, "gemv_times",
                              (ctypes.c_void_p, ctypes.c_int))
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times(ctypes.addressof(buf), n)      # read and cleared
    fn()
    torch.cuda.synchronize()
    if times(ctypes.addressof(buf), n) != 0:
        raise RuntimeError("gemv_times failed")
    rows = [buf[i * 10:(i + 1) * 10] for i in range(4096) if buf[i * 10]]
    t0 = min(r[0] for r in rows)
    out = [f"{len(rows)} blocks"]
    for i, name in enumerate(_PHASES[source]):
        ts = sorted((r[i] - t0) / 1e3 for r in rows)
        out.append(f"{name} {ts[0]:.2f}/{ts[len(ts) // 2]:.2f}/"
                   f"{ts[-1]:.2f}")
    per_sm = {}
    for r in rows:
        per_sm[r[9]] = per_sm.get(r[9], 0) + 1
    out.append(f"SMs {len(per_sm)}, blocks an SM "
               f"{min(per_sm.values())}-{max(per_sm.values())}")
    return ", ".join(out)


def gemv_cases(gen, tiles):
    """The fused GEMV at the 7B decode widths (and on weights past the L2)
    and the paged bf16 attention at the smoke's shapes; the GEMV EQUAL to
    its plain version, two calls bit-equal; the attention held to its
    plain version (max abs)."""
    cases, refs = {}, {}
    for k, n in ((4096, 11008), (4096, 4096), (11008, 4096)):
        w = torch.randn((k, n), generator=gen, device="cuda")
        _, _, packed, sw, _ = int4.prepare_w4a8(w[:1], w)
        del w
        for m in (4, 1, 16, 64):
            x = torch.randn((m, k), generator=gen, device="cuda")
            case = f"w4a8_gemv_fq m={m} {k}->{n}"
            args = (x, packed, sw)
            cases[case] = lambda a=args: gemv_call(*a)
            refs[case] = (True, args)
    copies = []
    for _ in range(4):
        w = torch.randn((4096, 11008), generator=gen, device="cuda")
        copies.append(int4.prepare_w4a8(w[:1], w)[2:4])
        del w
    x = torch.randn((4, 4096), generator=gen, device="cuda")
    turn = [0]

    def cold():
        packed, sw = copies[turn[0] % 4]
        turn[0] += 1
        return gemv_call(x, packed, sw)
    cases["w4a8_gemv_fq m=4 4096->11008, 4 weight copies"] = cold
    for kvh, rep, d, ps, lens in ((32, 1, 128, 128, [1, 300, 1000, 4096]),
                                  (3, 2, 32, 96, [1, 999, 1000, 517])):
        np_max = -(-max(lens) // ps)
        n_pages = len(lens) * np_max + 1
        free = (torch.randperm(n_pages - 1, generator=gen, device="cuda")
                + 1).tolist()
        table = torch.zeros((len(lens), np_max), dtype=torch.int32)
        for b, nl in enumerate(lens):
            for c in range(-(-nl // ps)):
                table[b, c] = free.pop()
        q = torch.randn((len(lens), kvh * rep, d), generator=gen,
                        device="cuda")
        pools = [torch.randn((n_pages, ps, kvh, d), generator=gen,
                             device="cuda").to(torch.bfloat16)
                 for _ in "kv"]
        args = (q, *pools, table.cuda(),
                torch.tensor(lens, dtype=torch.int32, device="cuda"))
        case = f"paged_decode_attention kvh={kvh} rep={rep} d={d} ps={ps}"
        cases[case] = lambda a=args: paged_call(*a)
        refs[case] = (False, paged_attention.paged_decode_attention_ref(
            *args))

    def check(name):
        parts = []
        for case, fn in cases.items():
            if case not in refs:
                continue
            exact, ref = refs[case]
            out = fn()
            if exact:
                want = int4.mmult_w4a8_fused_noc_ref(*ref)
                equal = torch.equal(out, want)
                same = torch.equal(out, fn())
                parts.append(f"{case}: {'EQUAL' if equal else 'DIFFERS'}, "
                             f"repeat {'equal' if same else 'DIFFERS'}")
            else:
                parts.append(f"{case}: max|kernel - plain| "
                             f"{float((out - ref).abs().max()):.3e}")
        if _ACTIVE[0].parent.name == "diag_timeline":
            for case in ("w4a8_gemv_fq m=4 4096->11008",
                         "w4a8_gemv_fq m=4 4096->11008, 4 weight copies",
                         "w4a8_gemv_fq m=4 11008->4096"):
                parts.append(f"{case}: {_timeline(cases[case])}")
        for k, n in ((4096, 11008), (11008, 4096)):
            case = f"w4a8_gemv_fq m=4 {k}->{n}"
            prof = profiling.call_profile(cases[case])
            parts.append(f"{case} host ops a call: {len(prof.aten)} aten "
                         f"{prof.aten}, {len(prof.launches)} launches, "
                         f"{len(prof.kernels)} kernels")
        return "; ".join(parts)
    return cases, check, {}


# an older tree's w4a16_gemv (one block a 32-column slab and 4 rows, no
# cluster): (a, packed, sw, out, M, N, K, Kp, lda, ldp, stream)
_OLD_W4A16_GEMV = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 6
                   + (ctypes.c_void_p,))


def w4a16_gemv_call(a, packed, sw):
    """w4a16_gemv on the tree in use: its wrapper (the variants' forced
    cluster in its plan), or an older tree's kernel launched with its own
    arguments."""
    name = "w4a16_gemv"
    m, k = a.shape
    n = sw.shape[1]
    kp = packed.shape[0] * 2
    forced = {"cl1": 1, "cl2": 2, "cl4": 4, "cl8": 8}.get(
        _ACTIVE[0].parent.name)
    if not _older(name) and forced is None:
        return int4.mmult_q_noc(a, packed, sw)
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if _older(name):
        fn = _build.c_function(_build.KERNELS[name].source, name,
                               _OLD_W4A16_GEMV)
        err = fn(*(t.data_ptr() for t in (a, packed, sw, out)), m, n, k, kp,
                 k, packed.shape[1],
                 torch.cuda.current_stream(a.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} (older tree) launch failed: "
                               f"cudaError {err}")
        return out
    cluster = forced
    spc = -(-int4.gemv_stages(k) // forced)
    if int4.w4a16_gemv_smem(min(m, int4.GEMV_ROWS), spc) > int4.GEMV_SMEM:
        cluster = int4.w4a16_gemv_plan(m, k, n, int4._sm_count(a.device))
    _build.launch(name, a.device, a, packed, sw, out, m, n, k, k, kp,
                  packed.shape[1], cluster)
    return out


def w4a16_cases(gen, tiles):
    """The W4A16 GEMV at the 7B decode widths (and on weights past the L2),
    the GEMM at the 7B prefill widths, chunks and a ragged shape, and rung
    07 (``w4a16_gemm``, C in place) at 4,096 and 2,048; each within 2e-5 of
    max |plain|, two calls bit-equal."""
    cases, refs = {}, {}

    def weights(k, n):
        w = torch.randn((k, n), generator=gen, device="cuda")
        return int4.prepare_w4a8(w[:1], w)[2:4]

    def acts(m, k):
        return torch.randn((m, k), generator=gen, device="cuda").to(
            torch.bfloat16)
    for k, n in ((4096, 11008), (4096, 4096), (11008, 4096)):
        packed, sw = weights(k, n)
        for m in ((4, 1, 16, 64) if (k, n) == (4096, 11008) else (4,)):
            args = (acts(m, k), packed, sw)
            case = f"w4a16_gemv m={m} {k}->{n}"
            cases[case] = lambda a=args: w4a16_gemv_call(*a)
            refs[case] = args
    copies = [weights(4096, 11008) for _ in range(4)]
    x = acts(4, 4096)
    turn = [0]

    def cold():
        packed, sw = copies[turn[0] % 4]
        turn[0] += 1
        return w4a16_gemv_call(x, packed, sw)
    cases["w4a16_gemv m=4 4096->11008, 4 weight copies"] = cold
    for m, k, n in ((1024, 4096, 11008), (1024, 11008, 4096),
                    (128, 4096, 11008), (256, 4096, 11008),
                    (1000, 1100, 1032)):
        args = (acts(m, k), *weights(k, n))
        case = f"w4a16_gemm_noc M={m} {k}->{n}"
        cases[case] = lambda a=args: int4.mmult_q_noc(*a)
        refs[case] = args
    # rung 07 in place: timed on a C of its own, checked on fresh copies
    rung07 = {}
    for p in (4096, 2048):
        args = (acts(p, p), *weights(p, p))
        c = torch.rand((p, p), generator=gen, device="cuda") * 2 - 1
        case = f"w4a16_gemm p={p}"
        work = c.clone()
        cases[case] = lambda a=args, work=work: int4.mmult_q(*a, work)
        rung07[case] = (args, c)

    def check(name):
        parts = []
        for case, (args, c) in rung07.items():
            out, again = (int4.mmult_q(*args, c.clone()) for _ in "12")
            ref = int4.mmult_q_ref(*args, c)
            rel = float((out - ref).abs().max() / ref.abs().max())
            parts.append(f"{case}: {rel:.3e} of max|plain| "
                         f"{'ok' if rel <= 2e-5 else 'BEYOND 2e-5'}, repeat "
                         f"{'equal' if torch.equal(out, again) else 'DIFFERS'}")
        for case, args in refs.items():
            fn = cases[case]
            out = fn()
            ref = int4.mmult_q_noc_ref(*args)
            rel = float((out - ref).abs().max() / ref.abs().max())
            same = torch.equal(out, fn())
            parts.append(f"{case}: {rel:.3e} of max|plain| "
                         f"{'ok' if rel <= 2e-5 else 'BEYOND 2e-5'}, repeat "
                         f"{'equal' if same else 'DIFFERS'}")
        if _ACTIVE[0].parent.name == "diag_timeline":
            for case in ("w4a16_gemv m=4 4096->11008",
                         "w4a16_gemv m=4 4096->11008, 4 weight copies",
                         "w4a16_gemv m=4 4096->4096",
                         "w4a16_gemv m=4 11008->4096"):
                parts.append(f"{case}: {_timeline(cases[case], _W16V)}")
        for case in ("w4a16_gemv m=4 4096->11008",
                     "w4a16_gemv m=4 11008->4096"):
            prof = profiling.call_profile(cases[case])
            parts.append(f"{case} host ops a call: {len(prof.aten)} aten "
                         f"{prof.aten}, {len(prof.launches)} launches, "
                         f"{len(prof.kernels)} kernels")
        return "; ".join(parts)
    return cases, check, {}


def ladder_cases(gen, tiles):
    """Rungs 02, 03 and 03b (their wrappers, fresh outputs) at 4,096 and
    2,048: each held to its plain version relative to max |plain| and to
    the fp64 product, two calls bit-equal, C left as it was; 01's call
    (cuBLAS's fp32 product) beside them."""
    cases, rows, library = {}, {}, {}
    for p in (4096, 2048):
        a, b, c = (torch.rand((p, p), generator=gen, device="cuda") * 2 - 1
                   for _ in "abc")
        for name, run, plain in (
                ("02 fp32_gemm_mn_tile", mn_tile.mmult, mn_tile.mn_tile_ref),
                ("03 fp32_gemm_k_blocked", k_blocked.mmult,
                 k_blocked.k_blocked_ref),
                ("03b fp32_gemm_k_blocked", k_blocked.mmult_small,
                 k_blocked.k_blocked_ref)):
            case = f"{name} p={p}"
            cases[case] = lambda run=run, a=a, b=b, c=c: run(a, b, c)
            rows[case] = (run, plain, a, b, c)
            library[case] = time_calls(
                lambda a=a, b=b, c=c: vendor.mmult(a, b, c), graph=True) * 1e3

    def check(name):
        parts = []
        for case, (run, plain, a, b, c) in rows.items():
            ref = plain(a, b, c)
            cin = c.clone()
            out = run(a, b, c)
            same = torch.equal(out, run(a, b, c))
            err = float((out - ref).abs().max() / ref.abs().max())
            oracle = a.double() @ b.double() + c.double()
            rel = float((out.double() - oracle).abs().max()
                        / oracle.abs().max())
            kept = "unchanged" if torch.equal(cin, c) else "CHANGED"
            parts.append(f"{case}: {err:.3e} of max |plain|, {rel:.3e} "
                         f"against fp64, repeat "
                         f"{'equal' if same else 'DIFFERS'}, C {kept}")
        return "; ".join(parts)
    return cases, check, library


CASES = {"forward": forward_cases, "dkv": dkv_cases, "dq": dq_cases,
         "gemm": gemm_cases, "paged": paged_cases, "w4a8": w4a8_cases,
         "int8": int8_cases, "gemv": gemv_cases, "w4a16": w4a16_cases,
         "strip": strip_cases, "pingpong": pingpong_cases,
         "tiled": tiled_cases,
         "ladder": ladder_cases}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--group", choices=sorted(GROUPS), default="forward")
    ap.add_argument("--variants", nargs="*", default=None,
                    help="the group's variants to build (default: all)")
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR[:BK], another tree's csrc (and the "
                         "forward's key tile)")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_variants: needs a CUDA device")
    sources, variants = GROUPS[args.group]
    trees, tiles = {}, {}
    for name in (list(variants) if args.variants is None else args.variants):
        trees[name] = prepare(args.group, name, variants[name])
        tiles[name] = KEY_TILE.get(name, attention.KERNEL_BK)
    for spec in args.tree:
        name, rest = spec.split("=", 1)
        path, _, bk = rest.partition(":")
        trees[name] = pathlib.Path(path).resolve()
        tiles[name] = int(bk) if bk else attention.KERNEL_BK
    build(trees, sources)

    gen = torch.Generator("cuda").manual_seed(0)
    print(f"card: {torch.cuda.get_device_name(0)}")
    cases, check, library = CASES[args.group](gen, tiles)
    for name, csrc in list(trees.items()):
        use(csrc, sources)
        try:
            print(f"[{name}] {check(name)}")
        except RuntimeError as e:   # a launch the driver refuses
            print(f"[{name}] {e}; not timed")
            del trees[name]
    order = list(trees)
    times = {(n, c): [] for n in order for c in cases}
    for r in range(args.rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            use(trees[name], sources)
            for case, fn in cases.items():
                times[name, case].append(time_calls(fn, graph=True) * 1e3)
    for case in cases:
        lib = library.get(case)
        print(f"{case}: library "
              + ("none" if lib is None else f"{lib:.4f} ms"))
        for name in order:
            ms = ", ".join(f"{t:.4f}" for t in times[name, case])
            print(f"  [{name}] {ms} ms")


if __name__ == "__main__":
    main()
