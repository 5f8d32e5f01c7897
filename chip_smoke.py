#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero before the last line):

1. the card: ``nvidia-smi`` name and power limit, CUDA and torch versions;
2. build every kernel under ``how_to_optimize_gemm_tpu_torch/csrc`` with
   nvcc (one process per source, all started together), with ptxas's
   register and spill counts;
3. the tooling path, with every launch count set to 0 just before it:
   ``probes.main()`` (every hardware probe on its kernel, each reading
   printed beside its ceiling, the H100 SXM data sheet's or, for the SFU
   and shared memory, NVIDIA's per-SM rate x SMs x the maximum SM clock;
   above 105% of it a reading raises), ``dispatch_probe.main(fast=True)``
   (eager and CUDA-graph cost of one op per kind, the async rows) and
   ``ab.main`` on rung 15 against 01b at p = 2,048 and 4,096, 5 rounds
   (artifact in a temporary directory); every probe kernel must have been
   launched. Then each probe kernel against its plain version at the
   probe's default tiles and sizes (iterations cut, ``CHECK_ITERS``) and
   at a small shape: EQUAL for the int8 chains, the copies, the checksum,
   the VMEM copy, the latency sums and ``add_one``, within stated bounds
   for the bf16, 3xTF32, FFMA and exp chains (``check_tooling``); the
   multi-stage copy's rule must refuse a copy with one chunk left out;
   each timed beside its plain version, its bound and the library call
   (the vendor stream's pass for the two copies, ``x + 1`` for
   ``add_one``);
4. each ladder kernel against its plain PyTorch version on the card, at
   M=N=K=4096 and at an unaligned shape (the hand-pipeline kernels of
   rungs 08-13, 17 and 18 also at ``WALK``, where their persistent walks
   and rings wrap; their tiles, derived from a block's shared memory and a
   thread's registers, rung 11's cluster size (its kernel's own, which
   must be ``manual_dma.CLUSTER``) and the clusters the card runs at once,
   the L2 residency budget of rungs 12 and 13 and rung 18's default cap
   and plan at 4,096 printed first): the int8 kernels' outputs must
   be EQUAL (rung 11, on K2's int8 ``wgmma`` body with A multicast across
   a cluster and C loaded into a fresh output, and rungs 10, 12 and 13,
   that body with its two consumers taking whole tiles in turn (12 with
   the operands kept in the L2, 13 fed by 1-D bulk copies of its repack's
   swizzled stage images), with C unchanged; rung
   13's repack ``int8_pretile`` byte for byte, its time beside its time
   before the rebuild; rungs 12 and
   13 must launch their own kernels at 4,096, not rung 11's; rung 17's six
   knob instances, K2's body at each ring depth with and without
   lookahead, EQUAL to ``int8_gemm_nt``'s output at ``WALK`` and 4,096,
   each timed at 4,096; rungs 10, 11, 12, 13 and 17 printed beside their
   ``mma.sync`` kernels' times; rung 18 also at 4,096 with cap 1,664, a two-piece plan,
   on its own kernel; K2 and rung 18, one int8 ``wgmma`` body, also at
   ``WALK``, where K2's persistent grid wraps (two calls at 4,096
   bit-equal), and on subnormal scales and C, EQUAL with C's rows of
   16-byte multiples and at N = 262, each time printed beside the
   ``mma.sync`` kernel's before the rebuild; K3 ``w4a8_gemm``, on the
   int8 prefill GEMMs' ``wgmma`` body with C added in place, also at
   ``WALK``, its time beside its ``mma.sync`` kernel's; K1
   ``int8_gemm_nn`` on the same body with C read into a fresh output and
   rung 07 ``w4a16_gemm`` on the W4A16 prefill GEMM's bf16 ``wgmma`` body
   with C added in place, both also at ``WALK`` (C's rows no 16-byte
   multiple: each thread adds C), their times beside their ``mma.sync``
   kernels'; then
   ``int8_gemm_nt``'s time
   right after a call of
   rung 10, 12 or 13, the check that evict_last lines left behind do not
   slow the next kernel, and rungs 12, 13, 14 and 18 at p = 2,048 chained
   beside a CUDA-graph replay, the host's share of a call), the bf16 and
   W4A16 kernels' within W4A16_REL, and rungs 16's and 04's (three bf16
   products of split operands on ``wgmma``: bf16x3, XLA's Precision.HIGH,
   where the reference runs HIGHEST), rungs 02's and 03's (bf16x3 on
   ``mma.sync``, the split inside the kernel; within FP32_REL / 2 at K
   4,096, two calls bit-equal, 03b also at 03's shapes and timed beside
   it) and the naive rung 00's (FFMA) within FP32_REL of max |plain|
   (fp32 sums in another order), and every output under its rung's
   gate_rel against an
   fp64 oracle on the card; then its time at 4096 beside the plain
   version's, the library call's (where one PyTorch call computes the
   same function: ``torch._int_mm`` and the epilogue for int8, the vendor
   bars 01b and 01 for the bf16 and fp32 kernels) and the card's bound at
   the peak of the kernel's type (int8; bf16 for bf16 and W4A16; for fp32
   the fastest route that meets gate 1e-4 and FP32_REL, three bf16
   products at a third of the bf16 peak, with the FFMA ceiling printed
   beside it for the rows on FFMA); rungs 16 and 04 also in their parts,
   the two ``split_bf16`` launches (counted: two a call, and two for each
   of their launches in the ladder path) and the kernel alone on planes
   split beforehand (bits equal to the wrapper's), each timed;
5. each serving kernel against its plain version at the Llama-2-7B
   shapes the serve paths give it (``kv_update`` and ``paged_kv_update``
   on each row kind: bf16 values, int8 values and fp32 scales; the paged
   attention kernels over a shuffled block table, pages of 128 (bf16) and
   384 (KV8); ``flash_attention`` at the 7B prefill, B 4 x 32 heads of
   128 at S = T = 4,096 causal, at 2,048 and at 1,024; ``w4a8_gemm_noc``
   also at a 128-token chunk and at m = 16,384; ``w4a8_gemv_fq`` at m =
   4, 1, 16 and 64 and at K = 5,000; ``w4a16_gemv`` at m = 4, 1, 16 and
   64, a second call bit-equal to the first and a CUDA graph replayed on
   new rows bit-equal to an eager call; ``w4a16_gemm_noc`` at the 4 x 256
   admission's widths, two calls bit-equal; ``int8_gemm_noc`` at the
   same widths (4,096 -> 11,008 and 11,008 -> 4,096) on the int8
   ``wgmma`` body; each rebuilt kernel's time printed beside its time
   before the rebuild (``paged_kv_update``: one launch a call since its
   rebuild);
   ``decode_attention_q8`` also from a CUDA graph replayed at other
   lengths; the split walks' workspace counters at 0 after every call)
   and at ragged shapes (EQUAL
   for w4a8_gemm_noc, w4a8_gemv_fq, kv_update, paged_kv_update and
   int8_gemm_noc; within W4A16_REL x max |y| for w4a16_gemm_noc and
   w4a16_gemv, whose fp32 sums run in another order; within atol 2e-3 for
   the four decode attention kernels; for flash_attention, every row
   within FLASH_ULPS bf16 ulps of its own max |plain|, against its plain
   version at the kernel's key tiles (``attention.KERNEL_BK``, 64 keys),
   at 4,096 and 2,048 on transposed
   (B, S, H, D) views as the model passes them, at 1,024, and on GQA rep
   4, D 64, S = 700 of T = 1,000, non-causal and T = 9,000; the same rule
   must refuse the plain version with one key tile skipped), timed as
   CUDA-graph replays beside its plain version, the
   library call (or null where no single PyTorch call computes the same
   function) and its bound; each paged attention kernel also beside the
   contiguous kernel on the same logical cache; then ``grouped_gemm``
   (the MoE grouped GEMM) at Mixtral-8x7B's prefill (4,096 tokens routed
   top-2 by a random router, one expert given no token, Tp = 9,216):
   w_gate/w_in (4,096 -> 14,336) and w_out (14,336 -> 4,096) on int8 +
   scale, packed int4 + scale and bf16 stacks, then f = 1,000 on the same
   kinds and fp32 stacks at d 36, f 130, each within GROUPED_REL (fp32:
   FP32_REL) of max |plain|, a rule that must refuse block 0 reading its
   neighbour expert's stack; timed at the Mixtral shapes, the bf16
   instance beside ``torch._grouped_mm``; ``split_bf16`` (the pre-pass of
   the forward, dx and dW) EQUAL to its plain version at both Mixtral
   widths and two ragged ones, timed at (9,216, 4,096); then the grouped
   GEMM's backward on the same layout: ``grouped_gemm_t`` (dx on int8 and
   bf16 stacks) and ``grouped_gemm_t4`` (packed int4) for w_gate/w_in's dx
   (dy 14,336 -> 4,096) and w_out's (4,096 -> 14,336), ``grouped_dw`` on
   both shapes and ``grouped_gemm``'s unscaled int4 instance (the
   backward's recompute of u), then f = 1,000 and fp32 stacks at d 36, f
   130: dx within GROUPED_REL (fp32: FP32_REL) and dW within FP32_REL of
   max |plain|, rules that must refuse block 0 reading its neighbour's
   stack and dW with one of an expert's blocks left out; timed at the
   Mixtral shapes beside the plain versions, the bounds and
   ``torch._grouped_mm`` (bf16 instances), each kernel alone on operands
   split beforehand with its wrapper's time beside;
6. the ladder's main path, with every launch count set to 0 just before
   it: the sweep driver on every rung of the registry, 06v, 06, 14, 07b,
   08, 09, 10, 11, 12, 13, 17, 18, 01, 01b, 04, 05, 07, 15, 16, 00, 02, 03
   and 03b, at p = 1024 (fp64 host oracle), 2048 and
   4096 (fp64 device check), writing ``.m`` files to a temporary
   directory and printing the ``p gflops diff`` rows, then the headline
   bench's JSON line (the int8 rungs of the top-level ``bench.py``), then
   the driver's CLI, ``--new 03_pallas_k_blocked --old 02_pallas_mn_tile
   --roofline --trace`` at p = 2048, whose per-kernel device profile of
   each rung must name that rung's hand kernel and no other. Every ladder
   kernel must have been launched;
7. the serving paths, each with every launch count set to 0 just before
   it and read just after: ``ServingEngine`` on Llama-2-7B (32 layers,
   random weights from seed 0) with W4A8 weights and a bf16 cache
   (S-w4a8), int8 weights (S-int8, the serving CLI's default), int4
   weights (S-int4, W4A16) and W4A8 weights over the KV8 cache (S-kv8),
   each with 4 slots, greedy, window 8, serving 8 requests of 32-256
   prompt tokens and 32 new tokens each; then the paged engine: S-paged
   (W4A8 weights, a bf16 pool of 128-token pages, the prefix cache; 8
   requests of a shared 128-token prefix and 16-128 more tokens, which
   must hit the cache) and S-paged-kv8 (W4A8 weights, a KV8 pool of
   384-token pages, chunked prefill of 256 tokens; 8 requests of 300-700
   prompt tokens, so prompts of 512 tokens or more are served through
   chunks, in a pool small enough that a slot is preempted); then S-long
   (W4A8 weights, a bf16 cache, 8 requests of 512-3,500 prompt tokens
   admitted without chunking, one dispatch at a bucket of 2,048 or 4,096
   per admission). Every request must get its 32 tokens, every kernel of
   the path must have been launched, and ``flash_attention`` exactly once
   per layer in every admission of 512 tokens or more. Then the time of
   one decode step at the same width, wall and device (torch.profiler),
   and for S-w4a8, on each shape of a layer's linears, one
   ``w4a8_gemv_fq`` call: one kernel on the card, its host operations
   printed. Then the MoE paths on
   ``mixtral_8x7b`` (32 layers, 8 experts of 14,336, top-2, moe_ragged,
   random weights from seed 0, 4 slots, a bf16 cache): S-moe-int8 (int8
   attention and int8 expert stacks, 47.5 GB) and S-moe-w4a8 (W4A8 and
   packed int4 stacks), 4 requests of 1,024-3,000 prompt tokens and 16
   new tokens, admitted in one dispatch at bucket 4,096: ``grouped_gemm``
   3 times a layer in it (96), and the attention path's kernels; TTFT,
   decode tokens/s, one decode step's time and peak memory printed.
   Each model is freed before the next one loads;
8. parity at full width: the same engine at Llama-2-7B width with 2
   layers, on the same weights and 2 prompts (100 and 128 tokens, so the
   admission prefill runs at m = 2 x 128 = 256 and takes the prefill
   kernels), teacher-forced on the card and on the CPU, both on the
   kernel routes (the CPU through the kernels' plain versions, flash's
   at the kernels' key tiles: ``kernel_tiles``), comparing
   the logits of the prefill and of 8 decode steps, for fp32, W4A8, int8
   and int4 weights, for W4A8 weights over the KV8 cache, for W4A8
   weights over a paged bf16 pool (pages of 128) and a paged KV8 pool
   (pages of 384), and "w4a8 long": prompts of 400 and 512 tokens, so the
   admission runs at s = 512 and takes ``flash_attention`` (on the CPU its
   plain version); and "moe int8" and "moe w4a8" at Mixtral-8x7B width
   with 2 layers (prompts of 400 and 512: the bucket-512 admission's
   2,048 routed copies take ``grouped_gemm``; 2 decode steps on the
   dispatch path; such a row compares the positions that every side
   routes to the CPU's experts in every layer, and a token routed
   otherwise must be a near-tie on the CPU side, ``flipped_positions``).
   The card side runs with every launch count set to 0 just before it
   and must launch every kernel its serve path launches. Float32 ops summed in
   another order differ by about 1e-6 relative, and the model amplifies
   that (bf16 cache and p roundings; activation and KV quantization move
   logits by a few %), so the bound is 3x what a 1e-6 relative
   perturbation of the embeddings does on the CPU in the same run. The
   CPU sides of a row convert each weight once (``cached_weights``), and
   each row prints its card and CPU seconds;
9. (run beside the checks of phases 4 and 5) the training attention's
   three kernels (``flash_attention_fwd_lse``, ``flash_attention_bwd_dq``,
   ``flash_attention_bwd_dkv``) against their plain versions at the soak's
   shape (B 8, H 32, KVH 4, S = 1,024, D 64, causal), at D 128 with rep 1
   and S = 2,048, and at S = 520 (not causal) and 130: out, dq, dk and dv
   each per row within a bound of their own row's max |plain|, lse within
   an absolute bound, and the same rule must refuse planted faults (a key
   tile skipped, a query head dropped from the dK/dV sum), and two dQ
   and two dK/dV calls must give the same bits; timed as
   CUDA-graph replays beside the plain versions, the bounds and SDPA (its
   forward; its whole backward on the dK/dV row);
10. the training path, ``training.soak_main`` on the TinyLlama-1.1B-shaped
   soak model at full width and depth (22 layers) with --flash-train
   --seq 1025 --batch 8, each run with every launch count set to 0 just
   before it: 8 steps with a checkpoint at step 4 (in a temporary
   directory), the same run resumed from it (its losses must equal the
   first run's bit for bit; the first run profiles one more step with
   torch.profiler), and 2 steps with --remat; every loss finite,
   each training kernel launched 22 times a step (the forward 44 under
   remat); tokens/s, MFU, step time, peak memory and losses printed;
11. training parity: two AdamW steps of the soak's model at full width
   with 2 layers (bf16 linears, batch 2 x 513 tokens, so s = 512 takes the
   flash kernels) on the card and on the CPU (their plain versions) from
   the same weights and batches: the losses and the weights after step 2
   within 3x what a 1e-6 relative perturbation of the embedding does on
   the CPU;
12. T-moe, MoE training at Mixtral-8x7B's width: ``mixtral_8x7b("bf16")``
   at 1 layer of 32 (dense bf16 stacks, moe_ragged) through
   ``training.make_train_step(flash_train=True)``, AdamW, batch 2 x 1,025
   (4,096 routed copies: the ragged path), with every launch count set to
   0 just before it: 4 steps with a checkpoint at step 2 and one profiled
   step, then the same model resumed from the checkpoint, whose losses
   must equal the first run's bit for bit; every loss finite, the router,
   the stacks, the attention and the embedding moved; ``grouped_gemm``,
   ``grouped_gemm_t`` and ``grouped_dw`` 3 times a layer a step,
   ``split_bf16`` 9 (x before each forward product; in each backward dy
   once, for dx and dW, and x for dW) and the training attention's
   kernels once; step ms, tokens/s, peak GB and the profiled step's
   kernels printed;
13. QLoRA: ``moe_bench train`` at Mixtral's expert shape (T 4,096) on int8
   and packed int4 stacks, each with the counts set to 0 just before it:
   the stacks unchanged, nonzero gradients for the router and the scales,
   the gradient step's ``grouped_gemm`` (forward and unscaled recompute,
   each after a ``split_bf16`` of x) and ``grouped_gemm_t`` or
   ``grouped_gemm_t4`` (after a ``split_bf16`` of the scaled dy)
   launches;
14. MoE training parity: two AdamW steps at Mixtral's width with 1 layer
   (batch 1 x 1,025: 2,048 routed copies) on the card and on the CPU from
   the same weights, for dense bf16 stacks and for int8 stacks under bf16
   linears, under phase 11's rule; a token some side routes otherwise must
   be a near-tie on the CPU side and is left out of that step's loss on
   every side (``train_moe_parity``);
15. one ``{"kernels": [...]}`` line (50 kernels), the card's line again,
   and last ``{"ok": true, "device": {...}}``.

Each phase prints its seconds, and the run its total and the host's
peak memory. The host's allocator keeps what the CPU sides free
(``keep_freed_host_memory``).

Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import math
import pathlib
import resource
import sys
import tempfile
import time

import numpy as np
import torch

from how_to_optimize_gemm_tpu_torch import _build, bench, convert
from how_to_optimize_gemm_tpu_torch.harness import (ab, driver,
                                                   flash_variants, mfile,
                                                   profiling)
from how_to_optimize_gemm_tpu_torch.harness.driver import run_sweep
from how_to_optimize_gemm_tpu_torch.harness.parameters import SweepConfig
# H100 SXM data sheet: dense int8 and bf16 tensor-core peaks, HBM3
# bandwidth. fp32 at the rungs' gate (1e-4) and FP32_REL: the fastest
# route that meets them is three bf16 products of operands split into bf16
# hi + lo, a third of the 989 TFLOP/s bf16 peak (rung 16's and
# grouped_dw's route; plain TF32 does not meet them, 3xTF32 runs at half
# that rate); FFMA tops out at 67 TFLOP/s.
from how_to_optimize_gemm_tpu_torch.harness.profiling import (
    PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_FFMA_FLOPS, PEAK_FP32_FLOPS,
    PEAK_INT8_OPS)
from how_to_optimize_gemm_tpu_torch.models import checkpoint, llama
from how_to_optimize_gemm_tpu_torch.ops import (attention, bounds,
                                               decode_attention,
                                               dispatch_probe, probes,
                                               grouped_gemm, hand_pipeline,
                                               int4, int8,
                                               k_blocked, manual_dma,
                                               quant, kv_update, mn_tile,
                                               naive,
                                               paged_attention, registry,
                                               tuned, vendor)
from how_to_optimize_gemm_tpu_torch.parallel import moe, serving, training
from how_to_optimize_gemm_tpu_torch.utils.device import card_line
from how_to_optimize_gemm_tpu_torch.utils.matrices import make_abc
from how_to_optimize_gemm_tpu_torch.utils.timing import (time_calls,
                                                         time_chained)

PEAKS = {"int8": PEAK_INT8_OPS, "bf16": PEAK_BF16_FLOPS,
         "fp32": PEAK_FP32_FLOPS}
P_FULL = 4096
MAIN_RUNGS = ("06v_xla_int8", "06_pallas_int8", "14_packed_alias_int8",
              "07b_pallas_w4a8", "08_manual_dma_int8", "09_fat_tile_int8",
              "10_packed_fat_int8", "11_strip_resident_int8",
              "12_resident_int8", "13_tiled_resident_int8",
              "17_hand_pipeline_int8", "18_ragged_m_int8",
              "01_xla_fp32", "01b_xla_bf16",
              "04_pallas_tuned_fp32", "05_pallas_bf16", "07_pallas_int4",
              "15_packed_alias_bf16", "16_packed_alias_fp32",
              "00_naive_vpu", "02_pallas_mn_tile", "03_pallas_k_blocked",
              "03b_pallas_small_blocks")
# the driver's CLI with --roofline and --trace, as a user runs it: each
# rung's trace must name its hand kernel and no other
DRIVER_RUNGS = {"02_pallas_mn_tile": "fp32_gemm_mn_tile",
                "03_pallas_k_blocked": "fp32_gemm_k_blocked"}
P_DRIVER = 2048
# w4a16 and bf16 kernels vs their plain version: exact products, fp32 sums
# in another order (the GEMM's by the tensor cores), relative to max |y|
W4A16_REL = 2e-5
# the fp32 kernels vs their plain version (cuBLAS's fp32 product),
# relative to max |y|: rung 00's one fmaf chain over K (FFMA), or three
# bf16 products of split operands (bf16x3: rungs 16 and 04 on wgmma,
# rungs 02 and 03/03b on mma.sync with the split inside the kernel),
# those within FP32_REL / 2 at K 4,096
FP32_REL = 1e-5

SRC = "how_to_optimize_gemm_tpu_torch/csrc/"
MANUAL_DMA = "how_to_optimize_gemm_tpu/ops/pallas_manual_dma.py"
# rung 18 at P_FULL on the reference test's two-piece plan (tests/
# test_ladder.py: ragged_m_plan(4096, 1664) == [(1536, 2, 0), (1024, 1, 3)])
RAGGED_CAP = 1664


def _int_mm_nn(qa, sa, qb, sb, c):
    return int8.dequant_epilogue(torch._int_mm(qa, qb), sa, sb, c)


def _int_mm_nt(qa, sa, qbt, sb, c):
    return int8.dequant_epilogue(torch._int_mm(qa, qbt.t()), sa, sb, c)


# The hand-pipeline kernels' extra shape: more tiles than the persistent
# grid holds and not a multiple of it, 9 K chunks (every ring slot and
# C/out buffer wraps at least twice), N not a multiple of 4, M of 128.
WALK = (2001, 2102, 520)
# rung 15's persistent kernel (bf16_gemm_nt, 128 x 256 tiles, one block an
# SM) at WALK walks 144 tiles, more than the card's 132 SMs and not a
# multiple of them (check_nt_walk), and at NT_EDGE has fewer rows than a
# consumer's 64 and K that is no multiple of its 64-value stage; WALK's C
# rows (2,102 values) are no 16-byte multiple, so its epilogue adds C in
# each thread, where the other shapes hand the sums to tensor-map
# reductions
NT_EDGE = (33, 520, 1000)
# Each kernel with the rung whose prepare/effective give its operands, its
# tolerance against its plain version (relative to max |plain|; 0: EQUAL),
# the peak its bound takes (``ffma``: an fp32 kernel on the CUDA cores,
# whose FFMA ceiling is printed beside it) and, beside the unaligned shape
# and P_FULL, any more shapes it is checked at.
KERNELS = [
    dict(name="int8_gemm_nn", source=SRC + "int8_gemm_nn.cu",
         replaces="how_to_optimize_gemm_tpu/ops/pallas_int8.py:29",
         function="pallas_int8._kernel (mmult_q, rung 06)",
         rung="06_pallas_int8", wrapper=int8.mmult_q,
         plain=int8.mmult_q_ref, library=_int_mm_nn,
         unaligned=(1000, 1032, 1100), more=(WALK,), tol=0.0, peak="int8"),
    dict(name="int8_gemm_nt", source=SRC + "int8_gemm_nt.cu",
         replaces="how_to_optimize_gemm_tpu/ops/pallas_int8.py:212",
         function="pallas_int8._kernel_bt + _kernel_bt_1k :259 "
                  "(mmult_q_bt, rung 14)",
         rung="14_packed_alias_int8", wrapper=int8.mmult_q_bt,
         plain=int8.mmult_q_bt_ref, library=_int_mm_nt,
         unaligned=(1000, 1032, 1100), more=(WALK,), tol=0.0, peak="int8",
         extra=("int8_walk", "subnormal")),
    # the hand-pipeline record (rungs 08-11): fresh outputs, EQUAL (rungs
    # 10 and 11, on K2's int8 wgmma body as a ping-pong and in clusters,
    # also C unchanged; rung 10 on its own kernel)
    dict(name="int8_dma_nn", source=SRC + "int8_dma_nn.cu",
         replaces=MANUAL_DMA + ":71",
         function="pallas_manual_dma._make_kernel (mmult_q :118, rung 08)",
         rung="08_manual_dma_int8", wrapper=manual_dma.mmult_q,
         plain=manual_dma.mmult_q_ref, library=_int_mm_nn,
         unaligned=(1000, 1032, 1100), more=(WALK,), tol=0.0, peak="int8"),
    dict(name="int8_fat_nn", source=SRC + "int8_fat.cu",
         replaces=MANUAL_DMA + ":166",
         function="pallas_manual_dma._make_fat_kernel (mmult_q_fat :288, "
                  "rung 09)",
         rung="09_fat_tile_int8", wrapper=manual_dma.mmult_q_fat,
         plain=manual_dma.mmult_q_fat_ref, library=_int_mm_nn,
         unaligned=(1000, 1032, 1100), more=(WALK,), tol=0.0, peak="int8"),
    dict(name="int8_fat_nt", source=SRC + "int8_fat.cu",
         replaces=MANUAL_DMA + ":357",
         function="pallas_manual_dma._make_packed_kernel (mmult_q_packed "
                  ":498, rung 10)",
         rung="10_packed_fat_int8", wrapper=manual_dma.mmult_q_packed,
         plain=manual_dma.mmult_q_packed_ref, library=_int_mm_nt,
         unaligned=(1000, 1032, 1100), more=(WALK,), tol=0.0, peak="int8",
         fresh=True, own=True),
    dict(name="int8_strip_nt", source=SRC + "int8_strip_nt.cu",
         replaces=MANUAL_DMA + ":559",
         function="pallas_manual_dma._make_strip_kernel (mmult_q_strip "
                  ":670, rung 11)",
         rung="11_strip_resident_int8", wrapper=manual_dma.mmult_q_strip,
         plain=manual_dma.mmult_q_strip_ref, library=_int_mm_nt,
         unaligned=(1000, 1032, 1100), more=(WALK,), tol=0.0, peak="int8",
         fresh=True),
    # the operand-resident rungs 12 and 13 (rung 10's body, fresh outputs,
    # C unchanged) and rung 13's
    # repack, the hand pipeline 17 and the ragged plan 18 (in place): EQUAL
    dict(name="int8_resident_nt", source=SRC + "int8_resident.cu",
         replaces=MANUAL_DMA + ":724",
         function="pallas_manual_dma._make_resident_kernel "
                  "(mmult_q_resident :860, rung 12)",
         rung="12_resident_int8", wrapper=manual_dma.mmult_q_resident,
         plain=manual_dma.mmult_q_resident_ref, library=_int_mm_nt,
         unaligned=(1000, 1032, 1100), more=(WALK,), tol=0.0, peak="int8",
         fresh=True, own=True),
    dict(name="int8_tiled_resident_nt", source=SRC + "int8_resident.cu",
         replaces=MANUAL_DMA + ":881",
         function="pallas_manual_dma._make_tiled_resident_kernel "
                  "(mmult_q_tiled_resident :1017, rung 13; with "
                  "int8_pretile)",
         rung="13_tiled_resident_int8",
         wrapper=manual_dma.mmult_q_tiled_resident,
         plain=manual_dma.mmult_q_tiled_resident_ref, library=_int_mm_nt,
         unaligned=(1000, 1032, 1100), more=(WALK,), tol=0.0, peak="int8",
         fresh=True, own=True, extra=("residue",)),
    dict(name="int8_pretile", source=SRC + "int8_resident.cu",
         replaces=MANUAL_DMA + ":881",
         function="pallas_manual_dma._make_tiled_resident_kernel's one-time "
                  "tiled loads (mmult_q_tiled_resident :1017, rung 13)",
         rung="13_tiled_resident_int8", unaligned=(1000, 1032, 1100),
         more=(WALK,), check="pretile"),
    dict(name="int8_hand_pipe_nt", source=SRC + "int8_hand_pipe.cu",
         replaces="how_to_optimize_gemm_tpu/ops/pallas_emit_pipeline.py:84",
         function="pallas_emit_pipeline kernel :136 + _scaled_body :84 "
                  "(mmult_q_bt_hand :106, rung 17)",
         rung="17_hand_pipeline_int8", wrapper=hand_pipeline.mmult_q_bt_hand,
         plain=int8.mmult_q_bt_ref, library=_int_mm_nt,
         unaligned=(1000, 1032, 1100), more=(WALK,), tol=0.0, peak="int8",
         own=True, extra=("knobs",)),
    dict(name="int8_ragged_nt", source=SRC + "int8_ragged_nt.cu",
         replaces="how_to_optimize_gemm_tpu/ops/pallas_int8.py:212",
         function="pallas_int8._kernel_bt under ragged_m_plan :404 "
                  "(mmult_q_bt_ragged :451, rung 18)",
         rung="18_ragged_m_int8", wrapper=int8.mmult_q_bt_ragged,
         plain=int8.mmult_q_bt_ref, library=_int_mm_nt,
         unaligned=(1000, 1032, 1100), more=(WALK,), tol=0.0, peak="int8",
         own=True, extra=("two_piece", "host", "subnormal")),
    dict(name="w4a8_gemm", source=SRC + "w4a8_gemm.cu",
         replaces="how_to_optimize_gemm_tpu/ops/pallas_int4.py:342",
         function="pallas_int4._kernel_w4a8 + _decode_w4 :36 "
                  "(mmult_q_w4a8, rung 07b)",
         rung="07b_pallas_w4a8", wrapper=int4.mmult_q_w4a8,
         plain=int4.mmult_q_w4a8_ref,
         library=None,   # no single PyTorch call decodes int4
         unaligned=(1000, 1032, 3584), more=(WALK,), tol=0.0, peak="int8",
         own=True),
    dict(name="bf16_gemm_nt", source=SRC + "bf16_gemm_nt.cu",
         replaces="how_to_optimize_gemm_tpu/ops/pallas_tuned.py:178",
         function="pallas_tuned._kernel_bf16_bt (mmult_bf16_bt, rung 15)",
         rung="15_packed_alias_bf16", wrapper=tuned.mmult_bf16_bt,
         plain=tuned.mmult_bf16_bt_ref,
         library=lambda a16, bt16, c: vendor.mmult_bf16(a16, bt16.t(), c),
         unaligned=(1000, 1032, 1100), more=(WALK, NT_EDGE), tol=W4A16_REL,
         peak="bf16", extra=("nt_walk",)),
    dict(name="fp32_gemm_nt", source=SRC + "fp32_gemm_nt.cu",
         replaces="how_to_optimize_gemm_tpu/ops/pallas_tuned.py:160",
         function="pallas_tuned._make_kernel_bt(HIGHEST) (mmult_fp32_bt, "
                  "rung 16)",
         rung="16_packed_alias_fp32", wrapper=tuned.mmult_fp32_bt,
         plain=tuned.mmult_fp32_bt_ref,
         library=lambda a, bt, c: vendor.mmult(a, bt.t(), c),
         unaligned=(1000, 1032, 1100),
         more=((1024, 1024, 1024), (2048, 2048, 2048)),
         tol=FP32_REL, peak="fp32", extra=("fp32_parts",)),
    dict(name="w4a16_gemm", source=SRC + "w4a16_gemm.cu",
         replaces="how_to_optimize_gemm_tpu/ops/pallas_int4.py:55",
         function="pallas_int4._kernel + _decode_w4 :36 (mmult_q, rung 07)",
         rung="07_pallas_int4", wrapper=int4.mmult_q, plain=int4.mmult_q_ref,
         library=None,   # no single PyTorch call decodes int4
         unaligned=(1000, 1032, 3584), more=(WALK,), tol=W4A16_REL,
         peak="bf16"),
    dict(name="bf16_gemm_nn", source=SRC + "bf16_gemm_nn.cu",
         replaces="how_to_optimize_gemm_tpu/ops/pallas_tuned.py:75",
         function="pallas_tuned._make_kernel(DEFAULT) (mmult_bf16 / "
                  "_mmult_impl :128, rung 05)",
         rung="05_pallas_bf16", wrapper=tuned.mmult_bf16,
         plain=tuned.mmult_bf16_ref, library=vendor.mmult_bf16,
         unaligned=(1000, 1032, 1100), tol=W4A16_REL, peak="bf16"),
    dict(name="fp32_gemm_nn", source=SRC + "fp32_gemm_nn.cu",
         replaces="how_to_optimize_gemm_tpu/ops/pallas_tuned.py:75",
         function="pallas_tuned._make_kernel(HIGHEST) (mmult / "
                  "_mmult_impl :128, rung 04)",
         rung="04_pallas_tuned_fp32", wrapper=tuned.mmult,
         plain=tuned.mmult_ref, library=vendor.mmult,
         unaligned=(1000, 1032, 1100),
         more=((1024, 1024, 1024), (2048, 2048, 2048)),
         tol=FP32_REL, peak="fp32", extra=("fp32_parts",)),
    # the rungs below 04: 00 on the CUDA cores, 02 and 03/03b bf16x3 on
    # mma.sync; an unaligned shape whose K and N rows are not 16-byte
    # multiples (02's and 03's wrappers pad them)
    dict(name="naive_gemm", source=SRC + "naive_gemm.cu",
         replaces="how_to_optimize_gemm_tpu/ops/naive_vpu.py:21",
         function="naive_vpu.mmult (plain JAX, K rank-1 updates; rung 00)",
         rung="00_naive_vpu", wrapper=naive.mmult, plain=naive.naive_ref,
         library=vendor.mmult, unaligned=(999, 1030, 1101), tol=FP32_REL,
         peak="fp32", ffma=True),
    dict(name="fp32_gemm_mn_tile", source=SRC + "fp32_gemm_mn_tile.cu",
         replaces="how_to_optimize_gemm_tpu/ops/pallas_mn_tile.py:24",
         function="pallas_mn_tile._kernel (mmult, rung 02)",
         rung="02_pallas_mn_tile", wrapper=mn_tile.mmult,
         plain=mn_tile.mn_tile_ref, library=vendor.mmult,
         unaligned=(999, 1030, 1101),
         more=((1024, 1024, 1024), (2048, 2048, 2048)), tol=FP32_REL,
         peak="fp32", extra=("bf16x3",)),
    dict(name="fp32_gemm_k_blocked", source=SRC + "fp32_gemm_k_blocked.cu",
         replaces="how_to_optimize_gemm_tpu/ops/pallas_k_blocked.py:31",
         function="pallas_k_blocked._kernel (mmult, rungs 03 and 03b)",
         rung="03_pallas_k_blocked", wrapper=k_blocked.mmult,
         plain=k_blocked.k_blocked_ref, library=vendor.mmult,
         unaligned=(999, 1030, 1101),
         more=((1024, 1024, 1024), (2048, 2048, 2048)), tol=FP32_REL,
         peak="fp32", extra=("bf16x3",)),
]


def bound(ops, m: int, n: int, k: int, peak: float = PEAK_INT8_OPS):
    """(ms, "bytes" | "operations"): the least time for this work, each
    input read once and the output written once, the operations at
    ``peak`` per second."""
    nbytes = sum(t.numel() * t.element_size() for t in ops)
    nbytes += 2 * 4 * m * n                     # C read, output written
    t_bytes = nbytes / PEAK_BYTES
    t_ops = 2.0 * m * n * k / peak
    return (1e3 * max(t_bytes, t_ops),
            "operations" if t_ops >= t_bytes else "bytes")


def print_fat_tiles() -> None:
    """The hand-pipeline kernels' tiles: rung 09's fat tile, derived from
    a block's shared memory and a thread's registers
    (``manual_dma.fat_tile``), and rungs 10's, 12's and 13's ping-pong
    tile, stages and shared memory."""
    bm, bn = manual_dma.fat_tile(1)
    print(f"rung 09: C tile {bm}x{bn} with 1 C/out buffer, "
          f"{manual_dma.fat_smem_bytes(bm, bn, 1):,} of "
          f"{manual_dma.SMEM_BLOCK:,} bytes of shared memory, "
          f"~{manual_dma.fat_regs(bm, bn)} registers a thread")
    tm, tn = manual_dma.PINGPONG_TILE
    print(f"rungs 10, 12 and 13: {tm}x{tn} a consumer warpgroup, the two "
          f"taking a block's tiles in turn, {manual_dma.PINGPONG_STAGES} "
          f"stages of {(tm + tn) * int8.STAGE_K // 1024} KB (13: one 1-D "
          f"bulk copy of a {tm * int8.STAGE_K:,}-byte image an operand), "
          f"{manual_dma.pingpong_smem_bytes():,} of "
          f"{manual_dma.SMEM_BLOCK:,} bytes of shared memory")
    size, active = manual_dma.strip_clusters()
    if size != manual_dma.CLUSTER:
        raise AssertionError(f"rung 11: the kernel's cluster {size} is not "
                             f"manual_dma.CLUSTER {manual_dma.CLUSTER}")
    print(f"rung 11: clusters of {size} blocks along N share each A box by "
          f"multicast, {active} clusters at once on the card")
    budget = int8.l2_budget("cuda")
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    for rung, tiled in (("12", False), ("13", True)):
        need = manual_dma.resident_bytes(P_FULL, P_FULL, P_FULL, tiled)
        print(f"rung {rung}: {need:,} resident bytes at p={P_FULL} against "
              f"the budget {budget:,} ({int8.L2_SHARE} of the {l2:,}-byte "
              f"L2): {'resident' if need <= budget else 'rung 11'}")
    cap = int8.ragged_cap(P_FULL, budget)
    print(f"rung 18: cap {cap} at K={P_FULL}, plan "
          f"{int8.ragged_m_plan(P_FULL, cap)} at p={P_FULL}")


def _launched(name: str, before: dict) -> None:
    """``name`` launched once since ``before`` and rung 11's kernel not:
    the call stayed on its own kernel."""
    now = _build.LAUNCHES
    if (now[name] - before[name] != 1
            or now["int8_strip_nt"] != before["int8_strip_nt"]):
        raise AssertionError(f"{name}: launches {before} -> {dict(now)}")


def check_pretile(spec: dict, gen: torch.Generator) -> dict:
    """Rung 13's repack: EQUAL to its plain version byte for byte on the
    prepared A and B^T at the spec's shapes; timed on A at P_FULL."""
    name = spec["name"]
    rung = registry.get(spec["rung"])
    for m, n, k in (spec["unaligned"], *spec["more"],
                    (P_FULL, P_FULL, P_FULL)):
        a, b, _ = make_abc(gen, m, n, k, "cuda")
        qa, _, qbt, _ = rung.prepare(a, b)
        for x in (bounds.pad_dim(qa, 1, int8.ALIGN),
                  bounds.pad_dim(qbt, 1, int8.ALIGN)):
            before = dict(_build.LAUNCHES)
            out = manual_dma.pretile(x)
            ref = manual_dma.pretile_ref(x)
            torch.cuda.synchronize()
            _launched(name, before)
            if not torch.equal(out, ref):
                raise AssertionError(f"{name} {tuple(x.shape)} differs from "
                                     "its plain version")
        print(f"{name} {m}x{n}x{k}: A and B^T images EQUAL to the plain "
              f"version, {tuple(out.shape)}")
    t = {fn.__name__: time_calls(lambda: fn(x)) * 1e3
         for fn in (manual_dma.pretile, manual_dma.pretile_ref)}
    b_ms, b_by = bound_ms(nbytes(x, ref), 0, PEAK_INT8_OPS)
    print(f"{name} {tuple(x.shape)}: {t['pretile']:.4f} ms (plain "
          f"{t['pretile_ref']:.4f}, bound {b_ms:.4f} by {b_by}; "
          f"{BEFORE_MS[name]} ms before the rebuild into swizzled stage "
          "images)")
    return {"max_abs_err": 0.0, "ms": t["pretile"],
            "plain_ms": t["pretile_ref"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}


def check_knobs(name: str, ops, c, gen: torch.Generator) -> None:
    """Rung 17's six instances (``hand_pipeline.B_BUFFERS`` x
    a_lookahead): each EQUAL to ``int8_gemm_nt``'s output at WALK and at
    P_FULL (the reference's test_bit_identical_to_rung14), each timed at
    P_FULL."""
    a, b, cw = make_abc(gen, *WALK, "cuda")
    walk = list(int8.prepare_packed(a, b))
    knobs = [(nb, la) for nb in hand_pipeline.B_BUFFERS
             for la in (False, True)]
    for args, cc in ((walk, cw), (ops, c)):
        k2 = int8.mmult_q_bt(*args, cc.clone())
        for nb, la in knobs:
            out = hand_pipeline.mmult_q_bt_hand(*args, cc.clone(),
                                                b_buffers=nb, a_lookahead=la)
            torch.cuda.synchronize()
            if not torch.equal(out, k2):
                raise AssertionError(f"rung 17 b_buffers={nb} a_lookahead="
                                     f"{la} {tuple(cc.shape)} differs from "
                                     "int8_gemm_nt")
    print(f"rung 17: all {len(knobs)} instances EQUAL to int8_gemm_nt at "
          f"{WALK} and p={P_FULL}")
    for nb, la in knobs:
        ms = time_chained(
            lambda *x, nb=nb, la=la: hand_pipeline.mmult_q_bt_hand(
                *x, b_buffers=nb, a_lookahead=la),
            ops, c, inner_iters=20, outer_repeats=3, warmup=2) * 1e3
        print(f"rung 17 b_buffers={nb} a_lookahead={la} p={P_FULL}: "
              f"{ms:.4f} ms = {2.0 * P_FULL ** 3 / ms * 1e-9:.1f} Tops/s")


def check_two_piece(name: str, ops, c, gen: torch.Generator) -> None:
    """Rung 18 at P_FULL on the reference test's two-piece plan
    (RAGGED_CAP): EQUAL to its plain version, on its own kernel."""
    plan = int8.ragged_m_plan(P_FULL, RAGGED_CAP)
    if len(plan) != 2:
        raise AssertionError(f"cap {RAGGED_CAP}: plan {plan} has no tail")
    before = dict(_build.LAUNCHES)
    out = int8.mmult_q_bt_ragged(*ops, c.clone(), cap=RAGGED_CAP)
    torch.cuda.synchronize()
    _launched("int8_ragged_nt", before)
    if not torch.equal(out, int8.mmult_q_bt_ref(*ops, c)):
        raise AssertionError(f"rung 18 plan {plan} differs from its plain "
                             "version")
    print(f"rung 18 p={P_FULL} cap {RAGGED_CAP} plan {plan}: EQUAL, one "
          "int8_ragged_nt launch")


def check_residue(name: str, ops, c, gen: torch.Generator) -> None:
    """int8_gemm_nt's time right after one call of rung 10, 12 or 13
    (median of 9): lines rungs 12 and 13 leave in the L2 under evict_last
    would slow the next kernel's reads."""
    for name, fn in (("10", manual_dma.mmult_q_packed),
                     ("12", manual_dma.mmult_q_resident),
                     ("13", manual_dma.mmult_q_tiled_resident)):
        times = []
        for _ in range(9):
            fn(*ops, c)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            cc = c.clone()
            start.record()
            int8.mmult_q_bt(*ops, cc)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        print(f"int8_gemm_nt right after rung {name}: "
              f"{sorted(times)[4]:.4f} ms (median of 9)")


P_HOST = 2048


def check_host(name: str, ops, c, gen: torch.Generator) -> None:
    """At P_HOST, rungs 12, 13, 14 and 18: the chained time a call (the
    host's issue included, as the sweep and ab time it) beside a CUDA-graph
    replay's (the device's time alone)."""
    a, b, cc = make_abc(gen, P_HOST, P_HOST, P_HOST, "cuda")
    small = list(int8.prepare_packed(a, b))
    for name in ("12_resident_int8", "13_tiled_resident_int8",
                 "14_packed_alias_int8", "18_ragged_m_int8"):
        run = registry.get(name).run
        chained = time_chained(run, small, cc, inner_iters=20,
                               outer_repeats=3, warmup=2) * 1e3
        replay = time_calls(lambda: run(*small, cc.clone()),
                            graph=True) * 1e3
        print(f"{name} p={P_HOST}: {chained:.4f} ms a call chained, "
              f"{replay:.4f} ms a graph replay (with a copy of C)")


def check_nt_walk(name: str, ops, c, gen: torch.Generator) -> None:
    """Rung 15's kernel: at WALK its persistent grid (one block an SM)
    walks more tiles than blocks, and not a multiple of them
    (``tuned.nt_tile_walk``); two calls at P_FULL give the same bits."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lengths = [len(w) for w in tuned.nt_tile_walk(WALK[0], WALK[1], sms)]
    if not (max(lengths) > 1 and min(lengths) < max(lengths)):
        raise AssertionError(f"bf16_gemm_nt at {WALK}: the walk of "
                             f"{sum(lengths)} tiles on {sms} SMs does not "
                             "wrap")
    out = tuned.mmult_bf16_bt(*ops, c.clone())
    again = tuned.mmult_bf16_bt(*ops, c.clone())
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError("bf16_gemm_nt: two calls differ")
    print(f"bf16_gemm_nt: {sum(lengths)} tiles at {WALK} on {sms} SMs (each "
          f"block walks {min(lengths)}-{max(lengths)}); two calls at "
          f"p={P_FULL} bit-equal")


def check_int8_walk(name: str, ops, c, gen: torch.Generator) -> None:
    """K2's int8 wgmma kernel: at WALK its persistent grid (one block an SM)
    walks more 128 x 256 tiles than blocks, and not a multiple of them
    (``tuned.nt_tile_walk`` on ``int8.NT_TILE``); two calls at P_FULL give
    the same bits."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lengths = [len(w) for w in tuned.nt_tile_walk(WALK[0], WALK[1], sms,
                                                  int8.NT_TILE)]
    if not (max(lengths) > 1 and min(lengths) < max(lengths)):
        raise AssertionError(f"{name} at {WALK}: the walk of "
                             f"{sum(lengths)} tiles on {sms} SMs does not "
                             "wrap")
    out = int8.mmult_q_bt(*ops, c.clone())
    again = int8.mmult_q_bt(*ops, c.clone())
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"{name}: two calls differ")
    print(f"{name}: {sum(lengths)} tiles at {WALK} on {sms} SMs (each "
          f"block walks {min(lengths)}-{max(lengths)}); two calls at "
          f"p={P_FULL} bit-equal")


def check_subnormal(name: str, ops, c, gen: torch.Generator) -> None:
    """K2 or rung 18 on sa = 2^-120 and sb = 2^-30, passed to the wrapper
    directly, and a C of subnormals of both signs: v = (acc x 2^-120) x
    2^-30 and v + C are subnormal for 2 <= |acc| < 2^23. EQUAL to the plain
    version where the tensor-map reduction adds C (N 264) and where each
    thread does (N 262)."""
    wrapper = (int8.mmult_q_bt if name == "int8_gemm_nt"
               else int8.mmult_q_bt_ragged)
    m, k = 300, 520
    for n in (264, 262):
        qa = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                           dtype=torch.int8)
        qbt = torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                            dtype=torch.int8)
        sa = torch.full((m, 1), 2.0 ** -120, device="cuda")
        sb = torch.full((1, n), 2.0 ** -30, device="cuda")
        cs = torch.randint(-2 ** 20, 2 ** 20, (m, n), generator=gen,
                           device="cuda").float() * 2.0 ** -149
        out = wrapper(qa, sa, qbt, sb, cs.clone())
        ref = int8.mmult_q_bt_ref(qa, sa, qbt, sb, cs)
        torch.cuda.synchronize()
        tiny = float((ref.abs() < torch.finfo(torch.float32).tiny).float()
                     .mean())
        if tiny < 0.9 or not torch.equal(out, ref):
            raise AssertionError(f"{name} subnormal case N={n}: "
                                 f"{int((out != ref).sum())} elements "
                                 f"differ, {tiny:.3f} subnormal")
        print(f"{name} subnormal case {m}x{n}x{k}: EQUAL, {tiny:.3f} of "
              "the outputs subnormal")


def check_fp32_parts(name: str, ops, c, gen: torch.Generator) -> None:
    """Rung 16's or rung 04's wrapper at P_FULL in its parts: the two
    ``split_bf16`` launches (A and BT, or A and B as it lies, into bf16
    hi + lo planes) and ``fp32_gemm_nt`` (in place) or ``fp32_gemm_nn`` (a
    fresh output) alone on planes split beforehand, whose bits must equal
    the wrapper's; each timed."""
    a, b = ops
    m, n = c.shape
    in_place = name == "fp32_gemm_nt"
    wrapper = tuned.mmult_fp32_bt if in_place else tuned.mmult

    def split():
        return grouped_gemm.split_bf16(a), grouped_gemm.split_bf16(b)
    a2, b2 = split()
    # rung 16 passes its padded K as the wrapper does; rung 04's B map
    # needs the true K (B's planes have K rows)
    k = a2.shape[2] if in_place else a.shape[1]

    def product(a_, b_, cc):
        out = cc if in_place else torch.empty_like(cc)
        _build.launch(name, cc.device, a2, b2, cc, out, m, n, k, a2.shape[2],
                      b2.shape[2], n)
        return out
    alone = product(a, b, c.clone())
    whole = wrapper(a, b, c.clone())
    torch.cuda.synchronize()
    if not torch.equal(alone, whole):
        raise AssertionError(f"{name}: the kernel alone differs from its "
                             "wrapper")
    split_ms = time_calls(split) * 1e3
    product_ms = time_chained(product, ops, c, inner_iters=20,
                              outer_repeats=3, warmup=2) * 1e3
    b_ms, b_by = bound([a2, b2], m, n, a.shape[1], PEAK_FP32_FLOPS)
    print(f"{name} p={P_FULL} in parts: the two splits "
          f"{split_ms:.4f} ms, the product alone {product_ms:.4f} ms "
          f"(bound {b_ms:.4f} by {b_by}), bits equal to the wrapper's")


def check_bf16x3(name: str, ops, c, gen: torch.Generator) -> None:
    """Rungs 02, 03 and 03b (bf16x3 on mma.sync, the split inside the
    kernel) at P_FULL: within FP32_REL / 2 of max |plain| at K 4,096, two
    calls bit-equal, one launch a call and no split_bf16. Rung 03b (03's
    kernel at half the block edge) also at 03's shapes, within FP32_REL
    and under its gate against fp64, and timed beside 03 at P_FULL."""
    rungs = {"fp32_gemm_mn_tile": {"02_pallas_mn_tile": mn_tile.mn_tile_ref},
             "fp32_gemm_k_blocked": dict.fromkeys(
                 ("03_pallas_k_blocked", "03b_pallas_small_blocks"),
                 k_blocked.k_blocked_ref)}[name]
    shapes = {"03b_pallas_small_blocks": ((999, 1030, 1101),
                                          (1024, 1024, 1024),
                                          (2048, 2048, 2048))}
    for rung_name, plain in rungs.items():
        rung = registry.get(rung_name)
        cases = [(*make_abc(gen, *s, "cuda"), FP32_REL)
                 for s in shapes.get(rung_name, ())]
        cases.append((*ops, c, FP32_REL / 2))
        for a, b, cc, tol in cases:
            before = dict(_build.LAUNCHES)
            out = rung.run(a, b, cc)
            again = rung.run(a, b, cc)
            ref = plain(a, b, cc)
            torch.cuda.synchronize()
            got = (_build.LAUNCHES[name] - before[name],
                   _build.LAUNCHES["split_bf16"] - before["split_bf16"])
            err = float((out - ref).abs().max() / ref.abs().max())
            oracle = a.double() @ b.double() + cc.double()
            rel = float((out.double() - oracle).abs().max()
                        / oracle.abs().max())
            shape = (*cc.shape, a.shape[1])
            print(f"{rung_name} {shape}: {err:.3e} of max|plain| (bound "
                  f"{tol}), {rel:.3e} against fp64, two calls "
                  f"{'bit-equal' if torch.equal(out, again) else 'DIFFER'}")
            if not (got == (2, 0) and err <= tol and rel < rung.gate_rel
                    and torch.equal(out, again)):
                raise AssertionError(f"{rung_name} {shape}: launches "
                                     f"{got}, err {err}, rel {rel}")
    if name == "fp32_gemm_k_blocked":
        ms = {fn.__name__: time_chained(fn, ops, c, inner_iters=20,
                                        outer_repeats=3, warmup=2) * 1e3
              for fn in (k_blocked.mmult_small, k_blocked.mmult)}
        print(f"03b_pallas_small_blocks p={P_FULL}: {ms['mmult_small']:.4f} "
              f"ms (03: {ms['mmult']:.4f})")


def _launched_with_splits(name: str, before: dict) -> None:
    """``name`` launched once and ``split_bf16`` twice since ``before``:
    rungs 16's and 04's wrappers split both operands, then take the
    product."""
    now = _build.LAUNCHES
    got = (now[name] - before[name], now["split_bf16"] - before["split_bf16"])
    if got != (1, 2):
        raise AssertionError(f"{name}: launches (kernel, split_bf16) {got}, "
                             "expected (1, 2)")


EXTRA_CHECKS = {"knobs": check_knobs, "two_piece": check_two_piece,
                "residue": check_residue, "host": check_host,
                "nt_walk": check_nt_walk, "fp32_parts": check_fp32_parts,
                "bf16x3": check_bf16x3,
                "int8_walk": check_int8_walk, "subnormal": check_subnormal}


def check_kernel(spec: dict, gen: torch.Generator) -> dict:
    """Compare with the plain version at its shapes; time at P_FULL."""
    if spec.get("check") == "pretile":
        return check_pretile(spec, gen)
    name = spec["name"]
    rung = registry.get(spec["rung"])
    result = {"max_abs_err": 0.0}
    for m, n, k in (spec["unaligned"], *spec.get("more", ()),
                    (P_FULL, P_FULL, P_FULL)):
        a, b, c = make_abc(gen, m, n, k, "cuda")
        prepared = rung.prepare(a, b)
        # the kernel's operands: 07b's and 07's prepare add kdim
        ops = [x for x in prepared if isinstance(x, torch.Tensor)]
        before = dict(_build.LAUNCHES)
        cin = c.clone()
        out = spec["wrapper"](*ops, cin)
        ref = spec["plain"](*ops, c)
        torch.cuda.synchronize()
        if spec.get("fresh") and not torch.equal(cin, c):
            raise AssertionError(f"{name} {m}x{n}x{k} changed C")
        if spec.get("own"):
            _launched(name, before)
        if "fp32_parts" in spec.get("extra", ()):
            _launched_with_splits(name, before)
        max_abs = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        ae, be = rung.effective(prepared)
        oracle = ae.double() @ be.double() + c.double()
        rel = float((out.double() - oracle).abs().max()
                    / oracle.abs().max().clamp_min(1e-30))
        print(f"{name} {m}x{n}x{k}: max|kernel - plain| = {max_abs} = "
              f"{max_abs / scale:.3e} of max|plain| (bound {spec['tol']}), "
              f"rel vs fp64 = {rel:.3e} (gate {rung.gate_rel})")
        if not (max_abs <= spec["tol"] * scale and rel < rung.gate_rel):
            raise AssertionError(f"{name} {m}x{n}x{k} disagrees: "
                                 f"max_abs {max_abs}, rel {rel}")
        result["max_abs_err"] = max(result["max_abs_err"], max_abs)
    # timed at the last (full) shape, on this run's inputs
    t = {key: time_chained(spec[key], ops, c, inner_iters=20,
                           outer_repeats=3, warmup=2) * 1e3
         for key in ("wrapper", "plain")}
    lib_ms = None
    if spec["library"] is not None:
        lib_ms = time_chained(spec["library"], ops, c, inner_iters=20,
                              outer_repeats=3, warmup=2) * 1e3
    bound_ms, bound_by = bound(ops, P_FULL, P_FULL, P_FULL,
                               PEAKS[spec["peak"]])
    result.update(ms=t["wrapper"], plain_ms=t["plain"], bound_ms=bound_ms,
                  bound_by=bound_by, library_ms=lib_ms)
    ffma = ""
    if spec.get("ffma"):
        ffma_ms = bound(ops, P_FULL, P_FULL, P_FULL, PEAK_FFMA_FLOPS)[0]
        ffma = f"; the FFMA ceiling {ffma_ms:.4f}"
    tops = 2.0 * P_FULL ** 3 / result["ms"] * 1e-9
    before = (f"; {BEFORE_MS[name]} ms before its rebuild"
              if name in BEFORE_MS else "")
    print(f"{name} p={P_FULL}: {result['ms']:.4f} ms = {tops:.1f} Tops/s "
          f"(plain {result['plain_ms']:.4f}, library {lib_ms}, bound "
          f"{bound_ms:.4f} by {bound_by} at the {spec['peak']} peak{ffma}"
          f"{before})")
    for extra in spec.get("extra", ()):
        EXTRA_CHECKS[extra](name, ops, c, gen)
    return result


def main_path(out_dir: pathlib.Path) -> dict:
    """The driver's sweeps and the headline bench, as a user runs them."""
    for rung in MAIN_RUNGS:
        print(f"== {rung} ==")
        host = run_sweep(rung, SweepConfig(pfirst=1024, plast=1024, pinc=1),
                         output_dir=out_dir / "host_oracle")
        dev = run_sweep(rung, SweepConfig(pfirst=2048, plast=P_FULL,
                                          pinc=2048),
                        output_dir=out_dir / "device_check",
                        quant_oracle=False, verify="device")
        for sub, rows in (("host_oracle", host), ("device_check", dev)):
            version, mrows = mfile.read_mfile(out_dir / sub
                                              / f"output_{rung}.m")
            if version != rung or [r[0] for r in mrows] != [r.p for r in
                                                             rows]:
                raise AssertionError(f"{rung}: .m file does not hold "
                                     "the sweep's rows")
        gate = registry.get(rung).gate_rel
        for r in host + dev:
            if not (math.isfinite(r.gflops) and r.gflops > 0
                    and r.kernel_rel < gate):
                raise AssertionError(f"{rung} p={r.p}: bad row {r}")
    record = bench.measure()
    print(json.dumps(record))
    drive_cli(out_dir / "driver")
    return record


def drive_cli(out_dir: pathlib.Path) -> None:
    """``driver --new 03 --old 02 --roofline --trace`` at P_DRIVER: both
    rungs' rows gated, their .m files written, and each trace naming its
    rung's hand kernel and no other kernel (no library GEMM)."""
    old, new = DRIVER_RUNGS
    results = driver.main(["--new", new, "--old", old, "--pfirst",
                           str(P_DRIVER), "--plast", str(P_DRIVER),
                           "--pinc", "1", "--output-dir", str(out_dir),
                           "--roofline", "--trace"])
    for rung, kernel in DRIVER_RUNGS.items():
        names = [op.name for op in results[rung]["trace"]]
        if not names or any(kernel not in name for name in names):
            raise AssertionError(f"driver --trace of {rung}: kernels "
                                 f"{names}, expected only {kernel}")
        rows = results[rung]["rows"]
        if [r.p for r in rows] != [P_DRIVER] or not (
                (out_dir / f"output_{rung}.m").exists()):
            raise AssertionError(f"driver {rung}: rows {rows}")


# ------------------------------------------------------------- serving

CFG_7B = llama.llama2_7b("w4a8")
MOE_CFG = llama.mixtral_8x7b("int8")
SLOTS = 4
DECODE_ATOL = 2e-3   # decode_attention vs its plain version (sum order, exp)
# flash_attention vs its plain version at the kernel's key tiles
# (attention.KERNEL_BK, 64 keys): in every row, max |kernel - plain| within
# FLASH_ULPS bf16 ulps of that row's max |plain| (attention.bf16_row_ulps).
# fp32 sums in another order, and exp as ex2.approx of the score times
# log2(e), can flip the bf16 rounding of p or of an output by one ulp; one
# 64-key tile skipped reads tens of ulps, and the check plants that fault
# to show it
FLASH_ULPS = 2.0
# the times of the rebuilt kernels before their rebuild: the flash
# forwards at the 7B prefill row and the soak's row, rungs 15, 16, 05, 04,
# 14 (K2), 18, 11, 17 (its b_buffers 3 with lookahead), 10, 12 and 13
# (their mma.sync fat kernel; 13's repack a launch on A) at P_FULL, dK/dV
# and dQ (its mma.sync kernel) at the soak's row, the serving kernels
# at their JSON rows (paged_kv_update with its stacked table at the 7B
# bf16 pool; the W4A8 decode GEMV's two launches at m = 4,
# 4,096 -> 11,008; the bf16 paged attention's one-block walk at the 7B
# pool; the W4A16 GEMV on the CUDA cores at m = 4, 4,096 -> 11,008 and
# its GEMM on mma.sync at m = 1,024, 4,096 -> 11,008; int8_gemm_noc on
# mma.sync at m = 1,024, 4,096 -> 11,008 and K3 at P_FULL; the float
# ladder's rungs 02 and 03 on the CUDA cores (FFMA) at P_FULL) (PERF.md
# section 6; NVIDIA H100 80GB HBM3, 700.00 W), printed beside this run's
BEFORE_MS = {"flash_attention": 2.8005, "flash_attention_fwd_lse": 0.2761,
             "bf16_gemm_nt": 0.6477, "flash_attention_bwd_dkv": 1.0286,
             "fp32_gemm_nt": 6.6231, "bf16_gemm_nn": 0.5681,
             "fp32_gemm_nn": 4.4085, "paged_decode_attention_q8": 0.8038,
             "w4a8_gemm_noc": 0.5742, "decode_attention_q8": 0.7697,
             "int8_gemm_nt": 0.4099, "int8_ragged_nt": 0.4124,
             "w4a8_gemv_fq": 0.0201, "paged_decode_attention": 0.5354,
             "w4a16_gemv": 0.0306, "w4a16_gemm_noc": 0.7901,
             "int8_gemm_noc": 0.3395, "w4a8_gemm": 0.6427,
             "int8_gemm_nn": 0.4896, "w4a16_gemm": 0.9937,
             "flash_attention_bwd_dq": 0.3791, "fp32_gemm_mn_tile": 16.0474,
             "fp32_gemm_k_blocked": 3.9921, "int8_strip_nt": 1.4485,
             "int8_hand_pipe_nt": 0.6475, "int8_fat_nt": 0.5114,
             "int8_resident_nt": 0.5076, "int8_tiled_resident_nt": 0.4951,
             "int8_pretile": 0.0485, "paged_kv_update": 0.0036}
# card vs CPU logits on the same routes: at most PARITY_SENSITIVITY x the
# CPU's own response to a PERTURB relative perturbation of the embeddings
PARITY_SENSITIVITY = 3.0
PERTURB = 1e-6
# An MoE row compares the positions that every side routes to the CPU's
# experts in every layer. A token routed otherwise (at most half the
# positions) must be a near-tie on the CPU side: its k-th and (k+1)-th
# router probabilities within PARITY_TIE. The card's MoE input differs
# from the CPU's by up to ~0.5% where flash's bf16 roundings differ
# (measured 4.9e-3 of max at the kernel's tiles on an H100), which
# moves router probabilities by a few 1e-3.
PARITY_TIE = 1e-2

# The serving kernels; each entry's check returns its result at the
# shape the JSON line reports (the first of its shapes) and prints the
# others.
SERVE_KERNELS = [
    dict(name="w4a8_gemm_noc", source=SRC + "w4a8_gemm_noc.cu",
         replaces="how_to_optimize_gemm_tpu/ops/pallas_int4.py:364",
         function="pallas_int4._kernel_w4a8_noc + _kernel_w4a8_noc_gemv "
                  ":135 (mmult_q_w4a8_noc)"),
    dict(name="w4a8_gemv_fq", source=SRC + "w4a8_gemv_fq.cu",
         replaces="how_to_optimize_gemm_tpu/ops/pallas_int4.py:380",
         function="pallas_int4._kernel_w4a8_noc_gemv_fq "
                  "(mmult_w4a8_fused_noc)"),
    dict(name="kv_update", source=SRC + "kv_update.cu",
         replaces="how_to_optimize_gemm_tpu/ops/pallas_kv_update.py:43",
         function="pallas_kv_update._kernel_contig (kv_update)"),
    dict(name="decode_attention", source=SRC + "decode_attention.cu",
         replaces="how_to_optimize_gemm_tpu/ops/"
                  "pallas_decode_attention.py:119",
         function="pallas_decode_attention._kernel_v3 + _kernel_v4 :207 "
                  "(decode_attention)"),
    dict(name="int8_gemm_noc", source=SRC + "int8_gemm_noc.cu",
         replaces="how_to_optimize_gemm_tpu/ops/pallas_int8.py:46",
         function="pallas_int8._kernel_noc (mmult_q_noc)"),
    dict(name="w4a16_gemm_noc", source=SRC + "w4a16_gemm_noc.cu",
         replaces="how_to_optimize_gemm_tpu/ops/pallas_int4.py:71",
         function="pallas_int4._kernel_noc + _decode_w4 :36 (mmult_q_noc, "
                  "m > 64)"),
    dict(name="w4a16_gemv", source=SRC + "w4a16_gemv.cu",
         replaces="how_to_optimize_gemm_tpu/ops/pallas_int4.py:89",
         function="pallas_int4._kernel_noc_gemv (mmult_q_noc, m <= 64)"),
    dict(name="decode_attention_q8", source=SRC + "decode_attention_q8.cu",
         replaces="how_to_optimize_gemm_tpu/ops/"
                  "pallas_decode_attention.py:469",
         function="pallas_decode_attention._kernel_q8_v3 + _kernel_q8_v4 "
                  ":570 (decode_attention_q8)"),
    dict(name="paged_kv_update", source=SRC + "paged_kv_update.cu",
         replaces="how_to_optimize_gemm_tpu/ops/pallas_kv_update.py:137",
         function="pallas_kv_update._kernel_paged (paged_kv_update)"),
    dict(name="paged_decode_attention",
         source=SRC + "paged_decode_attention.cu",
         replaces="how_to_optimize_gemm_tpu/ops/"
                  "pallas_paged_attention.py:59",
         function="pallas_paged_attention._kernel_v4_paged + "
                  "_kernel_v3_paged :154 (paged_decode_attention)"),
    dict(name="paged_decode_attention_q8",
         source=SRC + "paged_decode_attention_q8.cu",
         replaces="how_to_optimize_gemm_tpu/ops/"
                  "pallas_paged_attention.py:350",
         function="pallas_paged_attention._kernel_q8_v4_paged + "
                  "_kernel_q8_v3_paged :455 (paged_decode_attention_q8)"),
    dict(name="flash_attention", source=SRC + "flash_attention.cu",
         replaces="how_to_optimize_gemm_tpu/ops/pallas_attention.py:35",
         function="pallas_attention._stream_kernel (flash_attention, "
                  "mha_flash)"),
]

# The serving paths: (weight kind, cache kind, the kernels each must
# launch, the engine's paged options). The paged paths' requests and pool
# are made by ``paged_requests``.
W4A8_PAGED = ["w4a8_gemm_noc", "w4a8_gemv_fq", "paged_kv_update"]
SERVE_PATHS = {
    "S-w4a8": ("w4a8", "bf16", ["w4a8_gemm_noc", "w4a8_gemv_fq",
                                "kv_update", "decode_attention"], {}),
    "S-int8": ("int8", "bf16", ["int8_gemm_noc", "kv_update",
                                "decode_attention"], {}),
    "S-int4": ("int4", "bf16", ["w4a16_gemm_noc", "w4a16_gemv",
                                "kv_update", "decode_attention"], {}),
    "S-kv8": ("w4a8", "int8", ["w4a8_gemm_noc", "w4a8_gemv_fq",
                               "kv_update", "decode_attention_q8"], {}),
    "S-paged": ("w4a8", "bf16", W4A8_PAGED + ["paged_decode_attention"],
                dict(paged=True, prefix_cache=True)),
    "S-paged-kv8": ("w4a8", "int8",
                    W4A8_PAGED + ["paged_decode_attention_q8"],
                    dict(paged=True, prefill_chunk=256)),
    "S-long": ("w4a8", "bf16", ["w4a8_gemm_noc", "w4a8_gemv_fq",
                                "kv_update", "flash_attention",
                                "decode_attention"], {}),
}
# S-paged-kv8's prompts: make_requests(8, 300, 32, seed=3, 700) gives
# 625, 334, 371, 394, 372, 621, 648 and 533 tokens. The first four hold
# 2 + 1 + 1 + 2 = 6 pages of 384 at admission, and the 371-token prompt
# needs a second page 13 tokens into its decode; with 6 pages besides the
# trash page (cache_pages = 7) the pool is dry then, and the newest other
# slot is preempted. ``paged_requests`` works this out from the lengths.
PAGED_KV8_SEED = 3
# S-long's prompts: make_requests(8, 512, 32, seed=0, 3500) gives 3,054,
# 2,415, 2,039, 1,318, 1,432, 634, 736 and 561 tokens. The first four are
# admitted in one dispatch at bucket 4,096 (m = 16,384 rows), the last four
# at 2,048, without chunking: every layer of each admission launches
# flash_attention.
LONG_SEED = 0


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(n_bytes: float, ops: float, peak_ops: float):
    """(ms, "bytes" | "operations") for work moving ``n_bytes`` once and
    doing ``ops`` operations at ``peak_ops`` per second."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, ops / peak_ops
    return (1e3 * max(t_bytes, t_ops),
            "operations" if t_ops >= t_bytes else "bytes")


def timed(name: str, shape: str, kernel, plain, library, b_ms, b_by,
          err: float, wrapper=None) -> dict:
    """Time the kernel, its plain version and the library call; print.

    The kernel and the library call are timed as CUDA-graph replays (the
    device's time per call); the kernel also as called from Python one
    after another, which is what the serving path pays when the host,
    not the device, sets the pace. The plain version synchronizes (it
    reads lengths on the host), so it is timed from Python. ``wrapper``,
    where the kernel's wrapper launches other kernels too (a pre-pass),
    is the wrapper's call, timed as a replay beside the kernel alone
    (``wrapper_ms``)."""
    r = dict(max_abs_err=err, ms=time_calls(kernel, graph=True) * 1e3,
             plain_ms=time_calls(plain, inner_iters=3) * 1e3,
             library_ms=(None if library is None
                         else time_calls(library, graph=True) * 1e3),
             bound_ms=b_ms, bound_by=b_by)
    eager_ms = time_calls(kernel) * 1e3
    lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
    also = ""
    if wrapper is not None:
        r["wrapper_ms"] = time_calls(wrapper, graph=True) * 1e3
        also = f"; the wrapper, its pre-pass included, {r['wrapper_ms']:.4f}"
    print(f"{name} {shape}: max|kernel - plain| = {err}; {r['ms']:.4f} ms "
          f"(called from Python {eager_ms:.4f}; plain {r['plain_ms']:.4f}, "
          f"library {lib}, bound {b_ms:.4f} by {b_by}{also})")
    return r


def _equal(name: str, shape: str, out, ref) -> float:
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    if not torch.equal(out, ref):
        raise AssertionError(f"{name} {shape}: differs from its plain "
                             f"version by {err}")
    return err


def check_w4a8_noc(gen: torch.Generator) -> dict:
    """Kernel 2 at the prefill widths: M = 4 slots x a 256-token bucket (the
    JSON row, 4,096 -> 11,008, then 11,008 -> 4,096), then a 128-token
    chunk and S-long's admission at bucket 4,096 (m = 16,384), each EQUAL
    to its plain version."""
    results = []
    for m, k, n in ((SLOTS * 256, 4096, 11008), (SLOTS * 256, 11008, 4096),
                    (128, 4096, 11008), (SLOTS * 4096, 4096, 11008)):
        x = torch.randn((m, k), generator=gen, device="cuda")
        w = torch.randn((k, n), generator=gen, device="cuda")
        qa, sa, packed, sw, _ = int4.prepare_w4a8(x, w)
        del x, w
        args = (qa, sa, packed, sw)
        shape = f"M={m} {k}->{n}"
        err = _equal("w4a8_gemm_noc", shape, int4.mmult_q_w4a8_noc(*args),
                     int4.mmult_q_w4a8_noc_ref(*args))
        b = bound_ms(nbytes(*args) + 4 * m * n, 2.0 * m * n * k,
                     PEAK_INT8_OPS)
        results.append(timed("w4a8_gemm_noc", shape,
                             lambda: int4.mmult_q_w4a8_noc(*args),
                             lambda: int4.mmult_q_w4a8_noc_ref(*args),
                             None, *b, err))
        if len(results) == 1:
            print(f"w4a8_gemm_noc {shape}: {results[0]['ms']:.4f} ms on "
                  f"int8 wgmma; {BEFORE_MS['w4a8_gemm_noc']} ms before the "
                  "rebuild (mma.sync)")
        del args, qa, packed
        torch.cuda.empty_cache()
    return results[0]


def gemv_host_ops(name: str, call) -> None:
    """Print the host's operations of one call of the fused GEMV (top-level
    aten ops, runtime launches) and fail unless the card ran it as one
    kernel."""
    prof = profiling.call_profile(call)
    if len(prof.kernels) != 1 or "gemv_fq" not in prof.kernels[0]:
        raise AssertionError(f"{name}: the card ran {prof.kernels} for one "
                             "call, not the one kernel")
    print(f"{name}: one kernel a call; host ops a call {len(prof.aten)} "
          f"aten {prof.aten}, {len(prof.launches)} launches "
          f"{prof.launches}")


def check_w4a8_gemv(gen: torch.Generator) -> dict:
    """Kernel 3 at the decode widths of every 7B linear (m = 4, the JSON
    row first, and 1), at m = 16 and 64 (two and eight row groups of the
    kernel) and at K = 5,000 (a pack block's low half partly past K):
    each EQUAL to its plain version. (Its one kernel a call is checked by
    torch.profiler in S-w4a8, after the driver's --trace: a profiler
    session before that trace has left it empty on an H100.)"""
    results = []
    for k, n in ((4096, 11008), (4096, 4096), (11008, 4096), (5000, 4096)):
        w = torch.randn((k, n), generator=gen, device="cuda")
        _, _, packed, sw, _ = int4.prepare_w4a8(w[:1], w)
        del w
        for m in ((4, 1, 16, 64) if k != 5000 else (4,)):
            x = torch.randn((m, k), generator=gen, device="cuda")
            args = (x, packed, sw)
            shape = f"m={m} {k}->{n}"
            err = _equal("w4a8_gemv_fq", shape,
                         int4.mmult_w4a8_fused_noc(*args),
                         int4.mmult_w4a8_fused_noc_ref(*args))
            b = bound_ms(nbytes(*args) + 4 * m * n, 2.0 * m * n * k,
                         PEAK_INT8_OPS)
            results.append(timed("w4a8_gemv_fq", shape,
                                 lambda: int4.mmult_w4a8_fused_noc(*args),
                                 lambda: int4.mmult_w4a8_fused_noc_ref(
                                     *args), None, *b, err))
            if len(results) == 1:
                print(f"w4a8_gemv_fq {shape}: {results[0]['ms']:.4f} ms in "
                      f"one launch; {BEFORE_MS['w4a8_gemv_fq']} ms before "
                      "the rebuild (a quantize pass, then the GEMV)")
    return results[0]


def check_kv_update(gen: torch.Generator) -> dict:
    """Kernel 4 on one layer's 7B cache, one token per slot, for each row
    kind the serve paths write: the bf16 cache (B, T, KVH, D), and the KV8
    cache's int8 values (B, T, KVH, D) and fp32 scales (B, T, KVH), both
    made by ``llama.quantize_kv``. Slot 2's row lies past T (dropped),
    slot 3 is masked (kept). The JSON line reports the bf16 cache."""
    b, t = SLOTS, CFG_7B.max_seq
    heads = (CFG_7B.n_kv_heads, CFG_7B.d_head)
    pos = torch.tensor([5, 300, t, 1000], dtype=torch.int32, device="cuda")
    mask = torch.tensor([1, 1, 1, 0], dtype=torch.int32, device="cuda")
    written = [i for i in range(b) if mask[i] and 0 <= pos[i] < t]
    rows_b = torch.tensor(written, device="cuda")
    rows_t = pos[rows_b].long()

    def rows(s: int) -> torch.Tensor:
        return torch.randn((b, s, *heads), generator=gen, device="cuda")

    q_cache, s_cache = llama.quantize_kv(rows(t))
    q_new, s_new = llama.quantize_kv(rows(1))
    results = []
    for label, cache, new in (("bf16", rows(t).to(torch.bfloat16),
                               rows(1).to(torch.bfloat16)),
                              ("int8", q_cache, q_new),
                              ("fp32 scales", s_cache, s_new)):
        got, ref = cache.clone(), cache.clone()
        shape = f"cache {tuple(cache.shape)} {label}"
        err = _equal("kv_update", shape,
                     kv_update.kv_update(got, new, pos, mask),
                     kv_update.kv_update_ref(ref, new, pos, mask))
        vals = new[rows_b, 0]
        b_ms = bound_ms(2 * nbytes(vals) + nbytes(pos, mask), 0.0,
                        PEAK_INT8_OPS)
        results.append(timed(
            "kv_update", shape,
            lambda: kv_update.kv_update(got, new, pos, mask),
            lambda: kv_update.kv_update_ref(ref, new, pos, mask),
            lambda: got.index_put_((rows_b, rows_t), vals), *b_ms, err))
    return results[0]


def check_decode_attention(gen: torch.Generator) -> dict:
    """Kernel 5 over a 7B-width cache (kvh 32, d 128) and a GQA width
    (kvh 8, rep 4), slots at lengths 1, 300, 1000 and 4096."""
    t, d = CFG_7B.max_seq, CFG_7B.d_head
    lens = [1, 300, 1000, t]
    results = []
    for kvh, rep in ((32, 1), (8, 4)):
        h = kvh * rep
        q = torch.randn((len(lens), h, d), generator=gen, device="cuda")
        k, v = (torch.randn((len(lens), t, kvh, d), generator=gen,
                            device="cuda").to(torch.bfloat16)
                for _ in range(2))
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        shape = f"kvh={kvh} rep={rep} d={d} T={t} lengths {lens}"
        out = decode_attention.decode_attention(q, k, v, lengths)
        ref = decode_attention.decode_attention_ref(q, k, v, lengths)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if not err < DECODE_ATOL:
            raise AssertionError(f"decode_attention {shape}: differs from "
                                 f"its plain version by {err}")
        # library: one SDPA call over the whole cache with a length mask
        qb = q.to(torch.bfloat16)[:, :, None]
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        mask = (torch.arange(t, device="cuda")[None, :]
                < lengths[:, None])[:, None, None]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        live = sum(lens)
        b_ms = bound_ms(nbytes(q, lengths) + 4 * q.numel()
                        + 2 * live * kvh * d * k.element_size(),
                        4.0 * h * d * live, PEAK_BF16_FLOPS)
        results.append(timed(
            "decode_attention", shape,
            lambda: decode_attention.decode_attention(q, k, v, lengths),
            lambda: decode_attention.decode_attention_ref(q, k, v, lengths),
            lambda: sdpa(qb, kt, vt, attn_mask=mask, enable_gqa=True),
            *b_ms, err))
    return results[0]


def check_int8_noc(gen: torch.Generator) -> dict:
    """int8_gemm_noc at the int8 path's prefill widths (M = 4 slots x a
    256-token bucket) and at a ragged shape; the library call is
    torch._int_mm plus the same epilogue (none at the ragged shape:
    torch._int_mm takes K and N multiples of 8 only)."""
    results = []
    for m, k, n in ((SLOTS * 256, 4096, 11008), (SLOTS * 256, 11008, 4096),
                    (1000, 1100, 1032)):
        x = torch.randn((m, k), generator=gen, device="cuda")
        w = torch.randn((k, n), generator=gen, device="cuda")
        qa, sa, qb, sb = int8.prepare(x, w)
        args = (qa, sa, qb, sb)
        shape = f"M={m} {k}->{n}"
        err = _equal("int8_gemm_noc", shape, int8.mmult_q_noc(*args),
                     int8.mmult_q_noc_ref(*args))
        b = bound_ms(nbytes(*args) + 4 * m * n, 2.0 * m * n * k,
                     PEAK_INT8_OPS)
        results.append(timed(
            "int8_gemm_noc", shape, lambda: int8.mmult_q_noc(*args),
            lambda: int8.mmult_q_noc_ref(*args),
            (lambda: torch._int_mm(qa, qb).to(torch.float32) * sa * sb)
            if k % 8 == 0 and n % 8 == 0 else None, *b, err))
        if len(results) == 1:
            print(f"int8_gemm_noc {shape}: {results[0]['ms']:.4f} ms on "
                  f"int8 wgmma; {BEFORE_MS['int8_gemm_noc']} ms before the "
                  "rebuild (mma.sync)")
    return results[0]


def _close(name: str, shape: str, out, ref) -> float:
    """max |out - ref|; raises beyond W4A16_REL x max |ref|."""
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    print(f"{name} {shape}: max|kernel - plain| = {err:.3e} = "
          f"{err / scale:.3e} of max|y|")
    if not err <= W4A16_REL * scale:
        raise AssertionError(f"{name} {shape}: differs from its plain "
                             f"version by {err} > {W4A16_REL} x {scale}")
    return err


def _w4a16_args(gen, m, k, n):
    a = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((k, n), generator=gen, device="cuda")
    _, _, packed, sw, _ = int4.prepare_w4a8(w[:1], w)
    return a, packed, sw


def check_w4a16(name: str, shapes, gen: torch.Generator) -> dict:
    """A W4A16 kernel (the GEMM at m > 64, the GEMV at m <= 64) at the
    int4 path's shapes and a ragged one, within W4A16_REL of its plain
    version; a second call must give the first one's bits. The GEMV is
    also captured in a CUDA graph and replayed on new rows, which must
    give an eager call's bits. No single PyTorch call decodes int4, so the
    library time is null."""
    results = []
    for m, k, n in shapes:
        args = _w4a16_args(gen, m, k, n)
        shape = f"m={m} {k}->{n}"
        out = int4.mmult_q_noc(*args)
        err = _close(name, shape, out, int4.mmult_q_noc_ref(*args))
        if not torch.equal(out, int4.mmult_q_noc(*args)):
            raise AssertionError(f"{name} {shape}: a second call differs")
        b = bound_ms(nbytes(*args) + 4 * m * n, 2.0 * m * n * k,
                     PEAK_BF16_FLOPS)
        results.append(timed(name, shape, lambda: int4.mmult_q_noc(*args),
                             lambda: int4.mmult_q_noc_ref(*args), None,
                             *b, err))
        if len(results) == 1:
            print(f"{name} {shape}: {results[0]['ms']:.4f} ms; "
                  f"{BEFORE_MS[name]} ms before the rebuild on the tensor "
                  "cores")
        if name == "w4a16_gemv" and len(results) == 1:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                replayed = int4.mmult_q_noc(*args)
            args[0].copy_(torch.randn(args[0].shape, generator=gen,
                                      device="cuda"))
            graph.replay()
            if not torch.equal(replayed, int4.mmult_q_noc(*args)):
                raise AssertionError(f"{name} {shape}: a graph replay "
                                     "differs from an eager call")
            _close(name, f"{shape} (graph replay)", replayed,
                   int4.mmult_q_noc_ref(*args))
    return results[0]


def check_decode_attention_q8(gen: torch.Generator) -> dict:
    """decode_attention_q8 over a 7B-width KV8 cache (kvh 32, d 128), a
    GQA width (kvh 8, rep 4) and a ragged one (kvh 3, rep 2, d 64,
    T = 1000, one chunk of 1000), slots of ragged lengths, on the split
    walk; at the 7B width also from a CUDA graph captured once and
    replayed at two other sets of lengths, each replay bit-equal to an
    eager call and within DECODE_ATOL of the plain version, the
    workspace's counters at 0. No single PyTorch call attends over an int8
    cache with per-(token, head) scales, so the library time is null."""
    t7 = CFG_7B.max_seq
    results = []
    for kvh, rep, d, t, lens in ((32, 1, 128, t7, [1, 300, 1000, t7]),
                                 (8, 4, 128, t7, [1, 300, 1000, t7]),
                                 (3, 2, 64, 1000, [1, 999, 1000, 517])):
        h = kvh * rep
        q = torch.randn((len(lens), h, d), generator=gen, device="cuda")
        cache = []
        for _ in range(2):
            cache += llama.quantize_kv(torch.randn(
                (len(lens), t, kvh, d), generator=gen, device="cuda"))
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        shape = f"kvh={kvh} rep={rep} d={d} T={t} lengths {lens}"

        def call():
            return decode_attention.decode_attention_q8(q, *cache, lengths)

        def check(out, what):
            ref = decode_attention.decode_attention_q8_ref(q, *cache,
                                                           lengths)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            if not (err < DECODE_ATOL and torch.isfinite(out).all()):
                raise AssertionError(f"decode_attention_q8 {shape}{what}: "
                                     f"differs from its plain version by "
                                     f"{err}")
            if decode_attention._WORKSPACE[out.device][0].any():
                raise AssertionError(f"decode_attention_q8 {shape}{what}: "
                                     "counters left non-zero")
            return err
        err = check(call(), "")
        live = sum(lens)
        b_ms = bound_ms(nbytes(q, lengths) + 4 * q.numel()
                        + 2 * live * kvh * (d + 4),
                        4.0 * h * d * live, PEAK_BF16_FLOPS)
        results.append(timed("decode_attention_q8", shape, call,
                             lambda: decode_attention.decode_attention_q8_ref(
                                 q, *cache, lengths),
                             None, *b_ms, err))
        if len(results) > 1:
            continue
        print(f"decode_attention_q8 {shape}: {results[0]['ms']:.4f} ms on "
              f"the split walk; {BEFORE_MS['decode_attention_q8']} ms "
              "before (the one-block walk)")
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = call()
        for other in ([0, 256, 257, t7 - 1], [t7, 1, 0, 768]):
            lengths.copy_(torch.tensor(other, dtype=torch.int32))
            graph.replay()
            torch.cuda.synchronize()
            if not torch.equal(replayed, call()):
                raise AssertionError(f"decode_attention_q8 {shape}: the "
                                     f"replay at {other} differs from an "
                                     "eager call")
            e = check(replayed, f" (replayed at {other})")
            print(f"decode_attention_q8 graph replay at lengths {other}: "
                  f"max|kernel - plain| = {e}")
        lengths.copy_(torch.tensor(lens, dtype=torch.int32))
    return results[0]


def _shuffled_table(lens, ps: int, np_max: int, seed: int):
    """(NP, a (slots, np_max) int32 block table on the card): pages
    1 .. NP-1 handed out in a random order, chunks past a slot's length
    0 (unallocated)."""
    rng = np.random.default_rng(seed)
    n_pages = len(lens) * np_max + 1
    free = list(rng.permutation(np.arange(1, n_pages)))
    table = np.zeros((len(lens), np_max), np.int32)
    for b, n in enumerate(lens):
        for c in range(-(-n // ps)):
            table[b, c] = free.pop()
    return n_pages, torch.from_numpy(table).to("cuda")


def check_paged_kv_update(gen: torch.Generator) -> dict:
    """paged_kv_update, one token per slot, into one layer's 7B pools as
    the paged serve paths make them: bf16 (129, 128, 32, 128), and KV8
    int8 values (45, 384, 32, 128) and fp32 scales (45, 384, 32). Slot 1's
    row is on the trash page (skipped), slot 3 is masked (kept). The JSON
    line reports the bf16 pool; the library call is ``index_put_`` of the
    written rows."""
    heads = (CFG_7B.n_kv_heads, CFG_7B.d_head)
    mask = torch.tensor([1, 1, 1, 0], dtype=torch.int32, device="cuda")
    written = torch.tensor([0, 2], device="cuda")
    results = []
    for label, ps in (("bf16", 128), ("int8", 384), ("fp32 scales", 384)):
        n_pages = SLOTS * -(-CFG_7B.max_seq // ps) + 1
        pool = torch.randn((n_pages, ps, *heads), generator=gen,
                           device="cuda")
        new = torch.randn((SLOTS, 1, *heads), generator=gen, device="cuda")
        if label == "bf16":
            pool, new = pool.to(torch.bfloat16), new.to(torch.bfloat16)
        else:
            (pool, spool), (new, snew) = (llama.quantize_kv(pool),
                                          llama.quantize_kv(new))
            if label == "fp32 scales":
                pool, new = spool, snew
        pages = torch.tensor([[7], [0], [n_pages - 1], [3]],
                             dtype=torch.int32, device="cuda")
        offs = torch.tensor([[5], [9], [ps - 1], [0]], dtype=torch.int32,
                            device="cuda")
        got, ref = pool.clone(), pool.clone()
        shape = f"pool {tuple(pool.shape)} {label}"
        err = _equal("paged_kv_update", shape,
                     kv_update.paged_kv_update(got, new, pages, offs, mask),
                     kv_update.paged_kv_update_ref(ref, new, pages, offs,
                                                   mask))
        if not torch.equal(got[0], pool[0]):
            raise AssertionError(f"paged_kv_update {shape}: wrote page 0")
        vals = new[written, 0]
        idx = (pages[written, 0].long(), offs[written, 0].long())
        b_ms = bound_ms(2 * nbytes(vals) + nbytes(pages, offs, mask), 0.0,
                        PEAK_INT8_OPS)
        results.append(timed(
            "paged_kv_update", shape,
            lambda: kv_update.paged_kv_update(got, new, pages, offs, mask),
            lambda: kv_update.paged_kv_update_ref(ref, new, pages, offs,
                                                  mask),
            lambda: got.index_put_(idx, vals), *b_ms, err))
    return results[0]


def check_paged_attention(gen: torch.Generator, q8: bool) -> dict:
    """A paged attention kernel at the 7B width (4 slots, 32 heads of
    128, lengths 1, 300, 1000 and 4096) over a shuffled block table of
    128-token bf16 pages or 384-token KV8 pages (np_max * PS = 4,224 >
    max_seq), and at a ragged shape (kvh 3, rep 2, d 32, pages of 96).
    The contiguous kernel on the same logical cache (the pages gathered
    and cut to max_seq, as the contiguous engine holds it) is timed
    beside it. Both kernels walk each slot in splits of whole pages (two
    pages of 128, one of 384) and must leave their workspace's counters
    at 0. No single PyTorch call reads through a block table, so the
    library time is null."""
    name = "paged_decode_attention_q8" if q8 else "paged_decode_attention"
    kernel = getattr(paged_attention, name)
    plain = getattr(paged_attention, name + "_ref")
    contiguous = (decode_attention.decode_attention_q8 if q8
                  else decode_attention.decode_attention)
    t7 = CFG_7B.max_seq
    results = []
    for kvh, rep, d, ps, t, lens in (
            (32, 1, 128, 384 if q8 else 128, t7, [1, 300, 1000, t7]),
            (3, 2, 32, 96, 1000, [1, 999, 1000, 517])):
        np_max = -(-t // ps)
        n_pages, table = _shuffled_table(lens, ps, np_max, ps + kvh)
        q = torch.randn((len(lens), kvh * rep, d), generator=gen,
                        device="cuda")
        pools = []
        for _ in "kv":
            x = torch.randn((n_pages, ps, kvh, d), generator=gen,
                            device="cuda")
            pools += (list(llama.quantize_kv(x)) if q8
                      else [x.to(torch.bfloat16)])
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        shape = (f"kvh={kvh} rep={rep} d={d} page={ps} np_max={np_max} "
                 f"lengths {lens}")
        out = kernel(q, *pools, table, lengths)
        ref = plain(q, *pools, table, lengths)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if not (err < DECODE_ATOL and torch.isfinite(out).all()):
            raise AssertionError(f"{name} {shape}: differs from its plain "
                                 f"version by {err}")
        if decode_attention._WORKSPACE[out.device][0].any():
            raise AssertionError(f"{name} {shape}: counters left non-zero")
        live = sum(lens)
        row = 2 * kvh * (d + 4) if q8 else 2 * kvh * d * 2
        b_ms = bound_ms(nbytes(q, lengths, table) + 4 * q.numel()
                        + live * row, 4.0 * kvh * rep * d * live,
                        PEAK_BF16_FLOPS)
        results.append(timed(name, shape,
                             lambda: kernel(q, *pools, table, lengths),
                             lambda: plain(q, *pools, table, lengths), None,
                             *b_ms, err))
        flat = [paged_attention.gather_paged(c, table)[:, :t].contiguous()
                for c in pools]
        c_ms = time_calls(lambda: contiguous(q, *flat, lengths),
                          graph=True) * 1e3
        before = (f"; {BEFORE_MS[name]} ms before the split walk"
                  if name in BEFORE_MS and len(results) == 1 else "")
        print(f"{name} {shape}: the contiguous kernel on the same cache "
              f"(T={t}) {c_ms:.4f} ms, paged {results[-1]['ms']:.4f} ms"
              f"{before}")
        if decode_attention._WORKSPACE[out.device][0].any():
            raise AssertionError(f"{name} {shape}: counters left non-zero "
                                 "by the timed calls")
    return results[0]


# (B, H, KVH, S, T, D, causal, model layout): the 7B prefill (the JSON
# row) and the same at 2,048, S-long's two buckets, as mha_flash passes
# them (transposed views of (B, S, H, D) tensors); 1,024 on contiguous
# tensors; then GQA rep 4 (the serving CLI's 16 heads over 4), D 64 with
# the queries the last 700 of 1,000 positions, not causal, and T = 9,000
# past the reference's 8,192-key strip
FLASH_SHAPES = ((4, 32, 32, 4096, 4096, 128, True, True),
                (4, 32, 32, 2048, 2048, 128, True, True),
                (4, 32, 32, 1024, 1024, 128, True, False),
                (2, 16, 4, 1000, 1000, 128, True, False),
                (1, 8, 8, 700, 1000, 64, True, False),
                (2, 8, 8, 700, 1000, 128, False, False),
                (1, 4, 4, 64, 9000, 128, False, False))


def skipped_tile_ulps(q, k, v, ref) -> float:
    """The flash check's reading on a planted fault: the plain version of
    the last 64 queries with one key tile of the kernel's (64 keys) before
    them (at T / 2) skipped, held to the true output's rows. The queries
    are the last S of T positions, so dropping the tile's keys from k and v
    leaves every other key visible to them as before."""
    bk = attention.KERNEL_BK
    t = k.shape[2]
    j0 = t // 2 // bk * bk
    keep = torch.cat([torch.arange(j0, device=k.device),
                      torch.arange(j0 + bk, t, device=k.device)])
    faulty = attention.flash_attention_ref(
        q[:, :, -bk:], k[:, :, keep], v[:, :, keep], causal=True, bk=bk)
    return float(attention.bf16_row_ulps(faulty, ref[:, :, -bk:]).max())


def check_flash_attention(gen: torch.Generator) -> dict:
    """flash_attention against its plain version at the kernel's key
    tiles (every row within FLASH_ULPS bf16 ulps of its max |plain|); on
    each causal shape the same rule must refuse the plain version with one
    key tile skipped. The bound counts the query-key pairs this run's
    shape visits; the library call is SDPA on the same (B, H, S, D)
    tensors where it computes the same function (S = T, or not causal:
    its causal mask is aligned to the first query, not the last)."""
    results = []
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def make(b, heads, n, d, model_layout):
        x = torch.randn((b, n, heads, d), generator=gen, device="cuda").to(
            torch.bfloat16).transpose(1, 2)
        return x if model_layout else x.contiguous()
    for b, h, kvh, s, t, d, causal, model_layout in FLASH_SHAPES:
        q = make(b, h, s, d, model_layout)
        k, v = (make(b, kvh, t, d, model_layout) for _ in "kv")
        shape = (f"B={b} H={h} KVH={kvh} S={s} T={t} D={d} causal={causal}"
                 f"{' (B, S, H, D) views' if model_layout else ''}")

        def kernel():
            return attention.flash_attention(q, k, v, causal=causal)

        def plain():
            return attention.flash_attention_ref(
                q, k, v, causal=causal, bk=attention.KERNEL_BK)
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        if out.stride() != q.stride():
            raise AssertionError(f"flash_attention {shape}: out strides "
                                 f"{out.stride()}, q's {q.stride()}")
        err = float((out.float() - ref.float()).abs().max())
        ulps = float(attention.bf16_row_ulps(out, ref).max())
        fault = skipped_tile_ulps(q, k, v, ref) if causal else math.inf
        print(f"flash_attention {shape}: max|kernel - plain| = {err:.3e}, "
              f"{ulps:.3f} bf16 ulps of its row's max |plain| (bound "
              f"{FLASH_ULPS}); one key tile skipped reads {fault:.3f}")
        if not (ulps <= FLASH_ULPS and torch.isfinite(out).all()):
            raise AssertionError(f"flash_attention {shape}: differs from "
                                 f"its plain version by {ulps} ulps")
        if not fault > FLASH_ULPS:
            raise AssertionError(f"flash_attention {shape}: the check "
                                 f"passes a skipped key tile ({fault})")
        pairs = s * (t - s) + s * (s + 1) // 2 if causal else s * t
        b_ms = bound_ms(nbytes(q, q, k, v), 4.0 * b * h * d * pairs,
                        PEAK_BF16_FLOPS)
        library = None
        if s == t or not causal:
            def library():
                return sdpa(q, k, v, is_causal=causal, enable_gqa=h != kvh)
        results.append(timed("flash_attention", shape, kernel, plain,
                             library, *b_ms, err))
        if len(results) == 1:
            print(f"flash_attention {shape}: {results[0]['ms']:.4f} ms, "
                  f"{BEFORE_MS['flash_attention']} ms before the "
                  "rebuild on wgmma")
    return results[0]


SERVE_CHECKS = {"w4a8_gemm_noc": check_w4a8_noc,
                "w4a8_gemv_fq": check_w4a8_gemv,
                "kv_update": check_kv_update,
                "decode_attention": check_decode_attention,
                "int8_gemm_noc": check_int8_noc,
                # (m, k, n): the int4 path's prefill and decode widths
                # and a ragged shape each
                "w4a16_gemm_noc": lambda gen: check_w4a16(
                    "w4a16_gemm_noc", ((SLOTS * 256, 4096, 11008),
                                       (SLOTS * 256, 11008, 4096),
                                       (1000, 1100, 1032)), gen),
                "w4a16_gemv": lambda gen: check_w4a16(
                    "w4a16_gemv", ((SLOTS, 4096, 11008), (SLOTS, 4096, 4096),
                                   (SLOTS, 11008, 4096), (1, 4096, 11008),
                                   (16, 4096, 11008), (64, 4096, 11008),
                                   (5, 1100, 1032)), gen),
                "decode_attention_q8": check_decode_attention_q8,
                "paged_kv_update": check_paged_kv_update,
                "paged_decode_attention": lambda gen: check_paged_attention(
                    gen, q8=False),
                "paged_decode_attention_q8":
                    lambda gen: check_paged_attention(gen, q8=True),
                "flash_attention": check_flash_attention}


def paged_requests(path: str, page: int):
    """The paged paths' requests and pool: S-paged, a shared 128-token
    prefix and 16-128 more random tokens (numpy seed 0), the default pool;
    S-paged-kv8, 300-700 random tokens and a pool of just the pages the
    first four prompts hold at admission (plus the trash page), checked
    to make a slot grow into a dry pool during its 32 decode tokens."""
    if path == "S-paged":
        rng = np.random.default_rng(0)
        shared = rng.integers(1, 30000, 128).tolist()
        tails = rng.integers(16, 129, 8)
        return [serving.Request(uid=i, prompt=shared + rng.integers(
            1, 30000, int(n)).tolist(), max_new=32)
            for i, n in enumerate(tails)], None
    reqs = serving.make_requests(8, 300, 32, seed=PAGED_KV8_SEED,
                                 prompt_len_max=700)
    lens = [len(r.prompt) for r in reqs[:SLOTS]]
    held = [-(-n // page) for n in lens]
    if not any(-(-(n + 32) // page) > h for n, h in zip(lens, held)):
        raise AssertionError(f"{path}: no prompt of {lens} grows a page "
                             "in decode, so nothing would be preempted")
    return reqs, 1 + sum(held)


def serve_path(gen: torch.Generator, path: str) -> dict:
    """One serving path, launch counts set to 0 just before it and read
    just after; then one decode step's time at the same width."""
    kind, cache_kind, kernels, paged = SERVE_PATHS[path]
    cfg = dataclasses.replace(CFG_7B, weight_kind=kind)
    params = llama.init_params(gen, cfg, "cuda")
    cache_pages = None
    if paged:
        page = paged_attention.good_page_size(
            cfg.n_kv_heads, cfg.d_head, 1 if cache_kind == "int8" else 2)
        reqs, cache_pages = paged_requests(path, page)
    elif path == "S-long":
        reqs = serving.make_requests(8, 512, 32, seed=LONG_SEED,
                                     prompt_len_max=3500)
    else:
        reqs = serving.make_requests(8, 32, 32, seed=0, prompt_len_max=256)
    eng = serving.ServingEngine(cfg, params, batch_slots=SLOTS,
                                cache_kind=cache_kind, device="cuda",
                                cache_pages=cache_pages, **paged)
    # count preemptions without touching the engine: wrap its method
    preempted = []
    preempt = eng._preempt_newest

    def counting(protect, queue):
        ok = preempt(protect, queue)
        preempted.append(ok)
        return ok
    eng._preempt_newest = counting
    # record every prefill dispatch (s > 1): its shape, and whether it is
    # causal self-attention over the prompt (prefill_self)
    dispatches = []
    step = eng.step

    def recording(tokens, pos, **kw):
        if tokens.shape[1] > 1:
            dispatches.append((*tokens.shape, kw.get("prefill_self", False)))
        return step(tokens, pos, **kw)
    eng.step = recording
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    eng.run(reqs, window=8)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    del eng._preempt_newest, eng.step    # the wrappers refer to the engine
    launches = dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats = serving.summarize(reqs, seconds)
    short = [r.uid for r in reqs if len(r.out) != 32 or not r.done]
    if short:
        raise AssertionError(f"{path}: requests {short} did not get 32 "
                             "tokens")
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"{path} never launched {missing}")
    attn = kernels[-1]
    steps = launches[attn] // cfg.n_layers
    print(f"{path}: prompts {[len(r.prompt) for r in reqs]}, prefill "
          f"dispatches {dispatches}, peak {peak_gb:.2f} GB")
    # causal self-attention of 512 tokens or more takes the flash kernel,
    # once a layer, in every such dispatch
    flash = sum(1 for _, n, self_attn in dispatches
                if self_attn and n >= llama.FLASH_MIN_S)
    if launches["flash_attention"] != flash * cfg.n_layers:
        raise AssertionError(f"{path}: {launches['flash_attention']} flash "
                             f"launches for {flash} long dispatches")
    if path == "S-long" and (not flash or flash != len(dispatches)):
        raise AssertionError(f"{path}: dispatches {dispatches} are not all "
                             "long admissions")
    if paged:
        print(f"{path}: pool {eng.n_pages - 1} pages x {eng.page} tokens "
              f"(+ trash page), prefix hits {eng.prefix_hit_tokens} tokens, "
              f"{sum(preempted)} preemptions")
        if paged.get("prefix_cache") and not eng.prefix_hit_tokens > 0:
            raise AssertionError(f"{path}: no prefix-cache hit")
        if cache_pages is not None and not any(preempted):
            raise AssertionError(f"{path}: no slot was preempted")
    print(f"{path}: {stats['tokens']} tokens in {seconds:.3f} s = "
          f"{stats['tok_per_s']:.1f} tok/s; TTFT p50 "
          f"{stats['ttft_p50_ms']:.1f} ms max {stats['ttft_max_ms']:.1f} "
          f"ms; decode-only {stats['decode_tok_per_s']:.1f} tok/s")
    per_step = ", ".join(f"{launches[k] / max(steps, 1):.1f} {k}"
                         for k in kernels)
    print(f"{path}: launches {launches}; {steps} decode steps; per step "
          f"{per_step}")
    # one decode step of 4 slots at position 512, timed alone; a paged
    # engine reads through a table of the pool's pages, taken in turn
    tok = torch.ones((SLOTS, 1), dtype=torch.int32, device="cuda")
    pos = torch.full((SLOTS,), 512, dtype=torch.int32, device="cuda")
    kw = {}
    if paged:
        kw["table"] = (1 + torch.arange(SLOTS * eng.np_max, device="cuda")
                       % (eng.n_pages - 1)).to(torch.int32).reshape(
                           SLOTS, eng.np_max)
    step_ms = time_calls(lambda: eng.step(tok, pos, **kw), inner_iters=4,
                         outer_repeats=2, warmup=1) * 1e3
    step_prof = profiling.call_profile(lambda: eng.step(tok, pos, **kw))
    weight_bytes = sum(nbytes(t) for layer in params["layers"]
                       for lin in layer.values() if isinstance(lin, dict)
                       for t in lin.values())
    weight_bytes += nbytes(params["lm_head"]["fp32_w"])
    print(f"{path}: decode step {step_ms:.3f} ms at 4 slots, position 512 "
          f"(weights {weight_bytes / 1e9:.3f} GB: bound "
          f"{1e3 * weight_bytes / PEAK_BYTES:.3f} ms); on the device "
          f"{step_prof.device_ms:.3f} ms in {len(step_prof.kernels)} "
          "kernels (one profiled step)")
    if path == "S-w4a8":
        # each shape of a layer's linears: one kernel, its host operations
        shapes = {}
        for name, lin in params["layers"][0].items():
            if isinstance(lin, dict) and "w4a8_packed" in lin:
                shapes.setdefault(tuple(lin["w4a8_packed"].shape), name)
        for name in shapes.values():
            lin = params["layers"][0][name]
            x = torch.randn((SLOTS, lin["w4a8_packed"].shape[0] * 2),
                            generator=gen, device="cuda")
            gemv_host_ops(
                f"{path}: w4a8_gemv_fq m={SLOTS} on layer 0's {name} "
                f"{x.shape[1]}->{lin['w4a8_sw'].shape[1]}",
                lambda: int4.mmult_w4a8_fused_noc(x, lin["w4a8_packed"],
                                                  lin["w4a8_sw"]))
    stats.update(step_ms=step_ms, step_device_ms=step_prof.device_ms,
                 steps=steps, peak_gb=peak_gb)
    if paged:
        stats.update(prefix_hit_tokens=eng.prefix_hit_tokens,
                     preemptions=sum(preempted))
    print(json.dumps({"serve": path, "weights": kind, "cache": cache_kind,
                      **stats, "launches": launches}))
    del eng, params
    torch.cuda.empty_cache()
    return launches


def teacher_forced(eng, prompts, forced) -> torch.Tensor:
    """Logits of the engine's admission prefill of ``prompts`` (one per
    slot) and of decode steps fed ``forced`` (slots, steps) tokens ->
    (1 + steps, slots, vocab) on the CPU. A paged engine first gives each
    slot the pages of all its positions."""
    reqs = [serving.Request(uid=i, prompt=p, max_new=1)
            for i, p in enumerate(prompts)]
    if eng.paged:
        for s, p in enumerate(prompts):
            if not eng.alloc.grow(s, len(p) + forced.shape[1]):
                raise AssertionError("parity: the pool is too small")
    table = eng._table()
    kw = {} if table is None else {"table": table}
    first = eng._dispatch_prefill([(s, r, 0) for s, r in enumerate(reqs)],
                                  table)
    rows = [torch.cat([first[s] for s in range(len(prompts))])]
    pos = np.array([len(p) for p in prompts], np.int32)
    for j in range(forced.shape[1]):
        logits = eng.step(eng._tensor(forced[:, j:j + 1]), eng._tensor(pos),
                          **kw)
        rows.append(logits[:, -1])
        pos = pos + 1
    return torch.stack(rows).float().cpu()


# 2 slots x a 128-token bucket: the admission prefill runs at
# m = 256 = INT8_KERNEL_MIN_M, so it takes the prefill kernels
PARITY_PROMPTS = (100, 128)
# 2 slots x a 512-token bucket: the admission's attention takes flash
LONG_PARITY_PROMPTS = (400, 512)
# (label, weight kind, cache kind, kernels the card side must launch, the
# engine's paged options, prompt lengths) of each parity run
PARITY = (("fp32", "fp32", "bf16", ["kv_update", "decode_attention"], {},
           PARITY_PROMPTS),
          *((kind if cache_kind == "bf16" else f"{kind}+kv8", kind,
             cache_kind, kernels, paged, PARITY_PROMPTS)
            for kind, cache_kind, kernels, paged in (
                SERVE_PATHS[path] for path in ("S-w4a8", "S-int8", "S-int4",
                                               "S-kv8"))),
          ("w4a8 paged", "w4a8", "bf16",
           W4A8_PAGED + ["paged_decode_attention"], dict(paged=True),
           PARITY_PROMPTS),
          ("w4a8+kv8 paged", "w4a8", "int8",
           W4A8_PAGED + ["paged_decode_attention_q8"], dict(paged=True),
           PARITY_PROMPTS),
          ("w4a8 long", *SERVE_PATHS["S-long"], LONG_PARITY_PROMPTS))


@contextlib.contextmanager
def recorded_routes(calls: list):
    """Append every router call's logits, as (rows, E) fp32 on the CPU, to
    ``calls`` while active (``moe._router_logits`` serves the dispatch and
    the ragged paths alike)."""
    real = moe._router_logits

    def record(params, x):
        logits = real(params, x)
        calls.append(logits.reshape(-1, logits.shape[-1]).float().cpu())
        return logits
    moe._router_logits = record
    try:
        yield calls
    finally:
        moe._router_logits = real


def flipped_positions(label: str, routes: dict, lens, k: int,
                      n_layers: int) -> set:
    """The teacher-forced positions (step, slot) whose token some side
    routes to other top-k experts than the CPU does, in any layer; each
    such token must be a near-tie on the CPU side (its k-th and (k+1)-th
    router probabilities within PARITY_TIE), else this raises. Router
    calls come a layer at a time: the admission prefill (rows slot x
    bucket), then each decode step (one row a slot)."""
    slots = len(lens)
    ref_calls = routes["cpu"]
    bucket = ref_calls[0].shape[0] // slots
    flipped = set()
    for side, calls in routes.items():
        if side == "cpu":
            continue
        for c, (got, ref) in enumerate(zip(calls, ref_calls)):
            step = c // n_layers
            for slot in range(slots):
                row = (slot * bucket + lens[slot] - 1) if step == 0 else slot
                p_ref = torch.softmax(ref[row], -1)
                top = torch.topk(p_ref, k + 1).values
                if set(torch.topk(got[row], k).indices.tolist()) == set(
                        torch.topk(ref[row], k).indices.tolist()):
                    continue
                gap = float(top[k - 1] - top[k])
                print(f"parity {label}: {side} routes step {step} slot {slot}"
                      f" layer {c % n_layers} otherwise; the CPU's top-{k} "
                      f"gap {gap:.3e}")
                if gap > PARITY_TIE:
                    raise AssertionError(f"parity {label}: {side} routes a "
                                         f"token otherwise at a gap of {gap}")
                flipped.add((step, slot))
    return flipped


@contextlib.contextmanager
def kernel_tiles():
    """The plain flash versions walk the forward kernels' key tiles
    (``attention.KERNEL_BK``, ``attention.KERNEL_BK_LSE``) instead of the
    reference's 512-key blocks (serving) or training blocks, so the CPU
    side's online softmax
    rounds p to bf16 against the same running maxima as the card's. At
    512-key blocks those roundings move a prefill's MLP input by ~1% where
    they differ, which a routed model turns into expert choices of its own
    at near-ties (PERF.md, section 6)."""
    default, train = attention.default_block, attention.train_block
    attention.default_block = lambda t: attention.KERNEL_BK
    attention.train_block = lambda t: attention.KERNEL_BK_LSE
    try:
        yield
    finally:
        attention.default_block, attention.train_block = default, train


@contextlib.contextmanager
def cached_weights(cache: dict):
    """While active, the plain versions' weight conversions are taken once
    and kept in ``cache``: ``quant.unpack_int4`` (the int4 and W4A8
    linears' plain versions, the packed expert stacks),
    ``int8._weight_f64`` (the fp64 weight of the int8 and W4A8 plain
    products), ``grouped_gemm._expert_weight`` (the ragged path's plain
    version) and ``moe._stack_as`` (the dispatch path's fp32 copy of a
    quantized stack, every decode step otherwise). Each is a pure function
    of a weight and a few numbers; a result is keyed by its arguments, a
    tensor by its storage, shape, strides and version (an in-place update,
    an optimizer step's, makes a new key), a dict by identity, and the
    cache holds the arguments, so no key is reused while it lives. The CPU
    sides of a parity row share one cache: the same arithmetic, each
    weight converted once."""
    targets = [(quant, "unpack_int4"), (int8, "_weight_f64"),
               (grouped_gemm, "_expert_weight"), (moe, "_stack_as")]
    saved = [getattr(mod, name) for mod, name in targets]

    def part(a):
        if isinstance(a, torch.Tensor):
            return (a.data_ptr(), tuple(a.shape), a.stride(), a.dtype,
                    a._version)
        return id(a) if isinstance(a, dict) else a

    def memo(fn):
        def cached(*args):
            key = (fn,) + tuple(part(a) for a in args)
            if key not in cache:
                cache[key] = (args, fn(*args))
            return cache[key][1]
        return cached
    for (mod, name), fn in zip(targets, saved):
        setattr(mod, name, memo(fn))
    try:
        yield
    finally:
        for (mod, name), fn in zip(targets, saved):
            setattr(mod, name, fn)


def parity(gen: torch.Generator) -> None:
    """The engine at 7B width (``PARITY``) and at Mixtral-8x7B width with
    ``moe_ragged`` (``MOE_PARITY``), 2 layers, on the card and on the CPU,
    on the same weights and tokens; the card side runs with every launch
    count set to 0 just before it and must launch each kernel of its
    row."""
    rows = ([(row, CFG_7B, 8) for row in PARITY]
            + [(row, dataclasses.replace(MOE_CFG, moe_ragged=True),
                MOE_FORCED) for row in MOE_PARITY])
    for (label, kind, cache_kind, kernels, paged, lens), base, steps in rows:
        t0 = time.perf_counter()
        rng = np.random.default_rng(0)
        prompts = [rng.integers(1, 30000, n).tolist() for n in lens]
        forced = rng.integers(1, 30000, (2, steps)).astype(np.int32)
        cfg = dataclasses.replace(base, n_layers=2, weight_kind=kind)
        params = llama.init_params(gen, cfg, "cuda")
        cpu = convert.to_device(params, "cpu")
        noise = torch.randn(cpu["embed"].shape,
                            generator=torch.Generator().manual_seed(1))
        sides = {"cuda": (params, "cuda", None),
                 "cpu": (cpu, "cpu", True),
                 "cpu perturbed": ({**cpu, "embed": cpu["embed"]
                                    * (1 + PERTURB * noise)}, "cpu", True)}
        out, router, seconds, cache = {}, {}, {}, {}
        for side, (p, dev, routes) in sides.items():
            t_side = time.perf_counter()
            eng = serving.ServingEngine(cfg, p, batch_slots=2, device=dev,
                                        cache_kind=cache_kind,
                                        kernel_routes=routes, **paged)
            _build.reset_launches()
            with kernel_tiles() if routes else contextlib.nullcontext(), \
                    cached_weights(cache) if dev == "cpu" else \
                    contextlib.nullcontext(), \
                    recorded_routes(router.setdefault(side, [])):
                out[side] = teacher_forced(eng, prompts, forced)
            seconds[side] = time.perf_counter() - t_side
            if dev == "cuda":
                missing = [k for k in kernels if _build.LAUNCHES[k] == 0]
                if missing:
                    raise AssertionError(f"parity {label}: the card side "
                                         f"never launched {missing}")
            del eng
        del cache
        # an MoE row compares the positions every side routes alike
        keep = torch.ones(out["cpu"].shape[:2], dtype=torch.bool)
        if cfg.n_experts:
            for step, slot in flipped_positions(label, router, lens,
                                                cfg.moe_top_k, cfg.n_layers):
                keep[step, slot] = False
            if int(keep.sum()) * 2 < keep.numel():
                raise AssertionError(f"parity {label}: {int((~keep).sum())} "
                                     f"of {keep.numel()} positions routed "
                                     "otherwise")
        ref = out["cpu"]
        scale = float(ref.abs().max())
        diffs = {}
        for side in out:
            if side == "cpu":
                continue
            other = out[side]
            diffs[side] = float((other - ref)[keep].abs().max())
            agree = float((other.argmax(-1) == ref.argmax(-1)).float()
                          .mean())
            print(f"parity {label}: max|{side} - cpu| = {diffs[side]:.4e} "
                  f"(max|logit| {scale:.3f}, rel "
                  f"{diffs[side] / scale:.3e}); greedy agreement "
                  f"{agree:.3f} over {ref.shape[0]} positions x "
                  f"{ref.shape[1]} prompts")
        limit = PARITY_SENSITIVITY * diffs["cpu perturbed"]
        if not (torch.isfinite(out["cuda"]).all()
                and diffs["cuda"] <= limit):
            raise AssertionError(f"parity {label}: card and CPU logits "
                                 f"differ by {diffs['cuda']} > {limit}")
        print(f"parity {label}: {time.perf_counter() - t0:.1f} s (card side "
              f"{seconds['cuda']:.1f} s, CPU sides "
              f"{sum(v for k, v in seconds.items() if k != 'cuda'):.1f} s: "
              + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()
                          if k != "cuda") + ")")
        del params, cpu
        torch.cuda.empty_cache()


# ------------------------------------------------------------------ MoE

MOE_KERNEL = dict(
    name="grouped_gemm", source=SRC + "grouped_gemm.cu",
    replaces="how_to_optimize_gemm_tpu/ops/pallas_grouped_gemm.py:71",
    function="pallas_grouped_gemm._kernel + _kernel_noscale :83 + "
             "_kernel_q4 :87 + _kernel_q4_noscale :104, the backward's "
             "unscaled recompute (_gmm_call :108, grouped_matmul)")
# The forward's and dW's pre-pass: x (and dy) split into two bf16 planes,
# EQUAL to its plain version.
SPLIT_KERNEL = dict(
    name="split_bf16", source=SRC + "split_bf16.cu",
    replaces="how_to_optimize_gemm_tpu/ops/pallas_grouped_gemm.py:71",
    function="no Pallas kernel of its own: the split of the fp32 operand "
             "that pallas_grouped_gemm._kernel :71, _kernel_t :152 and "
             "_dw_kernel :255 leave to the MXU's precision; the pre-pass of "
             "grouped_gemm, grouped_gemm_t (kinds 0-2) and grouped_dw")
# grouped_gemm vs its plain version, relative to max |plain|: bf16, int8
# and int4 stacks take x split into bf16 hi + lo (2^-17 relative a
# product) and the tensor cores' sums (the mma.sync kernel read up to
# 3.4e-5 at K = 14,336 on an H100, 1.2e-5 at 4,096); fp32 stacks FFMA
# (FP32_REL). One block reading its neighbour expert's stack reads above 1.
GROUPED_REL = 1e-4
MOE_T = 4096        # the kernel phase's tokens: Mixtral's prefill, top-2
MOE_EMPTY = 1       # the expert the kernel phase's router gives no token
                    # (not the last: the layout's spare blocks go to it)
# The MoE serve paths on mixtral_8x7b (moe_ragged), each at 32 layers: the
# weight kind and the kernels each must launch. Their 4 prompts,
# make_requests(4, 1024, 16, seed=0, 3000), are admitted in one dispatch
# at bucket 4,096, which takes the grouped GEMM (4 x 4,096 x 2 routed
# copies >= 2 x 8 x 128) 3 times a layer; decode (4 tokens) takes the
# dispatch path.
MOE_SERVE_PATHS = {
    "S-moe-int8": ("int8", 32, ["grouped_gemm", "split_bf16",
                                "int8_gemm_noc",
                                "flash_attention", "kv_update",
                                "decode_attention"]),
    "S-moe-w4a8": ("w4a8", 32, ["grouped_gemm", "split_bf16",
                                "w4a8_gemm_noc",
                                "w4a8_gemv_fq", "flash_attention",
                                "kv_update", "decode_attention"]),
}
MOE_NEW = 16
# parity at Mixtral width with 2 layers: prompts of 400 and 512 tokens, so
# the bucket-512 admission has 2 x 512 x 2 = 2,048 routed copies and takes
# the grouped GEMM; decode takes the dispatch path. MOE_FORCED decode
# steps (not 8): the CPU side converts every expert stack to fp32 a step
MOE_PARITY = tuple((f"moe {kind}", kind, "bf16", kernels, {},
                    LONG_PARITY_PROMPTS)
                   for kind, _, kernels in MOE_SERVE_PATHS.values())
MOE_FORCED = 2


def _moe_rows(gen, t: int, d: int, e: int, k: int, empty: int):
    """t tokens (t, d) routed top-k by a random router over e experts,
    expert ``empty`` masked out, laid out for the grouped GEMM: (xs, the
    block -> expert map, routed copies)."""
    x = torch.randn((t, d), generator=gen, device="cuda")
    router = torch.randn((d, e), generator=gen, device="cuda") * d ** -0.5
    logits = vendor.fp32_matmul(x, router)
    logits[:, empty] = -1e30
    choice = torch.topk(torch.softmax(logits, -1), k, dim=-1).indices
    stok, _, dest, be, tp = moe._ragged_layout(choice.t().reshape(-1), t, e,
                                               k, 128)
    if int((be == empty).sum()) != 1:
        raise AssertionError("the empty expert does not own one block")
    xs = torch.zeros((tp, d), device="cuda")
    xs[dest] = x[stok]
    return xs, be, t * k


def _grouped_stack(gen, kind: str, e: int, kdim: int, n: int):
    """(w, scales, packed4) of one stack kind, drawn in fp32."""
    w = torch.randn((e, kdim, n), generator=gen, device="cuda") * kdim ** -0.5
    if kind in ("fp32", "bf16"):
        return (w if kind == "fp32" else w.to(torch.bfloat16)), None, False
    q, s = quant.quantize_symmetric(w, axis=1, bits=8 if kind == "int8"
                                    else 4)
    del w
    if kind == "int4":
        return quant.pack_int4(q, kdim), s, True
    return q, s, False


def _forward_alone(xs, w, be, s, packed4: bool):
    """(call, out): a call that launches grouped_gemm's kernel alone into
    ``out``, on x split beforehand, so that a row reads one kernel (the
    wrapper's split is ``split_bf16``'s row)."""
    kind = grouped_gemm._stack_kind(w, packed4, s)
    a = grouped_gemm.split_bf16(xs)
    wk = grouped_gemm._stack_operand(w, kind)
    be32 = be.to(torch.int32).contiguous()
    out = torch.empty((xs.shape[0], w.shape[2]), device=xs.device)
    return (lambda: grouped_gemm._launch_forward(a, wk, be32, s, out,
                                                 xs.shape[1], 128, kind),
            out)


def _t_alone(dy, w, be, packed4: bool):
    """(call, out): grouped_gemm_t's (or _t4's) kernel alone into ``out``
    on dy split beforehand."""
    kind = grouped_gemm._stack_kind(w, packed4)
    a = grouped_gemm.split_bf16(dy)
    wk = grouped_gemm._stack_operand(w, kind)
    be32 = be.to(torch.int32).contiguous()
    out = torch.empty((dy.shape[0], w.shape[1] * (2 if packed4 else 1)),
                      device=dy.device)
    return (lambda: grouped_gemm._launch_t(a, wk, be32, out, dy.shape[1],
                                           128, kind), out)


def _dw_alone(xs, dy, be, ne: int):
    """(call, out): grouped_dw's kernel alone on x and dy split
    beforehand."""
    a, b = grouped_gemm.split_bf16(xs), grouped_gemm.split_bf16(dy)
    be32 = be.to(torch.int32).contiguous()
    out = torch.empty((ne, xs.shape[1], dy.shape[1]), device=xs.device)
    return lambda: grouped_gemm._launch_dw(a, b, be32, out, 128), out


def _same_as_wrapper(name: str, shape: str, alone, out, got) -> None:
    """The kernel alone gives the wrapper's bits."""
    alone()
    if not torch.equal(out, got):
        raise AssertionError(f"{name} {shape}: the kernel alone differs "
                             "from its wrapper")


def check_grouped_gemm(gen: torch.Generator) -> dict:
    """grouped_gemm against its plain version at Mixtral-8x7B's prefill
    (T = 4,096 tokens, top-2, Tp = 9,216; a random router, expert 1 given
    no token): w_gate/w_in (4,096 -> 14,336) and w_out (14,336 -> 4,096)
    on int8 + scale, packed int4 + scale and bf16 stacks; then f = 1,000
    (not a multiple of 128) on the same kinds and fp32 stacks at d 36, f
    130. Each within GROUPED_REL (fp32: FP32_REL) of max |plain|, and the
    same rule must refuse the plain version with block 0 reading the
    neighbouring expert. Timed at the Mixtral shapes as CUDA-graph
    replays beside the plain version and the bound: the routed rows'
    operations (not the padding's) at the bf16 peak, whatever the stack
    kind, against the bytes of x, the stack, the scales and y once; the
    bf16 instance beside ``torch._grouped_mm`` (``_grouped_mm``: x
    rounded to bf16, a bf16 output), which has no int8 or int4 form. The
    kernel is timed alone, on x split beforehand (its bits the wrapper's),
    and the wrapper with its split beside it. Returns the int8 w_gate row
    (library null)."""
    e, d, f = MOE_CFG.n_experts, MOE_CFG.d_model, MOE_CFG.d_ff
    cases = [(MOE_T, d, f, e, ("int8", "int4", "bf16"), True),
             (MOE_T, f, d, e, ("int8", "int4", "bf16"), True),
             (1000, 1024, 1000, e, ("int8", "int4", "bf16"), False),
             (100, 36, 130, 4, ("fp32",), False)]
    first, worst = None, 0.0
    for t, kdim, n, ne, kinds, timed_here in cases:
        xs, be, routed = _moe_rows(gen, t, kdim, ne, 2, MOE_EMPTY)
        for kind in kinds:
            w, s, packed4 = _grouped_stack(gen, kind, ne, kdim, n)
            shape = f"{kind} Tp={xs.shape[0]} {kdim}->{n} E={ne}"
            out = grouped_gemm.grouped_matmul(xs, w, be, s, packed4=packed4)
            ref = grouped_gemm.grouped_matmul_ref(xs, w, be, s,
                                                  packed4=packed4)
            wrong = be[:1].clone()
            wrong[0] = (wrong[0] + 1) % ne
            bad = grouped_gemm.grouped_matmul_ref(xs[:128], w, wrong, s,
                                                  packed4=packed4)
            torch.cuda.synchronize()
            scale = float(ref.abs().max())
            err = float((out - ref).abs().max())
            fault = float((out[:128] - bad).abs().max())
            tol = FP32_REL if kind == "fp32" else GROUPED_REL
            print(f"grouped_gemm {shape}: max|kernel - plain| = {err} = "
                  f"{err / scale:.3e} of max|plain| (bound {tol}); block 0 "
                  f"on its neighbour's stack reads {fault / scale:.3e}")
            if not (err <= tol * scale and fault > tol * scale):
                raise AssertionError(f"grouped_gemm {shape}: {err / scale} "
                                     f"(fault {fault / scale})")
            worst = max(worst, err)
            if timed_here:
                args = (xs, w, be, s)
                b = bound_ms(nbytes(xs, w, out) + (nbytes(s) if s is not None
                                                   else 0),
                             2.0 * routed * kdim * n, PEAK_BF16_FLOPS)
                offs = torch.cumsum(torch.bincount(be, minlength=ne) * 128,
                                    0).to(torch.int32)
                lib = (_grouped_mm(xs.to(torch.bfloat16), w, offs)
                       if kind == "bf16" else None)
                alone, y = _forward_alone(*args, packed4)
                _same_as_wrapper("grouped_gemm", shape, alone, y, out)
                r = timed("grouped_gemm", shape, alone,
                          lambda: grouped_gemm.grouped_matmul_ref(
                              *args, packed4=packed4), lib, *b, err,
                          lambda: grouped_gemm.grouped_matmul(
                              *args, packed4=packed4))
                first = first or r
                del alone, y
            del w, s, out, ref
        del xs
        torch.cuda.empty_cache()
    first["max_abs_err"] = worst
    return first


def check_split(gen: torch.Generator) -> dict:
    """split_bf16 EQUAL to its plain version on x at both of Mixtral's
    widths (Tp 9,216 x 4,096 and x 14,336, the forward's and dW's
    operands) and on ragged widths (36, 130: the planes' zero columns);
    timed at (9,216, 4,096) beside its plain version and the bound (x read
    once, both planes written once; no operations counted). No single
    PyTorch call computes the pair: library null."""
    first, worst = None, 0.0
    for rows, cols, timed_here in ((9216, MOE_CFG.d_model, True),
                                   (9216, MOE_CFG.d_ff, False),
                                   (384, 36, False), (256, 130, False)):
        x = torch.randn((rows, cols), generator=gen, device="cuda")
        shape = f"({rows}, {cols})"
        out = grouped_gemm.split_bf16(x)
        err = _equal("split_bf16", shape, out, grouped_gemm.split_bf16_ref(x))
        worst = max(worst, err)
        print(f"split_bf16 {shape}: EQUAL to its plain version")
        if timed_here:
            b = bound_ms(nbytes(x, out), 0.0, PEAK_BF16_FLOPS)
            first = timed("split_bf16", shape,
                          lambda: grouped_gemm.split_bf16(x),
                          lambda: grouped_gemm.split_bf16_ref(x), None, *b,
                          err)
        del x, out
    first["max_abs_err"] = worst
    return first


def serve_moe_path(gen: torch.Generator, path: str) -> dict:
    """One MoE serving path, launch counts set to 0 just before it and read
    just after: ``grouped_gemm`` 3 times a layer in every admission of
    at least 2 x E x 128 routed copies, the attention path's kernels at
    least once; TTFT, decode tokens/s, one decode step's time and peak
    memory printed."""
    kind, layers, kernels = MOE_SERVE_PATHS[path]
    cfg = dataclasses.replace(llama.mixtral_8x7b(kind), moe_ragged=True,
                              n_layers=layers)
    t0 = time.perf_counter()
    params = llama.init_params(gen, cfg, "cuda")
    torch.cuda.synchronize()
    weight_gb = sum(nbytes(t) for layer in params["layers"]
                    for v in layer.values()
                    for t in (v.values() if isinstance(v, dict) else [v])
                    ) / 1e9
    print(f"{path}: mixtral_8x7b({kind}) at {layers} layers drawn in "
          f"{time.perf_counter() - t0:.1f} s, layer weights {weight_gb:.2f} "
          f"GB, {torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    reqs = serving.make_requests(SLOTS, 1024, MOE_NEW, seed=0,
                                 prompt_len_max=3000)
    eng = serving.ServingEngine(cfg, params, batch_slots=SLOTS,
                                device="cuda")
    dispatches = []
    step = eng.step

    def recording(tokens, pos, **kw):
        if tokens.shape[1] > 1:
            dispatches.append(tuple(tokens.shape))
        return step(tokens, pos, **kw)
    eng.step = recording
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    eng.run(reqs, window=8)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    del eng.step
    launches = dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats = serving.summarize(reqs, seconds)
    short = [r.uid for r in reqs if len(r.out) != MOE_NEW or not r.done]
    if short:
        raise AssertionError(f"{path}: requests {short} did not get "
                             f"{MOE_NEW} tokens")
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"{path} never launched {missing}")
    ragged = [dsp for dsp in dispatches
              if dsp[0] * dsp[1] * cfg.moe_top_k
              >= llama._moe_ragged_min_tokens(cfg)]
    if not ragged or launches["grouped_gemm"] != 3 * layers * len(ragged):
        raise AssertionError(f"{path}: {launches['grouped_gemm']} "
                             f"grouped_gemm launches for admissions "
                             f"{dispatches}")
    print(f"{path}: prompts {[len(r.prompt) for r in reqs]}, prefill "
          f"dispatches {dispatches}, grouped_gemm "
          f"{launches['grouped_gemm'] // len(ragged)} an admission, peak "
          f"{peak_gb:.2f} GB")
    print(f"{path}: {stats['tokens']} tokens in {seconds:.3f} s = "
          f"{stats['tok_per_s']:.1f} tok/s; TTFT p50 "
          f"{stats['ttft_p50_ms']:.1f} ms max {stats['ttft_max_ms']:.1f} "
          f"ms; decode-only {stats['decode_tok_per_s']:.1f} tok/s")
    tok = torch.ones((SLOTS, 1), dtype=torch.int32, device="cuda")
    pos = torch.full((SLOTS,), 512, dtype=torch.int32, device="cuda")
    step_ms = time_calls(lambda: eng.step(tok, pos), inner_iters=2,
                         outer_repeats=2, warmup=1) * 1e3
    print(f"{path}: decode step {step_ms:.3f} ms at 4 slots, position 512 "
          f"(weights {weight_gb:.3f} GB: bound "
          f"{1e3 * weight_gb * 1e9 / PEAK_BYTES:.3f} ms)")
    stats.update(step_ms=step_ms, peak_gb=peak_gb, layers=layers)
    print(json.dumps({"serve": path, "weights": kind, "cache": "bf16",
                      **stats, "launches": launches}))
    del eng, params
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------- training

# The training attention's kernels (B19) vs their plain versions, each
# output held per row to its own max |plain| (attention.row_rel_err, rows
# raised to 1% of the tensor's max). out: p is rounded to bf16 before
# p @ v, and the kernel's scores (q split into two bf16 halves, 2^-17
# relative) can move a p across a bf16 rounding: a row moves by up to about
# one bf16 ulp of its largest value (measured up to 4.1e-3). dq, dk, dv:
# fp32 throughout, the split operands' 2^-17 and fp32 sums in another order
# (measured up to 7.6e-4 for dq, whose ds = p (dp - delta) cancels; 4.6e-5
# for dk and dv). lse: absolute, a few fp32 ulps of m + log l (measured up
# to 1.1e-5). Each bound is 2.4 to 4.5 times the largest reading on an H100
# (PERF.md, section 6); a planted fault reads 0.67 or more.
TRAIN_OUT_REL = 8e-3
TRAIN_GRAD_REL = 2e-3
TRAIN_LSE_ATOL = 5e-5
# (B, H, KVH, S, D, causal): the soak's shape (the JSON row), the
# Llama-2-7B width (rep 1, D 128) at S = 2,048, and ragged shapes: S of
# 520, 130 and 1,025 (one past a key block and a query step), rep 1, 4 and
# 8 at D 64 and 128, causal and not
TRAIN_SHAPES = ((8, 32, 4, 1024, 64, True), (2, 32, 32, 2048, 128, True),
                (1, 8, 2, 520, 128, False), (2, 4, 1, 130, 64, True),
                (1, 8, 1, 1025, 64, False), (1, 16, 4, 1025, 128, True))
TRAIN_KERNELS = [
    dict(name="flash_attention_fwd_lse",
         source=SRC + "flash_attention_fwd_lse.cu",
         replaces="how_to_optimize_gemm_tpu/ops/pallas_attention.py:311",
         function="pallas_attention._fwd_kernel_lse (_flash_fwd_lse :570; "
                  "flash_attention_train, mha_flash_train)"),
    dict(name="flash_attention_bwd_dq",
         source=SRC + "flash_attention_bwd_dq.cu",
         replaces="how_to_optimize_gemm_tpu/ops/pallas_attention.py:405",
         function="pallas_attention._bwd_dq_kernel (_flash_bwd :635)"),
    dict(name="flash_attention_bwd_dkv",
         source=SRC + "flash_attention_bwd_dkv.cu",
         replaces="how_to_optimize_gemm_tpu/ops/pallas_attention.py:482",
         function="pallas_attention._bwd_dkv_kernel (_flash_bwd :675); "
                  "library_ms: SDPA's whole backward (dq, dk, dv)"),
]
# the training path: the soak at full width and depth, through flash
TRAIN_LAYERS = 22
TRAIN_ARGS = ["--flash-train", "--seq", "1025", "--batch", "8",
              "--n-layers", str(TRAIN_LAYERS), "--sync-every", "1"]
TRAIN_STEPS = 8
TRAIN_CKPT = 4


def _train_faults(q, k, v, do, lse, delta, causal, ref):
    """Readings of the training check's rule on planted faults of the
    plain versions: out and dq of the last 64 queries with one key tile
    before them skipped (the queries are the last S of T positions in the
    plain versions, so the other keys stay visible as before), and dk, dv
    with the first query head of every group dropped from the sum (its do
    and delta set to 0)."""
    bk = attention.KERNEL_BK_LSE
    s = k.shape[2]
    j0 = s // 2 // bk * bk
    keep = torch.cat([torch.arange(j0, device=k.device),
                      torch.arange(j0 + bk, s, device=k.device)])
    last = slice(s - bk, s)
    out_f, _ = attention.flash_attention_fwd_lse_ref(
        q[:, :, last], k[:, :, keep], v[:, :, keep], causal=causal, bk=bk)
    dq_f = attention.flash_attention_bwd_dq_ref(
        q[:, :, last], k[:, :, keep], v[:, :, keep], do[:, :, last],
        lse[:, :, last], delta[:, :, last], causal=causal)
    rep = q.shape[1] // k.shape[1]
    do_f, delta_f = do.clone(), delta.clone()
    do_f[:, ::rep] = 0.0
    delta_f[:, ::rep] = 0.0
    dk_f, dv_f = attention.flash_attention_bwd_dkv_ref(
        q, k, v, do_f, lse, delta_f, causal=causal)
    rel = attention.row_rel_err
    return {"out": float(rel(out_f, ref["out"][:, :, last]).max()),
            "dq": float(rel(dq_f, ref["dq"][:, :, last]).max()),
            "dk": float(rel(dk_f, ref["dk"]).max()),
            "dv": float(rel(dv_f, ref["dv"]).max())}


def check_flash_train(gen: torch.Generator) -> dict:
    """The three training kernels against their plain versions (the
    forward at the kernel's key tiles, whose bf16 p depends on the
    block), all on the plain version's lse and delta, at ``TRAIN_SHAPES``
    on (B, S, H, D) views as ``mha_flash_train`` passes them; the rule
    must refuse each planted fault (``_train_faults``). Timed at the first
    two shapes as CUDA-graph replays, beside the plain versions, the bound
    (the operations of the products at the bf16 peak, the split operands'
    extra MMAs not counted; the bytes of the kernel's inputs and outputs
    once) and SDPA: its forward on bf16 q for the forward kernel, its
    whole backward (dq, dk and dv; the replay of its forward and backward
    less its forward's) on the dK/dV row, beside the port's whole backward
    (delta, dq and dK/dV) as one replay. dQ and dK/dV must each give the
    same bits on a second call. Returns the first shape's results by
    kernel."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rel = attention.row_rel_err
    fwd, dq_k, dkv_k = (s["name"] for s in TRAIN_KERNELS)
    results = {}
    for i, (b, h, kvh, s, d, causal) in enumerate(TRAIN_SHAPES):
        def rows(heads, dtype=torch.float32):
            return torch.randn((b, s, heads, d), generator=gen,
                               device="cuda").to(dtype).transpose(1, 2)
        q, k, v, do = (rows(h), rows(kvh, torch.bfloat16),
                       rows(kvh, torch.bfloat16), rows(h))
        shape = f"B={b} H={h} KVH={kvh} S={s} D={d} causal={causal}"
        out, lse = attention.flash_attention_fwd_lse(q, k, v, causal=causal)
        ref = {}
        ref["out"], ref_lse = attention.flash_attention_fwd_lse_ref(
            q, k, v, causal=causal, bk=attention.KERNEL_BK_LSE)
        delta = (do * ref["out"]).sum(dim=-1)
        args = (q, k, v, do, ref_lse, delta)
        dq = attention.flash_attention_bwd_dq(*args, causal=causal)
        dq2 = attention.flash_attention_bwd_dq(*args, causal=causal)
        ref["dq"] = attention.flash_attention_bwd_dq_ref(*args, causal=causal)
        dk, dv = attention.flash_attention_bwd_dkv(*args, causal=causal)
        dk2, dv2 = attention.flash_attention_bwd_dkv(*args, causal=causal)
        ref["dk"], ref["dv"] = attention.flash_attention_bwd_dkv_ref(
            *args, causal=causal)
        torch.cuda.synchronize()
        if not torch.equal(dq, dq2):
            raise AssertionError(f"flash train {shape}: two dQ calls differ")
        if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
            raise AssertionError(f"flash train {shape}: two dK/dV calls "
                                 "differ")
        got = {"out": out, "dq": dq, "dk": dk, "dv": dv}
        errs = {n: float(rel(got[n], ref[n]).max()) for n in got}
        lse_err = float((lse - ref_lse).abs().max())
        faults = _train_faults(*args, causal, ref)
        bounds = {"out": TRAIN_OUT_REL, "dq": TRAIN_GRAD_REL,
                  "dk": TRAIN_GRAD_REL, "dv": TRAIN_GRAD_REL}
        print(f"flash train {shape}: per-row error over max |plain| "
              + ", ".join(f"{n} {errs[n]:.3e} (bound {bounds[n]}, a "
                          f"planted fault reads {faults[n]:.3e})"
                          for n in errs)
              + f"; lse max abs {lse_err:.3e} (bound {TRAIN_LSE_ATOL})")
        finite = all(bool(torch.isfinite(x).all()) for x in (*got.values(),
                                                            lse))
        bad = [n for n in errs if not errs[n] <= bounds[n]]
        if bad or not finite or not lse_err <= TRAIN_LSE_ATOL:
            raise AssertionError(f"flash train {shape}: {bad or 'lse'} "
                                 f"differ from the plain versions")
        passed = [n for n in faults if not faults[n] > bounds[n]]
        if passed:
            raise AssertionError(f"flash train {shape}: the rule passes the "
                                 f"planted faults of {passed}")
        if i >= 2:
            continue
        pairs = s * (s + 1) // 2 if causal else s * s
        ops = 2.0 * b * h * d * pairs            # one product's FLOPs
        rows_bytes = nbytes(lse, delta)
        q16, do16 = q.to(torch.bfloat16), do.to(torch.bfloat16)
        bounds_ms = {
            fwd: bound_ms(nbytes(q, k, v, out, lse), 2 * ops,
                          PEAK_BF16_FLOPS),
            dq_k: bound_ms(nbytes(q, k, v, do, dq) + rows_bytes, 3 * ops,
                           PEAK_BF16_FLOPS),
            dkv_k: bound_ms(nbytes(q16, k, v, do16, dk, dv) + rows_bytes,
                            4 * ops, PEAK_BF16_FLOPS)}
        lib_bwd_ms = flash_variants.sdpa_backward_ms(q16, k, v, do16,
                                                     causal)

        def port_backward():
            delta_ = (do * ref["out"]).sum(dim=-1)
            a = (q, k, v, do, ref_lse, delta_)
            attention.flash_attention_bwd_dq(*a, causal=causal)
            attention.flash_attention_bwd_dkv(*a, causal=causal)
        port_bwd_ms = time_calls(port_backward, graph=True) * 1e3
        print(f"flash train {shape}: the port's whole backward (delta, dq, "
              f"dK/dV) {port_bwd_ms:.4f} ms, SDPA's (dq, dk, dv) "
              f"{lib_bwd_ms:.4f} ms (graph replays)")
        cases = {
            fwd: (lambda: attention.flash_attention_fwd_lse(
                      q, k, v, causal=causal),
                  lambda: attention.flash_attention_fwd_lse_ref(
                      q, k, v, causal=causal, bk=attention.KERNEL_BK_LSE),
                  lambda: sdpa(q16, k, v, is_causal=causal,
                               enable_gqa=h != kvh),
                  max(errs["out"], lse_err)),
            dq_k: (lambda: attention.flash_attention_bwd_dq(
                       *args, causal=causal),
                   lambda: attention.flash_attention_bwd_dq_ref(
                       *args, causal=causal), None, errs["dq"]),
            dkv_k: (lambda: attention.flash_attention_bwd_dkv(
                        *args, causal=causal),
                    lambda: attention.flash_attention_bwd_dkv_ref(
                        *args, causal=causal), None,
                    max(errs["dk"], errs["dv"]))}
        for name, (kernel, plain, library, err) in cases.items():
            r = timed(name, shape, kernel, plain, library, *bounds_ms[name],
                      err)
            if i == 0:
                print(f"{name} {shape}: {r['ms']:.4f} ms, "
                      f"{BEFORE_MS[name]} ms before the rebuild on "
                      "wgmma")
            if name == dkv_k:
                r["library_ms"] = lib_bwd_ms
            results.setdefault(name, r)
    return results


def train_path(tmp: pathlib.Path) -> dict:
    """The soak as a user runs it (``training.soak_main``), each run with
    every launch count set to 0 just before it and read just after: 8
    steps with a checkpoint at step 4, then one more step under
    torch.profiler; the same run resumed from that checkpoint, whose
    losses must equal the first run's bit for bit; two steps with
    --remat. Every loss finite; each training kernel launched
    once per layer a step, the forward twice under remat. Returns the
    first run's launches."""
    names = [spec["name"] for spec in TRAIN_KERNELS]
    ck, art = tmp / "ckpt", tmp / "train_soak.json"

    def run(extra, remat=False, profiled=0):
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        a = training.soak_main(TRAIN_ARGS + extra)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {n: _build.LAUNCHES[n] for n in names}
        steps = a["config"]["steps"] - a["start_step"] + profiled
        per_step = dict.fromkeys(names, TRAIN_LAYERS)
        if remat:
            per_step[names[0]] *= 2
        want = {n: per_step[n] * steps for n in names}
        print(json.dumps({"train": "remat" if remat else "flash",
                          **{k: a[k] for k in ("start_step", "losses",
                                               "tokens_per_s", "mfu_pct",
                                               "step_ms", "peak_gb",
                                               "checkpoint_s", "sync_marks")},
                          "profiled_step": a["profile"] and {
                              k: a["profile"][k] for k in ("wall_ms",
                                                           "device_ms",
                                                           "busy")},
                          "bitexact_resume": a.get("bitexact_resume"),
                          "launches": launches, "seconds": seconds}))
        if launches != want:
            raise AssertionError(f"training launches {launches}, expected "
                                 f"{want} ({steps} steps)")
        if not all(math.isfinite(x) for x in a["losses"]):
            raise AssertionError(f"training losses {a['losses']}")
        torch.cuda.empty_cache()
        return a, launches

    common = ["--steps", str(TRAIN_STEPS), "--checkpoint-every",
              str(TRAIN_CKPT), "--ckpt-dir", str(ck), "--artifact", str(art)]
    first, launches = run(common + ["--profile"], profiled=1)
    for k in first["profile"]["kernels"]:
        print(f"train step profile: {k['ms']:.3f} ms x{k['count']} "
              f"{k['name']}")
    resumed, _ = run(common + ["--resume-from",
                               str(ck / f"step_{TRAIN_CKPT:06d}")])
    if not resumed["bitexact_resume"]:
        raise AssertionError("the resumed run's losses differ from the "
                             "first run's")
    run(["--remat", "--steps", "2", "--checkpoint-every", "0",
         "--artifact", str(tmp / "train_remat.json")], remat=True)
    return launches


def train_parity(gen: torch.Generator) -> None:
    """Two AdamW steps of the soak's model at full width with 2 layers on
    the card and on the CPU, on the same weights (bf16 linears) and
    batches (2 x 513 tokens: s = 512, so the card runs the flash kernels
    and the CPU their plain versions): the losses and the weights after
    step 2 must each be within PARITY_SENSITIVITY x what a PERTURB
    relative perturbation of the embedding does on the CPU."""
    cfg = llama.LlamaConfig(vocab=32000, d_model=2048, n_layers=2,
                            n_heads=32, n_kv_heads=4, d_ff=5632, max_seq=513,
                            weight_kind="bf16")
    params = llama.init_params(gen, cfg, "cuda")
    pert = convert.to_device(params, "cpu")
    noise = torch.randn(pert["embed"].shape,
                        generator=torch.Generator().manual_seed(1))
    pert["embed"] = pert["embed"] * (1 + PERTURB * noise)
    batches = [torch.from_numpy(training._affine_batch(
        np.random.default_rng(1234 + i), 2, 513, cfg.vocab))
        for i in range(2)]
    names = [spec["name"] for spec in TRAIN_KERNELS]
    out = {}
    for side, tree in (("cuda", params),
                       ("cpu", convert.to_device(params, "cpu")),
                       ("cpu perturbed", pert)):
        dev = "cuda" if side == "cuda" else "cpu"
        opt = training.make_optimizer()
        state = training.init_train_state(tree, opt)
        step = training.make_train_step(cfg, opt, flash_train=True)
        _build.reset_launches()
        losses = []
        for tokens in batches:
            state, loss = step(state, tokens.to(dev))
            losses.append(float(loss))
        if dev == "cuda" and any(_build.LAUNCHES[n] != 2 * cfg.n_layers
                                 for n in names):
            raise AssertionError(f"train parity: card launches "
                                 f"{ {n: _build.LAUNCHES[n] for n in names} }")
        floats, _ = training.split_trainable(state.params)
        out[side] = (torch.tensor(losses, dtype=torch.float64),
                     [f.detach().float().cpu() for f in floats])
        del state, tree
    del params
    torch.cuda.empty_cache()
    ref_loss, ref_w = out["cpu"]
    diffs = {}
    for side in ("cuda", "cpu perturbed"):
        loss, w = out[side]
        diffs[side] = (float((loss - ref_loss).abs().max()),
                       max(float((a - c).abs().max())
                           for a, c in zip(w, ref_w)))
        print(f"train parity: {side} losses {loss.tolist()} (cpu "
              f"{ref_loss.tolist()}): max|loss - cpu| {diffs[side][0]:.4e}, "
              f"max|weights - cpu| after step 2 {diffs[side][1]:.4e}")
    limit = [PARITY_SENSITIVITY * x for x in diffs["cpu perturbed"]]
    if not (all(math.isfinite(x) for x in out["cuda"][0].tolist())
            and all(c <= lim for c, lim in zip(diffs["cuda"], limit))):
        raise AssertionError(f"train parity: card vs CPU {diffs['cuda']} "
                             f"beyond {limit}")


# -------------------------------------------------------- MoE training

MOE_BWD_KERNELS = [
    dict(name="grouped_gemm_t", source=SRC + "grouped_gemm_t.cu",
         replaces="how_to_optimize_gemm_tpu/ops/pallas_grouped_gemm.py:152",
         function="pallas_grouped_gemm._kernel_t (_gmm_call_t :163; the dx "
                  "of _gmm_dense and _gmm_q8)"),
    dict(name="grouped_gemm_t4", source=SRC + "grouped_gemm_t.cu",
         replaces="how_to_optimize_gemm_tpu/ops/pallas_grouped_gemm.py:198",
         function="pallas_grouped_gemm._kernel_t4 (_gmm_call_t4 :218; the "
                  "dx of _gmm_q4)"),
    dict(name="grouped_dw", source=SRC + "grouped_dw.cu",
         replaces="how_to_optimize_gemm_tpu/ops/pallas_grouped_gemm.py:255",
         function="pallas_grouped_gemm._dw_kernel (_grouped_dw :277; the dW "
                  "of _gmm_dense)"),
]
# grouped_gemm_t and _t4 take dy split by split_bf16, two bf16 wgmma
# products as the forward: GROUPED_REL of max |plain| (fp32 stacks FFMA:
# FP32_REL). grouped_dw takes x and dy split by split_bf16, three bf16
# wgmma products (hi.hi + hi.lo + lo.hi, every partial product exact)
# summed in fp32 registers every 256 rows, against the plain version's one
# cuBLAS fp32 product over the expert's rows: FP32_REL, the fp32 sums in
# another order and the dropped lo.lo below 2^-16 of a product. A planted
# fault reads far above its rule: block 0 reading its neighbour expert's
# stack (dx), one of an expert's blocks left out of its sum (dW).
# T-moe: Mixtral-8x7B's width at 1 layer (dense bf16 stacks, every
# gradient taken, need 94 GB at 32 layers; one layer keeps the smoke
# inside its time), batch 2 x 1,025 tokens: 4,096 routed copies >= 2 x E x
# 128, so the ragged path, and s = 1,024 takes flash.
TMOE_LAYERS = 1
TMOE_BATCH = 2
TMOE_SEQ = 1025
TMOE_STEPS = 4
TMOE_CKPT = 2
# per layer a step: the grouped GEMM's three products forward and back,
# the training attention once
TMOE_LAUNCHES = {"grouped_gemm": 3, "grouped_gemm_t": 3, "grouped_dw": 3,
                 "split_bf16": 9,
                 "flash_attention_fwd_lse": 1, "flash_attention_bwd_dq": 1,
                 "flash_attention_bwd_dkv": 1}
# the QLoRA phase: moe_bench train at Mixtral's expert shape, T 4,096
QLORA_ARGS = ["train", "--d", "4096", "--f", "14336", "--e", "8", "--t",
              "4096", "--repeats", "2"]
# training parity at Mixtral's width, 1 layer, batch 1 x 1,025 (2,048
# routed copies: the ragged path at the default threshold): dense bf16
# stacks, and bf16 linears over int8 stacks (moe.quantize_moe)
MOE_TRAIN_PARITY = (("moe bf16", None), ("moe int8 stacks", 8))


def _grouped_mm(a, b, offs):
    """A call of ``torch._grouped_mm``, the library's grouped bf16 product
    (the fp32 operand rounded to bf16 first, a bf16 output; offs the
    groups' cumulative row ends), or None where this PyTorch has none."""
    fn = getattr(torch, "_grouped_mm", None)
    return None if fn is None else (lambda: fn(a, b, offs=offs))


def check_grouped_backward(gen: torch.Generator) -> dict:
    """The grouped GEMM's backward kernels against their plain versions at
    Mixtral-8x7B's prefill layout (``_moe_rows``: T = 4,096 tokens, top-2,
    expert 1 given no token, Tp = 9,216): grouped_gemm_t on int8 and bf16
    stacks and grouped_gemm_t4 on packed int4 ones for w_gate/w_in's dx
    (dy 14,336 -> 4,096) and w_out's (4,096 -> 14,336), grouped_dw on
    both shapes, and grouped_gemm's unscaled int4 instance (the backward's
    recompute of u); then f = 1,000 and fp32 stacks at d 36, f 130. Each
    within its rule of max |plain|, which must refuse the planted faults.
    Timed at the Mixtral shapes as CUDA-graph replays beside the plain
    version, the bound (the routed rows' operations at the bf16 peak, dW's
    at a third of it -- three bf16 products meet its rule -- against each
    operand's bytes once) and the library's grouped product where this
    PyTorch has one (bf16 instances); each kernel timed alone on operands
    split beforehand (its bits the wrapper's), its wrapper beside. Returns
    the row of each kernel: bf16 w_gate (the T-moe path's), int4 w_gate,
    bf16-stack w_gate's dW."""
    e, d, f = MOE_CFG.n_experts, MOE_CFG.d_model, MOE_CFG.d_ff
    cases = [(MOE_T, d, f, e, ("bf16", "int8", "int4"), True),
             (MOE_T, f, d, e, ("bf16", "int8", "int4"), True),
             (1000, 1024, 1000, e, ("bf16", "int8", "int4"), False),
             (100, 36, 130, 4, ("fp32",), False)]
    rows, worst = {}, dict.fromkeys(s["name"] for s in MOE_BWD_KERNELS)
    for t, dout, n, ne, kinds, timed_here in cases:
        xs, be, routed = _moe_rows(gen, t, dout, ne, 2, MOE_EMPTY)
        real = xs.abs().amax(1, keepdim=True) > 0     # the routed rows
        dy = torch.randn((xs.shape[0], n), generator=gen,
                         device="cuda") * real
        offs = torch.cumsum(torch.bincount(be, minlength=ne) * 128,
                            0).to(torch.int32)
        tag = f"Tp={xs.shape[0]} {dout}<-{n} E={ne}"
        for kind in kinds:
            w, s, packed4 = _grouped_stack(gen, kind, ne, dout, n)
            name = "grouped_gemm_t4" if packed4 else "grouped_gemm_t"
            fn = (grouped_gemm.grouped_matmul_t4 if packed4
                  else grouped_gemm.grouped_matmul_t)
            ref_fn = (grouped_gemm.grouped_matmul_t4_ref if packed4
                      else grouped_gemm.grouped_matmul_t_ref)
            out, ref = fn(dy, w, be), ref_fn(dy, w, be)
            wrong = be[:1].clone()
            wrong[0] = (wrong[0] + 1) % ne
            bad = ref_fn(dy[:128], w, wrong)
            torch.cuda.synchronize()
            scale = float(ref.abs().max())
            err = float((out - ref).abs().max())
            fault = float((out[:128] - bad).abs().max())
            tol = FP32_REL if kind == "fp32" else GROUPED_REL
            shape = f"{kind} {tag}"
            print(f"{name} {shape}: max|kernel - plain| = {err} = "
                  f"{err / scale:.3e} of max|plain| (bound {tol}); block 0 "
                  f"on its neighbour's stack reads {fault / scale:.3e}")
            if not (err <= tol * scale and fault > tol * scale):
                raise AssertionError(f"{name} {shape}: {err / scale} "
                                     f"(fault {fault / scale})")
            worst[name] = max(worst[name] or 0.0, err)
            if timed_here:
                b = bound_ms(nbytes(dy, w, out), 2.0 * routed * dout * n,
                             PEAK_BF16_FLOPS)
                lib = (_grouped_mm(dy.to(torch.bfloat16), w.transpose(1, 2),
                                   offs) if kind == "bf16" else None)
                alone, y = _t_alone(dy, w, be, packed4)
                _same_as_wrapper(name, shape, alone, y, out)
                r = timed(name, shape, alone, lambda: ref_fn(dy, w, be), lib,
                          *b, err, lambda: fn(dy, w, be))
                if n == f and kind in ("bf16", "int4"):
                    rows[name] = r
                del alone, y
            if packed4 and timed_here and n == f:
                u = grouped_gemm._gmm(xs, w, be, None, 128, True)
                uref = grouped_gemm.grouped_matmul_ref(xs, w, be,
                                                       packed4=True)
                torch.cuda.synchronize()
                uerr = float((u - uref).abs().max())
                uscale = float(uref.abs().max())
                if not uerr <= GROUPED_REL * uscale:
                    raise AssertionError(f"grouped_gemm unscaled int4: "
                                         f"{uerr / uscale}")
                b = bound_ms(nbytes(xs, w, u), 2.0 * routed * dout * n,
                             PEAK_BF16_FLOPS)
                ushape = f"unscaled {shape} (the backward's recompute of u)"
                alone, y = _forward_alone(xs, w, be, None, True)
                _same_as_wrapper("grouped_gemm", ushape, alone, y, u)
                timed("grouped_gemm", ushape, alone,
                      lambda: grouped_gemm.grouped_matmul_ref(
                          xs, w, be, packed4=True), None, *b, uerr,
                      lambda: grouped_gemm._gmm(xs, w, be, None, 128, True))
                del u, uref, alone, y
            del w, s, out, ref, bad
        got = grouped_gemm.grouped_dw(xs, dy, be, ne)
        ref = grouped_gemm.grouped_dw_ref(xs, dy, be, ne)
        e0 = int(be[0])
        bad = ref[e0] - grouped_gemm.grouped_dw_ref(xs[:128], dy[:128],
                                                    be[:1], ne)[e0]
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        fault = float((got[e0] - bad).abs().max())
        print(f"grouped_dw {tag}: max|kernel - plain| = {err} = "
              f"{err / scale:.3e} of max|plain| (bound {FP32_REL}); "
              f"expert {e0} without its first block reads "
              f"{fault / scale:.3e}; the empty expert's dW all zeros: "
              f"{not got[MOE_EMPTY].any()}")
        if not (err <= FP32_REL * scale and fault > FP32_REL * scale
                and not got[MOE_EMPTY].any()):
            raise AssertionError(f"grouped_dw {tag}: {err / scale} "
                                 f"(fault {fault / scale})")
        worst["grouped_dw"] = max(worst["grouped_dw"] or 0.0, err)
        del bad
        if timed_here:
            b = bound_ms(nbytes(xs, dy, got), 2.0 * routed * dout * n,
                         PEAK_FP32_FLOPS)
            lib = _grouped_mm(xs.to(torch.bfloat16).t(),
                              dy.to(torch.bfloat16), offs)
            alone, y = _dw_alone(xs, dy, be, ne)
            _same_as_wrapper("grouped_dw", tag, alone, y, got)
            r = timed("grouped_dw", f"fp32 {tag}", alone,
                      lambda: grouped_gemm.grouped_dw_ref(xs, dy, be, ne),
                      lib, *b, err,
                      lambda: grouped_gemm.grouped_dw(xs, dy, be, ne))
            if n == f:
                rows["grouped_dw"] = r
            del alone, y
        del xs, dy, got, ref
        torch.cuda.empty_cache()
    for name, r in rows.items():
        r["max_abs_err"] = worst[name]
    return rows


def _fresh(tree, device):
    """A copy of the tree's tensors on ``device`` (a train step updates its
    parameters in place)."""
    if isinstance(tree, dict):
        return {k: _fresh(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fresh(v, device) for v in tree]
    return tree.to(device, copy=True)


def _moe_train_batches(n: int, batch: int, vocab: int) -> list:
    return [torch.from_numpy(training._affine_batch(
        np.random.default_rng(4321 + i), batch, TMOE_SEQ, vocab))
        for i in range(n)]


def train_moe_path(tmp: pathlib.Path) -> dict:
    """T-moe: Mixtral-8x7B's width at TMOE_LAYERS (dense bf16 stacks,
    moe_ragged) through ``training.make_train_step(flash_train=True)``,
    AdamW, batch 2 x 1,025 tokens, with every launch count set to 0 just
    before the run: 4 steps with a checkpoint at step 2, then one step
    under torch.profiler; the same model resumed from the checkpoint,
    whose losses must equal the first run's bit for bit. Every loss
    finite; the router, the stacks, the attention and the embedding move;
    each kernel launched TMOE_LAUNCHES times a layer a step. Returns the
    first run's launches."""
    cfg = dataclasses.replace(llama.mixtral_8x7b("bf16"),
                              n_layers=TMOE_LAYERS, moe_ragged=True,
                              max_seq=TMOE_SEQ)
    print(f"T-moe: depth {cfg.n_layers} of mixtral_8x7b's 32 layers")
    batches = [b.to("cuda") for b in _moe_train_batches(
        TMOE_STEPS, TMOE_BATCH, cfg.vocab)]
    ck = tmp / "tmoe_s2"

    def run(resume=None):
        gen = torch.Generator(device="cuda").manual_seed(3)
        params = llama.init_params(gen, cfg, "cuda")
        opt = training.make_optimizer()
        state = training.init_train_state(params, opt)
        if resume is not None:
            t0 = time.perf_counter()
            state = checkpoint.load_train_state(resume, state)
            print(f"T-moe: resumed from step {state.step} in "
                  f"{time.perf_counter() - t0:.1f} s")
        step = training.make_train_step(cfg, opt, flash_train=True)
        layer = state.params["layers"][0]
        watch = {"router": layer["moe"]["router"],
                 "w_in": layer["moe"]["w_in"][0, :64, :64],
                 "w_out": layer["moe"]["w_out"][-1, :64, :64],
                 "wq": layer["wq"]["bf16_w"][:64, :64],
                 "embed": state.params["embed"][:64]}
        before = {k: v.detach().clone() for k, v in watch.items()}
        losses, step_s = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        print(f"T-moe: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
              "allocated before the steps")
        _build.reset_launches()
        for i in range(state.step, TMOE_STEPS):
            t0 = time.perf_counter()
            state, loss = step(state, batches[i])
            losses.append(float(loss))
            step_s.append(time.perf_counter() - t0)
            if resume is None and i + 1 == TMOE_CKPT:
                t0 = time.perf_counter()
                checkpoint.save_train_state(ck, state)
                print(f"T-moe: checkpoint at step {TMOE_CKPT} in "
                      f"{time.perf_counter() - t0:.1f} s")
        launches = dict(_build.LAUNCHES)
        moved = {k: not torch.equal(before[k], v) for k, v in watch.items()}
        return state, step, losses, step_s, launches, moved

    state, step, losses, step_s, launches, moved = run()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = TMOE_STEPS
    want = {k: n * cfg.n_layers * steps for k, n in TMOE_LAUNCHES.items()}
    got = {k: launches[k] for k in want}
    tokens = TMOE_BATCH * (TMOE_SEQ - 1)
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    print(json.dumps({"train": "T-moe", "losses": losses,
                      "step_ms": [1e3 * x for x in step_s],
                      "steady_step_ms": 1e3 * steady,
                      "tokens_per_s": tokens / steady, "peak_gb": peak_gb,
                      "moved": moved, "launches": got}))
    if got != want:
        raise AssertionError(f"T-moe launches {got}, expected {want}")
    if not (all(math.isfinite(x) for x in losses) and all(moved.values())):
        raise AssertionError(f"T-moe: losses {losses}, moved {moved}")
    prof = training._profile_step(step, state, batches[-1], top=16)
    print(f"T-moe profiled step: wall {prof['wall_ms']:.1f} ms, device "
          f"{prof['device_ms']:.1f} ms ({100 * prof['busy']:.1f}% busy)")
    for k in prof["kernels"]:
        print(f"T-moe step profile: {k['ms']:.3f} ms x{k['count']} "
              f"{k['name']}")
    del state, step
    torch.cuda.empty_cache()
    state, step, losses2, _, _, _ = run(ck)
    print(f"T-moe resumed: losses {losses2} (first run {losses})")
    if losses2 != losses[TMOE_CKPT:]:
        raise AssertionError("T-moe: the resumed run's losses differ from "
                             "the first run's")
    del state, step
    torch.cuda.empty_cache()
    return got


def qlora_path() -> dict:
    """``moe_bench train`` at Mixtral's expert shape (d 4,096, f 14,336,
    E 8, T 4,096) on int8 and packed int4 stacks, each with every launch
    count set to 0 just before it: the integer stacks unchanged, the
    router and every scale a nonzero gradient, and the gradient step's
    launches: grouped_gemm 6 (the forward's three and the three unscaled
    recomputes of u), grouped_gemm_t (int8) or grouped_gemm_t4 (int4)
    once (w_out's dx into the SwiGLU activations: the input x takes no
    gradient there; the timed chained step takes dx at all three) and
    split_bf16 7 (one before each of those seven products).
    Returns the launches summed over both runs."""
    from how_to_optimize_gemm_tpu_torch.parallel import moe_bench
    total = {}
    for kind in ("int8", "int4"):
        _build.reset_launches()
        r = moe_bench.main(QLORA_ARGS + ["--kind", kind])["custom"][
            f"train {kind}"]
        for k, v in _build.LAUNCHES.items():
            total[k] = total.get(k, 0) + v
        t = "grouped_gemm_t4" if kind == "int4" else "grouped_gemm_t"
        want = {"grouped_gemm": 6, "split_bf16": 7, t: 1}
        step = {k: r["launches"].get(k, 0) for k in want}
        print(json.dumps({"qlora": kind, "loss": r["loss"],
                          "trainable": r["trainable"],
                          "grad_norms": r["grad_norms"],
                          "step_launches": r["launches"],
                          "stacks_unchanged": r["stacks_unchanged"],
                          "fwd_bwd_x_ms": r["ms"]}))
        if not (r["stacks_unchanged"] and step == want
                and all(v > 0 for v in r["grad_norms"].values())):
            raise AssertionError(f"QLoRA {kind}: {r}")
        torch.cuda.empty_cache()
    return total


def _flipped_tokens(label: str, routes: dict, k: int, step: int) -> set:
    """The tokens of a one-layer forward (one router call a side) that
    some side routes to other top-k experts than the CPU does; each must
    be a near-tie on the CPU side (k-th and (k+1)-th probabilities within
    PARITY_TIE), else this raises."""
    flipped = set()
    ref = routes["cpu"][0]
    for side, calls in routes.items():
        if side == "cpu":
            continue
        for got in calls:
            a = torch.sort(torch.topk(got, k).indices, -1).values
            b = torch.sort(torch.topk(ref, k).indices, -1).values
            for tok in torch.nonzero((a != b).any(-1)).flatten().tolist():
                top = torch.topk(torch.softmax(ref[tok], -1), k + 1).values
                gap = float(top[k - 1] - top[k])
                print(f"train parity {label}: {side} routes step {step} "
                      f"token {tok} otherwise; the CPU's top-{k} gap "
                      f"{gap:.3e}")
                if gap > PARITY_TIE:
                    raise AssertionError(f"train parity {label}: a token "
                                         f"routed otherwise at a gap of "
                                         f"{gap}")
                flipped.add(tok)
    return flipped


@contextlib.contextmanager
def cpu_plain(dev: str, cache: dict):
    """For a CPU side: the plain flash versions at the kernel's tiles
    (``kernel_tiles``) and the weight conversions cached
    (``cached_weights``); nothing for the card."""
    if dev != "cpu":
        yield
        return
    with kernel_tiles(), cached_weights(cache):
        yield


class _Routed(Exception):
    """Raised by ``router_logits``'s stand-in MoE once the router ran."""


def router_logits(params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """The router logits (tokens, E) on the CPU of a one-layer MoE model's
    forward on ``tokens`` (flash_train, no grad), the forward stopped at
    its router: the MoE paths are replaced, while this runs, by one that
    calls ``moe._router_logits`` as theirs do and raises ``_Routed``."""
    calls = []

    def stop(params, x, *args, **kwargs):
        calls.append(moe._router_logits(params, x).float().cpu())
        raise _Routed
    real = moe.moe_ffn_ragged, moe.moe_ffn_local
    moe.moe_ffn_ragged = moe.moe_ffn_local = stop
    try:
        with torch.no_grad():
            llama.forward(params, cfg, tokens, flash_train=True)
    except _Routed:
        pass
    finally:
        moe.moe_ffn_ragged, moe.moe_ffn_local = real
    return calls[0]


@contextlib.contextmanager
def nll_without(tokens: set):
    """``llama.token_nll`` leaving out the predictions at the positions in
    ``tokens`` (of a batch of one): the positions a side routes otherwise.
    With one layer a token's experts reach only its own prediction, so
    the rest of the loss, and its gradients, compare like with like."""
    real = llama.token_nll

    def masked(logits, targets):
        keep = torch.ones(targets.shape, dtype=torch.float32,
                          device=logits.device)
        keep[:, sorted(tokens)] = 0.0
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None].to(torch.int64))
        return (nll[..., 0] * keep).sum() / keep.sum()
    llama.token_nll = masked if tokens else real
    try:
        yield
    finally:
        llama.token_nll = real


def train_moe_parity(gen: torch.Generator) -> None:
    """Two AdamW steps at Mixtral-8x7B's width with 1 layer (batch 1 x
    1,025: the ragged path on the card's backward kernels and flash) on
    the card and on the CPU (the plain versions, flash's at the kernels'
    key tiles) from the same weights and batches, for dense bf16 stacks
    and for int8 stacks under bf16 linears: the losses and the weights
    after step 2 within PARITY_SENSITIVITY x what a PERTURB relative
    perturbation of the embedding does on the CPU.

    The sides run in step. Before each step a forward up to the router on
    every side (``router_logits``; the step's own router must choose the
    same experts: on the CPU two such forwards have differed in the last
    bits of a logit) finds the tokens some side routes to other experts
    than the CPU does; each must be a near-tie on the CPU side
    (``_flipped_tokens``), and that step's loss leaves out their
    predictions on every side (``nll_without``: with one layer a token's
    experts reach only its own prediction). AdamW's first step moves
    every weight by about lr whatever the size of its gradient, so a
    gradient within rounding of 0 moves a weight by 2 lr on one side only,
    and the second step's router turns that into near-tie flips of its
    own, on the perturbed side as on the card."""
    cfg = dataclasses.replace(llama.mixtral_8x7b("bf16"), n_layers=1,
                              moe_ragged=True, max_seq=TMOE_SEQ)
    batches = _moe_train_batches(2, 1, cfg.vocab)
    for label, bits in MOE_TRAIN_PARITY:
        t0 = time.perf_counter()
        params = llama.init_params(gen, cfg, "cuda")
        if bits:
            layer = params["layers"][0]
            layer["moe"] = moe.quantize_moe(layer["moe"], bits)
        cpu = _fresh(params, "cpu")
        noise = torch.randn(cpu["embed"].shape,
                            generator=torch.Generator().manual_seed(1))
        pert = _fresh(cpu, "cpu")
        pert["embed"] = pert["embed"] * (1 + PERTURB * noise)
        sides = {}
        for side, tree in (("cuda", params), ("cpu", cpu),
                           ("cpu perturbed", pert)):
            opt = training.make_optimizer()
            sides[side] = (training.init_train_state(tree, opt),
                           training.make_train_step(cfg, opt,
                                                    flash_train=True))
        del params, cpu, pert
        losses = {side: [] for side in sides}
        seconds = dict.fromkeys(sides, 0.0)
        caches = {side: {} for side in sides}
        _build.reset_launches()
        for n, tokens in enumerate(batches):
            routes = {}
            for side, (state, _) in sides.items():
                dev = "cuda" if side == "cuda" else "cpu"
                t_side = time.perf_counter()
                with cpu_plain(dev, caches[side]):
                    routes[side] = [router_logits(state.params, cfg,
                                                  tokens[:, :-1].to(dev))]
                seconds[side] += time.perf_counter() - t_side
            skip = _flipped_tokens(label, routes, cfg.moe_top_k, n + 1)
            if 2 * len(skip) > tokens.shape[1] - 1:
                raise AssertionError(f"train parity {label}: {len(skip)} "
                                     f"tokens routed otherwise at step "
                                     f"{n + 1}")
            for side, (state, step) in sides.items():
                dev = "cuda" if side == "cuda" else "cpu"
                t_side = time.perf_counter()
                inside = []
                with cpu_plain(dev, caches[side]), nll_without(skip), \
                        recorded_routes(inside):
                    _, loss = step(state, tokens.to(dev))
                losses[side].append(float(loss))
                seconds[side] += time.perf_counter() - t_side
                chosen = [torch.sort(torch.topk(r, cfg.moe_top_k).indices,
                                     -1).values
                          for r in (inside[0], routes[side][0])]
                if not torch.equal(*chosen):
                    raise AssertionError(f"train parity {label}: {side}'s "
                                         "step routed otherwise than its "
                                         "router pass")
        names = ["grouped_gemm", "grouped_gemm_t"] + ([] if bits else
                                                       ["grouped_dw"])
        if any(_build.LAUNCHES[k] == 0 for k in names):
            raise AssertionError(f"train parity {label}: card launches "
                                 f"{_build.LAUNCHES}")
        # the weights compared on the card: the same fp32 differences of
        # the same values, a fraction of the CPU's time at this width
        weights = {side: [w.detach().to("cuda") for w in
                          training.split_trainable(state.params)[0]]
                   for side, (state, _) in sides.items()}
        ref_loss = torch.tensor(losses["cpu"], dtype=torch.float64)
        diffs = {}
        for side in ("cuda", "cpu perturbed"):
            loss = torch.tensor(losses[side], dtype=torch.float64)
            diffs[side] = (float((loss - ref_loss).abs().max()),
                           max(float((a.float() - c.float()).abs().max())
                               for a, c in zip(weights[side],
                                               weights["cpu"])))
            print(f"train parity {label}: {side} losses {loss.tolist()} "
                  f"(cpu {ref_loss.tolist()}): max|loss - cpu| "
                  f"{diffs[side][0]:.4e}, max|weights - cpu| after step 2 "
                  f"{diffs[side][1]:.4e}")
        del sides, weights
        torch.cuda.empty_cache()
        limit = [PARITY_SENSITIVITY * x for x in diffs["cpu perturbed"]]
        if not (all(math.isfinite(x) for x in losses["cuda"])
                and all(c <= lim for c, lim in zip(diffs["cuda"], limit))):
            raise AssertionError(f"train parity {label}: card vs CPU "
                                 f"{diffs['cuda']} beyond {limit}")
        print(f"train parity {label}: {time.perf_counter() - t0:.1f} s ("
              + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items())
              + ")")


# ------------------------------------------------- the tooling path (B21, B22)
PROBE_SRC = {"compute": SRC + "probes_compute.cu",
             "memory": SRC + "probes_memory.cu"}
REF_PROBES = "how_to_optimize_gemm_tpu/ops/probes.py"
TOOL_KERNELS = [
    dict(name="mma_chain", source=PROBE_SRC["compute"],
         replaces=REF_PROBES + ":34",
         function="probes._mxu_kernel (_mxu_probe :55, mxu_peak_gflops :64)"),
    dict(name="mma_throughput", source=PROBE_SRC["compute"],
         replaces=REF_PROBES + ":83",
         function="probes._mxu_throughput_kernel (mxu_throughput_gflops "
                  ":122, mxu_depth_gflops :161)"),
    dict(name="exp_chain", source=PROBE_SRC["compute"],
         replaces=REF_PROBES + ":174",
         function="probes._vpu_exp_kernel (vpu_exp_gelems :206)"),
    dict(name="ffma_chain", source=PROBE_SRC["compute"],
         replaces=REF_PROBES + ":281",
         function="probes._vpu_kernel (vpu_peak_gflops :310)"),
    dict(name="copy_grid", source=PROBE_SRC["memory"],
         replaces=REF_PROBES + ":218",
         function="probes._copy_kernel (_hbm_copy_once :224, "
                  "hbm_bandwidth_gbps :244)"),
    dict(name="tile_read", source=PROBE_SRC["memory"],
         replaces=REF_PROBES + ":322",
         function="probes._chunk_kernel (dma_chunk_bandwidth_gbps :393)"),
    dict(name="smem_copy", source=PROBE_SRC["memory"],
         replaces=REF_PROBES + ":407",
         function="probes._vmem_copy_kernel (vmem_bandwidth_gbps :431)"),
    dict(name="load_latency", source=PROBE_SRC["memory"],
         replaces=REF_PROBES + ":444",
         function="probes._dma_latency_kernel (dma_latency_ns :482)"),
    dict(name="pipelined_copy", source=PROBE_SRC["memory"],
         replaces=REF_PROBES + ":498",
         function="probes._manual_copy_kernel (hbm_copy_manual_gbps :562)"),
    dict(name="add_one", source=SRC + "dispatch_probe.cu",
         replaces="how_to_optimize_gemm_tpu/ops/dispatch_probe.py:55",
         function="dispatch_probe._copy_kernel (_custom_op :60, chained by "
                  "_make_chain :69)"),
]
# A.2's question on the card: the bf16 summit against cuBLAS
AB_ARGS = ["--a", "15_packed_alias_bf16", "--b", "01b_xla_bf16", "--p",
           "2048", "4096", "--rounds", "5"]
# The checks' iteration counts: the default tiles and sizes of each probe,
# with the iterations cut so that its plain version (a Python loop of
# PyTorch ops a step) ends within tens of milliseconds.
CHECK_ITERS = {"mma_chain": 4, "mma_throughput": 16, "exp_chain": 256,
               "ffma_chain": 32, "smem_copy": 64, "load_latency": 4096}


def tooling_path(tmp: pathlib.Path) -> dict:
    """The three tooling entry points as a user runs them, with every
    launch count set to 0 just before: ``probes.main()`` (every reading
    at most 105% of its ceiling, else it raises), ``dispatch_probe.main(
    fast=True)`` (eager and graph costs per op kind) and ``ab.main`` on
    rung 15 against 01b at p = 2,048 and 4,096, 5 rounds, its artifact in
    ``tmp``. Returns the launches of the ten probe kernels."""
    _build.reset_launches()
    rows = probes.main()
    dispatch = dispatch_probe.main(fast=True)
    for (kind, column), (_, slope, icept) in dispatch["chains"].items():
        if not (math.isfinite(slope) and math.isfinite(icept)):
            raise AssertionError(f"dispatch probe {kind} {column}: slope "
                                 f"{slope}, intercept {icept}")
    results = ab.main(AB_ARGS + ["--artifact-dir", str(tmp)])
    artifact = json.loads((tmp / "ab_15_packed_alias_bf16_vs_01b_xla_bf16"
                           ".json").read_text())
    for r in results:
        if r.wins_a + r.wins_b + r.ties != r.rounds:
            raise AssertionError(f"ab p={r.p}: {r}")
    torch.cuda.synchronize()
    launches = {s["name"]: _build.LAUNCHES[s["name"]] for s in TOOL_KERNELS}
    print(json.dumps({"tooling": {
        "probes": {r["name"]: [r["value"], r["unit"], r["share"]]
                   for r in rows},
        "dispatch_us_per_op": {f"{k} {c}": v[1]
                               for (k, c), v in dispatch["chains"].items()},
        "ab_w_t_l": {r.p: [r.wins_a, r.ties, r.wins_b] for r in results},
        "ab_medians": {r.p: [r.a_median, r.b_median] for r in results},
        "ab_sessions": len(artifact["sessions"]),
        "launches": launches}}))
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"the tooling path never launched {missing}")
    return launches


def _tool_timed(name: str, shape: str, kernel, plain, library, b_ms,
                b_by, err: float, graph: bool = False) -> dict:
    """The kernel and the library call timed as CUDA-event windows of
    back-to-back calls (as CUDA-graph replays where ``graph``: add_one,
    whose launch outlasts its work), the plain version from Python."""
    r = dict(max_abs_err=err,
             ms=time_calls(kernel, inner_iters=5, graph=graph) * 1e3,
             plain_ms=time_calls(plain, inner_iters=2, outer_repeats=2,
                                 warmup=1) * 1e3,
             library_ms=(None if library is None else time_calls(
                 library, inner_iters=5, graph=graph) * 1e3),
             bound_ms=b_ms, bound_by=b_by)
    lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
    bnd = "null" if b_ms is None else f"{b_ms:.4f} by {b_by}"
    print(f"{name} {shape}: max|kernel - plain| = {err}; {r['ms']:.4f} ms "
          f"(plain {r['plain_ms']:.4f}, library {lib}, bound {bnd})")
    return r


def _within(name: str, shape: str, out, ref, tol) -> float:
    """max |out - ref|, which must be within ``tol`` (a tensor of
    per-element bounds or a number)."""
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    if not bool((diff <= tol).all()):
        raise AssertionError(f"{name} {shape}: beyond its bound by "
                             f"{float((diff - tol).max())}")
    return float(diff.max())


def check_tooling(gen: torch.Generator) -> dict:
    """Each probe kernel against its plain version at the probe's default
    tiles and sizes (iterations cut to CHECK_ITERS) and at a small shape,
    under the rules of tests/test_torch_cuda.py's probe tests: EQUAL for
    the int8 chains, the copies, the checksum, the VMEM copy, the latency
    sums and add_one; bf16 chain n x 2^-8 of max |plain|; 3xTF32 chain n x
    (S x 2^-24 + 2^-20) and bf16 throughput n x K x 2^-24 of the largest
    sum of |terms|; exp (n + 4) x 2^-23 and FFMA one ulp a step of |plain|.
    The multi-stage copy's rule must refuse a copy with one chunk left
    out. Each kernel timed on its check inputs beside its plain version,
    its bound (data sheet; shared memory at the derived rate; none for
    the latency) and the library call where one PyTorch call computes the
    same function."""
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tiles = probes.TILES_PER_SM * sms
    derived = probes.derived_ceilings(dev)
    out = {}

    # mma_chain: every type at (tiles, 128, 128), and (3, 64, 64) once
    n = CHECK_ITERS["mma_chain"]
    errs = []
    for dtype in ("int8", "bf16", "fp32"):
        for size, t, iters in ((128, tiles, n), (64, 3, 1)):
            x, y = probes.chain_inputs(dtype, size, t, dev)
            if dtype == "int8":   # random bytes: the casts wrap
                x = torch.randint(-128, 128, x.shape, generator=gen,
                                  device=dev, dtype=torch.int8)
                y = torch.randint(-128, 128, y.shape, generator=gen,
                                  device=dev, dtype=torch.int8)
            else:   # a random y: every column of every step differs
                y = (torch.rand(y.shape, generator=gen, device=dev) * 2
                     - 1).to(y.dtype)
            got = probes.mxu_chain(x, y, iters)
            ref = probes.mxu_chain_ref(x, y, iters)
            shape = f"{dtype} {t}x{size}x{size} n={iters}"
            if dtype == "int8":
                errs.append(_equal("mma_chain", shape, got, ref))
            elif dtype == "bf16":
                errs.append(_within("mma_chain", shape, got, ref, iters
                                    * 2.0 ** -8 * float(ref.abs().max())))
            else:
                bound = float((x.abs() @ ref.abs()).max())
                errs.append(_within("mma_chain", shape, got, ref, iters * (
                    size * 2.0 ** -24 + 2.0 ** -20) * bound))
    x, y = probes.chain_inputs("bf16", 128, tiles, dev)
    flops = 2.0 * 128 ** 3 * tiles * n
    out["mma_chain"] = _tool_timed(
        "mma_chain", f"bf16 {tiles}x128x128 n={n}",
        lambda: probes.mxu_chain(x, y, n),
        lambda: probes.mxu_chain_ref(x, y, n), None,
        *bound_ms(nbytes(x, y) + 4 * x.numel(), flops, PEAK_BF16_FLOPS),
        max(errs))

    # mma_throughput: int8 (64 x 256) and bf16 at depth 64, default tiles;
    # a small (2, 64, 128) once
    n = CHECK_ITERS["mma_throughput"]
    errs = []
    for dtype, k, t, iters in (("int8", 256, tiles, n),
                               ("bf16", 64, tiles, n), ("int8", 128, 2, 3),
                               ("bf16", 512, 2, 3)):
        if dtype == "int8":
            xt = torch.randint(-128, 128, (t, 64, k), generator=gen,
                               device=dev, dtype=torch.int8)
            yt = torch.randint(-128, 128, (t, k, 64), generator=gen,
                               device=dev, dtype=torch.int8)
        else:
            xt = (torch.rand((t, 64, k), generator=gen, device=dev) * 2
                  - 1).to(torch.bfloat16)
            yt = (torch.rand((t, k, 64), generator=gen, device=dev) * 2
                  - 1).to(torch.bfloat16)
        got = probes.mxu_throughput(xt, yt, iters)
        ref = probes.mxu_throughput_ref(xt, yt, iters)
        shape = f"{dtype} {t}x64x{k} n={iters}"
        if dtype == "int8":
            errs.append(_equal("mma_throughput", shape, got, ref))
            if t == tiles:
                xi, yi = xt, yt
        else:
            bound = float((xt.float().abs() @ yt.float().abs()).max())
            errs.append(_within("mma_throughput", shape, got, ref,
                                iters * k * 2.0 ** -24 * bound))
    flops = 2.0 * 64 * 64 * 256 * tiles * n
    out["mma_throughput"] = _tool_timed(
        "mma_throughput", f"int8 {tiles}x64x256 n={n}",
        lambda: probes.mxu_throughput(xi, yi, n),
        lambda: probes.mxu_throughput_ref(xi, yi, n), None,
        *bound_ms(nbytes(xi, yi) + 4 * 64 * 64 * tiles, flops,
                  PEAK_INT8_OPS), max(errs))

    # exp_chain and ffma_chain: the readings' default tiles, and a ragged one
    n = CHECK_ITERS["exp_chain"]
    errs = []
    for shape in ((8 * sms, 1024), (5, 1000)):
        xe = torch.rand(shape, generator=gen, device=dev) * 3 - 2
        got, ref = probes.vpu_exp(xe, n), probes.vpu_exp_ref(xe, n)
        errs.append(_within("exp_chain", f"{shape} n={n}", got, ref,
                            (n + 4) * 2.0 ** -23 * ref.abs()))
    xe = torch.full((8 * sms, 1024), -0.5, device=dev)
    sfu = derived["sfu"] * 1e9 if derived["sfu"] else None
    t_sfu = xe.numel() * n / sfu if sfu else 0.0
    # 5 fp32 operations a term around the SFU's exp: the larger bound
    b_ms, b_by = bound_ms(2 * nbytes(xe), 5.0 * xe.numel() * n,
                          PEAK_FFMA_FLOPS)
    if 1e3 * t_sfu > b_ms:
        b_ms, b_by = 1e3 * t_sfu, "operations"
    out["exp_chain"] = _tool_timed(
        "exp_chain", f"{tuple(xe.shape)} n={n}",
        lambda: probes.vpu_exp(xe, n), lambda: probes.vpu_exp_ref(xe, n),
        None, b_ms, b_by, max(errs))

    n = CHECK_ITERS["ffma_chain"]
    errs = []
    for shape in ((16 * sms, 512), (7, 500)):
        xf = torch.rand(shape, generator=gen, device=dev) * 2 - 1
        for dep in (True, False):
            got = probes.vpu_fma(xf, n, dep)
            ref = probes.vpu_fma_ref(xf, n, dep)
            steps = n * (8 if dep else 1) + 3
            errs.append(_within("ffma_chain", f"{shape} n={n} dep={dep}",
                                got, ref, steps * 2.0 ** -23 * torch.maximum(
                                    ref.abs(), xf.abs())))
    xf = torch.full((16 * sms, 512), 1e-6, device=dev)
    out["ffma_chain"] = _tool_timed(
        "ffma_chain", f"{tuple(xf.shape)} n={n} independent",
        lambda: probes.vpu_fma(xf, n, False),
        lambda: probes.vpu_fma_ref(xf, n, False), None,
        *bound_ms(2 * nbytes(xf), 2.0 * 4 * xf.numel() * n,
                  PEAK_FFMA_FLOPS), max(errs))

    # copy_grid and pipelined_copy: the readings' 1 GiB, one copy; the
    # vendor stream's one pass (y * 1.000001) beside them
    big = torch.randn((131072, 2048), generator=gen, device=dev)
    dst = torch.empty_like(big)
    small = torch.randn((1000, 36), generator=gen, device=dev)
    err = max(_equal("copy_grid", "(1000, 36)", probes.hbm_copy(small),
                     probes.hbm_copy_ref(small)),
              _equal("copy_grid", "(131072, 2048)",
                     probes.hbm_copy(big, dst), big))
    stream = torch.empty_like(big)
    library = lambda: torch.mul(big, 1.000001, out=stream)   # noqa: E731
    out["copy_grid"] = _tool_timed(
        "copy_grid", "(131072, 2048) fp32",
        lambda: probes.hbm_copy(big, dst),
        lambda: probes.hbm_copy_ref(big, dst), library,
        *bound_ms(2 * nbytes(big), 0.0, PEAK_FFMA_FLOPS), err)

    errs = []
    for src, rows, nslots in ((big, 2, 4), (small[:999].reshape(-1, 36 * 3)
                                            .contiguous(), 3, 3)):
        dst2 = torch.zeros_like(src)
        got, cnt = probes.manual_copy(src, rows, nslots, 1, dst2)
        ref, ref_cnt = probes.manual_copy_ref(src, rows, nslots, 1)
        shape = f"{tuple(src.shape)} rows={rows} slots={nslots}"
        errs.append(_equal("pipelined_copy", shape, got, ref))
        _equal("pipelined_copy", shape + " count", cnt, ref_cnt)
        skipped = ref.clone()
        skipped[rows:2 * rows] = 0          # one chunk left out
        if torch.equal(skipped, src):
            raise AssertionError("pipelined_copy: the rule passed a copy "
                                 "with one chunk left out")
    out["pipelined_copy"] = _tool_timed(
        "pipelined_copy", "(131072, 2048) fp32 rows=2 slots=4",
        lambda: probes.manual_copy(big, 2, 4, 1, dst),
        lambda: probes.manual_copy_ref(big, 2, 4, 1, dst), library,
        *bound_ms(2 * nbytes(big), 0.0, PEAK_FFMA_FLOPS), max(errs))
    del big, dst, stream

    # tile_read: the readings' 65,536^2 parent, both chunk shapes, one rep
    parent = torch.randint(-128, 128, (65536, 65536), generator=gen,
                           device=dev, dtype=torch.int8)
    little = parent[:1024, :1024].contiguous()
    errs = []
    for x, rows, cols, reps in ((parent, 1024, 2048, 1),
                                (parent, 2048, 1024, 1),
                                (little, 256, 512, 2)):
        errs.append(_equal("tile_read", f"{x.shape[0]}^2 ({rows}, {cols})",
                           probes.dma_chunk_checksum(x, rows, cols, reps),
                           probes.dma_chunk_checksum_ref(x, rows, cols,
                                                         reps)))
    out["tile_read"] = _tool_timed(
        "tile_read", "65536^2 int8, (1024, 2048) chunks, 1 rep",
        lambda: probes.dma_chunk_checksum(parent, 1024, 2048, 1),
        lambda: probes.dma_chunk_checksum_ref(parent, 1024, 2048, 1), None,
        *bound_ms(nbytes(parent) + 4, 0.0, PEAK_FFMA_FLOPS), max(errs))
    del parent

    # smem_copy: the reading's 4 slabs an SM, and one slab
    n = CHECK_ITERS["smem_copy"]
    errs = []
    for rows in (4 * probes.SLAB * sms // 2048, probes.SLAB // 2048):
        xv = torch.randint(-128, 128, (rows, 2048), generator=gen,
                           device=dev, dtype=torch.int8)
        errs.append(_equal("smem_copy", f"({rows}, 2048) n={n}",
                           probes.vmem_copy(xv, n),
                           probes.vmem_copy_ref(xv, n)))
    xv = torch.ones((4 * probes.SLAB * sms // 2048, 2048), device=dev,
                    dtype=torch.int8)
    b_ms, b_by = bound_ms(2 * nbytes(xv), 0.0, PEAK_FFMA_FLOPS)
    if derived["smem"]:   # shared memory's traffic at the derived rate
        b_ms = max(b_ms, 1e3 * 4.0 * nbytes(xv) * n
                   / (derived["smem"] * 1e9))
    out["smem_copy"] = _tool_timed(
        "smem_copy", f"{tuple(xv.shape)} n={n}",
        lambda: probes.vmem_copy(xv, n),
        lambda: probes.vmem_copy_ref(xv, n),
        lambda: torch.bitwise_xor(xv, probes._t8(n - 1)), b_ms, "bytes",
        max(errs))

    # load_latency: the reading's 2^20 sources of 32 x 128, and 3 of
    # 8 x 2,048; both loops
    n = CHECK_ITERS["load_latency"]
    errs = []
    for rows, cols, nsrc in ((32, 128, 1 << 20), (8, 2048, 3)):
        xl = torch.randint(-128, 128, (rows * nsrc, cols), generator=gen,
                           device=dev, dtype=torch.int8)
        for load in (True, False):
            errs.append(_equal(
                "load_latency", f"{rows}x{cols} nsrc={nsrc} load={load}",
                probes.dma_latency_sum(xl, rows, n, load),
                probes.dma_latency_sum_ref(xl, rows, n, load)))
    xl = torch.ones((32 << 20, 128), device=dev, dtype=torch.int8)
    out["load_latency"] = _tool_timed(
        "load_latency", f"32x128 nsrc=2^20 n={n}",
        lambda: probes.dma_latency_sum(xl, 32, n),
        lambda: probes.dma_latency_sum_ref(xl, 32, n), None, None, None,
        max(errs))

    # add_one: the dispatch probe's (8, 256) tile and a ragged one
    err = 0.0
    for shape in ((8, 256), (3, 1001)):
        xa = (torch.rand(shape, generator=gen, device=dev) * 600
              - 300).to(torch.bfloat16)
        err = max(err, _equal("add_one", str(shape),
                              dispatch_probe.add_one(xa),
                              dispatch_probe.add_one_ref(xa)))
    xa = torch.ones((8, dispatch_probe.D), device=dev, dtype=torch.bfloat16)
    out["add_one"] = _tool_timed(
        "add_one", "(8, 256) bf16", lambda: dispatch_probe.add_one(xa),
        lambda: dispatch_probe.add_one_ref(xa), lambda: torch.add(xa, 1),
        *bound_ms(2 * nbytes(xa), xa.numel(), PEAK_FFMA_FLOPS), err,
        graph=True)
    torch.cuda.empty_cache()
    return out


def keep_freed_host_memory() -> None:
    """glibc's malloc hands every freed block above its mmap threshold back
    to the kernel, so each new large CPU tensor of the parities' CPU sides
    (fresh activations, gradients, casts and optimizer temporaries, the same
    sizes step after step) first pays page faults on zeroed pages. Serve
    every size from the heap and keep what is freed: the same arithmetic
    without that repeated work, for a few GB more of host memory at the
    peak (printed at the end)."""
    libc = ctypes.CDLL("libc.so.6")
    m_trim_threshold, m_mmap_max = -1, -4
    if not (libc.mallopt(m_mmap_max, 0)
            and libc.mallopt(m_trim_threshold, 2**31 - 1)):
        raise RuntimeError("mallopt refused the host allocator's settings")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    keep_freed_host_memory()
    start = time.perf_counter()
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    build_s = _build.build_all()
    print(f"build: {build_s:.1f} s")
    logged = set()
    for name, kernel in _build.KERNELS.items():
        if kernel.source in logged:     # one library for its kernels
            continue
        logged.add(kernel.source)
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {kernel.source}: {line.strip()}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    # the tooling path: the probes, the dispatch probe and the A/B protocol
    # as a user runs them, then each probe kernel against its plain version
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tool_launches = tooling_path(pathlib.Path(tmp))
    checks = check_tooling(gen)
    print(f"tooling: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print_fat_tiles()
    checks.update({spec["name"]: check_kernel(spec, gen) for spec in KERNELS})
    print(f"ladder kernels: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for spec in SERVE_KERNELS:
        checks[spec["name"]] = SERVE_CHECKS[spec["name"]](gen)
    checks.update(check_flash_train(gen))
    print(f"serving and training kernels: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    checks[MOE_KERNEL["name"]] = check_grouped_gemm(gen)
    checks[SPLIT_KERNEL["name"]] = check_split(gen)
    print(f"grouped_gemm: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    checks.update(check_grouped_backward(gen))
    print(f"grouped GEMM backward: {time.perf_counter() - t0:.1f} s")

    _build.reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        main_path(pathlib.Path(tmp))
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"ladder path: {time.perf_counter() - t0:.1f} s, "
          f"launches {launches}")
    missing = [s["name"] for s in KERNELS if launches[s["name"]] == 0]
    if missing:
        raise AssertionError(f"ladder path never launched {missing}")
    split_rungs = launches["fp32_gemm_nt"] + launches["fp32_gemm_nn"]
    if launches["split_bf16"] != 2 * split_rungs:
        raise AssertionError(f"ladder path: {launches['split_bf16']} "
                             f"split_bf16 launches for {split_rungs} of "
                             "fp32_gemm_nt and fp32_gemm_nn")
    print(f"ladder path: split_bf16 {launches['split_bf16']} launches, two "
          f"for each of fp32_gemm_nt's {launches['fp32_gemm_nt']} and "
          f"fp32_gemm_nn's {launches['fp32_gemm_nn']}")

    # each serving kernel's count: its launches summed over the serve
    # paths, each path's counts read just after it
    launches.update({s["name"]: 0 for s in SERVE_KERNELS})
    for path in SERVE_PATHS:
        gen.manual_seed(0)
        t0 = time.perf_counter()
        path_launches = serve_path(gen, path)
        print(f"{path}: {time.perf_counter() - t0:.1f} s")
        for spec in SERVE_KERNELS:
            launches[spec["name"]] += path_launches[spec["name"]]
    launches[MOE_KERNEL["name"]] = launches[SPLIT_KERNEL["name"]] = 0
    for path in MOE_SERVE_PATHS:
        gen.manual_seed(0)
        t0 = time.perf_counter()
        path_launches = serve_moe_path(gen, path)
        print(f"{path}: {time.perf_counter() - t0:.1f} s")
        for spec in SERVE_KERNELS + [MOE_KERNEL, SPLIT_KERNEL]:
            launches[spec["name"]] += path_launches[spec["name"]]
    gen.manual_seed(1)
    t0 = time.perf_counter()
    parity(gen)
    print(f"parity: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        launches.update(train_path(pathlib.Path(tmp)))
    print(f"training path: {time.perf_counter() - t0:.1f} s")
    gen.manual_seed(2)
    t0 = time.perf_counter()
    train_parity(gen)
    print(f"train parity: {time.perf_counter() - t0:.1f} s")

    # the MoE training paths: each count summed over T-moe and QLoRA, each
    # path's counts read just after it
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        moe_launches = [train_moe_path(pathlib.Path(tmp))]
    print(f"T-moe: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    moe_launches.append(qlora_path())
    print(f"QLoRA: {time.perf_counter() - t0:.1f} s")
    for path_launches in moe_launches:
        for spec in (TRAIN_KERNELS + [MOE_KERNEL, SPLIT_KERNEL]
                     + MOE_BWD_KERNELS):
            launches[spec["name"]] += path_launches.get(spec["name"], 0)
    missing = [s["name"] for s in MOE_BWD_KERNELS if not launches[s["name"]]]
    if missing:
        raise AssertionError(f"the MoE training paths never launched "
                             f"{missing}")
    gen.manual_seed(4)
    t0 = time.perf_counter()
    train_moe_parity(gen)
    print(f"MoE train parity: {time.perf_counter() - t0:.1f} s")
    print(f"chip_smoke: {time.perf_counter() - start:.1f} s in all, host "
          f"peak {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6:.1f}"
          " GB")

    kernels = []
    launches.update(tool_launches)
    for spec in (KERNELS + SERVE_KERNELS + TRAIN_KERNELS
                 + [MOE_KERNEL, SPLIT_KERNEL] + MOE_BWD_KERNELS
                 + TOOL_KERNELS):
        r = checks[spec["name"]]
        kernels.append({
            "name": spec["name"], "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"], "function": spec["function"],
            "launches": launches[spec["name"]],
            "max_abs_err": r["max_abs_err"],
            "max_abs_vs_plain": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
