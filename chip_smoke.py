#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero before the last line):

1. the card: ``nvidia-smi`` name and power limit, CUDA and torch versions;
2. build every kernel under ``how_to_optimize_gemm_tpu_torch/csrc`` with
   nvcc (one process per source, all started together), with ptxas's
   register and spill counts;
3. each ladder kernel against its plain PyTorch version on the card, at
   M=N=K=4096 and at an unaligned shape: the int8 kernels' outputs must
   be EQUAL, the bf16 and W4A16 kernels' within W4A16_REL and the FFMA
   kernels' (rungs 16, 04, 03/03b, 02 and the naive rung 00) within
   FP32_REL of max |plain| (fp32 sums in another order),
   and every output under its rung's gate_rel against an fp64 oracle on
   the card; then its time at 4096 beside the plain version's, the
   library call's (where one PyTorch call computes the same function:
   ``torch._int_mm`` and the epilogue for int8, the vendor bars 01b and
   01 for the bf16 and fp32 kernels) and the card's bound at the peak of
   the kernel's type (int8; bf16 for bf16 and W4A16; for fp32 the fastest
   route that meets gate 1e-4, 3xTF32 at a third of the TF32 peak, with
   the FFMA ceiling printed beside it);
4. each serving kernel against its plain version at the Llama-2-7B
   shapes the serve paths give it (``kv_update`` and ``paged_kv_update``
   on each row kind: bf16 values, int8 values and fp32 scales; the paged
   attention kernels over a shuffled block table, pages of 128 (bf16) and
   384 (KV8); ``flash_attention`` at the 7B prefill, B 4 x 32 heads of
   128 at S = T = 4,096 causal, at 2,048 and at 1,024) and at ragged
   shapes (EQUAL
   for w4a8_gemm_noc, w4a8_gemv_fq, kv_update, paged_kv_update and
   int8_gemm_noc; within W4A16_REL x max |y| for w4a16_gemm_noc and
   w4a16_gemv, whose fp32 sums run in another order; within atol 2e-3 for
   the four decode attention kernels; for flash_attention, every row
   within FLASH_ULPS bf16 ulps of its own max |plain|, against its plain
   version at the kernel's 64-key tiles, at 4,096 and 2,048 on transposed
   (B, S, H, D) views as the model passes them, at 1,024, and on GQA rep
   4, D 64, S = 700 of T = 1,000, non-causal and T = 9,000; the same rule
   must refuse the plain version with one key tile skipped), timed as
   CUDA-graph replays beside its plain version, the
   library call (or null where no single PyTorch call computes the same
   function) and its bound; each paged attention kernel also beside the
   contiguous kernel on the same logical cache;
5. the ladder's main path, with every launch count set to 0 just before
   it: the sweep driver on rungs 06v, 06, 14, 07b, 01, 01b, 04, 05, 07,
   15, 16, 00, 02, 03 and 03b at p = 1024 (fp64 host oracle), 2048 and
   4096 (fp64 device check), writing ``.m`` files to a temporary
   directory and printing the ``p gflops diff`` rows, then the headline
   bench's JSON line (the int8 rungs of the top-level ``bench.py``), then
   the driver's CLI, ``--new 03_pallas_k_blocked --old 02_pallas_mn_tile
   --roofline --trace`` at p = 2048, whose per-kernel device profile of
   each rung must name that rung's hand kernel and no other. Every ladder
   kernel must have been launched;
6. the serving paths, each with every launch count set to 0 just before
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
   one decode step at the same width.
   Each model is freed before the next one loads;
7. parity at full width: the same engine at Llama-2-7B width with 2
   layers, on the same weights and 2 prompts (100 and 128 tokens, so the
   admission prefill runs at m = 2 x 128 = 256 and takes the prefill
   kernels), teacher-forced on the card and on the CPU, both on the
   kernel routes (the CPU through the kernels' plain versions), comparing
   the logits of the prefill and of 8 decode steps, for fp32, W4A8, int8
   and int4 weights, for W4A8 weights over the KV8 cache, for W4A8
   weights over a paged bf16 pool (pages of 128) and a paged KV8 pool
   (pages of 384), and "w4a8 long": prompts of 400 and 512 tokens, so the
   admission runs at s = 512 and takes ``flash_attention`` (on the CPU its
   plain version). The card
   side runs with every launch count set to 0 just before it and must
   launch every kernel its serve path launches. Float32 ops summed in
   another order differ by about 1e-6 relative, and the model amplifies
   that (bf16 cache and p roundings; activation and KV quantization move
   logits by a few %), so the bound is 3x what a 1e-6 relative
   perturbation of the embeddings does on the CPU in the same run. The
   CPU's default routes
   (the reference's eager attention, which rounds q to bf16) are printed
   beside them;
8. one ``{"kernels": [...]}`` line (23 kernels), the card's line again,
   and last
   ``{"ok": true, "device": {...}}``.

Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from how_to_optimize_gemm_tpu_torch import _build, bench, convert
from how_to_optimize_gemm_tpu_torch.harness import driver, mfile
from how_to_optimize_gemm_tpu_torch.harness.driver import run_sweep
from how_to_optimize_gemm_tpu_torch.harness.parameters import SweepConfig
# H100 SXM data sheet: dense int8 and bf16 tensor-core peaks, HBM3
# bandwidth. fp32 at the rungs' gate (1e-4): the fastest route that meets
# it is a 3xTF32 split on the tensor cores, a third of the 495 TFLOP/s
# TF32 peak (plain TF32 does not meet it); FFMA tops out at 67 TFLOP/s.
from how_to_optimize_gemm_tpu_torch.harness.profiling import (
    PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_FFMA_FLOPS, PEAK_FP32_FLOPS,
    PEAK_INT8_OPS)
from how_to_optimize_gemm_tpu_torch.models import llama
from how_to_optimize_gemm_tpu_torch.ops import (attention, decode_attention,
                                               int4, int8, k_blocked,
                                               kv_update, mn_tile, naive,
                                               paged_attention, registry,
                                               tuned, vendor)
from how_to_optimize_gemm_tpu_torch.parallel import serving
from how_to_optimize_gemm_tpu_torch.utils.matrices import make_abc
from how_to_optimize_gemm_tpu_torch.utils.timing import (time_calls,
                                                         time_chained)

PEAKS = {"int8": PEAK_INT8_OPS, "bf16": PEAK_BF16_FLOPS,
         "fp32": PEAK_FP32_FLOPS}
P_FULL = 4096
MAIN_RUNGS = ("06v_xla_int8", "06_pallas_int8", "14_packed_alias_int8",
              "07b_pallas_w4a8", "01_xla_fp32", "01b_xla_bf16",
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
# the FFMA kernels vs their plain version: one fmaf chain over K against
# cuBLAS's fp32 order, relative to max |y|
FP32_REL = 1e-5

SRC = "how_to_optimize_gemm_tpu_torch/csrc/"
# Each kernel with the rung whose prepare/effective give its operands, its
# tolerance against its plain version (relative to max |plain|; 0: EQUAL)
# and the peak its bound takes.
KERNELS = [
    dict(name="int8_gemm_nn", source=SRC + "int8_gemm_nn.cu",
         replaces="how_to_optimize_gemm_tpu/ops/pallas_int8.py:29",
         function="pallas_int8._kernel (mmult_q, rung 06)",
         rung="06_pallas_int8", wrapper=int8.mmult_q,
         plain=int8.mmult_q_ref,
         library=lambda qa, sa, qb, sb, c: int8.dequant_epilogue(
             torch._int_mm(qa, qb), sa, sb, c),
         unaligned=(1000, 1032, 1100), tol=0.0, peak="int8"),
    dict(name="int8_gemm_nt", source=SRC + "int8_gemm_nt.cu",
         replaces="how_to_optimize_gemm_tpu/ops/pallas_int8.py:212",
         function="pallas_int8._kernel_bt + _kernel_bt_1k :259 "
                  "(mmult_q_bt, rung 14)",
         rung="14_packed_alias_int8", wrapper=int8.mmult_q_bt,
         plain=int8.mmult_q_bt_ref,
         library=lambda qa, sa, qbt, sb, c: int8.dequant_epilogue(
             torch._int_mm(qa, qbt.t()), sa, sb, c),
         unaligned=(1000, 1032, 1100), tol=0.0, peak="int8"),
    dict(name="w4a8_gemm", source=SRC + "w4a8_gemm.cu",
         replaces="how_to_optimize_gemm_tpu/ops/pallas_int4.py:342",
         function="pallas_int4._kernel_w4a8 + _decode_w4 :36 "
                  "(mmult_q_w4a8, rung 07b)",
         rung="07b_pallas_w4a8", wrapper=int4.mmult_q_w4a8,
         plain=int4.mmult_q_w4a8_ref,
         library=None,   # no single PyTorch call decodes int4
         unaligned=(1000, 1032, 3584), tol=0.0, peak="int8"),
    dict(name="bf16_gemm_nt", source=SRC + "bf16_gemm_nt.cu",
         replaces="how_to_optimize_gemm_tpu/ops/pallas_tuned.py:178",
         function="pallas_tuned._kernel_bf16_bt (mmult_bf16_bt, rung 15)",
         rung="15_packed_alias_bf16", wrapper=tuned.mmult_bf16_bt,
         plain=tuned.mmult_bf16_bt_ref,
         library=lambda a16, bt16, c: vendor.mmult_bf16(a16, bt16.t(), c),
         unaligned=(1000, 1032, 1100), tol=W4A16_REL, peak="bf16"),
    dict(name="fp32_gemm_nt", source=SRC + "fp32_gemm_nt.cu",
         replaces="how_to_optimize_gemm_tpu/ops/pallas_tuned.py:160",
         function="pallas_tuned._make_kernel_bt(HIGHEST) (mmult_fp32_bt, "
                  "rung 16)",
         rung="16_packed_alias_fp32", wrapper=tuned.mmult_fp32_bt,
         plain=tuned.mmult_fp32_bt_ref,
         library=lambda a, bt, c: vendor.mmult(a, bt.t(), c),
         unaligned=(1000, 1032, 1100), tol=FP32_REL, peak="fp32"),
    dict(name="w4a16_gemm", source=SRC + "w4a16_gemm.cu",
         replaces="how_to_optimize_gemm_tpu/ops/pallas_int4.py:55",
         function="pallas_int4._kernel + _decode_w4 :36 (mmult_q, rung 07)",
         rung="07_pallas_int4", wrapper=int4.mmult_q, plain=int4.mmult_q_ref,
         library=None,   # no single PyTorch call decodes int4
         unaligned=(1000, 1032, 3584), tol=W4A16_REL, peak="bf16"),
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
         unaligned=(1000, 1032, 1100), tol=FP32_REL, peak="fp32"),
    # the rungs below 04, on the CUDA cores; an unaligned shape whose K
    # and N rows are not 16-byte multiples (03's wrapper pads them)
    dict(name="naive_gemm", source=SRC + "naive_gemm.cu",
         replaces="how_to_optimize_gemm_tpu/ops/naive_vpu.py:21",
         function="naive_vpu.mmult (plain JAX, K rank-1 updates; rung 00)",
         rung="00_naive_vpu", wrapper=naive.mmult, plain=naive.naive_ref,
         library=vendor.mmult, unaligned=(999, 1030, 1101), tol=FP32_REL,
         peak="fp32"),
    dict(name="fp32_gemm_mn_tile", source=SRC + "fp32_gemm_mn_tile.cu",
         replaces="how_to_optimize_gemm_tpu/ops/pallas_mn_tile.py:24",
         function="pallas_mn_tile._kernel (mmult, rung 02)",
         rung="02_pallas_mn_tile", wrapper=mn_tile.mmult,
         plain=mn_tile.mn_tile_ref, library=vendor.mmult,
         unaligned=(999, 1030, 1101), tol=FP32_REL, peak="fp32"),
    dict(name="fp32_gemm_k_blocked", source=SRC + "fp32_gemm_k_blocked.cu",
         replaces="how_to_optimize_gemm_tpu/ops/pallas_k_blocked.py:31",
         function="pallas_k_blocked._kernel (mmult, rungs 03 and 03b)",
         rung="03_pallas_k_blocked", wrapper=k_blocked.mmult,
         plain=k_blocked.k_blocked_ref, library=vendor.mmult,
         unaligned=(999, 1030, 1101), tol=FP32_REL, peak="fp32"),
]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()


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


def check_kernel(spec: dict, gen: torch.Generator) -> dict:
    """Compare with the plain version at two shapes; time at P_FULL."""
    name = spec["name"]
    rung = registry.get(spec["rung"])
    result = {"max_abs_err": 0.0}
    for m, n, k in (spec["unaligned"], (P_FULL, P_FULL, P_FULL)):
        a, b, c = make_abc(gen, m, n, k, "cuda")
        prepared = rung.prepare(a, b)
        # the kernel's operands: 07b's and 07's prepare add kdim
        ops = [x for x in prepared if isinstance(x, torch.Tensor)]
        out = spec["wrapper"](*ops, c.clone())
        ref = spec["plain"](*ops, c)
        torch.cuda.synchronize()
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
    if spec["peak"] == "fp32":
        ffma_ms = bound(ops, P_FULL, P_FULL, P_FULL, PEAK_FFMA_FLOPS)[0]
        ffma = f"; the FFMA ceiling {ffma_ms:.4f}"
    tops = 2.0 * P_FULL ** 3 / result["ms"] * 1e-9
    print(f"{name} p={P_FULL}: {result['ms']:.4f} ms = {tops:.1f} Tops/s "
          f"(plain {result['plain_ms']:.4f}, library {lib_ms}, bound "
          f"{bound_ms:.4f} by {bound_by} at the {spec['peak']} peak{ffma})")
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
SLOTS = 4
DECODE_ATOL = 2e-3   # decode_attention vs its plain version (sum order, exp)
# flash_attention vs its plain version at the kernel's 64-key tiles: in
# every row, max |kernel - plain| within FLASH_ULPS bf16 ulps of that row's
# max |plain| (attention.bf16_row_ulps). fp32 sums in another order can
# flip the bf16 rounding of p or of an output by one ulp; one 64-key tile
# skipped reads tens of ulps, and the check plants that fault to show it
FLASH_ULPS = 2.0
# card vs CPU logits on the same routes: at most PARITY_SENSITIVITY x the
# CPU's own response to a PERTURB relative perturbation of the embeddings
PARITY_SENSITIVITY = 3.0
PERTURB = 1e-6

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
          err: float) -> dict:
    """Time the kernel, its plain version and the library call; print.

    The kernel and the library call are timed as CUDA-graph replays (the
    device's time per call); the kernel also as called from Python one
    after another, which is what the serving path pays when the host,
    not the device, sets the pace. The plain version synchronizes (it
    reads lengths on the host), so it is timed from Python."""
    r = dict(max_abs_err=err, ms=time_calls(kernel, graph=True) * 1e3,
             plain_ms=time_calls(plain, inner_iters=3) * 1e3,
             library_ms=(None if library is None
                         else time_calls(library, graph=True) * 1e3),
             bound_ms=b_ms, bound_by=b_by)
    eager_ms = time_calls(kernel) * 1e3
    lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
    print(f"{name} {shape}: max|kernel - plain| = {err}; {r['ms']:.4f} ms "
          f"(called from Python {eager_ms:.4f}; plain {r['plain_ms']:.4f}, "
          f"library {lib}, bound {b_ms:.4f} by {b_by})")
    return r


def _equal(name: str, shape: str, out, ref) -> float:
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    if not torch.equal(out, ref):
        raise AssertionError(f"{name} {shape}: differs from its plain "
                             f"version by {err}")
    return err


def check_w4a8_noc(gen: torch.Generator) -> dict:
    """Kernel 2 at the prefill widths: M = 4 slots x a 256-token bucket."""
    results = []
    for k, n in ((4096, 11008), (11008, 4096)):
        m = SLOTS * 256
        x = torch.randn((m, k), generator=gen, device="cuda")
        w = torch.randn((k, n), generator=gen, device="cuda")
        qa, sa, packed, sw, _ = int4.prepare_w4a8(x, w)
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
    return results[0]


def check_w4a8_gemv(gen: torch.Generator) -> dict:
    """Kernel 3 at the decode widths of every 7B linear."""
    results = []
    for k, n in ((4096, 11008), (4096, 4096), (11008, 4096)):
        w = torch.randn((k, n), generator=gen, device="cuda")
        _, _, packed, sw, _ = int4.prepare_w4a8(w[:1], w)
        for m in (4, 1):
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
    int4 path's shapes and a ragged one. No single PyTorch call decodes
    int4, so the library time is null."""
    results = []
    for m, k, n in shapes:
        args = _w4a16_args(gen, m, k, n)
        shape = f"m={m} {k}->{n}"
        err = _close(name, shape, int4.mmult_q_noc(*args),
                     int4.mmult_q_noc_ref(*args))
        b = bound_ms(nbytes(*args) + 4 * m * n, 2.0 * m * n * k,
                     PEAK_BF16_FLOPS)
        results.append(timed(name, shape, lambda: int4.mmult_q_noc(*args),
                             lambda: int4.mmult_q_noc_ref(*args), None,
                             *b, err))
    return results[0]


def check_decode_attention_q8(gen: torch.Generator) -> dict:
    """decode_attention_q8 over a 7B-width KV8 cache (kvh 32, d 128), a
    GQA width (kvh 8, rep 4) and a ragged one (kvh 3, rep 2, d 64,
    T = 1000, one chunk of 1000), slots of ragged lengths. No single
    PyTorch call attends over an int8 cache with per-(token, head)
    scales, so the library time is null."""
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
        out = decode_attention.decode_attention_q8(q, *cache, lengths)
        ref = decode_attention.decode_attention_q8_ref(q, *cache, lengths)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if not err < DECODE_ATOL:
            raise AssertionError(f"decode_attention_q8 {shape}: differs "
                                 f"from its plain version by {err}")
        live = sum(lens)
        b_ms = bound_ms(nbytes(q, lengths) + 4 * q.numel()
                        + 2 * live * kvh * (d + 4),
                        4.0 * h * d * live, PEAK_BF16_FLOPS)
        results.append(timed(
            "decode_attention_q8", shape,
            lambda: decode_attention.decode_attention_q8(q, *cache, lengths),
            lambda: decode_attention.decode_attention_q8_ref(q, *cache,
                                                             lengths),
            None, *b_ms, err))
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
    beside it. No single PyTorch call reads through a block table, so
    the library time is null."""
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
        print(f"{name} {shape}: the contiguous kernel on the same cache "
              f"(T={t}) {c_ms:.4f} ms, paged {results[-1]['ms']:.4f} ms")
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
    the last 64 queries with one 64-key tile before them (at T / 2)
    skipped, held to the true output's rows. The queries are the last S of
    T positions, so dropping the tile's keys from k and v leaves every
    other key visible to them as before."""
    bk = attention.KERNEL_BLOCK
    t = k.shape[2]
    j0 = t // 2 // bk * bk
    keep = torch.cat([torch.arange(j0, device=k.device),
                      torch.arange(j0 + bk, t, device=k.device)])
    faulty = attention.flash_attention_ref(
        q[:, :, -bk:], k[:, :, keep], v[:, :, keep], causal=True, bk=bk)
    return float(attention.bf16_row_ulps(faulty, ref[:, :, -bk:]).max())


def check_flash_attention(gen: torch.Generator) -> dict:
    """flash_attention against its plain version at the kernel's 64-key
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
                q, k, v, causal=causal, bk=attention.KERNEL_BLOCK)
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
    step_ms = time_calls(lambda: eng.step(tok, pos, **kw), inner_iters=8,
                         outer_repeats=3, warmup=2) * 1e3
    weight_bytes = sum(nbytes(t) for layer in params["layers"]
                       for lin in layer.values() if isinstance(lin, dict)
                       for t in lin.values())
    weight_bytes += nbytes(params["lm_head"]["fp32_w"])
    print(f"{path}: decode step {step_ms:.3f} ms at 4 slots, position 512 "
          f"(weights {weight_bytes / 1e9:.3f} GB: bound "
          f"{1e3 * weight_bytes / PEAK_BYTES:.3f} ms)")
    stats.update(step_ms=step_ms, steps=steps, peak_gb=peak_gb)
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


def parity(gen: torch.Generator) -> None:
    """The engine at 7B width with 2 layers, on the card and on the CPU,
    on the same weights and tokens, for each of ``PARITY``; the card side
    runs with every launch count set to 0 just before it and must launch
    each kernel of its row."""
    for label, kind, cache_kind, kernels, paged, lens in PARITY:
        rng = np.random.default_rng(0)
        prompts = [rng.integers(1, 30000, n).tolist() for n in lens]
        forced = rng.integers(1, 30000, (2, 8)).astype(np.int32)
        cfg = dataclasses.replace(CFG_7B, n_layers=2, weight_kind=kind)
        params = llama.init_params(gen, cfg, "cuda")
        cpu = convert.to_device(params, "cpu")
        noise = torch.randn(cpu["embed"].shape,
                            generator=torch.Generator().manual_seed(1))
        sides = {"cuda": (params, "cuda", None),
                 "cpu": (cpu, "cpu", True),
                 "cpu perturbed": ({**cpu, "embed": cpu["embed"]
                                    * (1 + PERTURB * noise)}, "cpu", True),
                 "cpu eager": (cpu, "cpu", None)}
        out = {}
        for side, (p, dev, routes) in sides.items():
            if kind == "fp32" and side == "cpu eager":
                continue
            eng = serving.ServingEngine(cfg, p, batch_slots=2, device=dev,
                                        cache_kind=cache_kind,
                                        kernel_routes=routes, **paged)
            _build.reset_launches()
            out[side] = teacher_forced(eng, prompts, forced)
            if dev == "cuda":
                missing = [k for k in kernels if _build.LAUNCHES[k] == 0]
                if missing:
                    raise AssertionError(f"parity {label}: the card side "
                                         f"never launched {missing}")
            del eng
        ref = out["cpu"]
        scale = float(ref.abs().max())
        diffs = {}
        for side in out:
            if side == "cpu":
                continue
            other = out[side]
            diffs[side] = float((other - ref).abs().max())
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
        del params, cpu
        torch.cuda.empty_cache()

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    build_s = _build.build_all()
    print(f"build: {build_s:.1f} s")
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    checks = {spec["name"]: check_kernel(spec, gen) for spec in KERNELS}
    for spec in SERVE_KERNELS:
        checks[spec["name"]] = SERVE_CHECKS[spec["name"]](gen)

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
    gen.manual_seed(1)
    t0 = time.perf_counter()
    parity(gen)
    print(f"parity: {time.perf_counter() - t0:.1f} s")

    kernels = []
    for spec in KERNELS + SERVE_KERNELS:
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
