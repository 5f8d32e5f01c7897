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
   M=N=K=4096 and at an unaligned shape: the outputs must be EQUAL, and
   under gate_rel 1e-4 against an fp64 oracle on the card; then its time
   at 4096 beside the plain version's, the library call's (where one
   PyTorch call computes the same function) and the card's bound;
4. each serving kernel against its plain version at the Llama-2-7B
   shapes the serve path gives it (EQUAL for w4a8_gemm_noc, w4a8_gemv_fq
   and kv_update; within atol 2e-3 for decode_attention), timed beside
   its plain version, the library call and its bound;
5. the ladder's main path, with every launch count set to 0 just before
   it: the sweep driver on rungs 06v, 06, 14 and 07b at p = 1024 (fp64
   host oracle), 2048 and 4096 (fp64 device check), writing ``.m`` files
   to a temporary directory and printing the ``p gflops diff`` rows, then
   the headline bench's JSON line. Every ladder kernel must have been
   launched;
6. the serving path, with every launch count set to 0 just before it:
   ``ServingEngine`` on Llama-2-7B W4A8 (32 layers, random weights from
   seed 0), 4 slots, greedy, window 8, serving 8 requests of 32-256
   prompt tokens and 32 new tokens each; every request must get its 32
   tokens and every serving kernel must have been launched. Then the
   time of one decode step at the same width;
7. parity at full width: the same engine at Llama-2-7B width with 2
   layers, on the same weights and 2 prompts, teacher-forced on the card
   and on the CPU, both on the kernel routes (the CPU through the
   kernels' plain versions), comparing the logits of the prefill and of
   8 decode steps, for fp32 and for W4A8 weights. Float32 ops summed in
   another order differ by about 1e-6 relative, and the model amplifies
   that (bf16 cache and p roundings; W4A8 activation quantization moves
   logits by a few %), so the bound is 3x what a 1e-6 relative
   perturbation of the embeddings does on the CPU in the same run. The
   CPU's default routes (the reference's eager attention, which rounds q
   to bf16) are printed beside them;
8. one ``{"kernels": [...]}`` line, the card's line again, and last
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
from how_to_optimize_gemm_tpu_torch.harness import mfile
from how_to_optimize_gemm_tpu_torch.harness.driver import run_sweep
from how_to_optimize_gemm_tpu_torch.harness.parameters import SweepConfig
from how_to_optimize_gemm_tpu_torch.models import llama
from how_to_optimize_gemm_tpu_torch.ops import (decode_attention, int4, int8,
                                               kv_update, registry)
from how_to_optimize_gemm_tpu_torch.parallel import serving
from how_to_optimize_gemm_tpu_torch.utils.matrices import make_abc
from how_to_optimize_gemm_tpu_torch.utils.timing import (time_calls,
                                                         time_chained)

# H100 SXM data sheet: dense int8 and bf16 tensor-core peaks, HBM3
# bandwidth.
PEAK_INT8_OPS = 1.979e15
PEAK_BF16_FLOPS = 0.989e15
PEAK_BYTES = 3.35e12
GATE_REL = 1e-4
P_FULL = 4096
MAIN_RUNGS = ("06v_xla_int8", "06_pallas_int8", "14_packed_alias_int8",
              "07b_pallas_w4a8")

SRC = "how_to_optimize_gemm_tpu_torch/csrc/"
# Each kernel with the rung whose prepare/effective give its operands.
KERNELS = [
    dict(name="int8_gemm_nn", source=SRC + "int8_gemm_nn.cu",
         replaces="how_to_optimize_gemm_tpu/ops/pallas_int8.py:29",
         function="pallas_int8._kernel (mmult_q, rung 06)",
         rung="06_pallas_int8", wrapper=int8.mmult_q,
         plain=int8.mmult_q_ref,
         library=lambda qa, sa, qb, sb, c: int8.dequant_epilogue(
             torch._int_mm(qa, qb), sa, sb, c),
         unaligned=(1000, 1032, 1100)),
    dict(name="int8_gemm_nt", source=SRC + "int8_gemm_nt.cu",
         replaces="how_to_optimize_gemm_tpu/ops/pallas_int8.py:212",
         function="pallas_int8._kernel_bt + _kernel_bt_1k :259 "
                  "(mmult_q_bt, rung 14)",
         rung="14_packed_alias_int8", wrapper=int8.mmult_q_bt,
         plain=int8.mmult_q_bt_ref,
         library=lambda qa, sa, qbt, sb, c: int8.dequant_epilogue(
             torch._int_mm(qa, qbt.t()), sa, sb, c),
         unaligned=(1000, 1032, 1100)),
    dict(name="w4a8_gemm", source=SRC + "w4a8_gemm.cu",
         replaces="how_to_optimize_gemm_tpu/ops/pallas_int4.py:342",
         function="pallas_int4._kernel_w4a8 + _decode_w4 :36 "
                  "(mmult_q_w4a8, rung 07b)",
         rung="07b_pallas_w4a8", wrapper=int4.mmult_q_w4a8,
         plain=int4.mmult_q_w4a8_ref,
         library=None,   # no single PyTorch call decodes int4
         unaligned=(1000, 1032, 3584)),
]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()


def bound(ops, m: int, n: int, k: int):
    """(ms, "bytes" | "operations"): the least time for this work, each
    input read once and the output written once."""
    nbytes = sum(t.numel() * t.element_size() for t in ops)
    nbytes += 2 * 4 * m * n                     # C read, output written
    t_bytes = nbytes / PEAK_BYTES
    t_ops = 2.0 * m * n * k / PEAK_INT8_OPS
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
        ops = prepared[:4]   # 07b's prepare adds kdim, no kernel operand
        out = spec["wrapper"](*ops, c.clone())
        ref = spec["plain"](*ops, c)
        torch.cuda.synchronize()
        max_abs = float((out - ref).abs().max())
        ae, be = rung.effective(prepared)
        oracle = ae.double() @ be.double() + c.double()
        rel = float((out.double() - oracle).abs().max()
                    / oracle.abs().max().clamp_min(1e-30))
        print(f"{name} {m}x{n}x{k}: max|kernel - plain| = {max_abs}, "
              f"rel vs fp64 = {rel:.3e}")
        if max_abs != 0.0 or not rel < GATE_REL:
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
    bound_ms, bound_by = bound(ops, P_FULL, P_FULL, P_FULL)
    result.update(ms=t["wrapper"], plain_ms=t["plain"], bound_ms=bound_ms,
                  bound_by=bound_by, library_ms=lib_ms)
    print(f"{name} p={P_FULL}: {result['ms']:.4f} ms (plain "
          f"{result['plain_ms']:.4f}, library {lib_ms}, bound "
          f"{bound_ms:.4f} by {bound_by})")
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
        for r in host + dev:
            if not (math.isfinite(r.gflops) and r.gflops > 0
                    and r.kernel_rel < GATE_REL):
                raise AssertionError(f"{rung} p={r.p}: bad row {r}")
    record = bench.measure()
    print(json.dumps(record))
    return record


# ------------------------------------------------------------- serving

CFG_7B = llama.llama2_7b("w4a8")
SLOTS = 4
DECODE_ATOL = 2e-3   # decode_attention vs its plain version (sum order, exp)
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
]


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
    """Kernel 4 on one layer's 7B cache, one token per slot: slot 2's row
    lies past T (dropped), slot 3 is masked (kept)."""
    b, t = SLOTS, CFG_7B.max_seq
    shape4 = (CFG_7B.n_kv_heads, CFG_7B.d_head)
    cache = torch.randn((b, t, *shape4), generator=gen,
                        device="cuda").to(torch.bfloat16)
    new = torch.randn((b, 1, *shape4), generator=gen,
                      device="cuda").to(torch.bfloat16)
    pos = torch.tensor([5, 300, t, 1000], dtype=torch.int32, device="cuda")
    mask = torch.tensor([1, 1, 1, 0], dtype=torch.int32, device="cuda")
    got, ref = cache.clone(), cache.clone()
    shape = f"cache {tuple(cache.shape)} bf16"
    err = _equal("kv_update", shape, kv_update.kv_update(got, new, pos, mask),
                 kv_update.kv_update_ref(ref, new, pos, mask))
    written = [i for i in range(b) if mask[i] and 0 <= pos[i] < t]
    rows_b = torch.tensor(written, device="cuda")
    rows_t = pos[rows_b].long()
    vals = new[rows_b, 0]
    b_ms = bound_ms(2 * nbytes(vals) + nbytes(pos, mask), 0.0,
                    PEAK_INT8_OPS)
    return timed("kv_update", shape,
                 lambda: kv_update.kv_update(got, new, pos, mask),
                 lambda: kv_update.kv_update_ref(ref, new, pos, mask),
                 lambda: got.index_put_((rows_b, rows_t), vals), *b_ms, err)


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


SERVE_CHECKS = {"w4a8_gemm_noc": check_w4a8_noc,
                "w4a8_gemv_fq": check_w4a8_gemv,
                "kv_update": check_kv_update,
                "decode_attention": check_decode_attention}


def serve_path(gen: torch.Generator) -> dict:
    """The serving path, launch counts set to 0 just before it and read
    just after; then one decode step's time at the same width."""
    params = llama.init_params(gen, CFG_7B, "cuda")
    eng = serving.ServingEngine(CFG_7B, params, batch_slots=SLOTS,
                                device="cuda")
    reqs = serving.make_requests(8, 32, 32, seed=0, prompt_len_max=256)
    buckets = [eng._bucket(len(r.prompt)) for r in reqs]
    if max(buckets) >= llama.FLASH_MIN_S:
        raise AssertionError(f"a prompt bucket {max(buckets)} would take "
                             "the unported flash route")
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    eng.run(reqs, window=8)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    stats = serving.summarize(reqs, seconds)
    short = [r.uid for r in reqs if len(r.out) != 32 or not r.done]
    if short:
        raise AssertionError(f"requests {short} did not get 32 tokens")
    missing = [s["name"] for s in SERVE_KERNELS
               if launches[s["name"]] == 0]
    if missing:
        raise AssertionError(f"serving path never launched {missing}")
    steps = launches["decode_attention"] // CFG_7B.n_layers
    print(f"serve: prompts {[len(r.prompt) for r in reqs]}, buckets "
          f"{sorted(set(buckets))}")
    print(f"serve: {stats['tokens']} tokens in {seconds:.3f} s = "
          f"{stats['tok_per_s']:.1f} tok/s; TTFT p50 "
          f"{stats['ttft_p50_ms']:.1f} ms max {stats['ttft_max_ms']:.1f} "
          f"ms; decode-only {stats['decode_tok_per_s']:.1f} tok/s")
    print(f"serve: launches {launches}; {steps} decode steps, "
          f"{launches['w4a8_gemv_fq'] / max(steps, 1):.1f} gemv + "
          f"{launches['kv_update'] / max(steps, 1):.1f} kv_update + "
          f"{launches['decode_attention'] / max(steps, 1):.1f} "
          "decode_attention launches per step")
    # one decode step of 4 slots at position 512, timed alone
    tok = torch.ones((SLOTS, 1), dtype=torch.int32, device="cuda")
    pos = torch.full((SLOTS,), 512, dtype=torch.int32, device="cuda")
    step_ms = time_calls(lambda: eng.step(tok, pos), inner_iters=8,
                         outer_repeats=3, warmup=2) * 1e3
    weight_bytes = sum(nbytes(t) for layer in params["layers"]
                       for lin in layer.values() if isinstance(lin, dict)
                       for t in lin.values())
    weight_bytes += nbytes(params["lm_head"]["fp32_w"])
    print(f"serve: decode step {step_ms:.3f} ms at 4 slots, position 512 "
          f"(weights {weight_bytes / 1e9:.3f} GB: bound "
          f"{1e3 * weight_bytes / PEAK_BYTES:.3f} ms)")
    stats.update(step_ms=step_ms, steps=steps)
    print(json.dumps({"serve": stats, "launches": launches}))
    del eng, params
    torch.cuda.empty_cache()
    return launches


def teacher_forced(eng, prompts, forced) -> torch.Tensor:
    """Logits of the engine's admission prefill of ``prompts`` (one per
    slot) and of decode steps fed ``forced`` (slots, steps) tokens ->
    (1 + steps, slots, vocab) on the CPU."""
    reqs = [serving.Request(uid=i, prompt=p, max_new=1)
            for i, p in enumerate(prompts)]
    first = eng._dispatch_prefill(list(enumerate(reqs)))
    rows = [torch.cat([first[s] for s in range(len(prompts))])]
    pos = np.array([len(p) for p in prompts], np.int32)
    for j in range(forced.shape[1]):
        logits = eng.step(eng._tensor(forced[:, j:j + 1]), eng._tensor(pos))
        rows.append(logits[:, -1])
        pos = pos + 1
    return torch.stack(rows).float().cpu()


def parity(gen: torch.Generator) -> None:
    """The engine at 7B width with 2 layers, on the card and on the CPU,
    on the same weights and tokens, for fp32 and for w4a8 weights."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 30000, n).tolist() for n in (40, 64)]
    forced = rng.integers(1, 30000, (2, 8)).astype(np.int32)
    for kind in ("fp32", "w4a8"):
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
                                        kernel_routes=routes)
            out[side] = teacher_forced(eng, prompts, forced)
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
            print(f"parity {kind}: max|{side} - cpu| = {diffs[side]:.4e} "
                  f"(max|logit| {scale:.3f}, rel "
                  f"{diffs[side] / scale:.3e}); greedy agreement "
                  f"{agree:.3f} over {ref.shape[0]} positions x "
                  f"{ref.shape[1]} prompts")
        limit = PARITY_SENSITIVITY * diffs["cpu perturbed"]
        if not (torch.isfinite(out["cuda"]).all()
                and diffs["cuda"] <= limit):
            raise AssertionError(f"parity {kind}: card and CPU logits "
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

    gen.manual_seed(0)
    t0 = time.perf_counter()
    serve_launches = serve_path(gen)
    print(f"serving path: {time.perf_counter() - t0:.1f} s")
    launches.update({s["name"]: serve_launches[s["name"]]
                     for s in SERVE_KERNELS})
    gen.manual_seed(1)
    parity(gen)

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
