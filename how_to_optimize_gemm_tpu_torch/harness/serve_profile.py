"""Where a serving decode step's, or an admission prefill's, time goes on
the card.

    python -m how_to_optimize_gemm_tpu_torch.harness.serve_profile \\
        [--weight-kind w4a8] [--cache-kind bf16] [--layers 32] \\
        [--slots 4] [--pos 512] [--steps 8] [--paged] [--page N] \\
        [--prefill S] [--device cpu]

Builds Llama-2-7B with ``--weight-kind`` weights (random, seed 0) and a
``--cache-kind`` cache (bf16, or int8 for KV8) for ``--slots`` slots,
contiguous or, with ``--paged``, a page pool of ``--page`` tokens a page
(default ``good_page_size``) with every slot's table allocated in order
(the reference's paged-vs-contiguous setup), then times decode steps of
one token per slot at position ``--pos`` (the cache's contents do not
change the work) or, with ``--prefill S``, admission prefills instead:
one dispatch of every slot's S-token prompt from position 0 (causal
self-attention, so ``flash_attention`` at S >= 512), as the engine
admits a full batch at bucket S:

1. wall: the host clock around ``--steps`` steps ending in a
   synchronize, in ms per step;
2. device: ``torch.profiler`` over the same number of steps: the summed
   time of the kernels on the card by name (kernel rows only: the
   operator rows repeat their kernels' time), their count per step, and
   the busy share (kernel time over the unprofiled wall time; tracing
   slows the host);
3. bound: for a decode step, the bytes it must read (the weights, the lm
   head, the live cache rows and, for KV8, their scales) over 3.35 TB/s;
   for a prefill, its operations (every linear's multiply-adds at the
   weights' tensor-core peak, int8 for int8 and W4A8 weights, bf16
   otherwise, and the causal attention's at the bf16 peak).

Prints one JSON line. Runs on the card unless ``--device cpu`` is given;
the CPU runs the kernels' plain versions (kernel routes) and reports no
device time.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from how_to_optimize_gemm_tpu_torch import _build
from how_to_optimize_gemm_tpu_torch.harness.profiling import (
    PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_INT8_OPS)
from how_to_optimize_gemm_tpu_torch.models import llama
from how_to_optimize_gemm_tpu_torch.models.linear import KINDS
from how_to_optimize_gemm_tpu_torch.ops.paged_attention import good_page_size
from how_to_optimize_gemm_tpu_torch.parallel.serving import CACHE_KINDS
from how_to_optimize_gemm_tpu_torch.utils.device import default_device


def step_bytes(params: dict, cfg: llama.LlamaConfig, slots: int,
               pos: int, cache_kind: str = "bf16") -> int:
    """Bytes one decode step must read: every linear's leaves, the lm
    head, and K and V of the live cache rows (bf16: 2 bytes a value;
    KV8: 1 byte a value and a 4-byte scale per row and head)."""
    def size(t):
        return t.numel() * t.element_size()
    n = sum(size(t) for layer in params["layers"] for lin in layer.values()
            if isinstance(lin, dict) for t in lin.values())
    n += size(params["lm_head"]["fp32_w"])
    row = (cfg.d_head * 2 if cache_kind == "bf16" else cfg.d_head + 4)
    n += 2 * cfg.n_layers * slots * (pos + 1) * cfg.n_kv_heads * row
    return n


def prefill_bound_ms(cfg: llama.LlamaConfig, slots: int, s: int) -> float:
    """The least time of one admission prefill of ``slots`` prompts of s
    tokens: the linears' 2 * m * d_in * d_out operations (m = slots * s)
    at the weights' tensor-core peak, plus causal attention's
    4 * d_head * s (s + 1) / 2 per head and slot at the bf16 peak."""
    d, dh = cfg.d_model, cfg.d_head
    per_row = (d * (cfg.n_heads + 2 * cfg.n_kv_heads) * dh
               + cfg.n_heads * dh * d + 3 * d * cfg.d_ff)
    linear_ops = 2.0 * slots * s * per_row * cfg.n_layers
    peak = (PEAK_INT8_OPS if cfg.weight_kind in ("int8", "w4a8")
            else PEAK_BF16_FLOPS)
    attn_ops = (4.0 * dh * s * (s + 1) / 2 * cfg.n_heads * slots
                * cfg.n_layers)
    return 1e3 * (linear_ops / peak + attn_ops / PEAK_BF16_FLOPS)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--weight-kind", default="w4a8", choices=KINDS)
    ap.add_argument("--cache-kind", default="bf16", choices=CACHE_KINDS)
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--pos", type=int, default=512)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--paged", action="store_true",
                    help="a page pool read through a block table")
    ap.add_argument("--page", type=int, default=None,
                    help="tokens a page (default: good_page_size)")
    ap.add_argument("--prefill", type=int, default=None, metavar="S",
                    help="profile admission prefills of S tokens a slot "
                         "instead of decode steps")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    device = default_device(args.device)
    on_card = device.type == "cuda"
    cfg = dataclasses.replace(llama.llama2_7b(args.weight_kind),
                              n_layers=args.layers)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = llama.init_params(gen, cfg, device)
    quantized = args.cache_kind == "int8"
    kw = {}
    if args.paged:
        page = args.page or good_page_size(cfg.n_kv_heads, cfg.d_head,
                                           1 if quantized else 2)
        np_max = -(-cfg.max_seq // page)
        cache = llama.init_paged_kv_cache(cfg, args.slots * np_max + 1, page,
                                          quantized=quantized, device=device)
        kw["table"] = torch.arange(
            1, args.slots * np_max + 1, dtype=torch.int32,
            device=device).reshape(args.slots, np_max)
    else:
        cache = llama.init_kv_cache(cfg, args.slots, quantized=quantized,
                                    device=device)
    if args.prefill:
        s = args.prefill
        tokens = torch.ones((args.slots, s), dtype=torch.int32, device=device)
        pos = torch.zeros(args.slots, dtype=torch.int32, device=device)
        kw.update(write_mask=torch.ones(args.slots, dtype=torch.bool,
                                        device=device),
                  prefill_self=True, logit_idx=pos + s - 1)
    else:
        tokens = torch.ones((args.slots, 1), dtype=torch.int32,
                            device=device)
        pos = torch.full((args.slots,), args.pos, dtype=torch.int32,
                         device=device)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def steps(n):
        for _ in range(n):
            llama.decode_step(params, cfg, cache, tokens, pos,
                              kernel_routes=True, **kw)

    steps(1 if args.prefill else 2)              # warm up, builds kernels
    sync()
    t0 = time.perf_counter()
    steps(args.steps)
    sync()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    _build.reset_launches()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        steps(args.steps)
        sync()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    kernels = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = ev.cuda_time_total
        kernels[ev.key] = (dev_us / 1e3 / args.steps, ev.count / args.steps)
    device_ms = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    if args.prefill:
        bound_ms = prefill_bound_ms(cfg, args.slots, args.prefill)
    else:
        bound_ms = 1e3 * step_bytes(params, cfg, args.slots, args.pos,
                                    args.cache_kind) / PEAK_BYTES
    record = {
        "card": torch.cuda.get_device_name(device) if on_card else "cpu",
        "weights": args.weight_kind, "cache": args.cache_kind,
        "page": cache[0][0].shape[1] if args.paged else None,
        "layers": args.layers, "slots": args.slots,
        "pos": None if args.prefill else args.pos,
        "prefill": args.prefill,
        "wall_ms_per_step": wall_ms,
        "profiled_wall_ms_per_step": prof_wall_ms,
        "device_ms_per_step": device_ms if kernels else None,
        "busy_share": device_ms / wall_ms if kernels else None,
        "kernel_launches_per_step": sum(c for _, c in kernels.values()),
        "hand_kernel_launches_per_step": {
            k: v / args.steps for k, v in _build.LAUNCHES.items() if v},
        "bound_ms_per_step": bound_ms,
        "flash_attention_ms_per_step": (
            sum(ms for k, (ms, _) in kernels.items() if "flash_attention" in k)
            if kernels else None),
        "top_kernels_ms_per_step": {k[:80]: round(ms, 5)
                                    for k, (ms, _) in top},
    }
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
