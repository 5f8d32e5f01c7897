"""Where a serving decode step's time goes on the card.

    python -m how_to_optimize_gemm_tpu_torch.harness.serve_profile \\
        [--layers 32] [--slots 4] [--pos 512] [--steps 8]

Builds Llama-2-7B with W4A8 weights (random, seed 0) and a bf16 cache for
``--slots`` slots, then times decode steps of one token per slot at
position ``--pos`` (the cache's contents do not change the work):

1. wall: the host clock around ``--steps`` steps ending in a
   synchronize, in ms per step;
2. device: ``torch.profiler`` over the same number of steps: the summed
   time of the kernels on the card by name (kernel rows only: the
   operator rows repeat their kernels' time), their count per step, and
   the busy share (kernel time over the unprofiled wall time; tracing
   slows the host);
3. bound: the bytes one step must read (the packed weights, the lm head,
   the live cache rows) over 3.35 TB/s.

Prints one JSON line. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from how_to_optimize_gemm_tpu_torch import _build
from how_to_optimize_gemm_tpu_torch.models import llama
from how_to_optimize_gemm_tpu_torch.utils.device import default_device

PEAK_BYTES = 3.35e12   # H100 SXM HBM3, data sheet


def step_bytes(params: dict, cfg: llama.LlamaConfig, slots: int,
               pos: int) -> int:
    """Bytes one decode step must read: every linear's leaves, the lm
    head, and K and V of the live cache rows (bf16)."""
    def size(t):
        return t.numel() * t.element_size()
    n = sum(size(t) for layer in params["layers"] for lin in layer.values()
            if isinstance(lin, dict) for t in lin.values())
    n += size(params["lm_head"]["fp32_w"])
    n += (2 * cfg.n_layers * slots * (pos + 1) * cfg.n_kv_heads
          * cfg.d_head * 2)
    return n


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--pos", type=int, default=512)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    device = default_device()
    cfg = dataclasses.replace(llama.llama2_7b("w4a8"), n_layers=args.layers)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = llama.init_params(gen, cfg, device)
    cache = llama.init_kv_cache(cfg, args.slots, device=device)
    tokens = torch.ones((args.slots, 1), dtype=torch.int32, device=device)
    pos = torch.full((args.slots,), args.pos, dtype=torch.int32,
                     device=device)

    def steps(n):
        for _ in range(n):
            llama.decode_step(params, cfg, cache, tokens, pos)

    steps(2)                                     # warm up, builds kernels
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(args.steps)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    _build.reset_launches()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        steps(args.steps)
        torch.cuda.synchronize()
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
    bound_ms = 1e3 * step_bytes(params, cfg, args.slots,
                                args.pos) / PEAK_BYTES
    record = {
        "card": torch.cuda.get_device_name(device),
        "layers": args.layers, "slots": args.slots, "pos": args.pos,
        "wall_ms_per_step": wall_ms,
        "profiled_wall_ms_per_step": prof_wall_ms,
        "device_ms_per_step": device_ms if kernels else None,
        "busy_share": device_ms / wall_ms if kernels else None,
        "kernel_launches_per_step": sum(c for _, c in kernels.values()),
        "hand_kernel_launches_per_step": {
            k: v / args.steps for k, v in _build.LAUNCHES.items() if v},
        "bound_ms_per_step": bound_ms,
        "top_kernels_ms_per_step": {k[:80]: round(ms, 5)
                                    for k, (ms, _) in top},
    }
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
