"""Timing on CUDA events: warm up, then the best of ``outer_repeats``
windows of ``inner_iters`` back-to-back launches, in seconds per call.

Counterpart of ``how_to_optimize_gemm_tpu/utils/timing.py``. The
reference subtracts a measured relay round trip and chains its repeats
through the accumulator (or through B, or behind an optimization
barrier) so that XLA cannot hoist a loop-invariant matmul out of the
timed loop inside ``jit``. Eager PyTorch has nothing to hoist and the
events are recorded on the device's own stream, so none of that is
needed here: each call is a real launch, timed between two events.

When the host enqueues calls more slowly than the device runs them (small
sizes), a window measures the host's per-call cost: that is the time a
caller of the rung sees. On the CPU (only when the caller asked for it)
the host clock times the same loop.
"""
from __future__ import annotations

import time
from typing import Callable

import torch


def time_chained(run: Callable[..., torch.Tensor], prepared: tuple,
                 c: torch.Tensor, inner_iters: int = 8,
                 outer_repeats: int = 3, warmup: int = 1) -> float:
    """Per-call seconds of ``run(*prepared, c)``.

    Calls are chained through C (each output is the next call's C), on a
    copy: the caller's ``c`` is never written, even by in-place rungs."""
    cc = c.clone()
    iters = max(inner_iters, 1)
    for _ in range(warmup):
        cc = run(*prepared, cc)
    best = float("inf")
    if cc.is_cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(cc.device)
        for _ in range(outer_repeats):
            start.record()
            for _ in range(iters):
                cc = run(*prepared, cc)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) * 1e-3 / iters)
        return best
    for _ in range(outer_repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            cc = run(*prepared, cc)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def time_calls(fn: Callable[[], object], inner_iters: int = 20,
               outer_repeats: int = 3, warmup: int = 2,
               graph: bool = False) -> float:
    """Per-call seconds of ``fn()`` on the card: the best of
    ``outer_repeats`` CUDA-event windows of ``inner_iters`` calls.

    graph=True captures the ``inner_iters`` calls in one CUDA graph and
    times its replay: the device's time per call, without the host's
    cost of issuing it (``fn`` must not synchronize)."""
    for _ in range(warmup):
        fn()
    window = fn
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(inner_iters):
                fn()
        window = g.replay
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(outer_repeats):
        start.record()
        if graph:
            window()
        else:
            for _ in range(inner_iters):
                fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) * 1e-3 / inner_iters)
    return best
