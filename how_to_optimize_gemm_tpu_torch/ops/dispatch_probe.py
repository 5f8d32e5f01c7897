"""The dispatch probe: what one issued op costs on the host, eagerly and
from a CUDA graph (B22).

Counterpart of ``how_to_optimize_gemm_tpu/ops/dispatch_probe.py``. The
reference priced its relay's dispatch with jitted programs in which one
quantity varies. Eager PyTorch has no JIT; the question it leaves is what
each launch costs the host, against the same launches captured in one
CUDA graph and replayed (the cost ROADMAP A9's lookahead and CUDA graphs
remove). Probes:

1. ``probe_op_chain(kind, ns, graph)``: a chain of N data-dependent ops
   (``_make_chain``), wall-clocked with its scalar readback; the slope of
   wall against N is the cost of one op issued that way, the intercept
   the fixed cost of a call. Kinds: ``dot`` (``torch.matmul`` by w, one
   cuBLAS kernel each), ``custom`` (the hand-written ``add_one`` kernel,
   ``csrc/dispatch_probe.cu``, whose device time is a few microseconds)
   and ``eltwise`` (a multiply and an add, two PyTorch kernels). Two
   columns on the card: ``graph=False`` launches eagerly, ``graph=True``
   replays one CUDA graph of the chain. On the CPU only the eager column
   exists: asking for the graph there raises.
2. ``probe_output_bytes(sizes)``: a fixed 64-dot chain with one more
   output of S bytes, held on the device (synchronized, not fetched)
   against fetched (``.cpu()``).
3. ``probe_async_depth(depths)``: K back-to-back calls of a program of
   about ``device_ms`` (on the card one CUDA-graph replay of a dot chain),
   blocking after each call against blocking once at the end.

Run: ``python -m how_to_optimize_gemm_tpu_torch.ops.dispatch_probe``
(``--fast`` for a reduced sweep, ``--device cpu`` for the host).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from how_to_optimize_gemm_tpu_torch import _build
from how_to_optimize_gemm_tpu_torch.utils.device import default_device

D = 256          # the chain's tile: (8, D) bf16
KINDS = ("eltwise", "dot", "custom")


# ------------------------------------------------------------- the kernel

def add_one_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``add_one``: one bf16 rounding of x + 1."""
    return x + 1


def add_one(x: torch.Tensor) -> torch.Tensor:
    """o = x + 1 on a bf16 tensor (the reference's ``_copy_kernel``, its
    "custom" op): kernel ``add_one`` on the card, the plain version on the
    CPU."""
    if x.device.type == "cpu":
        return add_one_ref(x)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"add_one: bf16, got {x.dtype}")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel():
        _build.launch("add_one", x.device, x, out, x.numel())
    return out


# --------------------------------------------------------------- chains

def _weight(d: int, device) -> torch.Tensor:
    return (torch.eye(d, dtype=torch.bfloat16, device=device) * 0.5
            + torch.full((d, d), 1e-3, dtype=torch.bfloat16, device=device))


def _make_chain(kind: str, n: int, device=None):
    """One thunk and its arguments: x -> n chained ops of ``kind`` -> the
    bf16 sum, as the reference's (x = ones (8, 256) bf16; ``dot``
    multiplies by w = 0.5 I + 1e-3, ``eltwise`` is x * bf16(1.0009765625)
    + bf16(1e-3), ``custom`` is ``add_one``)."""
    dev = default_device(device)
    x0 = torch.ones((8, D), dtype=torch.bfloat16, device=dev)
    if kind == "dot":
        w = _weight(D, dev)

        def fn(x):
            for _ in range(n):
                x = torch.matmul(x, w)
            return x.sum()
    elif kind == "custom":
        def fn(x):
            for _ in range(n):
                x = add_one(x)
            return x.sum()
    elif kind == "eltwise":
        # the reference's constants, rounded to bf16 first as its are
        scale, shift = (torch.tensor(v, dtype=torch.bfloat16, device=dev)
                        for v in (1.0009765625, 1e-3))

        def fn(x):
            for _ in range(n):
                x = x * scale + shift
            return x.sum()
    else:
        raise ValueError(kind)
    return fn, (x0,)


def _graphed(fn, args):
    """``fn(*args)`` captured in one CUDA graph: returns replay() -> the
    graph's output tensor."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):       # warm up off the capture
        fn(*args)
    torch.cuda.current_stream().wait_stream(stream)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = fn(*args)

    def replay():
        g.replay()
        return out
    return replay


def _wall_best(call, repeats: int = 5, warmup: int = 2) -> float:
    """Best host-clock seconds of call() and its scalar readback."""
    for _ in range(warmup):
        float(call())
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        float(call())
        best = min(best, time.perf_counter() - t0)
    return best


def probe_op_chain(kind: str, ns=(32, 128, 512, 1024), graph: bool = False,
                   repeats: int = 5, device=None):
    """Wall per call against N chained ops; returns (rows, slope_us,
    icept_ms): rows (n, wall_s), the least-squares slope (the cost of one
    op, microseconds) and intercept (the fixed cost of a call, ms).
    graph=True replays the chain from one CUDA graph (the card only)."""
    dev = default_device(device)
    if graph and dev.type != "cuda":
        raise ValueError("probe_op_chain: a CUDA graph needs the card")
    rows = []
    for n in ns:
        fn, args = _make_chain(kind, n, dev)
        call = _graphed(fn, args) if graph else (lambda: fn(*args))
        rows.append((n, _wall_best(call, repeats=repeats)))
    xs = np.array([r[0] for r in rows], np.float64)
    ys = np.array([r[1] for r in rows], np.float64)
    slope, icept = np.polyfit(xs, ys, 1)
    return rows, slope * 1e6, icept * 1e3


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def probe_output_bytes(sizes=(1 << 12, 1 << 18, 1 << 22, 1 << 24),
                       repeats: int = 5, device=None):
    """A fixed 64-dot chain and one more output of S bytes. Returns rows
    (bytes, held_s, fetched_s): ``held`` waits for the device without
    moving the output, ``fetched`` also copies it to the host."""
    dev = default_device(device)
    x0 = torch.ones((8, D), dtype=torch.bfloat16, device=dev)
    w = _weight(D, dev)
    rows = []
    for size in sizes:
        n_el = size // 4

        def fn(n_el=n_el):
            x = x0
            for _ in range(64):
                x = torch.matmul(x, w)
            big = torch.full((n_el,), 1.0, dtype=torch.float32,
                             device=dev) * x[0, 0].to(torch.float32)
            return x.sum(), big

        for _ in range(2):
            fn()
            _sync(dev)
        held = fetched = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            _sync(dev)
            held = min(held, time.perf_counter() - t0)
        for _ in range(repeats):
            t0 = time.perf_counter()
            _, big = fn()
            big.cpu()
            fetched = min(fetched, time.perf_counter() - t0)
        rows.append((size, held, fetched))
    return rows


def probe_async_depth(depths=(1, 2, 4, 8), device_ms: float = 10.0,
                      repeats: int = 3, device=None):
    """K back-to-back calls of a program of about ``device_ms``. Returns
    rows (k, per_call_blocking_s, per_call_async_s). On the card the
    program is one CUDA-graph replay of a dot chain calibrated to
    ``device_ms``, so a call is one host op; on the CPU the chain runs
    eagerly."""
    dev = default_device(device)
    d = 512
    x0 = torch.ones((8, d), dtype=torch.bfloat16, device=dev)
    w = _weight(d, dev)

    def make(iters):
        def fn(x):
            for _ in range(iters):
                x = torch.matmul(x, w)
            return x
        return fn

    def build(iters):
        if dev.type == "cuda":
            program = _graphed(make(iters), (x0,))
            return lambda x: program()      # noqa: E731
        return make(iters)

    # calibrate on the program's own form: a graph replay on the card
    iters = 256
    call = build(iters)
    call(x0)
    _sync(dev)
    t0 = time.perf_counter()
    call(x0)
    _sync(dev)
    per = (time.perf_counter() - t0) / iters
    iters = max(int(device_ms * 1e-3 / max(per, 1e-9)), 8)
    call = build(iters)
    call(x0)
    _sync(dev)

    rows = []
    for k in depths:
        blocking = asynch = float("inf")
        for _ in range(repeats):
            x = x0
            t0 = time.perf_counter()
            for _ in range(k):
                x = call(x)
                _sync(dev)
            blocking = min(blocking, (time.perf_counter() - t0) / k)
        for _ in range(repeats):
            x = x0
            t0 = time.perf_counter()
            for _ in range(k):
                x = call(x)               # enqueue only
            _sync(dev)
            asynch = min(asynch, (time.perf_counter() - t0) / k)
        rows.append((k, blocking, asynch))
    return rows


# --------------------------------------------------------------- report

def main(fast: bool = False, device=None) -> dict:
    """Print every probe; returns {"null_ms", "chains": {(kind, column):
    (rows, slope_us, icept_ms)}, "outbytes", "async"}."""
    dev = default_device(device)
    on_card = dev.type == "cuda"
    name = torch.cuda.get_device_name(dev) if on_card else "cpu"
    print(f"# dispatch probe on {dev.type} ({name})")
    x = torch.zeros((8, 128), dtype=torch.float32, device=dev)
    null = _wall_best(lambda: x.sum() + 1.0, repeats=10)
    print(f"# null op + scalar readback: {null * 1e3:.3f} ms")

    ns = (32, 128, 512) if fast else (32, 128, 512, 1024, 2048)
    columns = ("eager", "graph") if on_card else ("eager",)
    chains = {}
    for kind in KINDS:
        for column in columns:
            rows, slope_us, icept_ms = probe_op_chain(
                kind, ns=ns, graph=column == "graph", device=dev)
            chains[(kind, column)] = (rows, slope_us, icept_ms)
            tab = "  ".join(f"N={n}:{w * 1e3:.3f}ms" for n, w in rows)
            print(f"# chain[{kind:8s} {column:5s}] {tab}")
            print(f"#   -> marginal {slope_us:8.3f} us/op, "
                  f"fixed {icept_ms:7.3f} ms/call")

    sizes = ((1 << 16, 1 << 22) if fast
             else (1 << 12, 1 << 18, 1 << 22, 1 << 24, 1 << 26))
    outbytes = probe_output_bytes(sizes=sizes, device=dev)
    for size, held, fetched in outbytes:
        print(f"# outbytes {size / 2 ** 20:8.2f} MB  held {held * 1e3:7.3f}"
              f" ms  fetched {fetched * 1e3:7.3f} ms  (wire "
              f"{(size / max(fetched - held, 1e-9)) / 2 ** 30:6.2f} GB/s)")

    rows = probe_async_depth(depths=(1, 2, 4) if fast else (1, 2, 4, 8),
                             device=dev)
    for k, blocking, asynch in rows:
        print(f"# async depth {k}: blocking {blocking * 1e3:7.3f} "
              f"ms/call, async {asynch * 1e3:7.3f} ms/call")
    hidden = rows[-1][1] - rows[-1][2]
    print(f"# -> pipelining hides {hidden * 1e3:.3f} ms/call at depth "
          f"{rows[-1][0]}")
    return {"null_ms": null * 1e3, "chains": chains, "outbytes": outbytes,
            "async": rows}


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--fast", action="store_true")
    p.add_argument("--device", default=None,
                   help="the card unless 'cpu' is asked for")
    a = p.parse_args()
    main(fast=a.fast, device=a.device)
