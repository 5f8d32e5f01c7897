"""MoE benchmarks: the grouped GEMM, the ragged path against the dispatch
and dense paths at prefill and decode widths, and the ragged train step.

Counterpart: ``how_to_optimize_gemm_tpu/parallel/moe_bench.py``.

    python -m how_to_optimize_gemm_tpu_torch.parallel.moe_bench \\
        [kernel] [prefill] [decode] [train] [--t 4096] [--batch 8] \\
        [--d D --f F --e E] [--kind fp32|bf16|int8|int4] [--tp 8192] \\
        [--repeats 3] [--device cpu]

- ``kernel``: ``grouped_matmul`` (kernel ``grouped_gemm`` on the card) on
  bf16, int8-scaled and int4-packed stacks at a uniform layout (Tp / E
  rows an expert), fp32 x, checked against ``grouped_matmul_ref`` first;
- ``prefill``: ``moe_ffn_ragged`` vs ``moe_ffn_local`` (dropless,
  cf = E / k, and cf = 2) vs ``moe_ffn_dense`` at T tokens, each path but
  cf = 2 (which may drop) gated against ``moe_ffn_dense`` first (2e-3 of
  max |y| for dense stacks, 2e-2 for quantized ones, the reference's
  gates), for bf16 and int8 stacks unless ``--kind``;
- ``decode``: ragged vs dispatch at T = ``--batch`` tokens, int8 stacks
  unless ``--kind``, with the weight stream's rate;
- ``train``: the QLoRA-style ragged train step (the reference's
  ``bench_train``), int8 stacks unless ``--kind`` (int4, or bf16 whose
  stacks train too): one loss (mean y^2 + 0.01 aux) and gradient step on
  ``moe_ffn_ragged`` at T = ``--t`` tokens of bf16 x, printing the
  trainable leaves, their gradients' norms and the step's kernel launches
  and checking that the integer stacks did not change; then a chained
  forward and backward-of-x step (each call feeds x + dx to the next),
  timed.

With no part named, all four run, as the reference's do.

Shapes: the reference's d 2,048, f 1,408, E 8, then Mixtral-8x7B's d
4,096, f 14,336, E 8; ``--d``/``--f``/``--e`` give one set instead. Times
are CUDA events (``utils/timing.time_calls``, best of ``--repeats``
windows) on the card; ``--device cpu`` times the plain versions on the
host clock, and prints them as such.
"""
from __future__ import annotations

import argparse
import time

import torch

from how_to_optimize_gemm_tpu_torch import _build
from how_to_optimize_gemm_tpu_torch.ops import grouped_gemm, quant
from how_to_optimize_gemm_tpu_torch.parallel import moe
from how_to_optimize_gemm_tpu_torch.utils.device import default_device
from how_to_optimize_gemm_tpu_torch.utils.timing import time_calls

SHAPES = {"reference": (2048, 1408, 8), "mixtral_8x7b": (4096, 14336, 8)}
PARTS = ("kernel", "prefill", "decode", "train")   # the default: all four
BT = 128
GATE = {"bf16": 2e-3, "fp32": 2e-3, "int8": 2e-2, "int4": 2e-2}
KERNEL_REL = 1e-4


def _time(fn, device: torch.device, repeats: int) -> float:
    """Seconds per call: CUDA events on the card, the host clock else."""
    if device.type == "cuda":
        return time_calls(fn, inner_iters=5, outer_repeats=repeats)
    fn()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _unit(device: torch.device) -> str:
    return "card" if device.type == "cuda" else "host clock, plain versions"


def _rel(y, ref) -> float:
    ref = ref.to(torch.float32)
    return float((y.to(torch.float32) - ref).abs().max()
                 / ref.abs().max().clamp_min(1e-30))


def _gate(y, ref, label: str, tol: float) -> float:
    rel = _rel(y, ref)
    if not rel < tol:
        raise AssertionError(f"{label}: rel {rel:.3e} > {tol:g}")
    return rel


def _params(gen, d: int, f: int, e: int, kind: str, device) -> dict:
    dtype = torch.float32 if kind == "fp32" else torch.bfloat16
    p = moe.init_moe_params(gen, d, f, e, dtype=dtype, swiglu=True,
                            device=device)
    if kind in ("int8", "int4"):
        return moe.quantize_moe(p, bits=8 if kind == "int8" else 4)
    return p


def bench_kernel(gen, d: int, f: int, e: int, tp: int, device,
                 repeats: int) -> dict:
    """grouped_matmul per stack kind at a uniform layout; ms per call."""
    w = torch.randn((e, d, f), generator=gen, device=device) * d ** -0.5
    x = torch.randn((tp, d), generator=gen, device=device)
    be = torch.arange(e, device=device, dtype=torch.int32).repeat_interleave(
        tp // BT // e)
    flops = 2.0 * tp * d * f
    print(f"grouped_matmul (Tp={tp}, d={d}, f={f}, E={e}; {_unit(device)}):",
          flush=True)
    out = {}
    for kind in ("bf16", "int8", "int4"):
        if kind == "bf16":
            args, kw = (w.to(torch.bfloat16), be), {}
        else:
            q, s = quant.quantize_symmetric(w, axis=1,
                                            bits=8 if kind == "int8" else 4)
            packed = kind == "int4"
            args = (quant.pack_int4(q, d) if packed else q, be, s)
            kw = {"packed4": packed}
        y = grouped_gemm.grouped_matmul(x, *args, **kw)
        rel = _gate(y, grouped_gemm.grouped_matmul_ref(x, *args, **kw),
                    f"grouped {kind}", KERNEL_REL)
        del y
        sec = _time(lambda: grouped_gemm.grouped_matmul(x, *args, **kw),
                    device, repeats)
        out[kind] = sec * 1e3
        print(f"  {kind:<6} {sec * 1e3:9.3f} ms  {flops / sec / 1e12:8.2f} "
              f"TFLOP/s  (rel vs plain {rel:.2e})", flush=True)
    return out


def _paths(k: int, e: int) -> dict:
    return {
        "ragged (grouped GEMM)":
            lambda p, x: moe.moe_ffn_ragged(p, x, k=k),
        "dispatch (dropless cf=E/k)":
            lambda p, x: moe.moe_ffn_local(p, x, k=k,
                                           capacity_factor=e / k),
        "dispatch (cf=2)":
            lambda p, x: moe.moe_ffn_local(p, x, k=k, capacity_factor=2.0),
        "dense (every expert, every token)":
            lambda p, x: moe.moe_ffn_dense(p, x, k=k),
    }


def bench_prefill(gen, t: int, d: int, f: int, e: int, kind: str, device,
                  repeats: int, k: int = 2) -> dict:
    """Ragged vs dispatch vs dense at T tokens; useful FLOPs are the k
    routed copies' 3 GEMMs."""
    params = _params(gen, d, f, e, kind, device)
    x = torch.randn((t, d), generator=gen, device=device)
    ref = moe.moe_ffn_dense(params, x, k=k)
    flops = 2.0 * 3 * k * t * d * f
    print(f"prefill MoE (T={t}, d={d}, d_ff={f}, E={e}, k={k}, {kind}; "
          f"{_unit(device)}): useful {flops / 1e9:.1f} GFLOP/call",
          flush=True)
    out = {}
    for label, fn in _paths(k, e).items():
        if "cf=2" not in label:
            _gate(fn(params, x), ref, label, GATE[kind])
        sec = _time(lambda: fn(params, x), device, repeats)
        out[label] = sec * 1e3
        print(f"  {label:<34} {sec * 1e3:9.3f} ms/call  "
              f"{flops / sec / 1e12:8.2f} TFLOP/s", flush=True)
    return out


def bench_decode(gen, batch: int, d: int, f: int, e: int, kind: str,
                 device, repeats: int, k: int = 2) -> dict:
    """Decode widths: both paths stream every expert's stack once."""
    params = _params(gen, d, f, e, kind, device)
    x = torch.randn((batch, d), generator=gen, device=device)
    ref = moe.moe_ffn_dense(params, x, k=k)
    stream = sum(v.numel() * v.element_size() for name, v in params.items()
                 if name != "router")
    print(f"decode MoE (batch={batch}, d={d}, d_ff={f}, E={e}, k={k}, "
          f"{kind}; {_unit(device)}): weight stream {stream / 1e6:.1f} "
          "MB/step", flush=True)
    out = {}
    paths = _paths(k, e)
    for label in ("ragged (grouped GEMM)", "dispatch (dropless cf=E/k)"):
        fn = paths[label]
        _gate(fn(params, x), ref, label, GATE[kind])
        sec = _time(lambda: fn(params, x), device, repeats)
        out[label] = sec * 1e3
        print(f"  {label:<34} {sec * 1e3:9.3f} ms/call -> "
              f"{batch / sec:.0f} tok/s/layer-MLP, "
              f"{stream / sec / 1e9:.0f} GB/s weight stream", flush=True)
    return out


def bench_train(gen, t: int, d: int, f: int, e: int, kind: str, device,
                repeats: int, k: int = 2) -> dict:
    """One loss and gradient step over the layer's float leaves (the
    router and the scales, or the bf16 stacks; integer stacks frozen),
    then the chained forward and backward-of-x step; ms per chained
    step."""
    params = _params(gen, d, f, e, kind, device)
    x = torch.randn((t, d), generator=gen, device=device).to(torch.bfloat16)
    frozen = {n: v.clone() for n, v in params.items()
              if not torch.is_floating_point(v)}
    names = sorted(n for n, v in params.items() if torch.is_floating_point(v))

    def loss_of(p, xx):
        y, aux = moe.moe_ffn_ragged(p, xx, k=k, return_aux=True)
        return torch.mean(y.to(torch.float32) ** 2) + 0.01 * aux

    before = dict(_build.LAUNCHES)
    with torch.enable_grad():
        leaves = [params[n].detach().requires_grad_() for n in names]
        loss = loss_of({**params, **dict(zip(names, leaves))}, x)
        grads = torch.autograd.grad(loss, leaves)
    loss = float(loss.detach())
    launches = {n: c - before[n] for n, c in _build.LAUNCHES.items()
                if c != before[n]}
    norms = {n: float(g.to(torch.float32).norm()) for n, g in
             zip(names, grads)}
    unchanged = all(torch.equal(params[n], v) for n, v in frozen.items())
    print(f"train step (T={t}, d={d}, d_ff={f}, E={e}, {kind} stacks; "
          f"{_unit(device)}): loss {loss:.4f}, trainable leaves "
          f"{names}, frozen {sorted(frozen)} (unchanged: {unchanged})",
          flush=True)
    print("  gradient norms " + ", ".join(f"{n} {v:.4e}"
                                          for n, v in norms.items())
          + f"; kernel launches {launches}", flush=True)
    state = [x]

    def chained():
        xx = state[0].detach().requires_grad_()
        with torch.enable_grad():
            dx, = torch.autograd.grad(loss_of(params, xx), xx)
        state[0] = (xx + dx.to(xx.dtype)).detach()

    sec = _time(chained, device, repeats)
    print(f"  ragged {kind} fwd+bwd(x) {sec * 1e3:9.3f} ms/step", flush=True)
    return {"loss": loss, "trainable": names, "frozen": sorted(frozen),
            "grad_norms": norms, "launches": launches,
            "stacks_unchanged": unchanged, "ms": sec * 1e3}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parts", nargs="*", metavar="part",
                    choices=PARTS,
                    help="kernel, prefill, decode and train (default: "
                         "all four)")
    ap.add_argument("--t", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--tp", type=int, default=8192,
                    help="rows of the kernel part (a multiple of 128 x E)")
    ap.add_argument("--d", type=int, default=None)
    ap.add_argument("--f", type=int, default=None)
    ap.add_argument("--e", type=int, default=None)
    ap.add_argument("--kind", default=None,
                    choices=["fp32", "bf16", "int8", "int4"],
                    help="stack kind of prefill, decode and train")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    args.parts = args.parts or list(PARTS)
    device = default_device(args.device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    if args.d or args.f or args.e:
        ref = SHAPES["reference"]
        shapes = {"custom": (args.d or ref[0], args.f or ref[1],
                             args.e or ref[2])}
    else:
        shapes = SHAPES
    results = {}
    with torch.no_grad():
        for name, (d, f, e) in shapes.items():
            r = results[name] = {}
            if "kernel" in args.parts:
                r["kernel"] = bench_kernel(gen, d, f, e, args.tp, device,
                                           args.repeats)
            if "prefill" in args.parts:
                for kind in ([args.kind] if args.kind else ["bf16", "int8"]):
                    r[f"prefill {kind}"] = bench_prefill(
                        gen, args.t, d, f, e, kind, device, args.repeats)
            if "decode" in args.parts:
                kind = args.kind or "int8"
                r[f"decode {kind}"] = bench_decode(
                    gen, args.batch, d, f, e, kind, device, args.repeats)
    if "train" in args.parts:
        for name, (d, f, e) in shapes.items():
            kind = args.kind or "int8"
            results.setdefault(name, {})[f"train {kind}"] = bench_train(
                gen, args.t, d, f, e, kind, device, args.repeats)
    return results


if __name__ == "__main__":
    main()
