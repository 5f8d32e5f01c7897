"""Sweep driver: one ``p gflops diff`` row per size, gated per row.

Counterpart of ``how_to_optimize_gemm_tpu/harness/driver.py``. For every
sweep size: make (A, B, C) on the device, prepare the operands (untimed),
run the rung once against the oracle, fail hard on a gate trip
(``DiffGateError``), time the rung on CUDA events, and write the rows to
an Octave ``.m`` file.

Rungs 07, 07b, 14, 15 and 16 accumulate into C in place, so the driver
hands every run the oracle reads a clone of C, and the timing loop works
on its own copy: the C the oracle adds is always the C the rung started
from.

    python -m how_to_optimize_gemm_tpu_torch.harness.driver \\
        --new 14_packed_alias_int8 --old 06v_xla_int8 --quick
    python -m how_to_optimize_gemm_tpu_torch.harness.driver \\
        --new 15_packed_alias_bf16 --old 01b_xla_bf16 --quick
    python -m how_to_optimize_gemm_tpu_torch.harness.driver \\
        --new 03_pallas_k_blocked --old 02_pallas_mn_tile \\
        --pfirst 2048 --plast 2048 --pinc 1 --roofline --trace

``--roofline`` prints each rung's analytic roofline table and ``--trace``
its measured per-kernel device profile at the largest sweep size
(``harness/profiling.py``); ``--device cpu`` runs everything on the host
through the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import shutil

import torch

from how_to_optimize_gemm_tpu_torch.harness import mfile, oracle, profiling
from how_to_optimize_gemm_tpu_torch.harness.parameters import (
    CUDA_SWEEP, QUICK_SWEEP, SweepConfig)
from how_to_optimize_gemm_tpu_torch.ops import registry
from how_to_optimize_gemm_tpu_torch.utils.device import default_device
from how_to_optimize_gemm_tpu_torch.utils.matrices import make_abc
from how_to_optimize_gemm_tpu_torch.utils.timing import time_chained


@dataclasses.dataclass(frozen=True)
class SweepRow:
    p: int
    m: int
    n: int
    k: int
    gflops: float
    best_s: float
    kernel_rel: float   # vs fp64 oracle on effective operands (gated)
    quant_rel: float    # vs fp64 oracle on original operands (reported)


def _device_check(out, ae, be, c) -> oracle.CompareResult:
    """fp64 ``ae @ be + c`` on the tensors' own device vs ``out``."""
    ref = ae.double() @ be.double() + c.double()
    denom = max(float(ref.abs().max()), 1e-30)
    max_abs = float((out.double() - ref).abs().max())
    return oracle.CompareResult(max_abs, max_abs / denom, None)


def run_sweep(rung_name: str, config: SweepConfig | None = None,
              output_dir=None, strict: bool = True,
              verbose: bool = True,
              quant_oracle: bool = True,
              verify: bool | str = True,
              device=None) -> list[SweepRow]:
    """Sweep one rung over ``config.sizes()``.

    verify: True = the fp64 host oracle (numpy) on every row; "device" =
    an fp64 ``torch.matmul`` of the effective operands on the rung's own
    device (an oracle beside the path, not part of it; fast at p=4096);
    False = no check, only for callers that gated the same rung at
    another size in the same run. quant_oracle adds the reported (not
    gated) error against the original float32 operands when verify is
    True. device: the card unless ``"cpu"`` is asked for."""
    config = config or SweepConfig()
    rung = registry.get(rung_name)
    dev = default_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(config.seed)
    rows: list[SweepRow] = []
    for m, n, k in config.sizes():
        a, b, c = make_abc(gen, m, n, k, dev, ones=config.ones_fixture)
        prepared = rung.prepare(a, b)

        if not verify:
            cmp_eff = oracle.CompareResult(0.0, 0.0, None)
        elif verify == "device":
            out = rung.run(*prepared, c.clone())
            cmp_eff = _device_check(out, *rung.effective(prepared), c)
        else:
            out = rung.run(*prepared, c.clone()).cpu().numpy()
            ae, be = rung.effective(prepared)
            ref_eff = oracle.ref_mmult(ae.cpu().numpy(), be.cpu().numpy(),
                                       c.cpu().numpy())
            cmp_eff = oracle.compare_matrices(out, ref_eff, rung.gate_rel)
        if verify is True and quant_oracle:
            ref_fp32 = oracle.ref_mmult(a.cpu().numpy(), b.cpu().numpy(),
                                        c.cpu().numpy())
            cmp_q = oracle.compare_matrices(out, ref_fp32, float("inf"))
        else:
            cmp_q = cmp_eff

        if cmp_eff.max_rel > rung.gate_rel:
            msg = (f"{rung_name} p={m}x{n}x{k}: kernel rel diff "
                   f"{cmp_eff.max_rel:.3e} > gate {rung.gate_rel:.0e}, "
                   f"first bad element {cmp_eff.first_bad}")
            if strict:
                raise oracle.DiffGateError(msg)
            print("WARNING:", msg)

        best = time_chained(rung.run, prepared, c,
                            inner_iters=config.nrepeats,
                            outer_repeats=3, warmup=config.warmup)
        gflops = 2.0 * m * n * k / best / 1e9
        p = max(m, n, k)
        rows.append(SweepRow(p=p, m=m, n=n, k=k, gflops=gflops,
                             best_s=best, kernel_rel=cmp_eff.max_rel,
                             quant_rel=cmp_q.max_rel))
        if verbose:
            print(f"{p} {gflops:e} {cmp_eff.max_rel:e}")

    if output_dir is not None:
        out_path = pathlib.Path(output_dir) / f"output_{rung_name}.m"
        mfile.write_mfile(
            out_path, rung_name,
            [(r.p, r.gflops, r.kernel_rel) for r in rows])
        if verbose:
            print(f"wrote {out_path}")
    return rows


def main(argv=None) -> dict:
    """The CLI. Returns, per swept rung, its rows and (with ``--trace``)
    its profiled ops."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--new", required=True, choices=registry.names(),
                    help="rung under test (makefile NEW)")
    ap.add_argument("--old", default=None, choices=registry.names(),
                    help="comparison rung (makefile OLD); also swept")
    ap.add_argument("--output-dir", default="outputs/gpu")
    ap.add_argument("--quick", action="store_true",
                    help="coarse sweep (1024..4096 step 1024)")
    ap.add_argument("--cuda-sweep", action="store_true",
                    help="reference cuda sweep bounds (1024..4096 step 128)")
    ap.add_argument("--pfirst", type=int, default=None)
    ap.add_argument("--plast", type=int, default=None)
    ap.add_argument("--pinc", type=int, default=None)
    ap.add_argument("--nrepeats", type=int, default=None)
    ap.add_argument("--no-strict", action="store_true")
    ap.add_argument("--roofline", action="store_true",
                    help="print ANALYTIC top-down roofline attribution "
                         "per rung (harness/profiling.py)")
    ap.add_argument("--trace", action="store_true",
                    help="capture a MEASURED per-kernel device profile of "
                         "each rung at the largest sweep size "
                         "(torch.profiler) and print its table")
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu' is asked for (the "
                         "kernels' plain versions on the host)")
    args = ap.parse_args(argv)

    config = QUICK_SWEEP if args.quick else (
        CUDA_SWEEP if args.cuda_sweep else SweepConfig())
    overrides = {f: getattr(args, f) for f in
                 ("pfirst", "plast", "pinc", "nrepeats")
                 if getattr(args, f) is not None}
    if overrides:
        config = dataclasses.replace(config, **overrides)

    out_dir = pathlib.Path(args.output_dir)
    results = {}
    for name, tag in ((args.old, "old"), (args.new, "new")):
        if name is None:
            continue
        print(f"== {tag}: {name} ==")
        rows = run_sweep(name, config, out_dir, strict=not args.no_strict,
                         device=args.device)
        results[name] = {"rows": rows}
        # old/new A-B snapshot convention (aarch64/makefile:43-44)
        shutil.copy(out_dir / f"output_{name}.m",
                    out_dir / f"output_{tag}.m")
        if args.roofline:
            print(profiling.roofline_report(rows, name))
        if args.trace:
            rung = registry.get(name)
            p_max = max(r.p for r in rows)
            ops, path = profiling.trace_rung(
                name, p_max, logdir=out_dir / "profiles",
                device=args.device)
            results[name]["trace"] = ops
            print(profiling.trace_table(
                ops, compute_dtype=rung.compute_dtype or rung.dtype,
                total_note=f" [{name} p={p_max}, capture: {path}]"))
    return results


if __name__ == "__main__":
    main()
