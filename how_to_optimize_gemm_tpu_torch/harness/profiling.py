"""Roofline accounting and a measured per-kernel profile of a rung.

Counterpart of ``how_to_optimize_gemm_tpu/harness/profiling.py`` (the
reference's mperf/TMA slot):

- ``roofline`` / ``roofline_report``: analytic attribution of each sweep
  row. The least time at the compute ceiling (operations over the peak of
  the rung's compute dtype) against the least time at the memory ceiling
  (A and B read once at their byte widths, C read and the output written
  in fp32, over the HBM bandwidth): which bound dominates, and the share
  of that ceiling the row reached. The same columns and byte accounting
  as the reference's.
- ``trace_rung`` / ``trace_table``: ``torch.profiler`` (CUPTI) around a
  few calls of one rung at size p, each kernel that ran on the card taken
  by name: its count, device time, share of the capture, and GFLOPS and
  GB/s against the ceilings. The rung's operations and bytes are credited
  to the kernel that took the most device time, the product (the rest are
  a rung's small helpers: C's add, pads, casts).

The ceilings are the H100 SXM data sheet's dense peaks at 700 W (the
port's one copy of them; ``chip_smoke.py`` and the bench read them here).
fp32 at the ladder's gate (1e-4) is held to the fastest route that meets
it and FP32_REL: three bf16 products of operands split into bf16 hi + lo
on the tensor cores (rungs 16's and 04's kernels, measured within
FP32_REL on the card), a third of the bf16 peak; 3xTF32 runs at half that
rate. The CUDA cores' FFMA ceiling is printed beside it, since the fp32
rungs below 04 (00, 02, 03, 03b) run there. On the CPU (only when asked for) the profile times
the host's operators and is labelled so: no CPU time is a device time.
"""
from __future__ import annotations

import dataclasses
import pathlib

import torch

from how_to_optimize_gemm_tpu_torch.ops import registry
from how_to_optimize_gemm_tpu_torch.utils.device import default_device
from how_to_optimize_gemm_tpu_torch.utils.matrices import make_abc

# H100 SXM data sheet, dense: int8 and bf16 tensor-core peaks, TF32, the
# CUDA cores' fp32 FMA rate, HBM3 bandwidth.
PEAK_INT8_OPS = 1.979e15
PEAK_BF16_FLOPS = 0.989e15
PEAK_TF32_FLOPS = 0.495e15
# the fp32 rows' ceiling: three bf16 products of operands split into bf16
# hi + lo (bf16x3), the fastest route shown to meet FP32_REL (rung 16's
# and grouped_dw's)
PEAK_FP32_FLOPS = PEAK_BF16_FLOPS / 3
PEAK_FFMA_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# Ceilings by COMPUTE dtype family: (GFLOPS, HBM GB/s).
H100_PEAKS = {
    "fp32": (PEAK_FP32_FLOPS / 1e9, PEAK_BYTES / 1e9),
    "bf16": (PEAK_BF16_FLOPS / 1e9, PEAK_BYTES / 1e9),
    "int8": (PEAK_INT8_OPS / 1e9, PEAK_BYTES / 1e9),
    "int4": (PEAK_BF16_FLOPS / 1e9, PEAK_BYTES / 1e9),  # W4A16: bf16 math
}
FFMA_GFLOPS = PEAK_FFMA_FLOPS / 1e9
TRACE_REPS = 4   # calls in one capture


def _ffma_note(compute_dtype: str) -> str:
    return (f"; FFMA {FFMA_GFLOPS:.0f} GFLOPS beside it"
            if compute_dtype == "fp32" else "")


@dataclasses.dataclass
class OpStat:
    """One operator of a capture: a CUDA kernel by name on the card, a
    host operator on the CPU."""
    name: str
    category: str                 # "cuda kernel" | "cpu op"
    count: int = 0
    time_us: float = 0.0          # summed device time (CPU time on the CPU)
    bytes_accessed: float = 0.0   # credited bytes, summed
    model_flops: float = 0.0      # credited operations, summed

    @property
    def gflops(self) -> float:
        return (self.model_flops / (self.time_us * 1e-6) / 1e9
                if self.time_us else 0.0)

    @property
    def gbps(self) -> float:
        return (self.bytes_accessed / (self.time_us * 1e-6) / 1e9
                if self.time_us else 0.0)


def _short(name: str) -> str:
    """A kernel's name without its return type, namespace prefix and
    argument list."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(", 1)[0] or name


def _io_bytes(rung, m: int, n: int, k: int) -> float:
    """A and B read once at the rung's byte widths, C read and the fp32
    output written: the reference's accounting."""
    width = rung.bytes_per_input_elt
    ba = rung.bytes_a if rung.bytes_a is not None else width
    bb = rung.bytes_b if rung.bytes_b is not None else width
    return m * k * ba + k * n * bb + 2 * m * n * 4


def trace_rung(rung_name: str, p: int, logdir="profiles",
               device=None) -> tuple[list[OpStat], str]:
    """Profile ``TRACE_REPS`` calls of one rung at M = N = K = p: prepare the
    operands, warm up (builds the kernels outside the capture), capture,
    aggregate by operator. Returns (ops sorted by time, the path of the
    exported Chrome trace). device: the card unless ``"cpu"``."""
    rung = registry.get(rung_name)
    dev = default_device(device)
    on_card = dev.type == "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    a, b, c = make_abc(gen, p, p, p, dev)
    prepared = rung.prepare(a, b)
    cc = rung.run(*prepared, c.clone())          # warm up, builds
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        torch.cuda.synchronize(dev)
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(TRACE_REPS):
            cc = rung.run(*prepared, cc)         # chained through C
        if on_card:
            torch.cuda.synchronize(dev)
    path = pathlib.Path(logdir) / f"{rung_name}_p{p}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))

    stats: dict[str, OpStat] = {}
    for ev in prof.key_averages():
        if on_card:
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = ev.cuda_time_total
            category = "cuda kernel"
        else:
            us = ev.self_cpu_time_total
            category = "cpu op"
        if us <= 0:
            continue
        name = _short(ev.key)
        st = stats.setdefault(name, OpStat(name=name, category=category))
        st.count += ev.count
        st.time_us += us
    ops = sorted(stats.values(), key=lambda s: -s.time_us)
    if ops:
        ops[0].model_flops = 2.0 * p ** 3 * TRACE_REPS
        ops[0].bytes_accessed = _io_bytes(rung, p, p, p) * TRACE_REPS
    return ops, str(path)


def trace_table(ops: list[OpStat], compute_dtype="int8",
                total_note: str = "", peaks: dict | None = None) -> str:
    """Render ``trace_rung``'s ops: per-op time, share of the capture,
    achieved GFLOPS against the compute ceiling and GB/s against HBM's.
    peaks: ceilings in ``H100_PEAKS``'s form (default the data sheet's;
    a caller may pass ones built from ``ops/probes``' readings)."""
    peaks = H100_PEAKS if peaks is None else peaks
    peak_gflops, hbm_gbps = peaks[compute_dtype]
    source = ("H100 SXM data sheet" if peaks is H100_PEAKS
              else "the caller's ceilings")
    on_card = all(o.category == "cuda kernel" for o in ops)
    what, col = ("device", "dev ms") if on_card else ("CPU", "cpu ms")
    total_us = sum(o.time_us for o in ops) or 1.0
    lines = [f"measured per-op {what} profile{total_note} (ceilings: "
             f"{peak_gflops:.0f} GFLOPS {compute_dtype}"
             f"{_ffma_note(compute_dtype)}, {hbm_gbps:.0f} GB/s HBM; "
             f"{source})",
             f"{'op':<48} {'n':>4} {col:>8} {'%':>6} "
             f"{'GFLOPS':>9} {'%peak':>6} {'GB/s':>7} {'%HBM':>6}"]
    for o in ops:
        lines.append(
            f"{o.name[:48]:<48} {o.count:>4} {o.time_us / 1e3:>8.3f} "
            f"{100 * o.time_us / total_us:>5.1f}% "
            f"{o.gflops:>9.0f} {100 * o.gflops / peak_gflops:>5.1f}% "
            f"{o.gbps:>7.0f} {100 * o.gbps / hbm_gbps:>5.1f}%")
    return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class RooflinePoint:
    rung: str
    m: int
    n: int
    k: int
    achieved_gflops: float
    compute_ceiling_gflops: float
    memory_ceiling_gflops: float   # bw-limited GFLOPS for this shape
    bound: str                      # 'compute' | 'memory'
    fraction_of_ceiling: float


def roofline(rung_name: str, m: int, n: int, k: int,
             achieved_gflops: float, peaks: dict | None = None
             ) -> RooflinePoint:
    """One row's roofline point against ``peaks`` (``H100_PEAKS``'s form;
    default the data sheet's)."""
    rung = registry.get(rung_name)
    peaks = H100_PEAKS if peaks is None else peaks
    peak_gflops, hbm_gbps = peaks[rung.compute_dtype or rung.dtype]
    flops = 2.0 * m * n * k
    t_compute = flops / (peak_gflops * 1e9)
    t_memory = _io_bytes(rung, m, n, k) / (hbm_gbps * 1e9)
    mem_ceiling = flops / t_memory / 1e9
    if t_compute >= t_memory:
        bound, ceiling = "compute", peak_gflops
    else:
        bound, ceiling = "memory", mem_ceiling
    return RooflinePoint(
        rung=rung_name, m=m, n=n, k=k,
        achieved_gflops=achieved_gflops,
        compute_ceiling_gflops=peak_gflops,
        memory_ceiling_gflops=mem_ceiling,
        bound=bound,
        fraction_of_ceiling=achieved_gflops / ceiling)


def roofline_report(rows, rung_name: str, peaks: dict | None = None) -> str:
    """Format driver SweepRows as a top-down roofline table against
    ``peaks`` (default the data sheet's ``H100_PEAKS``)."""
    rung = registry.get(rung_name)
    dtype = rung.compute_dtype or rung.dtype
    ffma = dtype == "fp32"
    source = ("H100 SXM data sheet" if peaks is None or peaks is H100_PEAKS
              else "the caller's ceilings")
    lines = [f"rung {rung_name}: top-down roofline (ceilings: {dtype} "
             f"peak / HBM-bandwidth-limited{_ffma_note(dtype)}; {source})",
             f"{'p':>6} {'achieved':>12} {'bound':>8} {'ceiling':>12} "
             f"{'% of ceiling':>12}" + (f" {'% of FFMA':>10}" if ffma
                                        else "")]
    for r in rows:
        pt = roofline(rung_name, r.m, r.n, r.k, r.gflops, peaks)
        ceiling = (pt.compute_ceiling_gflops if pt.bound == "compute"
                   else pt.memory_ceiling_gflops)
        line = (f"{r.p:>6} {r.gflops:>12.0f} {pt.bound:>8} {ceiling:>12.0f} "
                f"{100 * pt.fraction_of_ceiling:>11.1f}%")
        if ffma:
            line += f" {100 * r.gflops / FFMA_GFLOPS:>9.1f}%"
        lines.append(line)
    return "\n".join(lines)
