"""Headline benchmark of the port — one JSON line on stdout.

Counterpart of the repository's top-level ``bench.py``, with its keys:
the peak GFLOPS of the int8 headline rungs (the hand-written kernels and
the library's int8 matmul as the vendor bar) over the M=N=K sizes,
each rung gated by the fp64 host oracle at p=1024 and by the fp64 device
check at the sizes it is timed at. Baseline: the reference tutorial's
best published GEMM, MMult_cuda_12's 22418 GFLOPS on an RTX 3080
(BASELINE.md).

    python -m how_to_optimize_gemm_tpu_torch.bench

Detail rows go to stderr; stdout carries exactly one JSON line.
"""
from __future__ import annotations

import json
import sys

import torch

from how_to_optimize_gemm_tpu_torch.harness.driver import run_sweep
from how_to_optimize_gemm_tpu_torch.harness.parameters import SweepConfig
from how_to_optimize_gemm_tpu_torch.harness.profiling import PEAK_INT8_OPS
from how_to_optimize_gemm_tpu_torch.utils.device import default_device

REFERENCE_BEST_GFLOPS = 22418.0  # cuda_12 sweep peak (BASELINE.md)
# H100 SXM dense int8 tensor-core peak (NVIDIA data sheet, 1,979 TOP/s at
# the full 700 W power limit): no honest reading of an int8 GEMM exceeds it.
PEAK_INT8_GFLOPS = PEAK_INT8_OPS / 1e9
# The headline population and the sizes each rung is timed at: the same
# rungs and sizes as the top-level bench.py.
RUNGS = {
    "06_pallas_int8": (2048, 3584),
    "06v_xla_int8": (3584, 4096),
    "07b_pallas_w4a8": (2048, 3584),
    "14_packed_alias_int8": (3584, 4096),
}


def measure(device=None) -> dict:
    """Gate and time every headline rung; returns the JSON record."""
    dev = default_device(device)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"# device {kind}; int8 ceiling {PEAK_INT8_GFLOPS:.0f} GFLOPS "
          "(H100 SXM data sheet)", file=sys.stderr)
    peak, best = 0.0, None
    hand_peak, hand_best = 0.0, None
    vendor_peak = 0.0
    for rung, sizes in RUNGS.items():
        gate_cfg = SweepConfig(pfirst=1024, plast=1024, pinc=1,
                               nrepeats=2, warmup=0)
        gate = run_sweep(rung, gate_cfg, verbose=False,
                         quant_oracle=False, device=dev)  # raises on a trip
        print(f"# {rung} gate@1024 kernel_rel={gate[0].kernel_rel:.2e}",
              file=sys.stderr)
        for p in sizes:
            cfg = SweepConfig(pfirst=p, plast=p, pinc=1, nrepeats=8,
                              warmup=1)
            for r in run_sweep(rung, cfg, verbose=False, quant_oracle=False,
                               verify="device", device=dev):
                if r.gflops > PEAK_INT8_GFLOPS:
                    raise RuntimeError(
                        f"{rung} p={r.p}: {r.gflops:.0f} GFLOPS is above "
                        "the card's int8 peak: a timing bug, not speed")
                print(f"# {rung} p={r.p} {r.gflops:.1f} GFLOPS "
                      f"(kernel_rel={r.kernel_rel:.2e})", file=sys.stderr)
                if r.gflops > peak:
                    peak, best = r.gflops, rung
                if "xla" in rung:
                    vendor_peak = max(vendor_peak, r.gflops)
                elif r.gflops > hand_peak:
                    hand_peak, hand_best = r.gflops, rung
    return {
        "metric": f"peak int8 dequant-GEMM GFLOPS (best rung: {best}, "
                  f"M=N=K sweep, 1 {kind})",
        "value": round(peak, 1),
        "unit": "GFLOPS",
        "vs_baseline": round(peak / REFERENCE_BEST_GFLOPS, 3),
        "hand_value": round(hand_peak, 1),
        "hand_rung": hand_best,
        "vendor_value": round(vendor_peak, 1),
    }


def main() -> None:
    print(json.dumps(measure()))


if __name__ == "__main__":
    main()
