"""GFLOPS-vs-size plots of the port's ``.m`` files.

Counterpart of ``how_to_optimize_gemm_tpu/viz/plot.py`` (the reference's
old-vs-new matplotlib lines with a horizontal peak line). Reads the
``.m`` files the port's driver writes; the roofline line takes the H100
SXM data-sheet ceilings of ``harness/profiling.py`` (fp32: 3xTF32, with
the FFMA ceiling drawn beside it). Runs on the host, from files: nothing
on the card's path imports this package.

    python -m how_to_optimize_gemm_tpu_torch.viz.plot \\
        outputs/gpu/output_old.m outputs/gpu/output_new.m \\
        --roofline fp32 --save figures/gpu/compare.png
"""
from __future__ import annotations

import argparse
import pathlib

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from how_to_optimize_gemm_tpu_torch.harness import mfile  # noqa: E402
from how_to_optimize_gemm_tpu_torch.harness.profiling import (  # noqa: E402
    FFMA_GFLOPS, H100_PEAKS)


def _peak_line(ax, peak: float, label: str, style: str) -> None:
    ax.axhline(peak, color="0.35", linestyle=style, linewidth=1.2)
    ax.annotate(label, xy=(0.99, peak), xycoords=("axes fraction", "data"),
                ha="right", va="bottom", fontsize=9, color="0.35")


def plot_mfiles(paths, save=None, roofline: str | None = None,
                title: str | None = None) -> None:
    """Plot one GFLOPS curve per .m file; optional peak line.

    roofline: one of 'bf16', 'int8', 'int4', 'fp32' (H100 SXM data-sheet
    ceilings; 'fp32' also draws the FFMA ceiling) or a float string (a
    measured ceiling)."""
    fig, ax = plt.subplots(figsize=(9, 5.5))
    for path in paths:
        version, rows = mfile.read_mfile(path)
        if not rows:
            continue
        ax.plot([r[0] for r in rows], [r[1] for r in rows],
                marker="o", markersize=3.5, linewidth=1.6, label=version)
    if roofline:
        try:
            _peak_line(ax, float(roofline),
                       f"peak {float(roofline):.0f} GFLOPS", "--")
        except ValueError:
            peak = H100_PEAKS[roofline][0]
            name = "3xTF32" if roofline == "fp32" else roofline
            _peak_line(ax, peak, f"H100 {name} peak", "--")
            if roofline == "fp32":
                _peak_line(ax, FFMA_GFLOPS, "H100 FFMA peak", ":")
    ax.set_xlabel("m = n = k")
    ax.set_ylabel("GFLOPS")
    if title:
        ax.set_title(title)
    ax.grid(True, linewidth=0.4, alpha=0.5)
    ax.legend(loc="best", fontsize=9)
    fig.tight_layout()
    if save:
        pathlib.Path(save).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(save, dpi=140)
        print(f"wrote {save}")
    plt.close(fig)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("mfiles", nargs="+",
                    help=".m result files (e.g. output_old.m output_new.m)")
    ap.add_argument("--save", default="figures/gpu/compare.png")
    ap.add_argument("--roofline", default=None,
                    help="'bf16'|'int8'|'int4'|'fp32' or a GFLOPS value")
    ap.add_argument("--title", default=None)
    args = ap.parse_args(argv)
    plot_mfiles(args.mfiles, save=args.save, roofline=args.roofline,
                title=args.title)


if __name__ == "__main__":
    main()
