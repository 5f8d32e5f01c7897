"""Per-transition comparison figures from the port's sweeps.

Counterpart of ``how_to_optimize_gemm_tpu/viz/transitions.py``: every
consecutive pair of the ladder's tutorial order with both ``.m`` files
present gets one old-vs-new figure, and the int8, bf16 and fp32 families
get one chart each against their vendor bar. ``LADDER_ORDER`` lists every
rung, in the reference's order.

    python -m how_to_optimize_gemm_tpu_torch.viz.transitions \\
        --outputs outputs/gpu --save-dir figures/gpu
"""
from __future__ import annotations

import argparse
import pathlib

from how_to_optimize_gemm_tpu_torch.viz.plot import plot_mfiles

# Tutorial order (ops/registry.py), the reference's; each
# consecutive pair is one "optimization step" figure, judged against its
# family's ceiling.
LADDER_ORDER = [
    ("00_naive_vpu", "fp32"),
    ("01_xla_fp32", "fp32"),
    ("01b_xla_bf16", "bf16"),
    ("02_pallas_mn_tile", "fp32"),
    ("03_pallas_k_blocked", "fp32"),
    ("03b_pallas_small_blocks", "fp32"),
    ("04_pallas_tuned_fp32", "fp32"),
    ("05_pallas_bf16", "bf16"),
    ("06v_xla_int8", "int8"),
    ("06_pallas_int8", "int8"),
    ("07_pallas_int4", "bf16"),     # W4A16 computes on the bf16 path
    ("07b_pallas_w4a8", "int8"),
    ("08_manual_dma_int8", "int8"),
    ("09_fat_tile_int8", "int8"),
    ("10_packed_fat_int8", "int8"),
    ("11_strip_resident_int8", "int8"),
    ("12_resident_int8", "int8"),
    ("13_tiled_resident_int8", "int8"),
    ("14_packed_alias_int8", "int8"),
    ("17_hand_pipeline_int8", "int8"),
    ("18_ragged_m_int8", "int8"),
    ("15_packed_alias_bf16", "bf16"),
    ("16_packed_alias_fp32", "fp32"),
]

HEADLINE = ["06v_xla_int8", "06_pallas_int8", "07b_pallas_w4a8",
            "11_strip_resident_int8", "14_packed_alias_int8"]
FAMILIES = {
    "bf16": ["01b_xla_bf16", "05_pallas_bf16", "15_packed_alias_bf16"],
    "fp32": ["01_xla_fp32", "00_naive_vpu", "02_pallas_mn_tile",
             "03_pallas_k_blocked", "03b_pallas_small_blocks",
             "04_pallas_tuned_fp32", "16_packed_alias_fp32"],
}


def generate(outputs="outputs/gpu", save_dir="figures/gpu") -> list[str]:
    out = pathlib.Path(outputs)
    save = pathlib.Path(save_dir)
    written: list[str] = []

    def mfile_of(name):
        p = out / f"output_{name}.m"
        return p if p.exists() else None

    for (old, _), (new, family) in zip(LADDER_ORDER, LADDER_ORDER[1:]):
        po, pn = mfile_of(old), mfile_of(new)
        if po is None or pn is None:
            continue
        dst = save / f"compare_{old}_{new}.png"
        plot_mfiles([po, pn], save=str(dst), roofline=family,
                    title=f"{old} → {new}")
        written.append(str(dst))

    headline = [p for p in map(mfile_of, HEADLINE) if p is not None]
    if headline:
        dst = save / "ladder_int8_family.png"
        plot_mfiles(headline, save=str(dst), roofline="int8",
                    title="int8 ladder vs the vendor bar")
        written.append(str(dst))

    for family, names in FAMILIES.items():
        paths = [p for p in map(mfile_of, names) if p is not None]
        if len(paths) >= 2:
            dst = save / f"ladder_{family}_family.png"
            plot_mfiles(paths, save=str(dst), roofline=family,
                        title=f"{family} ladder vs the vendor bar")
            written.append(str(dst))
    return written


def generate_small(outputs="outputs/gpu/small",
                   save_dir="figures/gpu") -> list[str]:
    """The small-size regime charts: one figure per dtype family over
    every rung with a small sweep under ``outputs``, plus the int8
    headline chart."""
    out = pathlib.Path(outputs)
    save = pathlib.Path(save_dir)
    written: list[str] = []
    fam_members: dict[str, list[pathlib.Path]] = {}
    for name, family in LADDER_ORDER:
        p = out / f"output_{name}.m"
        if p.exists():
            fam_members.setdefault(family, []).append(p)
    for family, paths in fam_members.items():
        if len(paths) < 2:
            continue
        dst = save / f"ladder_small_{family}.png"
        plot_mfiles(paths, save=str(dst), roofline=family,
                    title=f"{family} ladder, small sizes")
        written.append(str(dst))
    headline = [out / f"output_{n}.m" for n in HEADLINE]
    headline = [p for p in headline if p.exists()]
    if len(headline) >= 2:
        dst = save / "ladder_small_sizes.png"
        plot_mfiles(headline, save=str(dst), roofline="int8",
                    title="small-size regime: launch overhead and ramp")
        written.append(str(dst))
    return written


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--outputs", default="outputs/gpu")
    ap.add_argument("--save-dir", default="figures/gpu")
    ap.add_argument("--small", action="store_true",
                    help="generate the small-size regime charts from "
                         "--outputs (default outputs/gpu/small)")
    args = ap.parse_args(argv)
    if args.small:
        src = ("outputs/gpu/small" if args.outputs == "outputs/gpu"
               else args.outputs)
        written = generate_small(src, args.save_dir)
    else:
        written = generate(args.outputs, args.save_dir)
    print(f"{len(written)} figures")


if __name__ == "__main__":
    main()
