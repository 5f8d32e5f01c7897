"""Port tooling: the roofline, the per-op profile, the driver's
``--roofline --trace`` and the plots, on the CPU.

Tolerances: the roofline's bound and share equal the formula's to 1e-12
relative (the same arithmetic); the CPU profile is labelled as the CPU's,
never as a device time; plots are PNG files that exist and are not empty
(as tests/test_viz.py holds the reference's).
"""
import dataclasses
import importlib.util
import pathlib

import pytest
import torch

from how_to_optimize_gemm_tpu_torch.harness import driver, mfile, profiling
from how_to_optimize_gemm_tpu_torch.harness.parameters import SweepConfig
from how_to_optimize_gemm_tpu_torch.ops import registry

torch.set_num_threads(1)


@dataclasses.dataclass
class Row:
    p: int
    m: int
    n: int
    k: int
    gflops: float


def test_roofline_matches_the_formula():
    """Rung 03 at 4096 (compute-bound at the fp32 ceiling, three bf16
    products: 989 / 3 TFLOP/s) and rung 07b at m = 8 (W4A8: int8 A, int4
    B; memory-bound)."""
    pt = profiling.roofline("03_pallas_k_blocked", 4096, 4096, 4096,
                            33_000.0)
    assert pt.bound == "compute"
    assert pt.compute_ceiling_gflops == pytest.approx(989_000.0 / 3,
                                                      rel=1e-12)
    assert pt.fraction_of_ceiling == pytest.approx(0.1001011122345, rel=1e-9)
    flops = 2.0 * 4096 ** 3
    io = 2 * 4096 * 4096 * 4 + 2 * 4096 * 4096 * 4
    assert pt.memory_ceiling_gflops == pytest.approx(
        flops / (io / 3.35e12) / 1e9, rel=1e-12)

    m, n, k = 8, 4096, 4096
    pt = profiling.roofline("07b_pallas_w4a8", m, n, k, 100.0)
    io = m * k * 1.0 + k * n * 0.5 + 2 * m * n * 4
    mem = 2.0 * m * n * k / (io / 3.35e12) / 1e9
    assert pt.bound == "memory"
    assert pt.compute_ceiling_gflops == pytest.approx(1_979_000.0)
    assert pt.memory_ceiling_gflops == pytest.approx(mem, rel=1e-12)
    assert pt.fraction_of_ceiling == pytest.approx(100.0 / mem, rel=1e-12)


def test_roofline_report_rows():
    text = profiling.roofline_report(
        [Row(4096, 4096, 4096, 4096, 33_000.0)], "03_pallas_k_blocked")
    lines = text.splitlines()
    assert "H100 SXM" in lines[0] and "FFMA 67000" in lines[0]
    assert lines[1].split() == ["p", "achieved", "bound", "ceiling", "%",
                                "of", "ceiling", "%", "of", "FFMA"]
    assert lines[2].split() == ["4096", "33000", "compute", "329667",
                                "10.0%", "49.3%"]
    # the vendor bar's table has no FFMA column
    text = profiling.roofline_report(
        [Row(1024, 1024, 1024, 1024, 1.0)], "06v_xla_int8")
    assert "FFMA" not in text


def test_roofline_takes_measured_peaks():
    """A caller may pass ceilings built from the probes' readings, in
    ``H100_PEAKS``'s form; the default stays the data sheet's."""
    peaks = {"fp32": (40_000.0, 3_000.0), "bf16": (600_000.0, 3_000.0),
             "int8": (1_200_000.0, 3_000.0), "int4": (600_000.0, 3_000.0)}
    pt = profiling.roofline("03_pallas_k_blocked", 4096, 4096, 4096,
                            20_000.0, peaks=peaks)
    assert pt.bound == "compute"
    assert pt.compute_ceiling_gflops == 40_000.0
    assert pt.fraction_of_ceiling == pytest.approx(0.5)
    default = profiling.roofline("03_pallas_k_blocked", 4096, 4096, 4096,
                                 20_000.0)
    assert default.compute_ceiling_gflops == pytest.approx(989_000.0 / 3)
    rows = [Row(4096, 4096, 4096, 4096, 20_000.0)]
    text = profiling.roofline_report(rows, "03_pallas_k_blocked", peaks)
    assert "the caller's ceilings" in text.splitlines()[0]
    assert text.splitlines()[2].split()[3:5] == ["40000", "50.0%"]
    ops = [profiling.OpStat("k", "cuda kernel", 1, 1000.0, 3e9, 2e13)]
    table = profiling.trace_table(ops, compute_dtype="int8", peaks=peaks)
    assert "1200000 GFLOPS int8" in table and "3000 GB/s" in table
    assert "the caller's ceilings" in table


def test_chip_smoke_reads_the_same_ceilings():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parent.parent
        / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.PEAKS == {"int8": profiling.PEAK_INT8_OPS,
                                "bf16": profiling.PEAK_BF16_FLOPS,
                                "fp32": profiling.PEAK_FP32_FLOPS}
    assert chip_smoke.PEAK_BYTES == profiling.PEAK_BYTES


@pytest.mark.parametrize("name", ["03_pallas_k_blocked", "06_pallas_int8"])
def test_trace_rung_on_the_cpu(name, tmp_path):
    ops, path = profiling.trace_rung(name, 128, logdir=tmp_path,
                                     device="cpu")
    assert ops and all(o.category == "cpu op" and o.count > 0
                       and o.time_us > 0 for o in ops)
    assert [o.time_us for o in ops] == sorted(
        (o.time_us for o in ops), reverse=True)
    assert ops[0].model_flops == 2.0 * 128 ** 3 * profiling.TRACE_REPS
    assert all(o.model_flops == 0 for o in ops[1:])
    assert (tmp_path / f"{name}_p128.json").exists() and path
    table = profiling.trace_table(ops, compute_dtype="fp32")
    lines = table.splitlines()
    assert "CPU profile" in lines[0] and "device" not in lines[0]
    assert "cpu ms" in lines[1] and "dev ms" not in lines[1]
    assert len(lines) == 2 + len(ops)


def test_short_kernel_names():
    assert profiling._short(
        "void (anonymous namespace)::fp32_gemm_k_blocked_kernel<128>"
        "(float const*, float const*, float const*, float*, int, int, int,"
        " int, int, int)") == "fp32_gemm_k_blocked_kernel<128>"
    assert profiling._short("aten::mm") == "aten::mm"


def test_serve_profile_finds_flash_by_its_device_name():
    """serve_profile's flash time sums flash_attention's kernel alone: the
    wgmma flash forward without q's split, neither the training forward
    (the same template with the split) nor the grouped GEMM's kernel."""
    from how_to_optimize_gemm_tpu_torch.harness import serve_profile
    found = serve_profile.is_flash_kernel
    assert found("void htog::fw::flash_fwd<128, false>(CUtensorMap_st, "
                 "CUtensorMap_st, CUtensorMap_st, htog::fw::Params)")
    assert not found("void htog::fw::flash_fwd<64, true>(CUtensorMap_st, "
                     "CUtensorMap_st, CUtensorMap_st, htog::fw::Params)")
    assert not found("void htog::gg::grouped_wgmma<0, false>(CUtensorMap_st,"
                     " CUtensorMap_st, int const*)")


def test_driver_roofline_and_trace_on_the_cpu(tmp_path, capsys):
    results = driver.main(["--new", "03_pallas_k_blocked", "--old",
                           "02_pallas_mn_tile", "--pfirst", "64", "--plast",
                           "128", "--pinc", "64", "--nrepeats", "1",
                           "--output-dir", str(tmp_path), "--roofline",
                           "--trace", "--device", "cpu"])
    out = capsys.readouterr().out
    assert set(results) == {"02_pallas_mn_tile", "03_pallas_k_blocked"}
    for name, res in results.items():
        assert [r.p for r in res["rows"]] == [64, 128]
        assert all(r.kernel_rel < registry.get(name).gate_rel
                   for r in res["rows"])
        assert res["trace"]
        assert f"rung {name}: top-down roofline" in out
        assert f"[{name} p=128, capture:" in out
        assert (tmp_path / "profiles" / f"{name}_p128.json").exists()
    for tag in ("old", "new"):
        assert (tmp_path / f"output_{tag}.m").exists()


def test_driver_refuses_the_card_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.main(["--new", "00_naive_vpu", "--pfirst", "64", "--plast",
                     "64", "--output-dir", str(tmp_path)])


@pytest.fixture(scope="module")
def mfiles(tmp_path_factory):
    """The port's own sweeps at p = 64 on the CPU, as ``.m`` files."""
    out = tmp_path_factory.mktemp("outputs")
    cfg = SweepConfig(pfirst=64, plast=64, pinc=1, nrepeats=1, warmup=0)
    for name in ("00_naive_vpu", "01_xla_fp32", "01b_xla_bf16",
                 "06v_xla_int8", "06_pallas_int8"):
        driver.run_sweep(name, cfg, output_dir=out, verbose=False,
                         device="cpu")
    return out


def test_plot_mfiles_writes_a_png(mfiles, tmp_path):
    from how_to_optimize_gemm_tpu_torch.viz.plot import plot_mfiles
    for roofline in ("fp32", "int8", "123.0"):
        dst = tmp_path / f"fig_{roofline}.png"
        plot_mfiles([mfiles / "output_00_naive_vpu.m",
                     mfiles / "output_01_xla_fp32.m"], save=dst,
                    roofline=roofline)
        assert dst.exists() and dst.stat().st_size > 0
    version, rows = mfile.read_mfile(mfiles / "output_00_naive_vpu.m")
    assert version == "00_naive_vpu" and [r[0] for r in rows] == [64]


def test_transitions_generate(mfiles, tmp_path):
    """One figure per consecutive ladder pair present, plus the family
    charts (the reference's compare_*.png)."""
    from how_to_optimize_gemm_tpu_torch.viz.transitions import (
        LADDER_ORDER, generate)
    assert [n for n, _ in LADDER_ORDER] == [
        "00_naive_vpu", "01_xla_fp32", "01b_xla_bf16", "02_pallas_mn_tile",
        "03_pallas_k_blocked", "03b_pallas_small_blocks",
        "04_pallas_tuned_fp32", "05_pallas_bf16", "06v_xla_int8",
        "06_pallas_int8", "07_pallas_int4", "07b_pallas_w4a8",
        "08_manual_dma_int8", "09_fat_tile_int8", "10_packed_fat_int8",
        "11_strip_resident_int8", "12_resident_int8",
        "13_tiled_resident_int8", "14_packed_alias_int8",
        "17_hand_pipeline_int8", "18_ragged_m_int8",
        "15_packed_alias_bf16",
        "16_packed_alias_fp32"]
    assert sorted(n for n, _ in LADDER_ORDER) == registry.names()
    written = generate(outputs=mfiles, save_dir=tmp_path / "figs")
    names = [w.rsplit("/", 1)[-1] for w in written]
    assert names == [
        "compare_00_naive_vpu_01_xla_fp32.png",
        "compare_01_xla_fp32_01b_xla_bf16.png",
        "compare_06v_xla_int8_06_pallas_int8.png",
        "ladder_int8_family.png",
        "ladder_fp32_family.png",
    ]
    assert all((tmp_path / "figs" / n).stat().st_size > 0 for n in names)


def test_transitions_generate_small(mfiles, tmp_path):
    """The small-size charts: one per family with two sweeps or more
    (fp32: 00 and 01; int8: 06v and 06) and the int8 headline chart."""
    from how_to_optimize_gemm_tpu_torch.viz.transitions import (
        generate_small)
    written = generate_small(outputs=mfiles, save_dir=tmp_path)
    assert [w.rsplit("/", 1)[-1] for w in written] == [
        "ladder_small_fp32.png", "ladder_small_int8.png",
        "ladder_small_sizes.png"]
