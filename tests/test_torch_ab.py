"""The port's interleaved A/B protocol (``how_to_optimize_gemm_tpu_torch/
harness/ab.py``), the counterpart of ``tests/test_ab.py``, on the CPU:
bookkeeping, the gate before timing, artifact accumulation, the default
directory, the ceiling rule and ``--tuned``."""
import json
import pathlib

import pytest
import torch

from how_to_optimize_gemm_tpu_torch.harness import ab

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
A, B = "02_pallas_mn_tile", "01_xla_fp32"


@pytest.fixture(autouse=True)
def short_windows(monkeypatch):
    """Windows of 20 ms keep the CPU sessions short."""
    monkeypatch.setattr(ab, "WINDOW_S", 0.02)


def test_ab_protocol_counts_and_artifact(tmp_path):
    res = ab.run_protocol(A, B, [128], rounds=3, artifact_dir=tmp_path,
                          verbose=False, device="cpu")
    assert len(res) == 1
    r = res[0]
    assert r.wins_a + r.wins_b + r.ties == r.rounds == 3
    assert len(r.a_gflops) == len(r.b_gflops) == 3
    assert r.a_median > 0 and r.b_median > 0
    assert r.a_median == ab._median(r.a_gflops)
    path = tmp_path / f"ab_{A}_vs_{B}.json"
    data = json.loads(path.read_text())
    assert data["a"] == A and data["b"] == B
    assert len(data["sessions"]) == 1
    assert data["sessions"][0]["device"] == "cpu"
    # a second session appends (the multi-day record)
    ab.run_protocol(A, B, [128], rounds=3, artifact_dir=tmp_path,
                    verbose=False, device="cpu")
    data = json.loads(path.read_text())
    assert len(data["sessions"]) == 2
    sz = data["sessions"][1]["sizes"][0]
    assert sz["p"] == 128 and len(sz["a_gflops"]) == 3


def test_ab_median():
    assert ab._median([3.0, 1.0, 2.0]) == 2.0
    assert ab._median([4.0, 1.0, 2.0, 3.0]) == 2.5


def test_default_artifact_dir_is_the_ports_outputs():
    assert ab.DEFAULT_DIR == ROOT / "outputs" / "gpu"


def test_tuned_raises_naming_the_roadmap_item(tmp_path):
    with pytest.raises(NotImplementedError, match="A18"):
        ab.main(["--a", A, "--b", B, "--p", "128", "--tuned", "--device",
                 "cpu", "--artifact-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())


def test_reading_above_the_ceiling_is_a_broken_session(tmp_path,
                                                       monkeypatch):
    monkeypatch.setitem(ab.H100_PEAKS, "fp32", (1e-9, 3350.0))
    with pytest.raises(RuntimeError, match="broken session"):
        ab.run_protocol(A, B, [64], rounds=1, artifact_dir=tmp_path,
                        verbose=False, device="cpu")


def test_gate_trips_before_timing(monkeypatch):
    """A rung whose output is wrong raises before any window is timed."""
    from how_to_optimize_gemm_tpu_torch.ops import registry
    rung = registry.get(A)
    monkeypatch.setitem(registry.LADDER, A, rung.__class__(
        **{**rung.__dict__, "run": lambda a, b, c: rung.run(a, b, c) + 1.0}))
    with pytest.raises(RuntimeError, match="gate trip"):
        ab._prep(A, 64, 64, 64, device="cpu")
