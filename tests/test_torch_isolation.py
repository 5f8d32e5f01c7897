"""The port stands alone: no JAX, nothing of the JAX package, no nvcc needed
to import it.
"""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "how_to_optimize_gemm_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in PORT.rglob("*.py"))

_IMPORT_JAX = re.compile(r"^\s*(import|from)\s+(jax|jaxlib)\b", re.M)
_IMPORT_REF = re.compile(
    r"^\s*(import|from)\s+how_to_optimize_gemm_tpu(\.|\s|$)", re.M)


def test_port_modules_found():
    assert "how_to_optimize_gemm_tpu_torch.ops.int8" in MODULES
    assert "how_to_optimize_gemm_tpu_torch.harness.driver" in MODULES
    for name in ("models.linear", "models.llama", "parallel.serving",
                 "ops.kv_update", "ops.decode_attention"):
        assert f"how_to_optimize_gemm_tpu_torch.{name}" in MODULES, name
    assert len(MODULES) >= 20


def test_no_port_file_imports_jax_or_the_jax_package():
    files = [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]
    for path in files:
        text = path.read_text()
        assert not _IMPORT_JAX.search(text), path
        assert not _IMPORT_REF.search(text), path
    for path in PORT.rglob("*.cu*"):
        assert "jax" not in path.read_text().lower(), path


def test_every_port_module_imports_with_jax_blocked():
    """A fresh interpreter where ``import jax`` fails imports every port
    module (and the chip smoke script) and never loads the JAX package."""
    code = "\n".join([
        "import importlib, sys",
        "sys.modules['jax'] = None",
        "sys.modules['jaxlib'] = None",
        f"for name in {MODULES!r} + ['chip_smoke']:",
        "    importlib.import_module(name)",
        "bad = [m for m in sys.modules",
        "       if m == 'how_to_optimize_gemm_tpu'",
        "       or m.startswith('how_to_optimize_gemm_tpu.')]",
        "assert not bad, bad",
        "print('ok', len(sys.modules))",
    ])
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_kernel_loader_imports_without_nvcc(monkeypatch):
    """Every kernel has its source and its own C signature (ctypes
    argtypes: pointers and the trailing stream as c_void_p), all known
    without nvcc."""
    import ctypes
    from how_to_optimize_gemm_tpu_torch import _build
    assert set(_build.KERNELS) == {
        "int8_gemm_nn", "int8_gemm_nt", "w4a8_gemm", "w4a8_gemm_noc",
        "w4a8_gemv_fq", "kv_update", "decode_attention"}
    for name, kernel in _build.KERNELS.items():
        assert (_build.CSRC / kernel.source).exists(), name
        assert kernel.argtypes[-1] is ctypes.c_void_p, name
        assert set(kernel.argtypes) <= {ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_float}, name
        text = (_build.CSRC / kernel.source).read_text()
        assert f'extern "C" int {name}(' in text, name
    assert len(_build.KERNELS["decode_attention"].argtypes) == 13
    assert len(_build.KERNELS["kv_update"].argtypes) == 9
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", str(ROOT / "no-such-cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc()


def test_launch_counts_reset():
    from how_to_optimize_gemm_tpu_torch import _build
    _build.LAUNCHES["int8_gemm_nn"] += 3
    _build.reset_launches()
    assert set(_build.LAUNCHES.values()) == {0}


def test_chip_smoke_refuses_without_a_card():
    """Without CUDA the smoke script exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
