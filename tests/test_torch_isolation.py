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
                 "ops.kv_update", "ops.decode_attention",
                 "ops.paged_attention", "ops.attention", "parallel.kv_alloc",
                 "utils.native", "ops.tuned", "ops.vendor", "ops.naive",
                 "ops.mn_tile", "ops.k_blocked", "harness.profiling",
                 "viz.plot", "viz.transitions", "parallel.training",
                 "models.checkpoint", "ops.grouped_gemm", "parallel.moe",
                 "parallel.moe_bench", "ops.probes", "ops.dispatch_probe",
                 "harness.ab", "ops.manual_dma", "ops.hand_pipeline"):
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


def test_only_viz_imports_matplotlib():
    """matplotlib is imported by ``viz/`` alone: a fresh interpreter where
    ``import matplotlib`` fails imports every other port module and the
    chip smoke script (the card's machine need not have it)."""
    viz = "how_to_optimize_gemm_tpu_torch.viz"
    for path in PORT.rglob("*.py"):
        if "viz" not in path.relative_to(PORT).parts:
            assert "matplotlib" not in path.read_text(), path
            assert viz not in path.read_text(), path
    assert viz not in (ROOT / "chip_smoke.py").read_text()
    others = [m for m in MODULES if not m.startswith(viz)]
    code = "\n".join([
        "import importlib, sys",
        "sys.modules['matplotlib'] = None",
        f"for name in {others!r} + ['chip_smoke']:",
        "    importlib.import_module(name)",
        "print('ok')",
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
        "w4a8_gemv_fq", "kv_update", "decode_attention", "int8_gemm_noc",
        "w4a16_gemm_noc", "w4a16_gemv", "decode_attention_q8",
        "paged_kv_update", "paged_decode_attention",
        "paged_decode_attention_q8", "flash_attention", "bf16_gemm_nt",
        "bf16_gemm_nn", "fp32_gemm_nt", "fp32_gemm_nn", "w4a16_gemm",
        "naive_gemm", "fp32_gemm_mn_tile", "fp32_gemm_k_blocked",
        "flash_attention_fwd_lse", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv", "grouped_gemm", "grouped_gemm_t",
        "grouped_gemm_t4", "grouped_dw", "mma_chain", "mma_throughput",
        "exp_chain", "ffma_chain", "copy_grid", "tile_read", "smem_copy",
        "load_latency", "pipelined_copy", "add_one", "int8_dma_nn",
        "int8_fat_nn", "int8_fat_nt", "int8_strip_nt", "int8_resident_nt",
        "int8_tiled_resident_nt", "int8_pretile", "int8_hand_pipe_nt",
        "int8_ragged_nt", "split_bf16"}
    for name, kernel in _build.KERNELS.items():
        assert (_build.CSRC / kernel.source).exists(), name
        assert kernel.argtypes[-1] is ctypes.c_void_p, name
        assert set(kernel.argtypes) <= {ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_float}, name
        text = (_build.CSRC / kernel.source).read_text()
        assert f'extern "C" int {name}(' in text, name
    # q, the caches, lengths, out, the split walk's workspace (partials,
    # counters), B, T, KVH, REP, D, bk, the chunks a split, the scale, the
    # stream
    assert len(_build.KERNELS["decode_attention"].argtypes) == 16
    # and with the KV8 scales after each int8 cache
    assert len(_build.KERNELS["decode_attention_q8"].argtypes) == 18
    assert len(_build.KERNELS["kv_update"].argtypes) == 9
    # x split (or fp32 x), the stack, block_expert, the scales, out, Tp,
    # N, K, lda, ldw, bt, E, kind, the stream
    assert len(_build.KERNELS["grouped_gemm"].argtypes) == 14
    # dy split (or fp32 dy), the stack, block_expert, out, Tp, N, K, lda,
    # ldw, bt, E, kind (not for the packed entry), the stream
    assert len(_build.KERNELS["grouped_gemm_t"].argtypes) == 13
    assert len(_build.KERNELS["grouped_gemm_t4"].argtypes) == 12
    assert len(_build.KERNELS["split_bf16"].argtypes) == 7
    # pool, new, pages, offs (unstacked), mask, B, S, NP, PS, row_bytes,
    # the stream
    assert len(_build.KERNELS["paged_kv_update"].argtypes) == 11
    # the paged bf16 kernel takes the split walk's workspace and its C, as
    # the KV8 one does (without the two scale pools)
    assert len(_build.KERNELS["paged_decode_attention"].argtypes) == 18
    # x, packed, sw, out, M, N, K, ldx, Kp, ldp, cluster, the stream
    assert len(_build.KERNELS["w4a8_gemv_fq"].argtypes) == 12
    assert len(_build.KERNELS["paged_decode_attention_q8"].argtypes) == 20
    assert len(_build.KERNELS["flash_attention"].argtypes) == 25
    assert len(_build.KERNELS["flash_attention_fwd_lse"].argtypes) == 25
    assert len(_build.KERNELS["flash_attention_bwd_dq"].argtypes) == 30
    assert len(_build.KERNELS["flash_attention_bwd_dkv"].argtypes) == 34
    for name in ("int8_gemm_noc", "w4a16_gemm_noc", "w4a16_gemv",
                 "bf16_gemm_nt", "bf16_gemm_nn", "fp32_gemm_nt",
                 "fp32_gemm_nn", "w4a16_gemm", "naive_gemm",
                 "fp32_gemm_mn_tile", "fp32_gemm_k_blocked"):
        assert ctypes.c_float not in _build.KERNELS[name].argtypes, name
    for name in ("bf16_gemm_nt", "bf16_gemm_nn", "fp32_gemm_nt",
                 "fp32_gemm_nn", "naive_gemm", "fp32_gemm_mn_tile"):
        assert len(_build.KERNELS[name].argtypes) == 11, name
    assert len(_build.KERNELS["w4a16_gemm"].argtypes) == 12
    # the float GEMM's arguments and the block edge before the stream
    assert len(_build.KERNELS["fp32_gemm_k_blocked"].argtypes) == 12
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
