"""Device selection: the card unless the caller asks for the CPU.

Counterpart of ``how_to_optimize_gemm_tpu/utils/env.py``. There is no
interpret mode: on the CPU the kernel wrappers run their plain PyTorch
versions, and they do so only because the tensors they were given lie on
the CPU, which only an explicit ``device="cpu"`` produces.
"""
from __future__ import annotations

import subprocess

import torch


def default_device(device=None) -> torch.device:
    """``cuda`` by default; ``cpu`` only when asked for.

    Raises RuntimeError when CUDA is absent and the CPU was not asked
    for: a measurement that finds no card fails, it does not fall back."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{device} requested but CUDA is not available")
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device; pass device='cpu' to run the plain PyTorch "
            "versions on the host")
    return torch.device("cuda")


def kernel_routes_for(x: torch.Tensor, kernel_routes=None) -> bool:
    """Whether a computation on ``x`` takes its kernel routes (the
    reference's ``use_pallas``): always on the card, on the CPU only when
    asked (through the kernels' plain versions)."""
    if x.is_cuda:
        if kernel_routes is False:
            raise ValueError("on the card the model runs the kernel routes")
        return True
    return bool(kernel_routes)


def card_line(index: int = 0) -> str:
    """Card ``index``'s name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (every
    number kept from the card stands beside this line)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(index)],
        capture_output=True, text=True, check=True,
        timeout=30).stdout.strip()
