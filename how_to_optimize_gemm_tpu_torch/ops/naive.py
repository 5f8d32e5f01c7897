"""Rung 00, the naive baseline: one thread per output, no reuse.

Counterpart of ``how_to_optimize_gemm_tpu/ops/naive_vpu.py`` (``mmult``).
The reference is plain JAX, not Pallas: K rank-1 updates
``C += outer(A[:, p], B[p, :])`` on the TPU's vector unit, the matrix unit
idle, the accumulator started at C. Its point is "every FLOP, none of the
fast path", so the port does not call a library matmul here: ``mmult``
launches ``csrc/naive_gemm.cu``, the tutorial's naive CUDA kernel (one
thread per output, its own fmaf chain over K started at C, A and B read
straight from global memory).

The wrapper launches its kernel for CUDA tensors and runs its plain
version (``naive_ref``) only for CPU tensors.
"""
from __future__ import annotations

import torch

from how_to_optimize_gemm_tpu_torch.ops.int8 import require_cuda
from how_to_optimize_gemm_tpu_torch.ops.tuned import launch_gemm
from how_to_optimize_gemm_tpu_torch.ops.vendor import fp32_matmul


def naive_ref(a, b, c):
    """Plain version of rung 00: ``C + A @ B`` in fp32, a fresh output."""
    return c + fp32_matmul(a, b)


def mmult(a, b, c):
    """Rung 00: ``C' = C + A @ B`` in fp32, a fresh (M, N) output (kernel
    ``naive_gemm``); ``c`` is not modified."""
    if c.device.type == "cpu":
        return naive_ref(a, b, c)
    require_cuda("naive.mmult", c)
    return launch_gemm("naive.mmult", "naive_gemm", a, b, c,
                       torch.empty_like(c), torch.float32, bt=False,
                       align=False)
