"""Hardware probes: the card's own ceilings, measured on hand-written
kernels (B21).

Counterpart of ``how_to_optimize_gemm_tpu/ops/probes.py``, under the same
public names, so that each reading pairs with the reference's. The TPU's
units map onto Hopper's: "MXU" is the tensor cores (``mma.sync``, the
instruction every kernel of the port issues; the data sheet's peaks need
``wgmma``, ROADMAP A.2), "VPU" the CUDA cores and the SFU, "VMEM" an SM's
shared memory, "DMA" ``cp.async`` (global to shared memory), HBM the
card's HBM3.

Each probe has two parts:

- a function on tensors that returns what its kernel computes
  (``mxu_chain``, ``mxu_throughput``, ``vpu_exp``, ``vpu_fma``,
  ``hbm_copy``, ``dma_chunk_checksum``, ``vmem_copy``,
  ``dma_latency_sum``, ``manual_copy``): the kernel for CUDA tensors
  (``csrc/probes_compute.cu``, ``csrc/probes_memory.cu``), its plain
  PyTorch version (``*_ref``) for CPU tensors, which the CPU tests hold
  against the reference's Pallas kernels in interpret mode;
- the timed reading built on it (``mxu_peak_gflops`` ... ``hbm_copy_manual_
  gbps``), on CUDA events on the card.

On the card every block holds its own tile, and a reading launches 12
tiles an SM (a whole number of waves at any occupancy from 1 to 4) or a
grid that fills every SM, so it covers the card. Default sizes and
iteration counts give each reading about 0.15 s of device time on an H100
(``_ASSUMED``: rates used only to size the work); on the CPU (only when
asked for) they are small. ``main`` prints each reading beside its
ceiling: the H100 SXM data sheet's (``harness/profiling.py``), or for the
SFU and shared memory the figure derived from NVIDIA's per-SM rates and
the card's maximum SM clock (``derived_ceilings``); a reading above 105%
of its ceiling is a broken measurement and raises. ``torch_stream_
bandwidth_gbps`` is the vendor bar of the copies, as XLA's stream is the
reference's.
"""
from __future__ import annotations

import subprocess
import time
from typing import Callable

import numpy as np
import torch

from how_to_optimize_gemm_tpu_torch import _build
from how_to_optimize_gemm_tpu_torch.harness.profiling import (
    PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_FFMA_FLOPS, PEAK_INT8_OPS,
    PEAK_TF32_FLOPS)
from how_to_optimize_gemm_tpu_torch.ops.vendor import fp32_matmul
from how_to_optimize_gemm_tpu_torch.utils.device import default_device

# C kind codes of mma_chain / mma_throughput
_KIND = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
_DTYPES = {"int8": torch.int8, "bfloat16": torch.bfloat16,
           "bf16": torch.bfloat16, "float32": torch.float32,
           "fp32": torch.float32}
TILE = 64               # mma_throughput's tile edge (rows and columns)
TILES_PER_SM = 12       # tiles a reading launches an SM
SLAB = 16384            # smem_copy's bytes a block
MAX_LATENCY_TILE = 16384
TARGET_S = 0.15         # device seconds a reading aims at on the card
# Rates on an H100, used only to size a reading's work (not ceilings).
_ASSUMED = {"chain int8": 2e14, "chain bfloat16": 1e14,
            "chain float32": 3e13, "mma": 5e14, "exp": 3e12, "ffma": 6e13,
            "hbm": 3e12, "smem": 2.5e13, "latency_s": 1e-6}
_CPU_RATE = 2e9         # the same, for every probe on the CPU
# NVIDIA, CUDA C Programming Guide (arithmetic instruction throughput and
# shared memory, compute capability 9.0): results an SM a clock
SFU_EX2_PER_CLOCK = 16
SMEM_BYTES_PER_CLOCK = 128   # 32 banks of 4 bytes
SHARE_LIMIT = 1.05


def _dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[str(dtype)]


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.int32 if dtype == torch.int8 else torch.float32


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 values modulo 2^32 as int32 (the kernels' wrapping sums)."""
    v = v.to(torch.int64) & 0xFFFFFFFF
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def _wrap8(v: torch.Tensor) -> torch.Tensor:
    """The low byte of each int as int8 (``astype(int8)``: wraps)."""
    v = v.to(torch.int64) & 0xFF
    return torch.where(v >= 128, v - 256, v).to(torch.int8)


def _t8(t: int) -> int:
    """``int8(t)``, wrapped."""
    return (t + 128) % 256 - 128


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int64 products of int8 operands: fp64 holds every partial sum
    exactly (|sum| <= K * 2^14 < 2^53)."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(
        torch.int64)


def _require(cond: bool, name: str, what: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {what}")


def _batched(x: torch.Tensor) -> tuple[torch.Tensor, bool]:
    return (x[None], True) if x.dim() == 2 else (x, False)


# ------------------------------------------------------------ the MXU

def mxu_chain_ref(x: torch.Tensor, y: torch.Tensor,
                  n_iters: int) -> torch.Tensor:
    """Plain version of ``mxu_chain``: from acc = astype(y), n_iters times
    acc = x @ cast(acc), int8 (int32 sums, cast keeps the low byte), bf16
    (fp32 sums, cast rounds to bf16) or fp32 (a full fp32 product)."""
    acc = y.to(_acc_dtype(x.dtype))
    for _ in range(n_iters):
        if x.dtype == torch.int8:
            acc = _wrap32(_int_matmul(x, _wrap8(acc)))
        elif x.dtype == torch.bfloat16:
            acc = fp32_matmul(x.to(torch.float32),
                              acc.to(torch.bfloat16).to(torch.float32))
        else:
            acc = fp32_matmul(x, acc)
    return acc


def mxu_chain(x: torch.Tensor, y: torch.Tensor, n_iters: int) -> torch.Tensor:
    """The tensor cores' serially dependent chain (the reference's
    ``_mxu_kernel``): acc = x @ cast(acc), n_iters times, one (S, S) tile
    a block. x, y (S, S) or (tiles, S, S) of int8, bf16 or fp32; returns
    acc, int32 or fp32. Kernel ``mma_chain`` on the card (S = 64 or 128;
    fp32 as 3xTF32), the plain version on the CPU."""
    if x.device.type == "cpu":
        return mxu_chain_ref(x, y, n_iters)
    xb, squeeze = _batched(x)
    yb, _ = _batched(y)
    name = "mma_chain"
    _require(x.dtype in _KIND and y.dtype == x.dtype, name,
             f"x and y must share int8, bf16 or fp32, got {x.dtype}, "
             f"{y.dtype}")
    _require(xb.shape == yb.shape and xb.dim() == 3
             and xb.shape[1] == xb.shape[2] and xb.shape[1] in (64, 128),
             name, f"square tiles of 64 or 128, got {tuple(x.shape)}, "
                   f"{tuple(y.shape)}")
    _require(n_iters >= 0, name, "n_iters >= 0")
    xb, yb = xb.contiguous(), yb.contiguous()
    out = torch.empty(xb.shape, dtype=_acc_dtype(x.dtype), device=x.device)
    if xb.shape[0]:
        _build.launch(name, x.device, xb, yb, out, xb.shape[0], xb.shape[1],
                      n_iters, _KIND[x.dtype])
    return out[0] if squeeze else out


def mxu_throughput_ref(x: torch.Tensor, y: torch.Tensor,
                       n_iters: int) -> torch.Tensor:
    """Plain version of ``mxu_throughput``: the sum over t < n_iters of
    vary(x, t) @ y, int8 with x ^ int8(t) (wrapping int32 sums), bf16 with
    x * (1 - 2 (t % 2)) (fp32 sums)."""
    if x.dtype == torch.int8:
        acc = torch.zeros(x.shape[:-1] + y.shape[-1:], dtype=torch.int64,
                          device=x.device)
        for t in range(n_iters):
            acc += _int_matmul(x ^ _t8(t), y)
        return _wrap32(acc)
    xf, yf = x.to(torch.float32), y.to(torch.float32)
    acc = torch.zeros(x.shape[:-1] + y.shape[-1:], dtype=torch.float32,
                      device=x.device)
    for t in range(n_iters):
        acc += fp32_matmul(-xf if t % 2 else xf, yf)
    return acc


def mxu_throughput(x: torch.Tensor, y: torch.Tensor,
                   n_iters: int) -> torch.Tensor:
    """The tensor cores' throughput pattern (the reference's
    ``_mxu_throughput_kernel``): independent products of one tile summed
    into one accumulator, acc += vary(x, t) @ y. x (M, K) or (tiles, M,
    K), y (K, N) likewise, int8 (x ^ int8(t)) or bf16 (sign flip on odd
    t). Kernel ``mma_throughput`` on the card (M = N = 64; K a multiple of
    128 for int8, 64 for bf16), the plain version on the CPU."""
    if x.device.type == "cpu":
        return mxu_throughput_ref(x, y, n_iters)
    xb, squeeze = _batched(x)
    yb, _ = _batched(y)
    name = "mma_throughput"
    _require(x.dtype in (torch.int8, torch.bfloat16) and y.dtype == x.dtype,
             name, f"int8 or bf16 operands, got {x.dtype}, {y.dtype}")
    tiles, m, k = xb.shape
    step = 128 if x.dtype == torch.int8 else 64
    _require(m == TILE and yb.shape == (tiles, k, TILE) and k % step == 0,
             name, f"(64, K) @ (K, 64) tiles with K a multiple of {step}, "
                   f"got {tuple(x.shape)}, {tuple(y.shape)}")
    _require(n_iters >= 0, name, "n_iters >= 0")
    xb = xb.contiguous()
    yt = yb.transpose(1, 2).contiguous()
    out = torch.empty((tiles, TILE, TILE), dtype=_acc_dtype(x.dtype),
                      device=x.device)
    if tiles:
        _build.launch(name, x.device, xb, yt, out, tiles, k, n_iters,
                      _KIND[x.dtype])
    return out[0] if squeeze else out


# ------------------------------------------------- the VPU: SFU and FFMA

def vpu_exp_ref(x: torch.Tensor, n_iters: int) -> torch.Tensor:
    """Plain version of ``vpu_exp``: acc += exp(x * (1 + 1e-7 t)), the
    scale and every product and sum in fp32."""
    acc = torch.zeros_like(x)
    for t in range(n_iters):
        s = np.float32(1.0) + np.float32(1e-7) * np.float32(t)
        acc = acc + torch.exp(x * float(s))
    return acc


def vpu_exp(x: torch.Tensor, n_iters: int) -> torch.Tensor:
    """The SFU's exp (the reference's ``_vpu_exp_kernel``): per element of
    an fp32 tensor, the sum over t < n_iters of exp(x (1 + 1e-7 t)).
    Kernel ``exp_chain`` on the card (``__expf``: ex2.approx, about 2 ulp
    a term), the plain version on the CPU."""
    if x.device.type == "cpu":
        return vpu_exp_ref(x, n_iters)
    _require(x.dtype == torch.float32, "exp_chain", f"fp32, got {x.dtype}")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel():
        _build.launch("exp_chain", x.device, x, out, x.numel(), n_iters)
    return out


def vpu_fma_ref(x: torch.Tensor, n_iters: int,
                dependent: bool) -> torch.Tensor:
    """Plain version of ``vpu_fma``. fmaf(a, m, y) is taken in fp64 (the
    product of two fp32 values is exact there) and rounded to fp32: one
    rounding more than fmaf's, which moves a result by one ulp only on a
    halfway case."""
    m = float(np.float32(1.000001))
    y = x.to(torch.float64)

    def fma(a):
        return (a.to(torch.float64) * m + y).to(torch.float32)
    if dependent:
        acc = x
        for _ in range(n_iters * 8):
            acc = fma(acc)
        return acc
    accs = [x, x * 2.0, x * 3.0, x * 4.0]
    for _ in range(n_iters):
        accs = [fma(a) for a in accs]
    return accs[0] + accs[1] + accs[2] + accs[3]


def vpu_fma(x: torch.Tensor, n_iters: int, dependent: bool) -> torch.Tensor:
    """The CUDA cores' FFMA chains (the reference's ``_vpu_kernel``): per
    element of an fp32 tensor, 8 dependent acc = fma(acc, 1.000001, x) an
    iteration from acc = x (func1.S), or 4 independent chains from x, 2x,
    3x, 4x summed at the end (func2.S). Kernel ``ffma_chain`` on the card,
    the plain version on the CPU."""
    if x.device.type == "cpu":
        return vpu_fma_ref(x, n_iters, dependent)
    _require(x.dtype == torch.float32, "ffma_chain", f"fp32, got {x.dtype}")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel():
        _build.launch("ffma_chain", x.device, x, out, x.numel(), n_iters,
                      int(dependent))
    return out


# ------------------------------------------------------ HBM and the DMA

def hbm_copy_ref(src: torch.Tensor, dst: torch.Tensor | None = None):
    """Plain version of ``hbm_copy``."""
    dst = torch.empty_like(src) if dst is None else dst
    return dst.copy_(src)


def hbm_copy(src: torch.Tensor, dst: torch.Tensor | None = None):
    """One grid copy of ``src`` into ``dst`` (new when None), the
    reference's ``_copy_kernel``: HBM read + write. Kernel ``copy_grid``
    on the card (16-byte words: the byte count a multiple of 16), the
    plain version on the CPU."""
    if src.device.type == "cpu":
        return hbm_copy_ref(src, dst)
    dst = torch.empty_like(src) if dst is None else dst
    nbytes = src.numel() * src.element_size()
    _require(src.is_contiguous() and dst.is_contiguous()
             and dst.shape == src.shape and dst.dtype == src.dtype
             and nbytes % 16 == 0, "copy_grid",
             "contiguous tensors of one shape and dtype, a multiple of 16 "
             "bytes")
    if nbytes:
        _build.launch("copy_grid", src.device, src, dst, nbytes // 16)
    return dst


def _chunk_walk(parent: int, rows: int, cols: int) -> tuple[int, int]:
    ni, nj = parent // rows, parent // cols
    nchunks = ni * nj
    # The reference walks chunks in double-buffered pairs: an odd count
    # would leave its last DMA unwaited, and one chunk measures nothing.
    if nchunks < 2 or nchunks % 2:
        raise ValueError(
            f"(rows={rows}, cols={cols}) gives {nchunks} chunks of the "
            f"{parent}x{parent} parent; the double-buffered walk needs "
            "an even count >= 2")
    return ni, nj


def dma_chunk_checksum_ref(x: torch.Tensor, rows: int, cols: int,
                           reps: int) -> torch.Tensor:
    """Plain version of ``dma_chunk_checksum``."""
    ni, nj = _chunk_walk(x.shape[0], rows, cols)
    chunks = x[:ni * rows, :nj * cols].reshape(ni, rows, nj, cols)
    total = int(chunks[:, :8, :, :128].to(torch.int64).sum()) * reps
    return _wrap32(torch.tensor([[total]], device=x.device))


def dma_chunk_checksum(x: torch.Tensor, rows: int, cols: int,
                       reps: int) -> torch.Tensor:
    """Reads of (rows, cols) int8 chunks out of a (parent, parent) int8
    array, every chunk ``reps`` times (the reference's ``_chunk_kernel``,
    double-buffered DMA): the int32 checksum, over every chunk read, of
    its [:8, :128] sliver. ValueError on an odd or single-chunk walk, as
    the reference. Kernel ``tile_read`` on the card (``cp.async`` into a
    two-stage ring; parent and cols multiples of 16, cols <= 16,384), the
    plain version on the CPU."""
    if x.device.type == "cpu":
        return dma_chunk_checksum_ref(x, rows, cols, reps)
    _chunk_walk(x.shape[0], rows, cols)
    parent = x.shape[0]
    _require(x.dtype == torch.int8 and x.shape == (parent, parent)
             and x.is_contiguous() and parent % 16 == 0 and cols % 16 == 0
             and cols <= 16384, "tile_read",
             f"a contiguous square int8 array, parent and cols multiples "
             f"of 16, cols <= 16384; got {tuple(x.shape)}, cols {cols}")
    out = torch.zeros((1, 1), dtype=torch.int32, device=x.device)
    if reps:
        _build.launch("tile_read", x.device, x, out, parent, rows, cols,
                      reps)
    return out


def vmem_copy_ref(x: torch.Tensor, n_iters: int) -> torch.Tensor:
    """Plain version of ``vmem_copy``."""
    out = None
    for t in range(n_iters):
        buf = x ^ _t8(t)
        out = buf.clone()
    return out


def vmem_copy(x: torch.Tensor, n_iters: int) -> torch.Tensor:
    """Copies through VMEM (the reference's ``_vmem_copy_kernel``): buf =
    x ^ int8(t), o = buf, n_iters >= 1 times; returns o = x ^ int8(n_iters
    - 1). Kernel ``smem_copy`` on the card (each block a 16 KB slab in
    shared memory, the copies through volatile 16-byte loads and stores;
    the size a multiple of 16 KB), the plain version on the CPU."""
    _require(n_iters >= 1, "smem_copy", "n_iters >= 1")
    if x.device.type == "cpu":
        return vmem_copy_ref(x, n_iters)
    nbytes = x.numel()
    _require(x.dtype == torch.int8 and x.is_contiguous()
             and nbytes % SLAB == 0, "smem_copy",
             f"contiguous int8, a multiple of {SLAB} bytes")
    out = torch.empty_like(x)
    if nbytes:
        _build.launch("smem_copy", x.device, x, out, nbytes // SLAB, n_iters)
    return out


def dma_latency_sum_ref(x: torch.Tensor, rows: int, n_iters: int,
                        load: bool = True) -> torch.Tensor:
    """Plain version of ``dma_latency_sum``."""
    nsrc = x.shape[0] // rows
    if not load or n_iters == 0:
        return torch.zeros((1, 1), dtype=torch.int32, device=x.device)
    seen = min(nsrc, n_iters)       # the sources some iteration loads
    sums = x[:seen * rows].reshape(seen, -1).sum(1, dtype=torch.int64)
    counts = torch.full((seen,), n_iters // nsrc, dtype=torch.int64,
                        device=x.device)
    counts[:n_iters % nsrc] += 1
    return _wrap32((sums * counts).sum().reshape(1, 1))


def dma_latency_sum(x: torch.Tensor, rows: int, n_iters: int,
                    load: bool = True) -> torch.Tensor:
    """One minimal chunk load, waited on, then summed, serially (the
    reference's ``_dma_latency_kernel``): x (rows * nsrc, cols) int8,
    iteration t loads rows t % nsrc; returns the int32 sum of every tile
    loaded, or 0 without the load (the baseline loop). Kernel
    ``load_latency`` on the card (one warp, one ``cp.async`` tile of at
    most 16 KB), the plain version on the CPU."""
    if x.device.type == "cpu":
        return dma_latency_sum_ref(x, rows, n_iters, load)
    tile = rows * x.shape[1]
    nsrc = x.shape[0] // rows
    _require(x.dtype == torch.int8 and x.dim() == 2 and x.is_contiguous()
             and nsrc >= 1 and tile % 16 == 0 and tile <= MAX_LATENCY_TILE,
             "load_latency", f"contiguous int8 (rows * nsrc, cols), a tile "
                             f"of 16 .. {MAX_LATENCY_TILE} bytes in 16s")
    out = torch.zeros((1, 1), dtype=torch.int32, device=x.device)
    _build.launch("load_latency", x.device, x, out, tile, nsrc, n_iters,
                  int(load))
    return out


def manual_copy_ref(src: torch.Tensor, rows: int, nslots: int, reps: int,
                    dst: torch.Tensor | None = None):
    """Plain version of ``manual_copy``."""
    dst = torch.empty_like(src) if dst is None else dst
    for _ in range(reps):
        dst.copy_(src)
    n = torch.tensor([[src.shape[0] // rows]], dtype=torch.int32,
                     device=src.device)
    return dst, n


def manual_copy(src: torch.Tensor, rows: int, nslots: int, reps: int,
                dst: torch.Tensor | None = None):
    """An HBM copy with ``nslots`` chunks in flight (the reference's
    ``_manual_copy_kernel``): src (total_rows, cols) fp32 in chunks of
    ``rows`` rows, copied ``reps`` times into ``dst`` (new when None);
    returns (dst, the chunk count as a (1, 1) int32). Kernel
    ``pipelined_copy`` on the card (an ``nslots``-stage ``cp.async`` ring
    through shared memory; a chunk a multiple of 16 bytes, nslots in 2, 3,
    4, 6, 8 and nslots chunks at most 227 KB), the plain version on the
    CPU."""
    if src.device.type == "cpu":
        return manual_copy_ref(src, rows, nslots, reps, dst)
    dst = torch.empty_like(src) if dst is None else dst
    cb = rows * src.shape[1] * src.element_size()
    nchunks = src.shape[0] // rows
    _require(src.dim() == 2 and src.is_contiguous() and dst.is_contiguous()
             and dst.shape == src.shape and dst.dtype == src.dtype
             and src.shape[0] % rows == 0 and cb % 16 == 0
             and nslots in (2, 3, 4, 6, 8) and nslots * cb <= 232448,
             "pipelined_copy", f"chunks of {rows} rows of {tuple(src.shape)}"
                               f" in {nslots} slots")
    n = torch.zeros((1, 1), dtype=torch.int32, device=src.device)
    _build.launch("pipelined_copy", src.device, src, dst, n, cb, nchunks,
                  nslots, reps)
    return dst, n


# ------------------------------------------------------------ readings

def _on_card(dev: torch.device) -> bool:
    return dev.type == "cuda"


def _sms(dev: torch.device) -> int:
    return (torch.cuda.get_device_properties(dev).multi_processor_count
            if _on_card(dev) else 1)


def _iters(dev: torch.device, work: float, rate_key: str) -> int:
    """Iterations of ``work`` units that take about TARGET_S at the
    assumed rate."""
    rate = _ASSUMED[rate_key] if _on_card(dev) else _CPU_RATE
    return max(1, int(TARGET_S * rate / work))


def seconds(fn: Callable[[], object], dev: torch.device,
            repeats: int = 2) -> float:
    """The best of ``repeats`` timings of one call of ``fn`` after one
    warm-up call: CUDA events on the card, the host clock on the CPU."""
    fn()
    best = float("inf")
    if _on_card(dev):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        for _ in range(repeats):
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) * 1e-3)
        return best
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _gen(dev: torch.device) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(0)


def chain_inputs(dtype, size: int, tiles: int, dev: torch.device):
    """The reference's chain inputs: int8 ones, else x uniform [0, 2 /
    size) (near-unit spectral scale keeps the chain finite) and y ones."""
    dt = _dtype(dtype)
    shape = (tiles, size, size)
    if dt == torch.int8:
        return (torch.ones(shape, dtype=dt, device=dev),
                torch.ones(shape, dtype=dt, device=dev))
    x = torch.rand(shape, generator=_gen(dev), device=dev) * (2.0 / size)
    return x.to(dt), torch.ones(shape, dtype=dt, device=dev)


def mxu_peak_gflops(dtype=torch.bfloat16, size: int = 128,
                    n_iters: int | None = None, tiles: int | None = None,
                    repeats: int = 2, device=None) -> float:
    """The tensor cores' chained (latency-bound) rate for (size, size)
    tiles of ``dtype`` (int8, bf16, or fp32 as 3xTF32), GFLOPS."""
    dev = default_device(device)
    tiles = tiles or TILES_PER_SM * _sms(dev)
    x, y = chain_inputs(dtype, size, tiles, dev)
    flops = 2.0 * size ** 3 * tiles
    n_iters = n_iters or _iters(dev, flops, f"chain {x.dtype}".replace(
        "torch.", ""))
    sec = seconds(lambda: mxu_chain(x, y, n_iters), dev, repeats)
    return flops * n_iters / sec / 1e9


def _throughput_gflops(dtype, size: int, depth: int, n_iters, tiles,
                       repeats: int, device) -> float:
    dev = default_device(device)
    tiles = tiles or TILES_PER_SM * _sms(dev)
    x = torch.ones((tiles, size, depth), dtype=dtype, device=dev)
    y = torch.ones((tiles, depth, size), dtype=dtype, device=dev)
    flops = 2.0 * size * size * depth * tiles
    n_iters = n_iters or _iters(dev, flops, "mma")
    sec = seconds(lambda: mxu_throughput(x, y, n_iters), dev, repeats)
    return flops * n_iters / sec / 1e9


def mxu_throughput_gflops(size: int = TILE, depth: int = 256,
                          n_iters: int | None = None,
                          tiles: int | None = None, repeats: int = 2,
                          device=None) -> float:
    """The tensor cores' int8 THROUGHPUT: independent accumulating
    products of (size, depth) @ (depth, size) int8 tiles, GFLOPS (ops)."""
    return _throughput_gflops(torch.int8, size, depth, n_iters, tiles,
                              repeats, device)


def mxu_depth_gflops(depth: int = 64, size: int = TILE,
                     n_iters: int | None = None, tiles: int | None = None,
                     repeats: int = 2, device=None) -> float:
    """The tensor cores' bf16 rate against CONTRACTION DEPTH: accumulating
    (size, depth) @ (depth, size) bf16 products (the flash d = 64
    question), GFLOPS."""
    return _throughput_gflops(torch.bfloat16, size, depth, n_iters, tiles,
                              repeats, device)


def _elements(dev: torch.device, per_sm: int, cpu: int) -> int:
    return per_sm * _sms(dev) if _on_card(dev) else cpu


def vpu_exp_gelems(size: int | None = None, n_iters: int | None = None,
                   repeats: int = 2, device=None) -> float:
    """The SFU's fp32 exp throughput on an (size, 1024) tile resident in
    registers, Gelem/s. Default size: 8 rows an SM (4 elements a thread
    at 2,048 threads an SM)."""
    dev = default_device(device)
    rows = size or _elements(dev, 8, 64)
    x = torch.full((rows, 1024), -0.5, dtype=torch.float32, device=dev)
    n_iters = n_iters or _iters(dev, x.numel(), "exp")
    sec = seconds(lambda: vpu_exp(x, n_iters), dev, repeats)
    return float(x.numel()) * n_iters / sec / 1e9


def vpu_peak_gflops(size: int | None = None, n_iters: int | None = None,
                    repeats: int = 2, dependent: bool = False,
                    device=None) -> float:
    """The CUDA cores' chained FFMA rate (gflops_benchmark's func1.S when
    ``dependent``, func2.S otherwise) on a (size, 512) fp32 tile, GFLOPS.
    Default size: 16 rows an SM."""
    dev = default_device(device)
    rows = size or _elements(dev, 16, 64)
    x = torch.full((rows, 512), 1e-6, dtype=torch.float32, device=dev)
    flops = 2.0 * (8 if dependent else 4) * x.numel()
    n_iters = n_iters or _iters(dev, flops, "ffma")
    sec = seconds(lambda: vpu_fma(x, n_iters, dependent), dev, repeats)
    return flops * n_iters / sec / 1e9


def _stream_rows(dev: torch.device, mbytes: int | None) -> int:
    mbytes = mbytes or (1024 if _on_card(dev) else 4)
    return max(mbytes * 1024 * 1024 // (4 * 2048), 1)


def _chained(step, a: torch.Tensor, chain: int):
    """``chain`` calls step(src, dst), ping-pong between a and a copy."""
    b = torch.empty_like(a)

    def run():
        src, dst = a, b
        for _ in range(chain):
            step(src, dst)
            src, dst = dst, src
    return run


def hbm_bandwidth_gbps(mbytes: int | None = None, chain: int | None = None,
                       repeats: int = 2, device=None) -> float:
    """HBM read+write bandwidth of chained grid copies (``copy_grid``),
    GB/s. Default: 1 GiB copied back and forth on the card."""
    dev = default_device(device)
    x = torch.ones((_stream_rows(dev, mbytes), 2048), device=dev)
    nbytes = 2.0 * x.numel() * 4
    chain = chain or _iters(dev, nbytes, "hbm")
    sec = seconds(_chained(hbm_copy, x, chain), dev, repeats)
    return nbytes * chain / sec / 1e9


def torch_stream_bandwidth_gbps(mbytes: int | None = None,
                                chain: int | None = None, repeats: int = 2,
                                device=None) -> float:
    """HBM read+write bandwidth of PyTorch's own streaming kernel, chained
    ``y * 1.000001`` (the vendor bar of the copies, as XLA's stream is
    the reference's), GB/s."""
    dev = default_device(device)
    x = torch.ones((_stream_rows(dev, mbytes), 2048), device=dev)
    nbytes = 2.0 * x.numel() * 4
    chain = chain or _iters(dev, nbytes, "hbm")
    sec = seconds(_chained(lambda s, d: torch.mul(s, 1.000001, out=d), x,
                           chain), dev, repeats)
    return nbytes * chain / sec / 1e9


def dma_chunk_bandwidth_gbps(rows: int, cols: int, parent: int | None = None,
                             reps: int | None = None,
                             device=None) -> float:
    """DMA read bandwidth for (rows, cols) int8 chunks out of a row-major
    (parent, parent) array (``cp.async`` into shared memory), GB/s.
    Default parent 65,536 on the card: 4 GiB, 80 times the 50 MB L2 (the
    L2 keeps part of a cyclic walk: on an NVIDIA H100 80GB HBM3 at
    700.00 W a 256 MB parent read at 4.0-4.4 TB/s, past the HBM's 3.35,
    and a 1 GiB one at 3.33-3.38)."""
    dev = default_device(device)
    parent = parent or (65536 if _on_card(dev) else 1024)
    _chunk_walk(parent, rows, cols)
    x = torch.ones((parent, parent), dtype=torch.int8, device=dev)
    reps = reps or _iters(dev, parent * parent, "hbm")
    sec = seconds(lambda: dma_chunk_checksum(x, rows, cols, reps), dev, 2)
    return parent * parent * reps / sec / 1e9


def vmem_bandwidth_gbps(mbytes: float | None = None,
                        n_iters: int | None = None, repeats: int = 2,
                        device=None) -> float:
    """VMEM (shared memory) read+write bandwidth through copies, GB/s:
    each iteration reads x, writes buf, reads buf and writes o. Default:
    4 slabs of 16 KB an SM on the card."""
    dev = default_device(device)
    if mbytes is None:
        nbytes = 4 * SLAB * _sms(dev)
    else:
        nbytes = max(int(mbytes * 1024 * 1024) // SLAB, 1) * SLAB
    x = torch.ones((nbytes // 2048, 2048), dtype=torch.int8, device=dev)
    n_iters = n_iters or _iters(dev, 4.0 * nbytes, "smem")
    sec = seconds(lambda: vmem_copy(x, n_iters), dev, repeats)
    return 4.0 * nbytes * n_iters / sec / 1e9


def dma_latency_ns(rows: int = 32, cols: int = 128,
                   n_iters: int | None = None, nsrc: int | None = None,
                   repeats: int = 2, device=None) -> float:
    """DMA issue + completion latency of one (rows, cols) int8 tile load
    (``cp.async``, global -> shared), serially dependent, minus the same
    loop without the load, ns. Default nsrc 2^20 on the card: 4 GiB of
    sources, more than the reading's iterations, so no tile is loaded
    twice and each load comes from HBM, not the L2."""
    dev = default_device(device)
    nsrc = nsrc or ((1 << 20) if _on_card(dev) else 8)
    x = torch.ones((rows * nsrc, cols), dtype=torch.int8, device=dev)
    if n_iters is None:
        n_iters = (int(TARGET_S / _ASSUMED["latency_s"]) if _on_card(dev)
                   else 64)
    t_load = seconds(lambda: dma_latency_sum(x, rows, n_iters, True), dev,
                     repeats)
    t_base = seconds(lambda: dma_latency_sum(x, rows, n_iters, False), dev,
                     repeats)
    return max(t_load - t_base, 0.0) / n_iters * 1e9


def hbm_copy_manual_gbps(mbytes: int | None = None, rows: int | None = None,
                         cols: int = 2048, nslots: int = 4,
                         reps: int | None = None, repeats: int = 2,
                         device=None) -> float:
    """HBM read+write bandwidth of a copy with ``nslots`` chunks of (rows,
    cols) fp32 in flight (``pipelined_copy``), GB/s. Defaults on the card:
    1 GiB in 16 KB chunks, 4 slots."""
    dev = default_device(device)
    card = _on_card(dev)
    mbytes = mbytes or (1024 if card else 4)
    rows = rows or (2 if card else 8)
    total_rows = mbytes * 1024 * 1024 // (4 * cols)
    total_rows = max((total_rows // (rows * nslots)) * rows * nslots,
                     rows * nslots)
    assert (total_rows // rows) % nslots == 0, (total_rows, rows, nslots)
    x = torch.ones((total_rows, cols), dtype=torch.float32, device=dev)
    dst = torch.empty_like(x)
    nbytes = 2.0 * x.numel() * 4
    reps = reps or _iters(dev, nbytes, "hbm")
    sec = seconds(lambda: manual_copy(x, rows, nslots, reps, dst), dev,
                  repeats)
    return nbytes * reps / sec / 1e9


# ------------------------------------------------------------ ceilings

def max_sm_clock_mhz(device=None) -> float | None:
    """The card's maximum SM clock (``nvidia-smi clocks.max.sm``), or None
    where nvidia-smi does not answer."""
    dev = default_device(device)
    if not _on_card(dev):
        return None
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits", "-i", str(index)],
            capture_output=True, text=True, check=True, timeout=30).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def derived_ceilings(device=None) -> dict:
    """Ceilings the data sheet does not give, from NVIDIA's per-SM rates
    (CUDA C Programming Guide, compute capability 9.0) times the SMs and
    the maximum SM clock: the SFU's ex2 (Gelem/s) and shared memory's
    bandwidth (GB/s); None for each without a card or a clock."""
    dev = default_device(device)
    mhz = max_sm_clock_mhz(dev)
    if mhz is None:
        return {"sfu": None, "smem": None, "clock_mhz": None}
    per_clock = _sms(dev) * mhz * 1e6 / 1e9
    return {"sfu": SFU_EX2_PER_CLOCK * per_clock,
            "smem": SMEM_BYTES_PER_CLOCK * per_clock, "clock_mhz": mhz}


def _readings(dev: torch.device) -> list:
    """(name, unit, ceiling key, thunk) of every reading of ``main``."""
    return [
        ("MXU bf16 chain (mma.sync)", "GFLOPS", "bf16",
         lambda: mxu_peak_gflops(torch.bfloat16, device=dev)),
        ("MXU int8 chain (mma.sync)", "GFLOPS", "int8",
         lambda: mxu_peak_gflops(torch.int8, device=dev)),
        ("MXU int8 throughput", "GFLOPS", "int8",
         lambda: mxu_throughput_gflops(device=dev)),
        ("MXU fp32 chain (3xTF32)", "GFLOPS", "fp32",
         lambda: mxu_peak_gflops(torch.float32, device=dev)),
        ("VPU fma dependent (func1)", "GFLOPS", "ffma",
         lambda: vpu_peak_gflops(dependent=True, device=dev)),
        ("VPU fma independent (func2)", "GFLOPS", "ffma",
         lambda: vpu_peak_gflops(dependent=False, device=dev)),
        ("VPU exp throughput (SFU)", "Gelem/s", "sfu",
         lambda: vpu_exp_gelems(device=dev)),
        ("HBM r+w bandwidth (copy_grid)", "GB/s", "hbm",
         lambda: hbm_bandwidth_gbps(device=dev)),
        ("HBM r+w bandwidth (torch)", "GB/s", "hbm",
         lambda: torch_stream_bandwidth_gbps(device=dev)),
        ("HBM r+w bandwidth (manual DMA)", "GB/s", "hbm",
         lambda: hbm_copy_manual_gbps(device=dev)),
        ("DMA chunk bandwidth 1024x2048", "GB/s", "hbm",
         lambda: dma_chunk_bandwidth_gbps(1024, 2048, device=dev)),
        ("DMA chunk bandwidth 2048x1024", "GB/s", "hbm",
         lambda: dma_chunk_bandwidth_gbps(2048, 1024, device=dev)),
        ("VMEM r+w bandwidth (shared mem)", "GB/s", "smem",
         lambda: vmem_bandwidth_gbps(device=dev)),
        ("DMA issue+complete latency", "ns", None,
         lambda: dma_latency_ns(device=dev)),
        ("MXU bf16 @ depth 64", "GFLOPS", "bf16",
         lambda: mxu_depth_gflops(64, device=dev)),
        ("MXU bf16 @ depth 128", "GFLOPS", "bf16",
         lambda: mxu_depth_gflops(128, device=dev)),
        ("MXU bf16 @ depth 512", "GFLOPS", "bf16",
         lambda: mxu_depth_gflops(512, device=dev)),
    ]


def ceilings(device=None) -> dict:
    """Each reading's ceiling by key, with its source: the H100 SXM data
    sheet (dense, 700 W) or the derived figure; (None, "none") where
    there is none."""
    derived = derived_ceilings(device)
    sheet = "H100 SXM data sheet"
    guide = (f"derived: CUDA C Programming Guide per-SM rate x SMs x "
             f"{derived['clock_mhz']} MHz" if derived["clock_mhz"]
             else "none")
    return {
        "bf16": (PEAK_BF16_FLOPS / 1e9, sheet),
        "int8": (PEAK_INT8_OPS / 1e9, sheet),
        "fp32": (PEAK_TF32_FLOPS / 3 / 1e9, sheet + " (3xTF32: TF32 / 3)"),
        "ffma": (PEAK_FFMA_FLOPS / 1e9, sheet),
        "hbm": (PEAK_BYTES / 1e9, sheet),
        "sfu": (derived["sfu"], guide),
        "smem": (derived["smem"], guide),
        None: (None, "none"),
    }


def main(device=None) -> list[dict]:
    """Every reading beside its ceiling and its share of it; returns the
    rows. Raises RuntimeError when a reading is above SHARE_LIMIT (105%)
    of its ceiling: a broken measurement, not speed."""
    dev = default_device(device)
    name = (torch.cuda.get_device_name(dev) if _on_card(dev)
            else "the CPU (no device ceilings)")
    print(f"# hardware probes on {name}")
    ceil = ceilings(dev) if _on_card(dev) else {}
    rows = []
    for label, unit, key, fn in _readings(dev):
        value = fn()
        ceiling, source = ceil.get(key, (None, "none"))
        share = value / ceiling if ceiling else None
        rows.append({"name": label, "value": value, "unit": unit,
                     "ceiling": ceiling, "share": share, "source": source})
        tail = (f"{100 * share:6.1f}% of {ceiling:,.1f} ({source})"
                if share is not None else f"ceiling: {source}")
        print(f"{label:32s} {value:14.1f} {unit:8s} {tail}", flush=True)
    broken = [r for r in rows if r["share"] is not None
              and r["share"] > SHARE_LIMIT]
    if broken:
        raise RuntimeError(f"readings above {SHARE_LIMIT:.0%} of their "
                           f"ceilings (broken measurements): {broken}")
    return rows


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu' is asked for")
    main(ap.parse_args().device)
