"""Build, load and launch the hand-written Hopper kernels under ``csrc/``.

Each ``.cu`` file is compiled on its own by nvcc into a shared library
with a plain C interface (no PyTorch headers: seconds, not minutes),
cached under ``build/torch_kernels/`` at the repository root by a hash of
its sources and flags, and loaded with ctypes. A source may hold more than
one kernel (``grouped_gemm_t.cu``: ``grouped_gemm_t`` and
``grouped_gemm_t4``; ``int8_fat.cu``: rungs 09 and 10;
``int8_resident.cu``: rungs 12 and 13 and ``int8_pretile``); its kernels
share one library. Nothing is compiled
when this module is imported; the first launch of a kernel builds its
library, and ``build_all`` builds every library at once, one nvcc process
per source, all started together.

Every C entry point takes its own arguments (``Kernel.argtypes``:
``c_void_p`` for each pointer and for the CUDA stream, which comes last)
and returns ``cudaGetLastError()`` after its launch; ``launch`` raises if
that is not 0. A launch runs outside autograd, so ``launch`` also raises
when grad mode is on and a tensor argument requires grad
(``require_no_grad``): a kernel with a backward is launched from its
``torch.autograd.Function``, where grad mode is off. ``LAUNCHES`` counts the launches of each kernel, one per
call of ``launch`` and nowhere else, so a run can show which kernels its
path went through.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@dataclasses.dataclass(frozen=True)
class Kernel:
    """One C entry point: its source under ``csrc/`` and its ctypes
    argument types (the trailing stream included)."""
    source: str
    argtypes: tuple


# (qa, b, sa, sb, c, out, M, N, K, lda, ldb, ldc, stream)
_GEMM = (_P,) * 6 + (_I,) * 6 + (_P,)
# (a, b, c, out, M, N, K, lda, ldb, ldc, stream)
_FLOAT_GEMM = (_P,) * 4 + (_I,) * 6 + (_P,)

# kernel name -> Kernel; the C symbol has the kernel's name
KERNELS = {
    "int8_gemm_nn": Kernel("int8_gemm_nn.cu", _GEMM),
    "int8_gemm_nt": Kernel("int8_gemm_nt.cu", _GEMM),
    "w4a8_gemm": Kernel("w4a8_gemm.cu", _GEMM),
    # the hand-pipeline record (rungs 08-11), out fresh; b as (K, N) for
    # the _nn kernels and (N, K) for the _nt ones; ldc (c's and out's row
    # pitch) a multiple of 4 for the fat kernels
    "int8_dma_nn": Kernel("int8_dma_nn.cu", _GEMM),
    "int8_fat_nn": Kernel("int8_fat.cu", _GEMM),
    "int8_fat_nt": Kernel("int8_fat.cu", _GEMM),
    "int8_strip_nt": Kernel("int8_strip_nt.cu", _GEMM),
    # the operand-resident rungs 12 and 13, out fresh; the tiled kernel's
    # qa and b are int8_pretile's swizzled stage images (lda, ldb not read)
    "int8_resident_nt": Kernel("int8_resident.cu", _GEMM),
    "int8_tiled_resident_nt": Kernel("int8_resident.cu", _GEMM),
    # (src, dst, rows, K, ld, tiles, nk, stream)
    "int8_pretile": Kernel("int8_resident.cu", (_P,) * 2 + (_I,) * 5
                           + (_P,)),
    # rung 17, c and out the same buffer, then b_buffers, a_lookahead
    "int8_hand_pipe_nt": Kernel("int8_hand_pipe.cu", _GEMM[:-1]
                                + (_I, _I, _P)),
    # rung 18, c and out the same buffer, then the plan: bm1, g1, bm2, g2,
    # off2
    "int8_ragged_nt": Kernel("int8_ragged_nt.cu", _GEMM[:-1] + (_I,) * 5
                             + (_P,)),
    # c unused (may be null); out = f32(QA @ W4) * sa * sw
    "w4a8_gemm_noc": Kernel("w4a8_gemm_noc.cu", _GEMM),
    # (x, packed, sw, out, M, N, K, ldx, Kp, ldp, cluster, stream)
    "w4a8_gemv_fq": Kernel("w4a8_gemv_fq.cu", (_P,) * 4 + (_I,) * 7
                           + (_P,)),
    # (cache, new, pos, mask, B, T, S, row_bytes, stream)
    "kv_update": Kernel("kv_update.cu", (_P,) * 4 + (_I,) * 4 + (_P,)),
    # (q, k_cache, v_cache, lengths, out, part, count, B, T, KVH, REP, D,
    #  bk, C, scale, stream): part and count the split walk's workspace,
    #  C the chunks of a split
    "decode_attention": Kernel("decode_attention.cu", (_P,) * 7
                               + (_I,) * 7 + (_F, _P)),
    # (qa, qb, sa, sb, out, M, N, K, lda, ldb, ldc, stream):
    # out = f32(QA @ QB) * sa * sb
    "int8_gemm_noc": Kernel("int8_gemm_noc.cu", (_P,) * 5 + (_I,) * 6
                            + (_P,)),
    # (a, packed, sw, out, M, N, K, lda, ldb, ldc, stream): bf16 A
    "w4a16_gemm_noc": Kernel("w4a16_gemm_noc.cu", (_P,) * 4 + (_I,) * 6
                             + (_P,)),
    # (a, packed, sw, out, M, N, K, lda, Kp, ldp, cluster, stream): bf16 A
    "w4a16_gemv": Kernel("w4a16_gemv.cu", (_P,) * 4 + (_I,) * 7 + (_P,)),
    # (q, qk, sk, qv, sv, lengths, out, part, count, B, T, KVH, REP, D,
    #  bk, C, scale, stream): part and count decode_attention's workspace,
    #  C the chunks of a split
    "decode_attention_q8": Kernel("decode_attention_q8.cu", (_P,) * 9
                                  + (_I,) * 7 + (_F, _P)),
    # (pool, new, pages, offs, mask, B, S, NP, PS, row_bytes, stream)
    "paged_kv_update": Kernel("paged_kv_update.cu", (_P,) * 5 + (_I,) * 5
                              + (_P,)),
    # (q, k_pool, v_pool, table, lengths, out, part, count, B, NP, PS,
    #  np_max, KVH, REP, D, C, scale, stream): part and count the split
    #  walk's workspace, C the pages of a split
    "paged_decode_attention": Kernel("paged_decode_attention.cu", (_P,) * 8
                                     + (_I,) * 8 + (_F, _P)),
    # (q, qk, sk, qv, sv, table, lengths, out, part, count, B, NP, PS,
    #  np_max, KVH, REP, D, C, scale, stream): part and count the split
    #  walk's workspace, C the pages of a split
    "paged_decode_attention_q8": Kernel("paged_decode_attention_q8.cu",
                                        (_P,) * 10 + (_I,) * 8 + (_F, _P)),
    # (q, k, v, out, B, H, KVH, S, T, D, causal, then the (b, h, row)
    #  element strides of q, k, v and out, scale, stream); the two flash
    #  forwards are wgmma kernels (csrc/flash_wgmma.cuh) whose C entry
    #  encodes their tensor maps from these pointers and strides
    "flash_attention": Kernel("flash_attention.cu", (_P,) * 4 + (_I,) * 19
                              + (_F, _P)),
    # the training attention, self-attention of S tokens: (q, k, v, out,
    # lse, B, H, KVH, S, D, causal, the (b, h, row) element strides of q, k,
    # v and out, scale, stream)
    "flash_attention_fwd_lse": Kernel("flash_attention_fwd_lse.cu",
                                      (_P,) * 5 + (_I,) * 18 + (_F, _P)),
    # (q, k, v, do, lse, delta, dq, B, H, KVH, S, D, causal, the strides of
    #  q, k, v, do and dq, scale, stream)
    "flash_attention_bwd_dq": Kernel("flash_attention_bwd_dq.cu",
                                     (_P,) * 7 + (_I,) * 21 + (_F, _P)),
    # (q, k, v, do, lse, delta, dk, dv, B, H, KVH, S, D, causal, the strides
    #  of q, k, v, do, dk and dv, scale, stream)
    "flash_attention_bwd_dkv": Kernel("flash_attention_bwd_dkv.cu",
                                      (_P,) * 8 + (_I,) * 24 + (_F, _P)),
    # (a, b, c, out, M, N, K, lda, ldb, ldc, stream), b as BT (N, K) for
    # the _nt kernels and (K, N) for the _nn ones; c and out may alias
    "bf16_gemm_nt": Kernel("bf16_gemm_nt.cu", _FLOAT_GEMM),
    "bf16_gemm_nn": Kernel("bf16_gemm_nn.cu", _FLOAT_GEMM),
    "fp32_gemm_nt": Kernel("fp32_gemm_nt.cu", _FLOAT_GEMM),
    "fp32_gemm_nn": Kernel("fp32_gemm_nn.cu", _FLOAT_GEMM),
    # (a, packed, sw, c, out, M, N, K, lda, ldb, ldc, stream): bf16 A,
    # out = (A @ W4) * sw + C
    "w4a16_gemm": Kernel("w4a16_gemm.cu", (_P,) * 5 + (_I,) * 6 + (_P,)),
    # the fp32 rungs below rung 04, on the CUDA cores: (a, b, c, out, M, N,
    # K, lda, ldb, ldc, stream) with b (K, N), out fresh
    "naive_gemm": Kernel("naive_gemm.cu", _FLOAT_GEMM),
    "fp32_gemm_mn_tile": Kernel("fp32_gemm_mn_tile.cu", _FLOAT_GEMM),
    # (a, b, c, out, M, N, K, lda, ldb, ldc, block, stream): block is the
    # C tile edge, 128 (rung 03) or 64 (rung 03b)
    "fp32_gemm_k_blocked": Kernel("fp32_gemm_k_blocked.cu",
                                  _FLOAT_GEMM[:-1] + (_I, _P)),
    # the MoE grouped GEMM: (a, w, block_expert, s, out, Tp, N, K, lda, ldw,
    # bt, E, kind, stream); s may be null, kind 0 bf16, 1 int8, 2 packed
    # int4 (a: x split by split_bf16), 3 fp32 stacks (a: x)
    "grouped_gemm": Kernel("grouped_gemm.cu", (_P,) * 5 + (_I,) * 8 + (_P,)),
    # x (rows, ldx) fp32 -> (2, rows, ldo) bf16 hi, lo: (x, out, rows, cols,
    # ldx, ldo, stream)
    "split_bf16": Kernel("split_bf16.cu", (_P,) * 2 + (_I,) * 4 + (_P,)),
    # its backward: dx = dy @ W[e]^T, (a, w, block_expert, out, Tp, N, K,
    # lda, ldw, bt, E, kind, stream), kind 0 bf16, 1 int8 (a: dy split by
    # split_bf16), 3 fp32 stacks (a: dy); the same on a packed int4 stack
    # without the kind
    "grouped_gemm_t": Kernel("grouped_gemm_t.cu", (_P,) * 4 + (_I,) * 8
                             + (_P,)),
    "grouped_gemm_t4": Kernel("grouped_gemm_t.cu", (_P,) * 4 + (_I,) * 7
                              + (_P,)),
    # dW[e] = x_e^T dy_e: (x, dy, block_expert, out, nb, M, N, E, ldx, ldy,
    # bt, stream), x and dy split by split_bf16
    "grouped_dw": Kernel("grouped_dw.cu", (_P,) * 4 + (_I,) * 7 + (_P,)),
    # the hardware probes (ops/probes.py); kind 0 int8, 1 bf16, 2 fp32:
    # (x, y, out, blocks, S, n_iters, kind, stream)
    "mma_chain": Kernel("probes_compute.cu", (_P,) * 3 + (_I,) * 4 + (_P,)),
    # (x, yt, out, blocks, K, n_iters, kind, stream)
    "mma_throughput": Kernel("probes_compute.cu", (_P,) * 3 + (_I,) * 4
                             + (_P,)),
    # (x, out, n, n_iters, stream)
    "exp_chain": Kernel("probes_compute.cu", (_P,) * 2 + (_I,) * 2 + (_P,)),
    # (x, out, n, n_iters, dependent, stream)
    "ffma_chain": Kernel("probes_compute.cu", (_P,) * 2 + (_I,) * 3 + (_P,)),
    # (src, dst, 16-byte words, stream)
    "copy_grid": Kernel("probes_memory.cu", (_P,) * 2 + (_I,) + (_P,)),
    # (x, out, parent, rows, cols, reps, stream)
    "tile_read": Kernel("probes_memory.cu", (_P,) * 2 + (_I,) * 4 + (_P,)),
    # (x, out, blocks, n_iters, stream)
    "smem_copy": Kernel("probes_memory.cu", (_P,) * 2 + (_I,) * 2 + (_P,)),
    # (x, out, tile_bytes, nsrc, n_iters, do_load, stream)
    "load_latency": Kernel("probes_memory.cu", (_P,) * 2 + (_I,) * 4
                           + (_P,)),
    # (src, dst, nout, chunk_bytes, nchunks, nslots, reps, stream)
    "pipelined_copy": Kernel("probes_memory.cu", (_P,) * 3 + (_I,) * 4
                             + (_P,)),
    # the dispatch probe's custom op (ops/dispatch_probe.py): (x, out, n,
    # stream)
    "add_one": Kernel("dispatch_probe.cu", (_P,) * 2 + (_I,) + (_P,)),
}

LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS, 0)
_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc() -> str:
    """Path of nvcc; RuntimeError when there is none."""
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = pathlib.Path(cuda_home) / "bin" / "nvcc"
        if candidate.exists():
            path = str(candidate)
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(source: str) -> pathlib.Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in (CSRC / source, *sorted(CSRC.glob("*.cuh"))):
        h.update(f.read_bytes())
    stem = pathlib.Path(source).stem
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:12]}.so"


def _start_build(source: str):
    """Start nvcc for one source; None when its library is already built."""
    out = _lib_path(source)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(source: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {source}:\n{log}")
    os.replace(tmp, out)


def build_all() -> float:
    """Build every library not yet built, in parallel; returns seconds."""
    t0 = time.perf_counter()
    sources = dict.fromkeys(k.source for k in KERNELS.values())
    started = {src: _start_build(src) for src in sources}
    for src, s in started.items():
        if s is not None:
            _finish_build(src, s)
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output (with ptxas register and spill counts) of the last
    build of ``name``'s source, or '' when it was built by an earlier
    process."""
    log = _lib_path(KERNELS[name].source).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _library(source: str) -> ctypes.CDLL:
    if source not in _LIBS:
        started = _start_build(source)
        if started is not None:
            _finish_build(source, started)
        _LIBS[source] = ctypes.CDLL(str(_lib_path(source)))
    return _LIBS[source]


def _function(name: str):
    fn = getattr(_library(KERNELS[name].source), name)
    fn.argtypes = KERNELS[name].argtypes
    fn.restype = _I
    return fn


def c_function(source: str, name: str, argtypes: tuple):
    """C entry ``name`` of ``source``'s library (built first if need be)
    as a ctypes function of its own, taking ``argtypes`` and returning an
    int; the registered kernels' functions are left as they are. For
    entries that are no kernel of ``KERNELS``, or an older source's
    signature of one."""
    fn = _library(source)[name]
    fn.argtypes = argtypes
    fn.restype = _I
    return fn


def require_no_grad(name: str, *args) -> None:
    """Raise when grad mode is on and a tensor of ``args`` requires grad:
    ``name`` has no backward, and its output would carry no gradient
    back to that tensor, silently."""
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        raise RuntimeError(f"{name} has no backward: called on a tensor that "
                           "requires grad, with grad mode on")


def launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel ``name`` on the current stream of ``device``.

    ``args`` are the C arguments before the stream, in order: a tensor
    passes its ``data_ptr()``, ``None`` a null pointer, a number itself.
    The caller (a wrapper in ``ops/``) has checked devices, dtypes,
    shapes, contiguity and alignment. Raises RuntimeError if the launch
    was refused, or if the call needed a gradient (``require_no_grad``)."""
    require_no_grad(name, *args)
    fn = _function(name)
    if len(args) != len(fn.argtypes) - 1:
        raise TypeError(f"{name} takes {len(fn.argtypes) - 1} arguments "
                        f"before the stream, got {len(args)}")
    stream = torch.cuda.current_stream(device).cuda_stream
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
             for a in args]
    with torch.cuda.device(device):
        err = fn(*cargs, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1
