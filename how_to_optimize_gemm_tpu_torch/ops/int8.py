"""int8 symmetric GEMM: rungs 06 (kernel K1), 14 (kernel K2) and 18, and
the int8 serving linear at prefill widths (kernel ``int8_gemm_noc``).

Counterparts: ``how_to_optimize_gemm_tpu/ops/pallas_int8.py`` (``prepare``,
``mmult_q``, ``mmult_q_bt``, ``ragged_m_plan``, ``mmult_q_bt_ragged``,
``mmult_q_noc``) and ``pallas_manual_dma.prepare_packed``. The first three
compute ``C' = f32(QA @ QB as int32) * sa[i] * sb[j] + C``:

- ``mmult_q`` (K1, ``csrc/int8_gemm_nn.cu``) takes B as (K, N) and
  returns a fresh output;
- ``mmult_q_bt`` (K2, ``csrc/int8_gemm_nt.cu``) takes B packed
  transposed as (N, K) and accumulates IN PLACE into ``c``;
- ``mmult_q_bt_ragged`` (rung 18, ``csrc/int8_ragged_nt.cu``) is K2's
  function and kernel walked over ``ragged_m_plan``'s strips in one
  persistent launch, in place (K2 and rung 18: ``csrc/gemm_wgmma.cuh``'s
  int8 instance, ``wgmma`` on 128 x 256 tiles);
- ``mmult_q_noc`` (``csrc/int8_gemm_noc.cu``, ``csrc/w4a8_wgmma.cuh``'s
  int8 ``wgmma`` body on plain int8 weights: QB turned K-major into
  registers as wgmma's A, 64- or 128-token x 256-column tiles) returns
  ``f32(QA @ QB as int32) * sa[i] * sb[j]``.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version (``mmult_q_ref``, ``mmult_q_bt_ref``, ``mmult_q_noc_ref``) only
for CPU tensors. The kernels equal their plain versions bit for bit: the
int32 accumulator is exact and both apply the epilogue in the same order.

``int_matmul`` is the int8 linear's product below the kernel's widths,
the counterpart of the reference's XLA int8 dot (``models/linear.py``'s
non-Pallas branch).
"""
from __future__ import annotations

import functools

import torch

from how_to_optimize_gemm_tpu_torch import _build
from how_to_optimize_gemm_tpu_torch.ops import bounds, quant

# Every int8 row handed to a kernel starts on a 16-byte boundary.
ALIGN = 16
# The L2 of an H100 SXM (50 MiB, ``torch.cuda.get_device_properties()
# .L2_cache_size``) and the share of it a call counts on keeping (rungs 12,
# 13 and 18); the rest holds the lines of C and the output in flight.
L2_BYTES = 52_428_800
L2_SHARE = 0.875
# K2's and rung 18's output tile, rows x columns (csrc/int8_gemm_nt.cu,
# int8_ragged_nt.cu), and one wave of their persistent walk: a tile an SM
# of the H100 SXM's 132
TILE = 128
TILE_N = 256
NT_TILE = (TILE, TILE_N)
WAVE = 132
# their ring: STAGES stages of STAGE_K K bytes (one 128-byte line a row of
# QA's 128 and QBT's 256 rows)
STAGES = 4
STAGE_K = 128


def prepare(a: torch.Tensor, b: torch.Tensor):
    """Quantize float32 operands: A per row, B per column."""
    qa, sa = quant.quantize_symmetric(a, axis=1)   # (M,K) int8, (M,1) f32
    qb, sb = quant.quantize_symmetric(b, axis=0)   # (K,N) int8, (1,N) f32
    return qa, sa, qb, sb


def prepare_packed(a: torch.Tensor, b: torch.Tensor):
    """``prepare`` with B packed transposed, (N, K): the offline relayout
    that makes B K-major, the layout the int8 MMA reads."""
    qa, sa, qb, sb = prepare(a, b)
    return qa, sa, qb.t().contiguous(), sb


def dequant_epilogue(acc: torch.Tensor, sa: torch.Tensor, sb: torch.Tensor,
                     c: torch.Tensor) -> torch.Tensor:
    """``(float(acc) * sa) * sb + c``, each op rounded on its own."""
    return acc.to(torch.float32) * sa * sb + c


def _weight_f64(y: torch.Tensor) -> torch.Tensor:
    """The right operand of ``int_matmul_exact`` (a weight) in fp64; a
    function of its own so that a caller may reuse the conversion of a
    weight that does not change (``chip_smoke.cached_weights``)."""
    return y.to(torch.float64)


def int_matmul_exact(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """int8 @ int8 -> int32 with plain tensor ops, on any device.

    There is no int32 matmul on CUDA; fp64 is exact here because
    |acc| <= 127 * 127 * K is far below 2**53."""
    return (x.to(torch.float64) @ _weight_f64(y)).to(torch.int32)


# torch._int_mm (cuBLASLt) takes more than 16 rows and k, n multiples of 8
INT_MM_MIN_ROWS = 32
INT_MM_MULTIPLE = 8


def int_matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """int8 (m, k) @ int8 (k, n) -> int32, exact.

    On the card ``torch._int_mm``, the library's int8 product (the
    reference leaves this product to XLA's int8 dot), with k and n
    zero-padded to multiples of 8 and the rows to at least 32: zeros add
    nothing to an integer sum. For CPU tensors ``int_matmul_exact``."""
    if not x.is_cuda:
        return int_matmul_exact(x, y)
    m, k = x.shape
    n = y.shape[1]
    pad_k = -k % INT_MM_MULTIPLE
    pad_n = -n % INT_MM_MULTIPLE
    pad_m = max(INT_MM_MIN_ROWS - m, 0)
    if pad_k or pad_m:
        x = torch.nn.functional.pad(x, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        y = torch.nn.functional.pad(y, (0, pad_n, 0, pad_k))
    return torch._int_mm(x.contiguous(), y.contiguous())[:m, :n]


def mmult_q_ref(qa, sa, qb, sb, c):
    """Plain version of K1: a fresh ``dequant(QA @ QB) + C``."""
    return dequant_epilogue(int_matmul_exact(qa, qb), sa, sb, c)


def mmult_q_bt_ref(qa, sa, qbt, sb, c):
    """Plain version of K2, out of place: ``dequant(QA @ QBT^T) + C``."""
    return dequant_epilogue(int_matmul_exact(qa, qbt.t()), sa, sb, c)


def check_operands(name: str, qa, sa, b, sb, c) -> None:
    """Raise on what the kernels do not take: mixed devices, wrong dtypes
    or shapes, non-contiguous tensors, misaligned int8 bases."""
    m, n = c.shape
    if qa.dim() != 2 or qa.shape[0] != m:
        raise ValueError(f"{name}: qa {tuple(qa.shape)} vs c {tuple(c.shape)}")
    if tuple(sa.shape) != (m, 1) or tuple(sb.shape) != (1, n):
        raise ValueError(f"{name}: scales {tuple(sa.shape)}, {tuple(sb.shape)}"
                         f" do not match c {tuple(c.shape)}")
    for t, dt in ((qa, torch.int8), (b, torch.int8), (sa, torch.float32),
                  (sb, torch.float32), (c, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{name}: expected {dt}, got {t.dtype}")
        if t.device != c.device:
            raise ValueError(f"{name}: tensors on {t.device} and {c.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    for t in (qa, b):
        if t.data_ptr() % ALIGN:
            raise ValueError(f"{name}: int8 operand not {ALIGN}-byte aligned")


def l2_budget(device) -> int:
    """The L2 bytes a call may keep resident: ``L2_SHARE`` of the card's
    L2, or of ``L2_BYTES`` (derived for the H100 SXM) on a device that has
    none (the CPU, ``meta``)."""
    device = torch.device(device)
    size = (torch.cuda.get_device_properties(device).L2_cache_size
            if device.type == "cuda" else L2_BYTES)
    return int(L2_SHARE * size)


def bt_operands(name: str, qa, sa, qbt, sb, c):
    """K2's operands checked, K zero-padded to 16 bytes: (qa, qbt)."""
    m, n = c.shape
    k = qa.shape[1]
    if tuple(qbt.shape) != (n, k):
        raise ValueError(f"{name}: qbt {tuple(qbt.shape)} vs ({n}, {k})")
    qa = bounds.pad_dim(qa, 1, ALIGN)
    qbt = bounds.pad_dim(qbt, 1, ALIGN)
    check_operands(name, qa, sa, qbt, sb, c)
    return qa, qbt


def require_cuda(name: str, c: torch.Tensor) -> None:
    if not c.is_cuda:
        raise RuntimeError(f"{name}: tensors on {c.device}; the kernel runs "
                           "on CUDA and the plain version only on the CPU")


def mmult_q(qa, sa, qb, sb, c):
    """C' = dequant(QA @ QB) + C, a fresh (M, N) float32 output (K1).

    qa (M, K) int8, sa (M, 1), qb (K, N) int8, sb (1, N), c (M, N)
    float32; ``c`` is not modified."""
    if c.device.type == "cpu":
        return mmult_q_ref(qa, sa, qb, sb, c)
    require_cuda("mmult_q", c)
    m, n = c.shape
    k = qa.shape[1]
    if tuple(qb.shape) != (k, n):
        raise ValueError(f"mmult_q: qb {tuple(qb.shape)} vs ({k}, {n})")
    qa = bounds.pad_dim(qa, 1, ALIGN)
    qb = bounds.pad_dim(bounds.pad_dim(qb, 0, ALIGN), 1, ALIGN)
    check_operands("mmult_q", qa, sa, qb, sb, c)
    out = torch.empty_like(c)
    if m and n:
        kp = qa.shape[1]
        _build.launch("int8_gemm_nn", c.device, qa, qb, sa, sb, c, out,
                      m, n, kp, kp, qb.shape[1], n)
    return out


def mmult_q_bt(qa, sa, qbt, sb, c):
    """C = dequant(QA @ QBT^T) + C with B packed transposed (N, K) (K2).

    IN PLACE: the result is written into ``c``, which is returned. The
    reference aliases C into its output the same way
    (``input_output_aliases``); callers that need the old C keep a copy."""
    if c.device.type == "cpu":
        c.copy_(mmult_q_bt_ref(qa, sa, qbt, sb, c))
        return c
    require_cuda("mmult_q_bt", c)
    m, n = c.shape
    qa, qbt = bt_operands("mmult_q_bt", qa, sa, qbt, sb, c)
    if m and n:
        kp = qa.shape[1]
        _build.launch("int8_gemm_nt", c.device, qa, qbt, sa, sb, c, c,
                      m, n, kp, kp, kp, n)
    return c


def ragged_m_plan(mp: int, cap: int) -> list[tuple[int, int, int]]:
    """Strip plan [(bm, grid_m, off_blocks)] covering ``mp`` rows with
    ZERO padding and the fewest strips (each strip = one full B^T
    re-read, so strip count is the B-traffic knob the vendor's 3-strip
    p=4096 schedule wins ~1% with — RESULTS.md 4096 contest).

    The uniform chooser must sometimes choose between padding waste and
    an extra strip (p=4096, cap 1664: 3x1408 pads 128 rows; 4x1024 pads
    none — it picks 4 strips). A RAGGED plan gets both: a tall uniform
    head plus one shorter tail strip, expressible as TWO aliased
    pallas_calls when the tail offset is a multiple of the tail's own
    block height (BlockSpec index maps address in whole blocks). Plans:
    mp=4096 -> [(1536, 2, 0), (1024, 1, 3)] = 3 strips, no padding."""
    assert mp % 128 == 0, mp
    best: list[tuple[int, int, int]] | None = None

    def strips_of(plan):
        return sum(g for _, g, _ in plan)

    for bm1 in range(min(cap, mp), 127, -128):
        a, r = divmod(mp, bm1)
        if r == 0:
            plan = [(bm1, a, 0)]
        else:
            # tail block: largest 128-multiple dividing BOTH the tail
            # and the head extent (its blocks must start on their own
            # block grid)
            head = a * bm1
            bm2 = 0
            for c2 in range(min(cap, r), 127, -128):
                if r % c2 == 0 and head % c2 == 0:
                    bm2 = c2
                    break
            if not bm2:
                continue
            plan = [(bm1, a, 0), (bm2, r // bm2, head // bm2)]
        if best is None or strips_of(plan) < strips_of(best) or (
                strips_of(plan) == strips_of(best)
                and len(plan) < len(best)):
            best = plan
    assert best is not None
    return best


def ragged_cap(kp: int, budget: int, tile_n: int = TILE_N) -> int:
    """Rung 18's default strip cap for rows of ``kp`` K bytes: the tallest
    strip, a multiple of 128 within the reference's [512, 1792], whose A
    panel (cap x kp) and one wave's B^T panels (``WAVE`` tiles of the
    N-major walk, cap / 128 of them a panel: ceil(WAVE * 128 / cap) panels
    of ``tile_n`` x kp) stay inside ``budget`` bytes of L2
    (``l2_budget``), as the reference sizes its cap from VMEM
    (``pallas_int8.py:485-489``). ``tile_n``: the kernel's panel width,
    256 (``TILE_N``); 128 was the ``mma.sync`` kernel's."""
    for cap in range(1792, 511, -TILE):
        panels = -(-WAVE * TILE // cap)
        if (cap + panels * tile_n) * kp <= budget:
            return cap
    return 512


def ragged_walk(plan, n: int, blocks: int) -> list:
    """The (row, column) origins of the ``NT_TILE`` tiles that each block of
    rung 18's persistent grid computes, in order (``csrc/int8_ragged_nt.cu``
    ``PlanWalk``): the plan's tiles numbered strip by strip, N-major within
    a strip (the strip's row tiles of one panel, then the next panel),
    block i taking tiles i, i + blocks, ... of ``min(blocks, tiles)``
    blocks. ``plan``: ``ragged_m_plan``'s [(bm, strips, offset in
    blocks of bm)]."""
    num_n = -(-n // TILE_N)
    order = [(off * bm + s * bm + r * TILE, p * TILE_N)
             for bm, strips, off in plan for s in range(strips)
             for p in range(num_n) for r in range(bm // TILE)]
    return [order[i::blocks] for i in range(min(blocks, len(order)))]


@functools.lru_cache(maxsize=None)
def _ragged_launch_plan(mp: int, kp: int, cap: int | None, budget: int):
    """(cap, plan) of a rung-18 call, memoized: the two searches are Python
    loops, and at p = 2048 they took about as long as the kernel."""
    cap = ragged_cap(kp, budget) if cap is None else cap
    return cap, tuple(ragged_m_plan(mp, cap)) if mp else ()


def mmult_q_bt_ragged(qa, sa, qbt, sb, c, *, cap: int | None = None):
    """Rung 18: C = dequant(QA @ QBT^T) + C, IN PLACE, as ``mmult_q_bt``,
    with K2's 128 x 256 tiles walked over ``ragged_m_plan(round_up(M,
    128), cap)``: a head of tall strips and at most one shorter tail, in
    one persistent launch (kernel ``int8_ragged_nt``), N-major within a
    strip (``ragged_walk``).
    ``cap`` defaults to ``ragged_cap`` on the card's L2 budget. Returns
    ``c``."""
    m, n = c.shape
    _, plan = _ragged_launch_plan(bounds.round_up(m, TILE),
                                  bounds.round_up(qa.shape[1], ALIGN), cap,
                                  l2_budget(c.device))
    if c.device.type == "cpu":
        c.copy_(mmult_q_bt_ref(qa, sa, qbt, sb, c))
        return c
    require_cuda("mmult_q_bt_ragged", c)
    qa, qbt = bt_operands("mmult_q_bt_ragged", qa, sa, qbt, sb, c)
    if m and n:
        (bm1, g1, _), (bm2, g2, off2) = plan[0], (
            plan[1] if len(plan) > 1 else (TILE, 0, 0))
        kp = qa.shape[1]
        _build.launch("int8_ragged_nt", c.device, qa, qbt, sa, sb, c, c,
                      m, n, kp, kp, kp, n, bm1, g1, bm2, g2, off2)
    return c


def mmult_q_noc_ref(qa, sa, qb, sb):
    """Plain version of ``mmult_q_noc``: ``(f32(QA @ QB) * sa) * sb``."""
    return int_matmul_exact(qa, qb).to(torch.float32) * sa * sb


def mmult_q_noc(qa, sa, qb, sb):
    """y = f32(QA @ QB as int32) * sa * sb, a fresh (M, N) float32.

    qa (M, K) int8, sa (M, 1), qb (K, N) int8, sb (1, N) float32. No C is
    read or added: the int8 serving linear at prefill widths."""
    if qa.device.type == "cpu":
        return mmult_q_noc_ref(qa, sa, qb, sb)
    require_cuda("mmult_q_noc", qa)
    m, k = qa.shape
    n = qb.shape[1]
    if qb.shape[0] != k:
        raise ValueError(f"mmult_q_noc: qb {tuple(qb.shape)} vs K={k}")
    qa = bounds.pad_dim(qa, 1, ALIGN)
    qb = bounds.pad_dim(bounds.pad_dim(qb, 0, ALIGN), 1, ALIGN)
    out = torch.empty((m, n), dtype=torch.float32, device=qa.device)
    check_operands("mmult_q_noc", qa, sa, qb, sb, out)
    if m and n:
        kp = qa.shape[1]
        _build.launch("int8_gemm_noc", out.device, qa, qb, sa, sb, out,
                      m, n, kp, kp, qb.shape[1], n)
    return out
