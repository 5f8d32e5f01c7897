"""Decode attention through a block table over a paged KV pool (kernels
``paged_decode_attention`` and, for the KV8 pool,
``paged_decode_attention_q8``).

Counterpart: ``how_to_optimize_gemm_tpu/ops/pallas_paged_attention.py``
(``good_page_size``, ``gather_paged``, ``paged_decode_attention`` with
kernels ``_kernel_v4_paged`` and ``_kernel_v3_paged``,
``paged_decode_attention_q8`` with ``_kernel_q8_v4_paged`` and
``_kernel_q8_v3_paged``). The cache is a pool of pages (NP, PS, KVH, D)
shared by every slot, page 0 the trash page that no live table row
references; a slot's block table row (np_max,) maps its chunk c (token
positions [c*PS, (c+1)*PS)) to a physical page, unallocated entries 0.
The engine allocates pages as positions cross page boundaries
(``parallel/kv_alloc.py``).

The function is ``ops/decode_attention``'s with each chunk one page read
through the table: q (B, H, D) one query per slot, lengths (B,) the valid
rows of each slot, out (B, H * D) float32; a slot walks
``min(ceil(len / PS), np_max)`` pages, page ``min(table[b, c], NP - 1)``
(the reference's clamp), and a slot of length 0 outputs 0. The KV8 pool
holds int8 values and fp32 scales (NP, PS, KVH), without the reference's
128-lane pad (``convert.paged_cache_from_jax`` crops it). ``np_max * PS``
may pass ``max_seq``.

Both wrappers launch their kernels (``csrc/paged_decode_attention.cu``
and ``csrc/paged_decode_attention_q8.cu``, instances of the contiguous
kernels' templates in ``csrc/decode_attention.cuh``) for CUDA tensors and
run their plain versions (``*_ref``: ``decode_attention._chunk_walk``
through the table) only for CPU tensors; kernel and plain version sum in
other orders and agree to rounding. The bf16 pool's kernel walks each
slot with one block (per head); the KV8 pool's walks it in splits of
``paged_split_plan``'s pages, one block each, in one launch, and combines
the splits' partial softmax sums in a fixed order, in the workspace that
``decode_attention`` keeps per device (``decode_attention._workspace``).
The plan depends on np_max and PS only, never on the lengths, so a CUDA
graph captured at one set of lengths replays at any other.
"""
from __future__ import annotations

import torch

from how_to_optimize_gemm_tpu_torch import _build
from how_to_optimize_gemm_tpu_torch.ops.decode_attention import (
    _MAX_QELEMS, _MAX_SCORES, KERNEL_HEAD_DIMS, _chunk_walk, _workspace,
    split_plan)
from how_to_optimize_gemm_tpu_torch.ops.int8 import ALIGN, require_cuda


def good_page_size(kvh: int, d: int, itemsize: int = 2,
                   cap_tokens: int = 512) -> int:
    """The reference's default page (tokens): the largest 128-multiple
    whose two ping-pong (page, kvh*d) chunk buffers of K and of V fit the
    ~6 MB of TPU fast memory (VMEM) its contiguous kernels budget for,
    capped at ``cap_tokens``, at least 128. A TPU rule, kept so that the
    port's engine builds the reference's tables: Llama-2-7B gets 128 tokens
    for a bf16 pool and 384 for a KV8 pool."""
    budget = 6 * 1024 * 1024
    cap = budget // (4 * kvh * d * itemsize) // 128 * 128
    return max(min(cap, cap_tokens), 128)


def gather_paged(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """A slot-contiguous (B, np_max * PS, ...) copy of a page pool (NP, PS,
    ...) through the table (B, np_max): the eager route's read. Unallocated
    chunks show the trash page; callers mask by length. Any trailing
    shape (KV8 scale pools too)."""
    b, np_max = table.shape
    return pool[table.long()].reshape((b, np_max * pool.shape[1])
                                      + pool.shape[2:])


def paged_split_plan(np_max: int, ps: int) -> tuple[int, int]:
    """(pages a split, splits) of the KV8 kernel's walk over a table of
    np_max pages of ps tokens: ``decode_attention.split_plan`` with one
    page a chunk, from np_max and ps alone (the Llama-2-7B KV8 pool's
    384-token pages: one page a split)."""
    return split_plan(np_max * ps, ps)


def paged_decode_attention_ref(q, k_pool, v_pool, table, lengths):
    """Plain version of ``paged_decode_attention``: the chunk walk with
    bk = PS, each chunk's rows read through the table."""
    return _chunk_walk(q, k_pool, v_pool, lengths, k_pool.shape[1],
                       table=table)


def paged_decode_attention_q8_ref(q, qk_pool, sk_pool, qv_pool, sv_pool,
                                  table, lengths):
    """Plain version of ``paged_decode_attention_q8``: the chunk walk over
    the int8 pools with the scales folded in."""
    return _chunk_walk(q, qk_pool, qv_pool, lengths, qk_pool.shape[1],
                       sk_pool, sv_pool, table=table)


def _check(name, q, pools, scales, table, lengths, dtype):
    """Raise on what the kernel does not take; returns (q as contiguous
    fp32, lengths as int32, the C arguments after ``out``)."""
    b, h, d = q.shape
    n_pages, ps, kvh, dk = pools[0].shape
    if (dk != d or h % kvh or table.dim() != 2 or table.shape[0] != b
            or any(p.shape != pools[0].shape for p in pools)
            or any(tuple(s.shape) != (n_pages, ps, kvh) for s in scales)):
        raise ValueError(f"{name}: q {tuple(q.shape)}, pools "
                         f"{[tuple(p.shape) for p in pools]}, scales "
                         f"{[tuple(s.shape) for s in scales]}, table "
                         f"{tuple(table.shape)}")
    rep = h // kvh
    if d not in KERNEL_HEAD_DIMS or rep * d > _MAX_QELEMS \
            or rep * ps > _MAX_SCORES:
        raise ValueError(f"{name}: the kernel takes d in {KERNEL_HEAD_DIMS}, "
                         f"rep*d <= {_MAX_QELEMS}, rep*PS <= {_MAX_SCORES}; "
                         f"got d={d}, rep={rep}, PS={ps}")
    for x, want in ([(p, dtype) for p in pools]
                    + [(s, torch.float32) for s in scales]
                    + [(table, torch.int32)]):
        if x.device != q.device:
            raise ValueError(f"{name}: an operand on {x.device}, q on "
                             f"{q.device}")
        if x.dtype != want or not x.is_contiguous():
            raise TypeError(f"{name}: expected contiguous {want}, got "
                            f"{x.dtype}")
    lengths = torch.as_tensor(lengths, device=q.device).to(torch.int32)
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"{name}: lengths {tuple(lengths.shape)}")
    return (q.to(torch.float32).contiguous(), lengths,
            (b, n_pages, ps, table.shape[1], kvh, rep, d, d ** -0.5))


def paged_decode_attention(q, k_pool, v_pool, table, lengths):
    """(B, H, D) queries over (NP, PS, KVH, D) bf16 pools through the
    (B, np_max) int32 table -> (B, H * D) fp32.

    The kernel takes D in {32, 64, 128}, rep * D <= 2048 and
    rep * PS <= 8192."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pool, v_pool, table, lengths)
    require_cuda("paged_decode_attention", q)
    q, lengths, dims = _check("paged_decode_attention", q,
                              (k_pool, v_pool), (), table, lengths,
                              torch.bfloat16)
    b, h, d = q.shape
    out = torch.empty((b, h * d), dtype=torch.float32, device=q.device)
    if b and table.shape[1] and k_pool.shape[2]:
        _build.launch("paged_decode_attention", q.device, q, k_pool, v_pool,
                      table, lengths, out, *dims)
    return out


def paged_decode_attention_q8(q, qk_pool, sk_pool, qv_pool, sv_pool, table,
                              lengths):
    """(B, H, D) queries over the KV8 pools: qk, qv (NP, PS, KVH, D) int8,
    sk, sv (NP, PS, KVH) float32, through the (B, np_max) int32 table ->
    (B, H * D) fp32. The kernel's limits are ``paged_decode_attention``'s,
    and its pools' bases are 16-byte aligned (its copies are 16 bytes).

    Each slot's live pages are walked in splits of ``paged_split_plan``'s
    length, one block each, in one launch; the splits' partials and
    counters live in ``decode_attention``'s workspace, which grows only
    eagerly: a CUDA graph capture must follow one eager call at its size."""
    if q.device.type == "cpu":
        return paged_decode_attention_q8_ref(q, qk_pool, sk_pool, qv_pool,
                                             sv_pool, table, lengths)
    name = "paged_decode_attention_q8"
    require_cuda(name, q)
    q, lengths, dims = _check(name, q, (qk_pool, qv_pool),
                              (sk_pool, sv_pool), table, lengths, torch.int8)
    if any(p.data_ptr() % ALIGN for p in (qk_pool, qv_pool)):
        raise ValueError(f"{name}: pools not {ALIGN}-byte aligned")
    b, h, d = q.shape
    np_max, kvh = table.shape[1], qk_pool.shape[2]
    out = torch.empty((b, h * d), dtype=torch.float32, device=q.device)
    if b and np_max and kvh:
        per, splits = paged_split_plan(np_max, qk_pool.shape[1])
        count, part = _workspace(q.device, b * kvh,
                                 b * kvh * splits * (h // kvh) * (d + 2),
                                 name)
        _build.launch(name, q.device, q, qk_pool, sk_pool, qv_pool, sv_pool,
                      table, lengths, out, part, count, *dims[:-1], per,
                      dims[-1])
    return out
