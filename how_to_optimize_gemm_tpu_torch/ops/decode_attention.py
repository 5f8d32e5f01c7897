"""Length-aware single-query attention over a contiguous KV cache
(kernels ``decode_attention`` and, for the int8 KV8 cache,
``decode_attention_q8``).

Counterpart: ``how_to_optimize_gemm_tpu/ops/pallas_decode_attention.py``
(``decode_attention``, kernels ``_kernel_v3`` and ``_kernel_v4``;
``decode_attention_q8``, kernels ``_kernel_q8_v3`` and ``_kernel_q8_v4``:
each one function at two TPU widths, one CUDA template here,
``csrc/decode_attention.cuh``). q (B, H, D) holds one query per slot, the
caches (B, T, KVH, D) are time-major, and lengths (B,) counts each slot's
valid cache rows (the current token's K/V already written). Head
h = g * rep + r attends KV head g (GQA, rep = H / KVH). Returns
(B, H * D) float32.

The arithmetic is the reference's chunk walk over ``ceil(len / bk)``
chunks of bk keys: q in fp32 times D^-0.5; K cast to fp32; fp32 scores
with keys at positions >= len set to -1e30; an online softmax in fp32;
p rounded to bf16 before the PV product, which accumulates in fp32;
out = o / max(l, 1e-30). The KV8 cache holds int8 values and fp32 scales
sk, sv of layout (B, T, KVH), one per (slot, token, head): the scores are
multiplied by sk[t, g] and the PV operand is bf16(p * sv[t, g]). The TPU
lane tricks (``_pair_heads``, v4's block-diagonal Q, the one-hot scale
selector, the scales' lane padding to 128) compute the same function and
are not ported.

``decode_attention`` and ``decode_attention_q8`` launch their kernels for
CUDA tensors and run their plain versions (``*_ref``) only for CPU
tensors; kernel and plain version sum in other orders and agree to
rounding. Both kernels split each slot's chunks into runs of
``split_plan``'s length, walked by blocks of their own in one launch,
and combine the runs' partial softmax sums in a fixed order
(``csrc/decode_attention.cuh``'s split walk); the partials and a counter
per (slot, head) live in a workspace kept per device (``_workspace``),
which the paged kernels (``paged_attention.paged_decode_attention`` and
``paged_decode_attention_q8``) share.
"""
from __future__ import annotations

import torch

from how_to_optimize_gemm_tpu_torch import _build
from how_to_optimize_gemm_tpu_torch.ops.int8 import ALIGN, require_cuda

NEG_INF = -1e30
# the reference wrapper's default chunk and its fast-memory budget for
# two ping-pong (bk, KVH, D) chunks of K and of V
DEFAULT_BK = 512
_CHUNK_BUDGET = 6 * 1024 * 1024
# what the kernels' shared memory holds (csrc/decode_attention.cuh)
KERNEL_HEAD_DIMS = (32, 64, 128)
_MAX_SCORES = 8192        # rep * bk
_MAX_QELEMS = 2048        # rep * d
# decode_attention's split: whole bk chunks, SPLIT_KEYS keys or one chunk.
# At the 7B cache (T 4,096, bk 128, 32 heads) with the smoke's lengths
# (1, 300, 1,000, 4,096) that is 2 chunks, 736 live blocks of 128 threads
# (one block a (head, slot) would be 128): over 5 for each of the H100's
# 132 SMs, so every SM keeps a few blocks' copies in flight and the last
# wave is short; each block still walks 256 keys, whose 128 KB of K and V
# amortise its q load, its partial's write and the combine. Shorter
# splits add blocks that exit at once and partials to combine; at bk 512
# (the GQA widths) a split is one chunk.
SPLIT_KEYS = 256
# (counters, partials) by device; grown on demand, never shrunk
_WORKSPACE: dict = {}
# workspaces replaced by larger ones: a CUDA graph captured on one may
# still replay it, so none is freed
_RETIRED: list = []


def _divisor_block(t: int, cap: int) -> int:
    """Largest 128-multiple <= cap that divides t, else t."""
    for bk in range(cap // 128 * 128, 0, -128):
        if t % bk == 0:
            return bk
    return t


def pick_block(t: int, kvh: int, d: int, itemsize: int,
               bk: int = DEFAULT_BK) -> int:
    """The chunk length the reference wrapper picks for this cache."""
    cap = max(_CHUNK_BUDGET // (4 * kvh * d * itemsize) // 128 * 128, 128)
    return _divisor_block(t, min(bk, cap, t))


def split_plan(t: int, bk: int) -> tuple[int, int]:
    """(chunks a split, splits) of a cache of t rows in chunks of bk, from
    t and bk alone: the kernel's grid never depends on the lengths, which
    stay on the card."""
    chunks = -(-t // bk)
    per = max(1, SPLIT_KEYS // bk)
    return per, -(-chunks // per)


def _workspace(device, n_count: int, n_part: int,
               name: str = "decode_attention"):
    """The (int32 counters, float32 partials) of the split walk's kernels
    on ``device`` (``decode_attention``, ``decode_attention_q8``,
    ``paged_decode_attention`` and ``paged_decode_attention_q8``, which
    share it: calls on one stream leave the counters at zero), at least
    n_count and n_part long. The
    counters are zeroed once, when allocated: the kernels leave them at
    zero. A workspace is grown eagerly, never under a CUDA graph capture
    (its zero fill would run only in the graph's replays): a capture must
    follow one eager call at its size. The one it replaces stays allocated
    (``_RETIRED``)."""
    ws = _WORKSPACE.get(device)
    if ws is not None and ws[0].numel() >= n_count \
            and ws[1].numel() >= n_part:
        return ws
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{name}: its workspace must grow, which it "
                           "does not under a CUDA graph capture; call it "
                           "once eagerly at this size first")
    if ws is not None:
        _RETIRED.append(ws)
        n_count = max(n_count, ws[0].numel())
        n_part = max(n_part, ws[1].numel())
    ws = (torch.zeros(n_count, dtype=torch.int32, device=device),
          torch.empty(n_part, dtype=torch.float32, device=device))
    _WORKSPACE[device] = ws
    return ws


def _chunk_walk(q, k_cache, v_cache, lengths, bk, sk=None, sv=None,
                table=None):
    """The plain chunk walk, slot by slot, in PyTorch ops; sk, sv (B, T,
    KVH) are the KV8 scales (None for a bf16 cache).

    table None: the caches are (B, T, KVH, D) and chunk c of slot b is
    rows [c*bk, (c+1)*bk) of cache b. table (B, np_max): the caches (and
    scales) are page pools (NP, PS, ...) with bk = PS, and chunk c of slot
    b is page min(table[b, c], NP - 1), as the paged kernels read it."""
    b, h, d = q.shape
    kvh = k_cache.shape[2]
    rep = h // kvh
    if table is None:
        nk_max = k_cache.shape[1] // bk  # bk divides t (or equals it)

        def rows_of(x, bi, c):
            return x[bi, c * bk:(c + 1) * bk]
    else:
        nk_max = table.shape[1]
        pages = torch.as_tensor(table).clamp(max=k_cache.shape[0] - 1)
        pages = pages.tolist()

        def rows_of(x, bi, c):
            return x[pages[bi][c]]
    qg = q.reshape(b, kvh, rep, d).to(torch.float32) * d ** -0.5
    p_dtype = torch.bfloat16 if sv is not None else v_cache.dtype
    out = torch.zeros((b, kvh, rep, d), dtype=torch.float32, device=q.device)
    for bi, length in enumerate(torch.as_tensor(lengths).tolist()):
        nk = min(-(-length // bk), nk_max) if length > 0 else 0
        o = torch.zeros((kvh, rep, d), dtype=torch.float32, device=q.device)
        m = torch.full((kvh, rep, 1), NEG_INF, device=q.device)
        l = torch.zeros((kvh, rep, 1), device=q.device)
        for c in range(nk):
            kb = rows_of(k_cache, bi, c).to(torch.float32)  # (bk, kvh, d)
            s = torch.einsum("grd,tgd->grt", qg[bi], kb)
            if sk is not None:
                s = s * rows_of(sk, bi, c).t()[:, None, :]
            k_pos = c * bk + torch.arange(kb.shape[0], device=q.device)
            live = k_pos < length
            s = s.masked_fill(~live, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            if sv is not None:
                # rows past the length are never read (their p is 0)
                p = torch.where(live, p * rows_of(sv, bi, c).t()[:, None, :],
                                0.0)
            pv = torch.einsum("grt,tgd->grd", p.to(p_dtype).to(torch.float32),
                              rows_of(v_cache, bi, c).to(torch.float32))
            o = o * alpha + pv
            m = m_new
        out[bi] = o / torch.clamp_min(l, 1e-30)
    return out.reshape(b, h * d)


def decode_attention_ref(q, k_cache, v_cache, lengths, bk=DEFAULT_BK):
    """Plain version of ``decode_attention``: the same chunk walk, slot
    by slot, in PyTorch ops."""
    _, t, kvh, d = k_cache.shape
    bk = pick_block(t, kvh, d, k_cache.element_size(), bk)
    return _chunk_walk(q, k_cache, v_cache, lengths, bk)


def decode_attention_q8_ref(q, qk, sk, qv, sv, lengths, bk=DEFAULT_BK):
    """Plain version of ``decode_attention_q8``: the chunk walk over the
    int8 cache with the scales folded in."""
    _, t, kvh, d = qk.shape
    bk = pick_block(t, kvh, d, qk.element_size(), bk)
    return _chunk_walk(q, qk, qv, lengths, bk, sk, sv)


def _check(name, q, caches, scales, lengths, bk, dtype):
    """Raise on what the kernel does not take; returns (q as contiguous
    fp32, lengths as int32, b, h, d, t, kvh, rep, bk)."""
    b, h, d = q.shape
    k_cache = caches[0]
    _, t, kvh, dk = k_cache.shape
    if (k_cache.shape[0] != b or dk != d or h % kvh
            or any(c.shape != k_cache.shape for c in caches)
            or any(tuple(s.shape) != (b, t, kvh) for s in scales)):
        raise ValueError(f"{name}: q {tuple(q.shape)}, caches "
                         f"{[tuple(c.shape) for c in caches]}, scales "
                         f"{[tuple(s.shape) for s in scales]}")
    rep = h // kvh
    bk = pick_block(t, kvh, d, k_cache.element_size(), bk)
    if d not in KERNEL_HEAD_DIMS or rep * d > _MAX_QELEMS \
            or rep * bk > _MAX_SCORES:
        raise ValueError(f"{name}: the kernel takes d in "
                         f"{KERNEL_HEAD_DIMS}, rep*d <= {_MAX_QELEMS}, "
                         f"rep*bk <= {_MAX_SCORES}; got d={d}, rep={rep}, "
                         f"bk={bk}")
    for x, want in [(c, dtype) for c in caches] + [(s, torch.float32)
                                                   for s in scales]:
        if x.device != q.device:
            raise ValueError(f"{name}: cache on {x.device}, q on {q.device}")
        if x.dtype != want or not x.is_contiguous():
            raise TypeError(f"{name}: expected contiguous {want}, got "
                            f"{x.dtype}")
    lengths = torch.as_tensor(lengths, device=q.device).to(torch.int32)
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"{name}: lengths {tuple(lengths.shape)}")
    return (q.to(torch.float32).contiguous(), lengths, b, h, d, t, kvh, rep,
            bk)


def decode_attention(q, k_cache, v_cache, lengths, bk=DEFAULT_BK):
    """(B, H, D) queries over (B, T, KVH, D) caches -> (B, H * D) fp32.

    Each slot reads only its first ``ceil(lengths[b] / bk)`` chunks of
    ``bk`` keys (bk as the reference wrapper picks it, ``pick_block``),
    in splits of ``split_plan``'s length, one block each, one launch.
    The kernel takes bf16 caches, D in {32, 64, 128}, rep * D <= 2048
    and rep * bk <= 8192."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, lengths, bk)
    require_cuda("decode_attention", q)
    q, lengths, b, h, d, t, kvh, rep, bk = _check(
        "decode_attention", q, (k_cache, v_cache), (), lengths, bk,
        torch.bfloat16)
    out = torch.empty((b, h * d), dtype=torch.float32, device=q.device)
    if b and t and kvh:
        per, splits = split_plan(t, bk)
        count, part = _workspace(q.device, b * kvh,
                                 b * kvh * splits * rep * (d + 2))
        _build.launch("decode_attention", q.device, q, k_cache, v_cache,
                      lengths, out, part, count, b, t, kvh, rep, d, bk, per,
                      d ** -0.5)
    return out


def decode_attention_q8(q, qk, sk, qv, sv, lengths, bk=DEFAULT_BK):
    """(B, H, D) queries over the KV8 cache: qk, qv (B, T, KVH, D) int8,
    sk, sv (B, T, KVH) float32 -> (B, H * D) fp32.

    The chunk length is the reference's for a 1-byte cache
    (``pick_block``); the kernel's limits are ``decode_attention``'s, and
    its caches' bases are 16-byte aligned (its copies are 16 bytes). Each
    slot's live chunks are walked in splits of ``split_plan``'s length, one
    block each, in one launch, on ``decode_attention``'s workspace, which
    grows only eagerly: a CUDA graph capture must follow one eager call at
    its size."""
    if q.device.type == "cpu":
        return decode_attention_q8_ref(q, qk, sk, qv, sv, lengths, bk)
    name = "decode_attention_q8"
    require_cuda(name, q)
    q, lengths, b, h, d, t, kvh, rep, bk = _check(
        name, q, (qk, qv), (sk, sv), lengths, bk, torch.int8)
    if any(c.data_ptr() % ALIGN for c in (qk, qv)):
        raise ValueError(f"{name}: caches not {ALIGN}-byte aligned")
    out = torch.empty((b, h * d), dtype=torch.float32, device=q.device)
    if b and t and kvh:
        per, splits = split_plan(t, bk)
        count, part = _workspace(q.device, b * kvh,
                                 b * kvh * splits * rep * (d + 2), name)
        _build.launch(name, q.device, q, qk, sk, qv, sv, lengths, out, part,
                      count, b, t, kvh, rep, d, bk, per, d ** -0.5)
    return out
