"""Length-aware single-query attention over a contiguous KV cache
(kernel ``decode_attention``).

Counterpart: ``how_to_optimize_gemm_tpu/ops/pallas_decode_attention.py``
(``decode_attention``, kernels ``_kernel_v3`` and ``_kernel_v4``: one
function at two TPU widths, one CUDA kernel here). q (B, H, D) holds one
query per slot, k_cache and v_cache (B, T, KVH, D) are time-major, and
lengths (B,) counts each slot's valid cache rows (the current token's
K/V already written). Head h = g * rep + r attends KV head g (GQA,
rep = H / KVH). Returns (B, H * D) float32.

The arithmetic is the reference's chunk walk over ``ceil(len / bk)``
chunks of bk keys: q in fp32 times D^-0.5; K cast to fp32; fp32 scores
with keys at positions >= len set to -1e30; an online softmax in fp32;
p rounded to the cache's dtype before the PV product, which accumulates
in fp32; out = o / max(l, 1e-30). The TPU lane tricks (``_pair_heads``,
v4's block-diagonal Q) compute the same function and are not ported.

``decode_attention`` launches ``csrc/decode_attention.cu`` for CUDA
tensors and runs its plain version ``decode_attention_ref`` only for CPU
tensors; the two sum in other orders and agree to rounding.
"""
from __future__ import annotations

import torch

from how_to_optimize_gemm_tpu_torch import _build
from how_to_optimize_gemm_tpu_torch.ops.int8 import require_cuda

NEG_INF = -1e30
# the reference wrapper's default chunk and its fast-memory budget for
# two ping-pong (bk, KVH, D) chunks of K and of V
DEFAULT_BK = 512
_CHUNK_BUDGET = 6 * 1024 * 1024
# what the kernel's shared memory holds (csrc/decode_attention.cu)
KERNEL_HEAD_DIMS = (32, 64, 128)
_MAX_SCORES = 8192        # rep * bk
_MAX_QELEMS = 2048        # rep * d


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


def decode_attention_ref(q, k_cache, v_cache, lengths, bk=DEFAULT_BK):
    """Plain version of ``decode_attention``: the same chunk walk, slot
    by slot, in PyTorch ops."""
    b, h, d = q.shape
    _, t, kvh, _ = k_cache.shape
    rep = h // kvh
    bk = pick_block(t, kvh, d, k_cache.element_size(), bk)
    nk_max = t // bk                     # bk divides t (or equals it)
    qg = q.reshape(b, kvh, rep, d).to(torch.float32) * d ** -0.5
    out = torch.zeros((b, kvh, rep, d), dtype=torch.float32, device=q.device)
    for bi, length in enumerate(torch.as_tensor(lengths).tolist()):
        nk = min(-(-length // bk), nk_max) if length > 0 else 0
        o = torch.zeros((kvh, rep, d), dtype=torch.float32, device=q.device)
        m = torch.full((kvh, rep, 1), NEG_INF, device=q.device)
        l = torch.zeros((kvh, rep, 1), device=q.device)
        for c in range(nk):
            rows = slice(c * bk, (c + 1) * bk)
            kb = k_cache[bi, rows].to(torch.float32)        # (bk, kvh, d)
            s = torch.einsum("grd,tgd->grt", qg[bi], kb)
            k_pos = c * bk + torch.arange(kb.shape[0], device=q.device)
            s = s.masked_fill(k_pos >= length, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            pv = torch.einsum("grt,tgd->grd",
                              p.to(v_cache.dtype).to(torch.float32),
                              v_cache[bi, rows].to(torch.float32))
            o = o * alpha + pv
            m = m_new
        out[bi] = o / torch.clamp_min(l, 1e-30)
    return out.reshape(b, h * d)


def decode_attention(q, k_cache, v_cache, lengths, bk=DEFAULT_BK):
    """(B, H, D) queries over (B, T, KVH, D) caches -> (B, H * D) fp32.

    Each slot reads only its first ``ceil(lengths[b] / bk)`` chunks of
    ``bk`` keys (bk as the reference wrapper picks it, ``pick_block``).
    The kernel takes bf16 caches, D in {32, 64, 128}, rep * D <= 2048
    and rep * bk <= 8192."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, lengths, bk)
    require_cuda("decode_attention", q)
    b, h, d = q.shape
    _, t, kvh, dk = k_cache.shape
    if (k_cache.shape[0] != b or dk != d or h % kvh
            or v_cache.shape != k_cache.shape):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    rep = h // kvh
    bk = pick_block(t, kvh, d, k_cache.element_size(), bk)
    if d not in KERNEL_HEAD_DIMS or rep * d > _MAX_QELEMS \
            or rep * bk > _MAX_SCORES:
        raise ValueError(f"decode_attention: the kernel takes d in "
                         f"{KERNEL_HEAD_DIMS}, rep*d <= {_MAX_QELEMS}, "
                         f"rep*bk <= {_MAX_SCORES}; got d={d}, rep={rep}, "
                         f"bk={bk}")
    for x in (k_cache, v_cache):
        if x.device != q.device:
            raise ValueError(f"decode_attention: cache on {x.device}, q on "
                             f"{q.device}")
        if x.dtype != torch.bfloat16 or not x.is_contiguous():
            raise TypeError("decode_attention: caches must be contiguous "
                            "bf16")
    q = q.to(torch.float32).contiguous()
    lengths = torch.as_tensor(lengths, device=q.device).to(torch.int32)
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"decode_attention: lengths {tuple(lengths.shape)}")
    out = torch.empty((b, h * d), dtype=torch.float32, device=q.device)
    if b and t and kvh:
        _build.launch("decode_attention", q.device, q, k_cache, v_cache,
                      lengths, out, b, t, kvh, rep, d, bk, d ** -0.5)
    return out
