"""Flash attention: the causal or non-causal GQA forward with an online
softmax (kernel ``flash_attention``).

Counterpart: ``how_to_optimize_gemm_tpu/ops/pallas_attention.py``
(``flash_attention``, kernel ``_stream_kernel``, and around it
``flash_attention_packed`` and ``mha_flash``). q (B, H, S, D) and k, v
(B, KVH, T, D), bf16; query head h attends KV head h // (H // KVH), which
is never expanded or copied per query head. The queries are the last S of
T positions (query i sits at position T - S + i), so S <= T; keys exist at
positions 0 .. T - 1 only. S and T need not be multiples of any block.

The arithmetic is the reference's walk over blocks of keys: scores q . k
in fp32 times ``scale`` (default D ** -0.5); masked scores -1e30 (causal:
key position > query position); per block m_new = max(m, max s),
alpha = exp(m - m_new) and p = exp(s - m_new) in fp32; l = l * alpha +
sum p over the fp32 p; o = o * alpha + bf16(p) @ v accumulated in fp32;
the output o / max(l, 1e-30) rounded to q's dtype.

Not ported, because the TPU's grid runs in order and a GPU's blocks do
not: the super-block strips of K/V (``ts_len``), the online-softmax state
carried in scratch from one strip to the next, and the dead-strip clamp.
On the card one block of the kernel walks all of its key tiles itself, so
T has no cap (the reference's multi-strip case, T > 8192, is the same
walk). Rows that see no key at all, which the reference computes with
p = exp(0) on masked keys, arise only from a causal S > T: the wrapper
refuses that instead of copying it.

``flash_attention`` launches the kernel for CUDA tensors and runs the
plain version ``flash_attention_ref`` only for CPU tensors. The kernel's
key tile is ``KERNEL_BLOCK`` keys; its sums run in another order than the
plain version's, so the two agree to rounding.
"""
from __future__ import annotations

import torch

from how_to_optimize_gemm_tpu_torch import _build
from how_to_optimize_gemm_tpu_torch.ops import bounds
from how_to_optimize_gemm_tpu_torch.ops.int8 import require_cuda

NEG_INF = -1e30
# the reference wrapper's default key block, capped at T rounded up to 128
DEFAULT_BLOCK = 512
# the kernel's query and key tiles (csrc/flash_attention.cu)
KERNEL_BLOCK = 64
HEAD_DIMS = (64, 128)
_INT32_MAX = 2 ** 31 - 1


def default_block(t: int) -> int:
    """The key block the reference picks when none is given, without its
    TPU autotune lookup: min(512, round_up(T, 128))."""
    return min(DEFAULT_BLOCK, bounds.round_up(t, 128))


def flash_attention_ref(q, k, v, *, causal: bool = True, bk: int | None = None,
                        scale: float | None = None) -> torch.Tensor:
    """Plain version of ``flash_attention``: the reference's online
    softmax over key blocks of ``bk`` (default ``default_block(T)``), all
    query rows at once. A row visits blocks past its last visible key,
    which the reference's causal early exit skips; there every score is
    -1e30, so alpha = 1 and p = 0 and the row's state is unchanged."""
    b, h, s, d = q.shape
    kvh, t = k.shape[1], k.shape[2]
    rep = h // kvh
    bk = bk or default_block(t)
    scale = d ** -0.5 if scale is None else scale
    dev = q.device
    qf = (q.to(torch.float32) * scale).reshape(b, kvh, rep, s, d)
    q_pos = (t - s) + torch.arange(s, device=dev)[:, None]
    o = torch.zeros((b, kvh, rep, s, d), dtype=torch.float32, device=dev)
    m = torch.full((b, kvh, rep, s, 1), NEG_INF, device=dev)
    l = torch.zeros((b, kvh, rep, s, 1), device=dev)
    for k0 in range(0, t, bk):
        kb = k[:, :, k0:k0 + bk].to(torch.float32)
        sc = torch.einsum("bgrsd,bgnd->bgrsn", qf, kb)
        if causal:
            k_pos = k0 + torch.arange(kb.shape[2], device=dev)
            sc = sc.masked_fill(k_pos > q_pos, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        vb = v[:, :, k0:k0 + bk]
        o = o * alpha + torch.einsum("bgrsn,bgnd->bgrsd",
                                     p.to(vb.dtype).to(torch.float32),
                                     vb.to(torch.float32))
        m = m_new
    out = o / torch.clamp_min(l, 1e-30)
    return out.reshape(b, h, s, d).to(q.dtype)


def bf16_row_ulps(out, ref) -> torch.Tensor:
    """Per row (every index but the last), max |out - ref| in bf16 ulps of
    that row's max |ref|: the measure the kernel is held to against its
    plain version. A row's outputs shrink as it attends more keys, so a
    bound relative to the whole tensor's largest output (a row that sees
    one key) would pass a long row that is wrong."""
    err = (out.float() - ref.float()).abs().amax(dim=-1)
    mag = ref.float().abs().amax(dim=-1).clamp_min(2.0 ** -126)
    _, e = torch.frexp(mag)              # mag = f * 2 ** e, 0.5 <= f < 1
    return err / torch.exp2((e - 8).float())


def _check(q, k, v, causal: bool):
    """Raise on what the kernel does not take; returns (b, h, s, d, kvh,
    t). The kernel reads bf16 rows of D contiguous elements that start on
    16-byte boundaries, through the strides of the other three dims."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, h, s, d = q.shape
    bk_, kvh, t, dk = k.shape
    if bk_ != b or dk != d or kvh == 0 or h % kvh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} against k, v "
                         f"{tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes d in "
                         f"{HEAD_DIMS}, got {d}")
    if causal and s > t:
        raise ValueError(f"flash_attention: causal with S={s} > T={t} leaves "
                         "rows with no visible key")
    if t == 0 and s:
        raise ValueError("flash_attention: no keys (T=0)")
    for x in (q, k, v):
        if x.device != q.device:
            raise ValueError(f"flash_attention: operands on {x.device} and "
                             f"{q.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention: expected bf16, got {x.dtype}")
        if x.numel() and (x.stride(-1) != 1
                          or any(st % 8 or st > _INT32_MAX
                                 for st in x.stride()[:3])
                          or x.data_ptr() % 16):
            raise ValueError(f"flash_attention: rows must be contiguous and "
                             f"16-byte aligned, got strides {x.stride()}")
    return b, h, s, d, kvh, t


def flash_attention(q, k, v, *, causal: bool = True, bq: int | None = None,
                    bk: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q (B, H, S, D), k and v (B, KVH, T, D), bf16 -> (B, H, S, D) bf16.

    D in {64, 128}, H a multiple of KVH, S <= T when causal; any strides
    that keep each row of D elements contiguous and 16-byte aligned (the
    model passes transposed views of (B, S, H, D) tensors, never copies).
    The output has q's strides. On the CPU, ``bk`` is the plain version's
    key block and ``bq`` changes nothing (the reference's query block only
    bounds its causal early exit); on the card the kernel's tiles are
    ``KERNEL_BLOCK`` queries by ``KERNEL_BLOCK`` keys, and another bq or
    bk raises."""
    b, h, s, d, kvh, t = _check(q, k, v, causal)
    scale = d ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, bk=bk, scale=scale)
    require_cuda("flash_attention", q)
    if any(x not in (None, KERNEL_BLOCK) for x in (bq, bk)):
        raise ValueError(f"flash_attention: the kernel's tiles are "
                         f"{KERNEL_BLOCK} x {KERNEL_BLOCK}; got bq={bq}, "
                         f"bk={bk}")
    out = torch.empty_like(q)
    if b and h and s:
        _build.launch("flash_attention", q.device, q, k, v, out, b, h, kvh,
                      s, t, d, int(causal), *q.stride()[:3],
                      *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                      float(scale))
    return out


def flash_attention_packed(q, k, v, *, causal: bool = True,
                           bq: int | None = None,
                           bk: int | None = None) -> torch.Tensor:
    """The reference's d=64 head-packed view over the same kernel: two
    adjacent KV heads ride one 128-wide row (k, v: a concat of heads
    2g and 2g+1 along D), each query head is zero-extended into its pair's
    band, so the zero band cancels the other head's terms, and each head
    keeps its own band of the output. The scale stays 64 ** -0.5. KVH must
    be even. The reference measured this view slower than the plain one
    on its TPU, and ``mha_flash`` does not take it unless asked."""
    b, h, s, d = q.shape
    kvh = k.shape[1]
    if kvh % 2:
        raise ValueError(f"flash_attention_packed: KVH={kvh} is odd")
    rep = h // kvh
    band = ((torch.arange(h, device=q.device) // rep) % 2)[None, :, None,
                                                           None]
    z = torch.zeros_like(q)
    q2 = torch.cat([torch.where(band == 0, q, z),
                    torch.where(band == 0, z, q)], dim=-1)
    k2 = torch.cat([k[:, 0::2], k[:, 1::2]], dim=-1)
    v2 = torch.cat([v[:, 0::2], v[:, 1::2]], dim=-1)
    out = flash_attention(q2, k2, v2, causal=causal, bq=bq, bk=bk,
                          scale=d ** -0.5)
    return torch.where(band == 0, out[..., :d], out[..., d:])


def mha_flash(q, k, v, *, causal: bool = True,
              pack_heads: bool | None = None) -> torch.Tensor:
    """Model layout: q (B, S, H, D), k and v (B, T, KVH, D) -> (B, S, H * D)
    float32. q is rounded to k's dtype first; the kernel reads the three
    through (B, H, S, D) views, without copies. pack_heads routes d=64
    models with an even KVH through ``flash_attention_packed``; None
    leaves it off, as the reference measured."""
    b, s, h, d = q.shape
    packable = d == 64 and k.shape[2] % 2 == 0
    fn = (flash_attention_packed if pack_heads and packable
          else flash_attention)
    out = fn(q.to(k.dtype).transpose(1, 2), k.transpose(1, 2),
             v.transpose(1, 2), causal=causal)
    return out.transpose(1, 2).reshape(b, s, h * d).to(torch.float32)
