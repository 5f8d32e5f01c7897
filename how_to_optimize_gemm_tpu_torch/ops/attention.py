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
tiles are ``KERNEL_BQ`` queries by ``KERNEL_BK`` keys; the key tile sets
where p rounds to bf16, so the plain version at ``bk=KERNEL_BK`` is its
yardstick. Its sums run in another order than the plain version's, so the
two agree to rounding. It has no backward: it raises when grad mode is on
and an operand requires grad.

The training half (counterpart: ``pallas_attention.py``'s
``_fwd_kernel_lse``, ``_bwd_dq_kernel``, ``_bwd_dkv_kernel``,
``_flash_fwd_lse``, ``_flash_bwd``, ``flash_attention_train`` and
``mha_flash_train``) is causal or non-causal GQA self-attention (S == T)
with a backward, three kernels under ``FlashAttentionTrain``:

- ``flash_attention_fwd_lse`` (kernel ``flash_attention_fwd_lse``): q
  (B, H, S, D) float32, k and v (B, KVH, S, D) bf16 -> out float32 and
  the logsumexp rows lse (B, H, S) float32 (the reference's trailing dim
  of 8 is a Mosaic tiling rule and is not kept). q is not rounded to
  bf16: the scores are fl(q * scale) . k in fp32; p is rounded to bf16
  before p @ v, as in the inference kernel; lse = m + log(max(l, 1e-30)).
- ``flash_attention_bwd_dq`` (kernel ``flash_attention_bwd_dq``): per
  key block s = fl(q * scale) . k, p = exp(s - lse), dp = do . v,
  ds = p (dp - delta), dq += ds . k, all in fp32 with delta = sum(do * o)
  (computed outside the kernels, as the reference does in XLA); the
  result is dq * scale in fp32.
- ``flash_attention_bwd_dkv`` (kernel ``flash_attention_bwd_dkv``): q and
  do rounded to bf16 first; per query block and query head of the KV
  head's group, dv += p^T . do and dk += ds^T . fl(q * scale), in fp32;
  dk and dv in fp32 (the autograd function rounds them to k's dtype).

The reference pads an S that is no block multiple outside its custom VJP
and masks the padded keys; the kernels and plain versions take any S, so
nothing is padded: no key at or past S enters a softmax, and there are
no padded query rows. The forward kernel's tiles are ``KERNEL_BQ`` queries
by ``KERNEL_BK_LSE`` keys, the dQ kernel's ``KERNEL_DQ_ROWS`` by
``KERNEL_BLOCK`` (a persistent ``wgmma`` kernel, ``dq_walk``); the dK/dV
kernel walks ``KERNEL_BLOCK`` queries a step
(a ``wgmma`` kernel whose blocks hold 128 keys at D 64 and 64 at D 128,
csrc/flash_attention_bwd_dkv.cu). The plain versions walk the reference's blocks:
``train_block(S)``, the least-waste of 512, 256 and 128, unless told
otherwise; they also take queries that are the last S of T positions
(S <= T), which the wrappers do not.
"""
from __future__ import annotations

import torch

from how_to_optimize_gemm_tpu_torch import _build
from how_to_optimize_gemm_tpu_torch.ops import bounds
from how_to_optimize_gemm_tpu_torch.ops.int8 import require_cuda

NEG_INF = -1e30
# the reference wrapper's default key block, capped at T rounded up to 128
DEFAULT_BLOCK = 512
# the forward kernels' query tile and key tiles (csrc/flash_wgmma.cuh:
# flash_attention.cu, flash_attention_fwd_lse.cu); the key tile sets where
# p rounds to bf16
KERNEL_BQ = 128
KERNEL_BK = 64
KERNEL_BK_LSE = 64
# the dQ kernel's key tile (flash_attention_bwd_dq.cu) and the dK/dV
# kernel's query step (flash_attention_bwd_dkv.cu)
KERNEL_BLOCK = 64
# the dQ kernel's query rows an item (64 each of its two consumer
# warpgroups)
KERNEL_DQ_ROWS = 128
HEAD_DIMS = (64, 128)
# the reference's training blocks (mha_flash_train's least-waste choice)
TRAIN_BLOCKS = (512, 256, 128)
_INT32_MAX = 2 ** 31 - 1


def default_block(t: int) -> int:
    """The key block the reference picks when none is given, without its
    TPU autotune lookup: min(512, round_up(T, 128))."""
    return min(DEFAULT_BLOCK, bounds.round_up(t, 128))


def train_block(s: int) -> int:
    """The reference's training block for S: the least padding among
    ``TRAIN_BLOCKS``, ties to the larger block."""
    return min(TRAIN_BLOCKS, key=lambda bb: (bounds.round_up(s, bb), -bb))


def flash_attention_ref(q, k, v, *, causal: bool = True, bk: int | None = None,
                        scale: float | None = None) -> torch.Tensor:
    """Plain version of ``flash_attention``: the reference's online
    softmax over key blocks of ``bk`` (default ``default_block(T)``), all
    query rows at once; the arithmetic of ``flash_attention_fwd_lse_ref``
    (on bf16 q), whose lse it drops."""
    return flash_attention_fwd_lse_ref(
        q, k, v, causal=causal, bk=bk or default_block(k.shape[2]),
        scale=scale)[0]


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


# row_rel_err's floor, as a share of the tensor's max |ref|
ROW_FLOOR = 1e-2


def row_rel_err(out, ref, floor: float = ROW_FLOOR) -> torch.Tensor:
    """Per row (every index but the last), max |out - ref| over that row's
    max |ref|: the measure the training kernels are held to against their
    plain versions. A row's max is raised to at least ``floor`` times the
    tensor's max |ref|, so that a row whose values cancel to about 0 (dq
    of the first query, which sees one key) is held to the tensor's scale
    and not to its own rounding noise."""
    err = (out.float() - ref.float()).abs().amax(dim=-1)
    mag = ref.float().abs().amax(dim=-1)
    return err / torch.maximum(mag, floor * mag.max()).clamp_min(1e-30)


def _check_tiles(name: str, *given) -> None:
    """Raise unless each (value, tiles) pair's value is None or one of
    its kernel tiles: on the card the kernels' tiles are fixed."""
    for value, tiles in given:
        if value is not None and value not in tiles:
            raise ValueError(f"{name}: the kernel's tiles are "
                             f"{sorted(tiles)}; got {value}")


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
    bounds its causal early exit); elsewhere the kernel's tiles are
    ``KERNEL_BQ`` queries by ``KERNEL_BK`` keys, and another bq or bk
    raises. There is no backward: an operand that requires grad, with
    grad mode on, raises on every device (``flash_attention_train`` is the
    differentiable form)."""
    _build.require_no_grad("flash_attention", q, k, v)
    b, h, s, d, kvh, t = _check(q, k, v, causal)
    scale = d ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, bk=bk, scale=scale)
    _check_tiles("flash_attention", (bq, {KERNEL_BQ}), (bk, {KERNEL_BK}))
    require_cuda("flash_attention", q)
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
    leaves it off, as the reference measured. No backward
    (``mha_flash_train`` is the differentiable form)."""
    _build.require_no_grad("mha_flash", q, k, v)
    b, s, h, d = q.shape
    packable = d == 64 and k.shape[2] % 2 == 0
    fn = (flash_attention_packed if pack_heads and packable
          else flash_attention)
    out = fn(q.to(k.dtype).transpose(1, 2), k.transpose(1, 2),
             v.transpose(1, 2), causal=causal)
    return out.transpose(1, 2).reshape(b, s, h * d).to(torch.float32)


# ---------------------------------------------------------------- training

def _train_views(q, k, v, lse=None, delta=None):
    """(b, kvh, rep, s, t, d) and the (b, kvh, rep, s, 1) views of lse
    and delta, for the plain versions."""
    b, h, s, d = q.shape
    kvh, t = k.shape[1], k.shape[2]
    rep = h // kvh
    rows = [x.to(torch.float32).reshape(b, kvh, rep, s, 1)
            for x in (lse, delta) if x is not None]
    return (b, kvh, rep, s, t, d), rows


def _positions(s: int, t: int, dev):
    """Query positions (s, 1), the last s of t, and key positions (t,)."""
    return ((t - s) + torch.arange(s, device=dev)[:, None],
            torch.arange(t, device=dev))


def flash_attention_fwd_lse_ref(q, k, v, *, causal: bool = True,
                                bk: int | None = None,
                                scale: float | None = None):
    """Plain version of ``flash_attention_fwd_lse`` (the reference's
    ``_fwd_kernel_lse``): the online softmax over key blocks of ``bk``
    (default ``train_block(T)``), all query rows at once, on fl(q * scale)
    in fp32 -> (out in q's dtype, lse (B, H, S) float32). A row visits
    blocks past its last visible key, which the reference's causal early
    exit skips; there p = 0 and alpha = 1, so its state is unchanged."""
    (b, kvh, rep, s, t, d), _ = _train_views(q, k, v)
    bk = bk or train_block(t)
    scale = d ** -0.5 if scale is None else scale
    dev = q.device
    qf = (q.to(torch.float32) * scale).reshape(b, kvh, rep, s, d)
    q_pos, k_pos = _positions(s, t, dev)
    o = torch.zeros((b, kvh, rep, s, d), dtype=torch.float32, device=dev)
    m = torch.full((b, kvh, rep, s, 1), NEG_INF, device=dev)
    l = torch.zeros((b, kvh, rep, s, 1), device=dev)
    for k0 in range(0, t, bk):
        kb = k[:, :, k0:k0 + bk].to(torch.float32)
        sc = torch.einsum("bgrsd,bgnd->bgrsn", qf, kb)
        if causal:
            sc = sc.masked_fill(k_pos[k0:k0 + bk] > q_pos, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        vb = v[:, :, k0:k0 + bk]
        o = o * alpha + torch.einsum("bgrsn,bgnd->bgrsd",
                                     p.to(vb.dtype).to(torch.float32),
                                     vb.to(torch.float32))
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    out = (o / l).reshape(b, kvh * rep, s, d).to(q.dtype)
    return out, (m + torch.log(l)).reshape(b, kvh * rep, s)


def dq_walk(s: int, h: int, b: int, blocks: int) -> list:
    """The (first query row, head, batch) items that each block of the
    dQ kernel's persistent grid takes, in order, for S = ``s``: items of
    ``KERNEL_DQ_ROWS`` query rows, the last query tile (the longest
    causal walk) first, heads fastest, then batches; the kernel launches
    ``min(blocks, items)`` blocks (one an SM) and walks rounds of that many
    items, block i taking a round's item i in even rounds and its item
    blocks - 1 - i in odd ones, so that the longest of one round and the
    shortest of the next go to the same block."""
    bq = KERNEL_DQ_ROWS
    nq, hb = -(-s // bq), h * b
    total = nq * hb
    g = min(blocks, total)

    def item(w):
        return (nq - 1 - w // hb) * bq, w % hb % h, w % hb // h
    walk = []
    for i in range(g):
        ws = [k * g + (g - 1 - i if k % 2 else i)
              for k in range(-(-total // g))]
        walk.append([item(w) for w in ws if w < total])
    return walk


def flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, *,
                               causal: bool = True, bk: int | None = None,
                               scale: float | None = None) -> torch.Tensor:
    """Plain version of ``flash_attention_bwd_dq`` (the reference's
    ``_bwd_dq_kernel``): over key blocks of ``bk`` (default
    ``train_block(T)``), s = fl(q * scale) . k, p = exp(s - lse),
    dp = do . v, ds = p (dp - delta), dq += ds . k, in fp32 -> dq * scale
    (B, H, S, D) float32."""
    (b, kvh, rep, s, t, d), (lse_, delta_) = _train_views(q, k, v, lse,
                                                          delta)
    bk = bk or train_block(t)
    scale = d ** -0.5 if scale is None else scale
    dev = q.device
    qf = (q.to(torch.float32) * scale).reshape(b, kvh, rep, s, d)
    dof = do.to(torch.float32).reshape(b, kvh, rep, s, d)
    q_pos, k_pos = _positions(s, t, dev)
    dq = torch.zeros((b, kvh, rep, s, d), dtype=torch.float32, device=dev)
    for k0 in range(0, t, bk):
        kb = k[:, :, k0:k0 + bk].to(torch.float32)
        vb = v[:, :, k0:k0 + bk].to(torch.float32)
        sc = torch.einsum("bgrsd,bgnd->bgrsn", qf, kb)
        if causal:
            sc = sc.masked_fill(k_pos[k0:k0 + bk] > q_pos, NEG_INF)
        p = torch.exp(sc - lse_)
        dp = torch.einsum("bgrsd,bgnd->bgrsn", dof, vb)
        ds = p * (dp - delta_)
        dq = dq + torch.einsum("bgrsn,bgnd->bgrsd", ds, kb)
    return (dq * scale).reshape(b, kvh * rep, s, d)


def flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, *,
                                causal: bool = True, bq: int | None = None,
                                scale: float | None = None):
    """Plain version of ``flash_attention_bwd_dkv`` (the reference's
    ``_bwd_dkv_kernel`` and the bf16 rounding of q and do before it): over
    query blocks of ``bq`` (default ``train_block(S)``) and, inside each,
    the ``rep`` query heads of every KV head's group in turn,
    p = exp(fl(q * scale) . k - lse), dv += p^T . do,
    ds = p (do . v - delta), dk += ds^T . fl(q * scale), in fp32 ->
    (dk, dv), each (B, KVH, T, D) float32."""
    (b, kvh, rep, s, t, d), (lse_, delta_) = _train_views(q, k, v, lse,
                                                          delta)
    bq = bq or train_block(s)
    scale = d ** -0.5 if scale is None else scale
    dev = q.device
    q16 = q.to(torch.bfloat16).to(torch.float32).reshape(b, kvh, rep, s, d)
    do16 = do.to(torch.bfloat16).to(torch.float32).reshape(b, kvh, rep, s,
                                                           d)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    q_pos, k_pos = _positions(s, t, dev)
    dk = torch.zeros((b, kvh, t, d), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    for q0 in range(0, s, bq):
        rows = slice(q0, q0 + bq)
        for r in range(rep):
            qb = q16[:, :, r, rows] * scale
            dob = do16[:, :, r, rows]
            sc = torch.einsum("bgsd,bgnd->bgsn", qb, kf)
            if causal:
                sc = sc.masked_fill(k_pos > q_pos[rows], NEG_INF)
            p = torch.exp(sc - lse_[:, :, r, rows])
            dv = dv + torch.einsum("bgsn,bgsd->bgnd", p, dob)
            dp = torch.einsum("bgsd,bgnd->bgsn", dob, vf)
            ds = p * (dp - delta_[:, :, r, rows])
            dk = dk + torch.einsum("bgsn,bgsd->bgnd", ds, qb)
    return dk, dv


def flash_attention_bwd_ref(q, k, v, out, lse, do, *, causal: bool = True,
                            bq: int | None = None, bk: int | None = None,
                            scale: float | None = None):
    """Plain version of the whole backward (the reference's ``_flash_bwd``):
    delta = sum(do * o) over D in fp32, then the dq and dK/dV passes ->
    (dq, dk, dv) float32."""
    delta = (do.to(torch.float32) * out.to(torch.float32)).sum(dim=-1)
    dq = flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, causal=causal,
                                    bk=bk, scale=scale)
    dk, dv = flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta,
                                         causal=causal, bq=bq, scale=scale)
    return dq, dk, dv


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` if the kernels can read it through its strides (rows of D
    contiguous elements starting on 16-byte boundaries, strides in int),
    else a contiguous copy."""
    per16 = 16 // x.element_size()
    if (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(st % per16 == 0 and st <= _INT32_MAX
                    for st in x.stride()[:3])):
        return x
    return x.contiguous()


def _check_train(name: str, q, k, v, causal: bool, *tiles):
    """Raise on what the training kernels do not take; returns (b, h, s, d,
    kvh). Off the CPU: each (block, kernel tiles) pair of ``tiles`` None
    or one of its tiles (``_check_tiles``); on the card q float32, k and
    v bf16. Everywhere: self-attention (S == T), D in {64, 128}."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    b, h, s, d = q.shape
    if (k.shape[0] != b or k.shape[2] != s or k.shape[3] != d
            or k.shape[1] == 0 or h % k.shape[1]):
        raise ValueError(f"{name}: self-attention takes q (B, H, S, D) and "
                         f"k, v (B, KVH, S, D); got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: d in {HEAD_DIMS}, got {d}")
    if q.device.type != "cpu":
        _check_tiles(name, *tiles)
        require_cuda(name, q)
        if q.dtype != torch.float32 or k.dtype != torch.bfloat16 \
                or v.dtype != torch.bfloat16:
            raise TypeError(f"{name}: q float32 and k, v bf16, got "
                            f"{q.dtype}, {k.dtype}, {v.dtype}")
    return b, h, s, d, k.shape[1]


def _strides(*tensors):
    return [st for x in tensors for st in x.stride()[:3]]


def flash_attention_fwd_lse(q, k, v, *, causal: bool = True,
                            bk: int | None = None,
                            scale: float | None = None):
    """q (B, H, S, D), k and v (B, KVH, S, D) -> (out like q in float32,
    lse (B, H, S) float32); on the card q float32 and k, v bf16. The kernel
    for CUDA tensors, ``flash_attention_fwd_lse_ref`` for CPU tensors."""
    b, h, s, d, kvh = _check_train("flash_attention_fwd_lse", q, k, v,
                                   causal, (bk, {KERNEL_BK_LSE}))
    scale = d ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return flash_attention_fwd_lse_ref(q, k, v, causal=causal, bk=bk,
                                           scale=scale)
    q, k, v = _rows(q), _rows(k), _rows(v)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if b and h and s:
        _build.launch("flash_attention_fwd_lse", q.device, q, k, v, out, lse,
                      b, h, kvh, s, d, int(causal), *_strides(q, k, v, out),
                      float(scale))
    return out, lse


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                           bk: int | None = None,
                           scale: float | None = None) -> torch.Tensor:
    """dq (like q, float32) of the training attention, from the saved lse
    and delta = sum(do * out) over D, both (B, H, S) float32; on the card
    do float32 like q. The kernel for CUDA tensors,
    ``flash_attention_bwd_dq_ref`` for CPU tensors."""
    b, h, s, d, kvh = _check_train("flash_attention_bwd_dq", q, k, v,
                                   causal, (bk, {KERNEL_BLOCK}))
    scale = d ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_ref(q, k, v, do, lse, delta,
                                          causal=causal, bk=bk, scale=scale)
    if do.shape != q.shape or do.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd_dq: do {tuple(do.shape)} "
                         f"{do.dtype}, q {tuple(q.shape)}")
    q, k, v, do = _rows(q), _rows(k), _rows(v), _rows(do)
    lse, delta = (x.to(torch.float32).contiguous() for x in (lse, delta))
    dq = torch.empty_like(q)
    if b and h and s:
        _build.launch("flash_attention_bwd_dq", q.device, q, k, v, do, lse,
                      delta, dq, b, h, kvh, s, d, int(causal),
                      *_strides(q, k, v, do, dq), float(scale))
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                            bq: int | None = None,
                            scale: float | None = None):
    """(dk, dv), each like k in float32, of the training attention; q and
    do (any float dtype) are rounded to bf16 first, as the reference does
    before its dK/dV kernel. The kernel for CUDA tensors,
    ``flash_attention_bwd_dkv_ref`` for CPU tensors."""
    b, h, s, d, kvh = _check_train("flash_attention_bwd_dkv", q, k, v,
                                   causal, (bq, {KERNEL_BLOCK}))
    scale = d ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta,
                                           causal=causal, bq=bq, scale=scale)
    if do.shape != q.shape:
        raise ValueError(f"flash_attention_bwd_dkv: do {tuple(do.shape)}, "
                         f"q {tuple(q.shape)}")
    q16, do16 = _rows(q.to(torch.bfloat16)), _rows(do.to(torch.bfloat16))
    k, v = _rows(k), _rows(v)
    lse, delta = (x.to(torch.float32).contiguous() for x in (lse, delta))
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty_like(dk)
    if b and h and s:
        _build.launch("flash_attention_bwd_dkv", q.device, q16, k, v, do16,
                      lse, delta, dk, dv, b, h, kvh, s, d, int(causal),
                      *_strides(q16, k, v, do16, dk, dv), float(scale))
    return dk, dv


class FlashAttentionTrain(torch.autograd.Function):
    """Differentiable flash attention (the reference's custom VJP around
    ``flash_attention_train``): the forward saves (q, k, v, out, lse); the
    backward computes delta = sum(do * out) in fp32 and calls the dq and
    dK/dV wrappers, so on the CPU it runs the plain backward as written,
    not autograd through a plain forward. Gradients come back in the
    operands' dtypes (dk, dv rounded to bf16 for bf16 k, v)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, bq, bk):
        out, lse = flash_attention_fwd_lse(q, k, v, causal=causal, bk=bk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.bq, ctx.bk = causal, bq, bk
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.to(q.dtype)
        delta = (do.to(torch.float32) * out.to(torch.float32)).sum(dim=-1)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                    causal=ctx.causal, bk=ctx.bk)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                         causal=ctx.causal, bq=ctx.bq)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, \
            None


def flash_attention_train(q, k, v, causal: bool = True,
                          bq: int | None = None,
                          bk: int | None = None) -> torch.Tensor:
    """Differentiable self-attention: q (B, H, S, D), k and v (B, KVH, S,
    D) -> out like q. On the CPU ``bq`` and ``bk`` are the plain versions'
    query and key blocks (default ``train_block(S)``); elsewhere the
    kernels' tiles are fixed: bq None or the dK/dV kernel's query tile
    ``KERNEL_BLOCK``, bk None or a key tile of both the forward
    (``KERNEL_BK_LSE``) and the dQ kernel (``KERNEL_BLOCK``)."""
    _check_train("flash_attention_train", q, k, v, causal,
                 (bq, {KERNEL_BLOCK}), (bk, {KERNEL_BK_LSE} & {KERNEL_BLOCK}))
    return FlashAttentionTrain.apply(q, k, v, causal, bq, bk)


def mha_flash_train(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Model layout, differentiable: q (B, S, H, D), k and v (B, S, KVH, D)
    -> (B, S, H * D) float32. k and v are rounded to bf16 (q is not, unlike
    ``mha_flash``: the reference's asymmetry); the kernels read the three
    through (B, H, S, D) views, without copies."""
    b, s, h, d = q.shape
    out = flash_attention_train(q.transpose(1, 2),
                                k.transpose(1, 2).to(torch.bfloat16),
                                v.transpose(1, 2).to(torch.bfloat16),
                                causal)
    return out.transpose(1, 2).reshape(b, s, h * d).to(torch.float32)
