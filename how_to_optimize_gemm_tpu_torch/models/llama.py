"""Llama-2-architecture decoder on the quantized kernels.

Counterpart: ``how_to_optimize_gemm_tpu/models/llama.py``. Pre-RMSNorm,
rotary position embeddings, grouped-query attention, a SwiGLU MLP, sized
by ``LlamaConfig`` (``llama2_7b()`` gives the real proportions). The
parameters are plain nested dicts with the reference's key names, and the
KV cache is the reference's time-major layout, so
``convert.params_from_jax`` is a tree map and both packages can be run on
the same weights. Two caches (``init_kv_cache``):

- bf16: per layer (k_cache, v_cache), each (B, T, KVH, D);
- KV8 (``quantized=True``): per layer (qk, sk, qv, sv): int8 values
  (B, T, KVH, D) and fp32 scales (B, T, KVH), one per (slot, token,
  head), from ``quantize_kv``. The reference pads its scales to
  (B, T, 128) lanes, a Mosaic tiling rule; the port keeps KVH
  (``convert.kv_cache_from_jax`` crops the reference's).

Each has a paged form (``init_paged_kv_cache``): the same entries as page
pools (NP, PS, KVH, D) and scales (NP, PS, KVH), read and written through
a block table (B, np_max) that ``decode_step(table=...)`` takes (one
table for every layer; the engine owns it). Page 0 is the trash page.

Routes, by the device of the activations (the reference's
``use_pallas=None`` routes: kernels on the accelerator, its plain XLA
formulations elsewhere). ``kernel_routes=True`` takes the kernel routes
on the CPU too, through the kernels' plain versions (the reference's
``use_pallas=True`` in interpret mode); the card always takes them.

- linears: ``models/linear.apply_linear`` with ``kernels`` set from the
  route;
- cache writes of at most 8 rows on the kernel routes: kernel
  ``kv_update`` (``ops/kv_update``; KV8 values and scales alike), rows
  out of range dropped one by one, or over a paged cache kernel
  ``paged_kv_update``, trash-page rows skipped; otherwise the
  reference's indexing write, done in place (see ``_update_cache`` and
  ``_update_paged_cache``);
- decode (s == 1) on the kernel routes: kernel ``decode_attention``, or
  ``decode_attention_q8`` over a KV8 cache (``ops/decode_attention``),
  or their paged forms ``paged_decode_attention`` and
  ``paged_decode_attention_q8`` (``ops/paged_attention``), at every
  cache size. The reference's cost rule (``_route_decode``: eager
  below 24 MB of cache per layer) was measured on a v5e and is not
  carried over; off the kernel routes, ``_attention`` or
  ``_attention_kv8`` (over ``gather_paged`` copies of a paged cache);
- causal self-attention over the prompt (``forward``, and the admission
  prefill ``prefill_self`` over every cache kind): on the kernel routes,
  at s >= 512 with d_head 64 or 128, kernel ``flash_attention``
  (``ops/attention.mha_flash``) over the fresh bf16 k and v, as the
  reference runs its Pallas flash kernel there (also for the KV8 and
  paged caches, which it does not read); otherwise ``_attention``.
  Prefix-hit suffixes and chunks after the first (s > 1, not at position
  0) take the eager cached route, as in the reference.

Training (``loss_fn``, ``forward(remat=, flash_train=)``,
``sgd_train_step``; the optimizer loop is ``parallel/training.py``): the
reference's ``use_pallas=False`` routes with autograd through them. The
linears take their emulation (fp32 and bf16 have one route), attention is
``_attention`` under the causal mask unless ``flash_train`` routes causal
self-attention of s >= 512 with d_head 64 or 128 to the differentiable
``ops/attention.mha_flash_train`` (three kernels under a
``torch.autograd.Function``) on every device. The quantized linears'
kernels have no backward, so on the card ``loss_fn`` refuses int8, int4
and w4a8 weights (``NotImplementedError``, ROADMAP A15); on the CPU they
train their float scales through the emulation, as in the reference.
``remat`` wraps each block in ``torch.utils.checkpoint`` (non-reentrant):
its activations are recomputed in the backward pass. The embedding is
looked up with ``torch.nn.functional.embedding``, whose backward on the
card is deterministic (indexing's is an accumulating ``index_put_``).

MoE (``n_experts > 0``, ``mixtral_8x7b()``): a layer's MLP is a top-k
routed mixture of SwiGLU experts (``parallel/moe.py``) whose stacks
follow ``weight_kind`` (int8 W8A16 stacks for int8, nibble-packed int4
stacks for int4 and w4a8, bf16 otherwise, fp32 for fp32), on every cache
kind. ``_mlp`` chooses the route as the reference does: ``moe_ragged``
and at least ``moe_ragged_min_tokens`` routed copies (default 2 x E x
128) take ``moe_ffn_ragged`` (kernel ``grouped_gemm`` on the card: the
admission prefill of long prompts); else the dispatch path
``moe_ffn_local``, dropless (capacity factor at least E / k) when
``moe_dropless`` or ``moe_ragged`` (decode). MoE models train on every
device, as in the reference: ``loss_fn`` adds ``moe_aux_weight`` times the
mean load-balance aux over layers, and the ragged path's grouped products
run their backward kernels on the card. The card's refusal of quantized
weights is about the linears (A15): a quantized expert stack is frozen and
its float scales train through the grouped GEMM's backward.

Not ported yet, raising ``NotImplementedError``: LoRA (A8). Unlike JAX
arrays, the cache tensors are written in place: a step's returned cache
is the same tensors it was given.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from how_to_optimize_gemm_tpu_torch.models.linear import (QUANTIZED_KINDS,
                                                          apply_linear,
                                                          linear_kind,
                                                          make_linear)
from how_to_optimize_gemm_tpu_torch.ops.attention import (mha_flash,
                                                          mha_flash_train)
from how_to_optimize_gemm_tpu_torch.ops.decode_attention import (
    decode_attention, decode_attention_q8)
from how_to_optimize_gemm_tpu_torch.ops.kv_update import (kv_update,
                                                          paged_kv_update)
from how_to_optimize_gemm_tpu_torch.ops.paged_attention import (
    gather_paged, paged_decode_attention, paged_decode_attention_q8)
from how_to_optimize_gemm_tpu_torch.parallel import moe
from how_to_optimize_gemm_tpu_torch.utils.device import (default_device,
                                                         kernel_routes_for)

NEG_INF = -1e30
# the reference's routing constants (models/llama.py:298, :350)
FLASH_MIN_S = 512
FLASH_HEAD_DIMS = (64, 128)
KV_KERNEL_MAX_S = 8


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab: int = 256
    d_model: int = 128
    n_layers: int = 2
    n_heads: int = 4
    n_kv_heads: int = 2
    d_ff: int = 256
    max_seq: int = 128
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    weight_kind: str = "bf16"  # linear: fp32|bf16|int8|int4|w4a8
    # n_experts > 0: a top-k routed MoE MLP of SwiGLU experts (see the
    # module docstring); the fields and defaults are the reference's
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity: float = 2.0
    moe_dropless: bool = True
    moe_aux_weight: float = 0.01
    moe_ragged: bool = False
    moe_ragged_min_tokens: int | None = None

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads


def llama2_7b(weight_kind: str = "int8") -> LlamaConfig:
    """Llama-2-7B proportions (vocab 32000, 32 layers, d_model 4096)."""
    return LlamaConfig(vocab=32000, d_model=4096, n_layers=32, n_heads=32,
                       n_kv_heads=32, d_ff=11008, max_seq=4096,
                       weight_kind=weight_kind)


def mixtral_8x7b(weight_kind: str = "bf16") -> LlamaConfig:
    """Mixtral-8x7B proportions: GQA 32/8, 8 SwiGLU experts of d_ff
    14336, top-2 routing (the reference's preset: rope_theta 1e4 and
    max_seq 4096). Expert stacks follow ``weight_kind``."""
    return LlamaConfig(vocab=32000, d_model=4096, n_layers=32, n_heads=32,
                       n_kv_heads=8, d_ff=14336, max_seq=4096,
                       weight_kind=weight_kind, n_experts=8, moe_top_k=2)


def _init_moe(normal, cfg: LlamaConfig) -> dict:
    """One layer's router and expert stacks, as the reference's
    ``init_moe_params(..., swiglu=True)`` then ``quantize_moe``: each
    stack drawn in fp32, rounded to bf16 (fp32 for fp32 weights), then
    quantized (int8 for int8 weights, packed int4 for int4 and w4a8)
    before the next is drawn, so at most one fp32 stack exists at a time."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dtype = torch.float32 if cfg.weight_kind == "fp32" else torch.bfloat16
    bits = {"int8": 8, "int4": 4, "w4a8": 4}.get(cfg.weight_kind)
    p = {"router": (normal(d, e) * d ** -0.5).to(dtype)}
    for name, shape, scale in (("w_in", (e, d, f), d ** -0.5),
                               ("w_out", (e, f, d), f ** -0.5),
                               ("w_gate", (e, d, f), d ** -0.5)):
        w = (normal(*shape) * scale).to(dtype)
        if bits is None:
            p[name] = w
        else:
            p.update({name + k: v for k, v in
                      moe.quantize_stack(w, bits).items()})
        del w
    return p


# ---------------------------------------------------------------- params

def init_params(generator: torch.Generator, cfg: LlamaConfig,
                device=None) -> dict:
    """Random weights, drawn from ``generator`` (which must live on
    ``device``), linears stored in ``cfg.weight_kind``. Each weight is
    drawn in fp32 and converted before the next is drawn, so no more than
    one dense fp32 matrix (for MoE, one fp32 expert stack) exists at a
    time."""
    device = default_device(device)

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32)

    def dense(d_in, d_out, kind):
        return make_linear(normal(d_in, d_out) * d_in ** -0.5, kind)

    d, h, kvh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    kind = cfg.weight_kind
    layers = []
    for _ in range(cfg.n_layers):
        layer = {
            "attn_norm": torch.ones(d, device=device),
            "wq": dense(d, h * dh, kind),
            "wk": dense(d, kvh * dh, kind),
            "wv": dense(d, kvh * dh, kind),
            "wo": dense(h * dh, d, kind),
            "mlp_norm": torch.ones(d, device=device),
        }
        if cfg.n_experts > 0:
            layer["moe"] = _init_moe(normal, cfg)
        else:
            layer.update(w_gate=dense(d, cfg.d_ff, kind),
                         w_up=dense(d, cfg.d_ff, kind),
                         w_down=dense(cfg.d_ff, d, kind))
        layers.append(layer)
    return {
        "embed": normal(cfg.vocab, d) * 0.02,
        "out_norm": torch.ones(d, device=device),
        # the lm head stays fp32, as the reference keeps it
        "lm_head": dense(d, cfg.vocab, "fp32"),
        "layers": layers,
    }


# --------------------------------------------------------------- modules

def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * g


def _rope_freqs(cfg: LlamaConfig, positions: torch.Tensor):
    """positions (..., seq) ints -> cos, sin (..., seq, d_head / 2)."""
    exps = torch.arange(0, cfg.d_head, 2, dtype=torch.float32,
                        device=positions.device) / cfg.d_head
    inv = 1.0 / torch.pow(torch.full_like(exps, cfg.rope_theta), exps)
    ang = positions[..., None].to(torch.float32) * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x (..., seq, heads, d_head); cos, sin (..., seq, d_head / 2)."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, mask):
    """q (B, S, H, D); k, v (B, T, KVH, D); mask (S, T), (B, S, T) or
    None. GQA folds q's heads into (kv head, rep) groups against the
    unexpanded cache. q is rounded to the cache's dtype; products
    accumulate in fp32, as the reference's ``preferred_element_type``."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    rep = h // kvh
    qg = q.reshape(b, s, kvh, rep, d).to(k.dtype).to(torch.float32)
    logits = torch.einsum("bsgrd,btgd->bgrst", qg, k.to(torch.float32))
    logits = logits * d ** -0.5
    if mask is not None:
        if mask.dim() == 2:
            mask = mask[None]
        logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrst,btgd->bsgrd",
                       probs.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    return out.reshape(b, s, h * d)


def _route_flash(kernels: bool, s: int, dh: int) -> bool:
    """Whether causal self-attention over s tokens takes the flash kernel:
    the reference's predicate (a kernel route, s >= 512, d_head 64 or
    128)."""
    return kernels and s >= FLASH_MIN_S and dh in FLASH_HEAD_DIMS


def _self_attention(q, k, v, kernels: bool, flash_train: bool = False):
    """Causal self-attention over the step's own tokens: with
    ``flash_train``, ``mha_flash_train`` where the flash predicate holds on
    any route (the reference's ``_route_flash(True, ...)``); else
    ``mha_flash`` on bf16 k and v where ``_route_flash`` says so; else
    ``_attention`` under an (S, S) causal mask, which only that branch
    builds."""
    s, dh = q.shape[1], q.shape[3]
    if flash_train and _route_flash(True, s, dh):
        return mha_flash_train(q, k, v, causal=True)
    if _route_flash(kernels, s, dh):
        return mha_flash(q, k.to(torch.bfloat16), v.to(torch.bfloat16),
                         causal=True)
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    return _attention(q, k, v, mask)


def _is_scalar(pos) -> bool:
    return not isinstance(pos, torch.Tensor) or pos.dim() == 0


def _update_cache(cache, new, pos, write_mask=None, kernels=None):
    """cache (B, T, *rest) <- new (B, S, *rest) at position ``pos`` (an
    int or (B,) ints), IN PLACE; returns ``cache``. write_mask (B,) bools:
    slots with False keep their rows (the batched-prefill mechanism).

    Each branch keeps the reference's semantics at the edges:
    - at most 8 rows on the kernel route (``kernels``, by default on the
      card): ``kv_update``; rows outside [0, T) are dropped one by one;
    - a scalar pos, or (B,) positions with S > 1: the reference's
      ``dynamic_update_slice``, whose start wraps once if negative and is
      then clamped to [0, T - S];
    - (B,) positions with S == 1: the reference's scatter; a negative
      position wraps once, and a position still outside [0, T) is
      dropped."""
    new = new.to(cache.dtype)
    b, t = cache.shape[:2]
    s = new.shape[1]
    if kernel_routes_for(cache, kernels) and s <= KV_KERNEL_MAX_S:
        return kv_update(cache, new, pos, write_mask)
    dev = cache.device
    sel = (torch.ones(b, dtype=torch.bool, device=dev) if write_mask is None
           else torch.as_tensor(write_mask, device=dev).to(torch.bool))
    posv = torch.as_tensor(pos, device=dev).to(torch.int64).expand(b)
    posv = torch.where(posv < 0, posv + t, posv)
    if _is_scalar(pos) or s > 1:
        start = posv.clamp(0, t - s)
        rows = sel.nonzero()[:, 0]
        idx = start[rows, None] + torch.arange(s, device=dev)
        cache[rows[:, None], idx] = new[rows]
    else:
        rows = (sel & (posv >= 0) & (posv < t)).nonzero()[:, 0]
        cache[rows, posv[rows]] = new[rows, 0]
    return cache


def _paged_rows(pos, s: int, table: torch.Tensor, ps: int,
                write_mask=None):
    """The physical (pages, offs), each (B, S) int32, of positions
    pos .. pos + S - 1 (pos an int or (B,) ints) through the block table
    (B, np_max): chunk ``p // ps``, offset ``p % ps``. Masked slots
    (write_mask False) and positions outside [0, np_max * ps) go to the
    trash page 0. Every layer of a step writes the same rows, so
    ``decode_step`` computes them once.

    The reference clips the chunk index to [0, np_max - 1] instead, which
    lands bucket padding that passes the table in the slot's last page,
    on top of live rows there (ROADMAP C.4); no live position lies
    outside the table, so the port sends such rows to the trash page."""
    b, np_max = table.shape
    dev = table.device
    posv = torch.as_tensor(pos, device=dev).to(torch.int64).expand(b)
    positions = posv[:, None] + torch.arange(s, device=dev)
    chunk = torch.div(positions, ps, rounding_mode="floor")
    inside = (positions >= 0) & (chunk < np_max)
    pages = torch.gather(table.to(torch.int64), 1, chunk.clamp(0, np_max - 1))
    if write_mask is not None:
        inside &= torch.as_tensor(write_mask, device=dev).to(
            torch.bool).expand(b)[:, None]
    return (pages.masked_fill(~inside, 0).to(torch.int32),
            positions.remainder(ps).to(torch.int32))


def _write_paged(pool, new, pages, offs, kernels=None):
    """pool (NP, PS, *rest) <- new (B, S, *rest) at the (pages, offs) of
    ``_paged_rows``, IN PLACE; returns ``pool``. At most 8 rows on the
    kernel route: ``paged_kv_update``, which skips trash-page rows;
    otherwise the reference's scatter, which writes them to page 0."""
    new = new.to(pool.dtype)
    b, s = new.shape[:2]
    if kernel_routes_for(pool, kernels) and s <= KV_KERNEL_MAX_S:
        return paged_kv_update(pool, new, pages, offs)
    pool[pages.reshape(-1), offs.reshape(-1)] = new.reshape(
        (b * s,) + new.shape[2:])
    return pool


def _update_paged_cache(pool, new, pos, table, write_mask=None,
                        kernels=None):
    """Paged-cache write: pool (NP, PS, *rest) <- new (B, S, *rest) at
    positions pos .. pos + S - 1 through the block table, IN PLACE;
    returns ``pool`` (``_paged_rows``, then ``_write_paged``)."""
    pages, offs = _paged_rows(pos, new.shape[1], table, pool.shape[1],
                              write_mask)
    return _write_paged(pool, new, pages, offs, kernels)


def quantize_kv(x: torch.Tensor):
    """(B, S, G, D) -> int8 values and per-(b, s, g) fp32 scales (B, S, G):
    ``scale = max(amax, 1e-8) / 127`` (IEEE division, as the reference
    divides) and ``clip(round(x / scale), -127, 127)``, rounding half to
    even."""
    amax = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True), 1e-8)
    # divide by a tensor: CUDA divides by a Python scalar as a multiply
    # by its reciprocal (ops/quant.quantize_symmetric)
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0].to(torch.float32)


def _attention_kv8(q, qk, sk, qv, sv, mask):
    """Attention over the KV8 cache: q (B, S, H, D); qk, qv (B, T, KVH, D)
    int8; sk, sv (B, T, KVH); mask as ``_attention``'s. The scales are
    rank-1 in t, so they fold into the scores and the probabilities and
    the cache is never dequantized. The reference's off-TPU arithmetic,
    on every device: fp32 q, values and probabilities."""
    b, s, h, d = q.shape
    kvh = qk.shape[2]
    rep = h // kvh
    qg = q.reshape(b, s, kvh, rep, d).to(torch.float32)
    logits = torch.einsum("bsgrd,btgd->bgrst", qg, qk.to(torch.float32))
    logits = logits * sk.transpose(1, 2)[:, :, None, None, :]
    logits = logits * d ** -0.5
    if mask is not None:
        if mask.dim() == 2:
            mask = mask[None]
        logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    probs = probs * sv.transpose(1, 2)[:, :, None, None, :]
    out = torch.einsum("bgrst,btgd->bsgrd", probs, qv.to(torch.float32))
    return out.reshape(b, s, h * d)


def _lin(layer, name, x, kernels):
    return apply_linear(layer[name], x, kernels)


def _moe_ragged_min_tokens(cfg: LlamaConfig) -> int:
    """Routed copies from which the ragged path runs: the reference's
    cost rule (2 blocks of 128 per expert), or the config's."""
    return (2 * cfg.n_experts * 128 if cfg.moe_ragged_min_tokens is None
            else cfg.moe_ragged_min_tokens)


def _mlp(layer, cfg: LlamaConfig, y, kernels):
    """SwiGLU MLP, dense or routed -> (out, aux): aux is the GShard
    load-balance loss of an MoE layer, 0 for the dense MLP. Routed: the
    ragged path (``moe_ffn_ragged``) with ``moe_ragged`` and at least
    ``_moe_ragged_min_tokens`` routed copies, else the dispatch path
    (``moe_ffn_local``), dropless (cf >= E / k) with ``moe_dropless`` or
    ``moe_ragged``. The reference chooses so on every device."""
    if "moe" in layer:
        b, s, d = y.shape
        flat = y.reshape(b * s, d)
        if (cfg.moe_ragged
                and b * s * cfg.moe_top_k >= _moe_ragged_min_tokens(cfg)):
            out, aux = moe.moe_ffn_ragged(layer["moe"], flat,
                                          k=cfg.moe_top_k, return_aux=True)
        else:
            cf = cfg.moe_capacity
            if cfg.moe_dropless or cfg.moe_ragged:
                cf = max(cf, cfg.n_experts / cfg.moe_top_k)
            out, aux = moe.moe_ffn_local(layer["moe"], flat,
                                         k=cfg.moe_top_k, capacity_factor=cf,
                                         return_aux=True)
        return out.reshape(b, s, d), aux
    gate = _lin(layer, "w_gate", y, kernels)
    up = _lin(layer, "w_up", y, kernels)
    out = _lin(layer, "w_down", torch.nn.functional.silu(gate) * up, kernels)
    return out, torch.zeros((), dtype=torch.float32, device=y.device)


def _block(layer, cfg: LlamaConfig, x, cos, sin, kv=None,
           write_mask=None, prefill_self=False, kernel_routes=None,
           paged_rows=None, flash_train=False, kernels=None):
    """One transformer block. kv None: full-sequence forward (attention by
    ``_self_attention``, ``flash_train`` passed on); kv =
    (k_cache, v_cache, pos) for the cached step over a bf16 cache, or
    (qk, sk, qv, sv, pos) over a KV8 cache, pos an int or (B,) ints; a
    paged cache's entries are its pools followed by the block table:
    (k_pool, v_pool, table, pos) or (qk, sk, qv, sv, table, pos), and
    paged_rows the step's ``_paged_rows``. ``kernels``, when given, is the
    route already decided (``loss_fn`` passes False on every device: the
    reference's ``use_pallas=False``) and ``kernel_routes`` is not read.
    Returns (x, the layer's cache tuple or None, the MoE aux of ``_mlp``)."""
    if kernels is None:
        kernels = kernel_routes_for(x, kernel_routes)
    b, s, _ = x.shape
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    if kv is not None and len(kv) not in (3, 4, 5, 6):
        raise ValueError(f"a cache entry of {len(kv)} items")

    y = rmsnorm(x, layer["attn_norm"], cfg.norm_eps)
    q = _lin(layer, "wq", y, kernels).reshape(b, s, h, dh)
    k = _lin(layer, "wk", y, kernels).reshape(b, s, kvh, dh)
    v = _lin(layer, "wv", y, kernels).reshape(b, s, kvh, dh)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    new_kv = None
    if kv is None:
        attn = _self_attention(q, k, v, kernels, flash_train)
    else:
        *cache, pos = kv
        table = cache.pop() if len(kv) in (4, 6) else None
        kv8 = len(cache) == 4
        if kv8:
            kq, ks = quantize_kv(k)
            vq, vs = quantize_kv(v)
            new_rows = (kq, ks, vq, vs)
        else:
            new_rows = (k, v)
        if table is None:
            cache = tuple(_update_cache(c, n, pos, write_mask, kernels)
                          for c, n in zip(cache, new_rows))
        else:
            pages, offs = paged_rows
            cache = tuple(_write_paged(c, n, pages, offs, kernels)
                          for c, n in zip(cache, new_rows))
        if prefill_self:
            # admission prefill: the slot starts at position 0, so its
            # attention is causal self-attention over the prompt
            attn = _self_attention(q, k, v, kernels)
        elif s == 1 and kernels:
            lengths = torch.as_tensor(pos, device=x.device).to(
                torch.int32).expand(b) + 1
            if table is not None:
                fn = (paged_decode_attention_q8 if kv8
                      else paged_decode_attention)
                attn = fn(q[:, 0], *cache, table, lengths)
            elif kv8:
                attn = decode_attention_q8(q[:, 0], *cache, lengths)
            else:
                attn = decode_attention(q[:, 0], *cache, lengths)
            attn = attn[:, None]
        else:
            # eager cached route; a paged cache is gathered into a
            # slot-contiguous (B, np_max * PS, ...) copy first
            view = (cache if table is None
                    else [gather_paged(c, table) for c in cache])
            t = view[0].shape[1]
            q_pos = (torch.as_tensor(pos, device=x.device)[..., None]
                     + torch.arange(s, device=x.device))
            valid = (torch.arange(t, device=x.device)
                     <= q_pos[..., None])          # (S, T) or (B, S, T)
            attn = (_attention_kv8(q, *view, valid) if kv8
                    else _attention(q, *view, valid))
        new_kv = cache
    x = x + _lin(layer, "wo", attn, kernels)
    y = rmsnorm(x, layer["mlp_norm"], cfg.norm_eps)
    mlp_out, aux = _mlp(layer, cfg, y, kernels)
    return x + mlp_out, new_kv, aux


# -------------------------------------------------------------- forward

def forward(params, cfg: LlamaConfig, tokens: torch.Tensor,
            kernel_routes=None, remat: bool = False,
            flash_train: bool = False, return_moe_aux: bool = False):
    """Full-sequence forward: tokens (B, S) -> logits (B, S, vocab), and
    with ``return_moe_aux`` also the mean over layers of the MoE
    load-balance aux (0 for a dense MLP). kernel_routes: see the module
    docstring (the reference's ``use_pallas``); remat and flash_train: see
    its training section."""
    logits, aux = _forward(params, cfg, tokens,
                           kernel_routes_for(tokens, kernel_routes), remat,
                           flash_train)
    return (logits, aux) if return_moe_aux else logits


def _forward(params, cfg: LlamaConfig, tokens, kernels: bool, remat: bool,
             flash_train: bool):
    """``forward`` on a route already decided (``kernels``) -> (logits,
    mean MoE aux)."""
    _, s = tokens.shape
    x = F.embedding(tokens, params["embed"])
    pos = torch.arange(s, device=tokens.device)
    cos, sin = _rope_freqs(cfg, pos)

    def block(layer, x):
        out, _, aux = _block(layer, cfg, x, cos, sin,
                             flash_train=flash_train, kernels=kernels)
        return out, aux

    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for layer in params["layers"]:
        x, aux = (checkpoint(block, layer, x, use_reentrant=False) if remat
                  else block(layer, x))
        aux_total = aux_total + aux
    x = rmsnorm(x, params["out_norm"], cfg.norm_eps)
    return (apply_linear(params["lm_head"], x, kernels),
            aux_total / max(1, len(params["layers"])))


def init_kv_cache(cfg: LlamaConfig, batch: int, dtype=torch.bfloat16,
                  quantized: bool = False, device=None):
    """Per layer (k_cache, v_cache), each time-major (B, T, KVH, D)
    zeros of ``dtype`` (the card's decode kernel reads bf16). quantized
    (KV8): per layer (qk, sk, qv, sv), int8 (B, T, KVH, D) values and
    fp32 (B, T, KVH) scales, half the bytes of a bf16 cache."""
    device = default_device(device)
    shape = (batch, cfg.max_seq, cfg.n_kv_heads, cfg.d_head)
    if quantized:
        def entry():
            return (torch.zeros(shape, dtype=torch.int8, device=device),
                    torch.zeros(shape[:3], dtype=torch.float32,
                                device=device))
        return [entry() + entry() for _ in range(cfg.n_layers)]
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.n_layers)]


def init_paged_kv_cache(cfg: LlamaConfig, n_pages: int, page: int,
                        dtype=torch.bfloat16, quantized: bool = False,
                        device=None):
    """Page-pool cache: per layer (k_pool, v_pool), each (n_pages, page,
    KVH, D) zeros of ``dtype``; quantized (KV8): per layer (qk, sk, qv,
    sv), int8 (n_pages, page, KVH, D) values and fp32 (n_pages, page, KVH)
    scales. Page 0 is the trash page; the block table lives with the
    engine and is passed to ``decode_step``."""
    device = default_device(device)
    shape = (n_pages, page, cfg.n_kv_heads, cfg.d_head)
    if quantized:
        def entry():
            return (torch.zeros(shape, dtype=torch.int8, device=device),
                    torch.zeros(shape[:3], dtype=torch.float32,
                                device=device))
        return [entry() + entry() for _ in range(cfg.n_layers)]
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.n_layers)]


def decode_step(params, cfg: LlamaConfig, cache, tokens: torch.Tensor, pos,
                write_mask=None, prefill_self: bool = False,
                table=None, lora=None, lora_idx=None, logit_idx=None,
                kernel_routes=None):
    """One cached step: tokens (B, S) at position ``pos`` (an int or (B,)
    ints on the tokens' device) -> (logits, cache), the cache written in
    place (bf16 or KV8 entries, as ``init_kv_cache`` makes them, or their
    page pools from ``init_paged_kv_cache`` with ``table`` the (B, np_max)
    int32 block table on the tokens' device).
    write_mask (B,) bools restricts which slots' caches are
    written; prefill_self: the written slots start at position 0 and
    attend only to the new tokens; logit_idx (B,) ints unembeds only that
    position of each row (logits (B, 1, vocab)). kernel_routes: see the
    module docstring."""
    if lora is not None or lora_idx is not None:
        raise NotImplementedError("LoRA is not ported yet (ROADMAP A8)")
    b, s = tokens.shape
    x = params["embed"][tokens]
    offsets = torch.arange(s, device=tokens.device)
    positions = (pos + offsets if _is_scalar(pos)
                 else pos[..., None] + offsets)
    cos, sin = _rope_freqs(cfg, torch.as_tensor(positions))
    rows = (None if table is None else
            _paged_rows(pos, s, table, cache[0][0].shape[1], write_mask))
    new_cache = []
    for layer, entry in zip(params["layers"], cache):
        kv = (*entry, pos) if table is None else (*entry, table, pos)
        x, kv, _ = _block(layer, cfg, x, cos, sin, kv=kv,
                       write_mask=write_mask, prefill_self=prefill_self,
                       kernel_routes=kernel_routes, paged_rows=rows)
        new_cache.append(kv)
    if logit_idx is not None:
        x = x[torch.arange(b, device=x.device), logit_idx][:, None]
    x = rmsnorm(x, params["out_norm"], cfg.norm_eps)
    return apply_linear(params["lm_head"], x), new_cache


# ------------------------------------------------------------- training


def token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token negative log-likelihood: logits (B, S, V) against
    targets (B, S), in fp32."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.gather(logp, -1, targets[..., None].to(torch.int64)).mean()


def _linear_kinds(params) -> set:
    """The kinds of the tree's linears (an MoE layer's "moe" dict of router
    and expert stacks is not a linear)."""
    kinds = {linear_kind(params["lm_head"])}
    for layer in params["layers"]:
        kinds.update(linear_kind(v) for k, v in layer.items()
                     if isinstance(v, dict) and k != "moe")
    return kinds


def loss_fn(params, cfg: LlamaConfig, tokens: torch.Tensor,
            remat: bool = False, flash_train: bool = False) -> torch.Tensor:
    """Next-token cross entropy over (B, S) token batches: the forward on
    ``tokens[:, :-1]`` against ``tokens[:, 1:]``, on the reference's
    ``use_pallas=False`` routes (see the module docstring); an MoE model
    adds ``moe_aux_weight`` times the mean load-balance aux, as the
    reference does. Raises NotImplementedError for quantized linears on
    the card (ROADMAP A15)."""
    quantized = _linear_kinds(params) & set(QUANTIZED_KINDS)
    if tokens.is_cuda and quantized:
        raise NotImplementedError(
            f"training {sorted(quantized)} weights on the card is not ported "
            "yet: their kernels have no backward (ROADMAP A15)")
    logits, aux = _forward(params, cfg, tokens[:, :-1], False, remat,
                           flash_train)
    loss = token_nll(logits, tokens[:, 1:])
    if cfg.n_experts > 0:
        loss = loss + cfg.moe_aux_weight * aux
    return loss


def sgd_train_step(params, cfg: LlamaConfig, tokens: torch.Tensor,
                   lr: float = 1e-2):
    """One SGD step (the reference's dry-run trainer): the float leaves
    (``parallel/training.split_trainable``) take p - lr * g in their own
    dtype; integer leaves are frozen. Returns (new params, loss); the
    given tree is not changed."""
    from how_to_optimize_gemm_tpu_torch.parallel.training import (
        sgd_update, split_trainable)

    floats, rebuild = split_trainable(params)
    floats = [f.detach().requires_grad_() for f in floats]
    loss = loss_fn(rebuild(floats), cfg, tokens)
    grads = torch.autograd.grad(loss, floats)
    with torch.no_grad():
        new = sgd_update(floats, grads, lr)
    return rebuild(new), loss.detach()
