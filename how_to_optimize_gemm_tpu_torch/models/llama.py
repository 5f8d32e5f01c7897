"""Llama-2-architecture decoder on the quantized kernels.

Counterpart: ``how_to_optimize_gemm_tpu/models/llama.py``. Pre-RMSNorm,
rotary position embeddings, grouped-query attention, a SwiGLU MLP, sized
by ``LlamaConfig`` (``llama2_7b()`` gives the real proportions). The
parameters are plain nested dicts with the reference's key names, and the
KV cache is the reference's time-major (B, T, KVH, D) bf16 layout, so
``convert.params_from_jax`` is a tree map and both packages can be run on
the same weights.

Routes, by the device of the activations (the reference's
``use_pallas=None`` routes: kernels on the accelerator, its plain XLA
formulations elsewhere). ``kernel_routes=True`` takes the kernel routes
on the CPU too, through the kernels' plain versions (the reference's
``use_pallas=True`` in interpret mode); the card always takes them.

- linears: ``models/linear.apply_linear``;
- cache writes of at most 8 rows on the card: kernel ``kv_update``
  (``ops/kv_update``), rows out of range dropped one by one; otherwise the
  reference's indexing write, done in place (see ``_update_cache``);
- decode (s == 1) on the card: kernel ``decode_attention``
  (``ops/decode_attention``) at every cache size. The reference's cost
  rule (``_route_decode``: eager below 24 MB of cache per layer) was
  measured on a v5e and is not carried over;
- admission prefill: causal self-attention over the prompt
  (``_attention``). Prompts of 512 tokens or more with d_head 64 or 128,
  where the reference runs its Pallas flash kernel, raise
  ``NotImplementedError`` on the card (ROADMAP B18).

Not ported yet, each raising ``NotImplementedError``: MoE layers
(``n_experts > 0``, ROADMAP A11/B20), the KV8 cache (B16), paged caches
(B14-paged, B17) and LoRA (A8). Unlike JAX arrays, the cache tensors are
written in place: a step's returned cache is the same tensors it was
given.
"""
from __future__ import annotations

import dataclasses

import torch

from how_to_optimize_gemm_tpu_torch.models.linear import (apply_linear,
                                                          make_linear)
from how_to_optimize_gemm_tpu_torch.ops.decode_attention import (
    decode_attention)
from how_to_optimize_gemm_tpu_torch.ops.kv_update import kv_update
from how_to_optimize_gemm_tpu_torch.utils.device import default_device

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
    # the reference's MoE fields; n_experts > 0 is not ported yet
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


def _require_dense(cfg: LlamaConfig) -> None:
    if cfg.n_experts > 0:
        raise NotImplementedError("MoE layers (n_experts > 0) are not "
                                  "ported yet (ROADMAP A11, B20)")


# ---------------------------------------------------------------- params

def init_params(generator: torch.Generator, cfg: LlamaConfig,
                device=None) -> dict:
    """Random weights, drawn from ``generator`` (which must live on
    ``device``), linears stored in ``cfg.weight_kind``. Each weight is
    drawn in fp32 and converted before the next is drawn, so no more than
    one dense fp32 matrix exists at a time."""
    _require_dense(cfg)
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
        layers.append({
            "attn_norm": torch.ones(d, device=device),
            "wq": dense(d, h * dh, kind),
            "wk": dense(d, kvh * dh, kind),
            "wv": dense(d, kvh * dh, kind),
            "wo": dense(h * dh, d, kind),
            "mlp_norm": torch.ones(d, device=device),
            "w_gate": dense(d, cfg.d_ff, kind),
            "w_up": dense(d, cfg.d_ff, kind),
            "w_down": dense(cfg.d_ff, d, kind),
        })
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


def _route_flash(x: torch.Tensor, s: int, dh: int) -> None:
    """Raise where the reference would run its Pallas flash kernel."""
    if x.is_cuda and s >= FLASH_MIN_S and dh in FLASH_HEAD_DIMS:
        raise NotImplementedError(
            f"prefill attention at s={s} >= {FLASH_MIN_S}: the reference "
            "runs the Pallas flash kernel here, not ported yet (ROADMAP B18)")


def kernel_routes_for(x: torch.Tensor, kernel_routes=None) -> bool:
    """Whether the cache write and decode attention take their kernel
    routes: always on the card, on the CPU only when asked."""
    if x.is_cuda:
        if kernel_routes is False:
            raise ValueError("on the card the model runs the kernel routes")
        return True
    return bool(kernel_routes)


def _is_scalar(pos) -> bool:
    return not isinstance(pos, torch.Tensor) or pos.dim() == 0


def _update_cache(cache, new, pos, write_mask=None, kernels=None):
    """cache (B, T, KVH, D) <- new (B, S, KVH, D) at position ``pos`` (an
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


def _lin(layer, name, x):
    return apply_linear(layer[name], x)


def _mlp(layer, y):
    gate = _lin(layer, "w_gate", y)
    up = _lin(layer, "w_up", y)
    return _lin(layer, "w_down", torch.nn.functional.silu(gate) * up)


def _block(layer, cfg: LlamaConfig, x, cos, sin, kv=None, mask=None,
           write_mask=None, prefill_self=False, kernel_routes=None):
    """One transformer block. kv None: full-sequence forward; kv =
    (k_cache, v_cache, pos) for the cached step, pos an int or (B,) ints.
    Returns (x, (k_cache, v_cache) or None)."""
    kernels = kernel_routes_for(x, kernel_routes)
    b, s, _ = x.shape
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    if kv is not None and len(kv) != 3:
        raise NotImplementedError("paged and KV8 caches are not ported yet "
                                  "(ROADMAP B14-paged, B16, B17)")

    y = rmsnorm(x, layer["attn_norm"], cfg.norm_eps)
    q = _lin(layer, "wq", y).reshape(b, s, h, dh)
    k = _lin(layer, "wk", y).reshape(b, s, kvh, dh)
    v = _lin(layer, "wv", y).reshape(b, s, kvh, dh)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    new_kv = None
    if kv is None:
        _route_flash(x, s, dh)
        attn = _attention(q, k, v, mask)
    else:
        k_cache, v_cache, pos = kv
        k_cache = _update_cache(k_cache, k, pos, write_mask, kernels)
        v_cache = _update_cache(v_cache, v, pos, write_mask, kernels)
        t = k_cache.shape[1]
        if prefill_self:
            # admission prefill: the slot starts at position 0, so its
            # attention is causal self-attention over the prompt
            _route_flash(x, s, dh)
            causal = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                           device=x.device))
            attn = _attention(q, k, v, causal)
        elif s == 1 and kernels:
            lengths = torch.as_tensor(pos, device=x.device).to(
                torch.int32).expand(b) + 1
            attn = decode_attention(q[:, 0], k_cache, v_cache,
                                    lengths)[:, None]
        else:
            q_pos = (torch.as_tensor(pos, device=x.device)[..., None]
                     + torch.arange(s, device=x.device))
            valid = (torch.arange(t, device=x.device)
                     <= q_pos[..., None])          # (S, T) or (B, S, T)
            attn = _attention(q, k_cache, v_cache, valid)
        new_kv = (k_cache, v_cache)
    x = x + _lin(layer, "wo", attn)
    y = rmsnorm(x, layer["mlp_norm"], cfg.norm_eps)
    return x + _mlp(layer, y), new_kv


# -------------------------------------------------------------- forward

def forward(params, cfg: LlamaConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward: tokens (B, S) -> logits (B, S, vocab)."""
    _require_dense(cfg)
    _, s = tokens.shape
    x = params["embed"][tokens]
    pos = torch.arange(s, device=tokens.device)
    cos, sin = _rope_freqs(cfg, pos)
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                 device=tokens.device))
    for layer in params["layers"]:
        x, _ = _block(layer, cfg, x, cos, sin, mask=mask)
    x = rmsnorm(x, params["out_norm"], cfg.norm_eps)
    return apply_linear(params["lm_head"], x)


def init_kv_cache(cfg: LlamaConfig, batch: int, dtype=torch.bfloat16,
                  quantized: bool = False, device=None):
    """Per layer (k_cache, v_cache), each time-major (B, T, KVH, D)
    zeros. The card's decode kernel reads bf16."""
    if quantized:
        raise NotImplementedError("the KV8 cache is not ported yet "
                                  "(ROADMAP B16)")
    device = default_device(device)
    shape = (batch, cfg.max_seq, cfg.n_kv_heads, cfg.d_head)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.n_layers)]


def decode_step(params, cfg: LlamaConfig, cache, tokens: torch.Tensor, pos,
                write_mask=None, prefill_self: bool = False,
                table=None, lora=None, lora_idx=None, logit_idx=None,
                kernel_routes=None):
    """One cached step: tokens (B, S) at position ``pos`` (an int or (B,)
    ints on the tokens' device) -> (logits, cache), the cache written in
    place. write_mask (B,) bools restricts which slots' caches are
    written; prefill_self: the written slots start at position 0 and
    attend only to the new tokens; logit_idx (B,) ints unembeds only that
    position of each row (logits (B, 1, vocab)). kernel_routes: see the
    module docstring."""
    _require_dense(cfg)
    if table is not None:
        raise NotImplementedError("paged caches are not ported yet "
                                  "(ROADMAP B14-paged, B17)")
    if lora is not None or lora_idx is not None:
        raise NotImplementedError("LoRA is not ported yet (ROADMAP A8)")
    b, s = tokens.shape
    x = params["embed"][tokens]
    offsets = torch.arange(s, device=tokens.device)
    positions = (pos + offsets if _is_scalar(pos)
                 else pos[..., None] + offsets)
    cos, sin = _rope_freqs(cfg, torch.as_tensor(positions))
    new_cache = []
    for layer, entry in zip(params["layers"], cache):
        x, kv = _block(layer, cfg, x, cos, sin, kv=(*entry, pos),
                       write_mask=write_mask, prefill_self=prefill_self,
                       kernel_routes=kernel_routes)
        new_cache.append(kv)
    if logit_idx is not None:
        x = x[torch.arange(b, device=x.device), logit_idx][:, None]
    x = rmsnorm(x, params["out_norm"], cfg.norm_eps)
    return apply_linear(params["lm_head"], x), new_cache
