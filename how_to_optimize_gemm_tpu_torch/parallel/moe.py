"""Top-k routed mixture of experts on one device: dispatch, ragged, dense.

Counterpart: ``how_to_optimize_gemm_tpu/parallel/moe.py``
(``init_moe_params``, ``_route``, ``_n_experts``, ``quantize_moe``,
``dequantize_moe``, ``_experts``, ``moe_ffn_local``, ``moe_ffn_dense``,
``_ragged_layout``, ``moe_ffn_ragged``). The parameters are the
reference's dict: ``router`` (d, E) fp32 and the expert stacks ``w_in``,
``w_gate`` (E, d, f) and ``w_out`` (E, f, d), dense, or int8 (``_q``) or
nibble-packed int4 (``_q4``: ``quant.pack_int4`` with block_k = the
contraction) with per-(expert, column) fp32 scales (``_s``, (E, 1, n)).

- ``moe_ffn_local``: the dispatch path. Tokens route in chunks with a
  per-chunk capacity (GShard's fixed-capacity queueing, first choices
  first; tokens past capacity drop), the dispatch and combine are
  products with one-hot tensors, and each expert's FFN is a batched
  product over its capacity slots (``_experts``);
- ``moe_ffn_ragged``: dropless, without the dispatch path's padding to
  capacity: tokens are sorted by expert into ``bt``-aligned segments
  (``_ragged_layout``) and each segment multiplies its expert's stack
  through ``ops/grouped_gemm.grouped_matmul`` (kernel ``grouped_gemm`` on
  the card, the stack read at its stored width);
- ``moe_ffn_dense``: the per-token oracle (every expert on every token).

Every fp32 product here runs with TF32 off (``vendor.fp32_matmul``): the
router's (a TF32 router moves top-k choices), the dispatch path's expert
products, which the reference computes outside any Pallas kernel, and the
one-hot dispatch and combine. On the dispatch path a quantized stack is
converted to the activations' dtype whole before its product, as the
reference does (at Mixtral width, 1.88 GB of fp32 a stack).

Every path trains, as the reference's: autograd runs through the router,
the gather of the routed copies, the expert products, SwiGLU, the
gate-weighted combine and the aux. On the ragged path the expert products
are ``grouped_matmul``'s autograd functions (on the card its backward
kernels): dense stacks get dx and dW, int8 and packed int4 stacks train
QLoRA-style (the stack frozen, x and the scales get gradients). The
dispatch path's products are ``fp32_matmul``'s autograd, a quantized
stack's gradient stopping at its integer values. Not ported: the
expert-parallel ``moe_ffn``, which needs a mesh (ROADMAP A12).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from how_to_optimize_gemm_tpu_torch.ops import quant
from how_to_optimize_gemm_tpu_torch.ops.grouped_gemm import grouped_matmul
from how_to_optimize_gemm_tpu_torch.ops.vendor import fp32_matmul
from how_to_optimize_gemm_tpu_torch.utils.device import default_device

STACKS = ("w_in", "w_out", "w_gate")
MESH_TODO = ("expert-parallel MoE over a mesh (moe_ffn) is not ported yet "
             "(ROADMAP A12)")


def init_moe_params(generator: torch.Generator, d_model: int, d_ff: int,
                    n_experts: int, dtype=torch.float32,
                    swiglu: bool = False, device=None) -> dict:
    """Router and stacked expert FFN weights, drawn from ``generator``
    (on ``device``): ``router`` (d, E) in fp32 scaled by d^-0.5, ``w_in``
    (E, d, f) and, with ``swiglu``, ``w_gate`` likewise, ``w_out``
    (E, f, d) scaled by f^-0.5; stacks in ``dtype``. Each stack is drawn
    in fp32 and converted before the next is drawn."""
    device = default_device(device)

    def normal(shape, scale, dt):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * scale).to(dt)

    s_in, s_out = d_model ** -0.5, d_ff ** -0.5
    e = n_experts
    params = {"router": normal((d_model, e), s_in, dtype),
              "w_in": normal((e, d_model, d_ff), s_in, dtype),
              "w_out": normal((e, d_ff, d_model), s_out, dtype)}
    if swiglu:
        params["w_gate"] = normal((e, d_model, d_ff), s_in, dtype)
    return params


def _n_experts(params) -> int:
    for key in ("w_in", "w_in_q", "w_in_q4"):
        if key in params:
            return params[key].shape[0]
    raise KeyError(list(params))


def _gated(params) -> bool:
    return any(k in params for k in ("w_gate", "w_gate_q", "w_gate_q4"))


def quantize_stack(w: torch.Tensor, bits: int) -> dict:
    """One (E, K, N) stack -> {"_q" or "_q4": values, "_s": (E, 1, N)
    fp32 scales}: symmetric per-(expert, column) scales; bits=4 packs the
    values with block_k = K."""
    q, s = quant.quantize_symmetric(w, axis=1, bits=bits)
    if bits == 8:
        return {"_q": q, "_s": s.to(torch.float32)}
    return {"_q4": quant.pack_int4(q, q.shape[1]), "_s": s.to(torch.float32)}


def quantize_moe(params: dict, bits: int = 8) -> dict:
    """Quantized expert stacks (``quantize_stack``); the router stays fp32.
    A stack already quantized passes through when it has this width and
    raises ValueError otherwise (``dequantize_moe`` first)."""
    if bits not in (4, 8):
        raise ValueError(f"bits={bits}: 4 or 8")
    out = {"router": params["router"]}
    for name in STACKS:
        if name in params:
            out.update({name + k: v for k, v in
                        quantize_stack(params[name], bits).items()})
            continue
        have = (8 if name + "_q" in params
                else 4 if name + "_q4" in params else None)
        if have is not None and have != bits:
            raise ValueError(
                f"{name}: stacks already quantized at {have}-bit; "
                f"dequantize_moe() first to re-encode at {bits}-bit"
                " (silent pass-through would keep the old width)")
        for suffix in ("_q", "_q4", "_s"):
            if name + suffix in params:
                out[name + suffix] = params[name + suffix]
    return out


def _stack_values(params, name: str) -> torch.Tensor:
    """A quantized stack's integer values (E, K, N) int8, packed nibbles
    unpacked."""
    if name + "_q4" in params:
        packed = params[name + "_q4"]
        return quant.unpack_int4(packed, packed.shape[1] * 2)
    return params[name + "_q"]


def _stack_as(params, name: str, dtype) -> torch.Tensor:
    """A quantized stack's integer values converted to ``dtype`` whole; a
    function of its own so that a caller may reuse the conversion of a
    stack that does not change (``chip_smoke.cached_weights``)."""
    return _stack_values(params, name).to(dtype)


def dequantize_moe(params: dict) -> dict:
    """Inverse of ``quantize_moe`` (up to quantization error), fp32."""
    out = {"router": params["router"]}
    for name in STACKS:
        if name in params:
            out[name] = params[name]
        elif name + "_q" in params or name + "_q4" in params:
            out[name] = (_stack_values(params, name).to(torch.float32)
                         * params[name + "_s"])
    return out


def _route(logits: torch.Tensor, k: int, capacity: int, valid=None):
    """Top-k routing with fixed-capacity queueing: logits (T, E) ->
    dispatch (T, E, C) one-hot, combine (T, E, C) gate-weighted, and the
    GShard load-balance aux (E x mean_e fraction_e x prob_e; 1.0 at
    perfect balance). Choices queue first-choices-first; a choice past its
    expert's capacity drops. ``valid`` (T,) bools masks padding tokens:
    they take no capacity and do not count in the aux."""
    t, e = logits.shape
    dev = logits.device
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    gate_vals, choice = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    # flatten (k, T): every first choice precedes every second one
    flat_choice = choice.t().reshape(-1)
    onehot = F.one_hot(flat_choice, e).to(torch.int32)
    if valid is not None:
        onehot = onehot * valid.repeat(k).to(torch.int32)[:, None]
    pos = torch.cumsum(onehot, dim=0) - 1
    pos = torch.where(onehot > 0, pos, torch.full_like(pos, -1))
    pos = pos.amax(dim=-1)
    kept = (pos >= 0) & (pos < capacity)
    tok = torch.arange(t, device=dev).repeat(k)
    slot = pos.clamp(0, capacity - 1)
    disp = torch.zeros((t, e, capacity), dtype=torch.float32, device=dev)
    disp.index_put_((tok, flat_choice, slot), kept.to(torch.float32),
                    accumulate=True)
    gates_flat = gate_vals.t().reshape(-1)
    comb = torch.zeros_like(disp)
    comb.index_put_((tok, flat_choice, slot),
                    torch.where(kept, gates_flat, torch.zeros_like(gates_flat)),
                    accumulate=True)
    w = (valid.to(torch.float32) if valid is not None
         else torch.ones(t, dtype=torch.float32, device=dev))
    nv = torch.clamp_min(w.sum(), 1.0)
    first = F.one_hot(choice[:, 0], e).to(torch.float32)
    frac = (first * w[:, None]).sum(0) / nv
    mean_p = (probs * w[:, None]).sum(0) / nv
    aux = e * torch.sum(frac * mean_p)
    return disp, comb, aux


def _experts(params, x: torch.Tensor, ctype) -> torch.Tensor:
    """Batched per-expert FFN: x (E, S, d) -> (E, S, d), SwiGLU when the
    params carry a gate stack, else a relu MLP. A quantized stack is
    converted to ``ctype`` whole, then scaled after the product."""
    def mm(name, inp):
        if name in params:
            return fp32_matmul(inp, params[name].to(ctype))
        w = _stack_as(params, name, ctype)
        return fp32_matmul(inp, w) * params[name + "_s"].to(ctype)

    if _gated(params):
        h = F.silu(mm("w_gate", x)) * mm("w_in", x)
    else:
        h = torch.relu(mm("w_in", x))
    return mm("w_out", h)


def _router_logits(params, x: torch.Tensor) -> torch.Tensor:
    return fp32_matmul(x.to(torch.float32),
                       params["router"].to(torch.float32))


def moe_ffn(params, x, mesh=None, **kwargs):
    """Expert-parallel routed FFN over a mesh: not ported (ROADMAP A12)."""
    raise NotImplementedError(MESH_TODO)


def _moe_local(params, x, **kwargs):
    """``moe_ffn``'s per-device body: not ported (ROADMAP A12)."""
    raise NotImplementedError(MESH_TODO)


def moe_ffn_local(params, x: torch.Tensor, k: int = 2,
                  capacity_factor: float = 2.0, chunk: int = 256,
                  return_aux: bool = False):
    """Single-device routed MoE, the dispatch path: x (T, d) -> (T, d).

    Tokens route in chunks of ``chunk`` with capacity
    C = ceil(k * chunk * capacity_factor / E) a chunk, so the one-hot
    tensors are (n_chunks, chunk, E, C), linear in T; with
    ``capacity_factor >= E / k`` nothing drops and a token's output does
    not depend on its co-batch."""
    t, d = x.shape
    e = _n_experts(params)
    c = min(chunk, t)
    n = -(-t // c)
    pad = n * c - t
    capacity = max(1, int(-(-k * c * capacity_factor // e)))
    ctype = x.dtype
    dev = x.device
    xc = F.pad(x, (0, 0, 0, pad)).reshape(n, c, d)
    valid = (torch.arange(n * c, device=dev) < t).reshape(n, c)
    logits = _router_logits(params, xc)
    routed = [_route(logits[i], k, capacity, valid=valid[i])
              for i in range(n)]
    disp = torch.stack([r[0] for r in routed])           # (n, c, E, C)
    comb = torch.stack([r[1] for r in routed])
    aux = torch.stack([r[2] for r in routed])
    # buf[n, e, slot] = the token routed there (one-hot: exact)
    buf = fp32_matmul(disp.to(ctype).reshape(n, c, e * capacity)
                      .transpose(1, 2), xc)                # (n, E*C, d)
    buf = buf.reshape(n, e, capacity, d).transpose(0, 1)
    out = _experts(params, buf.reshape(e, n * capacity, d), ctype)
    out = out.reshape(e, n, capacity, d).transpose(0, 1)
    y = fp32_matmul(comb.reshape(n, c, e * capacity),
                    out.to(torch.float32).reshape(n, e * capacity, d))
    y = y.reshape(n * c, d)[:t].to(ctype)
    nv = valid.sum(1).to(torch.float32)
    aux = torch.sum(aux * nv) / torch.clamp_min(nv.sum(), 1.0)
    return (y, aux) if return_aux else y


def _top_k_gates(params, x, k: int):
    """Router probabilities (T, E), the renormalized gates (T, k) and the
    choices (T, k) of every token."""
    probs = torch.softmax(_router_logits(params, x), dim=-1)
    gate_vals, choice = torch.topk(probs, k, dim=-1)
    return probs, gate_vals / gate_vals.sum(-1, keepdim=True), choice


def moe_ffn_dense(params, x: torch.Tensor, k: int = 2) -> torch.Tensor:
    """Per-token dense oracle (no capacity): every expert computes every
    token and the top-k gates combine the chosen ones."""
    _, gate_vals, choice = _top_k_gates(params, x, k)
    e = _n_experts(params)
    x32 = x.to(torch.float32)
    outs = _experts(params, x32.expand(e, *x32.shape), torch.float32)
    y = torch.zeros_like(x32)
    idx = torch.arange(x.shape[0], device=x.device)
    for j in range(k):
        y = y + gate_vals[:, j:j + 1] * outs[choice[:, j], idx]
    return y.to(x.dtype)


def _ragged_layout(flat_exp: torch.Tensor, t: int, e: int, k: int,
                   bt: int):
    """Expert-sorted, bt-aligned destination layout for ``grouped_matmul``.

    flat_exp (k*T,) expert ids in first-choices-first order. Returns
    (stok, order, dest, block_expert, tp): the sorted token ids, the sort
    permutation, each routed copy's destination row, the (tp // bt,)
    int32 block -> expert map and the padded row count
    ceil(kT / bt) * bt + E * bt, an upper bound. Every expert owns at
    least one block (a zero-token expert one block of zero rows)."""
    kt = flat_exp.shape[0]
    dev = flat_exp.device
    flat_exp = flat_exp.to(torch.int64)
    order = torch.argsort(flat_exp, stable=True)
    sexp = flat_exp[order]
    counts = torch.bincount(flat_exp, minlength=e)
    padded = torch.clamp_min((counts + bt - 1) // bt * bt, bt)
    cum_pad = torch.cumsum(padded, 0)
    offs = cum_pad - padded
    seg_start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(kt, device=dev) - seg_start[sexp]
    dest = offs[sexp] + pos
    tp = -(-kt // bt) * bt + e * bt
    block_expert = torch.searchsorted(
        cum_pad, torch.arange(tp // bt, device=dev) * bt, right=True)
    block_expert = block_expert.clamp(0, e - 1).to(torch.int32)
    tok = torch.arange(t, device=dev).repeat(k)
    return tok[order], order, dest, block_expert, tp


def moe_ffn_ragged(params, x: torch.Tensor, k: int = 2,
                   bt: int | None = None, return_aux: bool = False):
    """Dropless routed MoE without overcompute: x (T, d) -> (T, d). Tokens
    are sorted by expert into bt-aligned segments and each segment
    multiplies its expert's stack through ``grouped_matmul`` (three calls
    a SwiGLU layer: w_gate, w_in, w_out), dense, int8 or packed int4,
    scales in the epilogue. ``bt`` defaults to 128, the reference's
    default with an empty autotune bank."""
    t, d = x.shape
    e = _n_experts(params)
    ctype = x.dtype
    bt = bt or 128
    probs, gate_vals, choice = _top_k_gates(params, x, k)
    flat_exp = choice.t().reshape(-1)
    stok, order, dest, block_expert, tp = _ragged_layout(flat_exp, t, e, k,
                                                         bt)
    xs = torch.zeros((tp, d), dtype=ctype, device=x.device)
    xs[dest] = x[stok]

    def gm(name, inp):
        if name in params:
            return grouped_matmul(inp, params[name], block_expert, bt=bt)
        if name + "_q4" in params:
            return grouped_matmul(inp, params[name + "_q4"], block_expert,
                                  params[name + "_s"], bt=bt, packed4=True)
        return grouped_matmul(inp, params[name + "_q"], block_expert,
                              params[name + "_s"], bt=bt)

    if _gated(params):
        h = F.silu(gm("w_gate", xs)) * gm("w_in", xs)
    else:
        h = torch.relu(gm("w_in", xs))
    ys = gm("w_out", h)
    sgate = gate_vals.t().reshape(-1)[order]
    out = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    out.index_add_(0, stok, ys[dest].to(torch.float32) * sgate[:, None])
    out = out.to(ctype)
    if not return_aux:
        return out
    frac = F.one_hot(choice[:, 0], e).to(torch.float32).mean(0)
    aux = e * torch.sum(frac * probs.mean(0))
    return out, aux
