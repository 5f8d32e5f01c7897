"""Port parity: training through the MoE layer, the grouped GEMM's backward
(dense, int8 and packed int4 stacks), the ragged and dispatch paths'
gradients, and MoE models under ``llama.loss_fn``, ``sgd_train_step`` and
``training.train``, against the JAX package's, on the CPU.

The JAX side runs as its own tests run it: ``grouped_matmul``'s custom
VJPs with the Pallas kernels in interpret mode (``bt=8``), the model on
its ``use_pallas=False`` routes. Weights come from the JAX side through
``convert.params_from_jax`` or from numpy, inputs from numpy (seeded): the
same bytes on both sides. The port's autograd functions take their plain
versions for CPU tensors.

Tolerances (as in ``test_torch_training.py``):
- each gradient (dx, dW, ds, a leaf's) within GRAD_REL of its own max
  |gradient| (fp32 sums in another order); a gradient rounded to bf16 (a
  bf16 stack's dW, a bf16 leaf's) within BF16_GRAD_REL, a few bf16 ulps;
- the loss within LOSS_RTOL relative; integer stacks EQUAL, byte for byte;
- the plain versions within PLAIN_REL of max |float64 product| (fp32 sums);
- ragged against dispatch: the reference's own bounds (atol 1e-5 for
  dense stacks, 1e-4 for quantized ones).

Routing near-ties: a gradient through the router compares like with like
only where both sides pick the same experts. Every test whose data goes
through a router first asserts that JAX's gap between the k-th and
(k+1)-th router probability exceeds ROUTE_GAP at every token
(``_assert_no_near_ties``); data that fails it fails the test.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from how_to_optimize_gemm_tpu.models import llama as jllama
from how_to_optimize_gemm_tpu.ops import pallas_grouped_gemm as jgg
from how_to_optimize_gemm_tpu.ops import quant as jquant
from how_to_optimize_gemm_tpu.parallel import moe as jmoe
from how_to_optimize_gemm_tpu.parallel import training as jtraining
from how_to_optimize_gemm_tpu_torch import convert
from how_to_optimize_gemm_tpu_torch.models import llama
from how_to_optimize_gemm_tpu_torch.ops import grouped_gemm as gg
from how_to_optimize_gemm_tpu_torch.ops import vendor
from how_to_optimize_gemm_tpu_torch.parallel import moe, moe_bench, training

torch.set_num_threads(1)

GRAD_REL = 1e-3
BF16_GRAD_REL = 2e-2
LOSS_RTOL = 1e-5
PLAIN_REL = 1e-5
ROUTE_GAP = 1e-4
BT = 8
# (E, d, f) of the grouped GEMM tests: f not a multiple of 128, d even for
# the packed stacks; tokens routed top-2, expert 1 given none
E, D, F = 4, 16, 200
T, K = 20, 2
EMPTY = 1


def _torch(a):
    if a is None:
        return None
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _rel(got, ref) -> float:
    ref = np.asarray(ref, np.float32)
    got = got.detach().to(torch.float32).numpy()
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _layout(seed: int = 0):
    """(xs, block_expert) of T tokens routed top-K over E experts with
    expert EMPTY masked out, laid out by the port's ``_ragged_layout``:
    expert EMPTY owns one zero block."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((T, E))
    logits[:, EMPTY] = -np.inf
    choice = np.argsort(-logits, axis=1)[:, :K]
    flat = torch.from_numpy(choice.T.reshape(-1).copy())
    stok, _, dest, be, tp = moe._ragged_layout(flat, T, E, K, BT)
    x = rng.standard_normal((T, D)).astype(np.float32)
    xs = np.zeros((tp, D), np.float32)
    xs[dest.numpy()] = x[stok.numpy()]
    assert int((be == EMPTY).sum()) == 1
    return xs, be.numpy().astype(np.int32)


def _stack(kind: str, dout: int, f: int, seed: int):
    """(w, scales, packed4) as numpy arrays: an (E, dout, f) stack of
    ``kind``, int4 packed with block_k = dout (jax.vmap of the reference's
    pack_int4)."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((E, dout, f)) * dout ** -0.5).astype(np.float32)
    if kind == "fp32":
        return w, None, False
    if kind == "bf16":
        return np.asarray(jnp.asarray(w, jnp.bfloat16)), None, False
    bits = 8 if kind == "int8" else 4
    q, s = jquant.quantize_symmetric(jnp.asarray(w), axis=1, bits=bits)
    if bits == 4:
        q = jax.vmap(lambda q2: jquant.pack_int4(q2, dout))(q)
    return np.asarray(q), np.asarray(s), bits == 4


# ------------------------------------------------------- grouped_matmul

@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8", "int4"])
def test_grouped_matmul_gradients_match_jax(kind):
    """dx and dW (dense stacks) or dx and ds (int8, packed int4) against
    the reference's custom VJPs in interpret mode; the integer stacks get
    no gradient and are unchanged."""
    xs, be = _layout()
    w, s, packed4 = _stack(kind, D, F, seed=3)
    dy = np.random.default_rng(4).standard_normal(
        (xs.shape[0], F)).astype(np.float32)
    jbe = jnp.asarray(be)
    if s is None:
        _, vjp = jax.vjp(lambda x, w_: jgg.grouped_matmul(x, w_, jbe, bt=BT),
                         jnp.asarray(xs), jnp.asarray(w))
    else:
        _, vjp = jax.vjp(lambda x, s_: jgg.grouped_matmul(
            x, jnp.asarray(w), jbe, s_, bt=BT, packed4=packed4),
            jnp.asarray(xs), jnp.asarray(s))
    jdx, jdp = vjp(jnp.asarray(dy))

    x = _torch(xs).requires_grad_()
    wt = _torch(w)
    st = _torch(s)
    before = wt.clone()
    trained = st if s is not None else wt
    trained.requires_grad_()
    y = gg.grouped_matmul(x, wt, _torch(be), st, bt=BT, packed4=packed4)
    y.backward(_torch(dy))
    assert _rel(x.grad, jdx) <= GRAD_REL
    assert trained.grad.dtype == trained.dtype
    rule = BF16_GRAD_REL if kind == "bf16" else GRAD_REL
    assert _rel(trained.grad, np.asarray(jdp, np.float32)) <= rule
    if s is not None:
        assert wt.grad is None and torch.equal(wt, before)


def test_grouped_matmul_takes_no_gradient_it_is_not_asked_for():
    """Only the inputs that require grad get one: x alone (the chained
    step of ``moe_bench train``) skips dW and the scales' recompute."""
    xs, be = _layout()
    w, s, _ = _stack("int8", D, F, seed=3)
    x = _torch(xs).requires_grad_()
    st = _torch(s)
    gg.grouped_matmul(x, _torch(w), _torch(be), st, bt=BT).sum().backward()
    assert x.grad is not None and st.grad is None
    with torch.no_grad():
        y = gg.grouped_matmul(x, _torch(w), _torch(be), st, bt=BT)
    assert not y.requires_grad


@pytest.mark.parametrize("kind", ["fp32", "int8", "int4"])
def test_backward_plain_versions_match_float64(kind):
    """grouped_matmul_t_ref / grouped_matmul_t4_ref and grouped_dw_ref
    against float64 per-block products with each block's expert (int4:
    the nibbles unpacked with block_k = dout)."""
    xs, be = _layout()
    w, _, packed4 = _stack(kind, D, F, seed=5)
    rng = np.random.default_rng(6)
    dy = rng.standard_normal((xs.shape[0], F)).astype(np.float32)
    wt = _torch(w)
    dense = (jax.vmap(lambda p: jquant.unpack_int4(p, D))(jnp.asarray(w))
             if packed4 else w)
    dense = np.asarray(dense, np.float64)
    want_dx = np.zeros((xs.shape[0], D))
    want_dw = np.zeros((E, D, F))
    for i, e in enumerate(be):
        rows = slice(i * BT, (i + 1) * BT)
        want_dx[rows] = dy[rows].astype(np.float64) @ dense[e].T
        want_dw[e] += xs[rows].astype(np.float64).T @ dy[rows]
    ref = gg.grouped_matmul_t4_ref if packed4 else gg.grouped_matmul_t_ref
    assert _rel(ref(_torch(dy), wt, _torch(be), bt=BT), want_dx) <= PLAIN_REL
    got_dw = gg.grouped_dw_ref(_torch(xs), _torch(dy), _torch(be), E, bt=BT)
    assert _rel(got_dw, want_dw) <= PLAIN_REL
    assert not got_dw[EMPTY].any()     # its one block is zero rows
    # the wrappers take the plain versions for CPU tensors
    wrap = gg.grouped_matmul_t4 if packed4 else gg.grouped_matmul_t
    assert torch.equal(wrap(_torch(dy), wt, _torch(be), bt=BT),
                       ref(_torch(dy), wt, _torch(be), bt=BT))


def test_grouped_dw_gives_zeros_to_an_expert_without_blocks():
    xs, be = _layout()
    dy = np.ones((xs.shape[0], F), np.float32)
    got = gg.grouped_dw(_torch(xs), _torch(dy), _torch(be), E + 1, bt=BT)
    assert got.shape == (E + 1, D, F) and not got[E].any()


def test_backward_wrappers_refuse_what_the_kernels_do_not_take():
    dy = torch.zeros((16, 8))
    be = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="contraction"):
        gg.grouped_matmul_t(dy, torch.zeros((2, 4, 6)), be, bt=8)
    with pytest.raises(ValueError, match="blocks of"):
        gg.grouped_matmul_t4(dy, torch.zeros((2, 4, 8), dtype=torch.int8),
                             be[:1], bt=8)
    with pytest.raises(ValueError, match="vs dy"):
        gg.grouped_dw(torch.zeros((8, 4)), dy, be, 2, bt=8)


def test_unscaled_packed_product_is_the_backward_recompute():
    """The raw forward with a packed stack and no scales (the reference's
    ``_kernel_q4_noscale``) equals the scaled product divided out, and the
    public wrapper keeps refusing it."""
    xs, be = _layout()
    w, s, _ = _stack("int4", D, F, seed=7)
    u = gg._gmm(_torch(xs), _torch(w), _torch(be), None, BT, True)
    ref = np.asarray(jgg._gmm_call(jnp.asarray(xs), jnp.asarray(w),
                                   jnp.asarray(be), None, BT, None, True,
                                   packed4=True))
    assert _rel(u, ref) <= PLAIN_REL
    with pytest.raises(ValueError, match="packed4 requires scales"):
        gg.grouped_matmul(_torch(xs), _torch(w), _torch(be), bt=BT,
                          packed4=True)


@pytest.mark.parametrize("xs,ws", [((3, 5, 4), (3, 4, 6)),
                                   ((2, 3, 5, 4), (3, 4, 6)),
                                   ((3, 5, 4), (4, 6))])
def test_fp32_matmul_gradients_of_batched_products(xs, ws):
    """fp32_matmul's backward on the dispatch path's batched products
    (x and w with batch dims, w's broadcast against x's) against float64
    autograd of torch.matmul."""
    rng = np.random.default_rng(8)
    x0, w0 = (rng.standard_normal(s) for s in (xs, ws))
    g0 = rng.standard_normal(np.broadcast_shapes(xs[:-2], ws[:-2])
                             + (xs[-2], ws[-1]))
    x, w = (torch.from_numpy(a).float().requires_grad_() for a in (x0, w0))
    vendor.fp32_matmul(x, w).backward(torch.from_numpy(g0).float())
    x64, w64 = (torch.from_numpy(a).requires_grad_() for a in (x0, w0))
    torch.matmul(x64, w64).backward(torch.from_numpy(g0))
    for got, want in ((x.grad, x64.grad), (w.grad, w64.grad)):
        assert got.shape == want.shape
        assert _rel(got, want.numpy()) <= PLAIN_REL


# ------------------------------------------------------------ MoE layer

MD, MF, ME = 16, 40, 4


def _jax_layer(kind: str, seed: int, f: int = MF):
    p = jmoe.init_moe_params(jax.random.PRNGKey(seed), MD, f, ME,
                             swiglu=True)
    if kind != "fp32":
        p = jmoe.quantize_moe(p, bits=8 if kind == "int8" else 4)
    return p, convert.params_from_jax(jax.tree.map(np.asarray, p), "cpu")


def _top_gaps(x: np.ndarray, router, k: int) -> np.ndarray:
    logits = jnp.asarray(x, jnp.float32) @ router.astype(jnp.float32)
    top = np.asarray(jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                                   k + 1)[0])
    return top[:, k - 1] - top[:, k]


def _assert_no_near_ties(gaps: np.ndarray) -> None:
    assert gaps.min() > ROUTE_GAP, (
        f"a token's top-k gap {gaps.min():.3e} is a near-tie: its gradient "
        "would compare other experts' choices")


def _floats(p: dict) -> list:
    return sorted(n for n, v in p.items()
                  if jnp.issubdtype(v.dtype, jnp.floating))


@pytest.mark.parametrize("kind", ["fp32", "int8", "int4"])
def test_moe_ffn_ragged_gradients_match_jax(kind):
    """x, the router and the stacks (fp32) or the scales (int8, int4)
    under sum(out * g) + 0.01 aux, the JAX grouped GEMM's VJPs in
    interpret mode."""
    jp, p = _jax_layer(kind, seed=21)
    rng = np.random.default_rng(22)
    x = rng.standard_normal((50, MD)).astype(np.float32)
    g = rng.standard_normal((50, MD)).astype(np.float32)
    _assert_no_near_ties(_top_gaps(x, jp["router"], 2))
    names = _floats(jp)

    def jloss(x_, floats):
        out, aux = jmoe.moe_ffn_ragged({**jp, **floats}, x_, k=2, bt=BT,
                                       return_aux=True)
        return jnp.sum(out * jnp.asarray(g)) + 0.01 * aux

    jgx, jgp = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), {n: jp[n] for n in names})
    xt = torch.from_numpy(x).requires_grad_()
    leaves = {n: p[n].clone().requires_grad_() for n in names}
    out, aux = moe.moe_ffn_ragged({**p, **leaves}, xt, k=2, bt=BT,
                                  return_aux=True)
    (torch.sum(out * torch.from_numpy(g)) + 0.01 * aux).backward()
    assert _rel(xt.grad, jgx) <= GRAD_REL
    for n in names:
        assert _rel(leaves[n].grad, jgp[n]) <= GRAD_REL, n
    assert set(names) == set(p) - {k for k in p if "_q" in k}


@pytest.mark.parametrize("kind", ["fp32", "int8", "int4"])
def test_ragged_gradients_match_dispatch(kind):
    """The reference's test_moe_ragged_gradients_match_dispatch,
    _q8_trains_like_dispatch and _q4_trains_like_dispatch on the port: the
    ragged path's gradients equal the dropless dispatch path's (d 16,
    f 128, E 4, T 64; the aux too for dense stacks)."""
    jp, p = _jax_layer(kind, seed=30, f=128)
    x = np.random.default_rng(32).standard_normal((64, MD)).astype(
        np.float32)
    _assert_no_near_ties(_top_gaps(x, jp["router"], 2))
    names = [n for n, v in p.items() if torch.is_floating_point(v)]
    aux_weight = 0.01 if kind == "fp32" else 0.0

    def grads(fn):
        leaves = {n: p[n].clone().requires_grad_() for n in names}
        y, aux = fn({**p, **leaves}, torch.from_numpy(x))
        (torch.mean(y ** 2) + aux_weight * aux).backward()
        return {n: leaves[n].grad for n in names}

    ga = grads(lambda q, xx: moe.moe_ffn_ragged(q, xx, k=2, bt=BT,
                                                return_aux=True))
    gb = grads(lambda q, xx: moe.moe_ffn_local(q, xx, k=2,
                                               capacity_factor=2.0,
                                               return_aux=True))
    atol = 1e-5 if kind == "fp32" else 1e-4
    for n in names:
        np.testing.assert_allclose(ga[n].numpy(), gb[n].numpy(), rtol=0,
                                   atol=atol, err_msg=n)


# ---------------------------------------------------------------- model

_MCFG = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=64, max_seq=32, n_experts=4)
# (weight kind, moe_ragged): True with moe_ragged_min_tokens=0 takes the
# ragged path at every step, False the dispatch path
LOSS_CASES = [(kind, ragged) for kind in ("fp32", "int8", "w4a8")
              for ragged in (True, False)]


def _models(kind: str, ragged: bool, seed: int = 9):
    extra = dict(weight_kind=kind, moe_ragged=ragged,
                 moe_ragged_min_tokens=0 if ragged else None)
    jcfg = jllama.LlamaConfig(**_MCFG, **extra)
    jparams = jllama.init_params(jax.random.PRNGKey(seed), jcfg)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     "cpu")
    return jcfg, jparams, llama.LlamaConfig(**_MCFG, **extra), params


def _model_gaps(jparams, jcfg, tokens, monkeypatch) -> np.ndarray:
    """JAX's top-k gap of every token at every MoE layer of a forward on
    ``tokens`` (the inputs its MoE paths receive, recorded)."""
    gaps = []
    for name in ("moe_ffn_ragged", "moe_ffn_local"):
        real = getattr(jmoe, name)

        def record(params, x, *a, _real=real, **kw):
            gaps.append(_top_gaps(np.asarray(x), params["router"],
                                  jcfg.moe_top_k))
            return _real(params, x, *a, **kw)
        monkeypatch.setattr(jmoe, name, record)
    jllama.forward(jparams, jcfg, jnp.asarray(tokens), use_pallas=False)
    monkeypatch.undo()
    assert len(gaps) == jcfg.n_layers
    return np.concatenate(gaps)


@pytest.mark.parametrize("kind,ragged", LOSS_CASES,
                         ids=[f"{k}-{'ragged' if r else 'dispatch'}"
                              for k, r in LOSS_CASES])
def test_moe_loss_fn_and_gradients_match_jax(kind, ragged, monkeypatch):
    """loss_fn with the aux (the reference's
    test_moe_loss_includes_aux_and_tp_shards, single-device half) and the
    gradient of every float leaf; the quantized linears through the CPU
    emulation, the stacks int8 (int8) or packed int4 (w4a8)."""
    jcfg, jparams, cfg, params = _models(kind, ragged)
    tokens = np.random.default_rng(10).integers(0, 64, (2, 13)).astype(
        np.int32)
    _assert_no_near_ties(_model_gaps(jparams, jcfg, tokens[:, :-1],
                                     monkeypatch))
    floats, rebuild = jtraining.split_trainable(jparams)
    leaves = jax.tree.leaves(jparams)
    jloss, jgrads = jax.value_and_grad(lambda fl: jllama.loss_fn(
        rebuild(fl, leaves), jcfg, jnp.asarray(tokens), False))(floats)
    tfloats, trebuild = training.split_trainable(params)
    tfloats = [f.detach().clone().requires_grad_() for f in tfloats]
    loss = llama.loss_fn(trebuild(tfloats), cfg, torch.from_numpy(tokens))
    grads = torch.autograd.grad(loss, tfloats)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_RTOL)
    assert len(grads) == len(jgrads)
    for g, jg in zip(grads, jgrads):
        rule = BF16_GRAD_REL if g.dtype == torch.bfloat16 else GRAD_REL
        assert _rel(g, np.asarray(jg, np.float32)) <= rule, g.shape
    # the aux term is in the loss: the cross entropy alone differs by it
    logits, aux = llama.forward(params, cfg, torch.from_numpy(tokens[:, :-1]),
                                return_moe_aux=True)
    ce = llama.token_nll(logits, torch.from_numpy(tokens[:, 1:]))
    np.testing.assert_allclose(float(loss.detach()),
                               float(ce + cfg.moe_aux_weight * aux),
                               rtol=LOSS_RTOL)
    assert float(aux) >= 1.0 - 1e-5


def test_linear_kinds_are_only_the_linears():
    """An MoE tree's "moe" dict (router, stacks) is not a linear."""
    _, _, _, params = _models("int8", True)
    assert llama._linear_kinds(params) == {"int8", "fp32"}
    _, _, _, params = _models("fp32", True)
    assert llama._linear_kinds(params) == {"fp32"}


def test_moe_train_step_moves_router():
    """The reference's test_moe_train_step_moves_router: SGD steps on an
    MoE model lower the loss and move the router; the int8 stacks stay."""
    _, _, cfg, params = _models("int8", True, seed=0)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (4, 16)))
    state, losses = params, []
    for _ in range(6):
        state, loss = llama.sgd_train_step(state, cfg, tokens, lr=1e-2)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    m0, m1 = params["layers"][0]["moe"], state["layers"][0]["moe"]
    assert not torch.equal(m0["router"], m1["router"])
    assert not torch.equal(m0["w_in_s"], m1["w_in_s"])
    assert torch.equal(m0["w_in_q"], m1["w_in_q"])


@pytest.mark.parametrize("kind", ["int8", "w4a8"])
def test_train_keeps_int_stacks_frozen_and_resumes_bit_exactly(kind,
                                                                tmp_path):
    """training.train on an MoE tree (ragged at every step): the integer
    stacks are unchanged, the scales and router move, and a run resumed
    from the step-2 checkpoint gives the same losses and parameters."""
    batches = [torch.from_numpy(np.random.default_rng(40 + i).integers(
        0, 64, (2, 13))) for i in range(4)]
    _, _, cfg, params = _models(kind, True)
    ints = {n: v.clone() for n, v in params["layers"][1]["moe"].items()
            if not training.is_float_leaf(v)}
    router = params["layers"][1]["moe"]["router"].clone()
    state, losses = training.train(cfg, params, iter(batches), 4, lr=1e-2,
                                   checkpoint_dir=str(tmp_path),
                                   checkpoint_every=2)
    moe1 = state.params["layers"][1]["moe"]
    assert ints and all(torch.equal(moe1[n], v) for n, v in ints.items())
    assert not torch.equal(moe1["router"], router)
    _, _, _, params2 = _models(kind, True)
    state2, losses2 = training.train(
        cfg, params2, iter(batches[2:]), 4, lr=1e-2,
        resume_from=str(tmp_path / "step_000002"))
    assert losses2 == losses[2:] and all(np.isfinite(losses))
    for a, b in zip(training._leaves(state.params),
                    training._leaves(state2.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["int8", "int4", "bf16"])
def test_moe_bench_train_runs_on_the_cpu(kind, capsys):
    r = moe_bench.main(["train", "--device", "cpu", "--kind", kind, "--t",
                        "64", "--d", "32", "--f", "48", "--e", "4",
                        "--repeats", "1"])["custom"][f"train {kind}"]
    stacks = {"w_gate", "w_in", "w_out"}
    if kind == "bf16":
        assert set(r["trainable"]) == stacks | {"router"} and not r["frozen"]
    else:
        suffix = "_q" if kind == "int8" else "_q4"
        assert set(r["frozen"]) == {n + suffix for n in stacks}
        assert set(r["trainable"]) == {n + "_s" for n in stacks} | {"router"}
    assert r["stacks_unchanged"] and all(v > 0 for v in
                                         r["grad_norms"].values())
    assert "trainable leaves" in capsys.readouterr().out


def test_mixtral_preset_trains_through_the_ragged_path(monkeypatch):
    """A Mixtral-shaped config cut to d 32 takes the ragged path once b x
    s x k reaches 2 x E x 128 routed copies, as the chip run's T-moe does,
    and its loss has a gradient for every float leaf."""
    cfg = dataclasses.replace(llama.mixtral_8x7b("bf16"), vocab=64,
                              d_model=32, n_layers=1, n_heads=4,
                              n_kv_heads=2, d_ff=48, max_seq=1025,
                              moe_ragged=True)
    params = llama.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    calls = []
    real = moe.moe_ffn_ragged
    monkeypatch.setattr(moe, "moe_ffn_ragged", lambda *a, **kw: (
        calls.append(a[1].shape[0]) or real(*a, **kw)))
    floats, rebuild = training.split_trainable(params)
    floats = [f.detach().requires_grad_() for f in floats]
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 64, (1, 1025)))
    grads = torch.autograd.grad(llama.loss_fn(rebuild(floats), cfg, tokens),
                                floats)
    assert calls == [1024]
    assert all(torch.isfinite(g).all() and g.abs().max() > 0 for g in grads)
