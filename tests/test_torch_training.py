"""Port parity: training the Llama model (loss, gradients, remat, AdamW with
global-norm clipping, SGD, checkpoint and bit-exact resume, the soak CLI)
against the JAX package's ``models/llama`` and ``parallel/training``, on
the CPU.

Weights come from the JAX ``init_params`` through
``convert.params_from_jax`` and tokens from numpy, so both sides start
from the same bytes. The JAX side runs as its own tests run it: the loss
on its ``use_pallas=False`` routes, the flash kernels (``flash_train``) in
interpret mode.

Tolerances (measured differences in the comments beside them):
- loss: LOSS_RTOL relative (fp32 ops in another order); FLASH_LOSS_RTOL
  through flash at s = 512, where a score moved by rounding can flip the
  bf16 rounding of p, and with bf16 weights an activation moved by
  rounding can flip its bf16 rounding before a linear;
- gradients, each leaf within GRAD_REL of its own max |gradient| (fp32
  sums in another order), FLASH_GRAD_REL through flash (the flips
  above); bf16 leaves (bf16 gradients) within BF16_GRAD_REL, a few bf16
  ulps;
- parameters after SGD steps: PARAM_ATOL; after AdamW steps PARAM_ATOL
  where every step's gradient stands above the gradient noise, and
  NOISY_STEP_BOUND per step elsewhere (``test_adamw_clip_steps_match_optax``
  derives it: Adam divides m by sqrt(v), so a gradient that is all
  rounding noise still steps by up to lr, in the noise's direction);
  the optimizers themselves, fed the same gradients, within ADAMW_ATOL
  (a few fp32 ulps of the parameters); BF16_PARAM_ATOL where a gradient is
  rounded to bf16 (the int4 emulation rounds x and the dequantized weight
  to bf16, so their gradients come back through that rounding): lr times
  one bf16 ulp of a gradient below 4, 1e-2 x 2^-6;
- resume, checkpoints and remat: EQUAL.
"""
import dataclasses
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from how_to_optimize_gemm_tpu.models import checkpoint as jcheckpoint
from how_to_optimize_gemm_tpu.models import llama as jllama
from how_to_optimize_gemm_tpu.parallel import training as jtraining
from how_to_optimize_gemm_tpu_torch import convert
from how_to_optimize_gemm_tpu_torch.models import checkpoint, llama
from how_to_optimize_gemm_tpu_torch.ops import attention
from how_to_optimize_gemm_tpu_torch.parallel import training

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
FLASH_LOSS_RTOL = 1e-4
GRAD_REL = 1e-3
FLASH_GRAD_REL = 5e-3
BF16_GRAD_REL = 2e-2
PARAM_ATOL = 1e-5
# |AdamW step| <= lr * (|m^| / (sqrt(v^) + eps) + wd * |p|), and
# |m^| <= sqrt(v^) in the first steps (beta1 0.9, beta2 0.999), so two
# steps taken on noise differ by at most 2 lr (+ the decay's rounding)
NOISY_STEP_BOUND = 2.0
# share of a leaf whose gradient lies within the noise at some step
# (measured: at most 6.2% over the three steps, in a (64, 32) linear)
NOISY_SHARE = 0.1
ADAMW_ATOL = 1e-6
BF16_PARAM_ATOL = 2e-4

SMALL = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=64, max_seq=32)
# d_head 64, rep 2, s = 512: the flash route on both sides
FLASH = dict(vocab=64, d_model=128, n_layers=2, n_heads=2, n_kv_heads=1,
             d_ff=128, max_seq=513)


def _models(cfg: dict, kind: str, seed: int = 0):
    jcfg = jllama.LlamaConfig(**cfg, weight_kind=kind)
    jparams = jllama.init_params(jax.random.PRNGKey(seed), jcfg)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     "cpu")
    return jcfg, jparams, llama.LlamaConfig(**cfg, weight_kind=kind), params


def _tokens(seed: int, batch: int, seq: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, vocab, (batch, seq)).astype(np.int32)


def _jax_loss_and_grads(jparams, jcfg, tokens, remat=False,
                        flash_train=False):
    floats, rebuild = jtraining.split_trainable(jparams)
    leaves = jax.tree.leaves(jparams)

    def loss_of(floats):
        return jllama.loss_fn(rebuild(floats, leaves), jcfg,
                              jnp.asarray(tokens), False, remat, flash_train)

    return jax.value_and_grad(loss_of)(floats)


def _port_loss_and_grads(params, cfg, tokens, remat=False,
                         flash_train=False):
    floats, rebuild = training.split_trainable(params)
    floats = [f.detach().clone().requires_grad_() for f in floats]
    loss = llama.loss_fn(rebuild(floats), cfg,
                         torch.from_numpy(tokens), remat, flash_train)
    return loss, torch.autograd.grad(loss, floats)


def _assert_grads_close(got, ref, fp32_rel=GRAD_REL):
    assert len(got) == len(ref)
    worst = 0.0
    for g, r in zip(got, ref):
        r = np.asarray(r, np.float32)
        bf16 = g.dtype == torch.bfloat16
        err = float(np.abs(g.float().numpy() - r).max())
        rel = err / max(float(np.abs(r).max()), 1e-30)
        assert rel <= (BF16_GRAD_REL if bf16 else fp32_rel), (g.shape, rel)
        worst = max(worst, rel)
    return worst


# ----------------------------------------------------------- loss, grads

@pytest.mark.parametrize("kind", ["fp32", "bf16"])
def test_loss_and_grads_match_jax_through_flash(kind, monkeypatch):
    """loss_fn and its gradients at s = 512 with flash_train on both sides
    (port: FlashAttentionTrain over the plain versions, once a layer;
    JAX: its custom VJP over the Pallas kernels in interpret mode).
    Measured: loss 2e-5 relative (bf16 weights); gradients 2.2e-3
    (fp32 leaves), 6.6e-3 (bf16 leaves)."""
    jcfg, jparams, cfg, params = _models(FLASH, kind)
    tokens = _tokens(1, 1, 513, FLASH["vocab"])
    jloss, jgrads = _jax_loss_and_grads(jparams, jcfg, tokens,
                                        flash_train=True)
    calls = []
    real = attention.flash_attention_fwd_lse_ref

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)
    monkeypatch.setattr(attention, "flash_attention_fwd_lse_ref", counting)
    loss, grads = _port_loss_and_grads(params, cfg, tokens, flash_train=True)
    assert len(calls) == FLASH["n_layers"]
    np.testing.assert_allclose(float(loss), float(jloss),
                               rtol=FLASH_LOSS_RTOL)
    print(f"{kind}: loss {float(loss)} vs {float(jloss)}, worst gradient "
          f"{_assert_grads_close(grads, jgrads, FLASH_GRAD_REL):.2e}")


@pytest.mark.parametrize("kind", ["fp32", "int8", "int4", "w4a8"])
def test_eager_loss_and_grads_match_jax(kind):
    """Below s = 512 (and without flash_train) attention is the eager
    _attention; the quantized kinds train their float scales through the
    emulation, as in the reference."""
    jcfg, jparams, cfg, params = _models(SMALL, kind)
    tokens = _tokens(2, 2, 17, SMALL["vocab"])
    jloss, jgrads = _jax_loss_and_grads(jparams, jcfg, tokens)
    loss, grads = _port_loss_and_grads(params, cfg, tokens)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    _assert_grads_close(grads, jgrads)


@pytest.mark.parametrize("cfg_dict,flash", [(SMALL, False), (FLASH, True)])
def test_remat_gives_the_same_gradients(cfg_dict, flash):
    _, _, cfg, params = _models(cfg_dict, "fp32")
    tokens = _tokens(3, 1, cfg_dict["max_seq"], cfg_dict["vocab"])
    loss, grads = _port_loss_and_grads(params, cfg, tokens, False, flash)
    loss_r, grads_r = _port_loss_and_grads(params, cfg, tokens, True, flash)
    assert torch.equal(loss, loss_r)
    for g, gr in zip(grads, grads_r):
        assert torch.equal(g, gr)


def test_token_nll_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    targets = rng.integers(0, 11, (2, 5)).astype(np.int32)
    ref = jllama.token_nll(jnp.asarray(logits), jnp.asarray(targets))
    got = llama.token_nll(torch.from_numpy(logits),
                          torch.from_numpy(targets))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


# ------------------------------------------------------------- optimizer

def test_clip_by_global_norm_matches_optax():
    rng = np.random.default_rng(5)
    grads = [rng.standard_normal(s).astype(np.float32) for s in
             ((4, 3), (7,), (2, 2))]
    for scale, dtype in ((1.0, np.float32), (0.01, np.float32)):
        gs = [g * scale for g in grads]
        ref, _ = optax.clip_by_global_norm(1.0).update(
            [jnp.asarray(g) for g in gs], optax.EmptyState())
        got = training.clip_by_global_norm(
            [torch.from_numpy(g) for g in gs], 1.0)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    assert float(training.global_norm([torch.ones(4)])) == 2.0


def test_adamw_clip_steps_match_optax():
    """Three AdamW + clip steps of the whole train step on both sides, fp32
    weights, a new batch each step; the gradient norm exceeds the clip at
    the start, so clipping acts. Losses within LOSS_RTOL (measured 2e-7).

    Parameters: Adam's step is lr * m^ / (sqrt(v^) + eps), about lr * sign(g)
    whatever |g| is, so an element whose gradient lies within the gradient
    noise (GRAD_REL x its leaf's max |g|, the bound the gradients are held
    to) steps by up to lr in whichever direction the rounding points. Such
    an element, at any step, is held to NOISY_STEP_BOUND x lr per step;
    every other element to PARAM_ATOL (measured 4e-7); and the noisy
    elements must be few (NOISY_SHARE of each leaf; measured 6.2% at
    most). A gradient that is 0
    on both sides (embedding rows of tokens not in the batch) is exact, not
    noise. Measured: leaf 7 (a 32x32 linear) element (3, 23) has a
    first-step gradient of 6.5e-7 against its leaf's 0.27 (2.4e-6 of it)
    and ends 1.1e-5 apart; the optimizers alone agree to 3e-7
    (test_adamw_matches_optax_on_the_same_gradients)."""
    lr, n_steps = 1e-2, 3
    jcfg, jparams, cfg, params = _models(SMALL, "fp32")
    jopt = jtraining.make_optimizer(lr)
    jstate = jtraining.init_train_state(jparams, jopt)
    jstep, _ = jtraining.make_train_step(jcfg, jopt)
    opt = training.make_optimizer(lr)
    state = training.init_train_state(params, opt)
    step = training.make_train_step(cfg, opt)
    first = _tokens(10, 2, 17, SMALL["vocab"])
    _, grads = _port_loss_and_grads(params, cfg, first)
    assert float(training.global_norm(grads)) > opt.clip
    noisy = None
    for i in range(n_steps):
        tokens = _tokens(10 + i, 2, 17, SMALL["vocab"])
        _, jgrads = _jax_loss_and_grads(jstate.params, jcfg, tokens)
        _, grads = _port_loss_and_grads(state.params, cfg, tokens)
        _assert_grads_close(grads, jgrads)
        step_noisy = []
        for g, r in zip(grads, jgrads):
            g, r = g.numpy(), np.asarray(r, np.float32)
            both_zero = (g == 0) & (r == 0)
            step_noisy.append(
                (np.abs(r) <= GRAD_REL * np.abs(r).max()) & ~both_zero)
        noisy = (step_noisy if noisy is None
                 else [a | b for a, b in zip(noisy, step_noisy)])
        jstate, jloss = jstep(jstate, jnp.asarray(tokens))
        state, loss = step(state, torch.from_numpy(tokens))
        np.testing.assert_allclose(float(loss), float(jloss),
                                   rtol=LOSS_RTOL)
    assert state.step == n_steps
    got, _ = training.split_trainable(state.params)
    ref, _ = jtraining.split_trainable(jstate.params)
    for i, (a, b, mask) in enumerate(zip(got, ref, noisy)):
        assert mask.mean() <= NOISY_SHARE, (i, float(mask.mean()))
        err = np.abs(a.detach().numpy() - np.asarray(b))
        bound = np.where(mask, NOISY_STEP_BOUND * lr * n_steps, PARAM_ATOL)
        assert (err <= bound).all(), (i, float(err.max()),
                                      float(err[~mask].max(initial=0)))


def test_adamw_matches_optax_on_the_same_gradients():
    """The port's optimizer (global-norm clip, then torch.optim.AdamW) and
    the reference's (optax.clip_by_global_norm, then optax.adamw) fed the
    same numpy gradients for three steps, the first above the clip and the
    last below it. Within ADAMW_ATOL: a few fp32 ulps of parameters near 1
    (measured 3e-7)."""
    lr = 1e-2
    rng = np.random.default_rng(11)
    shapes = ((32, 32), (32,), (64, 16))
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    steps = [[rng.standard_normal(s).astype(np.float32) * scale
              for s in shapes] for scale in (1.0, 0.05, 1e-3)]
    assert np.sqrt(sum((g * g).sum() for g in steps[0])) > 1.0
    assert np.sqrt(sum((g * g).sum() for g in steps[-1])) < 1.0
    jopt = jtraining.make_optimizer(lr)
    jparams = [jnp.asarray(p) for p in init]
    jstate = jopt.init(jparams)
    opt = training.make_optimizer(lr)
    floats = [torch.from_numpy(p.copy()).requires_grad_() for p in init]
    adamw = opt.init(floats)
    for grads in steps:
        updates, jstate = jopt.update([jnp.asarray(g) for g in grads],
                                      jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        clipped = training.clip_by_global_norm(
            [torch.from_numpy(g) for g in grads], opt.clip)
        for p, g in zip(floats, clipped):
            p.grad = g
        adamw.step()
    for a, b in zip(floats, jparams):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=0, atol=ADAMW_ATOL)


def test_sgd_train_step_matches_jax():
    jcfg, jparams, cfg, params = _models(SMALL, "fp32")
    tokens = _tokens(6, 2, 17, SMALL["vocab"])
    jnew, jloss = jllama.sgd_train_step(jparams, jcfg, jnp.asarray(tokens))
    new, loss = llama.sgd_train_step(params, cfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    for a, b in zip(training.split_trainable(new)[0],
                    jtraining.split_trainable(jnew)[0]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=PARAM_ATOL)
    # the given tree is not changed
    for a, b in zip(training.split_trainable(params)[0],
                    jtraining.split_trainable(jparams)[0]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("kind", ["int8", "int4", "w4a8"])
def test_integer_leaves_frozen_and_scales_move_as_in_jax(kind):
    """One SGD step: every integer leaf is unchanged, and the float scales
    move as the reference's do (its XLA emulation on the CPU)."""
    jcfg, jparams, cfg, params = _models(SMALL, kind)
    tokens = _tokens(7, 2, 17, SMALL["vocab"])
    jnew, _ = jllama.sgd_train_step(jparams, jcfg, jnp.asarray(tokens))
    new, _ = llama.sgd_train_step(params, cfg, torch.from_numpy(tokens))
    ints = [x for x in training._leaves(params)
            if not training.is_float_leaf(x)]
    assert ints and all(torch.equal(a, b) for a, b in zip(
        ints, [x for x in training._leaves(new)
               if not training.is_float_leaf(x)]))
    lin = new["layers"][0]["wq"]
    scale = lin[f"{kind}_sw"]
    assert not torch.equal(scale, params["layers"][0]["wq"][f"{kind}_sw"])
    atol = BF16_PARAM_ATOL if kind == "int4" else PARAM_ATOL
    np.testing.assert_allclose(scale.numpy(),
                               np.asarray(jnew["layers"][0]["wq"][
                                   f"{kind}_sw"]), atol=atol)
    for a, b in zip(training.split_trainable(new)[0],
                    jtraining.split_trainable(jnew)[0]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b, np.float32),
                                   atol=atol)


def test_bf16_weights_train():
    """bf16 leaves are trainable (the reference's dtype.kind trap), move in
    an AdamW step and stay bf16; integer leaves are not trainable."""
    _, _, cfg, params = _models(SMALL, "bf16")
    assert training.is_float_leaf(torch.zeros(1, dtype=torch.bfloat16))
    assert not training.is_float_leaf(torch.zeros(1, dtype=torch.int8))
    before = params["layers"][0]["wq"]["bf16_w"].clone()
    opt = training.make_optimizer(1e-2)
    state = training.init_train_state(params, opt)
    assert any(p is params["layers"][0]["wq"]["bf16_w"]
               for p in state.opt_state.param_groups[0]["params"])
    step = training.make_train_step(cfg, opt)
    losses = [float(step(state, torch.from_numpy(
        _tokens(8, 2, 17, SMALL["vocab"])))[1]) for _ in range(5)]
    after = state.params["layers"][0]["wq"]["bf16_w"]
    assert after.dtype == torch.bfloat16 and not torch.equal(before, after)
    assert losses[-1] < losses[0]


def test_mesh_is_not_ported():
    _, _, cfg, params = _models(SMALL, "fp32")
    opt = training.make_optimizer()
    with pytest.raises(NotImplementedError, match="A12"):
        training.init_train_state(params, opt, mesh=object())
    with pytest.raises(NotImplementedError, match="A12"):
        training.make_train_step(cfg, opt, mesh=object())


def test_affine_batch_is_the_reference_stream():
    a = training._affine_batch(np.random.default_rng(1234), 3, 40, 32000)
    b = jtraining._affine_batch(np.random.default_rng(1234), 3, 40, 32000)
    np.testing.assert_array_equal(a, b)


# ----------------------------------------------------- checkpoint, resume

def test_cpu_resume_is_bit_exact(tmp_path):
    """8 steps with checkpoints every 4, then a fresh state resumed from
    step 4: the last 4 losses, the parameters and the AdamW state equal
    the uninterrupted run's."""
    _, _, cfg, params = _models(SMALL, "bf16")
    batches = [torch.from_numpy(_tokens(20 + i, 2, 17, SMALL["vocab"]))
               for i in range(8)]
    state, losses = training.train(cfg, params, iter(batches), 8, lr=1e-2,
                                   checkpoint_dir=str(tmp_path),
                                   checkpoint_every=4)
    _, _, _, params2 = _models(SMALL, "bf16")
    state2, losses2 = training.train(
        cfg, params2, iter(batches[4:]), 8, lr=1e-2,
        resume_from=str(tmp_path / "step_000004"))
    assert state2.step == 8 and losses2 == losses[4:]
    for a, b in zip(training._leaves(state.params),
                    training._leaves(state2.params)):
        assert torch.equal(a, b)
    opt, opt2 = state.opt_state, state2.opt_state
    for p, p2 in zip(opt.param_groups[0]["params"],
                     opt2.param_groups[0]["params"]):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(opt.state[p][key], opt2.state[p2][key])


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8", "int4", "w4a8"])
def test_checkpoint_roundtrip(tmp_path, kind):
    _, _, cfg, params = _models(SMALL, kind)
    checkpoint.save_params(tmp_path / "p", params)
    like = llama.init_params(torch.Generator().manual_seed(1), cfg, "cpu")
    back = checkpoint.load_params(tmp_path / "p", like)
    for a, b in zip(training._leaves(params), training._leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8", "int4", "w4a8"])
def test_jax_save_params_file_loads_into_the_port(tmp_path, kind):
    jcfg, jparams, cfg, params = _models(SMALL, kind, seed=3)
    jcheckpoint.save_params(tmp_path / "jax", jparams)
    like = llama.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    back = checkpoint.load_params(tmp_path / "jax", like)
    for a, b in zip(training._leaves(params), training._leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("kind", ["bf16", "w4a8"])
def test_checkpoint_file_is_what_np_savez_writes(tmp_path, kind):
    """save_params writes np.savez's archive (the same entries, sizes and
    CRCs as np.savez of the flattened tree; np.load and the JAX package
    read it), and load_params, reading in many small pieces here, gives
    the tree back bit for bit."""
    import zipfile

    from how_to_optimize_gemm_tpu.models import checkpoint as jck
    _, _, cfg, params = _models(SMALL, kind)
    tree = {"params": params, "step": np.int64(7)}
    checkpoint.save_params(tmp_path / "p", tree)
    np.savez(tmp_path / "ref", **checkpoint._flatten(tree))
    infos = [{zi.filename: (zi.file_size, zi.CRC, zi.compress_type)
              for zi in zipfile.ZipFile(tmp_path / name).infolist()}
             for name in ("p.npz", "ref.npz")]
    assert infos[0] == infos[1]
    with np.load(tmp_path / "p.npz") as z:
        assert int(z["step"]) == 7
    assert jck.load_params(tmp_path / "p.npz", {"step": np.int64(0)}) \
        == {"step": 7}
    old_chunk = checkpoint.CHUNK
    checkpoint.CHUNK = 1000
    try:
        back = checkpoint.load_params(tmp_path / "ref", tree)
    finally:
        checkpoint.CHUNK = old_chunk
    for a, b in zip(training._leaves(params), training._leaves(back["params"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(back["step"]) == 7


def test_checkpoint_load_checks_crc_and_reads_compressed(tmp_path):
    """A flipped data byte fails the entry's CRC-32, as with np.load; an
    archive of compressed entries (np.savez_compressed) goes through
    numpy's reader."""
    import zipfile
    tree = {"a": torch.arange(64, dtype=torch.float32).reshape(8, 8),
            "b": torch.ones(3, dtype=torch.bfloat16)}
    checkpoint.save_params(tmp_path / "p", tree)
    raw = bytearray((tmp_path / "p.npz").read_bytes())
    raw[raw.find(b"NUMPY") + 200] ^= 1
    (tmp_path / "bad.npz").write_bytes(raw)
    with pytest.raises(zipfile.BadZipFile, match="CRC"):
        checkpoint.load_params(tmp_path / "bad.npz", tree)
    np.savez_compressed(tmp_path / "z", a=tree["a"].numpy(),
                        b__bf16=tree["b"].view(torch.int16).numpy().view(
                            np.uint16))
    back = checkpoint.load_params(tmp_path / "z", tree)
    assert torch.equal(back["a"], tree["a"])
    assert torch.equal(back["b"], tree["b"])


def test_loaded_tensors_are_freed_without_the_cyclic_collector(tmp_path):
    """load_params keeps no reference cycle to what it loaded: a 20 GB
    train state must leave the card when its last user drops it, not at
    the cyclic collector's next run."""
    import gc
    import weakref
    tree = {"a": torch.ones(64, 64), "b": [torch.zeros(3)]}
    checkpoint.save_params(tmp_path / "p", tree)
    gc.disable()
    try:
        back = checkpoint.load_params(tmp_path / "p", tree)
        refs = [weakref.ref(back["a"]), weakref.ref(back["b"][0])]
        del back
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


def test_checkpoint_mismatch_raises(tmp_path):
    _, _, cfg, params = _models(SMALL, "fp32")
    checkpoint.save_params(tmp_path / "p", params)
    other = llama.init_params(torch.Generator().manual_seed(0),
                              dataclasses.replace(cfg, d_ff=32), "cpu")
    with pytest.raises(ValueError, match="mismatch"):
        checkpoint.load_params(tmp_path / "p", other)


def test_soak_main_on_the_cpu_writes_its_artifacts(tmp_path):
    """The soak CLI at a tiny width with --device cpu: 6 steps with a
    checkpoint at 3, then resumed from it; both artifacts land where they
    are told (never the JAX soak's outputs/train_soak*.json), and the
    resumed losses equal the first run's bit for bit. No device metric
    comes from the CPU run."""
    art = tmp_path / "gpu" / "train_soak.json"
    base = ["--device", "cpu", "--d-model", "64", "--n-layers", "2",
            "--n-heads", "1", "--n-kv-heads", "1", "--d-ff", "64",
            "--vocab", "128", "--seq", "17", "--batch", "2", "--steps", "6",
            "--checkpoint-every", "3", "--sync-every", "2",
            "--ckpt-dir", str(tmp_path / "ck"), "--artifact", str(art)]
    first = training.soak_main(base + ["--flash-train"])
    assert json.loads(art.read_text())["losses"] == first["losses"]
    assert len(first["losses"]) == 6 and first["mfu_pct"] is None
    assert first["device"] == "cpu" and first["peak_gb"] is None
    again = training.soak_main(
        base + ["--flash-train", "--resume-from",
                str(tmp_path / "ck" / "step_000003")])
    assert again["start_step"] == 3 and again["bitexact_resume"]
    assert again["losses"] == first["losses"][3:]
    assert (tmp_path / "gpu" / "train_soak.resume.json").exists()


def test_soak_defaults_stay_under_outputs_gpu():
    import inspect
    src = inspect.getsource(training.soak_main)
    assert '"outputs/gpu/train_soak.json"' in src
    assert '"outputs/gpu/train_soak_ckpt"' in src


def test_train_iterates_and_checkpoints(tmp_path):
    _, _, cfg, params = _models(SMALL, "fp32")
    batches = itertools.repeat(torch.from_numpy(
        _tokens(30, 2, 17, SMALL["vocab"])))
    state, losses = training.train(cfg, params, batches, 4, lr=1e-2,
                                   checkpoint_dir=str(tmp_path),
                                   checkpoint_every=2)
    assert len(losses) == 4 and losses[-1] < losses[0]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_000002.npz", "step_000004.npz"]
