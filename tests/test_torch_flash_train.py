"""Port parity: the training flash attention (forward with logsumexp, the dQ
and dK/dV passes, and the autograd function around them) against the JAX
package's ``flash_attention_train`` / ``mha_flash_train`` (Pallas in
interpret mode, differentiated by ``jax.vjp``), and the repairs that keep a
kernel wrapper from dropping a gradient.

The same numpy inputs go to both sides (k and v rounded to bf16 first). On
the CPU the port's wrappers run their plain versions, so these tests hold
the arithmetic the kernels copy; the kernels themselves are held to the
plain versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances (differences measured here: out 1.3e-4, dq 2e-5, lse 1e-6, dk
and dv one bf16 ulp):
- out, absolute OUT_ATOL: p is rounded to bf16 before p @ v on both
  sides, and the fp32 scores, summed in another order, can move a p across
  a bf16 rounding; one such flip moves an output by about 2^-8 p |v| / l;
- lse and dq, absolute FP32_ATOL: fp32 throughout, sums in another order
  and delta = sum(do * out) taken from outputs that differ as above;
- dk and dv (bf16, like k and v): one bf16 ulp of the reference value plus
  BF16_ATOL, since both sides round fp32 sums that differ by rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from how_to_optimize_gemm_tpu.ops import pallas_attention as jattn
from how_to_optimize_gemm_tpu_torch import _build, convert
from how_to_optimize_gemm_tpu_torch.ops import attention, vendor

torch.set_num_threads(1)

OUT_ATOL = 1e-3
FP32_ATOL = 1e-4
BF16_ATOL = 1e-3


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16))


def _torch(x, requires_grad=False):
    t = convert.params_from_jax(np.asarray(x), "cpu")
    return t.requires_grad_() if requires_grad else t


def _close(got, ref, atol, what):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    diff = float(np.abs(got - ref).max())
    assert diff <= atol, (what, diff)
    return diff


def _close_bf16(got, ref, what):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert np.all(np.abs(got - ref) <= ulp + BF16_ATOL), (
        what, float(np.abs(got - ref).max()))


def _jax_lse(q, k, v, causal, blk):
    """The reference's lse rows (B, H, S) for S of any length: padded to
    the block outside its kernel as mha_flash_train pads, padded keys
    masked with t_real, the 8-lane trailing dim and padded rows cropped."""
    s = q.shape[2]
    pad = -s % blk
    widths = ((0, 0), (0, 0), (0, pad), (0, 0))
    qp, kp, vp = (jnp.pad(jnp.asarray(x), widths) for x in (q, k, v))
    _, lse = jattn._flash_fwd_lse(qp, kp, vp, causal, blk, blk, True,
                                  t_real=s if pad else None)
    return np.asarray(lse)[:, :, :s, 0]


def _inputs(b, h, kvh, s, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k, v = (_bf16(rng.standard_normal((b, kvh, s, d))) for _ in "kv")
    do = rng.standard_normal((b, h, s, d)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("causal", [True, False])
def test_plain_versions_match_the_reference_kernels(causal):
    """flash_attention_fwd_lse_ref against _flash_fwd_lse (out, lse), and
    the two backward plain versions against _flash_bwd (dq, dk, dv in fp32,
    before the VJP casts them) on the same out, lse and do, at blocks of
    32 over (1, 4, 2, 128, 64)."""
    q, k, v, do = _inputs(1, 4, 2, 128, 64, seed=1)
    out, lse = jattn._flash_fwd_lse(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal, 32, 32, True)
    dq, dk, dv = jattn._flash_bwd(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), out, lse, jnp.asarray(do),
                                  causal, 32, 32, True)
    tq, tk, tv, tdo = (_torch(x) for x in (q, k, v, do))
    got_out, got_lse = attention.flash_attention_fwd_lse_ref(
        tq, tk, tv, causal=causal, bk=32)
    _close(got_out, out, OUT_ATOL, "out")
    _close(got_lse, np.asarray(lse)[..., 0], FP32_ATOL, "lse")
    tout, tlse = _torch(out), _torch(np.asarray(lse)[..., 0])
    delta = (tdo * tout).sum(dim=-1)
    got_dq = attention.flash_attention_bwd_dq_ref(tq, tk, tv, tdo, tlse,
                                                  delta, causal=causal, bk=32)
    got_dk, got_dv = attention.flash_attention_bwd_dkv_ref(
        tq, tk, tv, tdo, tlse, delta, causal=causal, bq=32)
    _close(got_dq, dq, FP32_ATOL, "dq")
    _close(got_dk, dk, FP32_ATOL, "dk")
    _close(got_dv, dv, FP32_ATOL, "dv")
    assert got_dk.dtype == got_dv.dtype == torch.float32
    whole = attention.flash_attention_bwd_ref(tq, tk, tv, tout, tlse, tdo,
                                              causal=causal, bq=32, bk=32)
    for a, b_ in zip(whole, (got_dq, got_dk, got_dv)):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(1, 4, 2, 256, 64), (1, 2, 1, 200, 128)])
def test_fwd_lse_plain_version_matches_jax_at_the_kernel_tile(shape, causal):
    """flash_attention_fwd_lse_ref at the card forward's key tile
    (attention.KERNEL_BK_LSE, which sets where p rounds to bf16) against
    _flash_fwd_lse at the kernel's tiles in interpret mode (KERNEL_BQ
    queries by KERNEL_BK_LSE keys), an S that is no tile multiple padded as
    mha_flash_train pads it."""
    b, h, kvh, s, d = shape
    q, k, v, _ = _inputs(b, h, kvh, s, d, seed=s + d)
    bq, bk = attention.KERNEL_BQ, attention.KERNEL_BK_LSE
    pad = -s % max(bq, bk)
    widths = ((0, 0), (0, 0), (0, pad), (0, 0))
    qp, kp, vp = (jnp.pad(jnp.asarray(x), widths) for x in (q, k, v))
    out, lse = jattn._flash_fwd_lse(qp, kp, vp, causal, bq, bk, True,
                                    t_real=s if pad else None)
    got_out, got_lse = attention.flash_attention_fwd_lse_ref(
        _torch(q), _torch(k), _torch(v), causal=causal, bk=bk)
    _close(got_out, np.asarray(out)[:, :, :s], OUT_ATOL, "out")
    _close(got_lse, np.asarray(lse)[:, :, :s, 0], FP32_ATOL, "lse")


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_train_matches_jax_vjp(causal):
    """FlashAttentionTrain through autograd against jax.vjp of
    flash_attention_train, blocks of 32, (B, H, KVH, S, D) = (1, 4, 2, 128,
    64); q float32, k and v bf16, gradients in their dtypes."""
    q, k, v, w = _inputs(1, 4, 2, 128, 64, seed=2)
    out, vjp = jax.vjp(
        lambda q, k, v: jattn.flash_attention_train(q, k, v, causal, 32, 32,
                                                    True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    gq, gk, gv = vjp(jnp.asarray(w))
    tq, tk, tv = (_torch(x, True) for x in (q, k, v))
    got = attention.flash_attention_train(tq, tk, tv, causal, 32, 32)
    got.backward(_torch(w))
    _close(got, out, OUT_ATOL, "out")
    _close(tq.grad, gq, FP32_ATOL, "dq")
    assert tk.grad.dtype == tv.grad.dtype == torch.bfloat16
    _close_bf16(tk.grad, gk, "dk")
    _close_bf16(tv.grad, gv, "dv")
    _, lse = attention.flash_attention_fwd_lse(tq.detach(), tk.detach(),
                                               tv.detach(), causal=causal,
                                               bk=32)
    _close(lse, _jax_lse(q, k, v, causal, 32), FP32_ATOL, "lse")


# (B, H, KVH, S, D, causal): S that pads to the reference's block (200 and
# 130 to 256) or picks 128 over 512 (640), non-causal, D 128 at rep 1 and 4
MODEL_SHAPES = [(1, 4, 2, 200, 64, True), (1, 4, 2, 130, 64, True),
                (1, 4, 2, 640, 64, True), (1, 4, 2, 200, 64, False),
                (1, 2, 2, 200, 128, True), (1, 4, 1, 200, 128, True)]


@pytest.mark.parametrize("shape", MODEL_SHAPES)
def test_mha_flash_train_matches_jax_vjp(shape):
    """mha_flash_train (model layout, q not rounded, k and v rounded to bf16)
    through autograd against jax.vjp of the reference's, which pads S to
    its least-waste block outside its VJP; the port pads nothing."""
    b, h, kvh, s, d, causal = shape
    rng = np.random.default_rng(sum(shape))
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, kvh, d)).astype(np.float32)
            for _ in "kv")
    w = rng.standard_normal((b, s, h * d)).astype(np.float32)
    out, vjp = jax.vjp(
        lambda q, k, v: jattn.mha_flash_train(q, k, v, causal=causal,
                                              interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    gq, gk, gv = vjp(jnp.asarray(w))
    tq, tk, tv = (_torch(x, True) for x in (q, k, v))
    got = attention.mha_flash_train(tq, tk, tv, causal=causal)
    got.backward(_torch(w))
    assert got.dtype == torch.float32 and got.shape == (b, s, h * d)
    _close(got, out, OUT_ATOL, "out")
    _close(tq.grad, gq, FP32_ATOL, "dq")
    # k and v are rounded to bf16 inside: their gradients are bf16 values
    _close_bf16(tk.grad, gk, "dk")
    _close_bf16(tv.grad, gv, "dv")
    blk = attention.train_block(s)
    qt, kt, vt = (np.swapaxes(x, 1, 2) for x in (q, _bf16(k), _bf16(v)))
    _, lse = attention.flash_attention_fwd_lse(
        _torch(qt), _torch(kt), _torch(vt), causal=causal)
    _close(lse, _jax_lse(qt, kt, vt, causal, blk), FP32_ATOL, "lse")


def test_backward_is_the_plain_backward():
    """On the CPU FlashAttentionTrain's backward is the plain backward as
    written (delta, then the dq and dK/dV passes), not autograd through the
    plain forward."""
    q, k, v, do = (_torch(x) for x in _inputs(1, 4, 2, 96, 64, seed=3))
    tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
    out = attention.flash_attention_train(tq, tk, tv, True)
    out.backward(do)
    _, lse = attention.flash_attention_fwd_lse_ref(q, k, v, causal=True)
    dq, dk, dv = attention.flash_attention_bwd_ref(q, k, v, out.detach(),
                                                   lse, do, causal=True)
    assert torch.equal(tq.grad, dq)
    assert torch.equal(tk.grad, dk.to(torch.bfloat16))
    assert torch.equal(tv.grad, dv.to(torch.bfloat16))
    assert out.grad_fn.name() == "FlashAttentionTrainBackward"


def test_train_block_is_the_least_waste_choice():
    assert [attention.train_block(s) for s in (1024, 512, 640, 200, 130,
                                               384, 100)] == [
        512, 512, 128, 256, 256, 128, 128]


def test_training_wrappers_refuse_what_the_kernels_do_not_take():
    q, k, v, _ = (_torch(x) for x in _inputs(1, 4, 2, 64, 64, seed=4))
    with pytest.raises(ValueError, match="self-attention"):
        attention.flash_attention_train(q, k[:, :, :32], v[:, :, :32])
    with pytest.raises(ValueError, match="d in"):
        attention.flash_attention_train(q[..., :32], k[..., :32],
                                        v[..., :32])
    # off the CPU each kernel takes its own tiles only: the forward's key
    # tile KERNEL_BK_LSE, the backward's KERNEL_BLOCK (meta tensors reach
    # the check without a card; a tile that passes meets the device check)
    qm, km = (x.to("meta") for x in (q, k))
    rows = qm[..., 0]
    fwd, bwd = attention.KERNEL_BK_LSE, attention.KERNEL_BLOCK
    for call, bad, good in (
            (lambda **t: attention.flash_attention_fwd_lse(qm, km, km, **t),
             {"bk": fwd // 2}, {"bk": fwd}),
            (lambda **t: attention.flash_attention_bwd_dq(
                qm, km, km, qm, rows, rows, **t), {"bk": 2 * bwd},
             {"bk": bwd}),
            (lambda **t: attention.flash_attention_bwd_dkv(
                qm, km, km, qm, rows, rows, **t), {"bq": 2 * bwd},
             {"bq": bwd}),
            (lambda **t: attention.flash_attention_train(qm, km, km, **t),
             {"bq": 2 * bwd}, {"bq": bwd})):
        with pytest.raises(ValueError, match="tiles"):
            call(**bad)
        with pytest.raises(RuntimeError, match="CUDA"):
            call(**good)
    if fwd != bwd:   # one bk feeds the forward and the dQ kernel
        for bk in (fwd, bwd):
            with pytest.raises(ValueError, match="tiles"):
                attention.flash_attention_train(qm, km, km, bk=bk)


def test_row_rel_err_floors_rows_that_cancel():
    ref = torch.tensor([[1.0, -2.0], [1e-9, 0.0]])
    out = ref + torch.tensor([[0.0, 0.01], [0.001, 0.0]])
    err = attention.row_rel_err(out, ref)
    assert torch.allclose(err, torch.tensor([0.005, 0.001 / 0.02]))


# ------------------------------------------------ repairs: no lost gradient

def test_kernel_wrappers_without_backward_refuse_gradients():
    """flash_attention and mha_flash have no backward: with grad mode on
    and an operand that requires grad they raise on every device, so a
    gradient cannot vanish silently; without grad they run as before."""
    q, k, v, _ = _inputs(1, 2, 2, 64, 64, seed=5)
    tq = _torch(_bf16(q)).requires_grad_()
    tk, tv = _torch(k), _torch(v)
    with pytest.raises(RuntimeError, match="no backward"):
        attention.flash_attention(tq, tk, tv)
    with pytest.raises(RuntimeError, match="no backward"):
        attention.mha_flash(tq.transpose(1, 2), tk.transpose(1, 2),
                            tv.transpose(1, 2))
    with torch.no_grad():
        attention.flash_attention(tq, tk, tv)
    attention.flash_attention(tq.detach(), tk, tv)


def test_launch_refuses_gradients_before_building():
    """_build.launch, the one place every kernel is launched, checks first:
    it raises for a tensor that requires grad (no nvcc needed to see it)."""
    x = torch.zeros(4, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        _build.launch("kv_update", torch.device("cpu"), x, x, x, None, 1, 1,
                      1, 1)
    _build.require_no_grad("kv_update", x.detach(), 3)
    with torch.no_grad():
        _build.require_no_grad("kv_update", x)


def test_fp32_matmul_keeps_tf32_off_in_its_gradient(monkeypatch):
    """With allow_tf32 set globally, fp32_matmul's backward gives the
    gradients it gives with the flag off, and each of its two products runs
    through the TF32-off product (on the CPU the flag changes no value, so
    this checks the structure; the card test checks the values)."""
    rng = np.random.default_rng(6)
    x0 = torch.from_numpy(rng.standard_normal((3, 5, 16)).astype(np.float32))
    w0 = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((3, 5, 8)).astype(np.float32))
    matmul = torch.backends.cuda.matmul
    grads = {}
    calls = []
    real = vendor._matmul_highest

    def counting(a, b):
        calls.append(matmul.allow_tf32)
        return real(a, b)
    monkeypatch.setattr(vendor, "_matmul_highest", counting)
    saved = (matmul.allow_tf32, torch.get_float32_matmul_precision())
    try:
        for flag in (False, True):
            matmul.allow_tf32 = flag
            x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
            calls.clear()
            vendor.fp32_matmul(x, w).backward(g)
            assert len(calls) == 3 and matmul.allow_tf32 == flag
            grads[flag] = (x.grad, w.grad)
    finally:
        matmul.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])
    assert torch.equal(grads[True][0], grads[False][0])
    assert torch.equal(grads[True][1], grads[False][1])
    assert torch.allclose(grads[False][0], g @ w0.t(), atol=1e-5)
    assert torch.allclose(grads[False][1],
                          x0.reshape(-1, 16).t() @ g.reshape(-1, 8),
                          atol=1e-4)
