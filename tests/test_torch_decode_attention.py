"""Port parity: length-aware decode attention against the JAX package's.

The same numpy q and bf16 caches go through
``pallas_decode_attention.decode_attention`` (Pallas in interpret mode)
and the port's ``decode_attention`` on the CPU (its plain version), at a
fused-head (v4) width, kvh=2 rep=2 d=128, and a per-slot (v3) width,
kvh=16 d=128, with T=256, bk=128 and lengths {1, 129, 256}.

Tolerance: both walk the same chunks with an fp32 online softmax; they
differ in summation order and in exp, and a p that lands on a bf16
rounding boundary can round the other way before the PV product (one
such flip moves an output by about p * |v| * 2^-8; the largest
difference seen here is 7.6e-5, at the v3 width). The JAX package holds
this kernel to atol 3e-2 (``tests/test_decode_attention.py``); the port
is held to 5e-4.

The card's kernels walk each slot in splits of whole chunks and combine
the splits' partial sums (``csrc/decode_attention.cuh``); ``_split_walk``
below models that arithmetic in plain PyTorch, held to the card's rule
for the kernel, DECODE_ATOL = 2e-3 (``chip_smoke.py``), against the plain
walk and the JAX kernel: a split rounds p to bf16 against its own running
max, not the slot's. For the KV8 cache (``decode_attention_q8``: scores
times sk, the PV operand bf16(p * sv)) the model is held to the plain walk
and to JAX's ``decode_attention_q8`` (interpret mode) within the rounding
bound of the PV operand, ``_rounding_bound``: each operand rounds within
2^-8 of itself, so two walks that round at other scales differ by at most
2^-7 of the softmax-weighted sum of |v| (dequantized) over the slot's keys,
plus fp32 slack.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from how_to_optimize_gemm_tpu.ops import pallas_decode_attention as jda
from how_to_optimize_gemm_tpu_torch import convert
from how_to_optimize_gemm_tpu_torch.models import llama
from how_to_optimize_gemm_tpu_torch.ops import decode_attention as da

torch.set_num_threads(1)

T, D, BK = 256, 128, 128
LENGTHS = [1, 129, 256]
ATOL = 5e-4
DECODE_ATOL = 2e-3


def _inputs(kvh, rep, seed):
    rng = np.random.default_rng(seed)
    b = len(LENGTHS)
    q = rng.standard_normal((b, kvh * rep, D)).astype(np.float32)
    k, v = (jnp.asarray(rng.standard_normal((b, T, kvh, D)), jnp.bfloat16)
            for _ in "kv")
    return q, k, v


@pytest.mark.parametrize("kvh,rep", [(2, 2), (16, 1)])
def test_decode_attention_matches_jax(kvh, rep):
    q, k, v = _inputs(kvh, rep, kvh)
    lengths = np.asarray(LENGTHS, np.int32)
    ref = np.asarray(jda.decode_attention(jnp.asarray(q), k, v,
                                          jnp.asarray(lengths), bk=BK,
                                          interpret=True))
    tk, tv = (convert.params_from_jax(np.asarray(x), "cpu") for x in (k, v))
    got = da.decode_attention(torch.from_numpy(q), tk, tv,
                              torch.from_numpy(lengths), bk=BK)
    assert got.shape == (len(LENGTHS), kvh * rep * D)
    assert got.dtype == torch.float32
    err = float(np.max(np.abs(got.numpy() - ref)))
    print(f"kvh={kvh} rep={rep}: max |port - jax| = {err:.3e}")
    assert err < ATOL, err


def test_block_choice_follows_the_reference():
    """The reference wrapper's chunk: bk capped by its 6 MB budget for
    two ping-pong chunks of K and V, then the largest 128-multiple that
    divides T."""
    assert da.pick_block(4096, 32, 128, 2) == 128        # Llama-2-7B
    assert da.pick_block(4096, 8, 128, 2) == 512         # GQA kvh=8
    assert da.pick_block(256, 2, 128, 2, bk=128) == 128
    assert da.pick_block(2048, 4, 64, 2, bk=384) == 256  # 384 does not divide
    assert da.pick_block(100, 2, 64, 2) == 100           # no 128-multiple


def test_matches_eager_masked_attention():
    """The chunk walk computes the eager masked attention the model runs
    on the CPU (``llama._attention``), to the JAX test's atol 3e-2."""
    q, k, v = _inputs(2, 2, 3)
    tk, tv = (convert.params_from_jax(np.asarray(x), "cpu") for x in (k, v))
    tq = torch.from_numpy(q)
    lengths = torch.tensor(LENGTHS)
    valid = torch.arange(T)[None, None, :] < lengths[:, None, None]
    eager = llama._attention(tq[:, None], tk, tv, valid)[:, 0]
    got = da.decode_attention(tq, tk, tv, lengths, bk=BK)
    assert float((got - eager).abs().max()) < 3e-2


def test_zero_length_slot_is_zero():
    q, k, v = _inputs(2, 1, 4)
    tk, tv = (convert.params_from_jax(np.asarray(x), "cpu") for x in (k, v))
    got = da.decode_attention(torch.from_numpy(q), tk, tv,
                              torch.tensor([0, 5, 0]), bk=BK)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert torch.equal(got[2], torch.zeros_like(got[2]))


def test_decode_attention_refuses_other_devices():
    q = torch.zeros((1, 2, D), device="meta")
    c = torch.zeros((1, T, 2, D), dtype=torch.bfloat16, device="meta")
    with pytest.raises(RuntimeError):
        da.decode_attention(q, c, c, torch.ones(1, dtype=torch.int32,
                                                device="meta"))


def _split_walk(q, k, v, lengths, bk, per, sk=None, sv=None):
    """A model of the kernels' split walk: each run of ``per`` chunks of a
    slot walked alone by the plain walk's arithmetic (from m = -1e30,
    l = 0, o = 0; for the KV8 cache, sk and sv (B, T, KVH), scores times
    sk and the PV operand bf16(p * sv) of the rows below the length), the
    runs' (m, l, o) then combined in run order: m* = max m, l* = sum l
    exp(m - m*), o* = sum o exp(m - m*), out = o* / max(l*, 1e-30); a slot
    of length 0 is zeros."""
    b, h, d = q.shape
    kvh = k.shape[2]
    rep = h // kvh
    qg = q.reshape(b, kvh, rep, d).to(torch.float32) * d ** -0.5
    out = torch.zeros((b, kvh, rep, d))
    for bi, length in enumerate(lengths):
        nk = -(-length // bk)
        parts = []
        for c0 in range(0, nk, per):
            m = torch.full((kvh, rep, 1), da.NEG_INF)
            l = torch.zeros((kvh, rep, 1))
            o = torch.zeros((kvh, rep, d))
            for c in range(c0, min(c0 + per, nk)):
                rows = slice(c * bk, (c + 1) * bk)
                kb = k[bi, rows].to(torch.float32)
                s = torch.einsum("grd,tgd->grt", qg[bi], kb)
                if sk is not None:
                    s = s * sk[bi, rows].t()[:, None, :]
                live = c * bk + torch.arange(kb.shape[0]) < length
                s = s.masked_fill(~live, da.NEG_INF)
                m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new)
                l = l * alpha + p.sum(dim=-1, keepdim=True)
                if sv is not None:
                    p = torch.where(live, p * sv[bi, rows].t()[:, None, :],
                                    0.0)
                vb = v[bi, rows].to(torch.float32)
                pv = torch.einsum("grt,tgd->grd",
                                  p.to(torch.bfloat16).to(torch.float32), vb)
                o = o * alpha + pv
                m = m_new
            parts.append((m, l, o))
        if not parts:
            continue
        m_all = torch.stack([pm for pm, _, _ in parts]).amax(0)
        l_all = sum(pl * torch.exp(pm - m_all) for pm, pl, _ in parts)
        o_all = sum(po * torch.exp(pm - m_all) for pm, _, po in parts)
        out[bi] = o_all / torch.clamp_min(l_all, 1e-30)
    return out.reshape(b, h * d)


def _torch_inputs(kvh, rep, lengths, seed):
    rng = np.random.default_rng(seed)
    b = len(lengths)
    q = rng.standard_normal((b, kvh * rep, D)).astype(np.float32)
    k, v = (torch.from_numpy(rng.standard_normal((b, T, kvh, D)).astype(
        np.float32)).to(torch.bfloat16) for _ in "kv")
    return q, k, v


@pytest.mark.parametrize("kvh,rep", [(2, 2), (16, 1)])
def test_split_walk_matches_plain_walk_and_jax(kvh, rep):
    """One chunk a split (two splits at T = 256, bk = 128, the reference's
    chunk): slots of length 0, 1, the first split's last key, the second
    split's first key and T, against the plain walk and the JAX kernel in
    interpret mode."""
    lengths = [0, 1, BK, BK + 1, T]
    q, k, v = _torch_inputs(kvh, rep, lengths, 5 + kvh)
    tl = torch.tensor(lengths)
    got = _split_walk(torch.from_numpy(q), k, v, lengths, BK, 1)
    plain = da.decode_attention_ref(torch.from_numpy(q), k, v, tl, bk=BK)
    jk, jv = (jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (k, v))
    ref = np.asarray(jda.decode_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(np.asarray(lengths, np.int32)),
        bk=BK, interpret=True))
    err_plain = float((got - plain).abs().max())
    err_jax = float(np.max(np.abs(got.numpy() - ref)))
    print(f"kvh={kvh} rep={rep}: split walk vs plain {err_plain:.3e}, vs "
          f"jax {err_jax:.3e}")
    assert err_plain < DECODE_ATOL and err_jax < DECODE_ATOL
    assert not got[0].any()


@pytest.mark.parametrize("per", [1, 2, 3])
def test_split_walk_at_many_splits(per):
    """Chunks of 32 keys (eight at T = 256), splits of 1, 2 and 3 of them,
    the last one short for 3; slots at 0, 1, a split boundary, one past it
    and T, against the plain walk at the same chunk."""
    bk = 32
    lengths = [0, 1, per * bk, per * bk + 1, T]
    q, k, v = _torch_inputs(2, 2, lengths, 11 + per)
    q = torch.from_numpy(q)
    got = _split_walk(q, k, v, lengths, bk, per)
    plain = da._chunk_walk(q, k, v, torch.tensor(lengths), bk)
    err = float((got - plain).abs().max())
    print(f"per={per}: split walk vs plain {err:.3e}")
    assert err < DECODE_ATOL
    assert torch.equal(got[1], plain[1])   # one key: one split, no combine


def _rounding_bound(q, qk, sk, qv, sv, lengths):
    """Per output element, 2^-7 of the softmax-weighted sum of |v| over
    the slot's keys (in fp64, K and V dequantized) plus 1e-5: how far two
    walks that round each PV operand to bf16 at other scales can differ."""
    b, h, d = q.shape
    kvh = qk.shape[2]
    qg = q.reshape(b, kvh, h // kvh, d).double() * d ** -0.5
    out = torch.zeros((b, kvh, h // kvh, d), dtype=torch.float64)
    for bi, n in enumerate(lengths):
        if n == 0:
            continue

        def rows(x, s):
            return x[bi, :n].double() * s[bi, :n, :, None]
        w = torch.softmax(torch.einsum("grd,tgd->grt", qg[bi],
                                       rows(qk, sk)), -1)
        out[bi] = torch.einsum("grt,tgd->grd", w, rows(qv, sv).abs())
    return (2.0 ** -7 * out + 1e-5).reshape(b, h * d).float()


@pytest.mark.parametrize("per", [1, 2])
@pytest.mark.parametrize("kvh,rep,d", [(2, 2, 64), (16, 1, 128)])
def test_split_walk_q8_matches_plain_walk_and_jax(kvh, rep, d, per):
    """``decode_attention_q8``'s split walk over the contiguous KV8 cache:
    one chunk a split (two splits at T = 256, bk = 128) and two (one
    split, the plan's: ``split_plan(256, 128)``); slots of length 0, 1,
    the first split's last key, the second split's first key and T,
    against the plain walk and the JAX kernel in interpret mode, within
    the rounding bound."""
    lengths = [0, 1, BK, BK + 1, T]
    rng = np.random.default_rng(30 + kvh + per)
    q = torch.from_numpy(rng.standard_normal(
        (len(lengths), kvh * rep, d)).astype(np.float32))
    cache = []
    for _ in "kv":
        cache += llama.quantize_kv(torch.from_numpy(rng.standard_normal(
            (len(lengths), T, kvh, d)).astype(np.float32)))
    qk, sk, qv, sv = cache
    tl = torch.tensor(lengths)
    got = _split_walk(q, qk, qv, lengths, BK, per, sk, sv)
    plain = da.decode_attention_q8_ref(q, *cache, tl, bk=BK)
    pad = ((0, 0), (0, 0), (0, 128 - kvh))
    jcache = [jnp.asarray(x.numpy()) if i % 2 == 0
              else jnp.asarray(np.pad(x.numpy(), pad))
              for i, x in enumerate(cache)]
    ref = np.asarray(jda.decode_attention_q8(
        jnp.asarray(q.numpy()), *jcache,
        jnp.asarray(np.asarray(lengths, np.int32)), bk=BK, interpret=True))
    bound = _rounding_bound(q, *cache, lengths)
    err_plain = (got - plain).abs()
    err_jax = (got - torch.tensor(ref)).abs()
    print(f"kvh={kvh} rep={rep} d={d} per={per}: split walk vs plain "
          f"{float(err_plain.max()):.3e} (DECODE_ATOL {DECODE_ATOL}), "
          f"{float((err_plain / bound).max()):.3f} of the rounding bound; "
          f"vs jax {float(err_jax.max()):.3e}")
    assert (err_plain <= bound).all()
    assert (err_jax <= bound + ATOL).all()
    assert not got[0].any()
    # one chunk: one split, no combine
    assert torch.equal(got[1], plain[1]) and torch.equal(got[2], plain[2])


def test_split_plan_depends_on_t_and_bk_only():
    """The kernel's grid: splits of SPLIT_KEYS keys of whole chunks, at
    least one chunk; the 7B cache at both of the reference's chunks."""
    assert da.split_plan(4096, 128) == (2, 16)   # kvh 32: 736 live blocks
    assert da.split_plan(4096, 512) == (1, 8)    # kvh 8
    assert da.split_plan(256, 128) == (2, 1)
    assert da.split_plan(300, 100) == (2, 2)
    for t, bk in ((4096, 128), (1024, 512), (100, 100)):
        per, splits = da.split_plan(t, bk)
        assert per * bk >= min(da.SPLIT_KEYS, bk)
        assert (splits - 1) * per * bk < t <= splits * per * bk
