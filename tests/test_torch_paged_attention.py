"""Port parity: decode attention through a block table against the JAX
package's.

The same numpy q, page pools and shuffled block table go through
``pallas_paged_attention.paged_decode_attention`` and
``paged_decode_attention_q8`` (Pallas in interpret mode) and the port's
functions on the CPU (their plain versions: ``decode_attention``'s chunk
walk with one page a chunk), at a fused-head (v4) width, kvh 2 rep 2
d 128, and a per-slot (v3) width, kvh 16 d 128, with pages of 16 tokens,
np_max 4 and lengths 1, 40, 64 and 0 (a free slot, whose table row is all
zeros, reads nothing). The KV8 scale pools are (NP, PS, KVH) in the port
and lane-padded to (NP, PS, 128) in the reference, so the reference's
are padded and the port's are the crop.

Tolerance: both walk the same pages with an fp32 online softmax; they
differ in summation order and in exp, and a p (or p * sv) on a bf16
rounding boundary can round the other way before the PV product: atol
5e-4, as for the contiguous kernels (``test_torch_decode_attention.py``).
``gather_paged`` and ``good_page_size`` are EQUAL to the reference's.

The card's kernels, bf16 and KV8, walk each slot in splits of whole pages
and combine the splits' partial sums (``csrc/decode_attention.cuh``'s
split walk); ``_split_walk`` below models that arithmetic in plain
PyTorch, held against the plain paged walk and the JAX kernel: the KV8
pool at pages of 16, the bf16 pool at the 7B pool's pages of 128 (splits
of one page, of two, the S-paged plan ``paged_split_plan(32, 128)``, and
of the whole table). A split rounds p (KV8: p * sv) to bf16 against its
own running max, not the slot's, so the two walks round each PV operand
at other points: each rounding is within 2^-8 of its operand, so an
output differs by at most 2^-7 of the softmax-weighted sum of |v|
(dequantized) over its slot's keys, plus fp32 slack
(``_rounding_bound``). That per-element bound is the rule; the card's
rule for the kernels, DECODE_ATOL = 2e-3 (absolute; ``chip_smoke.py``),
is a statistical one: at 64-key slots the model's largest difference ran
0.5e-3 to 2.1e-3 over 49 seeds, splits of two pages crossing it at one of
them (kvh 16 below). The split's length comes from np_max and PS alone
(``paged_split_plan``), never from the lengths.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from how_to_optimize_gemm_tpu.ops import pallas_paged_attention as jpa
from how_to_optimize_gemm_tpu_torch import convert
from how_to_optimize_gemm_tpu_torch.models import llama
from how_to_optimize_gemm_tpu_torch.ops import paged_attention as pa

torch.set_num_threads(1)

PS, NP_MAX, D = 16, 4, 128
LENGTHS = [1, 40, 64, 0]
ATOL = 5e-4
DECODE_ATOL = 2e-3
WIDTHS = [(2, 2), (16, 1)]          # (kvh, rep): v4, v3


def _table(seed):
    """Each live slot's pages drawn from a shuffled pool of pages
    1 .. NP-1; chunks past a slot's length stay 0 (unallocated)."""
    rng = np.random.default_rng(seed)
    n_pages = len(LENGTHS) * NP_MAX + 1
    free = list(rng.permutation(np.arange(1, n_pages)))
    table = np.zeros((len(LENGTHS), NP_MAX), np.int32)
    for b, n in enumerate(LENGTHS):
        for c in range(-(-n // PS)):
            table[b, c] = free.pop()
    return n_pages, table


def _q_and_table(kvh, rep, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((len(LENGTHS), kvh * rep, D)).astype(np.float32)
    n_pages, table = _table(seed)
    return rng, q, n_pages, table


def _check(got, ref, width):
    assert got.shape == (len(LENGTHS), width * D)
    assert got.dtype == torch.float32
    err = float(np.max(np.abs(got.numpy() - ref)))
    print(f"max |port - jax| = {err:.3e}")
    assert err < ATOL, err
    assert torch.equal(got[3], torch.zeros_like(got[3]))    # length 0


@pytest.mark.parametrize("kvh,rep", WIDTHS)
def test_paged_decode_attention_matches_jax(kvh, rep):
    rng, q, n_pages, table = _q_and_table(kvh, rep, kvh)
    k, v = (jnp.asarray(rng.standard_normal((n_pages, PS, kvh, D)),
                        jnp.bfloat16) for _ in "kv")
    lengths = np.asarray(LENGTHS, np.int32)
    ref = np.asarray(jpa.paged_decode_attention(
        jnp.asarray(q), k, v, jnp.asarray(table), jnp.asarray(lengths),
        interpret=True))
    tk, tv = (convert.params_from_jax(np.asarray(x), "cpu") for x in (k, v))
    got = pa.paged_decode_attention(torch.from_numpy(q), tk, tv,
                                    torch.from_numpy(table),
                                    torch.from_numpy(lengths))
    _check(got, ref, kvh * rep)


@pytest.mark.parametrize("kvh,rep", WIDTHS)
def test_paged_decode_attention_q8_matches_jax(kvh, rep):
    rng, q, n_pages, table = _q_and_table(kvh, rep, 10 + kvh)
    pools = []
    for _ in "kv":
        x = torch.from_numpy(rng.standard_normal(
            (n_pages, PS, kvh, D)).astype(np.float32))
        pools += llama.quantize_kv(x)
    jpools = [jnp.asarray(p.numpy()) if i % 2 == 0 else jnp.asarray(
        np.pad(p.numpy(), ((0, 0), (0, 0), (0, 128 - kvh))))
        for i, p in enumerate(pools)]
    lengths = np.asarray(LENGTHS, np.int32)
    ref = np.asarray(jpa.paged_decode_attention_q8(
        jnp.asarray(q), *jpools, jnp.asarray(table), jnp.asarray(lengths),
        interpret=True))
    # the port's pools are the crop of the reference's
    back = convert.paged_cache_from_jax([[np.asarray(p) for p in jpools]],
                                        "cpu")[0]
    assert all(torch.equal(a, b) for a, b in zip(back, pools))
    got = pa.paged_decode_attention_q8(torch.from_numpy(q), *pools,
                                       torch.from_numpy(table),
                                       torch.from_numpy(lengths))
    _check(got, ref, kvh * rep)


def test_paged_equals_contiguous_on_the_same_rows():
    """Through the table, a slot reads what the contiguous chunk walk
    reads from gather_paged's copy of its pages, chunk for page."""
    from how_to_optimize_gemm_tpu_torch.ops import decode_attention as da
    rng, q, n_pages, table = _q_and_table(2, 2, 3)
    k, v = (torch.from_numpy(rng.standard_normal(
        (n_pages, PS, 2, D)).astype(np.float32)).to(torch.bfloat16)
        for _ in "kv")
    t = torch.from_numpy(table)
    lengths = torch.tensor(LENGTHS)
    got = pa.paged_decode_attention(torch.from_numpy(q), k, v, t, lengths)
    ref = da._chunk_walk(torch.from_numpy(q), pa.gather_paged(k, t),
                         pa.gather_paged(v, t), lengths, PS)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("trailing", [(2, D), (2,)])
def test_gather_paged_equals_jax(trailing):
    rng = np.random.default_rng(5)
    n_pages, table = _table(5)
    pool = rng.standard_normal((n_pages, PS, *trailing)).astype(np.float32)
    ref = np.asarray(jpa.gather_paged(jnp.asarray(pool), jnp.asarray(table)))
    got = pa.gather_paged(torch.from_numpy(pool), torch.from_numpy(table))
    assert got.shape == (len(LENGTHS), NP_MAX * PS, *trailing)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_good_page_size_equals_jax():
    """The reference's VMEM rule, kept for its tables: 128 tokens for a
    Llama-2-7B bf16 pool, 384 for its KV8 pool, 512 for small GQA."""
    assert pa.good_page_size(32, 128, 2) == 128
    assert pa.good_page_size(32, 128, 1) == 384
    for kvh, d, itemsize in [(32, 128, 2), (32, 128, 1), (2, 128, 2),
                             (4, 64, 2), (8, 128, 1), (16, 64, 2),
                             (64, 128, 2)]:
        assert pa.good_page_size(kvh, d, itemsize) == jpa.good_page_size(
            kvh, d, itemsize), (kvh, d, itemsize)


def test_paged_attention_refuses_other_devices():
    q = torch.zeros((1, 2, D), device="meta")
    pool = torch.zeros((3, PS, 2, D), dtype=torch.bfloat16, device="meta")
    table = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError):
        pa.paged_decode_attention(q, pool, pool, table,
                                  torch.ones(1, dtype=torch.int32,
                                             device="meta"))


def _split_walk(q, k, v, table, lengths, per, sk=None, sv=None):
    """A model of the kernels' split walk: each run of ``per`` pages of a
    slot walked alone by the plain walk's arithmetic (from m = -1e30,
    l = 0, o = 0; for KV8 the scores times sk and the PV operand bf16(p *
    sv), for bf16 the operand bf16(p)), only the rows below the slot's
    length read; the runs' (m, l, o) then combined in run order: m* = max
    m, l* = sum l exp(m - m*), o* = sum o exp(m - m*), out = o* /
    max(l*, 1e-30); a slot of length 0 is zeros. Page c of slot b is
    min(table[b, c], NP - 1)."""
    b, h, d = q.shape
    n_pages, ps, kvh, _ = k.shape
    rep = h // kvh
    qg = q.reshape(b, kvh, rep, d).to(torch.float32) * d ** -0.5
    out = torch.zeros((b, kvh, rep, d))
    for bi, length in enumerate(lengths):
        nk = min(-(-length // ps), table.shape[1])
        parts = []
        for c0 in range(0, nk, per):
            m = torch.full((kvh, rep, 1), -1e30)
            l = torch.zeros((kvh, rep, 1))
            o = torch.zeros((kvh, rep, d))
            for c in range(c0, min(c0 + per, nk)):
                page = min(int(table[bi, c]), n_pages - 1)
                rows = min(ps, length - c * ps)
                kb = k[page, :rows].to(torch.float32)
                s = torch.einsum("grd,tgd->grt", qg[bi], kb)
                if sk is not None:
                    s = s * sk[page, :rows].t()[:, None, :]
                m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new)
                l = l * alpha + p.sum(dim=-1, keepdim=True)
                if sv is not None:
                    p = p * sv[page, :rows].t()[:, None, :]
                p = p.to(torch.bfloat16)
                pv = torch.einsum("grt,tgd->grd", p.to(torch.float32),
                                  v[page, :rows].to(torch.float32))
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


def _rounding_bound(q, k, v, table, lengths, sk=None, sv=None):
    """Per output element, 2^-7 of the softmax-weighted sum of |v| over
    the slot's keys (in fp64, K and V dequantized) plus 1e-5: how far two
    walks that round each PV operand to bf16 at other scales can differ."""
    b, h, d = q.shape
    n_pages, ps, kvh, _ = k.shape
    rep = h // kvh
    qg = q.reshape(b, kvh, rep, d).double() * d ** -0.5
    out = torch.zeros((b, kvh, rep, d), dtype=torch.float64)
    for bi, n in enumerate(lengths):
        pages = [min(int(table[bi, c]), n_pages - 1)
                 for c in range(-(-n // ps))]
        if not pages:
            continue

        def rows(x, s):
            r = torch.cat([x[p] for p in pages])[:n].double()
            if s is None:
                return r
            return r * torch.cat([s[p] for p in pages])[:n, :, None]
        w = torch.softmax(torch.einsum("grd,tgd->grt", qg[bi],
                                       rows(k, sk)), -1)
        out[bi] = torch.einsum("grt,tgd->grd", w, rows(v, sv).abs())
    return (2.0 ** -7 * out + 1e-5).reshape(b, h * d).float()


def _q8_case(kvh, rep, lengths, seed):
    """numpy q, the port's KV8 pools and the reference's lane-padded
    ones, and a shuffled table of NP_MAX pages a slot."""
    rng = np.random.default_rng(seed)
    n_pages = len(lengths) * NP_MAX + 1
    free = list(rng.permutation(np.arange(1, n_pages)))
    table = np.zeros((len(lengths), NP_MAX), np.int32)
    for b, n in enumerate(lengths):
        for c in range(-(-n // PS)):
            table[b, c] = free.pop()
    q = rng.standard_normal((len(lengths), kvh * rep, D)).astype(np.float32)
    pools = []
    for _ in "kv":
        pools += llama.quantize_kv(torch.from_numpy(rng.standard_normal(
            (n_pages, PS, kvh, D)).astype(np.float32)))
    jpools = [jnp.asarray(p.numpy()) if i % 2 == 0 else jnp.asarray(
        np.pad(p.numpy(), ((0, 0), (0, 0), (0, 128 - kvh))))
        for i, p in enumerate(pools)]
    return q, pools, jpools, table


# slots of length 0, 1, a page boundary, one past it and the table's full
# length; splits of one page (the 7B pool's, PS 384 > SPLIT_KEYS), two, and
# the plan's at these pages (all NP_MAX pages in one split)
SPLIT_LENGTHS = [0, 1, PS, PS + 1, NP_MAX * PS]


@pytest.mark.parametrize("per", sorted({1, 2, pa.paged_split_plan(
    NP_MAX, PS)[0]}))
@pytest.mark.parametrize("kvh,rep", WIDTHS)
def test_split_walk_q8_matches_plain_walk_and_jax(kvh, rep, per):
    q, pools, jpools, table = _q8_case(kvh, rep, SPLIT_LENGTHS,
                                       20 + kvh + per)
    tq, tt = torch.from_numpy(q), torch.from_numpy(table)
    lengths = np.asarray(SPLIT_LENGTHS, np.int32)
    qk, sk, qv, sv = pools
    got = _split_walk(tq, qk, qv, tt, SPLIT_LENGTHS, per, sk, sv)
    plain = pa.paged_decode_attention_q8_ref(tq, *pools, tt,
                                             torch.from_numpy(lengths))
    ref = np.asarray(jpa.paged_decode_attention_q8(
        jnp.asarray(q), *jpools, jnp.asarray(table), jnp.asarray(lengths),
        interpret=True))
    bound = _rounding_bound(tq, qk, qv, tt, SPLIT_LENGTHS, sk, sv)
    err_plain = (got - plain).abs()
    err_jax = (got - torch.tensor(ref)).abs()
    print(f"kvh={kvh} rep={rep} per={per}: split walk vs plain "
          f"{float(err_plain.max()):.3e} (DECODE_ATOL {DECODE_ATOL}), "
          f"{float((err_plain / bound).max()):.3f} of the rounding bound; "
          f"vs jax {float(err_jax.max()):.3e}")
    assert (err_plain <= bound).all()
    assert (err_jax <= bound + ATOL).all()
    assert not got[0].any()
    # one page: one split, no combine
    assert torch.equal(got[1], plain[1]) and torch.equal(got[2], plain[2])


# the bf16 pool at the 7B pool's pages of 128: slots of length 0, 1, a
# page boundary, one past it, 300 and the table's full 512
PS_7B, NP_MAX_7B = 128, 4
SPLIT_LENGTHS_7B = [0, 1, 128, 129, 300, NP_MAX_7B * PS_7B]


@pytest.mark.parametrize("per", sorted({1, 2, NP_MAX_7B, pa.paged_split_plan(
    32, PS_7B)[0], pa.paged_split_plan(NP_MAX_7B, PS_7B)[0]}))
@pytest.mark.parametrize("kvh,rep", WIDTHS)
def test_split_walk_matches_plain_walk_and_jax(kvh, rep, per):
    rng = np.random.default_rng(30 + kvh + per)
    lens = SPLIT_LENGTHS_7B
    n_pages = len(lens) * NP_MAX_7B + 1
    free = list(rng.permutation(np.arange(1, n_pages)))
    table = np.zeros((len(lens), NP_MAX_7B), np.int32)
    for b, n in enumerate(lens):
        for c in range(-(-n // PS_7B)):
            table[b, c] = free.pop()
    q = rng.standard_normal((len(lens), kvh * rep, D)).astype(np.float32)
    k, v = (jnp.asarray(rng.standard_normal((n_pages, PS_7B, kvh, D)),
                        jnp.bfloat16) for _ in "kv")
    tk, tv = (convert.params_from_jax(np.asarray(x), "cpu") for x in (k, v))
    tq, tt = torch.from_numpy(q), torch.from_numpy(table)
    lengths = np.asarray(lens, np.int32)
    got = _split_walk(tq, tk, tv, tt, lens, per)
    plain = pa.paged_decode_attention_ref(tq, tk, tv, tt,
                                          torch.from_numpy(lengths))
    ref = np.asarray(jpa.paged_decode_attention(
        jnp.asarray(q), k, v, jnp.asarray(table), jnp.asarray(lengths),
        interpret=True))
    bound = _rounding_bound(tq, tk, tv, tt, lens)
    err_plain = (got - plain).abs()
    err_jax = (got - torch.tensor(ref)).abs()
    print(f"kvh={kvh} rep={rep} per={per}: split walk vs plain "
          f"{float(err_plain.max()):.3e} (DECODE_ATOL {DECODE_ATOL}), "
          f"{float((err_plain / bound).max()):.3f} of the rounding bound; "
          f"vs jax {float(err_jax.max()):.3e}")
    assert (err_plain <= bound).all()
    assert (err_jax <= bound + ATOL).all()
    assert not got[0].any()
    # one page: one split, no combine
    assert torch.equal(got[1], plain[1]) and torch.equal(got[2], plain[2])


def test_paged_split_plan_depends_on_np_max_and_ps_only(monkeypatch):
    """The KV8 kernel's grid and workspace: splits of whole pages, one
    page a split where a page passes SPLIT_KEYS (the 7B pool: 11 pages of
    384, 11 splits); the wrapper's launch takes the same plan, workspace
    and arguments at any lengths (meta tensors, the launch recorded)."""
    from how_to_optimize_gemm_tpu_torch import _build
    from how_to_optimize_gemm_tpu_torch.ops import decode_attention as da
    assert pa.paged_split_plan(11, 384) == (1, 11)
    assert pa.paged_split_plan(32, 128) == (2, 16)
    assert pa.paged_split_plan(NP_MAX, PS) == (16, 1)
    assert pa.paged_split_plan(11, 96) == (2, 6)
    for np_max, ps in ((11, 384), (5, 128), (7, 96), (1, 16)):
        per, splits = pa.paged_split_plan(np_max, ps)
        assert (per, splits) == da.split_plan(np_max * ps, ps)
        assert (splits - 1) * per < np_max <= splits * per
    calls = []
    monkeypatch.setattr(pa, "require_cuda", lambda name, x: None)
    ws = (torch.zeros(1, dtype=torch.int32, device="meta"),
          torch.zeros(1, device="meta"))
    monkeypatch.setattr(pa, "_workspace", lambda dev, n_count, n_part, name:
                        calls.append((n_count, n_part)) or ws)
    monkeypatch.setattr(_build, "launch", lambda name, dev, *args:
                        calls.append((name, *(a for a in args if not
                                              isinstance(a, torch.Tensor)))))
    kvh, rep, ps, np_max, b = 32, 1, 384, 11, 4
    meta = dict(device="meta")
    q = torch.zeros((b, kvh * rep, D), **meta)
    qk = torch.zeros((b * np_max + 1, ps, kvh, D), dtype=torch.int8, **meta)
    sk = torch.zeros(qk.shape[:3], **meta)
    table = torch.zeros((b, np_max), dtype=torch.int32, **meta)
    for lens in ([1, 300, 1000, 4096], [0, 0, 0, 0], [4224, 1, 2, 3]):
        pa.paged_decode_attention_q8(q, qk, sk, qk, sk, table, lens)
    assert len(calls) == 6 and calls[0::2] == [calls[0]] * 3
    assert calls[1::2] == [calls[1]] * 3
    assert calls[0] == (b * kvh, b * kvh * 11 * rep * (D + 2))
    assert calls[1] == ("paged_decode_attention_q8", b, b * np_max + 1, ps,
                        np_max, kvh, rep, D, 1, D ** -0.5)
