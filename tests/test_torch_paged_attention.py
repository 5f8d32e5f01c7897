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
