"""The flash dQ kernel's arithmetic and walk on the CPU, against the JAX
package.

``csrc/flash_attention_bwd_dq.cu`` runs only on the card. Its sums are
modelled here in torch (``dq_model``): key tiles of ``KERNEL_BLOCK`` keys
in order, q times scale, do and ds each split into bf16 hi + lo, the two
halves' products added into one fp32 sum, p = 2^(s log2(e) - lse log2(e)),
and dq times scale at the end. The model is held to the reference's
``_flash_bwd`` dq (Pallas in interpret mode, as
``tests/test_torch_flash_train.py`` runs it; an S that is no block multiple
padded as ``mha_flash_train`` pads it) within ``TRAIN_GRAD_REL`` of each
row's max, the bound the card holds the kernel to against its plain
version. The persistent walk's description (``attention.dq_walk``) must
visit every (query tile, head, batch) once, longest causal rows first, on
the tiles the source declares.
"""
import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from how_to_optimize_gemm_tpu.ops import pallas_attention as jattn
from how_to_optimize_gemm_tpu_torch import _build, convert
from how_to_optimize_gemm_tpu_torch.ops import attention

torch.set_num_threads(1)

TRAIN_GRAD_REL = 2e-3
LOG2E = np.float32(1.4426950408889634)
SOURCE = "flash_attention_bwd_dq.cu"


def _split(x: torch.Tensor, lo: bool = True):
    """fp32 x as bf16 hi = bf16(x) and lo = bf16(x - hi), back in fp32 (lo
    zero when not ``lo``)."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    if not lo:
        return hi, torch.zeros_like(x)
    return hi, (x - hi).to(torch.bfloat16).to(torch.float32)


def _nt(a: torch.Tensor, b: torch.Tensor, lo: bool) -> torch.Tensor:
    """(a_hi + a_lo) b^T: both halves' products into one fp32 sum."""
    hi, low = _split(a, lo)
    return hi @ b.transpose(-1, -2) + low @ b.transpose(-1, -2)


def dq_model(q, k, v, do, lse, delta, *, causal: bool, bk: int,
             lo: bool = True):
    """dq as the kernel sums it: q, do (B, H, S, D) fp32, k, v (B, KVH, S,
    D) bf16, lse and delta (B, H, S) fp32 -> (B, H, S, D) fp32; without
    ``lo`` each split operand is one bf16 pass (what the kernel must not
    compute)."""
    b, h, s, d = q.shape
    rep = h // k.shape[1]
    scale = np.float32(d ** -0.5)
    kf = k.to(torch.float32).repeat_interleave(rep, dim=1)
    vf = v.to(torch.float32).repeat_interleave(rep, dim=1)
    qs = q * scale
    lse2 = (lse * LOG2E)[..., None]
    pos = torch.arange(s)
    dq = torch.zeros_like(q)
    for k0 in range(0, s, bk):
        kt, vt = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
        sc = _nt(qs, kt, lo)
        # fma(s, log2(e), -lse log2(e)): the product exact, one rounding
        x = (sc.double() * float(LOG2E) - lse2.double()).to(torch.float32)
        p = torch.exp2(x)
        if causal:
            p = p.masked_fill(pos[k0:k0 + bk] > pos[:, None], 0.0)
        ds = p * (_nt(do, vt, lo) - delta[..., None])
        hi, low = _split(ds, lo)
        dq = dq + (hi @ kt + low @ kt)
    return dq * scale


def _jax_dq(q, k, v, do, causal: bool, blk: int):
    """The reference's dq (and its out and lse rows) at blocks of ``blk``,
    S padded to a multiple outside the kernels with the keys past S
    masked (t_real), as mha_flash_train pads it; cropped to S."""
    s = q.shape[2]
    pad = -s % blk
    widths = ((0, 0), (0, 0), (0, pad), (0, 0))
    qp, kp, vp, dop = (jnp.pad(jnp.asarray(x), widths)
                       for x in (q, k, v, do))
    t_real = s if pad else None
    out, lse = jattn._flash_fwd_lse(qp, kp, vp, causal, blk, blk, True,
                                    t_real=t_real)
    dq, _, _ = jattn._flash_bwd(qp, kp, vp, out, lse, dop, causal, blk, blk,
                                True, t_real=t_real)
    return (np.asarray(dq)[:, :, :s], np.asarray(out)[:, :, :s],
            np.asarray(lse)[:, :, :s, 0])


@functools.lru_cache(maxsize=None)
def _case(shape, causal):
    """The reference's dq on numpy inputs from a seed, and the torch
    operands of the model (k and v rounded to bf16 first; lse and out the
    reference forward's, delta = sum(do * out)); once a case, for the two
    tests that read it."""
    b, h, kvh, s, d = shape
    rng = np.random.default_rng(s + d + h)
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k, v = (np.asarray(jnp.asarray(rng.standard_normal((b, kvh, s, d)),
                                   jnp.bfloat16)) for _ in "kv")
    do = rng.standard_normal((b, h, s, d)).astype(np.float32)
    ref, out, lse = _jax_dq(q, k, v, do, causal, 64)
    tq, tk, tv, tdo, tout, tlse = (convert.params_from_jax(np.asarray(x),
                                                           "cpu")
                                   for x in (q, k, v, do, out, lse))
    delta = (tdo * tout).sum(dim=-1)
    return torch.from_numpy(np.array(ref)), (tq, tk, tv, tdo, tlse, delta)


SHAPES = [(1, 4, 2, 128, 64), (1, 2, 1, 200, 128), (1, 8, 1, 130, 64)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_dq_model_matches_the_reference(shape, causal):
    ref, args = _case(shape, causal)
    got = dq_model(*args, causal=causal, bk=attention.KERNEL_BLOCK)
    err = attention.row_rel_err(got, ref)
    assert got.shape == shape[:2] + shape[3:] and torch.isfinite(got).all()
    assert float(err.max()) <= TRAIN_GRAD_REL, float(err.max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_dq_model_of_one_bf16_pass_is_refused(shape, causal):
    """The same rule refuses the sums without the lo halves (measured 7.6e-3
    to 0.53 of a row's max): each split is needed."""
    ref, args = _case(shape, causal)
    got = dq_model(*args, causal=causal, bk=attention.KERNEL_BLOCK,
                   lo=False)
    assert float(attention.row_rel_err(got, ref).max()) > TRAIN_GRAD_REL


def _const(pattern: str) -> re.Match:
    return re.search(pattern, (_build.CSRC / SOURCE).read_text())


def test_dq_walk_tiles_are_the_kernel_source():
    nc = int(_const(r"constexpr int NC = (\d);")[1])
    assert attention.KERNEL_DQ_ROWS == 64 * nc
    assert int(_const(r"constexpr int BK = (\d+);")[1]) == \
        attention.KERNEL_BLOCK


# (S, H, B, blocks): the soak's shape, the 7B training row and T-moe's on
# an H100's 132 SMs, fewer items than SMs, ragged S on a few blocks
@pytest.mark.parametrize("s,h,b,blocks", [
    (1024, 32, 8, 132), (2048, 32, 2, 132), (1025, 32, 2, 132),
    (1, 4, 2, 132), (130, 8, 1, 5), (700, 4, 3, 7)])
def test_dq_walk_visits_every_item_once_longest_first(s, h, b, blocks):
    bq, bk = attention.KERNEL_DQ_ROWS, attention.KERNEL_BLOCK
    walk = attention.dq_walk(s, h, b, blocks)
    items = [x for block in walk for x in block]
    expected = {(q0, hh, bb) for q0 in range(0, s, bq) for hh in range(h)
                for bb in range(b)}
    assert len(items) == len(expected) and set(items) == expected
    assert len(walk) == min(blocks, len(expected))
    # each block's causal walks shorten item by item, and the first wave
    # takes the longest query tiles
    last = (s - 1) // bq * bq
    for block in walk:
        q0s = [q0 for q0, _, _ in block]
        assert q0s == sorted(q0s, reverse=True)
    first = sorted(block[0][0] for block in walk)
    assert first[-1] == last
    assert first[0] >= last - (len(walk) - 1) // (h * b) * bq

    def tiles(q0):
        return min(q0 + bq - 1, s - 1) // bk + 1
    # the reversed rounds even out the blocks' causal work: no block does
    # more than one longest item beyond another
    work = [sum(tiles(q0) for q0, _, _ in block) for block in walk]
    assert max(work) - min(work) <= tiles(last)
