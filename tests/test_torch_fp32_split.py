"""Rung 16's route on the card, its arithmetic on the CPU: A and BT split
into bf16 hi + lo planes (``split_bf16``), hi.hi + hi.lo + lo.hi summed
stage by stage of 64 K values in the order ``csrc/fp32_gemm_nt.cu`` sums
them (CH stages in the wgmma accumulator, the partials added in fp32 in
K's order, C added last), emulated in plain PyTorch. The tensor cores'
fp32 accumulation is modelled, not reproduced bit for bit: each wgmma
instruction's 16 exact products are added into the accumulator and the
sum truncated toward zero to fp32. At K 4,096 the model reads 6.2e-6,
4.2e-6 and 2.4e-5 of max |ref| for CH 16, 4 and the straight sum at 128
x 128, where an H100 read 6.1e-6, 4.3e-6 and 1.7e-5 over 4,096 x 4,096
(``harness/flash_variants.py --group gemm``); rounding to nearest instead
reads 4.0e-6 to 4.1e-6 for all three, so it could not tell them apart.

- held against the JAX ``mmult_fp32_bt`` (its Pallas kernel in interpret
  mode) at tests/test_torch_tuned.py's shapes within REL = 1e-5 of
  max |ref|;
- held against the fp64 product under FP32_REL / 2 at K = 4,096 with the
  kernel's CH and the others the card measured under it (1, 2, 4), the
  card's rule for the kernel being FP32_REL of max |plain|;
- the straight sum misses FP32_REL at K = 4,096, as it did on the card;
- hi.hi alone does not meet FP32_REL (the lo planes carry the function).

CH and the tile are read from the kernel's sources, so the emulation
follows them.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from how_to_optimize_gemm_tpu.ops import registry as jregistry
from how_to_optimize_gemm_tpu_torch import _build
from how_to_optimize_gemm_tpu_torch.ops import grouped_gemm as gg
from how_to_optimize_gemm_tpu_torch.ops import registry, tuned

torch.set_num_threads(1)

# rung 16's rule on the card (tests/test_torch_cuda.py, chip_smoke.py):
# within FP32_REL of max |plain|
FP32_REL = 1e-5
# the JAX rung against its emulation: both sum exact products, in fp32
REL = 1e-5
SHAPES = [(256, 256, 256), (200, 136, 72), (128, 384, 1024)]


def _const(source: str, name: str) -> int:
    src = (_build.CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])


CH = _const("fp32_gemm_nt.cu", "CH")
KT = _const("wgmma.cuh", "KT")


def _abc(shape, seed):
    m, n, k = shape
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32))
                 for s in ((m, k), (k, n), (m, n)))


def toward_zero(x: torch.Tensor) -> torch.Tensor:
    """fp64 ``x`` rounded to fp32 toward zero."""
    y = x.float()
    over = y.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def split_route(a, bt, c, ch: int = CH, products: int = 3):
    """A @ BT^T + C in the kernel's order: per chunk of ch stages of KT K
    values (ch 0: all of K) a wgmma accumulator from 0, each 16-deep step
    adding hi.hi (then hi.lo and lo.hi with products 3) with the sum
    truncated toward zero to fp32 (the model of the tensor cores' fp32
    sum); the chunks added in fp32 in K's order, then C."""
    (ah, al), (bh, bl) = (gg.split_bf16_ref(x).double()
                          for x in (a, bt))
    pairs = ((ah, bh), (ah, bl), (al, bh))[:products]
    k = a.shape[1]
    step = ch * KT if ch else max(k, 1)
    tot = torch.zeros((a.shape[0], bt.shape[0]), dtype=torch.float32)
    for k0 in range(0, k, step):
        acc = torch.zeros_like(tot)
        for k1 in range(k0, min(k, k0 + step), 16):
            s = slice(k1, k1 + 16)
            for x, y in pairs:
                acc = toward_zero(acc.double() + x[:, s] @ y[:, s].T)
        tot = tot + acc
    return tot + c


def test_route_constants_match_the_sources():
    """The emulated chunk divides K into whole stages, and rung 16's tile
    (``tuned.FP32_NT_TILE``) is the one its kernel names."""
    assert KT == 64 and CH >= 0
    bm = _const("gemm_wgmma.cuh", "BM")
    assert tuned.FP32_NT_TILE == (bm, _const("fp32_gemm_nt.cu", "BN"))
    assert _const("fp32_gemm_nt.cu", "PRODUCTS") == 3


@pytest.mark.parametrize("shape", SHAPES)
def test_route_matches_jax(shape):
    a, b, c = _abc(shape, 300 + SHAPES.index(shape))
    jrung = jregistry.get("16_packed_alias_fp32")
    ja, jbt = jrung.prepare(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
    jout = np.asarray(jrung.run(ja, jbt, jnp.asarray(c.numpy())))
    a2, bt = registry.get("16_packed_alias_fp32").prepare(a, b)
    assert torch.equal(bt, torch.from_numpy(np.array(jbt)))
    out = split_route(a2, bt, c).numpy()
    scale = float(np.max(np.abs(jout)))
    np.testing.assert_allclose(out, jout, rtol=0, atol=REL * scale)
    # and the port's plain version, which the card's kernel is held to
    ref = tuned.mmult_fp32_bt_ref(a2, bt, c).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=REL * scale)


def _err_at_k_4096(**route) -> float:
    a, b, c = _abc((64, 64, 4096), 7)
    bt = b.t().contiguous()
    oracle = a.double() @ bt.double().T + c.double()
    out = split_route(a, bt, c, **route)
    return float((out.double() - oracle).abs().max() / oracle.abs().max())


def test_toward_zero_takes_the_neighbour_nearer_zero():
    x = torch.tensor([1 + 2.0 ** -30, -(1 + 2.0 ** -30), 1 - 2.0 ** -30,
                      0.5, -3.0], dtype=torch.float64)
    y = toward_zero(x)
    assert y.dtype == torch.float32
    assert y.tolist() == [1.0, -1.0, 1 - 2.0 ** -24, 0.5, -3.0]


@pytest.mark.parametrize("ch", sorted({CH, 1, 2}))
def test_route_meets_half_the_rule_at_k_4096(ch):
    """At K = 4,096 (the sweep's largest) the split route is within
    FP32_REL / 2 of the fp64 product, with the kernel's chunk and the
    smaller ones the card measured under it."""
    err = _err_at_k_4096(ch=ch)
    assert err < FP32_REL / 2, err


def test_straight_sum_misses_the_rule_at_k_4096():
    """Without partial sums the truncations of 768 accumulator adds pile
    up past FP32_REL (the card read 1.7e-5): what CH is for."""
    err = _err_at_k_4096(ch=0)
    assert err > FP32_REL, err


def test_hi_products_alone_miss_the_rule():
    """hi.hi alone is a bf16 product: far outside FP32_REL, so the lo
    planes' two products are what makes the route fp32."""
    err = _err_at_k_4096(products=1)
    assert err > 10 * FP32_REL, err


def test_wrapper_on_the_cpu_runs_the_plain_version_in_place():
    a, b, c = _abc((40, 24, 72), 9)
    a2, bt = tuned.prepare_fp32_bt(a, b)
    c2 = c.clone()
    out = tuned.mmult_fp32_bt(a2, bt, c2)
    assert out is c2
    assert torch.equal(c2, tuned.mmult_fp32_bt_ref(a2, bt, c))


@pytest.mark.parametrize("bad", ["shape", "dtype"])
def test_wrapper_refuses_on_meta_tensors(bad):
    """Off the CPU the wrapper goes to its kernels or raises: here a meta
    tensor (no card), whatever else is wrong with the call."""
    k = 16
    a = torch.zeros((4, k), device="meta")
    bt = torch.zeros((8, k if bad == "dtype" else k + 1), device="meta",
                     dtype=torch.bfloat16 if bad == "dtype" else None)
    with pytest.raises(RuntimeError):
        tuned.mmult_fp32_bt(a, bt, torch.zeros((4, 8), device="meta"))
