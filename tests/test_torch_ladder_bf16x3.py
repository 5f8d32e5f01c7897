"""The float ladder's rungs 02, 03 and 03b on the card, their arithmetic
on the CPU. ``csrc/fp32_gemm_mn_tile.cu`` (rung 02) and
``csrc/fp32_gemm_k_blocked.cu`` (03 and 03b) split A and B inside the
kernel into bf16 hi = bf16(x) and lo = bf16(x - hi) (``split_bf16_ref``'s
arithmetic), take hi.hi + hi.lo + lo.hi for each 16-deep slice of K on
``mma.sync`` with fp32 sums, and add the tensor cores' partial of CH steps
of BK K values into a second fp32 sum in K's order: from 0, C added at the
end (rung 02), or seeded with C (03 and 03b). Both are modelled here in
plain PyTorch. The tensor cores' fp32 accumulation is modelled as in
tests/test_torch_fp32_split.py (each instruction's 16 exact products added
into the accumulator, the sum truncated toward zero to fp32), not
reproduced bit for bit.

- the model against the JAX rung (its Pallas kernel in interpret mode, as
  tests/test_torch_ladder_base.py runs it) at that file's shapes within
  REL = 1e-5 of max |ref|, and under the rung's gate_rel against the fp64
  oracle;
- against the port's plain version at the card tests' ragged shapes
  within FP32_REL of max |plain| (the card's rule);
- at K = 4,096 within FP32_REL / 2 of the fp64 product with the kernels'
  CH and the others the card measured beside it (2, 8); one sum over all
  of K misses FP32_REL there;
- planted faults: the model without one or both lo products misses
  FP32_REL, so the card's tolerance catches a dropped product;
- the split's contract on edge values: |x - hi - lo| <= 2^-17 |x| where
  |x| >= 2^-117 (signed zeros exact), and <= 2^-134, half the smallest
  bf16 subnormal, below it; x whose bf16 rounding overflows has no finite
  hi, in ``split_bf16_ref`` as in the kernels' ``split_pack``.

BK and CH are read from the kernels' header, so the model follows it.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from how_to_optimize_gemm_tpu.ops import registry as jregistry
from how_to_optimize_gemm_tpu_torch import _build, convert
from how_to_optimize_gemm_tpu_torch.harness import oracle
from how_to_optimize_gemm_tpu_torch.ops import grouped_gemm as gg
from how_to_optimize_gemm_tpu_torch.ops import k_blocked, mn_tile, registry

torch.set_num_threads(1)

# the rungs' rule on the card (tests/test_torch_cuda.py, chip_smoke.py):
# within FP32_REL of max |plain|, FP32_REL / 2 at K 4,096
FP32_REL = 1e-5
# the JAX rung against the model: both sum exact products, in fp32
REL = 1e-5
# tests/test_torch_ladder_base.py's shapes
SHAPES = [(256, 256, 256), (200, 136, 72), (130, 260, 300)]
# the card tests' ragged shapes (tests/test_torch_cuda.py BASE_SHAPES)
RAGGED = [(999, 1030, 1101), (17, 9, 40)]
# rung -> (wrapper, plain version, sums seeded with C)
RUNGS = {"02_pallas_mn_tile": (mn_tile.mmult, mn_tile.mn_tile_ref, False),
         "03_pallas_k_blocked": (k_blocked.mmult, k_blocked.k_blocked_ref,
                                 True),
         "03b_pallas_small_blocks": (k_blocked.mmult_small,
                                     k_blocked.k_blocked_ref, True)}
HEADER = "bf16x3_mma.cuh"


def _source(name: str) -> str:
    return (_build.CSRC / name).read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         _source(HEADER))[1])


BK = _const("BK")
CH = _const("CH")


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


def split(x: torch.Tensor):
    """x's hi and lo planes as the kernels split it (``split_bf16_ref``'s
    arithmetic), in fp64."""
    planes = gg.split_bf16_ref(x)[:, :, :x.shape[1]]
    return planes[0].double(), planes[1].double()


def route(a, b, c, seed_c: bool, ch: int = CH, products: int = 3):
    """C + A @ B in the kernels' order: per partial of ch steps of BK K
    values (ch 0: all of K) a tensor-core sum from 0, each 16-deep slice
    adding hi.hi (then hi.lo, then lo.hi, as many as ``products``) with
    the sum truncated toward zero to fp32; the partials added in fp32 in
    K's order into a sum that starts at C (``seed_c``: rungs 03, 03b) or
    at 0, C added last (rung 02)."""
    (ah, al), (bh, bl) = split(a), split(b)
    pairs = ((ah, bh), (ah, bl), (al, bh))[:products]
    k = a.shape[1]
    step = ch * BK if ch else max(k, 1)
    tot = c.clone() if seed_c else torch.zeros_like(c)
    for k0 in range(0, k, step):
        acc = torch.zeros_like(c)
        for k1 in range(k0, min(k, k0 + step), 16):
            s = slice(k1, k1 + 16)
            for x, y in pairs:
                acc = toward_zero(acc.double() + x[:, s] @ y[s, :])
        tot = tot + acc
    return tot if seed_c else tot + c


def test_route_constants_match_the_sources():
    """A partial is 128 K (4 steps of 32), and neither kernel keeps an
    FFMA loop: both are the header's products; rung 03 stages K by
    cp.async, rung 02 overlaps no copy."""
    assert (BK, CH) == (32, 4)
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in \
        _source(HEADER)
    for name in ("fp32_gemm_mn_tile.cu", "fp32_gemm_k_blocked.cu"):
        text = _source(name)
        assert f'#include "{HEADER}"' in text and "fmaf" not in text, name
    assert "copy_stage" in _source("fp32_gemm_k_blocked.cu")
    assert "cp_async" not in _source("fp32_gemm_mn_tile.cu")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", sorted(RUNGS))
def test_route_matches_jax(name, shape):
    a, b, c = _abc(shape, 700 + SHAPES.index(shape) * 10
                   + sorted(RUNGS).index(name))
    jrung, rung = jregistry.get(name), registry.get(name)
    jprep = jrung.prepare(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
    jout = np.asarray(jrung.run(*jprep, jnp.asarray(c.numpy())))
    a2, b2 = convert.from_jax_prepared(name, [np.asarray(x) for x in jprep],
                                       "cpu")
    assert torch.equal(a2, a) and torch.equal(b2, b)
    out = route(a, b, c, RUNGS[name][2]).numpy()
    scale = float(np.max(np.abs(jout)))
    np.testing.assert_allclose(out, jout, rtol=0, atol=REL * scale)
    ref = oracle.ref_mmult(a.numpy(), b.numpy(), c.numpy())
    assert oracle.compare_matrices(out, ref, rung.gate_rel).max_rel \
        < rung.gate_rel


@pytest.mark.parametrize("shape", RAGGED)
@pytest.mark.parametrize("name", sorted(RUNGS))
def test_route_within_the_card_rule_of_the_plain_version(name, shape):
    """The model against the port's plain version (cuBLAS's order on the
    card, PyTorch's here): within FP32_REL of max |plain|, C untouched
    by the wrapper's plain version."""
    a, b, c = _abc(shape, 800 + RAGGED.index(shape))
    wrapper, plain, seed_c = RUNGS[name]
    c_in = c.clone()
    ref = wrapper(a, b, c)
    assert torch.equal(c, c_in) and torch.equal(ref, plain(a, b, c))
    out = route(a, b, c, seed_c)
    err = float((out - ref).abs().max())
    assert err <= FP32_REL * float(ref.abs().max()), err


def _err_at_k_4096(seed_c: bool, **route_kw) -> float:
    a, b, c = _abc((64, 64, 4096), 9)
    exact = a.double() @ b.double() + c.double()
    out = route(a, b, c, seed_c, **route_kw)
    return float((out.double() - exact).abs().max() / exact.abs().max())


@pytest.mark.parametrize("ch", sorted({CH, 2, 8}))
@pytest.mark.parametrize("seed_c", [False, True], ids=["02", "03"])
def test_route_meets_half_the_rule_at_k_4096(seed_c, ch):
    """At K = 4,096 (the sweep's largest) within FP32_REL / 2 of the fp64
    product, in either rung's order, with the kernels' partials and the
    others measured beside them."""
    err = _err_at_k_4096(seed_c, ch=ch)
    assert err < FP32_REL / 2, err


@pytest.mark.parametrize("seed_c", [False, True], ids=["02", "03"])
def test_straight_sum_misses_the_rule_at_k_4096(seed_c):
    """One tensor-core sum over all of K piles up its truncations past
    FP32_REL: what the partials are for."""
    err = _err_at_k_4096(seed_c, ch=0)
    assert err > FP32_REL, err


@pytest.mark.parametrize("products", [1, 2], ids=["hi_hi", "no_lo_hi"])
@pytest.mark.parametrize("seed_c", [False, True], ids=["02", "03"])
def test_dropped_lo_products_miss_the_rule(seed_c, products):
    """A planted fault: without lo.hi (or both lo products) the model is
    a bf16 product on one side, far outside FP32_REL of max |plain|, so
    the card's rule would catch a kernel that dropped one."""
    a, b, c = _abc((64, 96, 512), 11)
    ref = c + a @ b
    out = route(a, b, c, seed_c, products=products)
    err = float((out - ref).abs().max() / ref.abs().max())
    assert err > 10 * FP32_REL, err


_BITS = {
    "signed_zeros": [0x00000000, 0x80000000],
    "subnormals": [0x00000001, 0x80000001, 0x00012345, 0x807FFFFF,
                   0x00400000, 0x007FFFFF],
    "largest_finite_hi": [0x7F7F7FFF, 0xFF7F7FFF, 0x7F7F0000, 0x7F000001],
    "smallest_normals": [0x00800000, 0x80800001, 0x05000000, 0x05FFFFFF],
    "bf16_exact": [0x3F800000, 0xC0490000, 0x3B800000],
}


@pytest.mark.parametrize("kind", sorted(_BITS))
def test_split_contract_on_edge_values(kind):
    x = torch.from_numpy(np.array(_BITS[kind], dtype=np.uint32)
                         .view(np.float32))[None, :]
    hi, lo = split(x)
    err = (x.double() - hi - lo).abs()
    big = x.double().abs() >= 2.0 ** -117
    assert torch.all(err[big] <= 2.0 ** -17 * x.double().abs()[big])
    assert torch.all(err[~big] <= 2.0 ** -134)
    assert torch.isfinite(hi).all() and torch.isfinite(lo).all()
    if kind in ("signed_zeros", "bf16_exact"):
        assert torch.equal(hi, x.double()) and not lo.any()


def test_split_of_values_past_the_bf16_range_has_no_finite_hi():
    """x at or above the largest fp32 whose bf16 rounding is finite
    (0x7F7F8000 and up): hi overflows to +-inf, as bf16(x) does; the
    kernels take such operands as the plain split does."""
    x = torch.from_numpy(np.array([0x7F7F8000, 0x7F7FFFFF, 0xFF7FFFFF],
                                  dtype=np.uint32).view(np.float32))[None]
    hi, _ = split(x)
    assert torch.isinf(hi).all()
    assert torch.equal(torch.sign(hi), torch.sign(x.double()))
