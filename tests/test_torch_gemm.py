"""Port parity: the four headline rungs against the JAX package's.

The same numpy (A, B, C) goes through each JAX rung (Pallas kernels in
interpret mode, as tests/test_ladder.py runs them) and, through
``convert.from_jax_prepared``, through the port's rung on the CPU (the
kernels' plain versions; the vendor rung's ``torch._int_mm``).

Tolerances:
- the port's ``prepare`` gives the JAX rung's operands exactly;
- outputs agree within 1e-6 * max|ref| (XLA:CPU may fuse the epilogue
  into an FMA, the port rounds each op on its own);
- both stay under the rung's gate_rel against the fp64 oracle.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from how_to_optimize_gemm_tpu.harness import oracle as joracle
from how_to_optimize_gemm_tpu.ops import registry as jregistry
from how_to_optimize_gemm_tpu_torch import convert
from how_to_optimize_gemm_tpu_torch.harness import oracle
from how_to_optimize_gemm_tpu_torch.ops import int4, int8, registry

torch.set_num_threads(1)

RUNGS = ["06v_xla_int8", "06_pallas_int8", "14_packed_alias_int8",
         "07b_pallas_w4a8"]
# square; nothing aligned; K over two w4a8 pack blocks
SHAPES = [(256, 256, 256), (200, 136, 72), (128, 384, 1024)]


def _abc(shape, seed):
    m, n, k = shape
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(-1, 1, s).astype(np.float32)
                 for s in ((m, k), (k, n), (m, n)))


# the float and W4A16 rungs and their vendor bars (tests/test_torch_tuned.py)
FLOAT_RUNGS = ["01_xla_fp32", "01b_xla_bf16", "04_pallas_tuned_fp32",
               "05_pallas_bf16", "07_pallas_int4", "15_packed_alias_bf16",
               "16_packed_alias_fp32"]


def test_port_registry_holds_the_headline_rungs():
    assert registry.names() == sorted(RUNGS + FLOAT_RUNGS)
    for name in RUNGS + FLOAT_RUNGS:
        assert registry.get(name).gate_rel == jregistry.get(name).gate_rel
    with pytest.raises(KeyError):
        registry.get("02_pallas_mn_tile")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", RUNGS)
def test_rung_matches_jax(name, shape):
    a, b, c = _abc(shape, SHAPES.index(shape) * 10 + RUNGS.index(name))
    jrung, rung = jregistry.get(name), registry.get(name)

    jprep = jrung.prepare(jnp.asarray(a), jnp.asarray(b))
    jnp_prep = [x if isinstance(x, int) else np.asarray(x) for x in jprep]
    prepared = convert.from_jax_prepared(name, jnp_prep, "cpu")
    own = rung.prepare(torch.from_numpy(a), torch.from_numpy(b))
    for x, y in zip(own, prepared):
        if isinstance(x, int):
            assert x == y
        else:
            assert x.dtype == y.dtype and torch.equal(x, y)

    jout = np.asarray(jrung.run(*jprep, jnp.asarray(c)))
    ct = torch.from_numpy(c.copy())
    out = rung.run(*prepared, ct).numpy()
    assert out.shape == shape[:2]
    scale = float(np.max(np.abs(jout)))
    np.testing.assert_allclose(out, jout, rtol=0, atol=1e-6 * scale)

    ae, be = rung.effective(prepared)
    ref = oracle.ref_mmult(ae.numpy(), be.numpy(), c)
    assert oracle.compare_matrices(out, ref, rung.gate_rel).max_rel \
        < rung.gate_rel
    jae, jbe = jrung.effective(jprep)
    np.testing.assert_array_equal(ae.numpy(), np.asarray(jae))
    np.testing.assert_array_equal(be.numpy(), np.asarray(jbe))
    jres = joracle.compare_matrices(jout, ref, jrung.gate_rel)
    assert jres.max_rel < jrung.gate_rel


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_versions_agree(shape):
    """K1, K2 and K3's plain versions compute one function: the same
    int8 operands give equal outputs through all three layouts."""
    a, b, c = (torch.from_numpy(x) for x in _abc(shape, 99))
    qa, sa, qb, sb = int8.prepare(a, b)
    out_nn = int8.mmult_q_ref(qa, sa, qb, sb, c)
    out_nt = int8.mmult_q_bt_ref(qa, sa, qb.t().contiguous(), sb, c)
    assert torch.equal(out_nn, out_nt)
    qa4, sa4, packed, sw, kdim = int4.prepare_w4a8(a, b)
    w = int4.quant.unpack_int4(packed, int4.PACK_BLOCK)[:kdim]
    assert torch.equal(int4.mmult_q_w4a8_ref(qa4, sa4, packed, sw, c),
                       int8.mmult_q_ref(qa4, sa4, w.contiguous(), sw, c))


@pytest.mark.parametrize("name", ["14_packed_alias_int8", "07b_pallas_w4a8"])
def test_in_place_rungs_write_c(name):
    """Rungs 14 and 07b accumulate into C and return it, as the JAX
    kernels alias C into their output."""
    a, b, c = (torch.from_numpy(x) for x in _abc((64, 48, 80), 5))
    rung = registry.get(name)
    prepared = rung.prepare(a, b)
    c2 = c.clone()
    out = rung.run(*prepared, c2)
    assert out is c2 and not torch.equal(c2, c)


@pytest.mark.parametrize("fn", [int8.mmult_q, int8.mmult_q_bt])
def test_wrappers_refuse_other_devices(fn):
    """The plain version runs only for CPU tensors; any other device
    goes to the kernel or raises (here: no CUDA, a meta tensor)."""
    qa = torch.zeros((4, 16), dtype=torch.int8, device="meta")
    sa = torch.zeros((4, 1), device="meta")
    sb = torch.zeros((1, 8), device="meta")
    b = torch.zeros((16, 8) if fn is int8.mmult_q else (8, 16),
                    dtype=torch.int8, device="meta")
    c = torch.zeros((4, 8), device="meta")
    with pytest.raises(RuntimeError):
        fn(qa, sa, b, sb, c)


def test_w4a8_wrapper_refuses_other_devices():
    qa = torch.zeros((4, 16), dtype=torch.int8, device="meta")
    packed = torch.zeros((256, 8), dtype=torch.int8, device="meta")
    with pytest.raises(RuntimeError):
        int4.mmult_q_w4a8(qa, torch.zeros((4, 1), device="meta"), packed,
                          torch.zeros((1, 8), device="meta"),
                          torch.zeros((4, 8), device="meta"))


def test_convert_rejects_wrong_layouts():
    with pytest.raises(KeyError):
        convert.from_jax_prepared("02_pallas_mn_tile", [], "cpu")
    with pytest.raises(TypeError):
        convert.from_jax_prepared(
            "06_pallas_int8",
            [np.zeros((2, 2), np.float32)] * 4, "cpu")
    with pytest.raises(ValueError):
        convert.from_jax_prepared("07b_pallas_w4a8",
                                  [np.zeros((2, 2), np.int8)] * 4, "cpu")
