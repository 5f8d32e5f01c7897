"""Port parity: the float ladder's base rungs 00, 02, 03 and 03b against
the JAX package's.

The same numpy (A, B, C) goes through each JAX rung (``00_naive_vpu`` is
plain JAX; 02, 03 and 03b run their Pallas kernels in interpret mode, as
tests/test_ladder.py runs them) and, through
``convert.from_jax_prepared``, through the port's rung on the CPU (the
kernels' plain versions).

Tolerances:
- the port's ``prepare`` gives the JAX rung's operands exactly (equal
  fp32 values);
- outputs agree within REL = 1e-5 * max|ref| (the bound of
  tests/test_torch_tuned.py): both sum the same fp32 products, in another
  order (the reference's rank-1 loop, its blocked dots);
- both stay under the rung's gate_rel against the fp64 oracle of the
  effective operands, which are equal.
Rung 00's K is at most 512, as tests/test_ladder.py limits it (its JAX
loop runs K rank-1 updates one after another).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from how_to_optimize_gemm_tpu.harness import oracle as joracle
from how_to_optimize_gemm_tpu.ops import registry as jregistry
from how_to_optimize_gemm_tpu_torch import convert
from how_to_optimize_gemm_tpu_torch.harness import driver, oracle
from how_to_optimize_gemm_tpu_torch.harness.parameters import SweepConfig
from how_to_optimize_gemm_tpu_torch.ops import (k_blocked, mn_tile, naive,
                                               registry)

torch.set_num_threads(1)

RUNGS = ["00_naive_vpu", "02_pallas_mn_tile", "03_pallas_k_blocked",
         "03b_pallas_small_blocks"]
# square; nothing aligned (K and N rows not 16-byte multiples); edges
# past one 128 and one 256 block
SHAPES = [(256, 256, 256), (200, 136, 72), (130, 260, 300)]
REL = 1e-5
WRAPPERS = [naive.mmult, mn_tile.mmult, k_blocked.mmult,
            k_blocked.mmult_small]


def _abc(shape, seed):
    m, n, k = shape
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(-1, 1, s).astype(np.float32)
                 for s in ((m, k), (k, n), (m, n)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", RUNGS)
def test_rung_matches_jax(name, shape):
    assert shape[2] <= 512 or name != "00_naive_vpu"
    a, b, c = _abc(shape, 300 + SHAPES.index(shape) * 10 + RUNGS.index(name))
    jrung, rung = jregistry.get(name), registry.get(name)

    jprep = jrung.prepare(jnp.asarray(a), jnp.asarray(b))
    prepared = convert.from_jax_prepared(
        name, [np.asarray(x) for x in jprep], "cpu")
    own = rung.prepare(torch.from_numpy(a), torch.from_numpy(b))
    assert len(own) == len(prepared) == 2
    for x, y in zip(own, prepared):
        assert x.dtype == y.dtype == torch.float32 and torch.equal(x, y)

    jout = np.asarray(jrung.run(*jprep, jnp.asarray(c)))
    ct = torch.from_numpy(c.copy())
    out = rung.run(*prepared, ct).numpy()
    assert out.shape == shape[:2]
    assert np.array_equal(ct.numpy(), c)            # a fresh output
    scale = float(np.max(np.abs(jout)))
    np.testing.assert_allclose(out, jout, rtol=0, atol=REL * scale)

    ae, be = rung.effective(prepared)
    ref = oracle.ref_mmult(ae.numpy(), be.numpy(), c)
    assert oracle.compare_matrices(out, ref, rung.gate_rel).max_rel \
        < rung.gate_rel
    assert joracle.compare_matrices(jout, ref, jrung.gate_rel).max_rel \
        < jrung.gate_rel


@pytest.mark.parametrize("name", RUNGS)
def test_registry_carries_the_reference_fields(name):
    jrung, rung = jregistry.get(name), registry.get(name)
    assert (rung.gate_rel, rung.dtype, rung.bytes_per_input_elt,
            rung.regression, rung.compute_dtype) == (
        jrung.gate_rel, jrung.dtype, jrung.bytes_per_input_elt,
        jrung.regression, jrung.compute_dtype)
    assert rung.gate_rel == 1e-4 and rung.dtype == "fp32"
    assert rung.regression == (name == "03b_pallas_small_blocks")


def test_every_port_rung_carries_the_reference_regression_and_compute():
    """``regression`` and ``compute_dtype`` (which the roofline reads)
    equal the reference's on every rung the port has."""
    for name in registry.names():
        jrung, rung = jregistry.get(name), registry.get(name)
        assert rung.regression == jrung.regression, name
        assert rung.compute_dtype == jrung.compute_dtype, name


@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_plain_versions_are_a_at_b_plus_c(wrapper):
    """On CPU tensors each wrapper is its plain version: ``A @ B + C`` in
    fp32 (the same value in both C orders), C left as it was."""
    a, b, c = (torch.from_numpy(x) for x in _abc((40, 24, 72), 7))
    c_in = c.clone()
    out = wrapper(a, b, c)
    assert torch.equal(c, c_in) and out.shape == c.shape
    ref = a.double() @ b.double() + c.double()
    assert float((out.double() - ref).abs().max()) < 1e-5


@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_wrappers_refuse_other_devices(wrapper):
    """The plain version runs only for CPU tensors; any other device
    goes to the kernel or raises (here: no CUDA, a meta tensor)."""
    a = torch.zeros((4, 16), device="meta")
    b = torch.zeros((16, 8), device="meta")
    with pytest.raises(RuntimeError):
        wrapper(a, b, torch.zeros((4, 8), device="meta"))


def test_k_blocked_takes_only_its_two_blocks():
    a, b, c = (torch.from_numpy(x) for x in _abc((8, 8, 8), 9))
    assert torch.equal(k_blocked.mmult(a, b, c, block=64),
                       k_blocked.mmult(a, b, c))
    with pytest.raises(ValueError):
        k_blocked.mmult(a, b, c, block=256)


@pytest.mark.parametrize("name", RUNGS)
def test_run_sweep_cpu_passes_gate(name, tmp_path):
    cfg = SweepConfig(pfirst=96, plast=192, pinc=96, nrepeats=1, warmup=0)
    rows = driver.run_sweep(name, cfg, output_dir=tmp_path, verbose=False,
                            device="cpu")
    assert [r.p for r in rows] == [96, 192]
    gate = registry.get(name).gate_rel
    assert all(r.kernel_rel < gate and r.gflops > 0 for r in rows)
    assert (tmp_path / f"output_{name}.m").exists()
