"""Port parity: the ladder's bf16, fp32 and W4A16 rungs and their vendor
bars (01, 01b, 04, 05, 07, 15, 16) against the JAX package's.

The same numpy (A, B, C) goes through each JAX rung (Pallas kernels in
interpret mode, as tests/test_ladder.py runs them) and, through
``convert.from_jax_prepared``, through the port's rung on the CPU (the
kernels' plain versions; the vendor bars' library calls).

Tolerances:
- the port's ``prepare`` gives the JAX rung's operands exactly: the same
  bf16 bits, byte-identical int4 packs, equal fp32 values;
- outputs agree within REL = 1e-5 * max|ref|: both sum the same exact
  products in fp32, in another order;
- both stay under the rung's gate_rel against the fp64 oracle of the
  effective operands, which are equal.
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
from how_to_optimize_gemm_tpu_torch.ops import int4, registry, tuned, vendor

torch.set_num_threads(1)

RUNGS = ["01_xla_fp32", "01b_xla_bf16", "04_pallas_tuned_fp32",
         "05_pallas_bf16", "07_pallas_int4", "15_packed_alias_bf16",
         "16_packed_alias_fp32"]
IN_PLACE = ["07_pallas_int4", "15_packed_alias_bf16", "16_packed_alias_fp32"]
# square; nothing aligned; K over two int4 pack blocks
SHAPES = [(256, 256, 256), (200, 136, 72), (128, 384, 1024)]
REL = 1e-5


def _abc(shape, seed):
    m, n, k = shape
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(-1, 1, s).astype(np.float32)
                 for s in ((m, k), (k, n), (m, n)))


def _bits(x: torch.Tensor) -> torch.Tensor:
    """The tensor's bits, so that equal means byte-identical."""
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16)
    if x.dtype == torch.float32:
        return x.view(torch.int32)
    return x


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", RUNGS)
def test_rung_matches_jax(name, shape):
    a, b, c = _abc(shape, 100 + SHAPES.index(shape) * 10 + RUNGS.index(name))
    jrung, rung = jregistry.get(name), registry.get(name)
    assert (rung.gate_rel, rung.bytes_per_input_elt, rung.bytes_a,
            rung.bytes_b) == (jrung.gate_rel, jrung.bytes_per_input_elt,
                              jrung.bytes_a, jrung.bytes_b)

    jprep = jrung.prepare(jnp.asarray(a), jnp.asarray(b))
    jnp_prep = [x if isinstance(x, int) else np.asarray(x) for x in jprep]
    prepared = convert.from_jax_prepared(name, jnp_prep, "cpu")
    own = rung.prepare(torch.from_numpy(a), torch.from_numpy(b))
    assert len(own) == len(prepared)
    for x, y in zip(own, prepared):
        if isinstance(x, int):
            assert x == y
        else:
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.is_contiguous()
            assert torch.equal(_bits(x), _bits(y))

    jout = np.asarray(jrung.run(*jprep, jnp.asarray(c)))
    ct = torch.from_numpy(c.copy())
    out = rung.run(*prepared, ct).numpy()
    assert out.shape == shape[:2]
    scale = float(np.max(np.abs(jout)))
    np.testing.assert_allclose(out, jout, rtol=0, atol=REL * scale)

    ae, be = rung.effective(prepared)
    jae, jbe = jrung.effective(jprep)
    np.testing.assert_array_equal(ae.numpy(), np.asarray(jae))
    np.testing.assert_array_equal(be.numpy(), np.asarray(jbe))
    ref = oracle.ref_mmult(ae.numpy(), be.numpy(), c)
    assert oracle.compare_matrices(out, ref, rung.gate_rel).max_rel \
        < rung.gate_rel
    assert joracle.compare_matrices(jout, ref, jrung.gate_rel).max_rel \
        < jrung.gate_rel


@pytest.mark.parametrize("name", RUNGS)
def test_in_place_rungs_write_c_and_the_others_leave_it(name):
    """Rungs 07, 15 and 16 accumulate into C and return it, as the JAX
    kernels alias C into their output; 01, 01b, 04 and 05 return a fresh
    output and leave C as it was."""
    a, b, c = (torch.from_numpy(x) for x in _abc((64, 48, 80), 5))
    rung = registry.get(name)
    prepared = rung.prepare(a, b)
    c2 = c.clone()
    out = rung.run(*prepared, c2)
    if name in IN_PLACE:
        assert out is c2 and not torch.equal(c2, c)
    else:
        assert out is not c2 and torch.equal(c2, c)


def test_packs_are_contiguous_transposes():
    """prepare_bf16_bt and prepare_fp32_bt give B as a contiguous (N, K),
    not a transposed view."""
    a, b, _ = (torch.from_numpy(x) for x in _abc((24, 40, 56), 6))
    for prepare, dtype in ((tuned.prepare_bf16_bt, torch.bfloat16),
                           (tuned.prepare_fp32_bt, torch.float32)):
        a2, bt = prepare(a, b)
        assert a2.dtype == bt.dtype == dtype
        assert bt.shape == (40, 56) and bt.is_contiguous()
        assert torch.equal(bt, b.t().to(dtype))


def test_the_two_c_orders():
    """04 and 05 seed the accumulator with C, 15 and 16 add C at the
    flush: with C = 0 both give the plain product, and C enters once."""
    a, b, c = (torch.from_numpy(x) for x in _abc((40, 24, 72), 7))
    zero = torch.zeros_like(c)
    a16, bt16 = tuned.prepare_bf16_bt(a, b)
    b16 = b.to(torch.bfloat16)
    for seeded, flushed in ((tuned.mmult_ref(a, b, zero),
                             tuned.mmult_fp32_bt_ref(a, b.t(), zero)),
                            (tuned.mmult_bf16_ref(a16, b16, zero),
                             tuned.mmult_bf16_bt_ref(a16, bt16, zero))):
        torch.testing.assert_close(seeded, flushed, rtol=0, atol=1e-5)
    assert torch.equal(tuned.mmult_ref(a, b, c),
                       c + tuned.mmult_ref(a, b, zero))
    packed, sw, _ = int4._pack_weights(b)
    y = int4.mmult_q_noc_ref(a16, packed, sw)
    assert torch.equal(int4.mmult_q_ref(a16, packed, sw, c), y + c)


@pytest.mark.parametrize("name", RUNGS)
def test_run_sweep_cpu_passes_gate(name, tmp_path):
    cfg = SweepConfig(pfirst=96, plast=192, pinc=96, nrepeats=1, warmup=0)
    rows = driver.run_sweep(name, cfg, output_dir=tmp_path, verbose=False,
                            device="cpu")
    assert [r.p for r in rows] == [96, 192]
    gate = registry.get(name).gate_rel
    assert all(r.kernel_rel < gate and r.gflops > 0 for r in rows)
    assert (tmp_path / f"output_{name}.m").exists()


def test_fp32_matmul_restores_the_precision_flags(monkeypatch):
    """The product runs with TF32 off, and both flags read what the
    caller set afterwards, also when the product raises."""
    flags = torch.backends.cuda.matmul
    saved = (flags.allow_tf32, torch.get_float32_matmul_precision())
    seen = []
    matmul = torch.matmul

    def spy(x, w):
        try:
            precision = torch.get_float32_matmul_precision()
        except RuntimeError:
            precision = None
        seen.append((flags.allow_tf32, precision))
        return matmul(x, w)
    monkeypatch.setattr(torch, "matmul", spy)
    try:
        flags.allow_tf32 = True
        before = (flags.allow_tf32, torch.get_float32_matmul_precision())
        assert before == (True, "high")
        x = torch.ones((3, 4))
        assert torch.equal(vendor.fp32_matmul(x, torch.ones((4, 2))),
                           torch.full((3, 2), 4.0))
        assert seen == [(False, "highest")]
        assert (flags.allow_tf32,
                torch.get_float32_matmul_precision()) == before
        with pytest.raises(RuntimeError):
            vendor.fp32_matmul(x, torch.ones((5, 2)))
        assert (flags.allow_tf32,
                torch.get_float32_matmul_precision()) == before
        torch.set_float32_matmul_precision("medium")
        vendor.fp32_matmul(x, torch.ones((4, 2)))
        assert (flags.allow_tf32,
                torch.get_float32_matmul_precision()) == (True, "medium")
        # allow_tf32 set after the precision: PyTorch's backends may then
        # disagree so that the precision cannot be read; the product still
        # runs with TF32 off and the flag reads what the caller set
        torch.set_float32_matmul_precision("high")
        flags.allow_tf32 = False
        seen.clear()
        vendor.fp32_matmul(x, torch.ones((4, 2)))
        assert seen[0][0] is False and flags.allow_tf32 is False
    finally:
        flags.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])


def test_linear_leaves_the_precision_flags():
    """apply_linear on fp32 and bf16 weights changes no global flag (the
    reference's dot carries its precision per call)."""
    from how_to_optimize_gemm_tpu_torch.models import linear
    flags = torch.backends.cuda.matmul
    saved = (flags.allow_tf32, torch.get_float32_matmul_precision())
    try:
        flags.allow_tf32 = True
        w = torch.ones((8, 4))
        for kind in ("fp32", "bf16"):
            y = linear.apply_linear(linear.make_linear(w, kind),
                                    torch.ones((2, 8)))
            assert torch.equal(y, torch.full((2, 4), 8.0))
            assert flags.allow_tf32
    finally:
        flags.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])


@pytest.mark.parametrize("fn,bt,dtype", [
    (tuned.mmult, False, torch.float32),
    (tuned.mmult_bf16, False, torch.bfloat16),
    (tuned.mmult_bf16_bt, True, torch.bfloat16),
    (tuned.mmult_fp32_bt, True, torch.float32)])
def test_wrappers_refuse_other_devices(fn, bt, dtype):
    """The plain version runs only for CPU tensors; any other device
    goes to the kernel or raises (here: no CUDA, a meta tensor)."""
    a = torch.zeros((4, 16), dtype=dtype, device="meta")
    b = torch.zeros((8, 16) if bt else (16, 8), dtype=dtype, device="meta")
    with pytest.raises(RuntimeError):
        fn(a, b, torch.zeros((4, 8), device="meta"))


def test_w4a16_rung_refuses_other_devices():
    a = torch.zeros((4, 16), dtype=torch.bfloat16, device="meta")
    packed = torch.zeros((256, 8), dtype=torch.int8, device="meta")
    with pytest.raises(RuntimeError):
        int4.mmult_q(a, packed, torch.zeros((1, 8), device="meta"),
                     torch.zeros((4, 8), device="meta"))


def test_convert_rejects_wrong_layouts():
    with pytest.raises(TypeError):                   # fp32 where bf16 is
        convert.from_jax_prepared(
            "15_packed_alias_bf16", [np.zeros((2, 2), np.float32)] * 2,
            "cpu")
    with pytest.raises(ValueError):                  # 07 carries kdim
        convert.from_jax_prepared(
            "07_pallas_int4", [np.zeros((2, 2), np.float32)] * 3, "cpu")
