"""Port parity: the hand-pipeline record's operand-resident rungs 12 and 13
against the JAX rungs.

The same numpy (A, B, C) goes through each JAX rung (its Pallas kernel in
interpret mode, as tests/test_ladder.py runs them) and, through
``convert.from_jax_prepared``, through the port's rung on the CPU (the
kernels' plain versions).

Tolerances:
- the port's ``prepare`` gives the JAX rung's operands exactly;
- outputs agree within 1e-6 * max|ref| (XLA:CPU may fuse the epilogue
  into an FMA, the port rounds each op on its own);
- both stay under the rung's gate_rel against the fp64 oracle;
- the rungs return a fresh output and leave C as it was;
- rung 13's repack (``pretile``) is a layout: exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from how_to_optimize_gemm_tpu.harness import oracle as joracle
from how_to_optimize_gemm_tpu.ops import registry as jregistry
from how_to_optimize_gemm_tpu_torch import convert
from how_to_optimize_gemm_tpu_torch.harness import oracle
from how_to_optimize_gemm_tpu_torch.ops import int8, manual_dma, registry

torch.set_num_threads(1)

RUNGS = ["12_resident_int8", "13_tiled_resident_int8"]
WRAPPERS = {"12_resident_int8": manual_dma.mmult_q_resident,
            "13_tiled_resident_int8": manual_dma.mmult_q_tiled_resident}
# tests/test_torch_manual_dma.py's shapes
SHAPES = [(256, 256, 256), (200, 136, 72), (128, 384, 1024),
          (512, 512, 1024)]


def _abc(shape, seed):
    m, n, k = shape
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(-1, 1, s).astype(np.float32)
                 for s in ((m, k), (k, n), (m, n)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", RUNGS)
def test_rung_matches_jax(name, shape):
    a, b, c = _abc(shape, 200 + SHAPES.index(shape) * 10 + RUNGS.index(name))
    jrung, rung = jregistry.get(name), registry.get(name)

    jprep = jrung.prepare(jnp.asarray(a), jnp.asarray(b))
    prepared = convert.from_jax_prepared(
        name, [np.asarray(x) for x in jprep], "cpu")
    own = rung.prepare(torch.from_numpy(a), torch.from_numpy(b))
    for x, y in zip(own, prepared):
        assert x.dtype == y.dtype and torch.equal(x, y)

    jout = np.asarray(jrung.run(*jprep, jnp.asarray(c)))
    ct = torch.from_numpy(c.copy())
    out = rung.run(*prepared, ct)
    assert torch.equal(ct, torch.from_numpy(c))       # C left as it was
    assert out.data_ptr() != ct.data_ptr()
    out = out.numpy()
    assert out.shape == shape[:2]
    scale = float(np.max(np.abs(jout)))
    np.testing.assert_allclose(out, jout, rtol=0, atol=1e-6 * scale)

    ae, be = rung.effective(prepared)
    ref = oracle.ref_mmult(ae.numpy(), be.numpy(), c)
    assert oracle.compare_matrices(out, ref, rung.gate_rel).max_rel \
        < rung.gate_rel
    jres = joracle.compare_matrices(jout, ref, jrung.gate_rel)
    assert jres.max_rel < jrung.gate_rel


@pytest.mark.parametrize("name", RUNGS)
def test_registry_entry_is_the_references(name):
    """12 carries the reference's regression flag; 13's stays unset there
    (its doc calls it a regression) and here."""
    jrung, rung = jregistry.get(name), registry.get(name)
    assert rung.gate_rel == jrung.gate_rel == 1e-4
    assert rung.bytes_per_input_elt == jrung.bytes_per_input_elt == 1.0
    assert rung.regression == jrung.regression == (name == "12_resident_int8")
    assert rung.dtype == jrung.dtype == "int8"
    assert rung.prepare is int8.prepare_packed
    assert rung.run is WRAPPERS[name]
    assert "REGRESSION" in rung.doc and "REGRESSION" in jrung.doc


def test_budget_is_a_share_of_the_l2():
    """RESIDENT_BUDGET is L2_SHARE of the H100 SXM's 50 MiB L2, the budget
    of any device without an L2 of its own."""
    assert int8.L2_BYTES == 50 * 1024 * 1024
    assert manual_dma.RESIDENT_BUDGET == int(int8.L2_SHARE * int8.L2_BYTES)
    assert int8.l2_budget("cpu") == int8.l2_budget("meta") \
        == manual_dma.RESIDENT_BUDGET
    assert 0 < int8.L2_SHARE < 1


@pytest.mark.parametrize("tiled", [False, True])
def test_resident_bytes_follow_the_references_need(tiled):
    """mp * kp + np * kp on 128-row tiles and 64-byte K chunks; rung 13's
    slot images carry 80 bytes a row."""
    width = manual_dma.LDS if tiled else manual_dma.BK
    assert manual_dma.resident_bytes(4096, 4096, 4096, tiled) \
        == 8192 * 64 * width
    assert manual_dma.resident_bytes(200, 136, 72, tiled) \
        == (256 + 256) * 2 * width
    assert manual_dma.resident_bytes(1, 1, 1, tiled) == 256 * width


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("p,fits", [(1024, True), (2048, True),
                                    (4096, True), (5120, False),
                                    (8192, False)])
def test_route_rule_at_the_sweep_sizes(p, fits, tiled):
    """Every sweep size (1024-4096) stays resident on the H100's budget;
    5120 and up take rung 11."""
    assert manual_dma.fits_resident(p, p, p, tiled=tiled) is fits
    assert manual_dma.fits_resident(
        p, p, p, tiled=tiled,
        budget=manual_dma.resident_bytes(p, p, p, tiled)) is True
    assert manual_dma.fits_resident(
        p, p, p, tiled=tiled,
        budget=manual_dma.resident_bytes(p, p, p, tiled) - 1) is False


@pytest.mark.parametrize("over", [False, True])
@pytest.mark.parametrize("name", RUNGS)
def test_above_the_budget_the_rung_takes_rung_11(name, over, monkeypatch):
    """The wrapper routes by the card's budget (``int8.l2_budget``): at or
    under it the rung's own route, above it ``mmult_q_strip``."""
    a, b, c = (torch.from_numpy(x) for x in _abc((200, 136, 72), 5))
    ops = int8.prepare_packed(a, b)
    need = manual_dma.resident_bytes(200, 136, 72,
                                     name == "13_tiled_resident_int8")
    monkeypatch.setattr(int8, "l2_budget",
                        lambda device: need - 1 if over else need)
    calls = []

    def strip(*args):
        calls.append(args)
        return manual_dma.mmult_q_strip_ref(*args)
    monkeypatch.setattr(manual_dma, "mmult_q_strip", strip)
    out = WRAPPERS[name](*ops, c)
    assert len(calls) == (1 if over else 0)
    assert torch.equal(out, int8.mmult_q_bt_ref(*ops, c))


@pytest.mark.parametrize("rows,k", [(200, 72), (128, 64), (1, 16),
                                    (384, 1024), (0, 32)])
def test_pretile_layout(rows, k):
    """pretile_ref's (tiles, nk, 128, LDS) image: chunk (t, kt) row r holds
    source row t * 128 + r, bytes kt * 64 .. + 64, then 16 zero bytes;
    rows and K past the source are zero."""
    rng = np.random.default_rng(rows + k)
    x = torch.from_numpy(rng.integers(-127, 128, (rows, k)).astype(np.int8))
    img = manual_dma.pretile_ref(x)
    tiles, nk = -(-rows // 128), -(-k // 64)
    assert img.shape == (tiles, nk, 128, manual_dma.LDS)
    assert img.dtype == torch.int8 and img.is_contiguous()
    assert torch.equal(manual_dma.pretile(x), img)   # CPU: the plain version
    full = torch.zeros((tiles * 128, nk * 64), dtype=torch.int8)
    full[:rows, :k] = x
    for t in range(tiles):
        for kt in range(nk):
            assert torch.equal(img[t, kt, :, :64],
                               full[t * 128:(t + 1) * 128,
                                    kt * 64:(kt + 1) * 64])
    assert not img[..., 64:].any()


def test_pretile_chunk_is_one_contiguous_slot_image():
    """Each chunk is 128 x 80 = 10,240 contiguous bytes: one bulk copy."""
    x = torch.arange(256 * 128, dtype=torch.int32).remainder(127).to(
        torch.int8).reshape(256, 128)
    img = manual_dma.pretile_ref(x)
    flat = img.reshape(-1)
    chunk = 128 * manual_dma.LDS
    assert chunk == 10_240
    second = flat[chunk:2 * chunk].reshape(128, manual_dma.LDS)  # (0, 1)
    assert torch.equal(second[:, :64], x[:128, 64:128])


@pytest.mark.parametrize("fn", [manual_dma.mmult_q_resident,
                                manual_dma.mmult_q_tiled_resident])
def test_wrappers_refuse_other_devices(fn):
    """For anything but a CPU tensor a wrapper launches its kernel or
    raises: never the plain version."""
    a, b, c = (torch.from_numpy(x) for x in _abc((64, 48, 80), 3))
    meta = [t.to("meta") for t in (*int8.prepare_packed(a, b), c)]
    with pytest.raises(RuntimeError):
        fn(*meta)


def test_pretile_refuses_other_devices():
    with pytest.raises(RuntimeError):
        manual_dma.pretile(torch.zeros((4, 16), dtype=torch.int8,
                                       device="meta"))


@pytest.mark.parametrize("name", RUNGS)
def test_plain_versions_are_one_function(name):
    """Both rungs compute rung 06's function on the packed operands, C
    unchanged."""
    a, b, c = (torch.from_numpy(x) for x in _abc((200, 136, 72), 7))
    qa, sa, qb, sb = int8.prepare(a, b)
    c0 = c.clone()
    out = WRAPPERS[name](qa, sa, qb.t().contiguous(), sb, c)
    assert torch.equal(c, c0)
    assert torch.equal(out, int8.mmult_q_ref(qa, sa, qb, sb, c))
