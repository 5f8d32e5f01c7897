"""Port parity: the hand-pipeline record's rungs 08-11 against the JAX rungs.

The same numpy (A, B, C) goes through each JAX rung (its Pallas kernel in
interpret mode, as tests/test_ladder.py runs them) and, through
``convert.from_jax_prepared``, through the port's rung on the CPU (the
kernels' plain versions).

Tolerances:
- the port's ``prepare`` gives the JAX rung's operands exactly;
- outputs agree within 1e-6 * max|ref| (XLA:CPU may fuse the epilogue
  into an FMA, the port rounds each op on its own);
- both stay under the rung's gate_rel against the fp64 oracle;
- the rungs return a fresh output and leave C as it was.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from how_to_optimize_gemm_tpu.harness import oracle as joracle
from how_to_optimize_gemm_tpu.ops import registry as jregistry
from how_to_optimize_gemm_tpu_torch import convert
from how_to_optimize_gemm_tpu_torch.harness import oracle
from how_to_optimize_gemm_tpu_torch.ops import bounds, int8, manual_dma, registry

torch.set_num_threads(1)

RUNGS = ["08_manual_dma_int8", "09_fat_tile_int8", "10_packed_fat_int8",
         "11_strip_resident_int8"]
# tests/test_torch_gemm.py's shapes (square; nothing aligned; K over two
# blocks) and tests/test_ladder.py's several K chunks
SHAPES = [(256, 256, 256), (200, 136, 72), (128, 384, 1024),
          (512, 512, 1024)]
# the sweep sizes the reference's chooser test walks
SWEEP = (128, 512, 1024, 1536, 2048, 2560, 3072, 3584, 4096, 11008, 100,
         640, 5632)
WRAPPERS = [manual_dma.mmult_q, manual_dma.mmult_q_fat,
            manual_dma.mmult_q_packed, manual_dma.mmult_q_strip]


def _abc(shape, seed):
    m, n, k = shape
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(-1, 1, s).astype(np.float32)
                 for s in ((m, k), (k, n), (m, n)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", RUNGS)
def test_rung_matches_jax(name, shape):
    a, b, c = _abc(shape, 100 + SHAPES.index(shape) * 10 + RUNGS.index(name))
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
    jrung, rung = jregistry.get(name), registry.get(name)
    assert rung.gate_rel == jrung.gate_rel == 1e-4
    assert rung.bytes_per_input_elt == jrung.bytes_per_input_elt == 1.0
    assert rung.regression == jrung.regression is False
    assert rung.dtype == jrung.dtype == "int8"
    # 10 and 11 take the packed operands (B^T), 08 and 09 rung 06's
    packed = name in ("10_packed_fat_int8", "11_strip_resident_int8")
    assert rung.prepare is (int8.prepare_packed if packed else int8.prepare)


@pytest.mark.parametrize("p", SWEEP)
def test_fat_chooser_invariants(p):
    """choose_blocks_fat: the blocks tile the padded operands and the
    rung's shared memory (ring, two C/out buffers, barriers) and its
    accumulators fit a block of the H100; rung 09's one-buffer tile too."""
    bm, bn, bk = manual_dma.choose_blocks_fat(p, p, p)
    assert (bm, bk) == (manual_dma.BM, manual_dma.BK)
    assert bn % 128 == 0 and bn <= manual_dma.fat_tile(2)[1]
    assert bounds.round_up(p, 128) % bn == 0      # least waste: no extra pad
    for tile, buffers in (((bm, bn), 2),
                          ((manual_dma.FAT_BM, manual_dma.FAT_BN), 1)):
        assert manual_dma.fat_smem_bytes(*tile, buffers) \
            <= manual_dma.SMEM_BLOCK == 227 * 1024
        assert manual_dma.fat_regs(*tile) <= manual_dma.MAX_REGS


def test_fat_tiles_are_the_largest_that_fit():
    """One buffer: 128 x 256 (a 128 x 384 tile's buffer is over budget);
    two buffers: 128 x 128 (two 128 x 256 buffers are)."""
    assert manual_dma.fat_tile(1) == (128, 256)
    assert manual_dma.fat_tile(2) == (128, 128)
    assert manual_dma.fat_smem_bytes(128, 384, 1) > manual_dma.SMEM_BLOCK
    assert manual_dma.fat_smem_bytes(128, 256, 2) > manual_dma.SMEM_BLOCK


@pytest.mark.parametrize("fn", WRAPPERS)
def test_wrappers_refuse_other_devices(fn):
    """For anything but a CPU tensor a wrapper launches its kernel or
    raises: never the plain version."""
    a, b, c = (torch.from_numpy(x) for x in _abc((64, 48, 80), 3))
    packed = fn in (manual_dma.mmult_q_packed, manual_dma.mmult_q_strip)
    qa, sa, qb, sb = (int8.prepare_packed if packed else int8.prepare)(a, b)
    meta = [t.to("meta") for t in (qa, sa, qb, sb, c)]
    with pytest.raises(RuntimeError):
        fn(*meta)


@pytest.mark.parametrize("fn", WRAPPERS)
def test_plain_versions_are_one_function(fn):
    """The four rungs compute rung 06's function: equal outputs on the same
    int8 operands, B in either layout, C unchanged."""
    a, b, c = (torch.from_numpy(x) for x in _abc((200, 136, 72), 7))
    qa, sa, qb, sb = int8.prepare(a, b)
    packed = fn in (manual_dma.mmult_q_packed, manual_dma.mmult_q_strip)
    c0 = c.clone()
    out = fn(qa, sa, qb.t().contiguous() if packed else qb, sb, c)
    assert torch.equal(c, c0)
    assert torch.equal(out, int8.mmult_q_ref(qa, sa, qb, sb, c))
