"""Port parity: rung 17 (the hand pipeline) and rung 18 (the ragged-M plan)
against the JAX rungs.

The same numpy (A, B, C) goes through each JAX rung (Pallas in interpret
mode: rung 17's emit_pipeline schedule, rung 18's two aliased calls) and,
through ``convert.from_jax_prepared``, through the port's rung on the CPU
(rung 14's plain version).

Tolerances:
- the port's ``prepare`` gives the JAX rung's operands exactly;
- outputs agree within 1e-6 * max|ref| (XLA:CPU may fuse the epilogue
  into an FMA, the port rounds each op on its own);
- both stay under the rung's gate_rel against the fp64 oracle;
- both rungs write C in place and return it;
- the strip plan is a pure function: equal to the reference's.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from how_to_optimize_gemm_tpu.harness import oracle as joracle
from how_to_optimize_gemm_tpu.ops import pallas_int8 as jint8
from how_to_optimize_gemm_tpu.ops import registry as jregistry
from how_to_optimize_gemm_tpu_torch import convert
from how_to_optimize_gemm_tpu_torch.harness import ab, oracle
from how_to_optimize_gemm_tpu_torch.ops import hand_pipeline, int8, registry

torch.set_num_threads(1)

RUNGS = ["17_hand_pipeline_int8", "18_ragged_m_int8"]
WRAPPERS = {"17_hand_pipeline_int8": hand_pipeline.mmult_q_bt_hand,
            "18_ragged_m_int8": int8.mmult_q_bt_ragged}
# tests/test_torch_manual_dma.py's shapes
SHAPES = [(256, 256, 256), (200, 136, 72), (128, 384, 1024),
          (512, 512, 1024)]
KNOBS = [(nb, la) for nb in hand_pipeline.B_BUFFERS for la in (False, True)]


def _abc(shape, seed):
    m, n, k = shape
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(-1, 1, s).astype(np.float32)
                 for s in ((m, k), (k, n), (m, n)))


def _against_jax(name, shape, seed, **kw):
    a, b, c = _abc(shape, seed)
    jrung, rung = jregistry.get(name), registry.get(name)

    jprep = jrung.prepare(jnp.asarray(a), jnp.asarray(b))
    prepared = convert.from_jax_prepared(
        name, [np.asarray(x) for x in jprep], "cpu")
    own = rung.prepare(torch.from_numpy(a), torch.from_numpy(b))
    for x, y in zip(own, prepared):
        assert x.dtype == y.dtype and torch.equal(x, y)

    jout = np.asarray(jrung.run(*jprep, jnp.asarray(c), **kw))
    ct = torch.from_numpy(c.copy())
    out = rung.run(*prepared, ct, **kw)
    assert out is ct                                   # C written in place
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


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", RUNGS)
def test_rung_matches_jax(name, shape):
    _against_jax(name, shape, 300 + SHAPES.index(shape) * 10
                 + RUNGS.index(name))


def test_ragged_two_piece_plan_matches_jax():
    """(640, 256, 256) at cap 256: a head of two 256-row strips and a
    128-row tail at block 4, through both packages."""
    assert int8.ragged_m_plan(640, 256) == [(256, 2, 0), (128, 1, 4)]
    _against_jax("18_ragged_m_int8", (640, 256, 256), 399, cap=256)


@pytest.mark.parametrize("mp", [128, 256, 1152, 1280, 2048, 3584, 4096,
                                8192])
def test_ragged_m_plan_is_the_references(mp):
    """tests/test_ladder.py's grid: the port's plan equals the reference's,
    and covers mp exactly with aligned offsets."""
    for cap in (512, 1024, 1664, 1792):
        plan = int8.ragged_m_plan(mp, cap)
        assert plan == jint8.ragged_m_plan(mp, cap)
        rows = 0
        for bm, gm, off in plan:
            assert bm % 128 == 0 and bm <= max(cap, 128)
            assert off * bm == rows
            rows += bm * gm
        assert rows == mp
    assert int8.ragged_m_plan(4096, 1664) == [(1536, 2, 0), (1024, 1, 3)]


# the B^T panel width of the reckoning: 128 (the mma.sync kernel's 128 x 128
# tiles) and 256 (the wgmma kernel's 128 x 256, the default), each with its
# cap at K = 12,288 on the H100's budget: (1,792 + 10 x 256) x 12,288 bytes
# is past the budget, where 128-column panels fit
@pytest.mark.parametrize("tile_n,cap_12288", [(128, 1792), (256, 512)])
def test_ragged_cap_from_the_l2(tile_n, cap_12288):
    """The cap keeps a strip's A panel and one wave's B^T panels inside the
    budget, clamped to the reference's [512, 1792]: 1792 at K = 4096 on the
    H100's budget (a two-piece plan at p = 4096), 512 when nothing fits."""
    budget = int8.l2_budget("cpu")
    assert int8.ragged_cap(4096, budget, tile_n) == 1792
    assert int8.ragged_m_plan(4096, 1792) == [(1792, 2, 0), (512, 1, 7)]
    assert int8.ragged_cap(1 << 20, budget, tile_n) == 512
    assert int8.ragged_cap(12288, budget, tile_n) == cap_12288
    for kp in (1024, 4096, 8192, 12288):
        cap = int8.ragged_cap(kp, budget, tile_n)
        panels = -(-int8.WAVE * 128 // cap)
        assert cap % 128 == 0 and 512 <= cap <= 1792
        assert (cap + panels * tile_n) * kp <= budget or cap == 512
    # a smaller budget gives a shorter strip
    assert int8.ragged_cap(8192, budget // 2, tile_n) < int8.ragged_cap(
        8192, budget, tile_n)
    # the kernel's panels are the default
    if tile_n == int8.TILE_N:
        assert int8.ragged_cap(12288, budget) == cap_12288


@pytest.mark.parametrize("b_buffers,a_lookahead", KNOBS)
def test_built_knobs_are_accepted(b_buffers, a_lookahead):
    """Every built instance runs (here its plain version: rung 14's)."""
    a, b, c = (torch.from_numpy(x) for x in _abc((200, 136, 72), 9))
    ops = int8.prepare_packed(a, b)
    c2 = c.clone()
    out = hand_pipeline.mmult_q_bt_hand(*ops, c2, b_buffers=b_buffers,
                                        a_lookahead=a_lookahead)
    assert out is c2 and torch.equal(out, int8.mmult_q_bt_ref(*ops, c))


@pytest.mark.parametrize("kw", [{"b_buffers": 1}, {"b_buffers": 5},
                                {"b_buffers": 3.0}, {"b_buffers": True},
                                {"a_lookahead": 1}, {"a_lookahead": "no"}])
def test_other_knobs_raise(kw):
    a, b, c = (torch.from_numpy(x) for x in _abc((64, 48, 80), 2))
    with pytest.raises(ValueError):
        hand_pipeline.mmult_q_bt_hand(*int8.prepare_packed(a, b), c, **kw)


@pytest.mark.parametrize("name", RUNGS)
def test_registry_entry_is_the_references(name):
    jrung, rung = jregistry.get(name), registry.get(name)
    assert rung.gate_rel == jrung.gate_rel == 1e-4
    assert rung.bytes_per_input_elt == jrung.bytes_per_input_elt == 1.0
    assert rung.regression is jrung.regression is True
    assert rung.dtype == jrung.dtype == "int8"
    assert rung.prepare is int8.prepare_packed
    assert rung.run is WRAPPERS[name]


@pytest.mark.parametrize("name", RUNGS)
def test_plain_versions_are_rung_14s(name):
    """Both rungs compute rung 14's function in place: the same C as
    ``int8.mmult_q_bt`` on the same operands, N not a multiple of 4."""
    a, b, c = (torch.from_numpy(x) for x in _abc((300, 262, 520), 4))
    ops = int8.prepare_packed(a, b)
    want = int8.mmult_q_bt(*ops, c.clone())
    c2 = c.clone()
    assert WRAPPERS[name](*ops, c2) is c2 and torch.equal(c2, want)


@pytest.mark.parametrize("name", RUNGS)
def test_wrappers_refuse_other_devices(name):
    """For anything but a CPU tensor a wrapper launches its kernel or
    raises: never the plain version."""
    a, b, c = (torch.from_numpy(x) for x in _abc((64, 48, 80), 3))
    meta = [t.to("meta") for t in (*int8.prepare_packed(a, b), c)]
    with pytest.raises(RuntimeError):
        WRAPPERS[name](*meta)


def test_ab_passes_knobs_to_rung_a(tmp_path, monkeypatch):
    """``ab --a-kw`` runs rung A with the knobs and records them in the
    session (the CPU: rung 14's plain version under both)."""
    monkeypatch.setattr(ab, "WINDOW_S", 0.02)
    seen = []
    rung = registry.get("17_hand_pipeline_int8")

    def run(*args, **kw):
        seen.append(kw)
        return rung.run(*args, **kw)
    monkeypatch.setitem(registry.LADDER, rung.name,
                        rung.__class__(**{**rung.__dict__, "run": run}))
    kw = {"b_buffers": 2, "a_lookahead": False}
    ab.main(["--a", rung.name, "--b", "14_packed_alias_int8", "--p", "128",
             "--rounds", "3", "--device", "cpu", "--artifact-dir",
             str(tmp_path), "--a-kw", json.dumps(kw)])
    assert seen and all(s == kw for s in seen)
    path = tmp_path / f"ab_{rung.name}_vs_14_packed_alias_int8.json"
    assert json.loads(path.read_text())["sessions"][0]["a_kw"] == kw
