"""The port's dispatch probe (``how_to_optimize_gemm_tpu_torch/ops/
dispatch_probe.py``) against the reference's, on the CPU.

Each chain kind's final sum is held against the reference's ``_make_chain``
(the custom kind's Pallas kernel in interpret mode) at N = 4 and 16: the
custom kind adds 1 to ones, exact in bf16, and must be EQUAL; the dot and
eltwise kinds round each step to bf16 on both sides, and the sum of 2,048
bf16 values may be accumulated in another order: within 2^-6 of the
reference's |sum| (two bf16 ulps).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from how_to_optimize_gemm_tpu.ops import dispatch_probe as jdp
from how_to_optimize_gemm_tpu_torch.ops import dispatch_probe

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [4, 16])
@pytest.mark.parametrize("kind", ["custom", "dot", "eltwise"])
def test_chain_matches_the_reference(kind, n):
    jfn, jargs = jdp._make_chain(kind, n, True)
    ref = float(np.asarray(jfn(*jargs).astype(jnp.float32)))
    fn, args = dispatch_probe._make_chain(kind, n, "cpu")
    out = fn(*args)
    assert out.dtype == torch.bfloat16
    if kind == "custom":
        assert float(out) == ref == 8 * 256 * (1 + n)
    else:
        assert abs(float(out) - ref) <= 2.0 ** -6 * abs(ref)


def test_add_one_is_the_reference_kernel():
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -300, 300, (8, 256)).astype(np.float32)).to(torch.bfloat16)
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    ref = np.asarray(jdp._custom_op(jx, True).astype(jnp.float32))
    assert np.array_equal(dispatch_probe.add_one(x).float().numpy(), ref)


def test_probe_op_chain_rows_and_slope_on_the_cpu():
    ns = (8, 32, 128)
    rows, slope_us, icept_ms = dispatch_probe.probe_op_chain(
        "custom", ns=ns, repeats=2, device="cpu")
    assert [n for n, _ in rows] == list(ns)
    assert all(wall > 0 for _, wall in rows)
    # every op costs the host something: the fitted slope is positive
    assert slope_us > 0 and np.isfinite(icept_ms)
    with pytest.raises(ValueError, match="CUDA graph"):
        dispatch_probe.probe_op_chain("custom", ns=ns, graph=True,
                                      device="cpu")


def test_main_on_the_cpu(capsys):
    r = dispatch_probe.main(fast=True, device="cpu")
    assert set(r["chains"]) == {(k, "eager") for k in dispatch_probe.KINDS}
    assert [k for k, _, _ in r["async"]] == [1, 2, 4]
    assert len(r["outbytes"]) == 2
    out = capsys.readouterr().out
    assert "marginal" in out and "async depth 4" in out
