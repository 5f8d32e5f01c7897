"""The port's hardware probes (``how_to_optimize_gemm_tpu_torch/ops/probes.py``)
against the reference's Pallas kernels in interpret mode, on the CPU.

Inputs come from numpy and go to both sides. Sizes are those of the
reference's ``tests/test_probes.py``: tiles of 128 and 4 iterations, a
parent of 1,024 for the chunk walk, chunks of 8 x 128 in 4 slots for the
manual copy. Tolerances:

- int8 chains (wrapping casts and sums), checksums, copies, VMEM copies:
  EQUAL.
- bf16 chain: both sides sum exact products in fp32 in their own order,
  and the chain rounds each acc to bf16, where one such difference may
  land a value on the neighbouring bf16: within n_iters x 2^-8 of max
  |ref|.
- fp32 chain (HIGHEST on the reference, a full fp32 product here; the
  card's 3xTF32 is held to this plain version by the card tests) and bf16
  throughput: fp32 sums in another order, within n_iters x K x 2^-24 of
  the largest sum of |terms|.
- exp: the two exps differ by a few ulp a term and each of the n_iters
  sums may round to the neighbouring float: within (n_iters + 4) x 2^-23
  of |ref|, element by element.
- FFMA: XLA may or may not fuse a * m + y into one rounding: one ulp a
  step, within steps x 2^-23 of |ref|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from how_to_optimize_gemm_tpu.ops import probes as jprobes
from how_to_optimize_gemm_tpu_torch.ops import probes

torch.set_num_threads(1)

SIZE, N_ITERS = 128, 4


def _rng(seed):
    return np.random.default_rng(seed)


def _vmem_call(kernel, out_shape, n_in, scratch=()):
    return pl.pallas_call(
        kernel, out_shape=out_shape,
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * n_in,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        scratch_shapes=list(scratch), interpret=True)


def _chain_inputs(dtype_name, seed):
    rng = _rng(seed)
    if dtype_name == "int8":
        x = rng.integers(-128, 128, (SIZE, SIZE)).astype(np.int8)
        y = rng.integers(-128, 128, (SIZE, SIZE)).astype(np.int8)
        return x, y
    x = (rng.uniform(0, 1, (SIZE, SIZE)) * (2.0 / SIZE)).astype(np.float32)
    y = rng.uniform(-1, 1, (SIZE, SIZE)).astype(np.float32)
    return x, y


def _to_torch(a, dtype_name):
    t = torch.from_numpy(a)
    return t.to(torch.bfloat16) if dtype_name == "bfloat16" else t


@pytest.mark.parametrize("dtype_name", ["int8", "bfloat16", "float32"])
def test_mxu_chain_matches_the_reference(dtype_name):
    x, y = _chain_inputs(dtype_name, 0)
    jdt = {"int8": jnp.int8, "bfloat16": jnp.bfloat16,
           "float32": jnp.float32}[dtype_name]
    ref = np.asarray(jprobes._mxu_probe(
        jnp.asarray(x, jdt), jnp.asarray(y, jdt), size=SIZE,
        n_iters=N_ITERS, dtype_name=dtype_name, interpret=True))
    out = probes.mxu_chain(_to_torch(x, dtype_name),
                           _to_torch(y, dtype_name), N_ITERS).numpy()
    assert out.dtype == ref.dtype and out.shape == ref.shape
    if dtype_name == "int8":
        assert np.array_equal(out, ref)
        return
    scale = float(np.abs(ref).max())
    err = float(np.abs(out - ref).max())
    if dtype_name == "bfloat16":
        assert err <= N_ITERS * 2.0 ** -8 * scale, err / scale
    else:
        bound = float((np.abs(x) @ np.abs(ref)).max())
        assert err <= N_ITERS * SIZE * 2.0 ** -24 * bound, err / scale


@pytest.mark.parametrize("dtype_name", ["int8", "bfloat16"])
def test_mxu_throughput_matches_the_reference(dtype_name):
    rng = _rng(1)
    if dtype_name == "int8":
        x = rng.integers(-128, 128, (SIZE, SIZE)).astype(np.int8)
        y = rng.integers(-128, 128, (SIZE, SIZE)).astype(np.int8)
        kernel = jprobes._mxu_throughput_kernel(N_ITERS, jnp.int32)
        acc = jnp.int32
        jx, jy = jnp.asarray(x), jnp.asarray(y)
    else:
        # the reference's depth sweep at depth 64
        x = rng.uniform(-1, 1, (SIZE, 64)).astype(np.float32)
        y = rng.uniform(-1, 1, (64, SIZE)).astype(np.float32)
        vary = lambda xv, t: xv * (1 - 2 * (t % 2)).astype(xv.dtype)  # noqa
        kernel = jprobes._mxu_throughput_kernel(N_ITERS, jnp.float32, vary)
        acc = jnp.float32
        jx = jnp.asarray(x, jnp.bfloat16)
        jy = jnp.asarray(y, jnp.bfloat16)
    ref = np.asarray(_vmem_call(
        kernel, jax.ShapeDtypeStruct((SIZE, SIZE), acc), 2,
        [pltpu.VMEM((SIZE, SIZE), acc)])(jx, jy))
    out = probes.mxu_throughput(_to_torch(x, dtype_name),
                                _to_torch(y, dtype_name), N_ITERS).numpy()
    assert out.dtype == ref.dtype and out.shape == ref.shape
    if dtype_name == "int8":
        assert np.array_equal(out, ref)
        return
    xb = _to_torch(x, "bfloat16").float().numpy()
    yb = _to_torch(y, "bfloat16").float().numpy()
    bound = float((np.abs(xb) @ np.abs(yb)).max())
    err = float(np.abs(out - ref).max())
    assert err <= N_ITERS * 64 * 2.0 ** -24 * bound, err / bound


def test_vpu_exp_matches_the_reference():
    x = _rng(2).uniform(-2, 1, (SIZE, SIZE)).astype(np.float32)
    ref = np.asarray(_vmem_call(
        jprobes._vpu_exp_kernel(N_ITERS),
        jax.ShapeDtypeStruct(x.shape, jnp.float32), 1)(jnp.asarray(x)))
    out = probes.vpu_exp(torch.from_numpy(x), N_ITERS).numpy()
    assert np.all(np.abs(out - ref) <= (N_ITERS + 4) * 2.0 ** -23
                  * np.abs(ref))


@pytest.mark.parametrize("dependent", [True, False])
def test_vpu_fma_matches_the_reference(dependent):
    x = _rng(3).uniform(-1, 1, (SIZE, 512)).astype(np.float32)
    ref = np.asarray(_vmem_call(
        jprobes._vpu_kernel(N_ITERS, dependent),
        jax.ShapeDtypeStruct(x.shape, jnp.float32), 1)(jnp.asarray(x)))
    out = probes.vpu_fma(torch.from_numpy(x), N_ITERS, dependent).numpy()
    steps = N_ITERS * (8 if dependent else 1) + 3
    assert np.all(np.abs(out - ref) <= steps * 2.0 ** -23
                  * np.maximum(np.abs(ref), np.abs(x)))


def test_hbm_copy_matches_the_reference():
    x = _rng(4).standard_normal((512, 2048)).astype(np.float32)
    ref = np.asarray(jprobes._hbm_copy_once(jnp.asarray(x), True))
    out = probes.hbm_copy(torch.from_numpy(x)).numpy()
    assert np.array_equal(out, ref)


@pytest.mark.parametrize("rows,cols", [(256, 512), (512, 256)])
def test_dma_chunk_checksum_matches_the_reference(rows, cols):
    parent, reps = 1024, 2
    x = _rng(5).integers(-128, 128, (parent, parent)).astype(np.int8)
    ni, nj = parent // rows, parent // cols
    ref = np.asarray(pl.pallas_call(
        jprobes._chunk_kernel(rows, cols, ni * nj, nj, reps),
        out_shape=jax.ShapeDtypeStruct((1, 1), jnp.int32),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pltpu.SMEM),
        scratch_shapes=[pltpu.VMEM((2, rows, cols), jnp.int8),
                        pltpu.SemaphoreType.DMA((2,))],
        interpret=True)(jnp.asarray(x)))
    out = probes.dma_chunk_checksum(torch.from_numpy(x), rows, cols,
                                    reps).numpy()
    assert out.dtype == np.int32 and np.array_equal(out, ref)


def test_dma_chunk_rejects_odd_walks():
    x = torch.zeros((1024, 1024), dtype=torch.int8)
    with pytest.raises(ValueError, match="even count"):
        probes.dma_chunk_checksum(x, 1024, 1024, 1)
    with pytest.raises(ValueError, match="even count"):
        probes.dma_chunk_bandwidth_gbps(1024, 1024, parent=1024,
                                        device="cpu")


def test_vmem_copy_matches_the_reference():
    n_iters = 3
    x = _rng(6).integers(-128, 128, (256, 2048)).astype(np.int8)
    ref = np.asarray(_vmem_call(
        jprobes._vmem_copy_kernel(n_iters),
        jax.ShapeDtypeStruct(x.shape, jnp.int8), 1,
        [pltpu.VMEM(x.shape, jnp.int8)])(jnp.asarray(x)))
    out = probes.vmem_copy(torch.from_numpy(x), n_iters).numpy()
    assert np.array_equal(out, ref)


def test_dma_latency_sum_matches_the_reference():
    rows, cols, nsrc, n_iters = 32, 128, 8, 64
    x = _rng(7).integers(-128, 128, (rows * nsrc, cols)).astype(np.int8)
    ref = np.asarray(pl.pallas_call(
        jprobes._dma_latency_kernel(n_iters, rows, cols, True, nsrc),
        out_shape=jax.ShapeDtypeStruct((1, 1), jnp.int32),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pltpu.SMEM),
        scratch_shapes=[pltpu.VMEM((rows, cols), jnp.int8),
                        pltpu.SemaphoreType.DMA(())],
        interpret=True)(jnp.asarray(x)))
    xt = torch.from_numpy(x)
    assert np.array_equal(probes.dma_latency_sum(xt, rows, n_iters).numpy(),
                          ref)
    # the baseline loop sums the tile that no load wrote: 0 here
    assert int(probes.dma_latency_sum(xt, rows, n_iters, load=False)) == 0


def test_manual_copy_matches_the_reference():
    rows, cols, nslots, nchunks = 8, 128, 4, 8
    x = (np.arange(rows * nchunks * cols, dtype=np.float32)
         .reshape(rows * nchunks, cols))
    ref, ref_n = pl.pallas_call(
        jprobes._manual_copy_kernel(rows, cols, nchunks, nslots, reps=1),
        out_shape=(jax.ShapeDtypeStruct(x.shape, jnp.float32),
                   jax.ShapeDtypeStruct((1, 1), jnp.int32)),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=(pl.BlockSpec(memory_space=pl.ANY),
                   pl.BlockSpec(memory_space=pltpu.SMEM)),
        scratch_shapes=[pltpu.VMEM((nslots, rows, cols), jnp.float32),
                        pltpu.SemaphoreType.DMA((nslots,)),
                        pltpu.SemaphoreType.DMA((nslots,))],
        compiler_params=pltpu.CompilerParams(has_side_effects=True),
        interpret=True)(jnp.asarray(x))
    out, n = probes.manual_copy(torch.from_numpy(x), rows, nslots, reps=1)
    assert np.array_equal(out.numpy(), np.asarray(ref))
    assert np.array_equal(n.numpy(), np.asarray(ref_n))


READINGS = {
    "mxu_peak_gflops bf16": lambda: probes.mxu_peak_gflops(
        "bf16", size=64, n_iters=2, tiles=1, repeats=1, device="cpu"),
    "mxu_peak_gflops int8": lambda: probes.mxu_peak_gflops(
        "int8", size=64, n_iters=2, tiles=1, repeats=1, device="cpu"),
    "mxu_peak_gflops fp32": lambda: probes.mxu_peak_gflops(
        "fp32", size=64, n_iters=2, tiles=1, repeats=1, device="cpu"),
    "mxu_throughput_gflops": lambda: probes.mxu_throughput_gflops(
        depth=128, n_iters=2, tiles=1, repeats=1, device="cpu"),
    "mxu_depth_gflops": lambda: probes.mxu_depth_gflops(
        64, n_iters=2, tiles=1, repeats=1, device="cpu"),
    "vpu_exp_gelems": lambda: probes.vpu_exp_gelems(
        size=8, n_iters=4, repeats=1, device="cpu"),
    "vpu_peak_gflops dependent": lambda: probes.vpu_peak_gflops(
        size=8, n_iters=4, repeats=1, dependent=True, device="cpu"),
    "vpu_peak_gflops independent": lambda: probes.vpu_peak_gflops(
        size=8, n_iters=4, repeats=1, dependent=False, device="cpu"),
    "hbm_bandwidth_gbps": lambda: probes.hbm_bandwidth_gbps(
        mbytes=1, chain=2, repeats=1, device="cpu"),
    "torch_stream_bandwidth_gbps": lambda: probes.torch_stream_bandwidth_gbps(
        mbytes=1, chain=2, repeats=1, device="cpu"),
    "dma_chunk_bandwidth_gbps": lambda: probes.dma_chunk_bandwidth_gbps(
        256, 512, parent=1024, reps=1, device="cpu"),
    "vmem_bandwidth_gbps": lambda: probes.vmem_bandwidth_gbps(
        mbytes=0.0625, n_iters=2, repeats=1, device="cpu"),
    "dma_latency_ns": lambda: probes.dma_latency_ns(
        n_iters=16, repeats=1, device="cpu"),
    "hbm_copy_manual_gbps": lambda: probes.hbm_copy_manual_gbps(
        mbytes=1, rows=32, cols=256, reps=1, repeats=1, device="cpu"),
}


@pytest.mark.parametrize("reading", sorted(READINGS))
def test_reading_is_positive_on_the_cpu(reading):
    value = READINGS[reading]()
    if reading == "dma_latency_ns":
        assert value >= 0.0
    else:
        assert value > 0.0


def test_ceilings_off_the_card():
    """Off the card only the data sheet's ceilings exist; the derived ones
    (SFU, shared memory) need a card and its clock."""
    ceil = probes.ceilings("cpu")
    assert ceil["bf16"][0] == pytest.approx(989_000.0)
    assert ceil["int8"][0] == pytest.approx(1_979_000.0)
    assert ceil["hbm"][0] == pytest.approx(3_350.0)
    assert ceil["sfu"] == (None, "none") and ceil["smem"] == (None, "none")
