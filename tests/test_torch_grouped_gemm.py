"""Port parity: the grouped (ragged) GEMM against the JAX package's, on the
CPU.

The JAX side runs as its own tests run it: ``grouped_matmul`` with the
Pallas kernels in interpret mode. The port's ``grouped_matmul`` takes its
plain version (``grouped_matmul_ref``) for CPU tensors. Inputs come from
numpy (seeded) and go to both sides as the same bytes.

Tolerance: GMM_REL of max |y|. Both sides take fp32 products of the same
fp32 values (each stack value is exact in fp32), summed in another order
(measured up to 3e-7). The card's kernel is held to its plain version in
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from how_to_optimize_gemm_tpu.ops import pallas_grouped_gemm as jgg
from how_to_optimize_gemm_tpu.ops import quant as jquant
from how_to_optimize_gemm_tpu_torch.ops import grouped_gemm as gg
from how_to_optimize_gemm_tpu_torch.ops import quant

torch.set_num_threads(1)

GMM_REL = 1e-5
BT = 8


def _stack(kind: str, e: int, d: int, f: int, seed: int):
    """(w, scales, packed4) as numpy arrays of one stack kind."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((e, d, f)) * d ** -0.5).astype(np.float32)
    if kind == "fp32":
        return w, None, False
    if kind == "bf16":
        return np.asarray(jnp.asarray(w, jnp.bfloat16)), None, False
    bits = 8 if kind == "int8" else 4
    q, s = jquant.quantize_symmetric(jnp.asarray(w), axis=1, bits=bits)
    if bits == 4:
        q = jnp.stack([jquant.pack_int4(qe, d) for qe in q])
    return np.asarray(q), np.asarray(s), bits == 4


def _torch(a):
    if a is None:
        return None
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


# (E, d, f, block_expert): a regular layout; f not a multiple of 128 with
# expert 1 owning no block (a zero-token expert's block belongs to it in
# the model's layout; here it is simply never read)
LAYOUTS = {"aligned": (3, 32, 256, [0, 0, 1, 2, 2, 2]),
           "ragged_f": (4, 24, 200, [0, 2, 2, 3])}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8", "int4"])
def test_grouped_matmul_matches_jax(kind, layout):
    e, d, f, be = LAYOUTS[layout]
    w, s, packed4 = _stack(kind, e, d, f, seed=len(be))
    x = np.random.default_rng(1).standard_normal(
        (len(be) * BT, d)).astype(np.float32)
    be = np.asarray(be, np.int32)
    ref = np.asarray(jgg.grouped_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(be),
        None if s is None else jnp.asarray(s), bt=BT, packed4=packed4))
    got = gg.grouped_matmul(_torch(x), _torch(w), _torch(be), _torch(s),
                            bt=BT, packed4=packed4)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    err = np.abs(got.numpy() - ref).max()
    assert err <= GMM_REL * np.abs(ref).max(), err


def test_pick_block_matches_jax():
    for dim, cap in ((14336, 512), (1408, 512), (200, 512), (1280, 512),
                     (4096, 4096), (384, 256)):
        assert gg._pick_block(dim, cap) == jgg._pick_block(dim, cap)


def test_int4_stack_packs_as_jax_vmap():
    """quant.pack_int4 over a leading expert axis (block_k = d) gives the
    bytes of the reference's jax.vmap(pack_int4), and unpacks back."""
    import jax
    q = np.random.default_rng(2).integers(-7, 8, (3, 24, 10)).astype(np.int8)
    ref = np.asarray(jax.vmap(lambda q2: jquant.pack_int4(q2, 24))(
        jnp.asarray(q)))
    got = quant.pack_int4(torch.from_numpy(q), 24)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(quant.unpack_int4(got, 24).numpy(), q)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((16, 8))
    w = torch.zeros((2, 8, 4))
    be = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="blocks of"):
        gg.grouped_matmul(x, w, be[:1], bt=BT)
    with pytest.raises(ValueError, match="packed4 requires scales"):
        gg.grouped_matmul(x, w[:, :4].to(torch.int8), be, bt=BT,
                          packed4=True)
    with pytest.raises(ValueError, match="scales"):
        gg.grouped_matmul(x, w, be, torch.ones((2, 1, 3)), bt=BT)
    # it has a backward: dx = dy @ w[e]^T per block, 4 ones a row here
    y = gg.grouped_matmul(x.requires_grad_(), torch.ones_like(w), be, bt=BT)
    y.sum().backward()
    assert torch.equal(x.grad, torch.full((16, 8), 4.0))
    with torch.no_grad():
        assert gg.grouped_matmul(x, w, be, bt=BT).shape == (16, 4)
