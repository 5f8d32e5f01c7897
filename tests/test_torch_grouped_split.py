"""The grouped GEMM's wgmma route, its host side and its arithmetic, on
the CPU: the plain version of ``split_bf16`` (the pre-pass of the forward,
dx and dW), plain-PyTorch emulations of dW's three bf16 products summed in
fp32 every 256 rows against ``grouped_dw_ref`` and of dx's two products
summed every 1,024 K against ``grouped_matmul_t_ref``, and the wrapper's
rules for the card (the stack as the kernels read it, the refusals, dy
split once in the dense backward)."""
import numpy as np
import pytest
import torch

from how_to_optimize_gemm_tpu_torch.ops import grouped_gemm as gg
from how_to_optimize_gemm_tpu_torch.ops import quant
from how_to_optimize_gemm_tpu_torch.ops.vendor import fp32_matmul

torch.set_num_threads(1)

# dW's rule on the card (chip_smoke.py, tests/test_torch_cuda.py): within
# 1e-5 of max |plain|
FP32_REL = 1e-5
# the rows a dW consumer sums in wgmma before adding into fp32 registers
# (csrc/grouped_dw.cu: 4 stages of 64 rows)
DW_CHUNK = 256
# dx's rule on the card (chip_smoke.py GROUPED_REL): within 1e-4 of max
# |plain|; a dx consumer sums 16 stages of 64 K values in wgmma before
# adding into fp32 registers (csrc/grouped_gemm.cuh)
GROUPED_REL = 1e-4
DX_CHUNK = 1024


def _x(rows, cols, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (rng.standard_normal((rows, cols)) * scale).astype(np.float32))


@pytest.mark.parametrize("shape", [(1, 1), (7, 36), (130, 64), (33, 1000)])
@pytest.mark.parametrize("scale", [2.0 ** -20, 1.0, 2.0 ** 20])
def test_split_bound(shape, scale):
    """hi + lo is x to 2^-17 |x| in every element; the planes are bf16,
    their rows padded to a multiple of 8 values with zeros."""
    x = _x(*shape, seed=shape[0] * 7 + shape[1], scale=scale)
    s = gg.split_bf16(x)
    rows, cols = shape
    assert s.dtype == torch.bfloat16
    assert s.shape == (2, rows, -(-cols // 8) * 8)
    assert not s[:, :, cols:].any()
    hi, lo = s[0, :, :cols].float(), s[1, :, :cols].float()
    assert torch.equal(hi, x.to(torch.bfloat16).float())
    assert torch.all((x - hi - lo).abs() <= 2.0 ** -17 * x.abs())


def test_split_of_exact_bf16_values_has_no_low_part():
    x = _x(16, 24, seed=3).to(torch.bfloat16).float()
    s = gg.split_bf16(x)
    assert torch.equal(s[0].float(), x) and not s[1].any()


def test_split_refuses_non_matrices():
    with pytest.raises(ValueError, match="2-D"):
        gg.split_bf16(torch.zeros(3, 4, 5))


def _skewed_layout(e, blocks, bt, d, f, seed):
    """Rows in expert order, expert e0 owning blocks[0] blocks and so on
    (zero blocks: an expert with no row); the padding rows of each block
    past its tokens zero."""
    be = torch.tensor([i for i, n in enumerate(blocks) for _ in range(n)],
                      dtype=torch.int32)
    tp = be.shape[0] * bt
    x, dy = _x(tp, d, seed), _x(tp, f, seed + 1)
    real = torch.from_numpy(
        np.random.default_rng(seed + 2).random(tp) < 0.9)[:, None]
    return x * real, dy * real, be


def _dw_emulated(x, dy, be, e, bt):
    """dW the way csrc/grouped_dw.cu sums it: x and dy split into bf16 hi
    + lo, each 256-row chunk of an expert's rows hi.hi + hi.lo + lo.hi in
    fp32 (every partial product exact), the chunks added in fp32 in row
    order."""
    xs, dys = gg.split_bf16(x).float(), gg.split_bf16(dy).float()
    d, f = x.shape[1], dy.shape[1]
    xh, xl = xs[0, :, :d], xs[1, :, :d]
    yh, yl = dys[0, :, :f], dys[1, :, :f]
    out = torch.zeros((e, d, f))
    for ei in range(e):
        blocks = (be == ei).nonzero().flatten().tolist()
        if not blocks:
            continue
        r0, r1 = blocks[0] * bt, (blocks[-1] + 1) * bt
        for c in range(r0, r1, DW_CHUNK):
            rows = slice(c, min(c + DW_CHUNK, r1))
            part = (fp32_matmul(xh[rows].t(), yh[rows])
                    + fp32_matmul(xh[rows].t(), yl[rows])
                    + fp32_matmul(xl[rows].t(), yh[rows]))
            out[ei] += part
    return out


@pytest.mark.parametrize("blocks", [(64, 1, 0, 2), (3, 9, 1, 0), (0, 0, 5, 2)])
def test_dw_three_products_meet_the_fp32_rule(blocks):
    """The route's arithmetic (three bf16 products, fp32 sums every 256
    rows) against the plain version under FP32_REL, one expert owning
    8,192 rows (64 blocks) in the first layout, an expert with no row in
    each."""
    bt = 128
    x, dy, be = _skewed_layout(len(blocks), blocks, bt, 48, 40, sum(blocks))
    ref = gg.grouped_dw_ref(x, dy, be, len(blocks), bt=bt)
    got = _dw_emulated(x, dy, be, len(blocks), bt)
    err = float((got - ref).abs().max())
    assert err <= FP32_REL * float(ref.abs().max()), err
    for ei, n in enumerate(blocks):
        if n == 0:
            assert not got[ei].any() and not ref[ei].any()


def _stack(kind, e, d, f):
    w = _x(e * d, f, seed=d + f).reshape(e, d, f) * d ** -0.5
    if kind in ("fp32", "bf16"):
        return (w if kind == "fp32" else w.to(torch.bfloat16)), None, False
    q, s = quant.quantize_symmetric(w, axis=1, bits=8 if kind == "int8"
                                    else 4)
    return ((quant.pack_int4(q, d), s, True) if kind == "int4"
            else (q, s, False))


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4", "fp32"])
def test_stack_is_not_copied_at_aligned_widths(kind):
    """At a width of a multiple of 16 (Mixtral's 4,096 and 14,336 are) the
    kernel reads the stack itself: no copy of the stack."""
    w, s, packed4 = _stack(kind, 2, 64, 256)
    k = gg._stack_kind(w, packed4, s)
    assert gg._stack_operand(w, k).data_ptr() == w.data_ptr()


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4", "fp32"])
@pytest.mark.parametrize("f", [130, 198])
def test_stack_rows_padded_to_16_bytes_elsewhere(kind, f):
    """At other widths the rows are padded with zero columns to a multiple
    of 16 bytes (4 floats for the FFMA kernel), the values unchanged."""
    w, s, packed4 = _stack(kind, 2, 36, f)
    k = gg._stack_kind(w, packed4, s)
    got = gg._stack_operand(w, k)
    assert (got.shape[2] * got.element_size()) % 16 == 0
    assert got.shape[2] - f < 16 // got.element_size()
    assert torch.equal(got[:, :, :f], w) and not got[:, :, f:].any()


def test_forward_refuses_what_the_card_has_no_kernel_for():
    w, s, _ = _stack("int8", 2, 64, 128)
    assert gg._stack_kind(w, False, s) == 1
    gg._check_bt(gg.KERNEL, 256)
    with pytest.raises(ValueError, match="multiple of"):
        gg._check_bt(gg.KERNEL, 64)
    with pytest.raises(TypeError, match="no kernel"):
        gg._stack_kind(w.to(torch.int16), False, s)
    with pytest.raises(TypeError, match="no kernel"):
        gg._stack_kind(w.to(torch.bfloat16), True, s)
    with pytest.raises(TypeError, match="float32"):
        gg._stack_kind(w, False, s.to(torch.bfloat16))


def _dx_columns(w, kind):
    """Each expert's stack (E, dout, f) as the dx kernel decodes it, one
    output column n at a time: a packed stack's column n < dout/2 is the
    low nibble of packed row n, (b & 0xF) - 8, the others the high nibble
    of row n - dout/2, the signed byte's b >> 4; every value exact in
    bf16."""
    if kind != "int4":
        return w.to(torch.float32)
    b = w.to(torch.int32)
    return torch.cat([(b & 0xF) - 8, b >> 4], dim=1).to(torch.float32)


def _dx_emulated(dy, w, be, kind, bt):
    """dx the way csrc/grouped_gemm.cuh sums it: dy split into bf16 hi +
    lo, each block's 1,024-value K chunks hi . W^T + lo . W^T in fp32
    (every partial product exact), the chunks added in fp32 in order."""
    planes = gg.split_bf16(dy).float()
    f = dy.shape[1]
    hi, lo = planes[0, :, :f], planes[1, :, :f]
    cols = _dx_columns(w, kind)
    out = torch.zeros((dy.shape[0], cols.shape[1]))
    for i, e in enumerate(be.tolist()):
        rows = slice(i * bt, (i + 1) * bt)
        for c in range(0, f, DX_CHUNK):
            k = slice(c, c + DX_CHUNK)
            we = cols[e][:, k].t()
            out[rows] += (fp32_matmul(hi[rows, k], we)
                          + fp32_matmul(lo[rows, k], we))
    return out


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("dout", [36, 200, 256])
def test_dx_two_products_meet_the_rule(kind, dout):
    """dx's arithmetic (dy split, two bf16 products, fp32 sums every 1,024
    K) on bf16-exact stacks against the plain version under GROUPED_REL,
    at K = 2,100 (three chunks, the last short) and dout 36 and 200, whose
    dout/2 is not a multiple of 128 (a packed stack's column tile then
    straddles the nibble boundary); the column rule is ``unpack_int4``'s."""
    bt = 128
    w, _, packed4 = _stack(kind, 3, dout, 2100)
    be = torch.tensor([0, 2, 2, 1], dtype=torch.int32)
    dy = _x(be.shape[0] * bt, 2100, seed=dout)
    if packed4:
        assert torch.equal(_dx_columns(w, kind),
                           quant.unpack_int4(w, dout).to(torch.float32))
        ref = gg.grouped_matmul_t4_ref(dy, w, be, bt=bt)
    else:
        ref = gg.grouped_matmul_t_ref(dy, w, be, bt=bt)
    got = _dx_emulated(dy, w, be, kind, bt)
    err = float((got - ref).abs().max())
    assert err <= GROUPED_REL * float(ref.abs().max()), err


def test_dense_backward_splits_dy_once(monkeypatch):
    """The card path of a dense stack's forward and backward, driven on
    meta tensors with the launches recorded (none runs): dy is split once
    and the same planes reach grouped_gemm_t and grouped_dw; x is split
    for the forward and for dW."""
    launches = []
    monkeypatch.setattr(gg, "require_cuda", lambda name, x: None)
    monkeypatch.setattr(gg._build, "launch",
                        lambda name, device, *args: launches.append(
                            (name, args)))
    e, d, f, tp = 3, 64, 96, 384
    x = torch.empty((tp, d), device="meta", requires_grad=True)
    w = torch.empty((e, d, f), dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    be = torch.empty((tp // 128,), dtype=torch.int32, device="meta")
    gg.grouped_matmul(x, w, be).backward(torch.empty((tp, f),
                                                     device="meta"))
    names = [name for name, _ in launches]
    assert sorted(names) == sorted(["split_bf16"] * 3 + [
        "grouped_gemm", "grouped_gemm_t", "grouped_dw"])
    splits = [args for name, args in launches if name == "split_bf16"]
    assert sorted(tuple(a[0].shape) for a in splits) == [(tp, d), (tp, d),
                                                         (tp, f)]
    dys = next(a[1] for a in splits if tuple(a[0].shape) == (tp, f))
    t_args = next(args for name, args in launches
                  if name == "grouped_gemm_t")
    dw_args = next(args for name, args in launches if name == "grouped_dw")
    assert t_args[0] is dys and dw_args[1] is dys
