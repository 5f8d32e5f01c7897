"""The hand-written Hopper kernels against their plain versions, on the card.

Every test here needs a CUDA device and nvcc and skips without them (the
``cuda`` marker). This file imports no JAX, so it also runs on a machine
without it; from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: each int8 GEMM kernel must EQUAL its plain version (exact
int32 accumulation, the same epilogue order), and the ladder's kernels
stay under their rung's gate_rel against an fp64 oracle of the effective
operands. The float ladder kernels' and the serving kernels' tolerances
are stated above their tests.
"""
import numpy as np
import pytest
import torch

from how_to_optimize_gemm_tpu_torch import _build, convert
from how_to_optimize_gemm_tpu_torch.harness.driver import run_sweep
from how_to_optimize_gemm_tpu_torch.harness.parameters import SweepConfig
from how_to_optimize_gemm_tpu_torch.ops import (attention, decode_attention,
                                               int4, int8, k_blocked,
                                               kv_update, mn_tile, naive,
                                               paged_attention, registry,
                                               tuned, vendor)

pytestmark = pytest.mark.cuda

# (M, N, K): aligned, nothing aligned (K=72 and K=1100 rows are not
# 16-byte multiples), two pack blocks, odd tiny edges, a full sweep size.
SHAPES = [(256, 256, 256), (200, 136, 72), (128, 384, 1024),
          (1000, 1032, 1100), (1000, 1032, 3584), (17, 9, 40), (1, 1, 1),
          (4096, 4096, 4096)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        _build.nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda")


def _abc(shape, seed, device):
    m, n, k = shape
    rng = np.random.default_rng(seed)
    a, b, c = (torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32))
               .to(device) for s in ((m, k), (k, n), (m, n)))
    return a, b, c


# The float ladder kernels: products of bf16 values (and of int4 weights
# decoded to bf16) are exact in fp32, and the tensor cores sum them in
# another order than the plain version: within W4A16_REL of max |plain|.
# The FFMA kernels sum one fmaf chain over K, the plain version in
# cuBLAS's fp32 order: within FP32_REL of max |plain|.
W4A16_REL = 2e-5
FP32_REL = 1e-5
CASES = {
    # kernel: (rung that prepares its operands, wrapper, plain version,
    # tolerance relative to max |plain|: 0 is EQUAL)
    "int8_gemm_nn": ("06_pallas_int8", int8.mmult_q, int8.mmult_q_ref, 0.0),
    "int8_gemm_nt": ("14_packed_alias_int8", int8.mmult_q_bt,
                     int8.mmult_q_bt_ref, 0.0),
    "w4a8_gemm": ("07b_pallas_w4a8", int4.mmult_q_w4a8,
                  int4.mmult_q_w4a8_ref, 0.0),
    "bf16_gemm_nt": ("15_packed_alias_bf16", tuned.mmult_bf16_bt,
                     tuned.mmult_bf16_bt_ref, W4A16_REL),
    "bf16_gemm_nn": ("05_pallas_bf16", tuned.mmult_bf16,
                     tuned.mmult_bf16_ref, W4A16_REL),
    "fp32_gemm_nt": ("16_packed_alias_fp32", tuned.mmult_fp32_bt,
                     tuned.mmult_fp32_bt_ref, FP32_REL),
    "fp32_gemm_nn": ("04_pallas_tuned_fp32", tuned.mmult, tuned.mmult_ref,
                     FP32_REL),
    "w4a16_gemm": ("07_pallas_int4", int4.mmult_q, int4.mmult_q_ref,
                   W4A16_REL),
}


def _operands(prepared):
    """The kernel's operands: 07's and 07b's prepare add kdim."""
    return [x for x in prepared if isinstance(x, torch.Tensor)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kernel", sorted(CASES))
def test_kernel_equals_plain_version(cuda, kernel, shape):
    rung_name, wrapper, plain, tol = CASES[kernel]
    rung = registry.get(rung_name)
    a, b, c = _abc(shape, SHAPES.index(shape), cuda)
    prepared = rung.prepare(a, b)
    ops = _operands(prepared)
    before = _build.LAUNCHES[kernel]
    out = wrapper(*ops, c.clone())
    torch.cuda.synchronize()
    assert _build.LAUNCHES[kernel] == before + 1
    ref = plain(*ops, c)
    assert out.shape == c.shape
    err = float((out - ref).abs().max())
    if tol == 0.0:
        assert torch.equal(out, ref), err
    else:
        scale = float(ref.abs().max())
        print(f"{kernel} {shape}: max|kernel - plain| = {err:.3e} of "
              f"max|y| {scale:.3e}")
        assert err <= tol * scale, err / scale
    ae, be = rung.effective(prepared)
    oracle = ae.double() @ be.double() + c.double()
    rel = float((out.double() - oracle).abs().max()
                / oracle.abs().max().clamp_min(1e-30))
    assert rel < rung.gate_rel, rel


def test_in_place_kernels_write_c(cuda):
    """Rungs 14, 07b, 07, 15 and 16 write the result into C itself."""
    a, b, c = _abc((300, 260, 520), 1, cuda)
    for kernel in ("int8_gemm_nt", "w4a8_gemm", "w4a16_gemm",
                   "bf16_gemm_nt", "fp32_gemm_nt"):
        rung_name, wrapper, plain, tol = CASES[kernel]
        ops = _operands(registry.get(rung_name).prepare(a, b))
        c2 = c.clone()
        out = wrapper(*ops, c2)
        assert out.data_ptr() == c2.data_ptr(), kernel
        ref = plain(*ops, c)
        assert float((c2 - ref).abs().max()) <= tol * float(
            ref.abs().max()), kernel


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    a, b, c = _abc((64, 64, 64), 2, cuda)
    qa, sa, qb, sb = int8.prepare(a, b)
    with pytest.raises(ValueError):
        int8.mmult_q(qa, sa, qb, sb, c.t())        # non-contiguous C
    with pytest.raises(TypeError):
        int8.mmult_q(qa.float(), sa, qb, sb, c)    # wrong dtype
    with pytest.raises(ValueError):
        int8.mmult_q(qa, sa, qb[:32], sb, c)       # K mismatch


@pytest.mark.parametrize("name", registry.names())
def test_rung_sweep_on_card(cuda, name):
    rows = run_sweep(name, SweepConfig(pfirst=256, plast=768, pinc=512,
                                       nrepeats=2, warmup=1),
                     verbose=False, device=cuda)
    assert all(r.kernel_rel < registry.get(name).gate_rel for r in rows)


# The fp32 rungs below 04 (00, 02, 03 and 03b): each output one fmaf
# chain over K, against the plain version's cuBLAS fp32 order: within
# FP32_REL of max |plain|. (rung, kernel, wrapper, plain version)
BASE_RUNGS = {
    "00_naive_vpu": ("naive_gemm", naive.mmult, naive.naive_ref),
    "02_pallas_mn_tile": ("fp32_gemm_mn_tile", mn_tile.mmult,
                          mn_tile.mn_tile_ref),
    "03_pallas_k_blocked": ("fp32_gemm_k_blocked", k_blocked.mmult,
                            k_blocked.k_blocked_ref),
    "03b_pallas_small_blocks": ("fp32_gemm_k_blocked",
                                k_blocked.mmult_small,
                                k_blocked.k_blocked_ref),
}
# K and N rows not 16-byte multiples; p = 1024; edges smaller than one
# block (and than a warp); one block edge and a bit
BASE_SHAPES = [(999, 1030, 1101), (1024, 1024, 1024), (17, 9, 40),
               (130, 260, 300)]


@pytest.mark.parametrize("shape", BASE_SHAPES)
@pytest.mark.parametrize("rung_name", sorted(BASE_RUNGS))
def test_ladder_base_kernels_equal_plain_version(cuda, rung_name, shape):
    kernel, wrapper, plain = BASE_RUNGS[rung_name]
    a, b, c = _abc(shape, 50 + BASE_SHAPES.index(shape), cuda)
    c_in = c.clone()
    before = _build.LAUNCHES[kernel]
    out = wrapper(a, b, c)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[kernel] == before + 1
    assert torch.equal(c, c_in)                  # a fresh output
    ref = plain(a, b, c)
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    print(f"{rung_name} {shape}: max|kernel - plain| = {err:.3e} of "
          f"max|y| {scale:.3e}")
    assert err <= FP32_REL * scale, err / scale
    oracle = a.double() @ b.double() + c.double()
    rel = float((out.double() - oracle).abs().max() / oracle.abs().max())
    assert rel < registry.get(rung_name).gate_rel, rel


def test_k_blocked_refuses_other_blocks(cuda):
    a, b, c = _abc((64, 64, 64), 4, cuda)
    with pytest.raises(ValueError):
        k_blocked.mmult(a, b, c, block=32)
    with pytest.raises(ValueError):
        naive.mmult(a, b[:32], c)                  # K mismatch


# ---------------------------------------------------------------- serving
# The four serving kernels. Kernels w4a8_gemm_noc, w4a8_gemv_fq and
# kv_update must EQUAL their plain versions (exact int32 sums and the same
# epilogue order; byte copies). decode_attention sums in another order
# than its plain version, and p is rounded to bf16 after an exp that may
# differ by an ulp, which can flip one bf16 rounding: atol 2e-3 on outputs
# of magnitude ~1.

def _w4a8_weights(k, n, seed, device):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    _, _, packed, sw, _ = int4.prepare_w4a8(torch.zeros((1, k)), w)
    return packed.to(device), sw.to(device)


def _activations(m, k, seed, device):
    """Rows of x with an all-zero row (the 1e-8 scale floor) and one row
    of exact .5 ties after scaling (amax 127 gives scale 1)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    if m > 1:
        x[1] = 0.0
    if m > 2:
        x[2] = np.round(rng.uniform(-120, 120, k)) + 0.5
        x[2, 0] = 127.0
    return torch.from_numpy(x).to(device)


@pytest.mark.parametrize("m,n,k", [(65, 384, 700), (200, 136, 72),
                                   (1, 9, 40), (1024, 1032, 1100),
                                   (300, 4096, 4096)])
def test_w4a8_gemm_noc_equals_plain_version(cuda, m, n, k):
    x = _activations(m, k, m + n, cuda)
    qa, sa = int4.quant.quantize_symmetric(x, axis=1)
    packed, sw = _w4a8_weights(k, n, k, cuda)
    before = _build.LAUNCHES["w4a8_gemm_noc"]
    out = int4.mmult_q_w4a8_noc(qa, sa, packed, sw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["w4a8_gemm_noc"] == before + 1
    ref = int4.mmult_q_w4a8_noc_ref(qa, sa, packed, sw)
    assert out.shape == (m, n)
    assert torch.equal(out, ref), float((out - ref).abs().max())


@pytest.mark.parametrize("m", [1, 4, 5, 64])
@pytest.mark.parametrize("n,k", [(384, 700), (1000, 4096), (4096, 11008)])
def test_w4a8_gemv_fq_equals_plain_version(cuda, m, n, k):
    x = _activations(m, k, 7 * m + k, cuda)
    packed, sw = _w4a8_weights(k, n, n, cuda)
    before = _build.LAUNCHES["w4a8_gemv_fq"]
    out = int4.mmult_w4a8_fused_noc(x, packed, sw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["w4a8_gemv_fq"] == before + 1
    ref = int4.mmult_w4a8_fused_noc_ref(x, packed, sw)
    assert out.shape == (m, n)
    assert torch.equal(out, ref), float((out - ref).abs().max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("rest", [(2, 128), (3, 5)])
def test_kv_update_equals_plain_version(cuda, dtype, s, rest):
    b, t = 4, 64
    rng = np.random.default_rng(s)
    cache = torch.from_numpy(
        rng.standard_normal((b, t, *rest)).astype(np.float32)).to(
            device=cuda, dtype=dtype)
    new = torch.from_numpy(
        rng.standard_normal((b, s, *rest)).astype(np.float32)).to(cuda)
    pos = torch.tensor([0, t - 2, -2, 17], dtype=torch.int32, device=cuda)
    mask = torch.tensor([True, True, True, False], device=cuda)
    for wm in (None, mask):
        got = cache.clone()
        before = _build.LAUNCHES["kv_update"]
        out = kv_update.kv_update(got, new, pos, wm)
        torch.cuda.synchronize()
        assert out.data_ptr() == got.data_ptr()
        assert _build.LAUNCHES["kv_update"] == before + 1
        ref = kv_update.kv_update_ref(cache.clone(), new, pos, wm)
        assert torch.equal(got, ref)


@pytest.mark.parametrize("kvh,rep,d", [(2, 2, 128), (16, 1, 128),
                                       (4, 4, 64), (8, 4, 128), (3, 2, 32)])
def test_decode_attention_matches_plain_version(cuda, kvh, rep, d):
    b, t = 4, 256
    rng = np.random.default_rng(kvh * rep * d)
    q = torch.from_numpy(rng.standard_normal((b, kvh * rep, d)).astype(
        np.float32)).to(cuda)
    k, v = (torch.from_numpy(rng.standard_normal((b, t, kvh, d)).astype(
        np.float32)).to(device=cuda, dtype=torch.bfloat16) for _ in "kv")
    lengths = torch.tensor([1, 129, 256, 0], dtype=torch.int32,
                           device=cuda)
    bk = 128
    # rows past each slot's last live chunk are never read: NaN there
    # must not reach the output
    for c in (k, v):
        c[0, bk:] = float("nan")
        c[3] = float("nan")
    before = _build.LAUNCHES["decode_attention"]
    out = decode_attention.decode_attention(q, k, v, lengths, bk=bk)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["decode_attention"] == before + 1
    ref = decode_attention.decode_attention_ref(q, k, v, lengths, bk=bk)
    assert out.shape == (b, kvh * rep * d)
    assert torch.isfinite(out).all()
    err = float((out - ref).abs().max())
    print(f"decode_attention kvh={kvh} rep={rep} d={d}: max|kernel - "
          f"plain| = {err}")
    assert err < 2e-3, err


# Slice 3's kernels. int8_gemm_noc must EQUAL its plain version (exact
# int32 sums, the same epilogue). The W4A16 kernels' products are exact in
# fp32 but summed in another order (by the tensor cores for the GEMM, whose
# fp32 adds do not round as IEEE does): within W4A16_REL of max |y|.
# decode_attention_q8 as decode_attention: atol 2e-3.


@pytest.mark.parametrize("m,n,k", [(256, 256, 256), (300, 136, 72),
                                   (1, 9, 40), (1000, 1032, 1100),
                                   (1024, 11008, 4096)])
def test_int8_gemm_noc_equals_plain_version(cuda, m, n, k):
    x = _activations(m, k, m + n, cuda)
    qa, sa = int8.quant.quantize_symmetric(x, axis=1)
    w = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (k, n)).astype(np.float32)).to(cuda)
    qb, sb = int8.quant.quantize_symmetric(w, axis=0)
    before = _build.LAUNCHES["int8_gemm_noc"]
    out = int8.mmult_q_noc(qa, sa, qb, sb)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["int8_gemm_noc"] == before + 1
    ref = int8.mmult_q_noc_ref(qa, sa, qb, sb)
    assert out.shape == (m, n)
    assert torch.equal(out, ref), float((out - ref).abs().max())


@pytest.mark.parametrize("m,k,n", [(1, 40, 8), (3, 4096, 4096),
                                   (17, 72, 136), (100, 1100, 1032),
                                   (5, 70, 30)])
def test_int_matmul_equals_exact_product(cuda, m, k, n):
    """The int8 linear's product below the kernel widths (torch._int_mm
    with k and n zero-padded to multiples of 8 and the rows to 32): the
    int32 accumulators equal the fp64 product's."""
    rng = np.random.default_rng(m * k)
    x = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
    y = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8))
    got = int8.int_matmul(x.to(cuda), y.to(cuda))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, int8.int_matmul_exact(x.to(cuda), y.to(cuda)))


def _w4a16_case(m, n, k, seed, device):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    packed, sw = _w4a8_weights(k, n, seed + 1, device)
    return a.to(device=device, dtype=torch.bfloat16), packed, sw


@pytest.mark.parametrize("m,n,k", [(1, 9, 40), (4, 11008, 4096),
                                   (4, 4096, 11008), (5, 1032, 1100),
                                   (64, 384, 700), (65, 384, 700),
                                   (300, 136, 72), (1000, 1032, 1100),
                                   (1024, 11008, 4096)])
def test_w4a16_kernels_match_plain_version(cuda, m, n, k):
    a, packed, sw = _w4a16_case(m, n, k, m + n + k, cuda)
    name = "w4a16_gemv" if m <= int4.GEMV_MAX_M else "w4a16_gemm_noc"
    before = _build.LAUNCHES[name]
    out = int4.mmult_q_noc(a, packed, sw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 1
    ref = int4.mmult_q_noc_ref(a, packed, sw)
    assert out.shape == (m, n)
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    print(f"{name} m={m} n={n} k={k}: max|kernel - plain| = {err:.3e} "
          f"of max|y| {scale:.3e}")
    assert err <= W4A16_REL * scale, err / scale


def test_float_wrappers_reject_what_the_kernels_do_not_take(cuda):
    a, b, c = _abc((64, 48, 32), 3, cuda)
    with pytest.raises(ValueError):
        tuned.mmult(a, b, c.t().contiguous().t())   # non-contiguous C
    with pytest.raises(TypeError):
        tuned.mmult_fp32_bt(a.to(torch.bfloat16), b.t().contiguous(), c)
    with pytest.raises(ValueError):
        tuned.mmult_bf16_bt(*tuned.prepare_bf16_bt(a, b[:, :40]), c)


def test_fp32_products_keep_the_callers_tf32_flag(cuda):
    """With TF32 turned on by the caller, the fp32 linear and rung 01 run
    at fp32 accuracy (TF32 would read ~1e-3) and leave the flag on."""
    from how_to_optimize_gemm_tpu_torch.models import linear
    flags = torch.backends.cuda.matmul
    saved = (flags.allow_tf32, torch.get_float32_matmul_precision())
    rng = np.random.default_rng(3)
    x, w, c = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((256, 1024), (1024, 512), (256, 512)))
    ref = x.double() @ w.double()
    try:
        flags.allow_tf32 = True
        y = linear.apply_linear(linear.make_linear(w.to(cuda), "fp32"),
                                x.to(cuda))
        assert flags.allow_tf32
        y01 = vendor.mmult(x.to(cuda), w.to(cuda), c.to(cuda))
        assert flags.allow_tf32
    finally:
        flags.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])
    for out, want in ((y, ref), (y01, ref + c.double())):
        rel = float((out.cpu().double() - want).abs().max()
                    / want.abs().max())
        assert rel < 1e-5, rel


@pytest.mark.parametrize("kvh,rep,d", [(2, 2, 128), (16, 1, 128),
                                       (4, 4, 64), (8, 4, 128), (3, 2, 32)])
def test_decode_attention_q8_matches_plain_version(cuda, kvh, rep, d):
    from how_to_optimize_gemm_tpu_torch.models import llama
    b, t = 4, 256
    rng = np.random.default_rng(kvh * rep * d)
    q = torch.from_numpy(rng.standard_normal((b, kvh * rep, d)).astype(
        np.float32)).to(cuda)
    cache = []
    for _ in "kv":
        x = torch.from_numpy(rng.standard_normal((b, t, kvh, d)).astype(
            np.float32)).to(cuda)
        cache += llama.quantize_kv(x)
    lengths = torch.tensor([1, 129, 256, 0], dtype=torch.int32,
                           device=cuda)
    bk = 128
    # rows past each slot's last live chunk are never read: garbage (and
    # NaN scales) there must not reach the output
    for c in cache:
        c[0, bk:] = float("nan") if c.is_floating_point() else 77
        c[3] = float("nan") if c.is_floating_point() else -77
    before = _build.LAUNCHES["decode_attention_q8"]
    out = decode_attention.decode_attention_q8(q, *cache, lengths, bk=bk)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["decode_attention_q8"] == before + 1
    ref = decode_attention.decode_attention_q8_ref(q, *cache, lengths, bk=bk)
    assert out.shape == (b, kvh * rep * d)
    assert torch.isfinite(out).all()
    err = float((out - ref).abs().max())
    print(f"decode_attention_q8 kvh={kvh} rep={rep} d={d}: max|kernel - "
          f"plain| = {err}")
    assert err < 2e-3, err


# Slice 4's kernels, over page pools through block tables.
# paged_kv_update must EQUAL its plain version (byte copies; trash-page and
# masked rows skipped by both). The paged attention kernels sum as the
# contiguous ones do: atol 2e-3 against their plain versions.

def _shuffled_table(lengths, ps, np_max, seed):
    """Pages 1 .. NP-1 handed out in a shuffled order; chunks past a
    slot's length stay 0."""
    rng = np.random.default_rng(seed)
    n_pages = len(lengths) * np_max + 1
    free = list(rng.permutation(np.arange(1, n_pages)))
    table = np.zeros((len(lengths), np_max), np.int32)
    for b, n in enumerate(lengths):
        for c in range(-(-n // ps)):
            table[b, c] = free.pop()
    return n_pages, table


@pytest.mark.parametrize("kind", ["bf16", "int8", "fp32 scales", "odd"])
@pytest.mark.parametrize("s", [1, 4])
def test_paged_kv_update_equals_plain_version(cuda, kind, s):
    from how_to_optimize_gemm_tpu_torch.models import llama
    n_pages, ps, kvh, d, b = 16, 16, 4, 128, 3
    rng = np.random.default_rng(s)
    x = torch.from_numpy(rng.standard_normal(
        (n_pages, ps, kvh, d)).astype(np.float32)).to(cuda)
    new = torch.from_numpy(rng.standard_normal(
        (b, s, kvh, d)).astype(np.float32)).to(cuda)
    if kind == "bf16":
        pool = x.to(torch.bfloat16)
    elif kind == "odd":                  # a 3 x 5 fp32 row: byte copies
        pool = x[:, :, 0, :15].reshape(n_pages, ps, 3, 5).contiguous()
        new = new[:, :, 0, :15].reshape(b, s, 3, 5)
    else:
        (pool, spool), (new, snew) = llama.quantize_kv(x), \
            llama.quantize_kv(new)
        if kind == "fp32 scales":
            pool, new = spool, snew
    perm = rng.permutation(np.arange(1, n_pages))
    pages = torch.from_numpy(perm[:b * s].reshape(b, s).astype(np.int32))
    pages[0, 0] = 0                                 # a trash-page row
    offs = torch.from_numpy(rng.integers(0, ps, (b, s)).astype(np.int32))
    mask = torch.tensor([True, False, True], device=cuda)
    pages, offs = pages.to(cuda), offs.to(cuda)
    for wm in (None, mask):
        got = pool.clone()
        before = _build.LAUNCHES["paged_kv_update"]
        out = kv_update.paged_kv_update(got, new, pages, offs, wm)
        torch.cuda.synchronize()
        assert out.data_ptr() == got.data_ptr()
        assert _build.LAUNCHES["paged_kv_update"] == before + 1
        ref = kv_update.paged_kv_update_ref(pool.clone(), new, pages, offs,
                                            wm)
        assert torch.equal(got, ref)
        assert torch.equal(got[0], pool[0])         # page 0 untouched
        assert not torch.equal(got, pool)


# (kvh, rep, d, page, lengths): GQA and wide widths, pages of 16 and 128,
# and KV8-sized pages whose table (np_max * PS = 288) passes a 256-token
# max_seq
PAGED_CASES = [(2, 2, 128, 16, [1, 40, 64, 0]),
               (32, 1, 128, 128, [1, 300, 512, 129]),
               (4, 4, 64, 16, [17, 64, 3, 33]),
               (3, 2, 32, 96, [1, 200, 256, 0])]


def _nan_outside_the_tables(pools, table):
    """NaN (int8: 77) in page 0 and every page no table row holds: a
    kernel that reads one of them shows it."""
    unused = sorted(set(range(pools[0].shape[0])) - set(table.flatten())
                    | {0})
    for c in pools:
        c[unused] = float("nan") if c.is_floating_point() else 77


@pytest.mark.parametrize("kvh,rep,d,ps,lens", PAGED_CASES)
def test_paged_decode_attention_matches_plain_version(cuda, kvh, rep, d, ps,
                                                      lens):
    np_max = -(-max(lens) // ps) + 1
    n_pages, table = _shuffled_table(lens, ps, np_max, kvh + d)
    rng = np.random.default_rng(ps)
    q = torch.from_numpy(rng.standard_normal(
        (len(lens), kvh * rep, d)).astype(np.float32)).to(cuda)
    k, v = (torch.from_numpy(rng.standard_normal(
        (n_pages, ps, kvh, d)).astype(np.float32)).to(
            device=cuda, dtype=torch.bfloat16) for _ in "kv")
    _nan_outside_the_tables((k, v), table)
    table = torch.from_numpy(table).to(cuda)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = _build.LAUNCHES["paged_decode_attention"]
    out = paged_attention.paged_decode_attention(q, k, v, table, lengths)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["paged_decode_attention"] == before + 1
    ref = paged_attention.paged_decode_attention_ref(q, k, v, table,
                                                     lengths)
    assert torch.isfinite(out).all()
    err = float((out - ref).abs().max())
    print(f"paged_decode_attention kvh={kvh} rep={rep} d={d} ps={ps}: "
          f"max|kernel - plain| = {err}")
    assert err < 2e-3, err


@pytest.mark.parametrize("kvh,rep,d,ps,lens", PAGED_CASES)
def test_paged_decode_attention_q8_matches_plain_version(cuda, kvh, rep, d,
                                                         ps, lens):
    from how_to_optimize_gemm_tpu_torch.models import llama
    np_max = -(-max(lens) // ps) + 1
    n_pages, table = _shuffled_table(lens, ps, np_max, kvh + d + 1)
    rng = np.random.default_rng(ps + 1)
    q = torch.from_numpy(rng.standard_normal(
        (len(lens), kvh * rep, d)).astype(np.float32)).to(cuda)
    pools = []
    for _ in "kv":
        pools += llama.quantize_kv(torch.from_numpy(rng.standard_normal(
            (n_pages, ps, kvh, d)).astype(np.float32)).to(cuda))
    _nan_outside_the_tables(pools, table)
    table = torch.from_numpy(table).to(cuda)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = _build.LAUNCHES["paged_decode_attention_q8"]
    out = paged_attention.paged_decode_attention_q8(q, *pools, table,
                                                    lengths)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["paged_decode_attention_q8"] == before + 1
    ref = paged_attention.paged_decode_attention_q8_ref(q, *pools, table,
                                                        lengths)
    assert torch.isfinite(out).all()
    err = float((out - ref).abs().max())
    print(f"paged_decode_attention_q8 kvh={kvh} rep={rep} d={d} ps={ps}: "
          f"max|kernel - plain| = {err}")
    assert err < 2e-3, err


def test_paged_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((2, 4, 128), device=cuda)
    pool = torch.zeros((5, 16, 2, 128), dtype=torch.bfloat16, device=cuda)
    table = torch.zeros((2, 3), dtype=torch.int32, device=cuda)
    lengths = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):                  # an int64 table
        paged_attention.paged_decode_attention(q, pool, pool, table.long(),
                                               lengths)
    with pytest.raises(ValueError):                 # rep * PS > 8192
        big = torch.zeros((2, 8192, 1, 128), dtype=torch.bfloat16,
                          device=cuda)
        paged_attention.paged_decode_attention(q[:, :2], big, big, table,
                                               lengths)
    with pytest.raises(ValueError):                 # pages of another shape
        kv_update.paged_kv_update(pool, torch.zeros((2, 1, 2, 64),
                                                    device=cuda),
                                  table[:, :1], table[:, :1])


@pytest.mark.parametrize("kv8", [False, True])
def test_tiny_paged_engine_on_the_card(cuda, kv8):
    """The paged engine serves on the card with the prefix cache,
    chunked prefill and a pool small enough to preempt; every request
    completes and the paged kernels run."""
    from how_to_optimize_gemm_tpu_torch.models import llama
    from how_to_optimize_gemm_tpu_torch.parallel import serving
    cfg = llama.LlamaConfig(vocab=512, d_model=256, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=512, max_seq=256,
                            weight_kind="w4a8")
    params = llama.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    on_card = convert.to_device(params, cuda)
    shared = list(range(1, 33))
    prompts = [shared + [40 + i] * (3 + 9 * i) for i in range(4)]
    before = dict(_build.LAUNCHES)
    eng = serving.ServingEngine(cfg, on_card, batch_slots=2, device=cuda,
                                cache_kind="int8" if kv8 else "bf16",
                                paged=True, page=16, cache_pages=9,
                                prefix_cache=True, prefill_chunk=24)
    done = eng.run([serving.Request(uid=i, prompt=p, max_new=40)
                    for i, p in enumerate(prompts)])
    assert all(r.done and len(r.out) == 40 for r in done)
    assert eng.prefix_hit_tokens > 0
    attn = "paged_decode_attention_q8" if kv8 else "paged_decode_attention"
    for k in ("paged_kv_update", attn, "w4a8_gemv_fq"):
        assert _build.LAUNCHES[k] > before[k], k
    assert not any(eng.slot_pages)


# ------------------------------------------------------------ model path

def test_unported_routes_raise_on_the_card(cuda):
    """The int8 and int4 linears take their kernels on the card (int8 at
    m >= 256, int4 at every m: the GEMV at m <= 64), and causal
    self-attention of 512 tokens or more takes the flash kernel; the
    kernel routes cannot be turned off on the card."""
    from how_to_optimize_gemm_tpu_torch.models import linear, llama
    w = torch.ones((16, 8), device=cuda)
    lin4 = linear.make_linear(w, "int4")
    lin8 = linear.make_linear(w, "int8")
    for lin, m, name in ((lin4, 2, "w4a16_gemv"),
                         (lin4, 100, "w4a16_gemm_noc"),
                         (lin8, 256, "int8_gemm_noc")):
        before = dict(_build.LAUNCHES)
        y = linear.apply_linear(lin, torch.ones((m, 16), device=cuda))
        torch.cuda.synchronize()
        assert y.shape == (m, 8)
        assert _build.LAUNCHES[name] == before[name] + 1, name
    before = dict(_build.LAUNCHES)
    assert linear.apply_linear(lin8, torch.ones((3, 16),
                                                device=cuda)).shape == (3, 8)
    assert _build.LAUNCHES == before     # the library's int8 product
    on_card = llama.kernel_routes_for(torch.ones(1, device=cuda))
    assert llama._route_flash(on_card, 512, 128)      # the flash kernel
    assert not llama._route_flash(on_card, 511, 128)
    with pytest.raises(ValueError):
        llama.kernel_routes_for(torch.ones(1, device=cuda), False)
    with pytest.raises(ValueError):
        linear.apply_linear(lin4, torch.ones((2, 16), device=cuda), False)


def _teacher_forced(params, cfg, device, tokens, forced, quantized=False):
    """Logits of a masked prefill of ``tokens`` and of decode steps fed
    ``forced``, on the kernel routes (the CPU: their plain versions)."""
    from how_to_optimize_gemm_tpu_torch.models import llama
    cache = llama.init_kv_cache(cfg, tokens.shape[0], quantized=quantized,
                                device=device)
    s = tokens.shape[1]
    pos = torch.zeros(tokens.shape[0], dtype=torch.int32, device=device)
    rows = [llama.decode_step(params, cfg, cache,
                              torch.from_numpy(tokens).to(device), pos,
                              prefill_self=True, logit_idx=pos + s - 1,
                              kernel_routes=True)[0][:, 0]]
    pos = pos + s
    for j in range(forced.shape[1]):
        f = torch.from_numpy(forced[:, j:j + 1]).to(device)
        rows.append(llama.decode_step(params, cfg, cache, f, pos,
                                      kernel_routes=True)[0][:, 0])
        pos = pos + 1
    return torch.stack(rows).float().cpu()


# the kernels each (weight kind, KV8?) must launch, beside kv_update
TINY_KERNELS = {
    ("fp32", False): ["decode_attention"],
    ("w4a8", False): ["decode_attention", "w4a8_gemm_noc", "w4a8_gemv_fq"],
    ("int8", False): ["decode_attention", "int8_gemm_noc"],
    ("int4", False): ["decode_attention", "w4a16_gemm_noc", "w4a16_gemv"],
    ("w4a8", True): ["decode_attention_q8", "w4a8_gemm_noc", "w4a8_gemv_fq"],
}


@pytest.mark.parametrize("kind,kv8", list(TINY_KERNELS))
def test_tiny_model_on_the_card_matches_its_cpu_kernel_routes(cuda, kind,
                                                              kv8):
    """Teacher-forced logits of a masked 128-token prefill (m = 256: the
    prefill-width linears, the int8 kernel's threshold included) and 4
    decode steps, the card (kernels) against the CPU on the same routes
    (their plain versions). Float32 ops summed in another order differ by
    about 1e-6 relative, which the model amplifies (bf16 cache and p
    roundings, int8 KV and activation quantization), so the bound is 3x
    what a 1e-6 relative perturbation of the embeddings does on the CPU.
    Then the engine serves on the card."""
    from how_to_optimize_gemm_tpu_torch.models import llama
    from how_to_optimize_gemm_tpu_torch.parallel import serving
    cfg = llama.LlamaConfig(vocab=512, d_model=256, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=512, max_seq=256,
                            weight_kind=kind)
    params = llama.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    on_card = convert.to_device(params, cuda)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (2, 128)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab, (2, 4)).astype(np.int32)
    before = dict(_build.LAUNCHES)
    card = _teacher_forced(on_card, cfg, cuda, tokens, forced, kv8)
    for k in ["kv_update"] + TINY_KERNELS[kind, kv8]:
        assert _build.LAUNCHES[k] > before[k], k
    cpu = _teacher_forced(params, cfg, "cpu", tokens, forced, kv8)
    scale = float(cpu.abs().max())
    diff = float((card - cpu).abs().max())
    noise = torch.randn(params["embed"].shape,
                        generator=torch.Generator().manual_seed(1))
    moved = {**params, "embed": params["embed"] * (1 + 1e-6 * noise)}
    limit = 3 * float((_teacher_forced(moved, cfg, "cpu", tokens,
                                       forced, kv8) - cpu).abs().max())
    print(f"tiny model {kind} kv8={kv8}: max|card - cpu| = {diff} of "
          f"{scale} (limit {limit})")
    assert diff <= limit, diff
    eng = serving.ServingEngine(cfg, on_card, batch_slots=2, device=cuda,
                                cache_kind="int8" if kv8 else "bf16")
    done = eng.run([serving.Request(uid=i, prompt=[i + 1] * (5 + 7 * i),
                                    max_new=6) for i in range(3)])
    assert all(r.done and len(r.out) == 6 for r in done)


# ------------------------------------------------------------ flash prefill
# flash_attention sums in another order than its plain version (the
# tensor cores' fp32 sums, quad shuffles for the row sums), and an exp or
# a score one ulp apart can flip the bf16 rounding of p or of an output:
# in every row, max |kernel - plain| <= 2 bf16 ulps of that row's max
# |plain| (attention.bf16_row_ulps). The plain version walks the kernel's
# 64-key tiles.
FLASH_ULPS = 2.0

# (B, H, KVH, S, T, D, causal): GQA rep 4 (the serving CLI's 16 heads over
# 4), D 64, the last 700 of 1000 positions, not causal, T = 9000 past the
# reference's 8192-key strip, and tails of one row and one key
FLASH_CASES = [(2, 16, 4, 1024, 1024, 128, True),
               (1, 8, 8, 700, 1000, 64, True),
               (2, 4, 2, 700, 1000, 128, False),
               (1, 4, 4, 64, 9000, 128, False),
               (1, 4, 1, 129, 129, 64, True),
               (3, 2, 2, 1, 65, 128, True)]


def _flash_inputs(b, h, kvh, s, t, d, seed, device, model_layout=False):
    """bf16 q (B, H, S, D), k, v (B, KVH, T, D); with model_layout, views
    of (B, S, H, D) and (B, T, KVH, D) tensors, as mha_flash passes."""
    rng = np.random.default_rng(seed)

    def make(heads, n):
        x = torch.from_numpy(rng.standard_normal((b, n, heads, d)).astype(
            np.float32)).to(device=device, dtype=torch.bfloat16)
        x = x.transpose(1, 2)
        return x if model_layout else x.contiguous()
    return make(h, s), make(kvh, t), make(kvh, t)


@pytest.mark.parametrize("model_layout", [False, True])
@pytest.mark.parametrize("b,h,kvh,s,t,d,causal", FLASH_CASES)
def test_flash_attention_matches_plain_version(cuda, b, h, kvh, s, t, d,
                                               causal, model_layout):
    q, k, v = _flash_inputs(b, h, kvh, s, t, d, s + t + d, cuda,
                            model_layout)
    before = _build.LAUNCHES["flash_attention"]
    out = attention.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention"] == before + 1
    assert out.stride() == q.stride() and out.dtype == torch.bfloat16
    ref = attention.flash_attention_ref(q, k, v, causal=causal,
                                        bk=attention.KERNEL_BLOCK)
    assert torch.isfinite(out).all()
    err = float((out.float() - ref.float()).abs().max())
    ulps = float(attention.bf16_row_ulps(out, ref).max())
    print(f"flash_attention {(b, h, kvh, s, t, d, causal)}: max|kernel - "
          f"plain| = {err:.3e}, {ulps:.3f} bf16 ulps of its row's max")
    assert ulps <= FLASH_ULPS, ulps


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v = _flash_inputs(1, 2, 1, 64, 64, 64, 0, cuda)
    with pytest.raises(ValueError):                 # the kernel's tiles
        attention.flash_attention(q, k, v, bk=512)
    with pytest.raises(ValueError):                 # causal S > T
        attention.flash_attention(k.repeat(1, 2, 2, 1), q[:, :1], q[:, :1])
    with pytest.raises(TypeError):
        attention.flash_attention(q.float(), k, v)


def _prefill_cache(cfg, kind, b, device):
    """A cache of each kind for ``decode_step`` and its keyword arguments
    (a block table for the paged pools)."""
    from how_to_optimize_gemm_tpu_torch.models import llama
    quantized = kind.endswith("kv8")
    if not kind.startswith("paged"):
        return llama.init_kv_cache(cfg, b, quantized=quantized,
                                   device=device), {}
    page = 128
    np_max = cfg.max_seq // page
    cache = llama.init_paged_kv_cache(cfg, b * np_max + 1, page,
                                      quantized=quantized, device=device)
    table = torch.arange(1, b * np_max + 1, dtype=torch.int32,
                         device=device).reshape(b, np_max)
    return cache, {"table": table}


@pytest.mark.parametrize("kind", ["bf16", "kv8", "paged", "paged-kv8"])
def test_long_prefill_takes_flash_and_matches_cpu(cuda, kind):
    """An admission prefill of 512 tokens (2 slots, prefill_self) on each
    cache kind: the card launches flash_attention once per layer, and its
    last-position logits stay within 3x what a 1e-6 relative perturbation
    of the embeddings does to the CPU's kernel routes (their plain
    versions, flash included)."""
    from how_to_optimize_gemm_tpu_torch.models import llama
    cfg = llama.LlamaConfig(vocab=512, d_model=256, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=512, max_seq=1024,
                            weight_kind="fp32")
    params = llama.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 512))

    def prefill(p, device):
        cache, kw = _prefill_cache(cfg, kind, 2, device)
        pos = torch.zeros(2, dtype=torch.int32, device=device)
        logits, _ = llama.decode_step(
            p, cfg, cache, torch.from_numpy(tokens).to(device), pos,
            prefill_self=True, logit_idx=pos + 511, kernel_routes=True, **kw)
        return logits.float().cpu()
    before = _build.LAUNCHES["flash_attention"]
    card = prefill(convert.to_device(params, cuda), cuda)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention"] == before + cfg.n_layers
    cpu = prefill(params, "cpu")
    noise = torch.randn(params["embed"].shape,
                        generator=torch.Generator().manual_seed(1))
    moved = {**params, "embed": params["embed"] * (1 + 1e-6 * noise)}
    limit = 3 * float((prefill(moved, "cpu") - cpu).abs().max())
    diff = float((card - cpu).abs().max())
    print(f"prefill 512 {kind}: max|card - cpu| = {diff} (limit {limit})")
    assert diff <= limit, diff
