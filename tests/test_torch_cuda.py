"""The hand-written Hopper kernels against their plain versions, on the card.

Every test here needs a CUDA device and nvcc and skips without them (the
``cuda`` marker). This file imports no JAX, so it also runs on a machine
without it; from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: each GEMM kernel must EQUAL its plain version (exact int32
accumulation, the same epilogue order), and the ladder's kernels stay
under their rung's gate_rel (1e-4) against an fp64 oracle of the
effective operands. The serving kernels' tolerances are stated above
their tests.
"""
import numpy as np
import pytest
import torch

from how_to_optimize_gemm_tpu_torch import _build, convert
from how_to_optimize_gemm_tpu_torch.harness.driver import run_sweep
from how_to_optimize_gemm_tpu_torch.harness.parameters import SweepConfig
from how_to_optimize_gemm_tpu_torch.ops import (decode_attention, int4, int8,
                                               kv_update, registry)

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


CASES = {
    # kernel: (rung that prepares its operands, wrapper, plain version)
    "int8_gemm_nn": ("06_pallas_int8", int8.mmult_q, int8.mmult_q_ref),
    "int8_gemm_nt": ("14_packed_alias_int8", int8.mmult_q_bt,
                     int8.mmult_q_bt_ref),
    "w4a8_gemm": ("07b_pallas_w4a8", int4.mmult_q_w4a8,
                  int4.mmult_q_w4a8_ref),
}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kernel", sorted(CASES))
def test_kernel_equals_plain_version(cuda, kernel, shape):
    rung_name, wrapper, plain = CASES[kernel]
    rung = registry.get(rung_name)
    a, b, c = _abc(shape, SHAPES.index(shape), cuda)
    prepared = rung.prepare(a, b)
    ops = prepared[:4]   # 07b's prepare adds kdim, no kernel operand
    before = _build.LAUNCHES[kernel]
    out = wrapper(*ops, c.clone())
    torch.cuda.synchronize()
    assert _build.LAUNCHES[kernel] == before + 1
    ref = plain(*ops, c)
    assert out.shape == c.shape
    assert torch.equal(out, ref), float((out - ref).abs().max())
    ae, be = rung.effective(prepared)
    oracle = ae.double() @ be.double() + c.double()
    rel = float((out.double() - oracle).abs().max()
                / oracle.abs().max().clamp_min(1e-30))
    assert rel < 1e-4, rel


def test_in_place_kernels_write_c(cuda):
    a, b, c = _abc((300, 260, 520), 1, cuda)
    prepared = int8.prepare_packed(a, b)
    c2 = c.clone()
    out = int8.mmult_q_bt(*prepared, c2)
    assert out.data_ptr() == c2.data_ptr()
    assert torch.equal(c2, int8.mmult_q_bt_ref(*prepared, c))


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


# ------------------------------------------------------------ model path

def test_unported_routes_raise_on_the_card(cuda):
    """Where the reference runs a Pallas kernel this port has not written
    yet, the card raises instead of falling back."""
    from how_to_optimize_gemm_tpu_torch.models import linear, llama
    w = torch.ones((16, 8), device=cuda)
    with pytest.raises(NotImplementedError, match="B11"):
        linear.apply_linear(linear.make_linear(w, "int4"),
                            torch.ones((2, 16), device=cuda))
    lin8 = linear.make_linear(w, "int8")
    assert linear.apply_linear(lin8, torch.ones((3, 16),
                                                device=cuda)).shape == (3, 8)
    with pytest.raises(NotImplementedError, match="B10"):
        linear.apply_linear(lin8, torch.ones((256, 16), device=cuda))
    with pytest.raises(NotImplementedError, match="B18"):
        llama._route_flash(torch.ones(1, device=cuda), 512, 128)
    with pytest.raises(ValueError):
        llama.kernel_routes_for(torch.ones(1, device=cuda), False)


def _teacher_forced(params, cfg, device, tokens, forced):
    """Logits of a masked prefill of ``tokens`` and of decode steps fed
    ``forced``, on the kernel routes (the CPU: their plain versions)."""
    from how_to_optimize_gemm_tpu_torch.models import llama
    cache = llama.init_kv_cache(cfg, tokens.shape[0], device=device)
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


@pytest.mark.parametrize("kind", ["fp32", "w4a8"])
def test_tiny_model_on_the_card_matches_its_cpu_kernel_routes(cuda, kind):
    """Teacher-forced logits of a masked 48-token prefill (m = 96: the
    prefill-width linear) and 4 decode steps, the card (kernels) against
    the CPU on the same routes (their plain versions). Float32 ops summed
    in another order differ by about 1e-6 relative, which the model
    amplifies (bf16 cache and p roundings, w4a8 activation quantization),
    so the bound is 3x what a 1e-6 relative perturbation of the
    embeddings does on the CPU. Then the engine serves on the card."""
    from how_to_optimize_gemm_tpu_torch.models import llama
    from how_to_optimize_gemm_tpu_torch.parallel import serving
    cfg = llama.LlamaConfig(vocab=512, d_model=256, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=512, max_seq=256,
                            weight_kind=kind)
    params = llama.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    on_card = convert.to_device(params, cuda)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (2, 48)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab, (2, 4)).astype(np.int32)
    before = dict(_build.LAUNCHES)
    card = _teacher_forced(on_card, cfg, cuda, tokens, forced)
    kernels = ["kv_update", "decode_attention"]
    if kind == "w4a8":
        kernels += ["w4a8_gemm_noc", "w4a8_gemv_fq"]
    for k in kernels:
        assert _build.LAUNCHES[k] > before[k], k
    cpu = _teacher_forced(params, cfg, "cpu", tokens, forced)
    scale = float(cpu.abs().max())
    diff = float((card - cpu).abs().max())
    noise = torch.randn(params["embed"].shape,
                        generator=torch.Generator().manual_seed(1))
    moved = {**params, "embed": params["embed"] * (1 + 1e-6 * noise)}
    limit = 3 * float((_teacher_forced(moved, cfg, "cpu", tokens,
                                       forced) - cpu).abs().max())
    print(f"tiny model {kind}: max|card - cpu| = {diff} of {scale} "
          f"(limit {limit})")
    assert diff <= limit, diff
    eng = serving.ServingEngine(cfg, on_card, batch_slots=2, device=cuda)
    done = eng.run([serving.Request(uid=i, prompt=[i + 1] * (5 + 7 * i),
                                    max_new=6) for i in range(3)])
    assert all(r.done and len(r.out) == 6 for r in done)
