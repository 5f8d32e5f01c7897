"""The fused W4A8 decode GEMV's walk (``csrc/w4a8_gemv_fq.cu``, kernel
``w4a8_gemv_fq``) modelled on the CPU, against the JAX package's
``pallas_int4.mmult_w4a8_fused_noc`` in interpret mode.

The model does what the kernel's blocks and threads do, in numpy, lanes
vectorised: a cluster of blocks shares a slab of 128 output columns and
splits its K in stages of 128 packed rows (``int4.gemv_plan`` picks the
cluster; a block takes 8 rows of x, more rows more row groups); each
block takes the absmax
of its slice of each row, the blocks' maxima give the row's scale
(IEEE division), each block quantizes its slice into its shared-memory
image in the products' permuted K order; each stage's box lands as the
tensor map lays it (128-byte swizzle, zeros past N); each lane loads its
words at the kernel's offsets (the model asserts 32 distinct banks a
load), turns each 4 x 4 byte group around as ``__byte_perm`` does, makes
16 times the signed nibbles, and ldmatrix's lanes address the quantized
rows; the mma.sync m16n8k32 products (the weights as A, x as B) are
taken from the fragments as PTX lays them out, summed in int32, added
over the block's two halves and the cluster's blocks (exact in any
order), shifted back by 4 and scaled as ``(float(acc) * sa) * sw``.

Tolerance: none. The model must EQUAL the JAX package's eager form
(``quantize_symmetric`` + ``mmult_q_w4a8_noc``, interpret mode) and the
port's plain version on every row, and the JAX fused kernel on every row
where its scale is IEEE division: under ``jit`` XLA on the CPU rewrites
``amax / 127.0`` into ``amax * (1 / 127)``, one ulp off on some rows
(``tests/test_torch_w4a8_noc.py`` states the same). m in {1, 4, 5, 64},
K 700 (a pack block's high half past K) and 1,024, N 100 (below a slab)
and 300 (past two), each padded to a 16-byte pitch (ldp > N). Beside it,
the plan, the kernel's constants read from its source, and the wrapper's
one launch on meta tensors.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from how_to_optimize_gemm_tpu.ops import pallas_int4 as jint4
from how_to_optimize_gemm_tpu.ops import quant as jquant
from how_to_optimize_gemm_tpu_torch import _build
from how_to_optimize_gemm_tpu_torch.ops import bounds, int4

torch.set_num_threads(1)

SOURCE = "w4a8_gemv_fq.cu"
H100_SMS = 132
SLAB = int4.GEMV_SLAB
ROWS = int4.GEMV_STAGE_ROWS
LANE = np.arange(32)
G, T = LANE >> 2, LANE & 3


def _const(name):
    src = (_build.CSRC / SOURCE).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])


def k_base(s, part):
    return 512 * (s // 2) + 128 * (s % 2) + 256 * part


def k_slot(rho):
    """The mma k index carrying row rho of a 32-row group."""
    r = rho & 15
    return (rho & 16) + 4 * ((r & 7) >> 1) + 2 * (r >> 3) + (r & 1)


def swz(r, c):
    return r * SLAB + ((((c >> 4) ^ r) & 7) << 4) + (c & 15)


def lo16(b):
    """16 x the signed low nibble of each byte (offset binary)."""
    return (((b.astype(np.int32) << 4) & 0xF0) ^ 0x80).astype(np.uint8) \
        .view(np.int8)


def hi16(b):
    return (b & 0xF0).astype(np.uint8).view(np.int8)


def _stage_image(pk, prow0, n0, n):
    """A stage's shared memory as the tensor map writes it: packed rows
    prow0 .. + 127, columns n0 .. + 127, zeros past N, 128-byte swizzle."""
    img = np.zeros(ROWS * SLAB, np.uint8)
    r, c = np.meshgrid(np.arange(ROWS), np.arange(SLAB), indexing="ij")
    rows = prow0 + r
    ok = (rows < pk.shape[0]) & (n0 + c < n)
    vals = np.where(ok, pk[np.minimum(rows, pk.shape[0] - 1),
                           np.minimum(n0 + c, pk.shape[1] - 1)], 0)
    img[swz(r, c)] = vals
    return img


def _block(x, k, pk, n, n0, row0, rows, s0, nst, spc, scale):
    """One block's int32 partials (8, SLAB), both halves summed:
    its slice quantized into the shared-memory image, then every stage's
    products."""
    rowb = spc * 2 * ROWS + 16
    qa = np.zeros((rows, rowb), np.int8)
    for u in range(2 * nst):
        for j in range(4):              # lane l takes K row 32 j + l
            ks = k_base(s0 + u // 2, u % 2) + 32 * j + LANE
            v = np.where(ks < k, x[row0:row0 + rows, np.minimum(ks, k - 1)],
                         np.float32(0))
            q = np.clip(np.rint(v / scale[:, None]), -127, 127)
            step = (4 * (u // 2) + j) * 2 + u % 2
            qa[:, step * 32 + k_slot(LANE)] = q.astype(np.int8)
    zeros = np.zeros(64, np.int8)
    red = np.zeros((2, 8, SLAB), np.int64)
    for q in range(nst):
        img = _stage_image(pk, (s0 + q) * ROWS, n0, n)
        for grp in range(4):
            half = grp // 2             # warps 4 half .. 4 half + 3
            for wc in range(4):
                col = wc * 32 + 4 * G
                # raw bytes [h][j][c] of each lane's words
                raw = np.zeros((2, 4, 4, 32), np.uint8)
                for h in range(2):
                    for j in range(4):
                        r = 32 * grp + 16 * h + 2 * T + (j & 1) + 8 * (j >> 1)
                        off = swz(r, col)
                        assert len(set((off // 4) % 32)) == 32
                        for c in range(4):
                            raw[h, j, c] = img[off + c]
                # the transpose: word c of register h holds column c's
                # bytes j = 0..3
                bw = raw.transpose(0, 2, 1, 3)          # [h][c][j][lane]
                step = (4 * q + grp) * 2
                regs = _ldmatrix(qa, zeros, rows, step)
                for part, dec in ((0, lo16), (1, hi16)):
                    bmat = np.zeros((32, 8), np.int64)
                    for h in range(2):
                        for byte in range(4):
                            bmat[16 * h + 4 * T + byte, G] = \
                                regs[2 * part + h, :, byte]
                    for pc in range(2):
                        amat = np.zeros((16, 32), np.int64)
                        for dr, c in ((0, 2 * pc), (8, 2 * pc + 1)):
                            for h in range(2):
                                for j in range(4):
                                    amat[G + dr, 16 * h + 4 * T + j] = \
                                        dec(bw[h, c, j])
                        d = amat @ bmat             # (16, 8)
                        # D's row g (+ 8): column 4g + 2pc (+ 1); its
                        # column 2t (+ 1): x row 2t (+ 1)
                        for dr in (0, 8):
                            for dn in (0, 1):
                                red[half, 2 * T + dn,
                                    wc * 32 + 4 * G + 2 * pc + dr // 8] \
                                    += d[G + dr, 2 * T + dn]
    return red.sum(axis=0)


def _ldmatrix(qa, zeros, rows, step):
    """The four 8 x 8 (b16) matrices ldmatrix.x4 gathers for x's rows:
    lane l addresses x row l % 8 (the zero row past ``rows``) at
    bytes 16 (l / 8) of the low step and the high one after it; matrix
    jm's row i comes from lane 8 jm + i and lane L receives its row L / 4,
    word L % 4. Returns regs [jm][lane][byte]: b0, b1 of the low step,
    then of the high."""
    rowb = qa.shape[1]
    flat = np.concatenate([qa.reshape(-1), zeros])

    def addr(lane):
        r = lane & 7
        live = r < rows
        base = np.where(live, r * rowb + step * 32, qa.size)
        return base + 16 * (lane >> 3)
    regs = np.zeros((4, 32, 4), np.int8)
    for jm in range(4):
        src = addr(8 * jm + LANE // 4)
        for byte in range(4):
            regs[jm, :, byte] = flat[src + 4 * (LANE % 4) + byte]
    return regs


def gemv_model(x, packed, sw, k, cluster):
    """The kernel's output for x (m, k) float32, packed (Kp/2, ldp) int8
    and sw (1, n) float32 (numpy), on ``cluster`` blocks a slab and 8 rows
    of x a block."""
    m = x.shape[0]
    n = sw.shape[1]
    pk = packed.view(np.uint8)
    s_total = int4.gemv_stages(k)
    spc = -(-s_total // cluster)
    out = np.zeros((m, n), np.float32)
    for row0 in range(0, m, 8):
        rows = min(8, m - row0)
        ranges = [(r * s_total // cluster, (r + 1) * s_total // cluster)
                  for r in range(cluster)]
        # (1) the blocks' slice maxima, combined: the row's scale
        amax = np.zeros(rows, np.float32)
        for s0, s1 in ranges:
            ks = np.concatenate([k_base(s0 + u // 2, u % 2) + np.arange(ROWS)
                                 for u in range(2 * (s1 - s0))] or [[]])
            ks = ks[ks < k].astype(np.int64)
            if ks.size:
                amax = np.maximum(amax, np.abs(x[row0:row0 + rows, ks])
                                  .max(axis=1))
        scale = np.maximum(amax, np.float32(1e-8)) / np.float32(127)
        for n0 in range(0, n, SLAB):
            total = sum(_block(x, k, pk, n, n0, row0, rows, s0, s1 - s0,
                               spc, scale) for s0, s1 in ranges)
            total = total.astype(np.int32)
            assert not (total % 16).any()
            cols = min(SLAB, n - n0)
            acc = (total[:rows, :cols] >> 4).astype(np.float32)
            out[row0:row0 + rows, n0:n0 + cols] = (
                (acc * scale[:, None]) * sw[:, n0:n0 + cols])
    return out


def _x(m, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    if m > 1:
        x[1] = 0.0                      # the 1e-8 scale floor
    if m > 2:
        x[2] = np.round(rng.uniform(-120, 120, k)) + 0.5   # .5 ties
        x[2, 0] = 127.0
    return x


_WEIGHTS = {}


def _weights(k, n):
    """(JAX packed, JAX sw, port packed padded to a 16-byte pitch, port
    sw) of one random (k, n) W."""
    if (k, n) not in _WEIGHTS:
        w = np.random.default_rng(k + n).standard_normal(
            (k, n)).astype(np.float32)
        _, _, jpacked, jsw, _ = jint4.prepare_w4a8(jnp.zeros((1, k)),
                                                   jnp.asarray(w))
        _, _, packed, sw, _ = int4.prepare_w4a8(torch.zeros((1, k)),
                                                torch.from_numpy(w))
        np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
        _WEIGHTS[k, n] = (jpacked, jsw, packed, sw)
    return _WEIGHTS[k, n]


@pytest.mark.parametrize("n", [100, 300])
@pytest.mark.parametrize("k", [700, 1024])
@pytest.mark.parametrize("m", [1, 4, 5, 64])
def test_gemv_walk_equals_jax(m, k, n):
    jpacked, jsw, packed, sw = _weights(k, n)
    x = _x(m, k, 100 * m + k + n)
    cluster = int4.gemv_plan(m, k, n, H100_SMS)
    ldp = bounds.pad_dim(packed, 1, 16)
    assert ldp.shape[1] > n
    got = gemv_model(x, ldp.numpy(), sw.numpy(), k, cluster)
    jqa, jsa = jquant.quantize_symmetric(jnp.asarray(x), axis=1)
    eager = np.asarray(jint4.mmult_q_w4a8_noc(jqa, jsa, jpacked, jsw,
                                              interpret=True))
    np.testing.assert_array_equal(got, eager)
    plain = int4.mmult_w4a8_fused_noc(torch.from_numpy(x), packed, sw)
    np.testing.assert_array_equal(got, plain.numpy())
    fused = np.asarray(jint4.mmult_w4a8_fused_noc(
        jnp.asarray(x), jpacked, jsw, interpret=True))
    amax = np.maximum(np.abs(x).max(axis=1), np.float32(1e-8))
    ieee = amax * (np.float32(1) / np.float32(127)) == amax / np.float32(127)
    np.testing.assert_array_equal(got[ieee], fused[ieee])


@pytest.mark.parametrize("cluster,m", [(1, 5), (2, 20), (8, 5)])
def test_gemv_walk_at_other_plans(cluster, m):
    """Any cluster (8 blocks over 4 stages leaves half of them none) and
    rows past 8 in more row groups give the same bits."""
    k, n = 700, 300
    _, _, packed, sw = _weights(k, n)
    x = _x(m, k, 7)
    got = gemv_model(x, bounds.pad_dim(packed, 1, 16).numpy(), sw.numpy(),
                     k, cluster)
    plain = int4.mmult_w4a8_fused_noc(torch.from_numpy(x), packed, sw)
    np.testing.assert_array_equal(got, plain.numpy())


def test_stages_cover_every_k_row_once():
    """Stage s holds packed rows 128 s .. + 127: K rows k_base(s, 0) ..
    (low nibbles) and k_base(s, 1) .. (high), so the stages below
    gemv_stages(K) cover each K row below K once."""
    for k in (1, 128, 129, 512, 700, 1024, 4096, 11008):
        seen = []
        for s in range(int4.gemv_stages(k)):
            for part in (0, 1):
                base = k_base(s, part)
                prow = 256 * (base // 512) + base % 256
                assert prow == 128 * s
                seen += [r for r in range(base, base + 128) if r < k]
        assert sorted(seen) == list(range(k)), k
    assert int4.gemv_stages(4096) == 16 and int4.gemv_stages(11008) == 44


def test_k_slots_pair_both_sides():
    """Each 32-row group's rows map to the 32 mma k indices one to one,
    and lane t's B bytes (rows 2t, 2t + 1, 2t + 8, 2t + 9, and + 16) are
    k = 4t .. 4t + 3 (+ 16), which ldmatrix hands the same lane of A."""
    assert sorted(k_slot(r) for r in range(32)) == list(range(32))
    for t in range(4):
        for h in range(2):
            for j in range(4):
                r = 16 * h + 2 * t + (j & 1) + 8 * (j >> 1)
                assert k_slot(r) == 16 * h + 4 * t + j


def test_ldmatrix_rows_hit_distinct_banks():
    """A row of quantized x is 16 bytes past whole 256-byte stages, so the
    8 rows of each ldmatrix matrix fall on 8 distinct 16-byte bank
    groups."""
    for spc in (1, 2, 6, 44):
        rowb = spc * 2 * ROWS + 16
        for step in range(0, 8, 2):
            for off in (0, 16, 32, 48):
                groups = {((r * rowb + step * 32 + off) // 16) % 8
                          for r in range(8)}
                assert len(groups) == 8


@pytest.mark.parametrize("m,k,n,cluster", [
    (4, 4096, 11008, 4), (4, 4096, 4096, 8), (4, 11008, 4096, 8),
    (1, 4096, 11008, 4), (16, 4096, 11008, 2), (64, 4096, 4096, 2),
    (64, 11008, 4096, 2), (5, 700, 300, 4)])
def test_gemv_plan(m, k, n, cluster):
    """The 7B decode shapes at m = 4: 86 slabs x 4 = 344 blocks, 32 x 8 =
    256, one wave of three blocks an SM; at 8 rows a block two blocks an
    SM, so 86 slabs take clusters of 2, and more than one row group at
    most 2. Every block has a stage and fits its shared memory."""
    assert int4.gemv_plan(m, k, n, H100_SMS) == cluster
    stages = int4.gemv_stages(k)
    rows = min(m, int4.GEMV_ROWS)
    smem = int4.gemv_smem(rows, -(-stages // cluster), cluster)
    assert stages >= cluster and cluster & (cluster - 1) == 0
    assert smem <= int4.GEMV_SMEM
    per_sm = min(int4.GEMV_BLOCKS_PER_SM, int4.GEMV_SM_SMEM // (smem + 1024))
    assert -(-n // int4.GEMV_SLAB) * cluster <= per_sm * H100_SMS


def test_gemv_plan_grows_to_fit():
    """Every m <= 64 fits a block's shared memory up to Kp = GEMV_MAX_KP
    (8 rows of 64 stages at clusters of 8)."""
    for m in (1, 4, 9, 33, 64):
        for k in (32768, int4.GEMV_MAX_KP):
            cluster = int4.gemv_plan(m, k, 4096, H100_SMS)
            spc = -(-int4.gemv_stages(k) // cluster)
            assert int4.gemv_smem(min(m, 8), spc, cluster) <= int4.GEMV_SMEM
    assert int4.gemv_plan(8, int4.GEMV_MAX_KP, 4096, H100_SMS) == 8


def test_kernel_constants_match_the_host():
    src = (_build.CSRC / SOURCE).read_text()
    assert _const("SLAB") == int4.GEMV_SLAB
    assert _const("ROWS") == int4.GEMV_ROWS
    assert _const("PACK_ROWS") == int4.GEMV_STAGE_ROWS
    assert _const("ST") == int4.GEMV_RING
    assert _const("MAX_CLUSTER") == int4.GEMV_MAX_CLUSTER
    assert _const("SMEM_LIMIT") == int4.GEMV_SMEM
    assert _const("ROW_PAD") == int4._GEMV_ROW_PAD
    assert (f"__launch_bounds__(THREADS, {int4.GEMV_BLOCKS_PER_SM})"
            in src)
    assert f"Kp > {int4.GEMV_MAX_KP}" in src
    # 16 x (127 x 8) x Kp stays below 2^31
    assert 16 * 127 * 8 * int4.GEMV_MAX_KP < 2 ** 31


def test_wrapper_launches_once_on_x_as_it_is(monkeypatch):
    """On the card the wrapper allocates out alone and launches the kernel
    once with the plan; x keeps its K (no pad to Kp) and its row pitch
    (meta tensors, the launch recorded)."""
    calls = []
    monkeypatch.setattr(int4, "require_cuda", lambda name, x: None)
    monkeypatch.setattr(int4, "_sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(_build, "launch", lambda name, dev, *args:
                        calls.append((name, *args)))
    meta = dict(device="meta")
    k, n = 11008, 4096
    packed = torch.zeros((11264 // 2, n), dtype=torch.int8, **meta)
    sw = torch.zeros((1, n), **meta)
    wide = torch.zeros((4, k + 64), **meta)
    x = wide[:, :k]
    out = int4.mmult_w4a8_fused_noc(x, packed, sw)
    assert out.shape == (4, n) and out.dtype == torch.float32
    (name, xa, pa, swa, outa, *ints), = calls
    assert name == "w4a8_gemv_fq" and outa is out
    assert xa.shape == (4, k) and pa is packed and swa is sw
    assert ints == [4, n, k, k + 64, 11264, n, 8]
