"""Host-side pieces of the wgmma kernels of rungs 15, 05 and 16
(``bf16_gemm_nt``, ``bf16_gemm_nn``, ``fp32_gemm_nt``: one body,
``csrc/gemm_wgmma.cuh``) and flash dK/dV (``flash_attention_bwd_dkv``), on
the CPU: the persistent tile walk as ``ops/tuned.nt_tile_walk`` describes
it on rung 15's and rung 16's tiles (every output tile computed exactly
once, in groups of row tiles, the constants the kernels' sources hold),
and the variant builds of ``harness/flash_variants.py`` (each
substitution fits the sources exactly once). The kernels themselves run
only on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import re

import pytest

from how_to_optimize_gemm_tpu_torch import _build
from how_to_optimize_gemm_tpu_torch.harness import flash_variants
from how_to_optimize_gemm_tpu_torch.ops import tuned

H100_SMS = 132


@pytest.mark.parametrize("m,n,blocks", [
    (4096, 4096, H100_SMS), (2001, 2102, H100_SMS), (33, 520, H100_SMS),
    (1, 1, H100_SMS), (4096, 4096, 1), (1000, 1032, 7), (300, 262, 5)])
def test_nt_tile_walk_covers_every_tile_once(m, n, blocks):
    tm, tn = tuned.NT_TILE
    walk = tuned.nt_tile_walk(m, n, blocks)
    tiles = [t for block in walk for t in block]
    expected = {(i * tm, j * tn) for i in range(-(-m // tm))
                for j in range(-(-n // tn))}
    assert len(tiles) == len(expected) and set(tiles) == expected
    assert len(walk) == min(blocks, len(expected))
    # blocks take turns: the walks' lengths differ by at most one
    assert max(map(len, walk)) - min(map(len, walk)) <= 1


def test_nt_tile_walk_runs_row_tiles_fastest_in_groups():
    """At 4,096 on an H100 the first wave (each block's first tile) lies in
    the first two groups of NT_GROUP_M row tiles, row tiles fastest, so the
    blocks running at once read at most 16 row tiles of A, and B."""
    tm, tn = tuned.NT_TILE
    g = tuned.NT_GROUP_M
    walk = tuned.nt_tile_walk(4096, 4096, H100_SMS)
    first = [block[0] for block in walk]
    assert first[:g + 1] == [(i * tm, 0) for i in range(g)] + [(0, tn)]
    rows = {r // tm for r, _ in first}
    assert set(range(g)) <= rows <= set(range(2 * g))
    # the last group may hold fewer row tiles: 10 row tiles, groups of 8
    last = tuned.nt_tile_walk(10 * tm, 2 * tn, 100)
    order = [block[0] for block in last]
    assert order[2 * g:] == [(8 * tm, 0), (9 * tm, 0), (8 * tm, tn),
                             (9 * tm, tn)]


def _const(source, name):
    src = (_build.CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])


def test_nt_tile_walk_matches_the_kernel_source():
    body = "gemm_wgmma.cuh"
    assert tuned.NT_TILE == (_const(body, "BM"),
                             _const("bf16_gemm_nt.cu", "BN"))
    assert tuned.NT_TILE == (_const(body, "BM"),
                             _const("bf16_gemm_nn.cu", "BN"))
    assert tuned.FP32_NT_TILE == (_const(body, "BM"),
                                  _const("fp32_gemm_nt.cu", "BN"))
    assert tuned.NT_GROUP_M == _const(body, "GROUP_M")


@pytest.mark.parametrize("m,n,blocks", [
    (4096, 4096, H100_SMS), (2001, 2102, H100_SMS), (1000, 1032, H100_SMS),
    (1, 1, H100_SMS), (300, 262, 5)])
def test_fp32_tile_walk_covers_every_tile_once(m, n, blocks):
    """Rung 16's 128 x 128 tiles: the same walk, every tile once, the
    blocks' walks one apart at most; at 4,096 its 1,024 tiles take each
    of the 132 blocks 7 or 8 times."""
    tm, tn = tuned.FP32_NT_TILE
    walk = tuned.nt_tile_walk(m, n, blocks, tuned.FP32_NT_TILE)
    tiles = [t for block in walk for t in block]
    expected = {(i * tm, j * tn) for i in range(-(-m // tm))
                for j in range(-(-n // tn))}
    assert len(tiles) == len(expected) and set(tiles) == expected
    assert max(map(len, walk)) - min(map(len, walk)) <= 1
    if m == n == 4096:
        assert {len(w) for w in walk} == {7, 8}
        g = tuned.NT_GROUP_M
        assert [b[0] for b in walk[:g + 1]] == \
            [(i * tm, 0) for i in range(g)] + [(0, tn)]


VARIANTS = [(group, name) for group, (_, variants)
            in flash_variants.GROUPS.items() for name in variants]


@pytest.mark.parametrize("group,name", VARIANTS)
def test_variant_builds_fit_the_sources(group, name, tmp_path, monkeypatch):
    monkeypatch.setattr(flash_variants, "OUT_DIR", tmp_path)
    sources, variants = flash_variants.GROUPS[group]
    csrc = flash_variants.prepare(group, name, variants[name])
    changed = {file for file, _, _ in variants[name]}
    assert changed <= set(sources) | set(flash_variants.HEADERS)
    for file in sources:
        same = (csrc / file).read_text() == (_build.CSRC / file).read_text()
        assert same == (file not in changed), file


def test_variant_refuses_a_substitution_that_does_not_fit(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(flash_variants, "OUT_DIR", tmp_path)
    with pytest.raises(ValueError):
        flash_variants.prepare("gemm", "bad", (("bf16_gemm_nt.cu",
                                                "no such text", ""),))
