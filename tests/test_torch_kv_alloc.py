"""Port parity: the paged-KV allocator against the JAX package's.

The port's ``parallel/kv_alloc.py`` is a copy of the reference's (the port
imports nothing of the JAX package). The same random sequences of
attach, grow, register and release (an admission, decode growth, a
completion or a preemption, over a small pool and a 3-token alphabet so
that prefixes collide and reattach) drive the reference's
``PagedAllocatorPy``, the port's ``"py"`` backend and the port's
``"native"`` backend (``csrc/paged_alloc.cpp``, built by the port's own
loader with g++). Tolerance: none, every return value, table, slot page
list, free and cached count and hit count is IDENTICAL after every step.
"""
import numpy as np
import pytest
import torch

from how_to_optimize_gemm_tpu.parallel import kv_alloc as jka
from how_to_optimize_gemm_tpu_torch.parallel import kv_alloc as ka
from how_to_optimize_gemm_tpu_torch.utils import native

torch.set_num_threads(1)


def _observe(a):
    return {"table": np.array(a.table, copy=True).tolist(),
            "free": a.free_pages, "cached": a.cached_pages,
            "hits": a.hit_tokens,
            "npages": [a.slot_npages(s) for s in range(a.batch)],
            "slot_pages": a.slot_pages}


def _drive(allocs, seed, prefix_cache, steps=600):
    """Random admission / growth / release sequences on every allocator
    at once; returns after asserting they agree at each step."""
    rng = np.random.default_rng(seed)
    n_pages, page, batch, np_max = 9, 4, 3, 6
    made = [make(n_pages, page, batch, np_max, prefix_cache)
            for make in allocs]
    prompts = [None] * batch

    def each(op, *args):
        out = [getattr(a, op)(*args) for a in made]
        assert all(o == out[0] for o in out), (op, args, out)
        return out[0]

    for step in range(steps):
        s = int(rng.integers(batch))
        if prompts[s] is None:
            n = int(rng.integers(1, np_max * page))
            toks = rng.integers(1, 4, size=n).tolist()
            adapter = int(rng.integers(-1, 2))
            each("attach", s, toks, adapter)
            if each("grow", s, n):
                each("register", s, toks, adapter)
                prompts[s] = toks
            else:
                each("release", s)
        elif rng.random() < 0.5:
            n = made[0].slot_npages(s) * page + int(rng.integers(1, 9))
            if not each("grow", s, n):
                each("release", s)            # preempted
                prompts[s] = None
        else:
            each("release", s)
            prompts[s] = None
        seen = [_observe(a) for a in made]
        assert all(o == seen[0] for o in seen), (step, seen)
    return made


@pytest.mark.parametrize("prefix_cache", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_py_backend_equals_jax(prefix_cache, seed):
    made = _drive([jka.PagedAllocatorPy, ka.PagedAllocatorPy], seed,
                  prefix_cache)
    if prefix_cache:
        assert made[1].hit_tokens > 0


@pytest.mark.parametrize("prefix_cache", [False, True])
@pytest.mark.parametrize("seed", [2, 3])
def test_native_backend_equals_py(prefix_cache, seed):
    made = _drive([lambda *a: ka.make_allocator("py", *a),
                   lambda *a: ka.make_allocator("native", *a)], seed,
                  prefix_cache)
    assert isinstance(made[1], ka.PagedAllocatorNative)


def test_chain_keys_equal_jax():
    toks = list(range(100, 117))
    for adapter in (-1, 0, 3):
        assert list(ka._chain_keys(toks, 4, 4, adapter)) == list(
            jka._chain_keys(toks, 4, 4, adapter))


def test_grow_beyond_the_table_fails_closed():
    for backend in ("py", "native"):
        a = ka.make_allocator(backend, 64, 4, 2, 3)
        assert not a.grow(0, 3 * 4 + 1)
        assert a.grow(0, 3 * 4)
        assert a.table[0].tolist() == [63, 62, 61]
    with pytest.raises(ValueError):
        ka.make_allocator("py", 1, 4, 2, 3)
    with pytest.raises(ValueError):
        ka.make_allocator("rust", 8, 4, 2, 3)


def test_native_loader_builds_outside_csrc(monkeypatch):
    """The library lands under build/native; csrc/ gains nothing. A
    missing compiler raises instead of falling back to "py"."""
    lib = native.paged_alloc_lib()
    assert lib.pa_new.restype is not None
    built = sorted(native.BUILD_DIR.glob("libpaged_alloc-*.so"))
    assert built and all(p.parent == native.BUILD_DIR for p in built)
    assert not any(native.SOURCE.parent.glob("libpaged_alloc*"))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", native.ROOT / "build" / "none")
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.paged_alloc_lib()
