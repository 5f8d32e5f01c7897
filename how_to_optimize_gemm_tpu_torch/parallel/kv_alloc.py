"""Paged-KV page allocator and prefix-cache index (host state).

Counterpart: ``how_to_optimize_gemm_tpu/parallel/kv_alloc.py``, kept as a
copy (the port imports nothing of the JAX package). Two interchangeable
backends of one state machine:

- ``PagedAllocatorPy``, plain Python and numpy, the engine's default;
- ``PagedAllocatorNative``, the repository's C++ tier
  (``csrc/paged_alloc.cpp``, built and loaded by ``utils/native.py``).
  The tests drive both through the same random operations and require
  the same tables and counts after each.

The state machine:

- pages ``1 .. n_pages - 1`` are handed out LIFO; page 0 is the trash
  page, never handed out (masked and padded writes land there);
- ``grow(s, n)`` appends pages to slot ``s``'s block table until it
  covers ``n`` tokens; it returns False when the pool is dry or ``n``
  passes the table, keeping any partial growth (the caller releases or
  preempts and retries);
- with ``prefix_cache``, pages carry refcounts, and a prompt's full pages
  are addressed by a rolling chain hash (sha1 of the previous page's key
  and this page's tokens, seeded with the LoRA adapter id), so a page is
  reused only when everything before it matches too. ``release`` retires
  registered pages whose refcount reaches 0 to an LRU pool that
  ``_alloc_page`` evicts only when the free list is empty.
"""
from __future__ import annotations

import ctypes
import hashlib
from collections import OrderedDict
from typing import Iterator

import numpy as np


def _chain_keys(tokens, page: int, n_pages: int,
                adapter: int) -> Iterator[bytes]:
    """Rolling chain keys of pages 0 .. n_pages - 1 of a token sequence:
    key_c = sha1(key_{c-1} || tokens[c*page:(c+1)*page] as int32), seeded
    with sha1(adapter as 8 little-endian bytes). Equal key_c means the
    adapter and every token through page c match."""
    prev = hashlib.sha1(
        int(adapter).to_bytes(8, "little", signed=True)).digest()
    arr = np.asarray(tokens, np.int32)
    for c in range(n_pages):
        prev = hashlib.sha1(
            prev + arr[c * page:(c + 1) * page].tobytes()).digest()
        yield prev


def _check_sizes(n_pages: int) -> None:
    if n_pages < 2:
        raise ValueError(f"n_pages {n_pages}: the pool needs at least one "
                         "page besides the trash page")


class PagedAllocatorPy:
    """Python backend. The surface both backends share: ``grow``,
    ``release``, ``attach``, ``register``, ``table`` (the live (batch,
    np_max) int32 block table), ``slot_pages``, ``slot_npages``,
    ``free_pages``, ``cached_pages`` and ``hit_tokens``."""

    def __init__(self, n_pages: int, page: int, batch: int, np_max: int,
                 prefix_cache: bool = False):
        _check_sizes(n_pages)
        self.n_pages = n_pages
        self.page = page
        self.batch = batch
        self.np_max = np_max
        self.prefix_cache = prefix_cache
        self._free = list(range(1, n_pages))     # LIFO, pops n-1 first
        self.slot_pages: list[list[int]] = [[] for _ in range(batch)]
        self.table = np.zeros((batch, np_max), np.int32)
        self.hit_tokens = 0
        self._refcount = np.zeros(n_pages, np.int64)
        self._prefix_index: dict[bytes, int] = {}   # chain key -> page
        self._page_key: dict[int, bytes] = {}
        self._cached: OrderedDict[int, None] = OrderedDict()  # LRU

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def cached_pages(self) -> int:
        return len(self._cached)

    def slot_npages(self, s: int) -> int:
        return len(self.slot_pages[s])

    def _alloc_page(self) -> int | None:
        """A free page, else (prefix cache) the least recently retired
        cached page, evicted from the index; None when neither exists."""
        if self._free:
            return self._free.pop()
        if self.prefix_cache and self._cached:
            p, _ = self._cached.popitem(last=False)
            key = self._page_key.pop(p)
            if self._prefix_index.get(key) == p:
                del self._prefix_index[key]
            return p
        return None

    def grow(self, s: int, n_tokens: int) -> bool:
        """Make slot s's table cover n_tokens; False when the pool is dry
        or n_tokens passes the table. Partial growth is kept."""
        need = -(-n_tokens // self.page)
        if need > self.np_max:
            return False
        while len(self.slot_pages[s]) < need:
            p = self._alloc_page()
            if p is None:
                return False
            if self.prefix_cache:
                self._refcount[p] = 1
            self.table[s, len(self.slot_pages[s])] = p
            self.slot_pages[s].append(p)
        return True

    def release(self, s: int) -> None:
        """Return slot s's pages: registered prefix pages whose refcount
        reaches 0 retire to the LRU cache, every other page to the free
        list."""
        if self.prefix_cache:
            for p in self.slot_pages[s]:
                self._refcount[p] -= 1
                if self._refcount[p] == 0:
                    key = self._page_key.get(p)
                    if (key is not None
                            and self._prefix_index.get(key) == p):
                        self._cached[p] = None
                    else:
                        self._page_key.pop(p, None)
                        self._free.append(p)
        else:
            self._free.extend(self.slot_pages[s])
        self.slot_pages[s] = []
        self.table[s, :] = 0

    def attach(self, s: int, tokens, adapter: int = -1) -> int:
        """At admission, bind every cached full page of the prompt to the
        EMPTY slot s, so that at least one token is left to prefill (the
        model must give logits to sample from). Returns the attached
        (hit) tokens; 0 without a prefix cache or on a slot that holds
        pages."""
        if not self.prefix_cache or self.slot_pages[s]:
            return 0
        cap = min((len(tokens) - 1) // self.page, self.np_max)
        got = 0
        for c, key in enumerate(_chain_keys(tokens, self.page, cap,
                                            adapter)):
            p = self._prefix_index.get(key)
            if p is None:
                break
            self.table[s, c] = p
            self.slot_pages[s].append(p)
            self._refcount[p] += 1
            self._cached.pop(p, None)
            got += self.page
        self.hit_tokens += got
        return got

    def register(self, s: int, tokens, adapter: int = -1) -> None:
        """After prefill, index slot s's pages that the prompt fills
        (decode starts past the last full page and never writes them)."""
        if not self.prefix_cache:
            return
        cap = min(len(tokens) // self.page, self.np_max)
        for c, key in enumerate(_chain_keys(tokens, self.page, cap,
                                            adapter)):
            p = int(self.table[s, c])
            if p == 0:
                break
            if key not in self._prefix_index:
                self._prefix_index[key] = p
                self._page_key[p] = key


class PagedAllocatorNative:
    """C++ backend (``csrc/paged_alloc.cpp``): ``PagedAllocatorPy``'s
    surface and behaviour. ``table`` is a view of the C++ table, valid
    while this object lives."""

    def __init__(self, n_pages: int, page: int, batch: int, np_max: int,
                 prefix_cache: bool = False):
        _check_sizes(n_pages)
        from how_to_optimize_gemm_tpu_torch.utils import native
        self._lib = native.paged_alloc_lib()
        self.n_pages = n_pages
        self.page = page
        self.batch = batch
        self.np_max = np_max
        self.prefix_cache = prefix_cache
        self._h = self._lib.pa_new(n_pages, page, batch, np_max,
                                   1 if prefix_cache else 0)

    def close(self) -> None:
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.pa_delete(h)

    def __del__(self):
        self.close()

    @property
    def table(self) -> np.ndarray:
        ptr = self._lib.pa_table_ptr(self._h)
        return np.ctypeslib.as_array(
            ctypes.cast(ptr, ctypes.POINTER(ctypes.c_int32)),
            shape=(self.batch, self.np_max))

    @property
    def slot_pages(self) -> list[list[int]]:
        # grow and attach fill a table row left to right in page order,
        # so its first slot_npages entries are the slot's pages
        t = self.table
        return [list(map(int, t[s, :self.slot_npages(s)]))
                for s in range(self.batch)]

    @property
    def free_pages(self) -> int:
        return int(self._lib.pa_free_pages(self._h))

    @property
    def cached_pages(self) -> int:
        return int(self._lib.pa_cached_pages(self._h))

    @property
    def hit_tokens(self) -> int:
        return int(self._lib.pa_hit_tokens(self._h))

    def slot_npages(self, s: int) -> int:
        return int(self._lib.pa_slot_npages(self._h, s))

    def grow(self, s: int, n_tokens: int) -> bool:
        return bool(self._lib.pa_grow_slot(self._h, s, n_tokens))

    def release(self, s: int) -> None:
        self._lib.pa_release_slot(self._h, s)

    def _tokens(self, tokens):
        arr = np.ascontiguousarray(tokens, np.int32)
        return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    def attach(self, s: int, tokens, adapter: int = -1) -> int:
        arr, ptr = self._tokens(tokens)
        return int(self._lib.pa_attach_prefix(self._h, s, ptr, len(arr),
                                              adapter))

    def register(self, s: int, tokens, adapter: int = -1) -> None:
        arr, ptr = self._tokens(tokens)
        self._lib.pa_register_prefix(self._h, s, ptr, len(arr), adapter)


BACKENDS = {"py": PagedAllocatorPy, "native": PagedAllocatorNative}


def make_allocator(backend: str, n_pages: int, page: int, batch: int,
                   np_max: int, prefix_cache: bool = False):
    """backend: "py" (the default) or "native" (the C++ tier)."""
    if backend not in BACKENDS:
        raise ValueError(f"alloc backend {backend!r} not in {list(BACKENDS)}")
    return BACKENDS[backend](n_pages, page, batch, np_max, prefix_cache)
