"""Paged KV-cache block pool for autoregressive transformer decode.

Counterpart of ``mxnet_tpu/serving/kv_cache.py``.  One device-resident
block pool replaces per-slot recurrent state, and each stream reaches its
K/V rows through a page table:

- :class:`KVBlockPool` owns two f32 tensors ``[layers, pages+1,
  page_size, heads, head_dim]`` on the pool's device (page 0 is the
  trash page inactive slots write to) plus host bookkeeping: a free
  list, per-page refcounts, the prefix cache (chain hash of full prompt
  pages -> page id) and an LRU of refcount-0 cached pages reclaimed on
  demand.  Exhaustion raises the typed
  :class:`~mxnet_tpu_torch.serving.errors.Overloaded`.
- **Prefix reuse and copy-on-write.**  A full prompt page is immutable
  once written, so identical prompt heads share pages (refcounted).
  Before a stream appends into a shared or registered page,
  :meth:`ensure_private` copies it into a fresh private page — one
  in-place page copy across every layer — and the stream's table entry
  moves to the copy.  The pools are written in place, never replaced, so
  a CUDA graph that reads them (``decode.py``) stays valid.

Config: ``MXNET_TPU_KV_POOL_PAGES`` (capacity in pages, default 64) and
``MXNET_TPU_KV_PAGE_TOKENS`` (tokens per page, default 16).  The pool
registers with the memory profiler (``memprof.register_pool``), so
``memprof.report()`` and ``traceview --memory`` carry one row for it:
pages used of its pages, at ``page_bytes`` each.
"""
from __future__ import annotations

import functools
import os
import weakref
from collections import OrderedDict

import torch

from .. import executor_cache
from .. import threads as _threads
from ..context import current_context
from ..observability import memprof as _memprof
from . import metrics
from .errors import Overloaded

ENV_POOL_PAGES = "MXNET_TPU_KV_POOL_PAGES"
DEFAULT_POOL_PAGES = 64
ENV_PAGE_TOKENS = "MXNET_TPU_KV_PAGE_TOKENS"
DEFAULT_PAGE_TOKENS = 16


def _env_int(env, default, lo=1):
    try:
        n = int(os.environ.get(env, str(default)))
    except ValueError:
        return default
    return max(lo, n)


def default_pool_pages():
    return _env_int(ENV_POOL_PAGES, DEFAULT_POOL_PAGES)


def default_page_tokens():
    return _env_int(ENV_PAGE_TOKENS, DEFAULT_PAGE_TOKENS)


def page_chain_hash(prev_hash, page_tokens):
    """Chain hash over full token pages: page p's identity commits to
    every token before it (the prev link) and its own tokens, so equal
    hashes mean equal full prefixes and equal cached K/V bits."""
    return hash((prev_hash, tuple(int(t) for t in page_tokens)))


@functools.lru_cache(maxsize=None)
def _clone_plan(shape, dtype, device):
    """The page copy of one pool geometry: page ``dst`` = page ``src``
    across every layer, in place.  Built (and counted as one plan build)
    once; the decoder's warmup builds it, so a copy-on-write in traffic
    builds nothing."""
    executor_cache.note_trace("fwd")

    def run(k_pool, v_pool, src, dst):
        if src != dst:
            k_pool[:, dst].copy_(k_pool[:, src])
            v_pool[:, dst].copy_(v_pool[:, src])

    return run


class KVBlockPool:
    """Device-resident paged KV store + host allocator and prefix cache."""

    def __init__(self, num_layers, num_heads, head_dim, num_pages=None,
                 page_size=None, name="kv", ctx=None):
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.num_pages = int(num_pages) if num_pages \
            else default_pool_pages()
        self.page_size = int(page_size) if page_size \
            else default_page_tokens()
        self.name = str(name)
        self.ctx = ctx or current_context()
        self.device = self.ctx.torch_device()
        shape = (self.num_layers, self.num_pages + 1, self.page_size,
                 self.num_heads, self.head_dim)
        self.k_pool = torch.zeros(shape, dtype=torch.float32,
                                  device=self.device)
        self.v_pool = torch.zeros(shape, dtype=torch.float32,
                                  device=self.device)
        self._lock = _threads.package_lock("KVBlockPool._lock")
        self._free = list(range(1, self.num_pages + 1))
        self._ref = {}               # page -> refcount (held pages only)
        self._prefix = {}            # chain hash -> page
        self._hash_of = {}           # page -> chain hash (registered)
        self._reclaim = OrderedDict()  # refcount-0 registered pages, LRU
        self._high_water = 0
        self.cow_clones = 0
        # k + v, all layers: the footprint of one logical page
        self.page_bytes = (2 * self.num_layers * self.page_size
                           * self.num_heads * self.head_dim * 4)
        ref = weakref.ref(self)
        _memprof.register_pool(
            self.name, self.page_bytes, self.num_pages,
            lambda: (lambda p: p.pages_used() if p is not None else 0)(
                ref()))
        metrics.record_kv_pool(0, self.num_pages, high_water=0)

    # -- accounting (host) -------------------------------------------------

    def pages_used(self):
        """Pages held: active (refcount > 0) + prefix-cached idle."""
        with self._lock:
            return self.num_pages - len(self._free)

    def stats(self):
        with self._lock:
            return {"pages_total": self.num_pages,
                    "pages_free": len(self._free),
                    "pages_active": len(self._ref),
                    "pages_cached_idle": len(self._reclaim),
                    "pages_high_water": self._high_water,
                    "prefix_entries": len(self._prefix),
                    "cow_clones": self.cow_clones,
                    "page_bytes": self.page_bytes}

    def _note_occupancy_locked(self):
        used = self.num_pages - len(self._free)
        if used > self._high_water:
            self._high_water = used
        metrics.record_kv_pool(used, self.num_pages,
                               high_water=self._high_water)

    # -- allocation --------------------------------------------------------

    def _alloc_locked(self):
        if self._free:
            page = self._free.pop()
        elif self._reclaim:
            page, _ = self._reclaim.popitem(last=False)
            h = self._hash_of.pop(page, None)
            if h is not None:
                self._prefix.pop(h, None)
            metrics.record_kv_eviction()
        else:
            raise Overloaded(
                "KV block pool exhausted: %d pages all actively held "
                "(raise %s or shed streams)"
                % (self.num_pages, ENV_POOL_PAGES))
        self._ref[page] = 1
        self._note_occupancy_locked()
        return page

    def alloc(self):
        """One free page (refcount 1).  Falls back to evicting the
        least-recently-idle prefix-cached page; raises ``Overloaded``
        when every page is actively held."""
        with self._lock:
            return self._alloc_locked()

    def release(self, page):
        """Drop one reference.  A refcount-0 page returns to the free
        list, unless it is prefix-registered: then it parks in the
        reclaimable LRU, where a later identical prompt can still hit
        it."""
        with self._lock:
            n = self._ref.get(page)
            if n is None:
                return
            if n > 1:
                self._ref[page] = n - 1
                return
            del self._ref[page]
            if page in self._hash_of:
                self._reclaim[page] = True
                self._reclaim.move_to_end(page)
            else:
                self._free.append(page)
            self._note_occupancy_locked()

    def refcount(self, page):
        with self._lock:
            return self._ref.get(page, 0)

    # -- copy-on-write -----------------------------------------------------

    def _clone(self):
        return _clone_plan(tuple(self.k_pool.shape), str(self.k_pool.dtype),
                           str(self.device))

    def ensure_private(self, page):
        """Copy-on-write guard before a stream appends into ``page``: a
        page that is shared (refcount > 1) or prefix-registered (its bits
        back cache hits) is copied into a freshly allocated private page,
        and the caller swaps its table entry to the returned id.  A page
        this stream owns alone comes back unchanged.

        Returns ``(page_id, cloned)``.  May raise ``Overloaded`` (no page
        for the copy); the caller sheds that stream, which still holds
        its reference to ``page``."""
        with self._lock:
            shared = self._ref.get(page, 0) > 1
            if not shared and page not in self._hash_of:
                return page, False
            fresh = self._alloc_locked()   # may raise Overloaded
        # the device copy runs outside the pool lock
        self._clone()(self.k_pool, self.v_pool, page, fresh)
        self.release(page)
        with self._lock:
            self.cow_clones += 1
        metrics.record_kv_cow()
        return fresh, True

    def warm_cow(self):
        """Build the page copy before traffic (the decoder's warmup calls
        this beside its step), so a copy-on-write in traffic builds
        nothing."""
        self._clone()(self.k_pool, self.v_pool, 0, 0)

    # -- prefix cache ------------------------------------------------------

    def lookup_retain(self, chain_hash):
        """Prefix probe: the page caching this chain hash, retained for
        the caller (refcount + 1), or None."""
        with self._lock:
            page = self._prefix.get(chain_hash)
            if page is None:
                return None
            if page in self._reclaim:
                del self._reclaim[page]
            self._ref[page] = self._ref.get(page, 0) + 1
            self._note_occupancy_locked()
            return page

    def register_prefix(self, chain_hash, page):
        """Offer a just-completed full page to the prefix cache.  The
        first writer wins: a hash already cached by another page keeps
        its entry (both pages hold the same bits; the duplicate frees
        normally at release)."""
        with self._lock:
            if chain_hash in self._prefix or page in self._hash_of:
                return
            if page not in self._ref:
                return  # released before registration: don't resurrect
            self._prefix[chain_hash] = page
            self._hash_of[page] = chain_hash

    def close(self):
        """Unregister the pool's memory-profiler row."""
        _memprof.unregister_pool(self.name)
