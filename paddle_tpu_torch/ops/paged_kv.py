"""Paged KV-cache: block-table paging over one preallocated device pool.

Counterpart of ``paddle_tpu/ops/paged_kv.py``.  The cache is the vLLM
PagedAttention shape:

  * ONE preallocated page pool per replica, ``[num_pages + 1, H,
    page_size, d]`` for K and V (the last page is the SINK, below).  The
    page is the allocation unit; the head axis rides ahead of the token
    axis, the JAX package's layout, so the tests compare like with like
    and ``flash_decode`` reads a (page, head) slab as one contiguous
    ``[page_size, d]`` block.
  * per-sequence BLOCK TABLES (host int32 ``[max_seqs,
    max_pages_per_seq]``) mapping logical page i of a sequence to its
    physical pool page.

The allocator is host-side (free list, refcounts, tables, lengths).
The pools are torch tensors updated IN PLACE: one token per sequence
lands by ``pool[page_ids, :, offsets, :] = vals`` (two advanced indices
split by a slice put the batch axis first, ``[N, H, d]``, as JAX's
``.at[].set`` does), a page run by ``pool[pid, :, a:b, :] = ...``, and
a copy-on-write by ``pool[new] = pool[old]``.  That takes the place of
JAX's functional updates, which return a new pool each time.
``flash_decode`` consumes (pools, tables, lens) directly.

Batch rows padded to a fixed batch shape scatter into the sink page,
which is never allocated and never read.  Duplicate indices of an
in-place scatter land in no defined order on a GPU; that is harmless
only because the sink page's contents are never read.

int8 KV storage (``kv_int8``): pages hold ``q = clip(round(x / s *
127), -127, 127)`` with per-(head, dim) abs-max scales calibrated on
the first write (or given), and ``flash_decode`` dequantizes.

Copy-on-write prefix sharing (``kv_share``): every page carries a
refcount and the cache keeps a radix tree over the FULL pages it has
written, so requests with a common token prefix share its pages,
``fork`` shares everything, and a write into a page with refcount > 1
copies it first.  The zero-leak invariant is ``free + unique(in_use) ==
num_pages`` with each refcount equal to its holders; ``check_accounting``
verifies both.

``PagedKVCache(device=...)`` defaults to ``"cuda"`` and raises
``NoCUDADeviceError`` without a card unless given ``"cpu"``.
"""

from __future__ import annotations

import itertools
import math
import threading
from collections import Counter

import numpy as np
import torch

from paddle_tpu_torch.core.types import NoCUDADeviceError, to_torch_dtype
from paddle_tpu_torch.observability import flight_recorder as _flight
from paddle_tpu_torch.observability import metrics as _obs_metrics

__all__ = ["OutOfPagesError", "PagedKVCache", "quantize_kv",
           "dequantize_kv", "kv_scales_of", "resolve_device"]

_M_PAGES = _obs_metrics.counter(
    "paddle_tpu_paged_kv_pages_total",
    "page-pool transitions (alloc / share / cow / free) summed over "
    "every cache in the process, by event")
_M_OOP = _obs_metrics.counter(
    "paddle_tpu_paged_kv_out_of_pages_total",
    "OutOfPagesError raises (the paging backpressure signal)")
_G_FREE = _obs_metrics.gauge(
    "paddle_tpu_paged_kv_pages_free",
    "free pages of each cache's pool, by cache index", max_series=64)
_G_IN_USE = _obs_metrics.gauge(
    "paddle_tpu_paged_kv_pages_in_use",
    "unique owned pages of each cache's pool, by cache index",
    max_series=64)
_G_SHARED = _obs_metrics.gauge(
    "paddle_tpu_paged_kv_pages_shared",
    "pages with refcount > 1 (prefix-shared / forked), by cache index",
    max_series=64)
_G_FRAG = _obs_metrics.gauge(
    "paddle_tpu_paged_kv_internal_frag_pct",
    "tail slack of live sequences' last pages as % of owned capacity, "
    "by cache index", max_series=64)
_G_TRANSIT = _obs_metrics.gauge(
    "paddle_tpu_paged_kv_pages_in_transit",
    "pages held by detached handoff handles, by cache index",
    max_series=64)

_INT8_BOUND = 127.0

_CACHE_INDEX = itertools.count()


class OutOfPagesError(RuntimeError):
    """The pool has no free page (admission backpressure signal: the
    serving tier defers the sequence instead of corrupting the pool)."""


def resolve_device(device) -> torch.device:
    """``device`` as a torch device; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise NoCUDADeviceError(
            f"device {device}: no CUDA device is available; pass "
            "device='cpu' to run on the CPU")
    return device


def _as_tensor(x, device):
    """``x`` (ndarray, list or tensor) as a tensor on ``device``; float64
    becomes float32, as ``jnp.asarray`` makes it with x64 off."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if t.dtype == torch.float64:
        t = t.float()
    return t.to(device)


def kv_scales_of(x, floor=1e-8):
    """Per-channel (head, dim) abs-max scale of ``x`` [T, H, d];
    all-zero channels floor at 1e-8."""
    s = x.float().abs().amax(dim=0)
    return torch.clamp_min(s, floor)


def quantize_kv(x, scale):
    """f32/bf16 [..., H, d] -> int8 under per-channel ``scale`` [H, d]:
    q = clip(round(x/s*127), -127, 127), rounding half to even."""
    q = torch.clamp(torch.round(x.float() / scale * _INT8_BOUND),
                    -_INT8_BOUND, _INT8_BOUND)
    return q.to(torch.int8)


def dequantize_kv(q, scale):
    """int8 [..., H, d] -> f32 (x_hat = q * s / 127)."""
    return q.float() * (scale / _INT8_BOUND)


class PagedKVCache:
    """Block-table paged K/V pool for one decode replica.

    Host side: free-list page allocator, per-page refcounts, per-sequence
    block tables and lengths (plus the full-page radix tree under
    ``kv_share``).  Device side: the two pools, updated in place.  The
    accounting invariant: at every moment ``free_pages + unique
    in_use_pages == num_pages`` with every page's refcount equal to the
    number of holders, and after drain ``in_use_pages == 0``.
    """

    def __init__(self, num_pages, page_size, num_heads, head_dim,
                 dtype=torch.float32, max_seqs=None,
                 max_pages_per_seq=None, kv_int8=None, kv_scales=None,
                 kv_share=None, device="cuda"):
        from paddle_tpu_torch.flags import get_flag

        self.device = resolve_device(device)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.kv_int8 = bool(get_flag("kv_int8")) if kv_int8 is None \
            else bool(kv_int8)
        self.kv_share = bool(get_flag("kv_share")) if kv_share is None \
            else bool(kv_share)
        self.dtype = to_torch_dtype(dtype)
        store = torch.int8 if self.kv_int8 else self.dtype
        # one extra SINK page rides past the allocatable pool: batch
        # writes padded to a fixed size scatter their dummy rows there —
        # never a free-list page, never in the accounting
        self.sink_page = self.num_pages
        shape = (self.num_pages + 1, self.num_heads, self.page_size,
                 self.head_dim)
        self.k_pages = torch.zeros(shape, dtype=store, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=store, device=self.device)
        # per-channel dequant scales (kv_int8 only): calibrated on the
        # first write unless given
        self.k_scale = None
        self.v_scale = None
        if kv_scales is not None:
            self.k_scale = _as_tensor(kv_scales[0], self.device).float()
            self.v_scale = _as_tensor(kv_scales[1], self.device).float()
        self.max_seqs = int(max_seqs) if max_seqs is not None \
            else self.num_pages
        self.max_pages_per_seq = int(max_pages_per_seq) \
            if max_pages_per_seq is not None else self.num_pages
        # host-side allocator state.  Padded/free table entries point at
        # physical page 0 (always a valid index); flash_decode never
        # reads a page at or past a sequence's length.
        self._tables = np.zeros((self.max_seqs,
                                 self.max_pages_per_seq), np.int32)
        self._lens = np.zeros((self.max_seqs,), np.int32)
        self._free_pages = list(range(self.num_pages - 1, -1, -1))
        self._free_slots = list(range(self.max_seqs - 1, -1, -1))
        self._live = set()          # live slot ids
        self._pages_of = {}         # slot -> [page ids] (logical order)
        # per-page refcount: number of holders of the page.  1 everywhere
        # unless kv_share.
        self._ref = np.zeros((self.num_pages,), np.int32)
        self._n_shared = 0          # pages with ref > 1
        # radix tree over FULL pages: root children keyed by the
        # page_size-token tuple; node = {"page": pid, "children": {}}.
        # _radix_of_page maps pid -> (parent_children_dict, key) for
        # O(1) detach when the page's refcount reaches zero.
        self._radix_root = {"children": {}}
        self._radix_of_page = {}
        # radix insertion cursor per slot (chunked prefill registers
        # full pages incrementally as extend() completes them)
        self._radix_cursor = {}
        self._peak_in_use = 0
        self._peak_shared = 0
        # detached page-list handles: handle id -> {"pages": [...],
        # "length": n}.  Pages in transit are owned (never on the free
        # list) but belong to no slot; the accounting counts them.
        self._in_transit = {}
        self._handoff_ids = itertools.count(1)
        self.lock = threading.RLock()
        self._label = str(next(_CACHE_INDEX))

    # -- geometry -----------------------------------------------------------
    def pages_for(self, n_tokens):
        return max(1, math.ceil(n_tokens / self.page_size))

    # -- allocation ---------------------------------------------------------
    def _take_page(self, slot):
        if not self._free_pages:
            _M_OOP.inc()
            raise OutOfPagesError(
                "page pool exhausted (%d pages, %d live seqs)"
                % (self.num_pages, len(self._live)))
        pages = self._pages_of[slot]
        if len(pages) >= self.max_pages_per_seq:
            _M_OOP.inc()
            raise OutOfPagesError(
                "sequence at max_pages_per_seq=%d"
                % self.max_pages_per_seq)
        pid = self._free_pages.pop()
        self._ref[pid] = 1
        self._tables[slot, len(pages)] = pid
        pages.append(pid)
        _M_PAGES.inc(event="alloc")
        self._peak_in_use = max(self._peak_in_use, self._owned_count())
        return pid

    def _untake_page(self, slot, pid):
        """Inverse of _take_page (the atomic rollback path): pid must be
        the slot's LAST page."""
        pages = self._pages_of[slot]
        assert pages and pages[-1] == pid
        pages.pop()
        self._tables[slot, len(pages)] = 0
        self._ref[pid] = 0
        self._free_pages.append(pid)

    def _share_page(self, slot, pid):
        """Point ``slot``'s next logical page at an already-owned
        physical page (prefix sharing / fork)."""
        pages = self._pages_of[slot]
        if len(pages) >= self.max_pages_per_seq:
            _M_OOP.inc()
            raise OutOfPagesError(
                "sequence at max_pages_per_seq=%d"
                % self.max_pages_per_seq)
        self._ref[pid] += 1
        if self._ref[pid] == 2:
            self._n_shared += 1
            self._peak_shared = max(self._peak_shared, self._n_shared)
        self._tables[slot, len(pages)] = pid
        pages.append(pid)
        _M_PAGES.inc(event="share")

    def _deref_page(self, pid):
        """Drop one reference; True when the page went back to the free
        list (refcount hit zero)."""
        self._ref[pid] -= 1
        if self._ref[pid] == 1:
            self._n_shared -= 1
        if self._ref[pid] == 0:
            self._free_pages.append(pid)
            self._radix_detach(pid)
            return True
        return False

    def alloc(self, n_tokens):
        """Reserve a sequence slot with page capacity for ``n_tokens``;
        returns the slot id.  Raises OutOfPagesError (nothing partially
        allocated) when the pool can't hold it."""
        need = self.pages_for(n_tokens)
        if len(self._free_pages) < need:
            _M_OOP.inc()
            raise OutOfPagesError(
                "need %d pages, %d free (of %d)"
                % (need, len(self._free_pages), self.num_pages))
        slot = self._take_slot()
        for _ in range(need):
            self._take_page(slot)
        _flight.record("paged_kv", "alloc", slot=int(slot), pages=need)
        self._export_gauges()
        return slot

    def _take_slot(self):
        if not self._free_slots:
            _M_OOP.inc()
            raise OutOfPagesError("no free sequence slot (max_seqs=%d)"
                                  % self.max_seqs)
        slot = self._free_slots.pop()
        self._live.add(slot)
        self._pages_of[slot] = []
        self._lens[slot] = 0
        return slot

    def _drop_slot(self, slot):
        """Undo a slot taken by a failed prefill/fork: every reference
        dropped, the slot back on the free list."""
        for pid in list(self._pages_of[slot]):
            self._deref_page(pid)
        self._pages_of.pop(slot)
        self._tables[slot, :] = 0
        self._lens[slot] = 0
        self._live.discard(slot)
        self._radix_cursor.pop(slot, None)
        self._free_slots.append(slot)

    def free(self, slot):
        """Retire a sequence: every reference dropped; pages whose
        refcount reaches zero go back on the free list."""
        if slot not in self._live:
            raise KeyError("slot %r is not live" % (slot,))
        self._live.discard(slot)
        pages = self._pages_of.pop(slot)
        n_freed = 0
        for pid in pages:
            if self._deref_page(pid):
                n_freed += 1
        _M_PAGES.inc(n_freed, event="free")
        _flight.record("paged_kv", "free", slot=int(slot),
                       pages=len(pages))
        self._tables[slot, :] = 0
        self._lens[slot] = 0
        self._radix_cursor.pop(slot, None)
        self._free_slots.append(slot)
        self._export_gauges()

    def reset(self):
        """Drop every sequence and in-transit handle (replica relaunch
        path)."""
        for slot in list(self._live):
            self.free(slot)
        self.release_in_transit()

    def fork(self, slot):
        """Beam fork: a NEW slot sharing every page of ``slot``
        (refcounts up, block table copied, same length); the first
        divergent append to a shared page copies it.  Needs
        ``kv_share``."""
        if not self.kv_share:
            raise RuntimeError("fork() needs kv_share=True (copy-on-"
                               "write is what makes aliased pages "
                               "sound)")
        if slot not in self._live:
            raise KeyError("slot %r is not live" % (slot,))
        new = self._take_slot()
        try:
            for pid in self._pages_of[slot]:
                self._share_page(new, pid)
        except OutOfPagesError:
            self._drop_slot(new)
            raise
        self._lens[new] = self._lens[slot]
        _flight.record("paged_kv", "fork", slot=int(slot),
                       child=int(new), pages=len(self._pages_of[new]))
        self._export_gauges()
        return new

    def truncate(self, slot, new_len):
        """Rewind a sequence to ``new_len`` tokens (the speculative-
        decoding rejection path): pages wholly past the new length are
        dereferenced through the same free path — a page-pointer rewind,
        never a byte rewrite."""
        if slot not in self._live:
            raise KeyError("slot %r is not live" % (slot,))
        new_len = int(new_len)
        cur = int(self._lens[slot])
        if not 0 <= new_len <= cur:
            raise ValueError("truncate to %d outside [0, %d]"
                             % (new_len, cur))
        keep = self.pages_for(new_len)   # >= 1: alloc's one-page floor
        pages = self._pages_of[slot]
        dropped = pages[keep:]
        del pages[keep:]
        for pid in dropped:
            self._deref_page(pid)
        self._tables[slot, keep:keep + len(dropped)] = 0
        self._lens[slot] = new_len
        if dropped:
            _M_PAGES.inc(len(dropped), event="rewind")
        self._export_gauges()

    # -- page-list handles --------------------------------------------------
    def detach(self, slot):
        """Detach a live sequence into a PAGE-LIST handle: the slot is
        released but its pages stay owned (the handle holds the slot's
        references) until ``adopt`` re-attaches them to a new slot or
        ``release_in_transit`` frees them.  Host metadata only: no
        device bytes move."""
        if slot not in self._live:
            raise KeyError("slot %r is not live" % (slot,))
        pages = self._pages_of.pop(slot)
        length = int(self._lens[slot])
        self._live.discard(slot)
        self._tables[slot, :] = 0
        self._lens[slot] = 0
        self._radix_cursor.pop(slot, None)
        self._free_slots.append(slot)
        hid = next(self._handoff_ids)
        self._in_transit[hid] = {"pages": list(pages), "length": length}
        handle = {"id": hid, "pages": list(pages), "length": length}
        _M_PAGES.inc(len(pages), event="detach")
        _flight.record("paged_kv", "detach", slot=int(slot),
                       handoff=hid, pages=len(pages), tokens=length)
        self._export_gauges()
        return handle

    def adopt(self, handle):
        """Adopt an in-transit page list onto a fresh slot: table entries
        reinstated, length restored, refcounts untouched.  Raises
        OutOfPagesError (the handle stays in transit) when no slot is
        free or the list exceeds the table width; KeyError for an
        unknown or settled handle."""
        hid = handle["id"] if isinstance(handle, dict) else int(handle)
        ent = self._in_transit.get(hid)
        if ent is None:
            raise KeyError("handoff %r is not in transit" % (hid,))
        pages = ent["pages"]
        if len(pages) > self.max_pages_per_seq:
            _M_OOP.inc()
            raise OutOfPagesError(
                "handoff of %d pages exceeds max_pages_per_seq=%d"
                % (len(pages), self.max_pages_per_seq))
        if not self._free_slots:
            _M_OOP.inc()
            raise OutOfPagesError("no free sequence slot (max_seqs=%d)"
                                  % self.max_seqs)
        del self._in_transit[hid]
        slot = self._take_slot()
        self._pages_of[slot] = list(pages)
        self._tables[slot, :len(pages)] = np.asarray(pages, np.int32)
        self._lens[slot] = ent["length"]
        _M_PAGES.inc(len(pages), event="adopt")
        _flight.record("paged_kv", "adopt", slot=int(slot),
                       handoff=hid, pages=len(pages),
                       tokens=ent["length"])
        self._export_gauges()
        return slot

    def release_in_transit(self, handle=None):
        """Drop an in-transit handle's page references; with no
        argument, every handle.  Returns the number of pages freed."""
        if handle is None:
            n = 0
            for hid in list(self._in_transit):
                n += self.release_in_transit(hid)
            return n
        hid = handle["id"] if isinstance(handle, dict) else int(handle)
        ent = self._in_transit.pop(hid, None)
        if ent is None:
            return 0
        n_freed = 0
        for pid in ent["pages"]:
            if self._deref_page(pid):
                n_freed += 1
        _M_PAGES.inc(n_freed, event="free")
        _flight.record("paged_kv", "handoff_released", handoff=hid,
                       pages=len(ent["pages"]))
        self._export_gauges()
        return n_freed

    def in_transit_pages(self):
        """Pages currently held by detached handles."""
        return sum(len(e["pages"]) for e in self._in_transit.values())

    # -- prefix sharing (radix tree over full pages) ------------------------
    @staticmethod
    def _page_key(tokens, i, ps):
        return tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])

    def _radix_walk(self, tokens, max_pages=None):
        """Longest chain of radix nodes matching ``tokens``' full pages
        (possibly empty)."""
        ps = self.page_size
        n_full = len(tokens) // ps
        if max_pages is not None:
            n_full = min(n_full, max_pages)
        cur, chain = self._radix_root, []
        for i in range(n_full):
            node = cur["children"].get(self._page_key(tokens, i, ps))
            if node is None:
                break
            chain.append(node)
            cur = node
        return chain

    def shared_prefix_tokens(self, tokens):
        """Number of leading tokens of ``tokens`` whose pages the pool
        already holds (a multiple of page_size; 0 unless kv_share).  The
        caller may skip computing K/V for that span entirely."""
        if not self.kv_share or tokens is None:
            return 0
        return len(self._radix_walk(tokens)) * self.page_size

    def _radix_register(self, slot, tokens, first_page, pages):
        """Insert newly WRITTEN full pages into the tree.  ``tokens`` is
        the slot's full token history; pages[i] backs logical page
        first_page + i.  A key conflict keeps the existing node."""
        ps = self.page_size
        cur = self._radix_cursor.get(slot)
        if cur is None:
            chain = self._radix_walk(tokens, max_pages=first_page)
            if len(chain) < first_page:
                # ancestors unregistered (e.g. a copied writer): the tree
                # only holds chains rooted at page 0, so stop here
                return
            cur = chain[-1] if chain else self._radix_root
        for i, pid in enumerate(pages):
            key = self._page_key(tokens, first_page + i, ps)
            node = cur["children"].get(key)
            if node is None:
                node = {"page": int(pid), "children": {}}
                cur["children"][key] = node
                self._radix_of_page[int(pid)] = (cur["children"], key)
            cur = node
        self._radix_cursor[slot] = cur

    def _radix_detach(self, pid):
        """Remove a dead page's node (and its dead descendants)."""
        ent = self._radix_of_page.pop(pid, None)
        if ent is None:
            return
        parent_children, key = ent
        node = parent_children.pop(key, None)
        stack = [node] if node is not None else []
        while stack:
            n = stack.pop()
            self._radix_of_page.pop(n["page"], None)
            stack.extend(n["children"].values())
            n["children"] = {}

    # -- writes -------------------------------------------------------------
    def _maybe_calibrate(self, k, v):
        if self.kv_int8 and self.k_scale is None:
            self.k_scale = kv_scales_of(k)
            self.v_scale = kv_scales_of(v)

    def _store(self, x, scale):
        return quantize_kv(x, scale) if self.kv_int8 \
            else x.to(self.dtype)

    def prefill(self, k, v, tokens=None):
        """Admit a sequence whose prompt K/V is already computed: k/v
        [T, H, d].  Allocates slot and pages, writes page by page, sets
        the length.  Returns the slot id.

        With ``kv_share`` and ``tokens`` (the prompt's token ids): the
        longest already-cached full-page prefix is SHARED instead of
        written, and k/v may cover either the full prompt or only the
        unshared tail ``tokens[shared_prefix_tokens():]``.  Newly
        written full pages register in the radix tree."""
        share = self.kv_share and tokens is not None
        k = _as_tensor(k, self.device)
        v = _as_tensor(v, self.device)
        if share:
            t = len(tokens)
            shared_nodes = self._radix_walk(tokens)
            m = len(shared_nodes) * self.page_size
        else:
            t = int(k.shape[0])
            shared_nodes, m = [], 0
        need_new = self.pages_for(t) - len(shared_nodes) if t else 1
        if len(self._free_pages) < max(0, need_new):
            _M_OOP.inc()
            raise OutOfPagesError(
                "need %d pages, %d free (of %d)"
                % (need_new, len(self._free_pages), self.num_pages))
        if share:
            if int(k.shape[0]) == t:
                k, v = k[m:], v[m:]
            elif int(k.shape[0]) != t - m:
                raise ValueError(
                    "k/v must cover the full prompt (%d tokens) or the "
                    "unshared tail (%d); got %d"
                    % (t, t - m, int(k.shape[0])))
        slot = self._take_slot()
        try:
            for node in shared_nodes:
                self._share_page(slot, node["page"])
            self._lens[slot] = m
            if shared_nodes:
                self._radix_cursor[slot] = shared_nodes[-1]
            if t - m:
                self._write_tokens(slot, k, v,
                                   tokens=tokens if share else None)
            elif not self._pages_of[slot]:
                self._take_page(slot)   # alloc's >= 1 page floor
            self._lens[slot] = t
        except OutOfPagesError:
            # atomic: nothing partially allocated survives a failure
            self._drop_slot(slot)
            raise
        _flight.record("paged_kv", "alloc", slot=int(slot),
                       pages=len(self._pages_of[slot]),
                       shared=len(shared_nodes))
        self._export_gauges()
        return slot

    def extend(self, slot, k, v, tokens=None):
        """Append T tokens' K/V to one sequence (the chunked-prefill
        write path): k/v [T, H, d] land at the slot's current length,
        taking pages as needed, atomically.  ``tokens`` (the slot's FULL
        token history including these T) lets newly completed full pages
        register for prefix sharing."""
        if slot not in self._live:
            raise KeyError("slot %r is not live" % (slot,))
        k = _as_tensor(k, self.device)
        v = _as_tensor(v, self.device)
        self._maybe_calibrate(k, v)
        self._write_tokens(slot, k, v, tokens=tokens)
        self._export_gauges()

    def _write_tokens(self, slot, k, v, tokens=None):
        """Shared write engine for prefill tails and extend: plan the
        page takes and copies for T tokens at the current length (an
        undo journal makes it atomic), then one in-place write per
        touched page."""
        t = int(k.shape[0])
        if t == 0:
            return
        self._maybe_calibrate(k, v)
        ps = self.page_size
        start = int(self._lens[slot])
        journal = []
        cow_pairs = []
        try:
            for pos in range(start, start + t):
                idx = pos // ps
                pages = self._pages_of[slot]
                if idx >= len(pages):
                    pid = self._take_page(slot)
                    journal.append(("take", pid))
                elif self.kv_share and self._ref[pages[idx]] > 1:
                    old = pages[idx]
                    pid = self._cow_page(slot, idx)
                    journal.append(("cow", idx, old, pid))
                    cow_pairs.append((old, pid))
        except OutOfPagesError:
            self._undo(slot, journal)
            raise
        self._apply_cow(cow_pairs)
        ks = self._store(k, self.k_scale)
        vs = self._store(v, self.v_scale)
        first_new_full = []
        pages = self._pages_of[slot]
        off0 = start % ps
        w = 0
        idx = start // ps
        while w < t:
            n = min(ps - off0, t - w)
            pid = pages[idx]
            self.k_pages[pid, :, off0:off0 + n, :] = \
                ks[w:w + n].transpose(0, 1)
            self.v_pages[pid, :, off0:off0 + n, :] = \
                vs[w:w + n].transpose(0, 1)
            if off0 + n == ps:
                first_new_full.append((idx, pid))
            w += n
            off0 = 0
            idx += 1
        self._lens[slot] = start + t
        if self.kv_share and tokens is not None and first_new_full:
            # register the completed full pages (contiguous by
            # construction) for prefix sharing
            i0 = first_new_full[0][0]
            self._radix_register(
                slot, tokens, i0, [p for _, p in first_new_full])

    def _cow_page(self, slot, idx):
        """Copy-on-write: repoint logical page ``idx`` of ``slot`` at a
        fresh physical page (bytes duplicated by _apply_cow); the shared
        original keeps its other holders."""
        if not self._free_pages:
            _M_OOP.inc()
            raise OutOfPagesError(
                "page pool exhausted during copy-on-write (%d pages, "
                "%d live seqs)" % (self.num_pages, len(self._live)))
        old = self._pages_of[slot][idx]
        new = self._free_pages.pop()
        self._ref[new] = 1
        self._ref[old] -= 1
        if self._ref[old] == 1:
            self._n_shared -= 1
        self._pages_of[slot][idx] = new
        self._tables[slot, idx] = new
        _M_PAGES.inc(event="cow")
        self._peak_in_use = max(self._peak_in_use, self._owned_count())
        return new

    def _undo(self, slot, journal):
        for step in reversed(journal):
            if step[0] == "take":
                self._untake_page(slot, step[1])
            else:
                _, idx, old, new = step
                self._pages_of[slot][idx] = old
                self._tables[slot, idx] = old
                self._ref[old] += 1
                if self._ref[old] == 2:
                    self._n_shared += 1
                self._ref[new] = 0
                self._free_pages.append(new)

    def _apply_cow(self, cow_pairs):
        if not cow_pairs:
            return
        olds = torch.tensor([o for o, _ in cow_pairs], dtype=torch.long,
                            device=self.device)
        news = torch.tensor([n for _, n in cow_pairs], dtype=torch.long,
                            device=self.device)
        self.k_pages[news] = self.k_pages[olds]
        self.v_pages[news] = self.v_pages[olds]

    def append(self, slots, k, v):
        """Append tokens for the whole running batch: slots [N] ints; k/v
        [N_pad, H, d] (one token per sequence) or [N_pad, R, H, d] (R
        tokens per sequence, the speculative verify write).  Rows past
        len(slots) are batch padding and scatter into the sink page.  One
        scatter per pool; new pages come off the free list as sequences
        cross page boundaries, shared pages are copied first, and
        OutOfPagesError leaves lengths, tables and refcounts untouched."""
        slots = list(slots)
        k = _as_tensor(k, self.device)
        v = _as_tensor(v, self.device)
        r = 1 if k.dim() == 3 else int(k.shape[1])
        k2 = k.reshape((-1,) + tuple(k.shape[-2:]))
        v2 = v.reshape((-1,) + tuple(v.shape[-2:]))
        self._maybe_calibrate(k2, v2)
        page_ids, offsets = [], []
        journal = {}            # slot -> undo journal
        cow_pairs = []
        try:
            for s in slots:
                ln = int(self._lens[s])
                jr = journal.setdefault(s, [])
                for j in range(r):
                    pos = ln + j
                    idx = pos // self.page_size
                    pages = self._pages_of[s]
                    if idx >= len(pages):
                        pid = self._take_page(s)
                        jr.append(("take", pid))
                    else:
                        pid = pages[idx]
                        if self.kv_share and self._ref[pid] > 1:
                            new = self._cow_page(s, idx)
                            jr.append(("cow", idx, pid, new))
                            cow_pairs.append((pid, new))
                            pid = new
                    page_ids.append(pid)
                    offsets.append(pos % self.page_size)
        except OutOfPagesError:
            for s, jr in journal.items():
                self._undo(s, jr)
            raise
        self._apply_cow(cow_pairs)
        ks = self._store(k2, self.k_scale)
        vs = self._store(v2, self.v_scale)
        n_pad = int(ks.shape[0]) - len(slots) * r
        if n_pad:
            page_ids = page_ids + [self.sink_page] * n_pad
            offsets = offsets + [0] * n_pad
        idx = torch.tensor(np.asarray([page_ids, offsets], np.int64),
                           device=self.device)
        self.k_pages[idx[0], :, idx[1], :] = ks
        self.v_pages[idx[0], :, idx[1], :] = vs
        for s in slots:
            self._lens[s] += r
        self._export_gauges()

    # -- reads --------------------------------------------------------------
    def seq_len(self, slot):
        return int(self._lens[slot])

    def tables_for(self, slots, max_pages=None, pad_to=None):
        """Block tables [N(_pad), max_pages] int32 on the cache's device
        for a batch of slots (padded COLUMNS point at valid page 0 and
        ``pad_to`` adds dummy ROWS of zeros; flash_decode reads neither,
        by the rows' lengths)."""
        n = max_pages if max_pages is not None else max(
            1, max(self.pages_for(int(self._lens[s])) for s in slots))
        t = self._tables[np.asarray(slots), :n]
        if t.shape[1] < n:
            # a requested width past the stored table (a pow2 bucket
            # rounding above max_pages_per_seq) pads COLUMNS with page 0
            t = np.concatenate(
                [t, np.zeros((t.shape[0], n - t.shape[1]), np.int32)],
                axis=1)
        if pad_to is not None and pad_to > t.shape[0]:
            t = np.concatenate(
                [t, np.zeros((pad_to - t.shape[0], n), np.int32)])
        return torch.from_numpy(np.ascontiguousarray(t)).to(self.device)

    def lens_for(self, slots, pad_to=None):
        """Lengths [N(_pad)] int32 on the cache's device (dummy rows have
        length 0; flash_decode emits zeros for them)."""
        ln = self._lens[np.asarray(slots)]
        if pad_to is not None and pad_to > ln.shape[0]:
            ln = np.concatenate(
                [ln, np.zeros((pad_to - ln.shape[0],), np.int32)])
        return torch.from_numpy(np.ascontiguousarray(ln)).to(self.device)

    def kv_scales(self):
        """(k_scale, v_scale) per-channel [H, d] dequant scales (int8
        mode; None otherwise)."""
        return self.k_scale, self.v_scale

    # -- accounting ---------------------------------------------------------
    def _owned_count(self):
        """Cheap unique-owned count (free-list complement); the audit
        surface recomputes it independently from the tables."""
        return self.num_pages - len(self._free_pages)

    def _holder_page_lists(self):
        """Every holder's page list: live slots and in-transit handles."""
        return list(self._pages_of.values()) + \
            [e["pages"] for e in self._in_transit.values()]

    def in_use_pages(self):
        """UNIQUE pages owned by live sequences or in-transit handles."""
        return len({p for pages in self._holder_page_lists()
                    for p in pages})

    def shared_pages(self):
        """Pages held by more than one sequence (refcount > 1)."""
        return self._n_shared

    def free_pages(self):
        return len(self._free_pages)

    def _export_gauges(self):
        free = len(self._free_pages)
        _G_FREE.set(free, cache=self._label)
        _G_IN_USE.set(self.num_pages - free, cache=self._label)
        _G_SHARED.set(self._n_shared, cache=self._label)
        live_tokens = int(sum(self._lens[s] for s in self._live))
        cap = sum(len(p) for p in self._pages_of.values()) * self.page_size
        _G_FRAG.set(
            round(100.0 * (cap - live_tokens) / cap, 2) if cap
            else 0.0, cache=self._label)
        _G_TRANSIT.set(self.in_transit_pages(), cache=self._label)

    def stats(self):
        """Allocator and fragmentation stats.  ``accounted`` is the
        leak invariant: every pool page is free or held by >= 1 holder,
        each shared page counted once, and every refcount equals its
        number of holders."""
        owned = [p for pages in self._holder_page_lists() for p in pages]
        cnt = Counter(owned)
        in_use = len(cnt)
        live_tokens = int(sum(self._lens[s] for s in self._live)) \
            + sum(e["length"] for e in self._in_transit.values())
        capacity = len(owned) * self.page_size
        ref_ok = all(int(self._ref[p]) == c for p, c in cnt.items()) \
            and int((self._ref > 0).sum()) == in_use
        return {
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "free_pages": self.free_pages(),
            "in_use_pages": in_use,
            "in_transit_pages": self.in_transit_pages(),
            "in_transit_handoffs": len(self._in_transit),
            "shared_pages": sum(1 for c in cnt.values() if c > 1),
            "logical_pages": len(owned),
            "peak_in_use_pages": self._peak_in_use,
            "peak_shared_pages": self._peak_shared,
            "live_seqs": len(self._live),
            "accounted": (self.free_pages() + in_use == self.num_pages
                          and ref_ok),
            # internal fragmentation: tail slack of the last page of
            # each live sequence (the only waste paging permits)
            "internal_frag_pct": round(
                100.0 * (capacity - live_tokens) / capacity, 2)
            if capacity else 0.0,
            "kv_int8": self.kv_int8,
            "kv_share": self.kv_share,
        }

    def check_accounting(self):
        """(ok, detail): free + unique(in_use) == num_pages, refcounts
        equal holder counts, no freed page still held, every radix page
        owned."""
        st = self.stats()
        if not st["accounted"]:
            return False, ("page accounting broken: free=%d in_use=%d "
                           "pool=%d refcounts_consistent=%s"
                           % (st["free_pages"], st["in_use_pages"],
                              st["num_pages"],
                              st["free_pages"] + st["in_use_pages"]
                              == st["num_pages"]))
        owned = {p for pages in self._holder_page_lists() for p in pages}
        both = owned & set(self._free_pages)
        if both:
            return False, "pages both free and owned: %s" % sorted(both)
        dead_radix = set(self._radix_of_page) - owned
        if dead_radix:
            return False, ("radix tree holds dead pages: %s"
                           % sorted(dead_radix))
        return True, ""
