# -*- coding: utf-8 -*-
"""
Incremental decoding with a KV cache — the slab, per-slot and paged
halves of ``distributed_dot_product_tpu/models/decode.py``.

Three cache layouts, as in the reference:

- **scalar slab** (:func:`init_cache`): ``(B, H_kv, t_max, d)`` buffers
  and one filled length shared by the batch (lockstep generation);
- **per-slot slab** (:func:`init_slot_cache`): the same buffers with a
  ``(B,)`` length vector — each batch row is an independent serving
  slot (:func:`append_kv_slots`, :func:`reset_slot`);
- **paged** (:func:`init_paged_cache`): one global ``(pages + 1, H_kv,
  page_size, d)`` pool (last row the reserved sink page) read through a
  ``(B, pages_per_slot)`` int32 page table, with the host allocator
  :class:`PagePool` (free list, refcounts, copy-on-write, prefix attach,
  fork) and :class:`PageChecksums` (per-page CRC32 at transfer
  boundaries).

The port runs eagerly, so lengths are host values — an int for the
scalar cache, a numpy int64 vector for per-slot and paged caches — and
an append past ``t_max`` always raises eagerly, naming the slot (the
reference's concrete-overflow contract). Appends and resets write the
buffers IN PLACE: a returned cache holds the same tensors as the one
passed in, with the lengths replaced, where the reference's functional
arrays returned new buffers. Paged writes through a ``-1`` table entry
are dropped, never redirected.

:func:`decode_step` is the fused append + attend step: by default (and
``impl='kernel'``) it runs the K5 port (``flash_decode``) on slab caches
and the K5p port (``flash_decode(page_table=...)``) on paged caches —
the CUDA kernels on the card, their plain versions on the CPU;
``impl='plain'`` runs the append ops + :func:`decode_attention` over the
(gathered) slab view, the reference's portable formulation
(``impl='xla'`` there).

Not ported yet: the int8 K mirror, sequence-sharded steps and the
sharded page table, verify-k (``n > 1`` through the kernel, per-slot
``counts`` above 1), rollback, cross-cache page transfer, windows,
ALiBi and packed segments — they raise ``NotImplementedError``.
"""

import math
import zlib
from typing import NamedTuple, Union

import numpy as np
import torch

from distributed_dot_product_tpu_torch.ops.flash_decode import (
    flash_decode, gather_pages,
)
from distributed_dot_product_tpu_torch.utils.comm import resolve_device

__all__ = ['DecodeCache', 'init_cache', 'append_kv', 'decode_attention',
           'decode_step', 'init_slot_cache', 'append_kv_slots',
           'reset_slot', 'slots_all_finite', 'PagedDecodeCache',
           'init_paged_cache', 'paged_gather', 'paged_append_kv_slots',
           'paged_append_rows', 'paged_reset_slot', 'paged_copy_attach',
           'PagePool', 'PageChecksums']


class DecodeCache(NamedTuple):
    """Static-shape KV cache: ``k``/``v`` are ``(B, H_kv, t_max, d·)``
    buffers; ``length`` the number of filled positions — a host int, or
    a ``(B,)`` numpy int64 vector for a per-slot cache."""
    k: torch.Tensor
    v: torch.Tensor
    length: Union[int, np.ndarray]

    @property
    def t_max(self):
        return self.k.shape[-2]


def _unported(fn, **kw):
    for name, value in kw.items():
        if value is not None:
            raise NotImplementedError(f'{fn}({name}=...) is not ported yet')


def _host(x, dtype):
    """A per-slot vector as a host numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).astype(dtype).reshape(-1)


def _to_device(x, device, dtype=np.int64):
    """A host vector on ``device`` without a stream synchronisation: a
    host-to-device copy from pageable memory is staged before the call
    returns, so the host may reuse ``x`` at once and need not wait for
    the card (a blocking copy would, and stall the host a step ahead)."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(
        device, non_blocking=True)


def init_cache(batch, kv_heads, t_max, head_dim, v_head_dim=None,
               dtype=torch.bfloat16, qk_quant=None, device='cuda'):
    """Zero cache for ``t_max`` positions on ``device``."""
    if qk_quant not in (None, 'int8'):
        raise ValueError(f"qk_quant must be None or 'int8', "
                         f'got {qk_quant!r}')
    _unported('init_cache', qk_quant=qk_quant)
    dev = resolve_device(device)
    v_head_dim = v_head_dim or head_dim
    return DecodeCache(
        k=torch.zeros((batch, kv_heads, t_max, head_dim), dtype=dtype,
                      device=dev),
        v=torch.zeros((batch, kv_heads, t_max, v_head_dim), dtype=dtype,
                      device=dev),
        length=0)


def _check_room(cache, n):
    if n > cache.t_max:
        raise ValueError(f'appending {n} positions to a t_max='
                         f'{cache.t_max} cache')
    if cache.length + n > cache.t_max:
        raise ValueError(
            f'KV-cache overflow: length {cache.length} + {n} new positions '
            f'exceeds t_max {cache.t_max} — grow the cache or stop the '
            f'generation loop')


def append_kv(cache: DecodeCache, k_new, v_new) -> DecodeCache:
    """Append ``k_new``/``v_new`` ``(B, H_kv, n, d·)`` at the cache head,
    writing the buffers in place; returns the cache with the length
    advanced. Appending past ``t_max`` raises and writes nothing."""
    n = k_new.shape[-2]
    _check_room(cache, n)
    end = cache.length + n
    cache.k[:, :, cache.length:end] = k_new.to(cache.k.dtype)
    cache.v[:, :, cache.length:end] = v_new.to(cache.v.dtype)
    return cache._replace(length=end)


# -- per-slot caches ----------------------------------------------------


def init_slot_cache(slots, kv_heads, t_max, head_dim, v_head_dim=None,
                    dtype=torch.bfloat16, device='cuda'):
    """Serving cache with PER-SLOT lengths: :func:`init_cache`'s buffers
    with ``length`` a ``(slots,)`` vector — each batch row an independent
    decode slot that fills, decodes and frees on its own clock."""
    base = init_cache(slots, kv_heads, t_max, head_dim,
                      v_head_dim=v_head_dim, dtype=dtype, device=device)
    return base._replace(length=np.zeros(slots, np.int64))


def _slot_counts(b, n, slot_mask, counts):
    """Rows each slot appends: ``counts`` clipped to ``[0, n]`` (default
    ``n``), 0 where ``slot_mask`` is False."""
    eff = (np.full(b, n, np.int64) if counts is None
           else np.clip(_host(counts, np.int64), 0, n))
    if slot_mask is not None:
        eff = np.where(_host(slot_mask, bool), eff, 0)
    return eff


def _check_slot_room(lengths, eff, t_max):
    for i, (cur, add) in enumerate(zip(lengths.tolist(), eff.tolist())):
        if add and cur + add > t_max:
            raise ValueError(
                f'KV-cache overflow on slot {i}: length {cur} + {add} new '
                f'position(s) exceeds t_max {t_max} — evict the slot '
                f'(reset_slot) or stop its generation loop')


def append_kv_slots(cache, k_new, v_new, *, slot_mask=None, counts=None):
    """Per-slot append: each slot's rows land at ITS length, in place.
    ``k_new``/``v_new`` are ``(B, H_kv, n, d·)``; ``counts (B,)`` takes
    the first ``counts[i]`` of the ``n`` rows for slot ``i`` (padded
    prefill chunks; default all ``n``); ``slot_mask (B,) bool`` freezes
    unselected slots entirely (buffers and length). An overflow raises
    naming the slot and writes nothing. A paged cache appends through its
    page table (:func:`paged_append_kv_slots`)."""
    if isinstance(cache, PagedDecodeCache):
        return paged_append_kv_slots(cache, k_new, v_new,
                                     slot_mask=slot_mask, counts=counts)
    if not isinstance(cache.length, np.ndarray):
        raise ValueError(
            'append_kv_slots needs a per-slot cache (init_slot_cache); '
            'this cache has a scalar length — use append_kv')
    n = k_new.shape[-2]
    if n > cache.t_max:
        raise ValueError(f'appending {n} positions to a t_max='
                         f'{cache.t_max} cache')
    eff = _slot_counts(cache.k.shape[0], n, slot_mask, counts)
    _check_slot_room(cache.length, eff, cache.t_max)
    for i in np.nonzero(eff)[0].tolist():
        lo, e = int(cache.length[i]), int(eff[i])
        cache.k[i, :, lo:lo + e] = k_new[i, :, :e].to(cache.k.dtype)
        cache.v[i, :, lo:lo + e] = v_new[i, :, :e].to(cache.v.dtype)
    return cache._replace(length=cache.length + eff)


def reset_slot(cache: DecodeCache, slot) -> DecodeCache:
    """Evict one sequence: zero slot ``slot``'s rows and length in place;
    every other slot's bits are untouched."""
    if isinstance(cache, PagedDecodeCache):
        raise ValueError(
            'reset_slot on a paged cache needs the freed-page list — '
            'use paged_reset_slot with PagePool.release()\'s result')
    if not isinstance(cache.length, np.ndarray):
        raise ValueError(
            'reset_slot needs a per-slot cache (init_slot_cache); a '
            'scalar-length cache is reset by init_cache — its batch '
            'rows share one sequence clock')
    cache.k[slot].zero_()
    cache.v[slot].zero_()
    length = cache.length.copy()
    length[slot] = 0
    return cache._replace(length=length)


def slots_all_finite(x):
    """Per-slot all-finite predicate: ``(B, ...)`` → ``(B,) bool`` — the
    serving layer's quarantine test."""
    return torch.isfinite(x.reshape(x.shape[0], -1)).all(dim=-1)


# -- paged caches -------------------------------------------------------


class PagedDecodeCache(NamedTuple):
    """Paged serving cache: ``k_pool``/``v_pool`` are global ``(pages +
    1, H_kv, page_size, d·)`` pools; ``page_table`` the ``(slots,
    pages_per_slot) int32`` device map from each slot's logical page
    ordinal to its pool page (-1 = unallocated); ``length`` the per-slot
    fill (host vector), as :func:`init_slot_cache`. Position ``p`` of
    slot ``i`` lives at row ``p % page_size`` of pool page
    ``page_table[i, p // page_size]``.

    The LAST pool row (index :attr:`pages`) is the reserved sink page —
    never allocated, never attended. The port never writes it; the
    layout keeps it so the pool geometry (and :class:`PagePool`'s page
    ids) match the reference's."""
    k_pool: torch.Tensor
    v_pool: torch.Tensor
    page_table: torch.Tensor
    length: np.ndarray

    @property
    def page_size(self):
        return self.k_pool.shape[-2]

    @property
    def pages(self):
        """Allocatable pages (the sink row is not one of them)."""
        return self.k_pool.shape[0] - 1

    @property
    def pages_per_slot(self):
        return self.page_table.shape[1]

    @property
    def slots(self):
        return self.page_table.shape[0]

    @property
    def t_max(self):
        """Per-slot logical capacity (the page table's reach)."""
        return self.page_table.shape[1] * self.k_pool.shape[-2]


def init_paged_cache(slots, kv_heads, t_max, head_dim, *, pages,
                     page_size, v_head_dim=None, dtype=torch.bfloat16,
                     qk_quant=None, device='cuda'):
    """Zero paged cache: a ``pages``-page pool (plus the sink row) whose
    page size divides the per-slot capacity ``t_max``, on ``device``."""
    v_head_dim = v_head_dim or head_dim
    if page_size < 1 or t_max % page_size:
        raise ValueError(f'page_size {page_size} must divide t_max '
                         f'{t_max}')
    if pages < 1:
        raise ValueError(f'need pages >= 1, got {pages}')
    if qk_quant not in (None, 'int8'):
        raise ValueError(f"qk_quant must be None or 'int8', "
                         f'got {qk_quant!r}')
    _unported('init_paged_cache', qk_quant=qk_quant)
    dev = resolve_device(device)
    return PagedDecodeCache(
        k_pool=torch.zeros((pages + 1, kv_heads, page_size, head_dim),
                           dtype=dtype, device=dev),
        v_pool=torch.zeros((pages + 1, kv_heads, page_size, v_head_dim),
                           dtype=dtype, device=dev),
        page_table=torch.full((slots, t_max // page_size), -1,
                              dtype=torch.int32, device=dev),
        length=np.zeros(slots, np.int64))


def paged_gather(cache: PagedDecodeCache):
    """The slab view ``(k, v)``, each ``(slots, H_kv, t_max, d·)``, of a
    paged cache; unallocated entries read zeros (the reference reads its
    never-written sink row)."""
    return (gather_pages(cache.k_pool, cache.page_table),
            gather_pages(cache.v_pool, cache.page_table))


def _scatter_rows(cache, pool_rows, vals_k, vals_v):
    """Write rows ``vals_* (M, H_kv, d·)`` at ``pool_rows = (pages,
    rows)`` (host index vectors) of both pools, in place."""
    if not len(pool_rows[0]):
        return
    dev = cache.k_pool.device
    pg, rw = (_to_device(x, dev) for x in pool_rows)
    cache.k_pool[pg, :, rw] = vals_k.to(cache.k_pool.dtype)
    cache.v_pool[pg, :, rw] = vals_v.to(cache.v_pool.dtype)


def _page_targets(table_rows, pos, ps):
    """Pool ``(page, row)`` of logical positions ``pos`` through the
    per-position table rows ``table_rows (M, pages_per_slot)``, and which
    of them hold a page (past the table's reach or -1: dropped)."""
    npg = table_rows.shape[1]
    pi = pos // ps
    pg = np.take_along_axis(table_rows, np.minimum(pi, npg - 1)[:, None],
                            axis=1)[:, 0]
    ok = (pi < npg) & (pg >= 0)
    return pg[ok], (pos % ps)[ok], ok


def paged_append_kv_slots(cache: PagedDecodeCache, k_new, v_new, *,
                          slot_mask=None, counts=None):
    """:func:`append_kv_slots` over the paged pool: each slot's rows
    scatter into the pool pages its table names, at its own length; a
    row whose table entry is -1 is dropped (the host allocator reserves
    pages first). Same ``counts``/``slot_mask`` and overflow contract."""
    n = k_new.shape[-2]
    if n > cache.t_max:
        raise ValueError(f'appending {n} positions to a t_max='
                         f'{cache.t_max} cache')
    eff = _slot_counts(cache.slots, n, slot_mask, counts)
    _check_slot_room(cache.length, eff, cache.t_max)
    slot = np.repeat(np.arange(cache.slots), eff)
    j = np.concatenate([np.arange(e) for e in eff.tolist()] or
                       [np.zeros(0, np.int64)]).astype(np.int64)
    table = cache.page_table.cpu().numpy()
    pg, rw, ok = _page_targets(table[slot], cache.length[slot] + j,
                               cache.page_size)
    si, ji = _to_device(slot[ok], k_new.device), _to_device(j[ok],
                                                             k_new.device)
    _scatter_rows(cache, (pg, rw), k_new[si, :, ji], v_new[si, :, ji])
    return cache._replace(length=cache.length + eff)


def paged_append_rows(cache: PagedDecodeCache, k_rows, v_rows, page_row,
                      start, count):
    """Single-sequence scatter used by prefix registration: ``count`` of
    the ``k_rows``/``v_rows (H_kv, C, d·)`` rows land at logical
    positions ``start..`` through the ``(pages_per_slot,)`` ``page_row``
    vector (-1-padded), with no slot or length involved."""
    c = k_rows.shape[-2]
    j = np.arange(min(int(count), c))
    row = _host(page_row, np.int64)
    pg, rw, ok = _page_targets(np.broadcast_to(row, (len(j), len(row))),
                               int(start) + j, cache.page_size)
    ji = _to_device(j[ok], k_rows.device)
    _scatter_rows(cache, (pg, rw), k_rows[:, ji].transpose(0, 1),
                  v_rows[:, ji].transpose(0, 1))
    return cache


def paged_reset_slot(cache: PagedDecodeCache, slot, freed_pages):
    """Evict one sequence from a paged cache: zero the pool pages in
    ``freed_pages`` (-1-padded; the pages whose refcount the host
    allocator dropped to zero — still-shared pages keep their bits),
    clear the slot's page-table row and zero its length (``slot = -1``
    touches no slot). Zeroing freed pages keeps a recycled page's unfilled
    tail benign: a NaN left by a poisoned sequence would otherwise leak
    into its next owner's output (0 · NaN = NaN)."""
    freed = _host(freed_pages, np.int64)
    freed = freed[(freed >= 0) & (freed <= cache.pages)]
    if len(freed):
        idx = _to_device(freed, cache.k_pool.device)
        cache.k_pool[idx] = 0
        cache.v_pool[idx] = 0
    length = cache.length
    if 0 <= slot < cache.slots:
        cache.page_table[slot] = -1
        length = length.copy()
        length[slot] = 0
    return cache._replace(length=length)


def paged_copy_attach(cache: PagedDecodeCache, src_page, dst_page, slot,
                      length_val):
    """The copy-on-write / attach primitive: copy pool page ``src_page``
    → ``dst_page`` (-1 = no copy) and set ``length[slot] = length_val``
    (``slot = -1`` = no length change). The page table is host-owned; the
    caller re-mirrors it."""
    src, dst = int(src_page), int(dst_page)
    if 0 <= dst <= cache.pages:
        cache.k_pool[dst] = cache.k_pool[max(src, 0)]
        cache.v_pool[dst] = cache.v_pool[max(src, 0)]
    length = cache.length
    if 0 <= slot < cache.slots:
        length = length.copy()
        length[slot] = int(length_val)
    return cache._replace(length=length)


class PagePool:
    """Host-side page allocator for a :class:`PagedDecodeCache`: free
    list, per-page refcounts, per-slot page-table mirror and length
    mirror. Pure numpy bookkeeping — deterministic (LIFO free list),
    no device work; the owner performs the device-side copies/zeroing
    its return values call for and re-mirrors :attr:`table` to the
    device when :attr:`dirty` is set.

    Sharing model: a page's refcount counts the page-table rows (plus
    registered prefixes) naming it. Pages are only ever WRITTEN at
    refcount 1 — :meth:`prepare_append` returns the copy-on-write pair
    when a slot's append page is shared, and :meth:`fork` /
    :meth:`attach` share full pages read-only while copying the partial
    tail page the branch will append into."""

    def __init__(self, pages, page_size, slots, pages_per_slot):
        self.pages = pages
        self.page_size = page_size
        self.slots = slots
        self.pages_per_slot = pages_per_slot
        self.refcount = np.zeros(pages, np.int32)
        self._free = list(range(pages - 1, -1, -1))   # pop() → 0, 1, …
        self.table = np.full((slots, pages_per_slot), -1, np.int32)
        self.counts = np.zeros(slots, np.int32)       # pages per slot
        self.lengths = np.zeros(slots, np.int64)      # fill per slot
        self.dirty = False          # table changed since last mirror
        self.quarantined = set()    # pages withdrawn from circulation

    # -- introspection --------------------------------------------------
    @property
    def free_pages(self):
        return len(self._free)

    @property
    def used_pages(self):
        return self.pages - len(self._free)

    @property
    def shared_pages(self):
        """Pages referenced more than once — the prefix-sharing/fork
        win, and the acceptance gauge ('the prefix's pages occupied
        exactly once')."""
        return int(np.sum(self.refcount > 1))

    def slot_pages(self, slot):
        return int(self.counts[slot])

    def pages_for_rows(self, rows):
        """Pages a fresh sequence of ``rows`` tokens needs."""
        return -(-rows // self.page_size)

    # -- allocation -----------------------------------------------------
    def alloc(self):
        """One free page at refcount 1, or None (exhausted). Freshly
        allocated pages are always zero: init starts them zero and
        :meth:`_unref` only frees a page after the owner zeroes it."""
        if not self._free:
            return None
        page = self._free.pop()
        self.refcount[page] = 1
        return page

    def _unref(self, page):
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            # A quarantined page never re-enters the free list: the
            # owner still zeroes it (True), but it stays withdrawn.
            if page not in self.quarantined:
                self._free.append(page)
            return True
        return False

    def quarantine(self, pages):
        """Withdraw ``pages`` from circulation permanently (corruption
        verdict): free pages leave the free list now, referenced pages
        are withheld by :meth:`_unref` when their last reference drops.
        Returns the pages newly quarantined (idempotent)."""
        fresh = []
        for page in pages:
            page = int(page)
            if page in self.quarantined:
                continue
            self.quarantined.add(page)
            if self.refcount[page] == 0:
                # Delete by INDEX, never list.remove: .remove raises an
                # untyped ValueError when the element is missing.
                idx = next(
                    (i for i, f in enumerate(self._free) if f == page), None
                )
                if idx is not None:
                    self._free.pop(idx)
            fresh.append(page)
        return fresh

    def alloc_block(self, n):
        """Allocate ``n`` fresh pages as one unit (prefix
        registration). Returns the page list, or None with NOTHING
        changed when the pool cannot supply all of them (partial
        allocations roll back — never-written pages go straight back
        on the free list, still zero)."""
        pages = []
        for _ in range(n):
            p = self.alloc()
            if p is None:
                for q in reversed(pages):
                    self.refcount[q] = 0
                    self._free.append(q)
                return None
            pages.append(p)
        return pages

    def release_pages(self, pages):
        """Drop one reference from each page. Returns the pages that
        hit refcount 0 — back on the free list, and owed a device zero
        by the caller before any reuse (the :meth:`alloc` invariant)."""
        return [p for p in pages if self._unref(p)]

    def prepare_append(self, slot):
        """Make the next append position of ``slot`` writable. Returns
        ``(status, src, dst)``: ``('ok', -1, -1)`` nothing to do;
        ``('alloc', -1, page)`` a fresh (zero) page was mapped;
        ``('cow', src, dst)`` the append page was shared — the caller
        must device-copy ``src → dst`` (copy-on-write: the FIRST
        divergent append after a fork/attach pays one page copy);
        ``('full', -1, -1)`` the slot is at ``t_max`` — no page can
        ever cover the position, the device write drops (the slab
        engine's frozen-write contract), and allocating would not
        help; ``('exhausted', -1, -1)`` the pool is out of pages and
        nothing changed."""
        pos = int(self.lengths[slot])
        pi = pos // self.page_size
        if pi >= self.pages_per_slot:
            return ('full', -1, -1)
        if pi >= self.counts[slot]:
            page = self.alloc()
            if page is None:
                return ('exhausted', -1, -1)
            self.table[slot, pi] = page
            self.counts[slot] = pi + 1
            self.dirty = True
            return ('alloc', -1, page)
        page = int(self.table[slot, pi])
        if self.refcount[page] > 1:
            fresh = self.alloc()
            if fresh is None:
                return ('exhausted', -1, -1)
            self.refcount[page] -= 1        # > 1 before: never frees
            self.table[slot, pi] = fresh
            self.dirty = True
            return ('cow', page, fresh)
        return ('ok', -1, -1)

    def reserve_rows(self, slot, rows):
        """Reserve every page covering logical rows ``[length, length +
        rows)`` of ``slot`` (admission-time: a prompt's prefill must
        never fail mid-chunk). Returns ``(ok, copies)`` — ``copies``
        is the list of ``(src, dst)`` device copies the caller owes
        (at most one: the shared tail page). On exhaustion nothing is
        changed (partial allocations are rolled back)."""
        start = int(self.lengths[slot])
        end = start + rows
        if end > self.pages_per_slot * self.page_size:
            return False, []
        counts0 = int(self.counts[slot])
        undo = []                   # (pi, previous_entry, was_cow)
        copies = []
        for pi in range(start // self.page_size,
                        -(-end // self.page_size)):
            if pi >= self.counts[slot]:
                page = self.alloc()
                if page is None:
                    self._undo_reserve(slot, undo, counts0)
                    return False, []
                undo.append((pi, -1, False))
                self.table[slot, pi] = page
                self.counts[slot] = pi + 1
                self.dirty = True
            else:
                page = int(self.table[slot, pi])
                if self.refcount[page] > 1:
                    dup = self.alloc()
                    if dup is None:
                        self._undo_reserve(slot, undo, counts0)
                        return False, []
                    undo.append((pi, page, True))
                    self.refcount[page] -= 1
                    self.table[slot, pi] = dup
                    copies.append((page, dup))
                    self.dirty = True
        return True, copies

    def _undo_reserve(self, slot, undo, counts0):
        """Roll a partial :meth:`reserve_rows` back: on exhaustion the
        pool and the slot's row look exactly as they did before the
        call (a shed admission must not leak pages or CoW remaps)."""
        for pi, prev, was_cow in reversed(undo):
            page = int(self.table[slot, pi])
            self.refcount[page] = 0
            self._free.append(page)
            self.table[slot, pi] = prev
            if was_cow:
                self.refcount[prev] += 1
        self.counts[slot] = counts0

    def release(self, slot):
        """Drop every page reference ``slot`` holds; returns the pages
        whose refcount reached zero (the caller zeroes them on device
        BEFORE they can be re-allocated) and clears the slot's row and
        length."""
        freed = []
        for pi in range(int(self.counts[slot])):
            page = int(self.table[slot, pi])
            if page >= 0 and self._unref(page):
                freed.append(page)
        self.table[slot, :] = -1
        self.counts[slot] = 0
        self.lengths[slot] = 0
        self.dirty = True
        return freed

    def truncate(self, slot, new_length):
        """Acceptance-prefix rollback, host side: shrink ``slot``'s fill
        to ``new_length`` and release the tail pages no kept row lives
        in (refcount−−; the returned list is the pages that hit 0 — the
        caller zeroes them on device before reuse, the :meth:`alloc`
        invariant, via the same reset program as eviction). The kept
        partial tail page stays mapped; the device-side
        :func:`paged_rollback_slots` zeroes its rejected rows. A
        ``new_length`` at or past the current fill is a no-op."""
        if new_length >= int(self.lengths[slot]):
            return []
        keep = self.pages_for_rows(int(new_length))
        freed = []
        for pi in range(keep, int(self.counts[slot])):
            page = int(self.table[slot, pi])
            if page >= 0:
                if self._unref(page):
                    freed.append(page)
                self.table[slot, pi] = -1
                self.dirty = True
        self.counts[slot] = min(int(self.counts[slot]), keep)
        self.lengths[slot] = new_length
        return freed

    # -- sharing --------------------------------------------------------
    def attach(self, slot, pages, length):
        """Point an EMPTY slot at a registered prefix: share the full
        pages read-only (refcount++), and if ``length`` ends mid-page
        allocate a private tail page the caller must device-copy the
        prefix's tail into. Returns ``(ok, tail_src, tail_dst)`` with
        −1s when no tail copy is needed; on exhaustion nothing is
        changed."""
        if self.counts[slot] or self.lengths[slot]:
            # Pool-state invariant, not an argument check: the serving
            # stack attaches only onto a just-reset slot, so a non-empty
            # one means the bookkeeping broke — RuntimeError, the typed
            # internal-state shape.
            raise RuntimeError(f'attach needs an empty slot, slot '
                               f'{slot} holds {self.counts[slot]} '
                               f'pages')
        full = length // self.page_size
        rem = length % self.page_size
        tail_src = tail_dst = -1
        if rem:
            tail_dst = self.alloc()
            if tail_dst is None:
                return False, -1, -1
            tail_src = int(pages[full])
        for i in range(full):
            self.table[slot, i] = pages[i]
            self.refcount[pages[i]] += 1
        if rem:
            self.table[slot, full] = tail_dst
        self.counts[slot] = full + (1 if rem else 0)
        self.lengths[slot] = length
        self.dirty = True
        return True, tail_src, tail_dst

    def fork(self, src, dst):
        """Copy-on-write fork ``src → dst`` (an empty slot): full pages
        shared (refcount++), the partial tail page — the only page the
        branches will write divergently — copied. Returns ``(ok,
        tail_src, tail_dst)`` exactly like :meth:`attach`."""
        length = int(self.lengths[src])
        pages = [int(self.table[src, i])
                 for i in range(int(self.counts[src]))]
        return self.attach(dst, pages, length)



def _page_bytes(t):
    return t.contiguous().view(torch.uint8).cpu().numpy().tobytes()


class PageChecksums:
    """Host-side per-page integrity table for a
    :class:`PagedDecodeCache`: CRC32 over a page's K and V rows, recorded
    at TRANSFER boundaries only (registry fills) — never per decode step.
    Registered prefix pages are immutable once filled (copy-on-write
    sends divergent appends to fresh pages), so a digest recorded at
    fill time stays valid for the page's tracked life.

    The digest is the reference's ``(kv_crc, mirror_crc)`` pair;
    ``mirror_crc`` is 0 (the port has no int8 K mirror yet)."""

    def __init__(self):
        self._crc = {}              # page -> (kv_crc, mirror_crc)

    def __contains__(self, page):
        return int(page) in self._crc

    def __len__(self):
        return len(self._crc)

    def pages(self):
        """Tracked pages, sorted (deterministic iteration order)."""
        return sorted(self._crc)

    @staticmethod
    def digest(cache, page):
        """``page``'s ``(kv_crc, mirror_crc)`` from the live pools (one
        host copy of the page; transfer boundaries only)."""
        page = int(page)
        crc = zlib.crc32(_page_bytes(cache.k_pool[page]))
        return zlib.crc32(_page_bytes(cache.v_pool[page]), crc), 0

    def record(self, cache, pages):
        """(Re)digest ``pages`` from ``cache`` and remember the result
        — the page's content is declared canonical as of now."""
        for page in pages:
            self._crc[int(page)] = self.digest(cache, page)

    def get(self, page):
        return self._crc.get(int(page))

    def drop(self, pages):
        """Forget digests for pages leaving the tracked set (prefix
        unregistration / pool zeroing)."""
        for page in pages:
            self._crc.pop(int(page), None)

    def verify(self, cache, pages=None):
        """Re-digest ``pages`` (default: every tracked page) against
        the recorded values. Returns the sorted list of mismatching
        pages — empty means clean. Unrecorded pages are skipped."""
        if pages is None:
            pages = self.pages()
        bad = []
        for page in pages:
            page = int(page)
            want = self._crc.get(page)
            if want is not None and self.digest(cache, page) != want:
                bad.append(page)
        return sorted(bad)


# -- attention and the fused step ---------------------------------------


def decode_attention(q, cache: DecodeCache, *, scale=None, window=None,
                     alibi_slopes=None, segment_ids=None, seg_q=None,
                     qk_quant=None, axis_name=None, col_valid=None,
                     col_offset=None):
    """Masked-softmax attention of ``q (B, H, n, d)`` — the LAST ``n``
    appended positions — against the cache prefix; returns
    ``(B, H, n, d_v)`` in the cache dtype. A per-slot cache masks each
    row against its own length. Float32 scores and weights; a row with no
    attendable column returns 0."""
    _unported('decode_attention', window=window, alibi_slopes=alibi_slopes,
              segment_ids=segment_ids, seg_q=seg_q, qk_quant=qk_quant,
              axis_name=axis_name, col_valid=col_valid,
              col_offset=col_offset)
    b, h, n, d = q.shape
    h_kv = cache.k.shape[1]
    if h % h_kv:
        raise ValueError(f'query heads {h} must be a multiple of cache '
                         f'kv heads {h_kv}')
    group = h // h_kv
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    t_max = cache.t_max
    dev = q.device
    qg = q.reshape(b, h_kv, group * n, d).float()
    s = torch.matmul(qg, cache.k.float().transpose(-1, -2)) * scale
    s = s.reshape(b, h_kv, group, n, t_max)
    # Query row i sits at position length - n + i and attends positions
    # at or before its own; a per-slot cache gives each row its length.
    length = torch.as_tensor(cache.length, device=dev).reshape(-1, 1)
    pos_q = length - n + torch.arange(n, device=dev)     # (B | 1, n)
    pos_k = torch.arange(t_max, device=dev)
    allowed = pos_k <= pos_q[..., None]                  # (B | 1, n, t_max)
    s = s.masked_fill(~allowed[:, None, None], float('-inf'))
    m = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)          # empty rows
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(denom == 0.0, 1.0, denom)
    out = torch.matmul(p, cache.v.float()[:, :, None])
    return out.to(cache.v.dtype).reshape(b, h, n, cache.v.shape[-1])


def decode_step(q, cache, k_new, v_new, *, slot_mask=None, counts=None,
                scale=None, window=None, alibi_slopes=None, segment_ids=None,
                seg_q=None, qk_quant=None, axis_name=None, impl=None,
                interpret=None):
    """One fused decode step: append ``k_new``/``v_new`` ``(B, H_kv, 1,
    d)`` to the cache (in place) AND attend ``q (B, H, 1, d)`` against
    the result. ``impl``: ``None``/``'auto'``/``'kernel'`` run the K5
    port on slab caches and the K5p port on paged caches (CUDA kernels
    for CUDA tensors, their plain versions for CPU tensors); ``'plain'``
    runs the append ops + :func:`decode_attention` over the (gathered)
    slab view (any ``n``).

    Per-slot and paged caches take ``slot_mask (B,) bool`` (masked slots
    append nothing and their queries attend their un-advanced prefix)
    and ``counts (B,)`` (rows appended per slot, at most 1 here — verify-k
    is not ported). An overflow raises eagerly, naming the slot.
    Returns ``(cache, out (B, H, n, d_v))``."""
    _unported('decode_step', window=window, alibi_slopes=alibi_slopes,
              segment_ids=segment_ids, seg_q=seg_q, qk_quant=qk_quant,
              axis_name=axis_name)
    if impl not in (None, 'auto', 'kernel', 'plain'):
        raise ValueError(f"decode impl must be None/'auto'/'kernel'/"
                         f"'plain', got {impl!r}")
    paged = isinstance(cache, PagedDecodeCache)
    per_slot = isinstance(cache.length, np.ndarray)
    if (slot_mask is not None or counts is not None) and not per_slot:
        raise ValueError('slot_mask/counts need a per-slot cache '
                         '(init_slot_cache or init_paged_cache); '
                         'scalar-length caches share one sequence clock')
    b, _, n, _ = q.shape
    if counts is not None and n > 1:
        raise NotImplementedError('per-slot counts with n > 1 (verify-k) '
                                  'are not ported yet')
    if impl == 'plain':
        if per_slot:
            cache = append_kv_slots(cache, k_new, v_new,
                                    slot_mask=slot_mask, counts=counts)
        else:
            cache = append_kv(cache, k_new, v_new)
        attend = cache
        if paged:
            attend = DecodeCache(*paged_gather(cache), length=cache.length)
        return cache, decode_attention(q, attend, scale=scale)
    if n != 1:
        raise NotImplementedError(
            f'the fused decode kernel takes one new row per step (verify-k '
            f'is not ported yet), got n={n}; use impl="plain"')
    if per_slot:
        lengths = cache.length
        eff = _slot_counts(b, 1, slot_mask, counts)
        _check_slot_room(lengths, eff, cache.t_max)
        active = (np.ones(b, bool) if slot_mask is None
                  else _host(slot_mask, bool))
        # Active queries sit AT their append position; frozen slots'
        # queries attend their un-advanced prefix.
        ap = _to_device(np.where(eff > 0, lengths, -1), q.device, np.int32)
        vt = _to_device(np.where(active, lengths, lengths - 1), q.device,
                        np.int32)
        new_length = lengths + eff
    else:
        _check_room(cache, 1)
        ap = vt = torch.full((b,), cache.length, dtype=torch.int32,
                             device=q.device)
        new_length = cache.length + 1
    if paged:
        out, _, _ = flash_decode(q, k_new, v_new, cache.k_pool, cache.v_pool,
                                 vt, ap, page_table=cache.page_table,
                                 scale=scale, interpret=interpret)
    else:
        out, _, _ = flash_decode(q, k_new, v_new, cache.k, cache.v, vt, ap,
                                 scale=scale, interpret=interpret)
    return cache._replace(length=new_length), out
