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

Sequence-sharded slab decode (the reference's ``axis_name`` steps; here
``group=``, a ``torch.distributed`` process group): each rank of the
sequence group holds the ``(B, H_kv, t_max/W, d)`` slab of a global
cache, ``length`` is the GLOBAL fill, :func:`append_kv_sharded` writes
the rows a rank owns, and :func:`decode_attention` /
:func:`decode_step` merge the ranks' softmax partials by the
flash-decoding rule (:func:`_flash_merge`: max over ranks, rescale, sum).
Every rank runs every collective of a step, its slab full, empty or
wholly in the query's future alike. An append past the global capacity
raises eagerly on every rank and writes nothing.

Verify-k (``decode_step`` with ``n > 1`` rows and per-slot ``counts``,
speculative decoding's fused verify) runs through K5/K5p, and
:func:`rollback_slots` / :func:`paged_rollback_slots` truncate each slot
to its accepted prefix. ``qk_quant='int8'`` caches carry the int8 K
mirror (``k_q``/``k_scale``, paged ``k_q_pool``/``k_scale_pool``), kept
by every append, reset and rollback; int8 decode scores against it (or,
on a mirror-less cache, quantizes on the fly on the plain path). A call
the kernel does not cover takes the plain step on CPU tensors and raises
on CUDA tensors unless the caller passes ``impl='plain'``.

The sliding ``window`` and the ALiBi slopes of the training kernels apply
to every decode path (the kernels add ``slope·(col − valid_to − j)``).
Packed segments (``segment_ids`` of the cached side, ``seg_q`` of the
query rows) are masked by the plain step only, as in the reference, so on
CUDA tensors they need ``impl='plain'``.

The sequence-sharded page table (:class:`ShardedPageTable`,
:func:`init_sharded_paged_cache`) splits one stream's page table over
``N`` shards, shard ``s`` owning a contiguous run of the logical page
ordinals: each shard holds a local :class:`PagedDecodeCache` whose table
keeps the full logical width with -1 at every ordinal another shard owns
(:func:`shard_view` gives it as views of the stacked cache). Positions
stay global, appends drop through the -1 on non-owners, and each shard's
masked softmax partials ``(num, m, l)`` (:func:`paged_partials_step`:
K5p with ``partials=True``, or the plain masked attention) merge by the
flash-decoding rule (:func:`_merge_partials`) into the single-pool
result: over a process group in :func:`decode_step` (``group=``), or
over shards held in one process in :func:`sharded_decode_step`.
:func:`paged_transfer_pages` copies whole pages from another paged cache
into this one: the prefill→decode handoff of disaggregated serving.
"""

import math
import zlib
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from distributed_dot_product_tpu_torch.ops.flash_attention import (
    _LOG2E, _NEG_BIG, quantize_rows,
)
from distributed_dot_product_tpu_torch.ops.flash_decode import (
    _SPLIT, flash_decode, gather_pages,
)
from distributed_dot_product_tpu_torch.utils.comm import (
    all_reduce, all_reduce_max, get_rank, get_world_size, resolve_device,
)

__all__ = ['DecodeCache', 'init_cache', 'append_kv', 'append_kv_sharded',
           'decode_attention', 'decode_step', 'decode_kernel_eligible',
           'init_slot_cache', 'append_kv_slots', 'reset_slot',
           'slots_all_finite', 'rollback_slots', 'PagedDecodeCache',
           'init_paged_cache', 'paged_gather', 'paged_gather_mirror',
           'paged_append_kv_slots', 'paged_append_rows', 'paged_reset_slot',
           'paged_rollback_slots', 'paged_copy_attach',
           'paged_transfer_pages', 'PagePool',
           'PageChecksums', 'ShardedPageTable', 'init_sharded_paged_cache',
           'shard_view', 'paged_partials_step', 'sharded_decode_step',
           'merge_partials']


class DecodeCache(NamedTuple):
    """Static-shape KV cache: ``k``/``v`` are ``(B, H_kv, t_max, d·)``
    buffers; ``length`` the number of filled positions — a host int, or
    a ``(B,)`` numpy int64 vector for a per-slot cache. ``k_q (…, d)
    int8`` / ``k_scale (…, 1) float32``: the int8 mirror of ``k`` with
    per-row scales, kept at append time for ``qk_quant='int8'`` models —
    rows are append-only and the quantization is per row, so quantizing
    once on append equals re-quantizing the buffer each step."""
    k: torch.Tensor
    v: torch.Tensor
    length: Union[int, np.ndarray]
    k_q: Optional[torch.Tensor] = None
    k_scale: Optional[torch.Tensor] = None

    @property
    def t_max(self):
        return self.k.shape[-2]


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


def _mirror_zeros(lead, head_dim, quant, dev):
    """Zero int8 mirror ``(k_q, k_scale)`` for rows ``lead`` (or
    ``(None, None)``)."""
    if not quant:
        return None, None
    return (torch.zeros((*lead, head_dim), dtype=torch.int8, device=dev),
            torch.zeros((*lead, 1), dtype=torch.float32, device=dev))


def init_cache(batch, kv_heads, t_max, head_dim, v_head_dim=None,
               dtype=torch.bfloat16, qk_quant=None, device='cuda'):
    """Zero cache for ``t_max`` positions on ``device``.
    ``qk_quant='int8'`` allocates the int8 K mirror for int8-trained
    models."""
    if qk_quant not in (None, 'int8'):
        raise ValueError(f"qk_quant must be None or 'int8', "
                         f'got {qk_quant!r}')
    dev = resolve_device(device)
    v_head_dim = v_head_dim or head_dim
    k_q, k_scale = _mirror_zeros((batch, kv_heads, t_max), head_dim,
                                 qk_quant == 'int8', dev)
    return DecodeCache(
        k=torch.zeros((batch, kv_heads, t_max, head_dim), dtype=dtype,
                      device=dev),
        v=torch.zeros((batch, kv_heads, t_max, v_head_dim), dtype=dtype,
                      device=dev),
        length=0, k_q=k_q, k_scale=k_scale)


def _quantize_k(k_new, dtype):
    """The mirror rows of ``k_new``: the CACHE-dtype value quantized per
    row (the mirror's contract is "identical to re-quantizing the
    buffer", which a higher-precision ``k_new`` would break)."""
    return quantize_rows(k_new.to(dtype))


def _check_room(cache, n):
    if n > cache.t_max:
        raise ValueError(f'appending {n} positions to a t_max='
                         f'{cache.t_max} cache')
    if cache.length + n > cache.t_max:
        raise ValueError(
            f'KV-cache overflow: length {cache.length} + {n} new positions '
            f'exceeds t_max {cache.t_max} — grow the cache or stop the '
            f'generation loop')


def _check_global_room(cache, n, world):
    """The sharded overflow contract: an append past the GLOBAL capacity
    ``world * t_local`` raises on every rank (the length is replicated),
    before any write."""
    if not isinstance(cache.length, (int, np.integer)):
        raise ValueError(
            'per-slot lengths (init_slot_cache) are a local serving '
            'construct; sequence-sharded decode uses the scalar global '
            'length')
    cap = world * cache.t_max
    if cache.length + n > cap:
        raise ValueError(
            f'KV-cache overflow: length {cache.length} + {n} new positions '
            f'exceeds the global capacity {cap} ({world} slabs of '
            f'{cache.t_max}) — grow the cache or stop the generation loop')


def append_kv_sharded(cache: DecodeCache, k_new, v_new, *, group=None):
    """Sequence-sharded :func:`append_kv`: ``cache`` holds this rank's
    ``(B, H_kv, t_max/W, d·)`` slab of a global cache sharded over the
    sequence group ``group`` (the default group when None), rank ``r``
    holding global columns ``r·t_local ..``; ``cache.length`` is the
    GLOBAL length. The ``n`` new rows land at global positions
    ``length ..``, each on the rank that owns it (a prefill chunk may
    straddle slabs), in place; every rank advances the length. An append
    past the global capacity raises on every rank and writes nothing."""
    n = k_new.shape[-2]
    tl = cache.t_max
    _check_global_room(cache, n, get_world_size(group))
    lo, p = get_rank(group) * tl, int(cache.length)
    a, e = max(p, lo), min(p + n, lo + tl)
    if a < e:
        cache.k[:, :, a - lo:e - lo] = k_new[:, :, a - p:e - p].to(
            cache.k.dtype)
        cache.v[:, :, a - lo:e - lo] = v_new[:, :, a - p:e - p].to(
            cache.v.dtype)
        if cache.k_q is not None:
            ki, sk = _quantize_k(k_new[:, :, a - p:e - p], cache.k.dtype)
            cache.k_q[:, :, a - lo:e - lo] = ki
            cache.k_scale[:, :, a - lo:e - lo] = sk
    return cache._replace(length=p + n)


def append_kv(cache: DecodeCache, k_new, v_new) -> DecodeCache:
    """Append ``k_new``/``v_new`` ``(B, H_kv, n, d·)`` at the cache head,
    writing the buffers in place; returns the cache with the length
    advanced. Appending past ``t_max`` raises and writes nothing."""
    n = k_new.shape[-2]
    _check_room(cache, n)
    end = cache.length + n
    cache.k[:, :, cache.length:end] = k_new.to(cache.k.dtype)
    cache.v[:, :, cache.length:end] = v_new.to(cache.v.dtype)
    if cache.k_q is not None:
        ki, sk = _quantize_k(k_new, cache.k.dtype)
        cache.k_q[:, :, cache.length:end] = ki
        cache.k_scale[:, :, cache.length:end] = sk
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
    _slab_mirror_rows(cache, k_new, cache.length, eff)
    return cache._replace(length=cache.length + eff)


def _slab_mirror_rows(cache, k_new, start, eff):
    """Keep a slab cache's int8 mirror: slot ``i``'s first ``eff[i]`` rows
    of ``k_new`` quantized in at ``start[i]`` (host vectors); a no-op
    without a mirror."""
    if cache.k_q is None:
        return
    for i in np.nonzero(eff)[0].tolist():
        lo, e = int(start[i]), int(eff[i])
        ki, sk = _quantize_k(k_new[i, :, :e], cache.k.dtype)
        cache.k_q[i, :, lo:lo + e] = ki
        cache.k_scale[i, :, lo:lo + e] = sk


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
    for buf in _buffers(cache):
        buf[slot].zero_()
    length = cache.length.copy()
    length[slot] = 0
    return cache._replace(length=length)


def slots_all_finite(x):
    """Per-slot all-finite predicate: ``(B, ...)`` → ``(B,) bool`` — the
    serving layer's quarantine test."""
    return torch.isfinite(x.reshape(x.shape[0], -1)).all(dim=-1)


def _buffers(cache):
    """The cache's row buffers (slab or pools): k, v and the int8 mirror
    when present."""
    return tuple(b for name, b in zip(cache._fields, cache)
                 if name not in ('length', 'page_table') and b is not None)


def rollback_slots(cache: DecodeCache, lengths, span=None):
    """Acceptance-prefix rollback (speculative decoding): truncate each
    slot's length to ``min(current, lengths)`` AND zero every row at or
    past it, in place, so the cache is bit-identical to having appended
    only the accepted tokens (a slot whose target is at or past its fill
    is untouched: one call can roll back a few slots with a don't-touch
    sentinel for the rest). ``lengths`` broadcasts against
    ``cache.length``. ``span`` (per-slot caches only): the most rows any
    slot rolls back — the zeroing then touches only the ``span`` rows at
    each slot's new length (rows past the old fill are zero already);
    without it every row past the new length is zeroed. Paged caches
    take :func:`paged_rollback_slots`."""
    if isinstance(cache, PagedDecodeCache):
        raise ValueError(
            'rollback_slots on a paged cache needs the bounded span '
            'and the host page release — use paged_rollback_slots '
            "with PagePool.truncate()'s bookkeeping")
    per_slot = isinstance(cache.length, np.ndarray)
    if span is not None and not per_slot:
        raise ValueError('span needs a per-slot cache (init_slot_cache); '
                         'scalar-clock caches take the full-mask path '
                         '(span=None)')
    cur = np.asarray(cache.length, np.int64)
    new = np.minimum(cur, np.asarray(lengths, np.int64))
    t_max = cache.t_max
    if not per_slot:
        new = int(new)
        for buf in _buffers(cache):
            buf[:, :, new:].zero_()
        return cache._replace(length=new)
    for i in np.nonzero(new < cur)[0].tolist():
        lo = int(new[i])
        hi = t_max if span is None else min(t_max, lo + int(span))
        for buf in _buffers(cache):
            buf[i, :, lo:hi].zero_()
    return cache._replace(length=new)


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
    ids) match the reference's. ``k_q_pool (pages + 1, H_kv, page_size,
    d) int8`` / ``k_scale_pool (…, 1) float32``: the int8 K mirror pools
    of a ``qk_quant='int8'`` cache, paged through the same table."""
    k_pool: torch.Tensor
    v_pool: torch.Tensor
    page_table: torch.Tensor
    length: np.ndarray
    k_q_pool: Optional[torch.Tensor] = None
    k_scale_pool: Optional[torch.Tensor] = None

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
    page size divides the per-slot capacity ``t_max``, on ``device``.
    ``qk_quant='int8'`` allocates the int8 K-mirror pools."""
    v_head_dim = v_head_dim or head_dim
    if page_size < 1 or t_max % page_size:
        raise ValueError(f'page_size {page_size} must divide t_max '
                         f'{t_max}')
    if pages < 1:
        raise ValueError(f'need pages >= 1, got {pages}')
    if qk_quant not in (None, 'int8'):
        raise ValueError(f"qk_quant must be None or 'int8', "
                         f'got {qk_quant!r}')
    dev = resolve_device(device)
    k_q, k_scale = _mirror_zeros((pages + 1, kv_heads, page_size), head_dim,
                                 qk_quant == 'int8', dev)
    return PagedDecodeCache(
        k_pool=torch.zeros((pages + 1, kv_heads, page_size, head_dim),
                           dtype=dtype, device=dev),
        v_pool=torch.zeros((pages + 1, kv_heads, page_size, v_head_dim),
                           dtype=dtype, device=dev),
        page_table=torch.full((slots, t_max // page_size), -1,
                              dtype=torch.int32, device=dev),
        length=np.zeros(slots, np.int64), k_q_pool=k_q, k_scale_pool=k_scale)


def paged_gather(cache: PagedDecodeCache):
    """The slab view ``(k, v)``, each ``(slots, H_kv, t_max, d·)``, of a
    paged cache; unallocated entries read zeros (the reference reads its
    never-written sink row)."""
    return (gather_pages(cache.k_pool, cache.page_table),
            gather_pages(cache.v_pool, cache.page_table))


def paged_gather_mirror(cache: PagedDecodeCache):
    """Slab view of the int8 K mirror — ``(k_q (B, H_kv, t_max, d),
    k_scale (B, H_kv, t_max, 1))`` gathered through the page table like
    :func:`paged_gather` (unallocated entries read zeros)."""
    if cache.k_q_pool is None:
        raise ValueError('this paged cache carries no int8 K mirror — '
                         "allocate it with init_paged_cache("
                         "qk_quant='int8')")
    return (gather_pages(cache.k_q_pool, cache.page_table),
            gather_pages(cache.k_scale_pool, cache.page_table))


def _write_mirror(cache, pg, rw, vals_k):
    """Quantize rows ``vals_k (M, H_kv, d)`` and write them at pool
    ``(pg, rw)`` (device index vectors) of the mirror pools — the one
    mirror-maintenance body of every paged writer."""
    ki, sk = _quantize_k(vals_k, cache.k_pool.dtype)
    cache.k_q_pool[pg, :, rw] = ki
    cache.k_scale_pool[pg, :, rw] = sk


def _scatter_rows(cache, pool_rows, vals_k, vals_v):
    """Write rows ``vals_* (M, H_kv, d·)`` at ``pool_rows = (pages,
    rows)`` (host index vectors) of both pools (and the mirror's), in
    place."""
    if not len(pool_rows[0]):
        return
    dev = cache.k_pool.device
    pg, rw = (_to_device(x, dev) for x in pool_rows)
    cache.k_pool[pg, :, rw] = vals_k.to(cache.k_pool.dtype)
    cache.v_pool[pg, :, rw] = vals_v.to(cache.v_pool.dtype)
    if cache.k_q_pool is not None:
        _write_mirror(cache, pg, rw, vals_k)


def _paged_mirror_fixup(cache: PagedDecodeCache, k_new, ap, nvec):
    """Quantize a step's appended rows into the mirror pools — the kernel
    path's fix-up when a non-int8 step on a mirror-carrying pool left the
    mirror to the host (the rows and targets of
    :func:`paged_append_kv_slots`). ``ap (B,)`` host vector: each slot's
    first append column (-1 none); ``nvec (B,)`` the rows it appended."""
    slot, j = _slot_rows(nvec)
    table = cache.page_table.cpu().numpy()
    pg, rw, ok = _page_targets(table[slot], ap[slot] + j, cache.page_size)
    if not len(pg):
        return
    dev = cache.k_pool.device
    si, ji = _to_device(slot[ok], k_new.device), _to_device(j[ok],
                                                             k_new.device)
    _write_mirror(cache, _to_device(pg, dev), _to_device(rw, dev),
                  k_new[si, :, ji])


def _slot_rows(counts):
    """``(slot, j)`` host vectors walking row ``j < counts[slot]`` of
    every slot, in slot order."""
    slot = np.repeat(np.arange(len(counts)), counts)
    j = np.concatenate([np.arange(e) for e in counts.tolist()] or
                       [np.zeros(0, np.int64)]).astype(np.int64)
    return slot, j


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
    slot, j = _slot_rows(eff)
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
        for pool in _buffers(cache):
            pool[idx] = 0
    length = cache.length
    if 0 <= slot < cache.slots:
        cache.page_table[slot] = -1
        length = length.copy()
        length[slot] = 0
    return cache._replace(length=length)


def paged_rollback_slots(cache: PagedDecodeCache, lengths, span):
    """Acceptance-prefix rollback over the paged pool: truncate each
    slot's length to ``min(current, lengths)`` (a don't-touch slot passes
    a sentinel past its fill) and zero, in place, the rejected rows at
    logical positions ``new .. new + span - 1`` of each rolled-back slot
    through its page table (unallocated or out-of-range rows write
    nowhere; rows past the old fill are zero already, and the pages
    touched were written this step, hence private). The host releases
    now-empty tail pages separately (:meth:`PagePool.truncate`); the
    caller zeroes the freed pages as on eviction."""
    cur = cache.length
    new = np.minimum(cur, np.asarray(lengths, np.int64))
    slot, j = _slot_rows(np.where(new < cur, int(span), 0))
    if len(slot):
        table = cache.page_table.cpu().numpy()
        pg, rw, _ = _page_targets(table[slot], new[slot] + j,
                                  cache.page_size)
        if len(pg):
            dev = cache.k_pool.device
            pg, rw = _to_device(pg, dev), _to_device(rw, dev)
            for pool in _buffers(cache):
                pool[pg, :, rw] = 0
    return cache._replace(length=new)


def paged_copy_attach(cache: PagedDecodeCache, src_page, dst_page, slot,
                      length_val):
    """The copy-on-write / attach primitive: copy pool page ``src_page``
    → ``dst_page`` (-1 = no copy) and set ``length[slot] = length_val``
    (``slot = -1`` = no length change). The page table is host-owned; the
    caller re-mirrors it."""
    src, dst = int(src_page), int(dst_page)
    if 0 <= dst <= cache.pages:
        for pool in _buffers(cache):
            pool[dst] = pool[max(src, 0)]
    length = cache.length
    if 0 <= slot < cache.slots:
        length = length.copy()
        length[slot] = int(length_val)
    return cache._replace(length=length)


def paged_transfer_pages(cache: PagedDecodeCache, src_k_pool, src_v_pool,
                         src_pages, dst_pages):
    """Cross-CACHE page transfer — the prefill→decode KV handoff unit of
    disaggregated serving (``serve/replica.py``): copy the pool pages
    named by ``src_pages`` out of ANOTHER paged cache's ``src_k_pool`` /
    ``src_v_pool`` into THIS cache's ``dst_pages``, in place. Both vectors
    are ``-1``-padded to a fixed width; a padded entry copies nothing (the
    valid pairs are selected by a mask and only those are copied), and no
    entry ever writes the sink page (the last pool row, which K5p keeps
    for itself). The page geometry (page size, KV heads, head dims) must
    match; the page COUNT of the two pools may differ. Sources on another
    device are moved to this cache's. Where this cache carries the int8 K
    mirror, the copied pages' mirror rows are rebuilt from the adopted K
    (:func:`~distributed_dot_product_tpu_torch.ops.flash_attention
    .quantize_rows`, the append-time rule), whether or not the source
    carries one. Page tables and host refcounts are untouched: the caller
    (``KernelEngine.adopt_prefix``) owns the allocator bookkeeping on both
    sides. Returns the cache."""
    if (tuple(src_k_pool.shape[1:]) != tuple(cache.k_pool.shape[1:])
            or tuple(src_v_pool.shape[1:]) != tuple(cache.v_pool.shape[1:])):
        raise ValueError(f'page geometry mismatch: source pages '
                         f'{tuple(src_k_pool.shape[1:])} / '
                         f'{tuple(src_v_pool.shape[1:])} vs '
                         f'{tuple(cache.k_pool.shape[1:])} / '
                         f'{tuple(cache.v_pool.shape[1:])}')
    src = _host(src_pages, np.int64)
    dst = _host(dst_pages, np.int64)
    if len(src) != len(dst):
        raise ValueError(f'{len(src)} source pages for {len(dst)} '
                         f'destination pages')
    ok = ((src >= 0) & (src < src_k_pool.shape[0])
          & (dst >= 0) & (dst < cache.pages))
    if not ok.any():
        return cache
    dev = cache.k_pool.device
    si = torch.from_numpy(src[ok]).to(src_k_pool.device)
    di = _to_device(dst[ok], dev)
    k_rows = src_k_pool.index_select(0, si).to(dev, cache.k_pool.dtype)
    cache.k_pool[di] = k_rows
    cache.v_pool[di] = src_v_pool.index_select(0, si.to(
        src_v_pool.device)).to(dev, cache.v_pool.dtype)
    if cache.k_q_pool is not None:
        ki, sk = quantize_rows(k_rows)
        cache.k_q_pool[di] = ki
        cache.k_scale_pool[di] = sk
    return cache


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


class ShardedPageTable:
    """Host-side allocator of a SEQUENCE-SHARDED paged cache: one
    stream's page table split over ``n_shards`` pools, so its KV capacity
    sums over the shards instead of capping at one device's memory. Shard
    ``s`` owns the contiguous logical page ordinals ``[s·ops,
    min((s+1)·ops, pages_per_slot))`` with ``ops = ceil(pages_per_slot /
    n_shards)``; the last shard takes the remainder.

    ``n_shards`` ordinary :class:`PagePool` instances (each
    ``pages_per_shard`` pages) share ONE ``lengths`` vector (the fill is
    a global property every shard advances alike). Each sub-pool's
    ``table`` keeps the full logical width with -1 at every ordinal
    another shard owns: the local view the sharded decode step reads
    (positions stay global, non-owned appends drop through the -1,
    non-owned columns are masked and the flash merge reassembles the
    single-pool attention). A sub-pool's ``counts[slot]`` is the
    high-watermark ordinal + 1 seen by that shard.

    Operations that touch several sub-pools (:meth:`reserve_rows` with
    its cross-shard rollback, :meth:`release`, :meth:`truncate`,
    :meth:`attach`) live here; single-ordinal ones route to the owning
    sub-pool. Returned page ids are LOCAL to their shard: every (shard,
    page) pair is explicit in the signatures. The stacked-pool id of a
    local page is :meth:`gpage`."""

    def __init__(self, n_shards, pages_per_shard, page_size, slots,
                 pages_per_slot):
        if n_shards < 2:
            raise ValueError(f'need n_shards >= 2 (a single shard is a '
                             f'plain PagePool), got {n_shards}')
        self.n_shards = n_shards
        self.pages_per_shard = pages_per_shard
        self.page_size = page_size
        self.slots = slots
        self.pages_per_slot = pages_per_slot
        self.ordinals_per_shard = -(-pages_per_slot // n_shards)
        self.shards = [PagePool(pages_per_shard, page_size, slots,
                                pages_per_slot)
                       for _ in range(n_shards)]
        # One fill vector: every sub-pool's lengths is the same array, so
        # an in-place update through any alias advances all shards.
        self.lengths = self.shards[0].lengths
        for p in self.shards[1:]:
            p.lengths = self.lengths

    # -- geometry -------------------------------------------------------
    def owner(self, ordinal):
        """Shard owning logical page ``ordinal``."""
        return min(ordinal // self.ordinals_per_shard, self.n_shards - 1)

    def owned_range(self, shard):
        """``(lo, hi)``: the contiguous ordinal run ``shard`` owns."""
        lo = min(self.pages_per_slot, shard * self.ordinals_per_shard)
        hi = (self.pages_per_slot if shard == self.n_shards - 1
              else min(self.pages_per_slot,
                       (shard + 1) * self.ordinals_per_shard))
        return lo, hi

    def owner_vector(self):
        """``(pages_per_slot,) int32``: ordinal → owning shard."""
        return np.asarray([self.owner(o)
                           for o in range(self.pages_per_slot)], np.int32)

    # The stacked pool's rows: each shard contributes pages_per_shard
    # allocatable rows plus its own sink row. These three helpers are the
    # only place that stride appears.
    def gpage(self, shard, page):
        """Shard-local page id → GLOBAL stacked-pool row id."""
        return shard * (self.pages_per_shard + 1) + page

    def gsplit(self, gpage):
        """GLOBAL stacked-pool row id → ``(shard, local page)``."""
        stride = self.pages_per_shard + 1
        return int(gpage) // stride, int(gpage) % stride

    def page_shard(self, gpage):
        """Shard owning GLOBAL stacked-pool row id ``gpage``."""
        return int(gpage) // (self.pages_per_shard + 1)

    # -- aggregate introspection ---------------------------------------
    @property
    def pages(self):
        """Allocatable pages summed over the shards."""
        return self.n_shards * self.pages_per_shard

    @property
    def free_pages(self):
        return sum(p.free_pages for p in self.shards)

    @property
    def free_pages_by_shard(self):
        return [p.free_pages for p in self.shards]

    @property
    def used_pages(self):
        return sum(p.used_pages for p in self.shards)

    @property
    def shared_pages(self):
        return sum(p.shared_pages for p in self.shards)

    @property
    def quarantined(self):
        """Withdrawn pages as ``(shard, local_page)`` pairs."""
        return {(s, page) for s, p in enumerate(self.shards)
                for page in p.quarantined}

    @property
    def dirty(self):
        return any(p.dirty for p in self.shards)

    @dirty.setter
    def dirty(self, value):
        for p in self.shards:
            p.dirty = bool(value)

    def pages_for_rows(self, rows):
        return -(-rows // self.page_size)

    def slot_pages(self, slot):
        """Pages mapped for ``slot`` over all shards."""
        return sum(int(np.sum(p.table[slot] >= 0)) for p in self.shards)

    def covered_rows(self, slot):
        """Longest ``[0, r)`` row prefix of ``slot`` whose pages are all
        mapped (chunked prefill's no-fail-mid-prompt check)."""
        o = 0
        while (o < self.pages_per_slot
               and int(self.shards[self.owner(o)].table[slot, o]) >= 0):
            o += 1
        return o * self.page_size

    def local_tables(self):
        """``(n_shards, slots, pages_per_slot) int32``: the local views
        stacked, the device tables' host mirror."""
        return np.stack([p.table for p in self.shards]).astype(np.int32)

    # -- allocation -----------------------------------------------------
    def prepare_append(self, slot):
        """:meth:`PagePool.prepare_append` routed to the shard owning the
        slot's next append ordinal. Returns ``(status, shard, src,
        dst)``; ``shard`` names the pool the status is about (-1 for
        'full'), so an exhaustion report can say which shard's range is
        out of pages while the others have headroom."""
        pi = int(self.lengths[slot]) // self.page_size
        if pi >= self.pages_per_slot:
            return ('full', -1, -1, -1)
        s = self.owner(pi)
        st, src, dst = self.shards[s].prepare_append(slot)
        return (st, s, src, dst)

    def reserve_rows(self, slot, rows):
        """Cross-shard :meth:`PagePool.reserve_rows`: reserve every page
        covering rows ``[length, length + rows)`` wherever they are
        owned. Returns ``(ok, copies)``, ``copies`` a list of ``(shard,
        src, dst)`` device copies owed. On ANY shard's exhaustion nothing
        is changed anywhere (the rollback spans shards)."""
        start = int(self.lengths[slot])
        end = start + rows
        if end > self.pages_per_slot * self.page_size:
            return False, []
        counts0 = [int(p.counts[slot]) for p in self.shards]
        undo = []                     # (shard, pi, prev, was_cow)
        copies = []
        for pi in range(start // self.page_size, -(-end // self.page_size)):
            s = self.owner(pi)
            pool = self.shards[s]
            if pi >= int(pool.counts[slot]) or int(pool.table[slot, pi]) < 0:
                page = pool.alloc()
                if page is None:
                    self._undo_reserve(slot, undo, counts0)
                    return False, []
                undo.append((s, pi, -1, False))
                pool.table[slot, pi] = page
                pool.counts[slot] = max(int(pool.counts[slot]), pi + 1)
                pool.dirty = True
            else:
                page = int(pool.table[slot, pi])
                if pool.refcount[page] > 1:
                    dup = pool.alloc()
                    if dup is None:
                        self._undo_reserve(slot, undo, counts0)
                        return False, []
                    undo.append((s, pi, page, True))
                    pool.refcount[page] -= 1
                    pool.table[slot, pi] = dup
                    copies.append((s, page, dup))
                    pool.dirty = True
        return True, copies

    def _undo_reserve(self, slot, undo, counts0):
        for s, pi, prev, was_cow in reversed(undo):
            pool = self.shards[s]
            page = int(pool.table[slot, pi])
            pool.refcount[page] = 0
            pool._free.append(page)
            pool.table[slot, pi] = prev
            if was_cow:
                pool.refcount[prev] += 1
        for s, c in enumerate(counts0):
            self.shards[s].counts[slot] = c

    def release(self, slot):
        """Evict ``slot`` everywhere. Returns ``{shard: [pages]}`` of the
        LOCAL pages that hit refcount 0 (the caller zeroes each shard's
        list in that shard's pool)."""
        freed = {}
        for s, pool in enumerate(self.shards):
            for pi in range(int(pool.counts[slot])):
                page = int(pool.table[slot, pi])
                if page >= 0 and pool._unref(page):
                    freed.setdefault(s, []).append(page)
            pool.table[slot, :] = -1
            pool.counts[slot] = 0
            pool.dirty = True
        self.lengths[slot] = 0
        return freed

    def truncate(self, slot, new_length):
        """Cross-shard :meth:`PagePool.truncate` (a per-shard delegation
        would stop at the first sub-pool: the shared lengths make every
        later one look already truncated). Returns ``{shard: [freed
        local pages]}``."""
        if new_length >= int(self.lengths[slot]):
            return {}
        keep = self.pages_for_rows(int(new_length))
        freed = {}
        for s, pool in enumerate(self.shards):
            for pi in range(keep, int(pool.counts[slot])):
                page = int(pool.table[slot, pi])
                if page >= 0:
                    if pool._unref(page):
                        freed.setdefault(s, []).append(page)
                    pool.table[slot, pi] = -1
                    pool.dirty = True
            pool.counts[slot] = min(int(pool.counts[slot]), keep)
        self.lengths[slot] = new_length
        return freed

    # -- sharing --------------------------------------------------------
    def attach(self, slot, ordinal_pages, length):
        """Point an EMPTY slot at pages laid out by ordinal:
        ``ordinal_pages (pages_per_slot,)`` holds, at each ordinal the
        prefix covers, the LOCAL page id in the owning shard's pool.
        Full pages are shared read-only (refcount++ on their shard); a
        partial tail page gets a private copy on the tail ordinal's
        owner. Returns ``(ok, tail_shard, tail_src, tail_dst)``, -1s
        when the prefix ends on a page boundary; on tail-page exhaustion
        nothing is changed."""
        if self.lengths[slot] or any(int(p.counts[slot])
                                     for p in self.shards):
            raise RuntimeError(f'attach needs an empty slot, slot '
                               f'{slot} is in use')
        full = length // self.page_size
        rem = length % self.page_size
        tail_shard = tail_src = tail_dst = -1
        if rem:
            tail_shard = self.owner(full)
            tail_dst = self.shards[tail_shard].alloc()
            if tail_dst is None:
                return False, -1, -1, -1
            tail_src = int(ordinal_pages[full])
        for o in range(full):
            pool = self.shards[self.owner(o)]
            pg = int(ordinal_pages[o])
            pool.table[slot, o] = pg
            pool.refcount[pg] += 1
            pool.counts[slot] = o + 1
            pool.dirty = True
        if rem:
            pool = self.shards[tail_shard]
            pool.table[slot, full] = tail_dst
            pool.counts[slot] = full + 1
            pool.dirty = True
        self.lengths[slot] = length
        return True, tail_shard, tail_src, tail_dst

    def release_pages_on(self, shard, pages):
        """Per-shard :meth:`PagePool.release_pages`; returns the LOCAL
        pages owed a zero in that shard's pool."""
        return self.shards[shard].release_pages(pages)

    def quarantine(self, shard, pages):
        """Withdraw LOCAL ``pages`` of ``shard`` from circulation; returns
        the pages newly quarantined on that shard."""
        return self.shards[shard].quarantine(pages)


def init_sharded_paged_cache(n_shards, slots, kv_heads, t_max, head_dim, *,
                             pages_per_shard, page_size, v_head_dim=None,
                             dtype=torch.bfloat16, device='cuda'):
    """Zero STACKED sharded paged cache, the device twin of
    :class:`ShardedPageTable`, on ``device``: the pools stack the
    per-shard ``(pages_per_shard + 1, H_kv, page_size, d·)`` local pools
    (each ending in its own sink row) on axis 0, the table stacks the
    local views as ``(n_shards, slots, pages_per_slot)`` (all -1), and
    the ``(slots,)`` fill is one host vector. :func:`shard_view` gives
    shard ``s``'s local :class:`PagedDecodeCache`; its local page ``p``
    is stacked row :meth:`ShardedPageTable.gpage` ``(s, p)``."""
    v_head_dim = v_head_dim or head_dim
    if page_size < 1 or t_max % page_size:
        raise ValueError(f'page_size {page_size} must divide t_max '
                         f'{t_max}')
    if n_shards < 2 or pages_per_shard < 1:
        raise ValueError(f'need n_shards >= 2 and pages_per_shard >= 1, '
                         f'got {n_shards}/{pages_per_shard}')
    dev = resolve_device(device)
    rows = n_shards * (pages_per_shard + 1)
    return PagedDecodeCache(
        k_pool=torch.zeros((rows, kv_heads, page_size, head_dim),
                           dtype=dtype, device=dev),
        v_pool=torch.zeros((rows, kv_heads, page_size, v_head_dim),
                           dtype=dtype, device=dev),
        page_table=torch.full((n_shards, slots, t_max // page_size), -1,
                              dtype=torch.int32, device=dev),
        length=np.zeros(slots, np.int64))


def shard_view(cache: PagedDecodeCache, shard):
    """Shard ``shard``'s local :class:`PagedDecodeCache` of a stacked
    cache (:func:`init_sharded_paged_cache`) as VIEWS, no copy: its block
    of the pools, its ``(slots, pages_per_slot)`` table and the shared
    length vector. Writes through it land in the stacked cache."""
    n = cache.page_table.shape[0]
    return PagedDecodeCache(
        k_pool=cache.k_pool.chunk(n)[shard],
        v_pool=cache.v_pool.chunk(n)[shard],
        page_table=cache.page_table[shard], length=cache.length)


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
    ``mirror_crc`` covers the int8 K-mirror rows and scales (0 for a
    mirror-less cache)."""

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
        crc = zlib.crc32(_page_bytes(cache.v_pool[page]), crc)
        mirror = 0
        if cache.k_q_pool is not None:
            mirror = zlib.crc32(_page_bytes(cache.k_q_pool[page]))
            mirror = zlib.crc32(_page_bytes(cache.k_scale_pool[page]),
                                mirror)
        return crc, mirror

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
                     qk_quant=None, group=None, col_valid=None,
                     col_offset=None, partials=False):
    """Masked-softmax attention of ``q (B, H, n, d)`` — the LAST ``n``
    appended positions — against the cache prefix; returns
    ``(B, H, n, d_v)`` in the cache dtype. A per-slot cache masks each
    row against its own length. Float32 scores and weights; a row with no
    attendable column returns 0. ``window``: the training kernels'
    sliding-window lookback over absolute positions. ``alibi_slopes
    (H,)``: the training kernels' ALiBi bias ``slope·(pos_k − pos_q)``
    (natural-log units here, added to the scaled scores).
    ``segment_ids (B, t_max)``: the cached side's packed-segment ids,
    with ``seg_q (B, n)`` the query rows'; pairs in different segments do
    not attend (on a sharded slab, ``segment_ids`` is the slab's own
    shard). ``qk_quant='int8'``
    reproduces the training kernels' quantized scoring: both sides
    quantized per row, the int8 products summed exactly, the scores
    ``s · (sq · scale) · sk``; the cached side is the cache's mirror when
    it carries one, else ``k`` quantized on the fly.

    ``group``: sequence-sharded decode (the reference's ``axis_name``):
    the cache is this rank's slab of a global cache sharded on its
    ``t_max`` axis over the ranks of ``group`` (see
    :func:`append_kv_sharded`), ``q`` is the same on every rank and
    ``cache.length`` is global; each rank scores ``q`` against its slab
    and the softmax merges across the ranks by the flash-decoding rule
    (row max over ranks, then the sums of the rescaled numerator and
    denominator), so the result equals the unsharded one on every rank.
    ``None``: the local step. ``col_offset``: the global position of the
    buffer's column 0 (default: ``rank · t_max`` when sharded, else 0);
    ``col_valid (B, t_max) bool``: columns the buffer holds (the rest are
    masked whatever their position). ``partials=True`` returns this
    buffer's flash-decoding partials ``(num (B, H, n, d_v), m, l (B, H,
    n, 1))`` in float32 instead, in the decode kernels' convention (the
    running max in base 2, ``_NEG_BIG`` and 0 for an empty row), which
    :func:`_merge_partials` combines (with ``group`` they are this
    rank's, merged over the group)."""
    if qk_quant not in (None, 'int8'):
        raise ValueError(f"qk_quant must be None or 'int8', "
                         f'got {qk_quant!r}')
    b, h, n, d = q.shape
    h_kv = cache.k.shape[1]
    if h % h_kv:
        raise ValueError(f'query heads {h} must be a multiple of cache '
                         f'kv heads {h_kv}')
    group_size = h // h_kv
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    t_max = cache.t_max
    dev = q.device
    per_slot = isinstance(cache.length, np.ndarray)
    if per_slot and group is not None and col_offset is None:
        raise ValueError(
            'per-slot lengths (init_slot_cache) are a local serving '
            'construct; sequence-sharded decode uses the scalar global '
            'length')
    if col_offset is None:
        col_offset = 0 if group is None else get_rank(group) * t_max
    qg = q.reshape(b, h_kv, group_size * n, d)
    if qk_quant == 'int8':
        qi, sq = quantize_rows(qg)
        ki, sk = ((cache.k_q, cache.k_scale) if cache.k_q is not None
                  else quantize_rows(cache.k))
        # Integer products summed in float32: every partial sum is an
        # integer below 2^24, so the sum is exact in any order.
        s = torch.matmul(qi.float(), ki.float().transpose(-1, -2))
        s = s * (sq * scale) * sk.transpose(-1, -2)
    else:
        s = torch.matmul(qg.float(), cache.k.float().transpose(-1, -2)) \
            * scale
    s = s.reshape(b, h_kv, group_size, n, t_max)
    # Query row i sits at global position length - n + i and attends
    # positions at or before its own (within the window); a per-slot
    # cache gives each row its length.
    length = torch.as_tensor(cache.length, device=dev).reshape(-1, 1)
    pos_q = length - n + torch.arange(n, device=dev)     # (B | 1, n)
    pos_k = col_offset + torch.arange(t_max, device=dev)
    rel = pos_k - pos_q[..., None]                       # (B | 1, n, t_max)
    allowed = rel <= 0
    if window is not None:
        allowed = allowed & (-rel < window)
    if col_valid is not None:
        allowed = allowed & torch.as_tensor(
            col_valid, device=dev).bool()[:, None, :]
    if segment_ids is not None:
        if seg_q is None:
            raise ValueError("segment_ids needs seg_q (the query rows' "
                             'ids)')
        seg_k = torch.as_tensor(segment_ids, device=dev)
        seg_q = torch.as_tensor(seg_q, device=dev)
        allowed = allowed & (seg_k[:, None, :] == seg_q[..., None])
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes, dtype=torch.float32,
                                 device=dev).reshape(h_kv, group_size, 1, 1)
        s = s + slopes * rel[:, None, None].float()
    s = s.masked_fill(~allowed[:, None, None], float('-inf'))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m.clamp_min(-1e30))                     # empty rows
    denom = p.sum(dim=-1, keepdim=True)
    dv = cache.v.shape[-1]
    if group is None and not partials:
        p = p / torch.where(denom == 0.0, 1.0, denom)
        out = torch.matmul(p, cache.v.float()[:, :, None])
        return out.to(cache.v.dtype).reshape(b, h, n, dv)
    num = torch.matmul(p, cache.v.float()[:, :, None])
    parts = (num.reshape(b, h, n, dv),
             (m * _LOG2E).clamp_min(_NEG_BIG).reshape(b, h, n, 1),
             denom.reshape(b, h, n, 1))
    if partials:
        return parts
    return _flash_merge(parts, group, cache.v.dtype)


def _merge_partials(partials, row_max, total, out_dtype):
    """The flash-decoding merge, the one formula every sharded decode
    path uses: shift each shard's ``(num, m, l)`` partials (base-2
    running max and denominator) by the row max over the shards
    (``row_max``), sum the numerators and denominators (``total``, one
    reduction for both) and divide. A shard that attends no column of a
    row contributes ``exp2(_NEG_BIG − m) = 0``; a row no shard attends
    gives 0. ``row_max`` and ``total`` are collectives over a process
    group (:func:`_flash_merge`) or reductions over a stacked shard axis
    (:func:`merge_partials`)."""
    num, m, l = partials
    corr = torch.exp2(m - row_max(m))
    both = total(torch.cat([num * corr, l * corr], dim=-1))
    num, den = both[..., :-1], both[..., -1:]
    return (num / torch.where(den == 0.0, 1.0, den)).to(out_dtype)


def _flash_merge(partials, group, out_dtype):
    """:func:`_merge_partials` over the ranks of ``group``: a max
    all-reduce, then one sum all-reduce of numerators and
    denominators."""
    return _merge_partials(partials, lambda m: all_reduce_max(m, group),
                           lambda x: all_reduce(x, group), out_dtype)


def merge_partials(partials, out_dtype):
    """:func:`_merge_partials` over shards held in one process:
    ``partials`` is one ``(num, m, l)`` per shard, all on one device,
    stacked on a new leading axis and reduced over it."""
    stacked = tuple(torch.stack(x) for x in zip(*partials))
    return _merge_partials(stacked, lambda m: m.amax(dim=0),
                           lambda x: x.sum(dim=0), out_dtype)


def decode_kernel_eligible(cache, n=1, segment_ids=None, qk_quant=None,
                           explain=False, n_shards=1, shard=None):
    """Can :func:`decode_step` take the fused kernel (K5 / K5p) for this
    call? The kernel covers ``1 <= n <= the K split`` new rows per slot
    (n > 1 is the fused verify step; the slab's split is the port's
    ``min(128, t_max)`` columns, the paged one the page size), GQA, the
    window, and the int8 mirror at n = 1 on both layouts; packed
    segments, quantized verify-k and mirror-less int8 are left to the
    plain path (``impl='plain'`` on the card), as is sharded verify-k
    (``n_shards > 1``: the merge carries one query row per shard).
    ``explain=True`` returns ``(eligible, reason)``.

    ``n_shards > 1`` describes a sequence-sharded step (``cache`` is then
    ONE shard's local view: a slab of the sharded slab, or a shard of the
    sharded page table) and ``shard`` optionally names the shard probed.
    With ``explain=True`` every verdict then carries the geometry (the
    shard count and the shard's page-ordinal or column range): an
    eligible sharded probe returns ``(True, '<geometry>')``, an
    ineligible one ``(False, '<geometry> — <reason>')``."""
    geom = None
    if n_shards > 1:
        if isinstance(cache, PagedDecodeCache):
            pps = cache.pages_per_slot
            local = -(-pps // n_shards)
            if shard is None:
                own = (f'each of the {n_shards} shards owns a contiguous '
                       f'run of {local} of the {pps} logical page '
                       f'ordinals')
            else:
                lo = shard * local
                hi = min(pps, lo + local)
                own = (f'shard {shard}/{n_shards} owns logical page '
                       f'ordinals [{lo}, {hi}) of {pps}')
            geom = f'sequence-sharded page table: {own}'
        else:
            t_loc = cache.t_max
            if shard is None:
                own = (f'each of the {n_shards} shards owns a '
                       f'{t_loc}-column slab')
            else:
                own = (f'shard {shard}/{n_shards} owns columns '
                       f'[{shard * t_loc}, {(shard + 1) * t_loc})')
            geom = f'sequence-sharded slab: {own}'

    def verdict(reason):
        ok = reason is None
        if geom is not None:
            reason = geom if ok else f'{geom} — {reason}'
        return (ok, reason) if explain else ok

    if n_shards > 1 and n != 1:
        return verdict(f'the sharded kernel step is single-token (its '
                       f'flash-decoding merge carries one query row per '
                       f'shard), got n={n} — the plain path covers '
                       f'sharded verify-k')
    if n < 1:
        return verdict(f'needs at least one query row (n={n})')
    if segment_ids is not None:
        return verdict('packed segment_ids are masked by the plain path '
                       'only')
    if qk_quant == 'int8' and n != 1:
        return verdict(f'quantized verify-k (n={n} > 1) is plain-only — '
                       'the kernel appends the int8 mirror single-token')
    if isinstance(cache, PagedDecodeCache):
        if qk_quant == 'int8' and cache.k_q_pool is None:
            return verdict(
                'this paged cache carries no int8 K mirror — allocate the '
                "mirror pools with init_paged_cache(qk_quant='int8') so "
                'quantized decode can ride the kernel on the page pool')
        if n > cache.page_size:
            return verdict(f'verify-k width {n} exceeds the page size '
                           f'{cache.page_size} — k rows must span at most '
                           f'two pages')
        return verdict(None)
    if qk_quant == 'int8' and cache.k_q is None:
        return verdict('this slab cache carries no int8 K mirror — '
                       "allocate it with init_cache(qk_quant='int8')")
    bk = min(_SPLIT, cache.t_max)
    if n > bk:
        return verdict(f'verify-k width {n} exceeds the K split {bk} — k '
                       f'rows must span at most two blocks')
    return verdict(None)


def _resolve_decode_impl(impl, cache, n, segment_ids, qk_quant, n_shards,
                         device):
    """``'kernel'`` or ``'plain'``: None/``'auto'`` take the kernel where
    :func:`decode_kernel_eligible` allows it (on the card the CUDA
    kernels, on the CPU their plain versions). Where it does not, CPU
    tensors take the plain step (the reference's fallback) and CUDA
    tensors raise the reason: nothing on the card gives way to the plain
    version unless the caller asks for it with ``'plain'``. An explicit
    ``'kernel'`` the kernel does not cover raises on both."""
    if impl not in (None, 'auto', 'kernel', 'plain'):
        raise ValueError(f"decode impl must be None/'auto'/'kernel'/"
                         f"'plain', got {impl!r}")
    if impl == 'plain':
        return impl
    ok, reason = decode_kernel_eligible(cache, n, segment_ids, qk_quant,
                                        explain=True, n_shards=n_shards)
    if ok:
        return 'kernel'
    if impl == 'kernel' or device.type == 'cuda':
        raise ValueError(
            f'decode_step: the fused kernel does not cover this call '
            f"— {reason} — pass impl='plain' to run the plain step")
    return 'plain'


def decode_step(q, cache, k_new, v_new, *, slot_mask=None, counts=None,
                scale=None, window=None, alibi_slopes=None, segment_ids=None,
                seg_q=None, qk_quant=None, group=None, impl=None,
                interpret=None):
    """One fused decode step: append ``k_new``/``v_new`` ``(B, H_kv, n,
    d)`` to the cache (in place) AND attend ``q (B, H, n, d)`` against
    the result. ``n = 1`` is the per-token step; ``n > 1`` a VERIFY-k
    step (speculative decoding's fused verify): the rows land at
    consecutive positions and query row ``j`` attends the prefix plus
    the appended rows ``<= j`` — bit-identical per row to ``n``
    sequential one-row steps on the kernel path. ``impl``:
    None/``'auto'`` run the kernel where it covers the call
    (:func:`decode_kernel_eligible`); elsewhere CPU tensors take the
    plain step and CUDA tensors raise the reason;
    ``'kernel'`` runs the K5 port on slab caches and the K5p port on paged
    caches (CUDA kernels for CUDA tensors, their plain versions for CPU
    tensors) or raises; ``'plain'`` runs the append ops +
    :func:`decode_attention` over the (gathered) slab view. ``window``
    applies on every path; ``qk_quant='int8'`` scores against the cache's
    int8 mirror (the kernel appends it in place; a non-int8 kernel step
    on a mirror-carrying cache keeps the mirror by quantizing the
    appended rows).

    Per-slot and paged caches take ``slot_mask (B,) bool`` (masked slots
    append nothing and their queries attend their un-advanced prefix)
    and ``counts (B,)``: per slot, how many of the ``n`` rows are real (a
    mixed spec/non-spec batch rides one step; a slot with ``counts[i] =
    c`` appends rows ``0..c-1`` and its query rows ``>= c`` give outputs
    the caller discards). An overflow raises eagerly, naming the slot.

    ``group``: the sequence-sharded step over that process group. On a
    SLAB cache (scalar global length, one row; see
    :func:`append_kv_sharded`) the owning rank appends; the kernel path
    runs K5 with ``partials=True`` on every rank's slab — the query's
    global position localised to the slab as its ``valid_to``, negative
    when the slab lies wholly in its future, past the slab when wholly in
    its past — and merges by :func:`_flash_merge`; the plain path runs the
    masked :func:`decode_attention` partials. An append past the global
    capacity raises on every rank before any write. On a PAGED cache the
    cache is this rank's local view of the sequence-sharded page table
    (:class:`ShardedPageTable`: the logical width kept, -1 at every
    ordinal another rank owns): :func:`paged_partials_step` on every
    rank, positions global, the append dropped through the -1 on
    non-owners, then :func:`_flash_merge`. ``counts`` is refused with a
    group (the sharded step appends whole rows), and the kernel path is
    single-token there.
    Returns ``(cache, out (B, H, n, d_v))``."""
    b, _, n, _ = q.shape
    n_shards = 1 if group is None else max(2, get_world_size(group))
    impl = _resolve_decode_impl(impl, cache, n, segment_ids, qk_quant,
                                n_shards, q.device)
    paged = isinstance(cache, PagedDecodeCache)
    per_slot = isinstance(cache.length, np.ndarray)
    if (slot_mask is not None or counts is not None) and not per_slot:
        raise ValueError('slot_mask/counts need a per-slot cache '
                         '(init_slot_cache or init_paged_cache); '
                         'scalar-length caches share one sequence clock')
    if group is not None and counts is not None:
        raise ValueError('per-slot counts are a local serving construct; '
                         'the sharded step appends whole rows')
    kw = dict(scale=scale, window=window, alibi_slopes=alibi_slopes,
              qk_quant=qk_quant)
    if group is not None and paged:
        cache, parts = paged_partials_step(
            q, cache, k_new, v_new, slot_mask=slot_mask,
            segment_ids=segment_ids, seg_q=seg_q, impl=impl,
            interpret=interpret, **kw)
        return cache, _flash_merge(parts, group, cache.v_pool.dtype)
    if group is not None:
        _check_global_room(cache, n, get_world_size(group))
    if impl == 'plain':
        before = cache.length
        if group is not None:
            cache = append_kv_sharded(cache, k_new, v_new, group=group)
        elif per_slot:
            cache = append_kv_slots(cache, k_new, v_new,
                                    slot_mask=slot_mask, counts=counts)
        else:
            cache = append_kv(cache, k_new, v_new)
        attend = _attend_view(cache, qk_quant)
        if per_slot and counts is not None:
            # Verify-k masking base: query row j of a slot sits at
            # position before + j whatever the slot's real count, so
            # decode_attention's "length - n + j" needs length = before
            # + n on active slots (padded rows then attend never-written
            # zero columns: don't-care outputs).
            active = (np.ones(b, bool) if slot_mask is None
                      else _host(slot_mask, bool))
            attend = attend._replace(
                length=np.where(active, before + n, before))
        return cache, decode_attention(q, attend, segment_ids=segment_ids,
                                       seg_q=seg_q, group=group, **kw)
    if group is not None:
        quant = qk_quant == 'int8'
        p = int(cache.length)
        vt = p - get_rank(group) * cache.t_max
        ap = vt if 0 <= vt < cache.t_max else -1
        res, _, _ = flash_decode(
            q, k_new, v_new, cache.k, cache.v,
            torch.full((b,), vt, dtype=torch.int32, device=q.device),
            torch.full((b,), ap, dtype=torch.int32, device=q.device),
            k_q=cache.k_q if quant else None,
            k_scale=cache.k_scale if quant else None, interpret=interpret,
            partials=True, **kw)
        if cache.k_q is not None and not quant and ap >= 0:
            ki, sk = _quantize_k(k_new, cache.k.dtype)
            cache.k_q[:, :, ap:ap + 1] = ki
            cache.k_scale[:, :, ap:ap + 1] = sk
        return (cache._replace(length=p + 1),
                _flash_merge(res, group, cache.v.dtype))
    return _kernel_step(q, cache, k_new, v_new, slot_mask, counts,
                        interpret=interpret, **kw)


def _attend_view(cache, qk_quant):
    """The slab view :func:`decode_attention` reads: the cache itself, or
    a paged cache gathered (with its int8 mirror for int8 scoring)."""
    if not isinstance(cache, PagedDecodeCache):
        return cache
    mirror = ((None, None) if qk_quant != 'int8' or cache.k_q_pool is None
              else paged_gather_mirror(cache))
    return DecodeCache(*paged_gather(cache), cache.length, *mirror)


def _kernel_step(q, cache, k_new, v_new, slot_mask, counts, *, scale,
                 window, alibi_slopes, qk_quant, interpret, partials=False):
    """The local fused step on K5 (slab) or K5p (paged): the append in
    place and the attention, or with ``partials`` the ``(num, m, l)``
    partials in place of the output. Returns ``(cache, out)``."""
    b, _, n, _ = q.shape
    quant = qk_quant == 'int8'
    paged = isinstance(cache, PagedDecodeCache)
    if isinstance(cache.length, np.ndarray):
        lengths = cache.length
        eff = _slot_counts(b, n, slot_mask, counts)
        _check_slot_room(lengths, eff, cache.t_max)
        active = (np.ones(b, bool) if slot_mask is None
                  else _host(slot_mask, bool))
        new_length = lengths + eff
    else:
        _check_room(cache, n)
        lengths = np.full(b, cache.length, np.int64)
        eff = np.full(b, n, np.int64)
        active = np.ones(b, bool)
        new_length = cache.length + n
    # Active queries' row 0 sits AT the first appended position (row j
    # at + j); frozen slots' queries attend their un-advanced prefix.
    ap_host = np.where(eff > 0, lengths, -1)
    ap = _to_device(ap_host, q.device, np.int32)
    nn = _to_device(eff, q.device, np.int32)
    vt = _to_device(np.where(active, lengths, lengths - n), q.device,
                    np.int32)
    kw = dict(n_new=nn, qk_quant=qk_quant, scale=scale, window=window,
              alibi_slopes=alibi_slopes, interpret=interpret,
              partials=partials)
    if paged:
        out, _, _ = flash_decode(
            q, k_new, v_new, cache.k_pool, cache.v_pool, vt, ap,
            page_table=cache.page_table,
            k_q=cache.k_q_pool if quant else None,
            k_scale=cache.k_scale_pool if quant else None, **kw)
        if cache.k_q_pool is not None and not quant:
            _paged_mirror_fixup(cache, k_new, ap_host, eff)
    else:
        out, _, _ = flash_decode(
            q, k_new, v_new, cache.k, cache.v, vt, ap,
            k_q=cache.k_q if quant else None,
            k_scale=cache.k_scale if quant else None, **kw)
        if not quant:
            # A non-int8 step on a mirror-carrying cache keeps the mirror
            # exact: the appended rows quantized the append-op way.
            _slab_mirror_rows(cache, k_new, lengths, eff)
    return cache._replace(length=new_length), out


def paged_partials_step(q, cache: PagedDecodeCache, k_new, v_new, *,
                        slot_mask=None, scale=None, window=None,
                        alibi_slopes=None, segment_ids=None, seg_q=None,
                        qk_quant=None, impl='kernel', interpret=None):
    """One shard's half of the sequence-sharded paged step: ``cache`` is
    the shard's local view (:func:`shard_view`; -1 at every ordinal
    another shard owns), ``q (B, H, 1, d)`` and ``k_new``/``v_new`` the
    same on every shard, positions global. The append lands through the
    local table, so only the owner's pool takes a row (the others drop it
    through their -1); then the shard's masked softmax partials ``(num
    (B, H, 1, d_v), m, l (B, H, 1, 1))``, float32, base 2: K5p with
    ``partials=True`` (``impl='kernel'``), or :func:`decode_attention`'s
    partials over the gathered view with the -1 columns masked
    (``impl='plain'``). A shard that owns none of a row's attended
    columns gives ``(0, _NEG_BIG, 0)``. ``impl`` is resolved by the
    caller. Returns ``(cache, partials)``; merge them with
    :func:`_flash_merge` or :func:`merge_partials`."""
    kw = dict(scale=scale, window=window, alibi_slopes=alibi_slopes,
              qk_quant=qk_quant)
    if impl == 'kernel':
        return _kernel_step(q, cache, k_new, v_new, slot_mask, None,
                            interpret=interpret, partials=True, **kw)
    cache = paged_append_kv_slots(cache, k_new, v_new, slot_mask=slot_mask)
    col_valid = (cache.page_table >= 0).repeat_interleave(cache.page_size,
                                                          dim=1)
    return cache, decode_attention(
        q, _attend_view(cache, qk_quant), segment_ids=segment_ids,
        seg_q=seg_q, col_valid=col_valid, col_offset=0, partials=True, **kw)


def sharded_decode_step(q, caches, k_new, v_new, *, slot_mask=None,
                        scale=None, window=None, alibi_slopes=None,
                        qk_quant=None, impl=None, interpret=None):
    """The sequence-sharded paged step with every shard in this process:
    ``caches`` holds each shard's local view (:func:`shard_view`, or a
    local cache of the same shapes on the shard's own device). Runs
    :func:`paged_partials_step` once per shard on that shard's device
    (K5p with ``partials=True`` on the kernel path), moves the partials
    to the first shard's device and merges them there with
    :func:`merge_partials`. ``impl`` resolves as in :func:`decode_step`
    (the kernel path is single-token). Returns ``(caches, out (B, H, 1,
    d_v))`` on the first shard's device."""
    n = q.shape[-2]
    impl = _resolve_decode_impl(impl, caches[0], n, None, qk_quant,
                                len(caches), q.device)
    home = caches[0].k_pool.device
    out_caches, parts = [], []
    for cache in caches:
        dev = cache.k_pool.device
        cache, res = paged_partials_step(
            q.to(dev), cache, k_new.to(dev), v_new.to(dev),
            slot_mask=slot_mask, scale=scale, window=window,
            alibi_slopes=alibi_slopes, qk_quant=qk_quant, impl=impl,
            interpret=interpret)
        out_caches.append(cache)
        parts.append(tuple(x.to(home) for x in res))
    return out_caches, merge_partials(parts, caches[0].v_pool.dtype)


def graphlint_entrypoints():
    """Registration hook (``analysis/registry.py``): the decode steps at
    the shapes where the contracts bite — bf16 caches, the int8 mirror
    through the fused kernel, the paged pool (plain, K5p, K5p int8), the
    sequence-sharded slab over the seq mesh, the sequence-sharded page
    table (every shard in this process, the kv_shards engine's step:
    plain and K5p partials) and verify-k on slab and pool."""
    from functools import partial

    # Debt (ROADMAP §3): the plain slab step multiplies the bf16 cache in
    # float32 (decode_attention's plain path on either device; K5's plain
    # version, the kernel's numerics, on the CPU only).
    _PLAIN_UPCAST = ('cache-upcast',)

    def _spec(name, fn, args, cache_fields=('k', 'v'), cache_out=None,
              **kw):
        from distributed_dot_product_tpu_torch.analysis.registry import (
            TraceSpec,
        )
        return TraceSpec(
            name=name, fn=fn, args=args,
            cache_in=lambda a: [getattr(a[1], f) for f in cache_fields],
            cache_out=cache_out or (
                lambda o: [getattr(o[0], f) for f in cache_fields]),
            expect_donation=True, donate_argnums=(1,),
            min_donated=len(cache_fields), **kw)

    def _new(device, b, n=1):
        from distributed_dot_product_tpu_torch.analysis.registry import (
            HEAD_DIM, example,
        )
        return example((b, 2, n, HEAD_DIM), torch.bfloat16, device)

    def step_xla_slots(device):
        from distributed_dot_product_tpu_torch.analysis.registry import (
            HEAD_DIM,
        )
        cache = init_slot_cache(2, 2, 32, HEAD_DIM, device=device)
        new = _new(device, 2)
        return _spec('decode.step_xla_slots',
                     partial(decode_step, impl='plain'),
                     (new, cache, new, new), allow=_PLAIN_UPCAST)

    def step_kernel_int8(device):
        from distributed_dot_product_tpu_torch.analysis.registry import (
            HEAD_DIM,
        )
        cache = init_cache(1, 2, 64, HEAD_DIM, qk_quant='int8',
                           device=device)
        new = _new(device, 1)
        return _spec('decode.step_kernel_int8',
                     partial(decode_step, impl='kernel', qk_quant='int8'),
                     (new, cache, new, new),
                     cache_fields=('k', 'v', 'k_q', 'k_scale'),
                     allow=_PLAIN_UPCAST)

    def step_sharded(device):
        from distributed_dot_product_tpu_torch.analysis.registry import (
            HEAD_DIM,
        )
        from distributed_dot_product_tpu_torch.parallel.mesh import (
            seq_mesh, shard_decode_cache,
        )
        from distributed_dot_product_tpu_torch.utils.comm import world_group
        cache = shard_decode_cache(
            init_cache(1, 2, 64, HEAD_DIM, device=device), seq_mesh())
        new = _new(device, 1)
        # The seq mesh spans the world: its group is the world group
        # (decode_step's group=None is the local step).
        return _spec('decode.step_sharded',
                     partial(decode_step, impl='plain', group=world_group()),
                     (new, cache, new, new), mesh_axes=('seq',),
                     allow=_PLAIN_UPCAST)

    def _paged_args(device, qk_quant=None, n=1):
        from distributed_dot_product_tpu_torch.analysis.registry import (
            HEAD_DIM,
        )
        cache = init_paged_cache(2, 2, 32, HEAD_DIM, pages=6, page_size=8,
                                 qk_quant=qk_quant, device=device)
        # A realistic mid-serve table: slot 0 holds two pages (fill 10),
        # slot 1 one page (fill 3); pool page 3 stays free.
        cache.page_table[0, :2] = torch.tensor([0, 1])
        cache.page_table[1, 0] = 2
        cache = cache._replace(length=np.array([10, 3], np.int64))
        return cache, _new(device, 2, n)

    _POOLS = ('k_pool', 'v_pool')

    def step_paged(impl, name, device, qk_quant=None):
        cache, new = _paged_args(device, qk_quant)
        fields = _POOLS + (('k_q_pool', 'k_scale_pool') if qk_quant
                           else ())
        return _spec(name, partial(decode_step, impl=impl,
                                   qk_quant=qk_quant),
                     (new, cache, new, new), cache_fields=fields)

    def _sharded_paged_spec(impl, device):
        from distributed_dot_product_tpu_torch.analysis.registry import (
            HEAD_DIM,
        )
        # Two shards over a pps=4 table (each owns 2 ordinals); a
        # mid-serve fill: slot 0 holds 10 rows (ordinals 0-1, both
        # shard 0's), slot 1 holds 3 (ordinal 0 → shard 0's page 2).
        cache = init_sharded_paged_cache(2, 2, 2, 32, HEAD_DIM,
                                         pages_per_shard=3, page_size=8,
                                         device=device)
        cache.page_table[0, 0, :2] = torch.tensor([0, 1])
        cache.page_table[0, 1, 0] = 2
        cache = cache._replace(length=np.array([10, 3], np.int64))
        new = _new(device, 2)

        def fn(q, stacked, k, v):
            return sharded_decode_step(
                q, [shard_view(stacked, s) for s in range(2)], k, v,
                impl=impl)

        suffix = '_kernel' if impl == 'kernel' else ''
        # The step returns every shard's view of the stacked pools: the
        # first shard's views share the stacked storage.
        return _spec(f'decode.step_paged_sharded{suffix}', fn,
                     (new, cache, new, new), cache_fields=_POOLS,
                     cache_out=lambda o: [getattr(o[0][0], f)
                                          for f in _POOLS],
                     mesh_axes=('seq',))

    def step_verify_slab(device):
        from distributed_dot_product_tpu_torch.analysis.registry import (
            HEAD_DIM,
        )
        cache = init_slot_cache(2, 2, 32, HEAD_DIM, device=device)
        cache = cache._replace(length=np.array([5, 9], np.int64))
        q = _new(device, 2, 3)
        counts = np.array([3, 1], np.int64)     # mixed spec / non-spec
        return _spec('decode.step_verify_slab',
                     partial(decode_step, impl='kernel', counts=counts),
                     (q, cache, q, q), allow=_PLAIN_UPCAST)

    def step_verify_paged(device):
        cache, q = _paged_args(device, n=3)
        counts = np.array([3, 2], np.int64)
        return _spec('decode.step_verify_paged',
                     partial(decode_step, impl='kernel', counts=counts),
                     (q, cache, q, q), cache_fields=_POOLS)

    return {
        'decode.step_xla_slots': step_xla_slots,
        'decode.step_kernel_int8': step_kernel_int8,
        'decode.step_sharded': step_sharded,
        'decode.step_paged_xla': partial(step_paged, 'plain',
                                         'decode.step_paged_xla'),
        'decode.step_paged_kernel': partial(step_paged, 'kernel',
                                            'decode.step_paged_kernel'),
        'decode.step_paged_kernel_int8': partial(
            step_paged, 'kernel', 'decode.step_paged_kernel_int8',
            qk_quant='int8'),
        'decode.step_paged_sharded': partial(_sharded_paged_spec, 'plain'),
        'decode.step_paged_sharded_kernel': partial(_sharded_paged_spec,
                                                    'kernel'),
        'decode.step_verify_slab': step_verify_slab,
        'decode.step_verify_paged': step_verify_paged,
    }
