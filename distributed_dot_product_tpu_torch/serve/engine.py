# -*- coding: utf-8 -*-
"""
The substrate the scheduler drives: a minimal greedy LM over the KV-cache
decode kernels (``models/decode.py``), batched across decode SLOTS with
per-slot lengths — the port of ``distributed_dot_product_tpu/serve/
engine.py`` ``KernelEngine``.

Continuous batching needs every batch row on its own sequence clock,
which the per-slot and paged caches provide at the kernel level, so the
engine drives them directly: token embedding → q/k/v projections →
per-slot cache append → per-slot masked attention → logits → argmax. One
attention layer, fixed seeded weights (serving robustness needs
determinism, not trained weights).

Three operations serve the whole lifecycle, shapes fixed at
construction:

- ``step``: one token for EVERY slot (inactive slots masked out of the
  append; their outputs ignored) plus the per-slot all-finite verdict on
  the logits. The append + attend pair is the fused step
  (``decode_step``): K5 on the slab cache, K5p on the paged cache, each
  one CUDA kernel pair on the card that appends in place. The fault
  injector's NaN mask is applied inside the step, so the quarantine
  predicate sees real NaNs.
- ``prefill``: one padded prompt chunk into one slot's cache rows (no
  attention — the scheduler feeds the prompt's last token through
  ``step``).
- ``reset``: zero one slot's rows and length (eviction / quarantine);
  paged, the slot's pages go back to the pool and the freed ones are
  zeroed.

Every computation is batch-row independent (embedding lookups, row-wise
matmuls, per-slot masked attention, per-row argmax), so a request's
tokens depend only on its prompt and the seed — not on its slot or its
neighbours — and the slab and paged engines emit the same streams.

The port runs eagerly: the reference's three jitted programs are plain
methods here, weights are tensors on the engine's device (seeded with
``torch.Generator``, or loaded from the reference engine with
:meth:`KernelEngine.load_weights`), and slot lengths and the page pool
live on the host. Not ported yet (ROADMAP): ``kv_shards``,
``weight_quant``, ``verify_step``, ``rollback``, ``adopt_prefix`` and the
``DDP_TPU_*`` environment knobs.
"""

import itertools
import time

import numpy as np
import torch

from distributed_dot_product_tpu_torch.models.decode import (
    PageChecksums, PagePool, _to_device, append_kv_slots, decode_step,
    init_paged_cache, init_slot_cache, paged_append_rows, paged_copy_attach,
    paged_reset_slot, reset_slot, slots_all_finite,
)
from distributed_dot_product_tpu_torch.obs import spans as obs_spans
from distributed_dot_product_tpu_torch.obs.spans import span
from distributed_dot_product_tpu_torch.serve.errors import ServeContractError
from distributed_dot_product_tpu_torch.utils.comm import resolve_device

__all__ = ['KernelEngine', 'PageCorruptionError']

_WEIGHTS = ('embed', 'wq', 'wk', 'wv', 'wo')


class PageCorruptionError(RuntimeError):
    """A pool page's content no longer matches its recorded checksum.
    ``pages`` names the dirty pages, ``site`` the boundary that caught
    them ('scrub', 'attach', 'fork')."""

    def __init__(self, pages, site):
        self.pages = sorted(int(p) for p in pages)
        self.site = site
        super().__init__(f'KV page corruption at {site}: page(s) '
                         f'{self.pages} fail checksum verification')


class KernelEngine:
    """Greedy decode engine over ``slots`` independent sequences.

    ``prefill_chunk`` is the chunk width for prompt ingestion (prompts
    append in ceil(len/chunk) calls — chunked prefill, so a long prompt
    never monopolizes the loop between decode steps).

    ``decode_impl``: ``'kernel'`` runs the fused step (K5 / K5p — the
    CUDA kernels on the card, their plain versions on the CPU),
    ``'plain'`` the append ops + masked attention.

    ``cache_mode='paged'`` swaps the per-slot slab for the page-pool
    cache: ``pages`` sizes the pool (default the slab's bytes, ``slots ·
    t_max / page_size``), ``page_size`` the page (default ``min(16,
    t_max)``). The host :class:`PagePool` owns allocation;
    :meth:`step`/:meth:`prefill` reserve the pages they need (raising on
    exhaustion), while the Scheduler calls :meth:`prepare_step` /
    :meth:`reserve_rows` itself so a deficit routes through its
    evict/preempt ladder. :meth:`register_prefix` /
    :meth:`start_with_prefix` give refcounted prefix sharing,
    :meth:`fork_slot` copy-on-write forks. Token streams are
    bit-identical to the slab engine's.

    ``device`` follows the port's rule: the card unless the caller asks
    for the CPU.
    """

    def __init__(self, slots, t_max, *, vocab=64, heads=2, head_dim=8,
                 prefill_chunk=8, seed=0, dtype=torch.float32,
                 decode_impl='kernel', cache_mode='slab', pages=None,
                 page_size=None, kv_checksums=True, device='cuda'):
        if slots < 1 or t_max < 2:
            raise ValueError(f'need slots >= 1 and t_max >= 2, got '
                             f'{slots}/{t_max}')
        if decode_impl not in ('kernel', 'plain'):
            raise ValueError(f"decode_impl must be 'kernel' or 'plain', "
                             f'got {decode_impl!r}')
        if cache_mode not in ('slab', 'paged'):
            raise ValueError(f"cache_mode must be 'slab' or 'paged', "
                             f'got {cache_mode!r}')
        self.device = resolve_device(device)
        self.decode_impl = decode_impl
        self.cache_mode = cache_mode
        self.slots = slots
        self.t_max = t_max
        self.vocab = vocab
        self.heads = heads
        self.head_dim = head_dim
        self.prefill_chunk = prefill_chunk
        self.seed = seed
        self.dtype = dtype
        dim = heads * head_dim
        gen = torch.Generator().manual_seed(seed)
        scale = 1.0 / np.sqrt(dim)
        shapes = {'embed': (vocab, dim), 'wq': (dim, dim), 'wk': (dim, dim),
                  'wv': (dim, dim), 'wo': (dim, vocab)}
        self.load_weights({name: torch.randn(shape, generator=gen) * scale
                           for name, shape in shapes.items()})
        if cache_mode == 'paged':
            ps = page_size or min(16, t_max)
            if t_max % ps:
                raise ValueError(f'page_size {ps} must divide t_max '
                                 f'{t_max}')
            self.page_size = ps
            n_pages = pages if pages is not None else slots * (t_max // ps)
            self.pool = PagePool(n_pages, ps, slots, t_max // ps)
            self.cache = init_paged_cache(slots, heads, t_max, head_dim,
                                          pages=n_pages, page_size=ps,
                                          dtype=dtype, device=self.device)
            self._prefix_registry = {}
            self._prefix_counter = itertools.count()
            # Registry pages only, digested on the host at transfer
            # boundaries — never per step. kv_checksums=False is the
            # no-integrity twin.
            self.checksums = PageChecksums() if kv_checksums else None
        else:
            self.page_size = None
            self.pool = None
            self.checksums = None
            self.cache = init_slot_cache(slots, heads, t_max, head_dim,
                                         dtype=dtype, device=self.device)
        self.verify_seconds = 0.0   # host wall time spent digesting
        # Cumulative REAL wall seconds spent inside decode and prefill
        # calls, the decode step timed through the host read of its
        # tokens (which waits for the card). The scheduler diffs it
        # across a tick to split tick time into device work and
        # host-loop overhead. Monotone, never reset.
        self.program_seconds = 0.0

    def load_weights(self, state):
        """Set the weights from ``{'embed', 'wq', 'wk', 'wv', 'wo'}``
        (arrays or tensors in the reference's layout: ``embed (vocab,
        dim)``, the projections ``(dim, dim)`` and the head ``(dim,
        vocab)``, each ``x @ w``) — cast to the engine's dtype and
        device. The port's counterpart of ``load_state_dict``; see
        ``convert.engine_state_from_jax``."""
        if set(state) != set(_WEIGHTS):
            raise ValueError(f'engine weights are {_WEIGHTS}, got '
                             f'{sorted(state)}')
        dim = self.heads * self.head_dim
        want = {'embed': (self.vocab, dim), 'wq': (dim, dim),
                'wk': (dim, dim), 'wv': (dim, dim), 'wo': (dim, self.vocab)}
        for name in _WEIGHTS:
            w = torch.as_tensor(state[name])
            if tuple(w.shape) != want[name]:
                raise ValueError(f'{name} has shape {tuple(w.shape)}, want '
                                 f'{want[name]}')
            setattr(self, f'_{name}', w.to(device=self.device,
                                           dtype=self.dtype).contiguous())

    # -- the step bodies ------------------------------------------------
    def _project(self, tokens):
        """tokens (S,) → q, k, v each (S, H, 1, D)."""
        x = self._embed[tokens]                              # (S, dim)
        shape = (tokens.shape[0], self.heads, 1, self.head_dim)
        return ((x @ self._wq).reshape(shape),
                (x @ self._wk).reshape(shape),
                (x @ self._wv).reshape(shape))

    def _project_kv(self, tokens):
        """Chunk tokens ``(C,)`` → cache-layout k, v each ``(H, C, D)``
        — the ONE projection both prefill paths share, so shared-prefix
        pages hold exactly the K/V a slot's own prefill would."""
        x = self._embed[tokens]                              # (C, dim)
        shape = (tokens.shape[0], self.heads, self.head_dim)
        return ((x @ self._wk).reshape(shape).transpose(0, 1),
                (x @ self._wv).reshape(shape).transpose(0, 1))

    def _decode(self, tokens, active, poison):
        q, k, v = self._project(tokens)
        self.cache, out = decode_step(q, self.cache, k, v, slot_mask=active,
                                      impl=self.decode_impl)
        logits = out.reshape(self.slots, -1) @ self._wo       # (S, vocab)
        logits = torch.where(poison[:, None], float('nan'), logits)
        finite = slots_all_finite(logits)
        # A poisoned row's argmax input would be NaN-ordered garbage; the
        # scheduler discards non-finite slots' tokens, so the value only
        # needs to be deterministic.
        next_tok = torch.argmax(torch.where(torch.isfinite(logits), logits,
                                            float('-inf')), dim=-1)
        return next_tok, finite

    # -- host surface (numpy in, numpy out) -----------------------------
    def step(self, tokens, active, poison=None, request_ids=None):
        """One decode step for all slots. ``tokens (S,) int`` — each
        ACTIVE slot's input token (its previous output, or the last
        prompt token right after prefill); inactive entries ignored.
        Returns ``(next_tokens (S,), finite (S,))`` numpy arrays.
        ``request_ids`` (per slot, optional) labels the span only."""
        act = np.asarray(active, bool)
        poison = (np.zeros(self.slots, bool) if poison is None
                  else np.asarray(poison, bool))
        if self.cache_mode == 'paged':
            # Auto-prepare only when a slot actually needs a page (the
            # scheduler's ladder has usually prepared already); a bare
            # loop has no evict/preempt ladder, so exhaustion raises.
            if not self._writable_mask(act).all():
                ok = self.prepare_step(act)
                if not ok.all():
                    raise RuntimeError(
                        f'page pool exhausted for slot(s) '
                        f'{np.nonzero(~ok)[0].tolist()} '
                        f'({self.pool.free_pages} pages free) — retire or '
                        f'evict sequences (the Scheduler ladder does), or '
                        f'size the pool larger')
            self._sync_page_table()
        ids = (tuple(r for r in (request_ids or ()) if r)
               if obs_spans.enabled() else ())
        with span('engine.decode_step', requests=ids):
            t0 = time.perf_counter()
            tok, finite = self._decode(_to_device(tokens, self.device), act,
                                       _to_device(poison, self.device, bool))
            # The host read waits for the card: program_seconds is the
            # wall time the loop actually waits on the step.
            out = (tok.cpu().numpy().astype(np.int32), finite.cpu().numpy())
            self.program_seconds += time.perf_counter() - t0
            if self.cache_mode == 'paged':
                self.pool.lengths[act] += 1
            return out

    def prefill(self, slot, tokens, request_id=None):
        """Append one prompt chunk (``len(tokens) <= prefill_chunk``)
        into ``slot``. Pads to the chunk width; padded rows never land
        (counts mask). ``request_id`` labels the span only."""
        n = len(tokens)
        if n > self.prefill_chunk:
            raise ServeContractError(
                f'chunk of {n} exceeds prefill_chunk={self.prefill_chunk}')
        buf = np.zeros(self.prefill_chunk, np.int64)
        buf[:n] = np.asarray(tokens, np.int64)
        if self.cache_mode == 'paged':
            # Reserve the chunk's pages (a no-op when the scheduler
            # already reserved the whole prompt at admission).
            pos = int(self.pool.lengths[slot])
            covered = int(self.pool.counts[slot]) * self.page_size
            if pos + n > covered and not self.reserve_rows(slot, n):
                raise RuntimeError(
                    f'page pool exhausted prefilling rows [{pos}, '
                    f'{pos + n}) of slot {slot} ({self.pool.free_pages} '
                    f'pages free)')
            self._sync_page_table()
        with span('engine.prefill', slot=int(slot),
                  request=request_id or ''):
            t0 = time.perf_counter()
            k, v = self._project_kv(_to_device(buf, self.device))
            counts = np.zeros(self.slots, np.int64)
            counts[slot] = n
            # The chunk broadcast to every slot (a view); the counts mask
            # lands it on the one slot.
            self.cache = append_kv_slots(
                self.cache, k[None].expand(self.slots, *k.shape),
                v[None].expand(self.slots, *v.shape), counts=counts)
            self.program_seconds += time.perf_counter() - t0
        if self.cache_mode == 'paged':
            self.pool.lengths[slot] += n

    def _zero_freed(self, freed, slot=-1):
        """Zero freed pool pages (and clear ``slot``'s table row and
        length when one is named; -1 touches no slot)."""
        self.cache = paged_reset_slot(self.cache, slot, freed)
        if self.checksums is not None:
            self.checksums.drop(freed)

    def reset(self, slot):
        """Evict ``slot`` (zero rows + length); other slots untouched.
        Paged: drops the slot's page references and zeroes exactly the
        pages that reached refcount 0 (still-shared prefix/fork pages
        keep their bits)."""
        if self.cache_mode == 'paged':
            self._zero_freed(self.pool.release(slot), slot)
            self._sync_page_table()
        else:
            self.cache = reset_slot(self.cache, slot)

    def lengths(self):
        return np.array(self.cache.length)

    # -- paged-pool surface (cache_mode='paged') ------------------------
    def _sync_page_table(self):
        """Copy the host table to the card when the pool changed it."""
        if self.pool.dirty:
            # Staged at once (see _to_device): the pool may change the
            # host table right after without waiting for the card.
            self.cache.page_table.copy_(torch.from_numpy(self.pool.table),
                                        non_blocking=True)
            self.pool.dirty = False

    def _apply_copies(self, copies):
        for src, dst in copies:
            self.cache = paged_copy_attach(self.cache, src, dst, -1, 0)

    def _writable_mask(self, active):
        """Per active slot: does a PRIVATE page already cover its next
        append position? A slot at ``t_max`` counts as writable (nothing
        to prepare)."""
        idx = np.nonzero(active)[0]
        ok = np.ones(len(active), bool)
        if not idx.size:
            return ok
        pool = self.pool
        pi = pool.lengths[idx] // self.page_size
        full = pi >= pool.pages_per_slot
        pg = pool.table[idx, np.minimum(pi, pool.pages_per_slot - 1)]
        good = (pg >= 0)
        good &= pool.refcount[np.maximum(pg, 0)] == 1
        ok[idx] = full | good
        return ok

    def prepare_step(self, active):
        """Make every active slot's next append position writable:
        allocate the page a slot crossing a page boundary needs, and
        copy-on-write any shared append page. Returns a ``(slots,) bool``
        mask — False means the pool is EXHAUSTED for that slot and nothing
        was allocated; the scheduler owns the evict/preempt policy."""
        active = np.asarray(active, bool)
        ok = np.ones(self.slots, bool)
        todo = active & ~self._writable_mask(active)
        for i in np.nonzero(todo)[0]:
            st, src, dst = self.pool.prepare_append(int(i))
            if st == 'exhausted':
                ok[i] = False
            elif st == 'cow':
                self._apply_copies([(src, dst)])
        self._sync_page_table()
        return ok

    def reserve_rows(self, slot, rows):
        """Admission-time reservation: every page covering ``slot``'s next
        ``rows`` logical rows (chunked prefill can then never fail
        mid-prompt). False = pool exhausted, nothing changed."""
        ok, copies = self.pool.reserve_rows(slot, rows)
        if ok:
            self._apply_copies(copies)
            self._sync_page_table()
        return ok

    def register_prefix(self, tokens):
        """Prefill ``tokens`` ONCE into registry-owned pool pages and
        return a prefix id. Sequences started with
        :meth:`start_with_prefix` share the prefix's full pages read-only
        (refcounted)."""
        if self.cache_mode != 'paged':
            raise ValueError("prefix sharing needs cache_mode='paged'")
        tokens = np.asarray(tokens, np.int64).reshape(-1)
        n = len(tokens)
        if n < 1:
            raise ValueError('empty prefix')
        if n + 1 > self.t_max:
            raise ValueError(f'prefix of {n} tokens leaves no room to '
                             f'generate in a t_max={self.t_max} cache')
        needed = self.pool.pages_for_rows(n)
        pages = self.pool.alloc_block(needed)
        if pages is None:
            raise RuntimeError(
                f'page pool exhausted registering a {n}-token prefix '
                f'({needed} pages needed, {self.pool.free_pages} free)')
        row = np.full(self.pool.pages_per_slot, -1, np.int64)
        row[:needed] = pages
        for start in range(0, n, self.prefill_chunk):
            chunk = tokens[start:start + self.prefill_chunk]
            buf = np.zeros(self.prefill_chunk, np.int64)
            buf[:len(chunk)] = chunk
            k, v = self._project_kv(_to_device(buf, self.device))
            self.cache = paged_append_rows(self.cache, k, v, row, start,
                                           len(chunk))
        pid = next(self._prefix_counter)
        self._prefix_registry[pid] = (pages, n)
        self._checksum_record(pages)
        return pid

    # -- page integrity (host-side, transfer boundaries only) -----------
    def _checksum_record(self, pages):
        if self.checksums is None:
            return
        t0 = time.perf_counter()
        self.checksums.record(self.cache, pages)
        self.verify_seconds += time.perf_counter() - t0

    def verify_pages(self, pages=None):
        """Re-digest ``pages`` (default: every tracked page — the scrub)
        against the recorded checksums. Returns the sorted dirty-page
        list without raising; [] when clean or when checksums are
        disabled."""
        if self.checksums is None:
            return []
        t0 = time.perf_counter()
        bad = self.checksums.verify(self.cache, pages)
        self.verify_seconds += time.perf_counter() - t0
        return bad

    def verify_prefix(self, prefix_id):
        """Scrub one registered prefix's pages (dirty list, no raise)."""
        pages, _ = self._prefix_registry[prefix_id]
        return self.verify_pages(pages)

    def check_pages(self, pages, site):
        """Raise :class:`PageCorruptionError` naming ``site`` if any of
        ``pages`` fails verification (untracked pages are skipped)."""
        bad = self.verify_pages(pages)
        if bad:
            raise PageCorruptionError(bad, site)

    def quarantine_pages(self, pages):
        """Withdraw dirty pages from circulation (they never return to
        the free list) and forget their digests. Returns the pages newly
        quarantined."""
        if self.checksums is not None:
            self.checksums.drop(pages)
        return self.pool.quarantine(pages)

    def prefix_length(self, prefix_id):
        return self._prefix_registry[prefix_id][1]

    def unregister_prefix(self, prefix_id):
        """Release the registry's page references; pages still shared
        by live sequences survive until those retire."""
        pages, _ = self._prefix_registry.pop(prefix_id)
        freed = self.pool.release_pages(pages)
        if freed:
            self._zero_freed(freed)

    def start_with_prefix(self, slot, prefix_id):
        """Point an EMPTY slot at a registered prefix: full pages shared
        (refcount++), partial tail page copied private, length set.
        False = pool exhausted. The prefix's pages are verified first."""
        pages, plen = self._prefix_registry[prefix_id]
        self.check_pages(pages, 'attach')
        ok, src, dst = self.pool.attach(slot, pages, plen)
        if not ok:
            return False
        self.cache = paged_copy_attach(self.cache, src, dst, slot, plen)
        self._sync_page_table()
        return True

    def fork_slot(self, src, dst):
        """Copy-on-write fork: ``dst`` (an empty slot) shares ``src``'s
        full pages and gets a private copy of the partial tail page.
        False = pool exhausted. The source's tracked pages are verified
        before the branch shares them."""
        if self.checksums is not None:
            shared = [int(self.pool.table[src, i])
                      for i in range(int(self.pool.counts[src]))]
            self.check_pages(shared, 'fork')
        ok, tail_src, tail_dst = self.pool.fork(src, dst)
        if not ok:
            return False
        self.cache = paged_copy_attach(self.cache, tail_src, tail_dst, dst,
                                       int(self.pool.lengths[dst]))
        self._sync_page_table()
        return True

    @property
    def weight_bytes(self):
        """Bytes of the four projection/head matrices a decode step
        streams (the embedding is gathered, not streamed)."""
        return sum(w.numel() * w.element_size()
                   for w in (self._wq, self._wk, self._wv, self._wo))

    @property
    def free_pages(self):
        return self.pool.free_pages if self.pool is not None else None

    @property
    def pinned_pages(self):
        """Distinct pool pages the prefix registry holds a permanent
        reference on (0 on slab engines)."""
        if self.pool is None:
            return 0
        return sum(len(pages)
                   for pages, _ in self._prefix_registry.values())

    @property
    def capacity_tokens(self):
        """Most rows ONE fresh sequence can ever hold: the per-slot
        table reach capped by the pool itself."""
        if self.pool is None:
            return self.t_max
        return min(self.t_max, self.pool.pages * self.page_size)

    def slot_pages(self, slot):
        return self.pool.slot_pages(slot) if self.pool is not None else 0

    def cache_stats(self):
        """Occupancy snapshot for the scheduler's gauges (zeros on slab
        engines, so generic code can probe any engine)."""
        pool = self.pool
        if pool is None:
            return {'pages': 0, 'pages_used': 0, 'pages_free': 0,
                    'shared_pages': 0, 'page_size': 0,
                    'pages_quarantined': 0}
        return {'pages': pool.pages, 'pages_used': pool.used_pages,
                'pages_free': pool.free_pages,
                'shared_pages': pool.shared_pages,
                'page_size': pool.page_size,
                'pages_quarantined': len(pool.quarantined)}

    def flip_page_bit(self, page):
        """Flip an exponent bit of ``page``'s K pool bytes (byte 3 of the
        page, in place on the device) — the corruption primitive the
        integrity tests use; an undetected flip changes delivered
        tokens."""
        raw = self.cache.k_pool[int(page)].view(-1).view(torch.uint8)
        raw[3] ^= 0x40
