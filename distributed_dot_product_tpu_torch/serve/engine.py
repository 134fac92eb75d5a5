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
- ``verify_step`` / ``rollback``: speculative decoding's fused verify-k
  step (every slot's input token plus its proposals in one K5 / K5p
  launch, per-slot counts) and the acceptance-prefix rollback that
  truncates each slot to the tokens it committed.

Every computation is batch-row independent (embedding lookups, row-wise
matmuls, per-slot masked attention, per-row argmax), so a request's
tokens depend only on its prompt and the seed — not on its slot or its
neighbours — and the slab and paged engines emit the same streams.

The port runs eagerly: the reference's three jitted programs are plain
methods here, weights are tensors on the engine's device (seeded with
``torch.Generator``, or loaded from the reference engine with
:meth:`KernelEngine.load_weights`), and slot lengths and the page pool
live on the host. ``kv_shards=N`` (paged) shards the KV cache's page
table over N pools (:class:`~distributed_dot_product_tpu_torch.models.
decode.ShardedPageTable`): one controller drives every shard from this
process, shard ``s`` on ``cuda:(s % device_count)`` (all on the one card
of a one-card machine, or on the CPU when asked), a decode tick launches
K5p with ``partials=True`` once per shard on its local view and merges
the partials on the first shard's device. ``weight_quant='int8'``
stores the four projection and head matrices int8 with per-output-channel
scales, and every projection and the logits go through the one s8
product of ``models/dense.quantized_dot``. As in the reference, the
``DDP_TPU_DECODE_KERNEL``, ``DDP_TPU_PAGED_CACHE`` and
``DDP_TPU_WEIGHT_QUANT`` environment knobs choose the decode path, the
cache layout and the weight precision when the arguments leave them
None.

The prefill→decode handoff of disaggregated serving (``serve/replica.py``,
``serve/router.py``): :meth:`KernelEngine.adopt_prefix` copies whole pages
of another paged cache (a prefill pool's) into freshly allocated pages of
this engine's pool (:func:`~distributed_dot_product_tpu_torch.models
.decode.paged_transfer_pages`) and registers them as a shared prefix,
verified end to end when the source's checksums come along; a
``kv_shards`` engine adopts shard-locally, each shard receiving only the
pages of the ordinals it owns.
"""

import itertools
import os
import time

import numpy as np
import torch

from distributed_dot_product_tpu_torch.models.decode import (
    PageChecksums, PagePool, ShardedPageTable, _to_device, append_kv_slots,
    decode_step, init_paged_cache, init_slot_cache, paged_append_rows,
    paged_copy_attach, paged_reset_slot, paged_rollback_slots,
    paged_transfer_pages, reset_slot, rollback_slots, sharded_decode_step,
    slots_all_finite,
)
from distributed_dot_product_tpu_torch.models.dense import (
    dense_param_bytes, quantize_kernel, quantized_dot,
)
from distributed_dot_product_tpu_torch.obs import spans as obs_spans
from distributed_dot_product_tpu_torch.ops.flash_decode import _SPLIT
from distributed_dot_product_tpu_torch.obs.spans import span
from distributed_dot_product_tpu_torch.serve.errors import ServeContractError
from distributed_dot_product_tpu_torch.utils.comm import resolve_device

__all__ = ['KernelEngine', 'PageCorruptionError']

_WEIGHTS = ('embed', 'wq', 'wk', 'wv', 'wo')


class PageCorruptionError(RuntimeError):
    """A pool page's content no longer matches its recorded checksum.
    ``pages`` names the dirty pages, ``site`` the boundary that caught
    them ('scrub', 'attach', 'fork'); on a ``kv_shards`` engine
    ``shards`` names the shards owning them (the page ids are then
    global stacked-row ids), None elsewhere."""

    def __init__(self, pages, site, shards=None):
        self.pages = sorted(int(p) for p in pages)
        self.site = site
        self.shards = (sorted({int(s) for s in shards})
                       if shards else None)
        msg = (f'KV page corruption at {site}: page(s) {self.pages} fail '
               f'checksum verification')
        if self.shards:
            msg += f' (kv shard(s) {self.shards})'
        super().__init__(msg)


def _resolve_decode_impl(decode_impl):
    """Engine decode-path selection: an explicit argument wins; else the
    ``DDP_TPU_DECODE_KERNEL`` env knob (1/true/kernel → the fused step,
    0/false/xla/plain → the plain step; the reference's ``xla`` is the
    port's ``plain``); else ``'kernel'`` (the kernel on the card, its
    plain version on the CPU)."""
    if decode_impl is not None:
        return decode_impl
    env = os.environ.get('DDP_TPU_DECODE_KERNEL', '').strip().lower()
    if env in ('0', 'false', 'xla', 'plain'):
        return 'plain'
    return 'kernel'


def _resolve_weight_quant(weight_quant):
    """Weight-precision selection: an explicit argument wins ('off'/None
    = float weights, 'int8' = per-output-channel int8 weights,
    ``models/dense.quantize_kernel``'s rule); else the
    ``DDP_TPU_WEIGHT_QUANT`` env knob (1/true/int8)."""
    if weight_quant is not None:
        if weight_quant == 'off':
            return None
        if weight_quant not in ('int8',):
            raise ValueError(f"weight_quant must be None/'off'/'int8', "
                             f'got {weight_quant!r}')
        return weight_quant
    env = os.environ.get('DDP_TPU_WEIGHT_QUANT', '').strip().lower()
    if env in ('1', 'true', 'int8'):
        return 'int8'
    return None


def _resolve_cache_mode(cache_mode):
    """Cache-layout selection: an explicit argument wins; else the
    ``DDP_TPU_PAGED_CACHE`` env knob (1/true/paged → the page-pool
    cache); else the slab."""
    if cache_mode is not None:
        if cache_mode not in ('slab', 'paged'):
            raise ValueError(f"cache_mode must be 'slab' or 'paged', "
                             f'got {cache_mode!r}')
        return cache_mode
    env = os.environ.get('DDP_TPU_PAGED_CACHE', '').strip().lower()
    if env in ('1', 'true', 'paged'):
        return 'paged'
    return 'slab'


class KernelEngine:
    """Greedy decode engine over ``slots`` independent sequences.

    ``prefill_chunk`` is the chunk width for prompt ingestion (prompts
    append in ceil(len/chunk) calls — chunked prefill, so a long prompt
    never monopolizes the loop between decode steps).

    ``decode_impl``: ``'kernel'`` runs the fused step (K5 / K5p — the
    CUDA kernels on the card, their plain versions on the CPU),
    ``'plain'`` the append ops + masked attention; None reads
    ``DDP_TPU_DECODE_KERNEL`` (default ``'kernel'``). ``cache_mode=None``
    reads ``DDP_TPU_PAGED_CACHE`` (default ``'slab'``).

    ``weight_quant='int8'`` (or, left None, ``DDP_TPU_WEIGHT_QUANT=int8``;
    ``'off'`` overrides the knob) stores ``wq``, ``wk``, ``wv`` and
    ``wo`` int8 with per-output-channel scales, quantized from the float
    weights at the engine's dtype (at construction and in
    :meth:`load_weights`); every projection and the logits then run
    :func:`~distributed_dot_product_tpu_torch.models.dense.quantized_dot`
    (:meth:`_dot`). The embedding stays float: it feeds a lookup. Streams
    stay deterministic and layout-oblivious (slab, paged and ``kv_shards``
    engines with the same seed and ``weight_quant`` emit the same
    tokens).

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

    ``kv_shards=N > 1`` (paged only) shards the page table over N pools
    of ``pages`` pages EACH (default the slab's bytes split over the
    shards), shard ``s`` owning a contiguous run of every slot's logical
    page ordinals: ``capacity_tokens`` sums over the shards,
    ``min(t_max, N · pages · page_size)``. Page ids on the host surface
    (checksum verdicts, quarantine, ``flip_page_bit``) are global
    stacked-row ids (:meth:`page_shard` names the owner); exhaustion of
    one shard's range is a typed failure naming every shard's free
    pages; checksums are kept per owning shard. Streams equal the
    single-pool engine's. Speculative verify, local prefix registration
    and forks are refused (ValueError naming ``kv_shards``): shared
    prefixes reach a sharded engine through :meth:`adopt_prefix`, which
    lands each page on the shard owning its ordinal. Shard ``s``'s
    local cache is its own allocation on ``shard_devices[s]``:
    ``cuda:(s % device_count)``, or the CPU when the engine's device is.

    ``device`` follows the port's rule: the card unless the caller asks
    for the CPU.
    """

    def __init__(self, slots, t_max, *, vocab=64, heads=2, head_dim=8,
                 prefill_chunk=8, seed=0, dtype=torch.float32,
                 decode_impl=None, cache_mode=None, pages=None,
                 page_size=None, weight_quant=None, kv_checksums=True,
                 kv_shards=1, device='cuda'):
        if slots < 1 or t_max < 2:
            raise ValueError(f'need slots >= 1 and t_max >= 2, got '
                             f'{slots}/{t_max}')
        decode_impl = _resolve_decode_impl(decode_impl)
        if decode_impl not in ('kernel', 'plain'):
            raise ValueError(f"decode_impl must be 'kernel' or 'plain', "
                             f'got {decode_impl!r}')
        cache_mode = _resolve_cache_mode(cache_mode)
        self.weight_quant = _resolve_weight_quant(weight_quant)
        self.kv_shards = int(kv_shards)
        if self.kv_shards < 1:
            raise ValueError(f'kv_shards must be >= 1, got {kv_shards}')
        if self.kv_shards > 1 and cache_mode != 'paged':
            raise ValueError("kv_shards > 1 needs cache_mode='paged' — the "
                             'sequence-sharded KV is a sharded page table, '
                             'there is no sharded slab')
        self.device = resolve_device(device)
        self.shard_devices = [self.device]
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
            if self.kv_shards > 1:
                self._init_sharded(pages, dtype)
            else:
                n_pages = (pages if pages is not None
                           else slots * (t_max // ps))
                self.pool = PagePool(n_pages, ps, slots, t_max // ps)
                self.cache = init_paged_cache(slots, heads, t_max, head_dim,
                                              pages=n_pages, page_size=ps,
                                              dtype=dtype,
                                              device=self.device)
            self._prefix_registry = {}
            self._prefix_counter = itertools.count()
            # Registry pages only, digested on the host at transfer
            # boundaries — never per step. kv_checksums=False is the
            # no-integrity twin. A kv_shards engine keeps one table per
            # owning shard, keyed by shard-local page ids.
            if not kv_checksums:
                self.checksums = None
            elif self.kv_shards > 1:
                self.checksums = [PageChecksums()
                                  for _ in range(self.kv_shards)]
            else:
                self.checksums = PageChecksums()
        else:
            self.page_size = None
            self.pool = None
            self.checksums = None
            self.cache = init_slot_cache(slots, heads, t_max, head_dim,
                                         dtype=dtype, device=self.device)
        # One watched program each for the engine's lifetime, the
        # reference's jitted programs (analysis/retrace.py): shapes are
        # fixed at construction, so more than budget input signatures of
        # one program means something per-call leaked into the step — the
        # step a CUDA graph could not keep. Budget 2: the real signature
        # plus one registry run / dtype respin.
        from distributed_dot_product_tpu_torch.analysis.retrace import (
            watch_traces,
        )
        self._decode = watch_traces(self._verify, 'engine.decode', budget=2)
        self._prefill = watch_traces(self._prefill_impl, 'engine.prefill',
                                     budget=2)
        self._reset = watch_traces(self._reset_impl, 'engine.reset',
                                   budget=2)
        if cache_mode == 'paged':
            # The sharing primitives: CoW/fork/attach page copy (+ length
            # set) and registry prefix prefill — dispatched on page
            # crossings and prefix/fork events, never per token.
            self._copy_attach = watch_traces(
                self._copy_attach_impl, 'engine.copy_attach', budget=2)
            # register_prefix is refused under kv_shards.
            self._prefix_fill = (None if self.kv_shards > 1 else
                                 watch_traces(self._prefix_fill_impl,
                                              'engine.prefix_fill',
                                              budget=2))
        # Built lazily, one per shape: a verify program per width W =
        # k+1, a rollback program per span bucket, a transfer program per
        # source pool shape.
        self._verifies = {}
        self._rollbacks = {}
        self._transfers = {}
        self.verify_seconds = 0.0   # host wall time spent digesting
        # Cumulative REAL wall seconds spent inside decode and prefill
        # calls, the decode step timed through the host read of its
        # tokens (which waits for the card). The scheduler diffs it
        # across a tick to split tick time into device work and
        # host-loop overhead. Monotone, never reset.
        self.program_seconds = 0.0

    def _init_sharded(self, pages, dtype):
        """The kv_shards pool and caches: a :class:`ShardedPageTable` and
        each shard's local cache, allocated on its own device (shards on
        one device each get their own). Every local cache reads the
        pool's one lengths vector."""
        pps = self.t_max // self.page_size
        if self.kv_shards > pps:
            raise ValueError(
                f'kv_shards {self.kv_shards} exceeds the {pps} logical '
                f'page ordinals of t_max={self.t_max}/page_size='
                f'{self.page_size} — some shards would own an empty range')
        n_pages = (pages if pages is not None
                   else -(-self.slots * pps // self.kv_shards))
        self.pool = ShardedPageTable(self.kv_shards, n_pages, self.page_size,
                                     self.slots, pps)
        if self.device.type == 'cuda':
            count = torch.cuda.device_count()
            self.shard_devices = [torch.device('cuda', s % count)
                                  for s in range(self.kv_shards)]
        else:
            self.shard_devices = [self.device] * self.kv_shards
        shape = (self.slots, self.heads, self.t_max, self.head_dim)
        self.cache = None
        self._shard_caches = [
            init_paged_cache(*shape, pages=n_pages, page_size=self.page_size,
                             dtype=dtype, device=dev)._replace(
                                 length=self.pool.lengths)
            for dev in self.shard_devices]

    def shard_cache(self, shard):
        """Shard ``shard``'s local paged cache (kv_shards engines),
        allocated on ``shard_devices[shard]``."""
        return self._shard_caches[shard]

    @property
    def placement(self):
        """Where each shard's cache lives, as ``['cuda:0', ...]`` (one
        entry on an unsharded engine)."""
        return [str(d) for d in self.shard_devices]

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
            w = w.to(device=self.device, dtype=self.dtype).contiguous()
            if self.weight_quant == 'int8' and name != 'embed':
                w = quantize_kernel(w.t())
            setattr(self, f'_{name}', w)

    # -- the step bodies ------------------------------------------------
    def _dot(self, x, w):
        """``x (rows, in) · w`` — the one product every projection and the
        logits go through. Float weights: ``x @ w`` at the engine dtype.
        int8 weights (``w`` the ``(w_q, w_s)`` pair): the shared
        :func:`~distributed_dot_product_tpu_torch.models.dense
        .quantized_dot`, cast back to the engine dtype."""
        if self.weight_quant == 'int8':
            return quantized_dot(x, *w).to(self.dtype)
        return x @ w

    def _project(self, tokens):
        """tokens (S,) → q, k, v each (S, H, 1, D)."""
        x = self._embed[tokens]                              # (S, dim)
        shape = (tokens.shape[0], self.heads, 1, self.head_dim)
        return (self._dot(x, self._wq).reshape(shape),
                self._dot(x, self._wk).reshape(shape),
                self._dot(x, self._wv).reshape(shape))

    def _project_kv(self, tokens):
        """Chunk tokens ``(C,)`` → cache-layout k, v each ``(H, C, D)``
        — the ONE projection both prefill paths share, so shared-prefix
        pages hold exactly the K/V a slot's own prefill would."""
        x = self._embed[tokens]                              # (C, dim)
        shape = (tokens.shape[0], self.heads, self.head_dim)
        return (self._dot(x, self._wk).reshape(shape).transpose(0, 1),
                self._dot(x, self._wv).reshape(shape).transpose(0, 1))

    def _verify(self, tokens, counts, active, poison):
        """The step body of :meth:`verify_step` and, at W = 1, of
        :meth:`step`: ``tokens (S, W)`` — per slot, column 0 the committed
        input token and columns 1.. the proposals, ``counts[i]`` of the W
        real. Projections and the logits product run PER COLUMN
        with the shapes of the one-token step, so that cuBLAS takes the
        same path as a plain step, and the fused step gives each row the
        bits of its sequential step: the committed stream is the one-token
        stream bit for bit."""
        w = tokens.shape[1]
        qs, ks, vs = zip(*(self._project(tokens[:, j]) for j in range(w)))
        q, k, v = (torch.cat(x, dim=2) for x in (qs, ks, vs))
        if self.kv_shards > 1:
            # One K5p partials launch a shard on its own view, the merge
            # on the first shard's device (the host vectors are shared).
            _, out = sharded_decode_step(
                q, [self.shard_cache(s) for s in range(self.kv_shards)], k,
                v, slot_mask=active, impl=self.decode_impl)
            out = out.to(self.device)
        else:
            self.cache, out = decode_step(q, self.cache, k, v,
                                          slot_mask=active, counts=counts,
                                          impl=self.decode_impl)
        logits = torch.stack([self._dot(out[:, :, j].reshape(self.slots, -1),
                                        self._wo)
                              for j in range(w)], dim=1)   # (S, W, vocab)
        logits = torch.where(poison[:, None, None], float('nan'), logits)
        finite = slots_all_finite(logits)
        # A poisoned row's argmax input would be NaN-ordered garbage; the
        # scheduler discards non-finite slots' tokens, so the value only
        # needs to be deterministic.
        next_tok = torch.argmax(torch.where(torch.isfinite(logits), logits,
                                            float('-inf')), dim=-1)
        return next_tok, finite

    @property
    def max_verify_rows(self):
        """Most rows one :meth:`verify_step` takes: the decode kernel's K
        split — the page size on a paged engine, ``min(128, t_max)``
        columns on a slab — so that k rows span at most two blocks."""
        return (self.page_size if self.cache_mode == 'paged'
                else min(_SPLIT, self.t_max))

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
                    by_shard = (
                        f', free by shard {self.pool.free_pages_by_shard} '
                        f"— one shard's contiguous range is out of pages "
                        f'even though others have headroom'
                        if self.kv_shards > 1 else '')
                    raise RuntimeError(
                        f'page pool exhausted for slot(s) '
                        f'{np.nonzero(~ok)[0].tolist()} '
                        f'({self.pool.free_pages} pages free{by_shard}) — '
                        f'retire or evict sequences (the Scheduler ladder '
                        f'does), or size the pool larger')
            self._sync_page_table()
        ids = (tuple(r for r in (request_ids or ()) if r)
               if obs_spans.enabled() else ())
        with span('engine.decode_step', requests=ids):
            t0 = time.perf_counter()
            # The one-token step is the verify body at width 1.
            tok, finite = self._decode(
                _to_device(tokens, self.device)[:, None],
                np.ones(self.slots, np.int64), act,
                _to_device(poison, self.device, bool))
            tok = tok[:, 0]
            # The host read waits for the card: program_seconds is the
            # wall time the loop actually waits on the step.
            out = (tok.cpu().numpy().astype(np.int32), finite.cpu().numpy())
            self.program_seconds += time.perf_counter() - t0
            if self.cache_mode == 'paged':
                self.pool.lengths[act] += 1
            return out

    def _verify_program(self, w):
        """One watched verify program per width W = k+1 (a serving run
        uses ONE k, so one program)."""
        prog = self._verifies.get(w)
        if prog is None:
            from distributed_dot_product_tpu_torch.analysis.retrace import (
                watch_traces,
            )
            prog = self._verifies[w] = watch_traces(
                self._verify, f'engine.verify_w{w}', budget=2)
        return prog

    def verify_step(self, tokens, counts, active, poison=None,
                    request_ids=None):
        """One fused verify-k step for all slots: ``tokens (S, W) int`` —
        per ACTIVE slot, ``[input_token, p_1, .., p_c, pad]`` with
        ``counts[i] = c_i + 1`` rows real (1 = a plain decode riding the
        same step). Returns ``(next_tokens (S, W), finite (S,))``:
        ``next_tokens[i, j]`` is the greedy token after input row ``j`` —
        the caller accepts the longest prefix with ``p_{j+1} ==
        next_tokens[i, j]``, commits one extra token, and rolls the cache
        back to the accepted prefix (:meth:`rollback`). Rows past
        ``counts[i]`` are don't-care outputs.

        The cache appends ``counts[i]`` rows per active slot; paged
        engines reserve the pages first, raising on exhaustion (the
        Scheduler reserves through its ladder instead)."""
        if self.kv_shards > 1:
            raise ServeContractError(
                'verify_step (speculative decoding) is not supported with '
                'kv_shards > 1 — the sharded decode step is single-token; '
                'run speculative decoding on unsharded engines')
        tokens = np.asarray(tokens, np.int64)
        s, w = tokens.shape
        if s != self.slots:
            raise ServeContractError(
                f'tokens rows {s} != slots {self.slots}')
        counts = np.clip(np.asarray(counts, np.int64), 0, w)
        act = np.asarray(active, bool)
        poison = (np.zeros(self.slots, bool) if poison is None
                  else np.asarray(poison, bool))
        if self.cache_mode == 'paged':
            for i in np.nonzero(act)[0]:
                c = int(counts[i])
                if c and not self.reserve_rows(int(i), c):
                    raise RuntimeError(
                        f'page pool exhausted reserving {c} verify rows '
                        f'for slot {int(i)} ({self.pool.free_pages} pages '
                        f'free) — retire or evict sequences (the '
                        f'Scheduler ladder does), or size the pool larger')
            self._sync_page_table()
        ids = (tuple(r for r in (request_ids or ()) if r)
               if obs_spans.enabled() else ())
        with span('engine.verify_step', requests=ids, width=w):
            t0 = time.perf_counter()
            tok, finite = self._verify_program(w)(
                _to_device(tokens, self.device), counts, act,
                _to_device(poison, self.device, bool))
            out = (tok.cpu().numpy().astype(np.int32), finite.cpu().numpy())
            self.program_seconds += time.perf_counter() - t0
            if self.cache_mode == 'paged':
                self.pool.lengths[act] += counts[act]
            return out

    def rollback(self, lengths):
        """Acceptance-prefix rollback: truncate each slot to
        ``lengths[i]`` rows and zero the rejected tail —
        ``min(current, target)`` semantics, so a past-fill sentinel (e.g.
        ``np.iinfo(np.int32).max``) leaves a slot untouched and one call
        serves a mixed tick. The zeroing is bounded to a span: the
        rolled-back rows rounded up to a power of two (the reference
        compiles one program per such bucket; here the bucket only sizes
        the zeroing). Paged engines return now-empty tail pages to the
        pool (freed pages zeroed) and resync the device page table."""
        tgt = np.asarray(lengths, np.int64)
        cur = (self.pool.lengths.astype(np.int64)
               if self.cache_mode == 'paged'
               else np.asarray(self.cache.length, np.int64))
        new = np.minimum(cur, tgt)
        need = int((cur - new).max()) if cur.size else 0
        if need == 0:
            return
        bucket = 1 << (need - 1).bit_length()
        with span('engine.rollback', rows=need):
            t0 = time.perf_counter()
            self._rollback_program(bucket)(new)
            self.program_seconds += time.perf_counter() - t0
        if self.kv_shards > 1:
            freed = {}
            for i in np.nonzero(cur > new)[0]:
                for s, pgs in self.pool.truncate(int(i), int(new[i])).items():
                    freed.setdefault(s, []).extend(pgs)
            if freed:
                self._zero_freed_sharded(freed)
            self._sync_page_table()
        elif self.cache_mode == 'paged':
            freed = []
            for i in np.nonzero(cur > new)[0]:
                freed += self.pool.truncate(int(i), int(new[i]))
            if freed:
                self._zero_freed(freed)
            self._sync_page_table()

    def _rollback_program(self, span_rows):
        """One watched rollback program per span bucket (the rolled-back
        rows rounded up to a power of two: a serving run uses one or
        two)."""
        prog = self._rollbacks.get(span_rows)
        if prog is None:
            from distributed_dot_product_tpu_torch.analysis.retrace import (
                watch_traces,
            )

            def body(new):
                if self.kv_shards > 1:
                    for s in range(self.kv_shards):
                        paged_rollback_slots(self.shard_cache(s), new,
                                             span_rows)
                elif self.cache_mode == 'paged':
                    self.cache = paged_rollback_slots(self.cache, new,
                                                      span_rows)
                else:
                    self.cache = rollback_slots(self.cache, new,
                                                span=span_rows)

            prog = self._rollbacks[span_rows] = watch_traces(
                body, f'engine.rollback_s{span_rows}', budget=2)
        return prog

    def _prefill_impl(self, slot, buf, n):
        """The prefill program: project the padded chunk ``buf`` once and
        append its first ``n`` rows into ``slot`` (the chunk broadcast to
        every slot — a view; the counts mask lands it on the one slot).
        Sharded, every shard appends through its local table: a row whose
        ordinal another shard owns drops through the -1."""
        k, v = self._project_kv(_to_device(buf, self.device))
        counts = np.zeros(self.slots, np.int64)
        counts[slot] = n
        if self.kv_shards > 1:
            for s in range(self.kv_shards):
                dev = self.shard_devices[s]
                append_kv_slots(
                    self.shard_cache(s),
                    k.to(dev)[None].expand(self.slots, *k.shape),
                    v.to(dev)[None].expand(self.slots, *v.shape),
                    counts=counts)
        else:
            self.cache = append_kv_slots(
                self.cache, k[None].expand(self.slots, *k.shape),
                v[None].expand(self.slots, *v.shape), counts=counts)

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
            covered = (self.pool.covered_rows(slot) if self.kv_shards > 1
                       else int(self.pool.counts[slot]) * self.page_size)
            if pos + n > covered and not self.reserve_rows(slot, n):
                raise RuntimeError(
                    f'page pool exhausted prefilling rows [{pos}, '
                    f'{pos + n}) of slot {slot} ({self.pool.free_pages} '
                    f'pages free)')
            self._sync_page_table()
        with span('engine.prefill', slot=int(slot),
                  request=request_id or ''):
            t0 = time.perf_counter()
            self._prefill(int(slot), buf, n)
            self.program_seconds += time.perf_counter() - t0
        if self.cache_mode == 'paged':
            self.pool.lengths[slot] += n

    def _reset_impl(self, slot, freed=None):
        """The reset program: the slab zeroes ``slot``'s rows and length;
        paged, zero the freed pool pages in ``freed`` (-1-padded, the
        pool's ``pages_per_slot`` wide — ``(kv_shards, pages_per_slot)``
        on a kv_shards engine, each shard its own row) and clear
        ``slot``'s table row and length (-1 touches no slot)."""
        if self.kv_shards > 1:
            for s in range(self.kv_shards):
                paged_reset_slot(self.shard_cache(s), slot, freed[s])
        elif self.cache_mode == 'paged':
            self.cache = paged_reset_slot(self.cache, slot, freed)
        else:
            self.cache = reset_slot(self.cache, slot)

    def _freed_vectors(self, freed):
        """``freed`` pages as -1-padded vectors of the reset program's
        fixed width, as many as they fill (a rollback may free more pages
        than one slot holds)."""
        width = self.pool.pages_per_slot
        for lo in range(0, max(len(freed), 1), width):
            vec = np.full(width, -1, np.int64)
            part = freed[lo:lo + width]
            vec[:len(part)] = part
            yield vec

    def _zero_freed(self, freed, slot=-1):
        """Zero freed pool pages (and clear ``slot``'s table row and
        length when one is named; -1 touches no slot) through the ONE
        reset program."""
        for vec in self._freed_vectors(list(freed)):
            self._reset(slot, vec)
            slot = -1
        if self.checksums is not None:
            self.checksums.drop(freed)

    def _zero_freed_sharded(self, freed, slot=-1):
        """kv_shards twin of :meth:`_zero_freed`: ``freed`` is ``{shard:
        [local pages]}``; the stacked per-shard vectors go through the
        ONE reset program (each shard zeroes its own pages and clears
        ``slot``'s table row), each shard's checksum table forgets its
        own."""
        per = [list(self._freed_vectors(freed.get(s, [])))
               for s in range(self.kv_shards)]
        for j in range(max(len(v) for v in per)):
            vec = np.full((self.kv_shards, self.pool.pages_per_slot), -1,
                          np.int64)
            for s, vecs in enumerate(per):
                if j < len(vecs):
                    vec[s] = vecs[j]
            self._reset(slot, vec)
            slot = -1
        if self.checksums is not None:
            for s, pages in freed.items():
                self.checksums[s].drop(pages)

    def reset(self, slot):
        """Evict ``slot`` (zero rows + length); other slots untouched.
        Paged: drops the slot's page references and zeroes exactly the
        pages that reached refcount 0 (still-shared prefix/fork pages
        keep their bits)."""
        if self.kv_shards > 1:
            self._zero_freed_sharded(self.pool.release(slot), slot)
            self._sync_page_table()
        elif self.cache_mode == 'paged':
            self._zero_freed(self.pool.release(slot), slot)
            self._sync_page_table()
        else:
            self._reset(slot)

    def lengths(self):
        return np.array(self.pool.lengths if self.kv_shards > 1
                        else self.cache.length)

    # -- paged-pool surface (cache_mode='paged') ------------------------
    def _sync_page_table(self):
        """Copy the host table to the card when the pool changed it."""
        if self.pool.dirty:
            # Staged at once (see _to_device): the pool may change the
            # host table right after without waiting for the card.
            if self.kv_shards > 1:
                tables = torch.from_numpy(self.pool.local_tables())
                for s in range(self.kv_shards):
                    self.shard_cache(s).page_table.copy_(tables[s],
                                                         non_blocking=True)
            else:
                self.cache.page_table.copy_(
                    torch.from_numpy(self.pool.table), non_blocking=True)
            self.pool.dirty = False

    def _copy_attach_impl(self, shard, src, dst, slot, length_val):
        """The copy/attach program: copy pool page ``src`` → ``dst`` (-1
        = no copy) on shard ``shard``'s cache (0 on an unsharded engine)
        and set ``length[slot]`` (-1 = none; the shared lengths vector of
        a kv_shards engine is the host pool's)."""
        if self.kv_shards > 1:
            paged_copy_attach(self.shard_cache(shard), src, dst, slot,
                              length_val)
        else:
            self.cache = paged_copy_attach(self.cache, src, dst, slot,
                                           length_val)

    def _apply_copies(self, copies):
        """Device page copies owed by the pool: ``(src, dst)`` pairs, or
        ``(shard, src, dst)`` triples on a kv_shards engine."""
        if self.kv_shards > 1:
            for s, src, dst in copies:
                self._copy_attach(int(s), int(src), int(dst), -1, 0)
            return
        for src, dst in copies:
            self._copy_attach(0, int(src), int(dst), -1, 0)

    def _writable_mask(self, active):
        """Per active slot: does a PRIVATE page already cover its next
        append position? A slot at ``t_max`` counts as writable (nothing
        to prepare)."""
        idx = np.nonzero(active)[0]
        ok = np.ones(len(active), bool)
        if not idx.size:
            return ok
        pool = self.pool
        if self.kv_shards > 1:
            # Each slot's append ordinal routes to its owning shard's
            # table and refcounts.
            for i in idx:
                pi = int(pool.lengths[i]) // self.page_size
                if pi >= pool.pages_per_slot:
                    continue                    # full: a no-op write
                sp = pool.shards[pool.owner(pi)]
                pg = int(sp.table[i, pi])
                ok[i] = pg >= 0 and int(sp.refcount[pg]) == 1
            return ok
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
            # Sharded, the status names the shard whose range answered.
            st, *copy = self.pool.prepare_append(int(i))
            if st == 'exhausted':
                ok[i] = False
            elif st == 'cow':
                self._apply_copies([tuple(copy)])
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
        if self.kv_shards > 1:
            raise ValueError(
                'register_prefix (local prefix prefill) is not supported '
                'with kv_shards > 1 — shared prefixes arrive through the '
                'shard-local prefill→decode handoff (adopt_prefix)')
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
            self._prefix_fill(buf, len(chunk), row, start)
        return self._register_pages(pages, n)

    def _prefix_fill_impl(self, buf, count, page_row, start):
        """The registry prefill program: project one padded chunk and
        scatter its first ``count`` rows into the REGISTRY-owned
        ``page_row`` pages at logical positions ``start..`` — no slot, no
        length."""
        k, v = self._project_kv(_to_device(buf, self.device))
        self.cache = paged_append_rows(self.cache, k, v, page_row, start,
                                       count)

    def _register_pages(self, pages, n):
        """Enter ``pages`` (already allocated and filled, covering ``n``
        rows; GLOBAL ids on a kv_shards engine) into the prefix registry
        — the one place prefix ids are minted, shared by
        :meth:`register_prefix` (local prefill) and :meth:`adopt_prefix`
        (cross-cache handoff)."""
        pid = next(self._prefix_counter)
        self._prefix_registry[pid] = (list(pages), n)
        self._checksum_record(pages)
        return pid

    # -- kv_shards page ids ---------------------------------------------
    def _gpage(self, shard, page):
        """Shard-local page id → GLOBAL page id (the page's row in the
        stacked pool): the ids a kv_shards engine's host surface
        speaks."""
        return self.pool.gpage(shard, page)

    def _gsplit(self, gpage):
        """GLOBAL page id → ``(shard, local page)``."""
        return self.pool.gsplit(gpage)

    def page_shard(self, page):
        """Shard owning GLOBAL page id ``page`` on a kv_shards engine;
        None on unsharded engines."""
        if self.kv_shards <= 1:
            return None
        return self.pool.page_shard(page)

    def _by_shard(self, pages):
        """GLOBAL page ids → ``{shard: [local pages]}`` (input order
        within a shard)."""
        per = {}
        for g in pages:
            s, p = self._gsplit(g)
            per.setdefault(s, []).append(p)
        return per

    # -- page integrity (host-side, transfer boundaries only) -----------
    def _checksum_record(self, pages):
        """Digest ``pages`` as canonical now (GLOBAL ids on a kv_shards
        engine: each goes to its owning shard's table, keyed by its local
        id and digested from that shard's cache)."""
        if self.checksums is None:
            return
        t0 = time.perf_counter()
        if self.kv_shards > 1:
            for s, locs in self._by_shard(pages).items():
                self.checksums[s].record(self.shard_cache(s), locs)
        else:
            self.checksums.record(self.cache, pages)
        self.verify_seconds += time.perf_counter() - t0

    def verify_pages(self, pages=None):
        """Re-digest ``pages`` (default: every tracked page — the scrub)
        against the recorded checksums. Returns the sorted dirty-page
        list without raising; [] when clean or when checksums are
        disabled. GLOBAL ids in and out on a kv_shards engine."""
        if self.checksums is None:
            return []
        t0 = time.perf_counter()
        if self.kv_shards > 1:
            per = (self._by_shard(pages) if pages is not None
                   else {s: tab.pages()
                         for s, tab in enumerate(self.checksums)})
            bad = sorted(self._gpage(s, p) for s, locs in per.items()
                         for p in self.checksums[s].verify(
                             self.shard_cache(s), locs))
        else:
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
            shards = ([self.page_shard(p) for p in bad]
                      if self.kv_shards > 1 else None)
            raise PageCorruptionError(bad, site, shards=shards)

    def quarantine_pages(self, pages):
        """Withdraw dirty pages from circulation (they never return to
        the free list) and forget their digests. Returns the pages newly
        quarantined (GLOBAL ids in and out on a kv_shards engine, each
        routed to its owning shard)."""
        if self.kv_shards > 1:
            newly = []
            for s, locs in self._by_shard(pages).items():
                if self.checksums is not None:
                    self.checksums[s].drop(locs)
                newly += [self._gpage(s, p)
                          for p in self.pool.quarantine(s, locs)]
            return sorted(newly)
        if self.checksums is not None:
            self.checksums.drop(pages)
        return self.pool.quarantine(pages)

    def slots_sharing(self, pages):
        """Slots whose page tables name any of ``pages`` (GLOBAL ids on a
        kv_shards engine, looked up in each owning shard's table) — the
        live victims of a corruption verdict."""
        if self.pool is None:
            return []
        if self.kv_shards > 1:
            per = {s: set(locs) for s, locs in self._by_shard(pages).items()}
            hit = []
            for slot in range(self.slots):
                for s, locs in per.items():
                    sp = self.pool.shards[s]
                    if any(int(sp.table[slot, i]) in locs
                           for i in range(int(sp.counts[slot]))):
                        hit.append(slot)
                        break
            return hit
        bad = {int(p) for p in pages}
        return [slot for slot in range(self.slots)
                if any(int(self.pool.table[slot, i]) in bad
                       for i in range(int(self.pool.counts[slot])))]

    def prefixes_on(self, pages):
        """Registered prefix ids built on any of ``pages`` — the entries a
        corruption verdict must invalidate."""
        bad = {int(p) for p in pages}
        return [pid for pid, (pgs, _) in self._prefix_registry.items()
                if bad.intersection(int(p) for p in pgs)]

    def adopt_prefix(self, src_cache, src_pages, length, src_checksums=None):
        """The prefill→decode KV handoff (disaggregated serving): copy
        ``length`` rows living in ``src_pages`` of ANOTHER paged cache (a
        prefill pool's — same page size and head geometry, its own pool
        size, on any device) into freshly allocated pages of THIS engine's
        pool and register them as a shared prefix. The transfer unit is
        the whole page, exactly what :meth:`register_prefix` produces, so
        a sequence started with :meth:`start_with_prefix` cannot tell a
        handed-off prefix from a locally prefilled one. Raises
        ``RuntimeError`` on pool exhaustion (the router checks headroom
        first) and ``ValueError`` on a geometry, length or page-count
        mismatch.

        ``src_checksums`` (the source pool's :class:`PageChecksums`) makes
        the handoff end-to-end verifiable: the source pages are verified
        BEFORE the transfer (dirty source → :class:`PageCorruptionError`
        at site ``'handoff_src'``) and the landed copies' KV digests are
        compared with the source's AFTER (a corrupted transfer → site
        ``'handoff_copy'``, the adopted prefix unregistered — never handed
        to a caller). Only the KV digest crosses caches: the destination's
        int8 mirror is re-quantized from the adopted K. A kv_shards engine
        adopts shard-locally (:meth:`_adopt_prefix_sharded`)."""
        if self.cache_mode != 'paged':
            raise ValueError("prefix adoption needs cache_mode='paged'")
        if src_cache.page_size != self.page_size:
            raise ValueError(
                f'page-size mismatch: source {src_cache.page_size} vs '
                f'{self.page_size} — the page is the transfer unit, both '
                f'pools must agree')
        local = self.cache if self.kv_shards == 1 else self.shard_cache(0)
        if (src_cache.k_pool.shape[1:] != local.k_pool.shape[1:]
                or src_cache.v_pool.shape[1:] != local.v_pool.shape[1:]):
            raise ValueError(
                f'KV geometry mismatch: source pages '
                f'{tuple(src_cache.k_pool.shape[1:])} vs '
                f'{tuple(local.k_pool.shape[1:])}')
        if length < 1 or length + 1 > self.t_max:
            raise ValueError(f'prefix of {length} rows leaves no room to '
                             f'generate in a t_max={self.t_max} cache')
        src_pages = [int(p) for p in src_pages]
        needed = self.pool.pages_for_rows(length)
        if len(src_pages) != needed:
            raise ValueError(f'{len(src_pages)} source pages for {length} '
                             f'rows (need {needed})')
        if src_checksums is not None:
            t0 = time.perf_counter()
            bad = src_checksums.verify(src_cache, src_pages)
            self.verify_seconds += time.perf_counter() - t0
            if bad:
                raise PageCorruptionError(bad, 'handoff_src')
        if self.kv_shards > 1:
            return self._adopt_prefix_sharded(src_cache, src_pages, length,
                                              src_checksums, needed)
        pages = self.pool.alloc_block(needed)
        if pages is None:
            raise RuntimeError(
                f'page pool exhausted adopting a {length}-row prefix '
                f'({needed} pages needed, {self.pool.free_pages} free)')
        # Fixed-width -1-padded vectors: one transfer program per source
        # pool shape, whatever the prefix length.
        width = max(self.pool.pages_per_slot, needed)
        vec_src = np.full(width, -1, np.int64)
        vec_dst = np.full(width, -1, np.int64)
        vec_src[:needed] = src_pages
        vec_dst[:needed] = pages
        self._transfer_program(0, src_cache.k_pool, src_cache.v_pool,
                               vec_src, vec_dst)
        pid = self._register_pages(pages, length)
        if self.checksums is not None and src_checksums is not None:
            # Landed-copy verification: whole pages move (unfilled tail
            # rows are zero on both sides), so the KV digest must survive
            # the copy bit for bit.
            bad = [dp for sp, dp in zip(src_pages, pages)
                   if self._digest_differs(src_checksums.get(sp),
                                           self.checksums.get(dp))]
            if bad:
                self.unregister_prefix(pid)
                raise PageCorruptionError(bad, 'handoff_copy')
        return pid

    def _transfer_program(self, shard, src_k, src_v, vec_src, vec_dst):
        """Copy the source pages ``vec_src`` of another cache's pools into
        ``vec_dst`` of shard ``shard``'s cache (0 unsharded; vectors
        -1-padded to a fixed width) through the watched transfer program
        of that source pool shape."""
        key = (tuple(src_k.shape), tuple(src_v.shape), len(vec_src))
        prog = self._transfers.get(key)
        if prog is None:
            from distributed_dot_product_tpu_torch.analysis.retrace import (
                watch_traces,
            )

            def body(shard, src_k, src_v, vec_src, vec_dst):
                cache = (self.shard_cache(shard) if self.kv_shards > 1
                         else self.cache)
                paged_transfer_pages(cache, src_k, src_v, vec_src, vec_dst)

            prog = self._transfers[key] = watch_traces(
                body, 'engine.adopt', budget=2)
        prog(shard, src_k, src_v, vec_src, vec_dst)

    @staticmethod
    def _digest_differs(want, have):
        """Landed-copy verdict: both KV digests known and unequal."""
        return want is not None and have is not None and have[0] != want[0]

    def _adopt_prefix_sharded(self, src_cache, src_pages, length,
                              src_checksums, needed):
        """kv_shards tail of :meth:`adopt_prefix` (validation and the
        source verify already ran): allocate, per shard, exactly the pages
        covering the ordinals that shard OWNS
        (:meth:`~distributed_dot_product_tpu_torch.models.decode
        .ShardedPageTable.owned_range`), then copy into each shard's own
        cache only its own ordinals' source pages — the shard-local
        handoff, page-granular, with no full-sequence gather anywhere.
        All-or-nothing allocation: any shard's exhaustion rolls the other
        shards' fresh blocks back. Landed digests are compared per owning
        shard."""
        alloc = {}                       # shard -> local pages, by ordinal
        for s in range(self.kv_shards):
            lo, hi = self.pool.owned_range(s)
            k = max(0, min(hi, needed) - lo)
            if k == 0:
                continue
            pgs = self.pool.shards[s].alloc_block(k)
            if pgs is None:
                for s2, got in alloc.items():
                    self.pool.shards[s2].release_pages(got)
                raise RuntimeError(
                    f'page pool exhausted adopting a {length}-row prefix: '
                    f'shard {s} has {self.pool.shards[s].free_pages} of the '
                    f'{k} pages its ordinal range [{lo}, {min(hi, needed)}) '
                    f'needs (free by shard {self.pool.free_pages_by_shard})')
            alloc[s] = pgs
        gpages = [0] * needed
        for s, pgs in alloc.items():
            lo, _ = self.pool.owned_range(s)
            width = self.pool.pages_per_slot
            vec_src = np.full(width, -1, np.int64)
            vec_dst = np.full(width, -1, np.int64)
            vec_src[:len(pgs)] = src_pages[lo:lo + len(pgs)]
            vec_dst[:len(pgs)] = pgs
            self._transfer_program(s, src_cache.k_pool, src_cache.v_pool,
                                   vec_src, vec_dst)
            for j, p in enumerate(pgs):
                gpages[lo + j] = self._gpage(s, p)
        pid = self._register_pages(gpages, length)
        if self.checksums is not None and src_checksums is not None:
            bad = []
            for o, g in enumerate(gpages):
                s, p = self._gsplit(g)
                if self._digest_differs(src_checksums.get(src_pages[o]),
                                        self.checksums[s].get(p)):
                    bad.append(g)
            if bad:
                self.unregister_prefix(pid)
                raise PageCorruptionError(
                    bad, 'handoff_copy',
                    shards=[self.page_shard(g) for g in bad])
        return pid

    def prefix_length(self, prefix_id):
        return self._prefix_registry[prefix_id][1]

    def unregister_prefix(self, prefix_id):
        """Release the registry's page references; pages still shared
        by live sequences survive until those retire (each shard frees
        and zeroes its own on a kv_shards engine)."""
        pages, _ = self._prefix_registry.pop(prefix_id)
        if self.kv_shards > 1:
            freed = {}
            for s, locs in self._by_shard(pages).items():
                got = self.pool.release_pages_on(s, locs)
                if got:
                    freed[s] = got
            if freed:
                self._zero_freed_sharded(freed)
            return
        freed = self.pool.release_pages(pages)
        if freed:
            self._zero_freed(freed)

    def start_with_prefix(self, slot, prefix_id):
        """Point an EMPTY slot at a registered prefix: full pages shared
        (refcount++), partial tail page copied private, length set.
        False = pool exhausted. The prefix's pages are verified first. A
        kv_shards engine attaches per owning shard (the tail copy lands on
        the tail ordinal's owner)."""
        pages, plen = self._prefix_registry[prefix_id]
        self.check_pages(pages, 'attach')
        if self.kv_shards > 1:
            ord_pages = np.full(self.pool.pages_per_slot, -1, np.int64)
            for o, g in enumerate(pages):
                ord_pages[o] = self._gsplit(g)[1]
            ok, tsh, tsrc, tdst = self.pool.attach(slot, ord_pages, plen)
            if not ok:
                return False
            if tsh >= 0:
                # The shared lengths vector already holds plen.
                self._copy_attach(int(tsh), int(tsrc), int(tdst), -1, 0)
            self._sync_page_table()
            return True
        ok, src, dst = self.pool.attach(slot, pages, plen)
        if not ok:
            return False
        self._copy_attach(0, int(src), int(dst), int(slot), int(plen))
        self._sync_page_table()
        return True

    def fork_slot(self, src, dst):
        """Copy-on-write fork: ``dst`` (an empty slot) shares ``src``'s
        full pages and gets a private copy of the partial tail page.
        False = pool exhausted. The source's tracked pages are verified
        before the branch shares them."""
        if self.kv_shards > 1:
            raise ValueError(
                'fork_slot (copy-on-write forks) is not supported with '
                'kv_shards > 1 — run parallel sampling on unsharded '
                'engines')
        if self.checksums is not None:
            shared = [int(self.pool.table[src, i])
                      for i in range(int(self.pool.counts[src]))]
            self.check_pages(shared, 'fork')
        ok, tail_src, tail_dst = self.pool.fork(src, dst)
        if not ok:
            return False
        self._copy_attach(0, int(tail_src), int(tail_dst), int(dst),
                          int(self.pool.lengths[dst]))
        self._sync_page_table()
        return True

    @property
    def weight_bytes(self):
        """Bytes of the four projection/head matrices a decode step
        streams (int8 engines count the int8 matrices and their scales);
        the embedding is gathered, not streamed."""
        return dense_param_bytes([self._wq, self._wk, self._wv, self._wo])

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
        out = {'pages': pool.pages, 'pages_used': pool.used_pages,
               'pages_free': pool.free_pages,
               'shared_pages': pool.shared_pages,
               'page_size': pool.page_size,
               'pages_quarantined': len(pool.quarantined)}
        if self.kv_shards > 1:
            # The per-shard free vector shows one shard's range running
            # dry while the aggregate still looks healthy.
            out['kv_shards'] = self.kv_shards
            out['pages_free_by_shard'] = pool.free_pages_by_shard
        return out

    def tracked_pages(self):
        """Registry-tracked pages, sorted (GLOBAL ids on kv_shards
        engines) — the population a corruption drill indexes, so a seeded
        run corrupts the same prefix page whatever the pool's allocation
        history."""
        return sorted({int(p) for pages, _ in self._prefix_registry.values()
                       for p in pages})

    def flip_page_bit(self, page):
        """Flip an exponent bit of ``page``'s K pool bytes (byte 3 of the
        page, in place on the device) — the corruption primitive the
        integrity tests use; an undetected flip changes delivered
        tokens. A kv_shards engine takes the GLOBAL id and flips the page
        in its owning shard's pool."""
        if self.kv_shards > 1:
            shard, page = self._gsplit(page)
            k_pool = self.shard_cache(shard).k_pool
        else:
            k_pool = self.cache.k_pool
        raw = k_pool[int(page)].view(-1).view(torch.uint8)
        raw[3] ^= 0x40


def _engine_spec(name, eng, wrap=None):
    """A registry spec of ``eng``'s batched decode step (the step body
    every tick runs): every slot active, from the state the builder left
    — the step advances the cache's lengths, so each call starts again
    from that state (``wrap``: a context around the call). The step
    returns ``(cache, tokens, finite)``, as the reference's program does:
    the cache it appended in place (every shard's, on a kv_shards
    engine)."""
    import contextlib

    from distributed_dot_product_tpu_torch.analysis.registry import (
        TraceSpec,
    )
    dev = eng.device
    tokens = torch.zeros((eng.slots, 1), dtype=torch.int64, device=dev)
    counts = np.ones(eng.slots, np.int64)
    active = np.ones(eng.slots, bool)
    poison = torch.zeros(eng.slots, dtype=torch.bool, device=dev)
    sharded = eng.kv_shards > 1
    cache = ([eng.shard_cache(s) for s in range(eng.kv_shards)] if sharded
             else eng.cache)

    def fn(cache, tokens, counts, active, poison):
        if not sharded:
            eng.cache = cache
        with (wrap() if wrap else contextlib.nullcontext()):
            # The watched decode program (analysis/retrace.py), as
            # the reference's entry runs its jitted one.
            tok, finite = eng._decode(tokens, counts, active, poison)
        return (cache if sharded else eng.cache), tok, finite

    pools = ('k_pool', 'v_pool') if eng.cache_mode == 'paged' else ('k', 'v')
    return TraceSpec(
        name=name, fn=fn, args=(cache, tokens, counts, active, poison),
        prejitted=True, mesh_axes=('seq',) if sharded else (),
        cache_in=None if sharded else (
            lambda a: [getattr(a[0], f) for f in pools]),
        cache_out=None if sharded else (
            lambda o: [getattr(o[0], f) for f in pools]),
        expect_donation=True, min_donated=2)


def graphlint_entrypoints():
    """Registration hook (``analysis/registry.py``): the serving engine's
    batched decode step — the body the continuous-batching scheduler
    runs per tick — slab, paged, with int8 weights and over a 2-way
    sequence-sharded page table, on the plain decode path (the
    reference's ``'xla'``), float32."""

    def _engine(device, **kw):
        from distributed_dot_product_tpu_torch.analysis.registry import (
            HEAD_DIM,
        )
        eng = KernelEngine(slots=2, head_dim=HEAD_DIM, decode_impl='plain',
                           device=device, **kw)
        if eng.cache_mode == 'paged':
            if not eng.prepare_step(np.ones(2, bool)).all():
                raise RuntimeError('the example pool is too small')
        return eng

    def engine_decode(device):
        return _engine_spec('serve.engine_decode',
                            _engine(device, t_max=16, cache_mode='slab'))

    def engine_decode_paged(device):
        return _engine_spec('serve.engine_decode_paged', _engine(
            device, t_max=16, cache_mode='paged', page_size=8, pages=3))

    def engine_decode_wq8(device):
        return _engine_spec('serve.engine_decode_wq8', _engine(
            device, t_max=16, cache_mode='slab', weight_quant='int8'))

    def engine_decode_kv_sharded(device):
        return _engine_spec('serve.engine_decode_kv_sharded', _engine(
            device, t_max=32, cache_mode='paged', page_size=8, pages=3,
            kv_shards=2))

    return {'serve.engine_decode': engine_decode,
            'serve.engine_decode_paged': engine_decode_paged,
            'serve.engine_decode_wq8': engine_decode_wq8,
            'serve.engine_decode_kv_sharded': engine_decode_kv_sharded}
