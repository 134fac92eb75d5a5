# -*- coding: utf-8 -*-
"""
Continuous-batching decode scheduler — the serving loop that keeps the
compiled decode step full and survives the traffic that tries to kill
it.

Design (the standard continuous-batching shape, scaled to this repo's
kernels): the engine owns ``S`` fixed decode slots over ONE donated
per-slot KV cache (``models/decode.py``: ``init_slot_cache`` /
``append_kv_slots`` / per-slot-masked ``decode_attention``). Every tick:

1. **Admit**: free slots pull from the bounded admission queue
   (``admission.py`` — typed rejection, deadlines, token budgets,
   degradation). Requests that expired while queued are finalized with
   a typed reason, never silently dropped.
2. **Chunked prefill**: each prefilling slot appends ONE prompt chunk
   (``engine.prefill_chunk`` wide) between decode steps, so a long
   prompt interleaves with live decoding instead of stalling it. The
   prompt's last token then enters the decode step like any other
   input token — same compiled program end to end.
3. **Decode**: one batched step for ALL active slots. The per-slot
   all-finite verdict comes back with the tokens; a non-finite slot is
   **quarantined** (slot reset + request requeued from scratch, bounded
   by ``max_requeues``) while every other slot's stream continues
   bit-identically — one poisoned sequence must not fail the batch.
4. **Retire**: completed / expired / abandoned sequences free their
   slot (``reset_slot`` — zero rows, no reallocation).

Failure-handling ladder at submit, in order: admit → admit degraded
(token budget capped under queue pressure) → evict the longest-idle
running sequence and admit → reject with typed ``QUEUE_FULL``.

Paged engines (``cache_mode='paged'``) plug PAGE EXHAUSTION into the
same ladder: pool pressure degrades budgets like queue pressure,
admission reserves a request's prompt pages up front (head-of-line
waits when the pool is full), a mid-stream page deficit first evicts
the longest-idle OTHER slot and then preempts/requeues the needy one
(typed ``CACHE_EXHAUSTED`` once retries are spent), and requests can
ride registered shared prefixes (``submit(prefix_id=...)``) or fork
mid-stream (:meth:`Scheduler.fork`). Occupancy gauges
(``serve.cache.pages_used/pages_free/shared_pages``) refresh per tick.

Liveness is judged OUTSIDE the loop: the scheduler heartbeats the
:class:`~distributed_dot_product_tpu_torch.serve.health.HealthMonitor` every
tick and a watchdog thread flags a stuck compiled step (no heartbeat)
as STALLED/NOT_READY; the first post-stall tick restores READY.

Fault injection (``utils/faults.py`` ``ServeFaultInjector``, or the
``DDP_TPU_FAULT_STUCK_STEP`` / ``..._NAN_DECODE_STEP`` /
``..._ABANDON_REQUEST`` env knobs when none is passed) drives every one
of these paths deterministically in CPU tests.

Copied from ``distributed_dot_product_tpu/serve/scheduler.py``. Not
ported yet (ROADMAP): speculative decoding, the scheduling policy, the
anomaly watchdog, the adaptive profiler captures and the router /
controller hooks (``load``, ``drain``, ``expel``, ``set_watermark``,
``set_queue_limit``); the matching ``ServeConfig`` fields do not exist,
so setting one raises ``TypeError``.
"""

import dataclasses
import enum
import time
from typing import Callable, Dict, Optional

import numpy as np

from distributed_dot_product_tpu_torch.obs import events as obs_events
from distributed_dot_product_tpu_torch.obs import flight as obs_flight
from distributed_dot_product_tpu_torch.obs import spans as obs_spans
from distributed_dot_product_tpu_torch.obs.spans import span
from distributed_dot_product_tpu_torch.serve.admission import (
    AdmissionController, RejectedError, RejectReason, Request,
    RequestResult,
)
from distributed_dot_product_tpu_torch.serve.engine import PageCorruptionError
from distributed_dot_product_tpu_torch.serve.errors import ServeContractError
from distributed_dot_product_tpu_torch.serve.health import (
    HealthMonitor, Liveness, Readiness,
)
from distributed_dot_product_tpu_torch.utils import faults as faults_lib
from distributed_dot_product_tpu_torch.utils import tracing

__all__ = ['ServeConfig', 'Scheduler']

@dataclasses.dataclass
class ServeConfig:
    """Knobs of the serving loop. ``queue_limit``/``max_new_tokens``/
    ``degrade_watermark``/``degraded_max_new_tokens`` parameterize
    admission (see admission.py). ``evict_before_reject``: try freeing
    the longest-idle slot (idle ≥ ``min_evict_idle`` seconds) before
    shedding a submit with QUEUE_FULL. ``max_requeues`` bounds
    NaN-quarantine retries per request. ``stall_timeout`` is the
    watchdog's no-heartbeat threshold (``watchdog=False`` disables the
    thread — e.g. under a virtual clock that would never beat in real
    time)."""
    queue_limit: int = 8
    max_new_tokens: int = 16
    degrade_watermark: float = 0.75
    degraded_max_new_tokens: Optional[int] = None
    evict_before_reject: bool = True
    min_evict_idle: float = 0.0
    max_requeues: int = 2
    eos_id: Optional[int] = None
    stall_timeout: float = 2.0
    watchdog: bool = True
    watchdog_poll: Optional[float] = None
    # Incident flight recorder (obs/flight.py — resolved process-wide
    # at trigger time, like the active event log): auto-dump a
    # post-mortem bundle on a watchdog stall, on an unhandled
    # scheduler-loop exception, and on a NaN-quarantine storm
    # (`flight_nan_storm` quarantines within `flight_nan_window`
    # decode steps). All no-ops while no recorder is installed.
    flight_dump_on_stall: bool = True
    flight_dump_on_exception: bool = True
    flight_nan_storm: int = 3
    flight_nan_window: int = 20


class _SlotState(enum.Enum):
    FREE = 'free'
    PREFILL = 'prefill'
    ACTIVE = 'active'


@dataclasses.dataclass
class _Slot:
    index: int
    state: _SlotState = _SlotState.FREE
    request: Optional[Request] = None
    prefill_pos: int = 0
    input_token: int = 0
    produced: int = 0
    last_progress: float = 0.0
    last_token_at: Optional[float] = None   # per-token latency anchor


class Scheduler:
    """Drive ``engine`` (a :class:`~distributed_dot_product_tpu_torch.serve
    .engine.KernelEngine` or anything with its surface) under the
    policy in ``config``.

    Usage::

        sched = Scheduler(KernelEngine(slots=4, t_max=256), ServeConfig())
        try:
            req = sched.submit(prompt, max_new_tokens=32,
                               deadline=clock() + 1.0)
        except RejectedError as e:
            ...                       # e.reason is typed
        sched.run_until_idle()
        sched.results[req.id]         # RequestResult
        sched.close()

    ``clock`` is the deadline/idleness clock (injectable — tests run
    virtual time); the watchdog always measures real time.
    ``on_tick(scheduler)`` runs at the end of every tick (tests advance
    their virtual clock there)."""

    def __init__(self, engine, config: Optional[ServeConfig] = None, *,
                 fault_injector=None, clock=time.monotonic,
                 registry: Optional[tracing.MetricsRegistry] = None,
                 health: Optional[HealthMonitor] = None,
                 on_tick: Optional[Callable] = None, event_log=None):
        self.engine = engine
        # Paged engines gate admission by FREE PAGES, not free slots,
        # and join page exhaustion into the degrade→evict→reject
        # ladder (plus the mid-stream preemption rung in _ensure_pages).
        self._paged = getattr(engine, 'cache_mode', 'slab') == 'paged'
        self.cfg = config or ServeConfig()
        self.clock = clock
        self.on_tick = on_tick
        self.registry = registry or tracing.get_registry()
        # Observability event sink: an explicit EventLog, or (when None)
        # whatever log is ACTIVE at emit time (obs/events.py) — so
        # `with obs.activate(log):` instruments an existing scheduler.
        self.event_log = event_log
        self.admission = AdmissionController(
            queue_limit=self.cfg.queue_limit, t_max=engine.t_max,
            max_new_tokens=self.cfg.max_new_tokens,
            degrade_watermark=self.cfg.degrade_watermark,
            degraded_max_new_tokens=self.cfg.degraded_max_new_tokens,
            clock=clock, registry=self.registry, event_log=event_log,
            capacity_tokens=(engine.capacity_tokens if self._paged
                             else None))
        # None = "consult the env knobs" (a shell faults a real run);
        # False = explicitly unfaulted even when knobs are set (the
        # clean reference run a fault-isolation audit compares against).
        if fault_injector is None:
            plan = faults_lib.serve_plan_from_env()
            fault_injector = (faults_lib.ServeFaultInjector(plan)
                              if plan.any() else None)
        self.injector = fault_injector or None
        if self.injector is not None and event_log is not None \
                and getattr(self.injector, 'event_log', None) is None:
            # Injections land in the same stream as the lifecycle they
            # disrupt (the injector alone can't know the sink).
            self.injector.event_log = event_log
        self.health = health or HealthMonitor(
            stall_timeout=self.cfg.stall_timeout,
            poll_interval=self.cfg.watchdog_poll, registry=self.registry,
            event_log=event_log)
        # Incident wiring: the watchdog's dangling on_stall hook now
        # drives the flight recorder — a stall's post-mortem bundle is
        # written WHILE the loop is wedged (the watchdog thread runs
        # free), capturing the stuck thread's stack. Never stomps a
        # caller-installed callback (mirror of the injector.event_log
        # rule).
        if self.cfg.flight_dump_on_stall and self.health.on_stall is None:
            self.health.on_stall = self._on_stall
        if self.cfg.watchdog:
            self.health.start()
        self._slots = [_Slot(i) for i in range(engine.slots)]
        self.results: Dict[str, RequestResult] = {}
        self._step_idx = 0
        self._admit_counter = 0
        self._closed = False
        reg = self.registry
        self._c = {name: reg.counter(f'serve.{name}') for name in
                   ('completed', 'evicted', 'nan_quarantined', 'requeued',
                    'abandoned', 'deadline_expired', 'failed',
                    'decode_steps', 'tokens_generated')}
        self._g_active = reg.gauge('serve.active_slots')
        if self._paged:
            # Cache-occupancy surface (tick-refreshed, /metrics-
            # rendered): pool fill, free headroom, and the sharing win
            # (pages referenced more than once). The histogram records
            # pages held per request at retirement.
            self._c_preempted = reg.counter('serve.cache_preempted')
            self._g_pages_used = reg.gauge('serve.cache.pages_used')
            self._g_pages_free = reg.gauge('serve.cache.pages_free')
            self._g_shared = reg.gauge('serve.cache.shared_pages')
            self._h_req_pages = reg.histogram(
                'serve.cache.request_pages', buckets=())
        self._h_step = reg.histogram('serve.step_seconds')
        # Dispatch-floor split (ROADMAP item 5): per decode tick, REAL
        # tick wall time partitions into device-program seconds (the
        # engine.program_seconds delta across the tick) and host-loop
        # overhead — the ~0.212 ms/step floor multi-tick decode would
        # attack. Mirrored per tick into serve.dispatch events so the
        # split survives in the JSONL (obs critpath reads it back).
        self._h_device = reg.histogram('serve.device_seconds')
        self._h_dispatch = reg.histogram(
            'serve.dispatch_overhead_seconds')
        # Device seconds of the CURRENT tick's decode/verify dispatch,
        # set right after the program returns and cleared at tick end —
        # _commit_token stamps it on every serve.decode it emits (the
        # per-token device share, additive field).
        self._tick_device = None
        # Request-timeline histograms: the latency decomposition a
        # continuous-batching server is judged by. All measured on the
        # scheduler's own clock and ALSO stamped into the event log, so
        # `obs.timeline(request_id)` reconstructs the same numbers.
        self._h_queue = reg.histogram('serve.queue_wait_seconds')
        self._h_ttft = reg.histogram('serve.ttft_seconds')
        self._h_token = reg.histogram('serve.token_seconds')
        self._h_request = reg.histogram('serve.request_seconds')
        # Tenant-labeled twins of the latency histograms, created
        # lazily per tenant seen and cached here (registry get-or-
        # create takes a lock — not a per-token cost we want).
        self._tenant_series: Dict[tuple, object] = {}
        # NaN-quarantine storm window: decode-step indices of recent
        # quarantines — `flight_nan_storm` of them within
        # `flight_nan_window` steps triggers one post-mortem dump.
        self._quarantine_steps = []
        # Every post-mortem bundle (including an HTTP /dump with no
        # scheduler in hand) embeds this scheduler's introspection.
        # ONE bound-method object, captured here: attribute access
        # mints a fresh one each time, which would break the
        # ownership check in remove_provider at close() (the same
        # identity rule FaultInjector._hook documents).
        self._introspection_hook = self.introspection
        obs_flight.add_provider('scheduler', self._introspection_hook)

    def _tenant_hist(self, name, tenant):
        """The ``tenant=``-labeled series of a latency family — same
        family name as the aggregate, so /metrics renders per-tenant
        quantiles/buckets an external Prometheus can alert on."""
        key = (name, tenant)
        h = self._tenant_series.get(key)
        if h is None:
            h = self._tenant_series[key] = self.registry.histogram(
                name, labels={'tenant': tenant})
        return h

    def _emit(self, event, **fields):
        """Into the explicit event log, else the active one, else
        nowhere (one None-check when observability is off)."""
        log = (self.event_log if self.event_log is not None
               else obs_events.get_active())
        if log is not None:
            log.emit(event, **fields)

    # -- incident flight recorder (obs/flight.py) ----------------------
    def introspection(self):
        """Point-in-time scheduler state for a post-mortem bundle:
        the slot table, queue depth, step index, engine cache stats.
        Read WITHOUT locks — this runs from the watchdog thread while
        the loop may be wedged mid-step, and a slightly torn view of
        host bookkeeping beats a dump that deadlocks."""
        slots = []
        for slot in self._slots:
            req = slot.request
            slots.append({
                'index': slot.index, 'state': slot.state.value,
                'request_id': req.id if req is not None else None,
                'tenant': req.tenant if req is not None else None,
                'produced': slot.produced,
                'prefill_pos': slot.prefill_pos,
                'requeues': req.requeues if req is not None else None,
                'last_progress': slot.last_progress,
            })
        out = {
            'step_idx': self._step_idx,
            'queue_depth': self.admission.depth,
            'queue_limit': self.cfg.queue_limit,
            'slots': slots,
            'results': len(self.results),
            'liveness': self.health.liveness.value,
            'readiness': self.health.readiness.value,
            'last_beat_age_s': self.health.last_beat_age(),
            'cache_mode': getattr(self.engine, 'cache_mode', 'slab'),
        }
        try:
            out['cache_stats'] = self.engine.cache_stats()
        except (AttributeError, TypeError):
            # An engine without the introspection surface is fine.
            out['cache_stats'] = None
        return out

    def _flight_dump(self, trigger, reason=''):
        """One rate-limited post-mortem bundle through the process
        flight recorder (no-op while none is installed — checked
        BEFORE building the introspection section, so the disabled
        path never materializes it). Never raises: the black box must
        not take down the loop it is recording."""
        rec = obs_flight.get_recorder()
        if rec is None:
            return None
        try:
            return rec.maybe_dump(
                trigger=trigger, reason=reason,
                sections={'scheduler': self.introspection()})
        except Exception as e:
            tracing.log_exception('scheduler.flight_dump', e,
                                  registry=self.registry)
            return None

    def _on_stall(self):
        """Watchdog-thread stall callback: dump the black box WHILE
        the loop is stuck (the bundle's stacks.json shows where)."""
        age = self.health.last_beat_age()
        self._flight_dump(
            'stall',
            reason=f'no heartbeat for '
                   f'{age:.2f}s (timeout {self.cfg.stall_timeout:.2f}s)'
                   if age is not None else 'watchdog stall')

    # -- submission surface --------------------------------------------
    def submit(self, prompt, *, max_new_tokens=None, deadline=None,
               request_id=None, prefix_id=None, tenant=None) -> Request:
        """Admit one request or raise a typed
        :class:`~distributed_dot_product_tpu_torch.serve.admission
        .RejectedError`. Applies the full backpressure ladder (degrade →
        evict → reject). ``prefix_id`` (paged engines): a registered
        shared prefix the prompt CONTINUES — its pages are shared, the
        budget math covers prefix + prompt. ``tenant`` labels the
        request for multi-tenant accounting (admit/reject events,
        tenant-labeled metrics; default tenant ``'default'``)."""
        if prefix_id is not None and not self._paged:
            raise ServeContractError(
                "prefix_id needs a paged engine (cache_mode='paged')")
        req = Request(prompt=prompt,
                      max_new_tokens=max_new_tokens
                      or self.cfg.max_new_tokens,
                      deadline=deadline, id=request_id or '',
                      prefix_id=prefix_id, tenant=tenant or 'default')
        req.submitted_at = self.clock()
        try:
            if prefix_id is not None:
                try:
                    req.prefix_len = self.engine.prefix_length(
                        prefix_id)
                except KeyError:
                    self.admission.reject(
                        RejectReason.PREFIX_UNREGISTERED,
                        f'request {req.id}: prefix id {prefix_id!r} '
                        f'is not registered', request_id=req.id,
                        tenant=req.tenant)
            self.admission.validate(req)
            pressure, source = self._pressure_info()
            self.admission.maybe_degrade(req, pressure=pressure,
                                         reason=source)
            if self.admission.full and self.cfg.evict_before_reject:
                # Freeing a slot lets a queued request promote out of
                # the queue, which is what makes room for this one.
                if self._evict_longest_idle():
                    self._admit_into_free_slots()
            self.admission.push(req)
        finally:
            self._update_readiness()
        return req

    def cancel(self, request_id):
        """Mid-stream client abandon: the request's slot frees at the
        next tick (queued requests resolve when they reach the head).
        Returns False for an unknown/already-finished id."""
        for slot in self._slots:
            if slot.request is not None \
                    and slot.request.id == request_id:
                slot.request.cancelled = True
                return True
        for req in list(self.admission._queue):
            if req.id == request_id:
                req.cancelled = True
                return True
        return False

    # -- scheduling internals ------------------------------------------
    def _finalize_request(self, req: Request, status,
                          reason: Optional[RejectReason] = None):
        finished_at = self.clock()
        total = max(0.0, finished_at - req.submitted_at)
        self._h_request.observe(total)
        if status == 'rejected':
            # Shed while queued: the timeline ends in a typed reject,
            # never a retire (it never held a slot).
            self._emit('serve.reject', request_id=req.id,
                       reason=reason.value if reason else None,
                       queued=True, total_seconds=total,
                       tenant=req.tenant)
        else:
            self._emit('serve.retire', request_id=req.id, status=status,
                       reason=reason.value if reason else None,
                       tokens=len(req.tokens), total_seconds=total,
                       tenant=req.tenant)
        self.results[req.id] = RequestResult(
            id=req.id, status=status, tokens=list(req.tokens),
            prompt_len=len(req.prompt), reason=reason,
            requeues=req.requeues, degraded=req.degraded,
            finished_at=finished_at, tenant=req.tenant)

    def _observe_slot_pages(self, slot: _Slot):
        if self._paged:
            self._h_req_pages.observe(self.engine.slot_pages(slot.index))

    def _finish(self, slot: _Slot, status,
                reason: Optional[RejectReason] = None):
        """Retire a slot's request with a terminal status and free the
        slot (rows zeroed — the next sequence starts clean)."""
        if status == 'evicted':
            self._emit('serve.evict', request_id=slot.request.id,
                       slot=slot.index)
        self._observe_slot_pages(slot)       # pages held AT retirement
        self._finalize_request(slot.request, status, reason)
        if status in self._c:
            self._c[status].inc()
        self._clear_slot(slot)

    def _clear_slot(self, slot: _Slot):
        """Free a slot without finalizing its request (quarantine and
        preempt share this arc; _finish owns the terminal one). No
        page observation here: serve.cache.request_pages records
        occupancy at RETIREMENT only — a requeued request's mid-flight
        partial fills would skew the distribution low."""
        self.engine.reset(slot.index)
        slot.state = _SlotState.FREE
        slot.request = None
        slot.produced = 0
        slot.prefill_pos = 0

    def _requeue(self, req: Request):
        """Retry an already-admitted request from scratch: the greedy
        stream is deterministic, so the retry regenerates exactly what
        the fault/preemption dropped. Its first token is a fresh TTFT
        observation, not a token gap."""
        req.requeues += 1
        req.tokens = []
        req.first_token_at = None
        self._c['requeued'].inc()
        self.admission.push_front(req)

    def _quarantine(self, slot: _Slot):
        """Non-finite logits in ONE slot: reset it and retry the request
        from scratch — or fail it with a typed status once
        ``max_requeues`` is exhausted. Other slots are untouched by
        construction (per-slot cache + row-independent engine), which
        the tests pin bit-exactly."""
        req = slot.request
        self._c['nan_quarantined'].inc()
        self._clear_slot(slot)
        requeued = req.requeues < self.cfg.max_requeues
        self._emit('serve.quarantine', request_id=req.id,
                   slot=slot.index, requeued=requeued)
        if requeued:
            self._requeue(req)
        else:
            self._c['failed'].inc()
            self._finalize_request(req, 'failed_nan')
        # Quarantine-storm trigger: one transient NaN is routine; a
        # cluster of them inside a short step window is an incident —
        # dump the black box while the poisoned state is still live.
        self._quarantine_steps.append(self._step_idx)
        window = [s for s in self._quarantine_steps
                  if s > self._step_idx - self.cfg.flight_nan_window]
        self._quarantine_steps = window
        if len(window) >= self.cfg.flight_nan_storm:
            self._flight_dump(
                'nan_storm',
                reason=f'{len(window)} quarantines within the last '
                       f'{self.cfg.flight_nan_window} decode steps')

    def _ensure_pages(self):
        """Page-deficit ladder, run before every decode tick: make each
        active slot's append page writable (``engine.prepare_step`` —
        allocation on page crossings, copy-on-write on shared pages).
        On pool exhaustion: evict the longest-idle OTHER busy slot to
        free pages and retry; when no other slot can yield, PREEMPT the
        needy slot itself — requeued from scratch like a quarantine
        (bounded by ``max_requeues``), then terminally evicted with the
        typed CACHE_EXHAUSTED reason. Each rung frees at least one
        slot, so the loop terminates."""
        while True:
            active = np.array([s.state is _SlotState.ACTIVE
                               for s in self._slots])
            if not active.any():
                return
            ok = self.engine.prepare_step(active)
            deficit = [s for s in self._slots
                       if active[s.index] and not ok[s.index]]
            if not deficit:
                return
            exclude = {s.index for s in deficit}
            if self.cfg.evict_before_reject \
                    and self._evict_longest_idle(exclude=exclude):
                continue
            self._preempt(deficit[0])

    def _preempt(self, slot: _Slot):
        """Page exhaustion landed on THIS slot: free it and retry the
        request from scratch, or evict it with the typed
        CACHE_EXHAUSTED reason once ``max_requeues`` is spent."""
        req = slot.request
        self._c_preempted.inc()
        requeued = req.requeues < self.cfg.max_requeues
        self._emit('serve.preempt', request_id=req.id, slot=slot.index,
                   requeued=requeued)
        if requeued:
            self._clear_slot(slot)
            self._requeue(req)
        else:
            self._finish(slot, 'evicted', RejectReason.CACHE_EXHAUSTED)

    def fork(self, request_id, *, request_id_new=None,
             max_new_tokens=None) -> Request:
        """Fork an actively decoding request into a free slot (parallel
        sampling): the branch shares the source's full pages read-only
        and copies only the partial tail page (engine.fork_slot), then
        continues decoding independently with its own budget. Raises a
        typed :class:`RejectedError` — QUEUE_FULL without a free slot,
        CACHE_EXHAUSTED without a free page."""
        if not self._paged:
            raise ValueError("fork needs a paged engine "
                             "(cache_mode='paged')")
        src = next((s for s in self._slots if s.request is not None
                    and s.request.id == request_id), None)
        if src is None or src.state is not _SlotState.ACTIVE:
            raise ValueError(f'fork needs an actively decoding request;'
                             f' {request_id!r} is not one')
        free = next((s for s in self._slots
                     if s.state is _SlotState.FREE), None)
        if free is None:
            raise RejectedError(
                RejectReason.QUEUE_FULL,
                f'no free slot to fork {request_id} into')
        if not self.engine.fork_slot(src.index, free.index):
            raise RejectedError(
                RejectReason.CACHE_EXHAUSTED,
                f'page pool exhausted forking {request_id}')
        now = self.clock()
        orig = src.request
        req = Request(prompt=orig.prompt,
                      max_new_tokens=max_new_tokens
                      or orig.max_new_tokens,
                      deadline=orig.deadline, id=request_id_new or '',
                      prefix_id=orig.prefix_id,
                      prefix_len=orig.prefix_len, tenant=orig.tenant)
        # Same budget policy admission applies at submit — one clamp,
        # shared, so the two entry points can never drift.
        self.admission.clamp_budget(req)
        self.admission.count_admit(tenant=req.tenant)
        req.submitted_at = now
        req.queued_since = now
        req.admitted_at = now
        req.tokens = list(orig.tokens)
        # The branch inherits the stream mid-flight: its next token is
        # a continuation, not a first token — no fresh TTFT.
        req.first_token_at = orig.first_token_at
        req.admit_index = self._admit_counter
        self._admit_counter += 1
        free.request = req
        free.state = _SlotState.ACTIVE
        free.produced = src.produced
        free.input_token = src.input_token
        free.prefill_pos = src.prefill_pos
        free.last_progress = now
        free.last_token_at = src.last_token_at
        self._emit('serve.admit', request_id=req.id, slot=free.index,
                   queue_wait=0.0, prompt_len=len(req.prompt),
                   requeues=0, fork_of=orig.id, tenant=req.tenant)
        return req

    def _evict_longest_idle(self, exclude=()):
        """Rung two of the ladder: evict the busy slot that has gone
        longest without progress (ties → oldest admission), if it has
        been idle at least ``min_evict_idle``. The evicted request
        terminates with status ``'evicted'`` and its partial tokens.
        ``exclude``: slot indices never chosen (the page-deficit ladder
        evicts OTHERS to free pages before preempting the needy one)."""
        now = self.clock()
        busy = [s for s in self._slots if s.state is not _SlotState.FREE
                and s.index not in exclude]
        if not busy:
            return False
        victim = max(busy,
                     key=lambda s: (now - s.last_progress,
                                    -(s.request.admit_index or 0)))
        if now - victim.last_progress < self.cfg.min_evict_idle:
            return False
        self._finish(victim, 'evicted')
        return True

    def _record_dropped(self, dropped):
        for req in dropped:
            if req.cancelled:
                self._c['abandoned'].inc()
                self._finalize_request(req, 'abandoned')
            else:
                # Counted by the admission controller already.
                self._finalize_request(req, 'rejected',
                                       RejectReason.DEADLINE_EXCEEDED)

    def _place_paged(self, slot: _Slot, req: Request):
        """Paged admission: attach the shared prefix (refcount++, tail
        copy) and RESERVE every page the prompt's prefill plus first
        decode append need (``len(prompt)`` rows past the prefix:
        ``len−1`` prefill appends + the first decode append) — chunked
        prefill can then never fail mid-prompt. Returns ``'ok'``,
        ``'wait'`` (pool exhausted — head-of-line waits, slot left
        clean) or ``'rejected'`` (the prefix vanished while queued, or
        the request can NEVER be placed — finalized with the typed
        reason)."""
        eng = self.engine
        # Cheap headroom check BEFORE any device work: a head-of-line
        # wait must not re-do an attach tail copy plus a page zeroing
        # every tick while the pool refills. Exact page count: the
        # attach's private tail copy (one page when the prefix ends
        # mid-page) plus the fresh pages the prompt reserve opens past
        # the prefix's coverage.
        plen = req.prefix_len
        covered = eng.pool.pages_for_rows(plen)
        need = ((1 if plen % eng.page_size else 0)
                + eng.pool.pages_for_rows(plen + len(req.prompt))
                - covered)
        if need > eng.pool.pages - eng.pinned_pages:
            # Statically unservable HERE AND FOREVER: registry-pinned
            # prefix pages never free while registered, so even a
            # fully drained pool cannot supply the attach tail copy
            # plus the prompt's fresh pages (admission.validate can't
            # see the pin — it only knows raw pool capacity). Waiting
            # would stall the head of the line for every later
            # request; reject with the typed reason instead.
            self.admission.count_reject(RejectReason.CACHE_EXHAUSTED,
                                        tenant=req.tenant)
            self._finalize_request(req, 'rejected',
                                   RejectReason.CACHE_EXHAUSTED)
            return 'rejected'
        if eng.free_pages < need:
            return 'wait'
        if req.prefix_id is not None:
            try:
                attached = eng.start_with_prefix(slot.index,
                                                 req.prefix_id)
            except KeyError:
                # Unregistered while the request sat queued: a typed
                # terminal, never a KeyError crashing the tick.
                self.admission.count_reject(
                    RejectReason.PREFIX_UNREGISTERED, tenant=req.tenant)
                self._finalize_request(
                    req, 'rejected', RejectReason.PREFIX_UNREGISTERED)
                return 'rejected'
            except PageCorruptionError as exc:
                # Standalone-engine safety net (a topology's router
                # verifies at routing time and heals through its
                # ledger, pre-empting this): quarantine the dirty
                # pages, drop the poisoned prefix, typed terminal —
                # never a token decoded off a page that fails its
                # checksum.
                eng.quarantine_pages(exc.pages)
                eng.unregister_prefix(req.prefix_id)
                self.admission.count_reject(
                    RejectReason.KV_CORRUPT, tenant=req.tenant)
                self._finalize_request(req, 'rejected',
                                       RejectReason.KV_CORRUPT)
                return 'rejected'
            if not attached:
                return 'wait'
        if not eng.reserve_rows(slot.index, len(req.prompt)):
            eng.reset(slot.index)       # releases a prefix attach too
            return 'wait'
        return 'ok'

    def _admit_into_free_slots(self):
        for slot in self._slots:
            if slot.state is not _SlotState.FREE:
                continue
            # A statically-rejected request must not burn this slot's
            # turn: the SAME slot keeps popping until something places
            # (or the queue drains / the head has to wait for pages,
            # which stops admission for the whole tick).
            while True:
                req, dropped = self.admission.pop_ready()
                self._record_dropped(dropped)
                if req is None:
                    return
                if not self._paged:
                    break
                placed = self._place_paged(slot, req)
                if placed == 'ok':
                    break
                if placed == 'wait':
                    # Admission is BY FREE PAGES: head-of-line waits
                    # (its queue position and wait clock intact) until
                    # running sequences retire pages.
                    queued_since = req.queued_since
                    self.admission.push_front(req)
                    req.queued_since = queued_since
                    return
                # 'rejected': typed terminal already recorded — the
                # slot is still free, try the next queued request.
            req.admit_index = self._admit_counter
            self._admit_counter += 1
            slot.request = req
            slot.produced = 0
            slot.prefill_pos = 0
            slot.last_token_at = None
            now = self.clock()
            slot.last_progress = now
            # Queue wait: submit (or quarantine-requeue) → slot. Stamped
            # into the admit event so the timeline reconstruction and
            # the histogram agree by construction.
            queued_since = (req.queued_since if req.queued_since
                            is not None else req.submitted_at)
            wait = max(0.0, now - queued_since)
            req.admitted_at = now
            self._h_queue.observe(wait)
            self._tenant_hist('serve.queue_wait_seconds',
                              req.tenant).observe(wait)
            self._emit('serve.admit', request_id=req.id,
                       slot=slot.index, queue_wait=wait,
                       prompt_len=len(req.prompt),
                       requeues=req.requeues, tenant=req.tenant)
            if len(req.prompt) == 1:
                slot.state = _SlotState.ACTIVE
                slot.input_token = int(req.prompt[-1])
            else:
                slot.state = _SlotState.PREFILL

    def _pressure_info(self):
        """``(pressure, source)``: the backpressure signal plus which
        stream dominates it (``'queue'`` / ``'page_pool'``) — the
        reason stamped on ``serve.degrade`` events."""
        pressure, source = self.admission.pressure, 'queue'
        if self._paged:
            stats = self.engine.cache_stats()
            pool = stats['pages_used'] / max(1, stats['pages'])
            if pool > pressure:
                pressure, source = pool, 'page_pool'
        return pressure, source

    def _pressure(self):
        """Backpressure signal: queue depth, and on paged engines the
        page-pool fill — whichever is higher. A nearly-full pool caps
        new budgets and downgrades readiness exactly like a nearly-
        full queue (shorter streams → fewer pages committed)."""
        return self._pressure_info()[0]

    def _update_readiness(self):
        if self.health.liveness is Liveness.STALLED or self._closed:
            return      # the watchdog owns NOT_READY during a stall
        if self.admission.full:
            self.health.set_readiness(Readiness.NOT_READY, 'queue full')
        elif self._pressure() >= self.cfg.degrade_watermark:
            self.health.set_readiness(Readiness.DEGRADED,
                                      'queue or page-pool pressure')
        else:
            self.health.set_readiness(Readiness.READY, 'serving')

    def _commit_token(self, slot: _Slot, tok: int, now) -> bool:
        """Append ONE committed token to the slot's stream with the
        full per-token bookkeeping — counters, TTFT/gap observations
        stamped into the serve.decode event, abandon/deadline/eos/
        budget terminal checks. Returns True when the token finished
        the request (slot freed)."""
        req = slot.request
        req.tokens.append(tok)
        slot.produced += 1
        slot.input_token = tok
        slot.last_progress = now
        self._c['tokens_generated'].inc()
        # Timeline observations, stamped into the decode event: TTFT
        # on the stream's first token, inter-token gap on the rest
        # (both on the scheduler clock).
        token_fields = dict(request_id=req.id, slot=slot.index,
                            token_index=slot.produced - 1, token=tok)
        if req.first_token_at is None:
            req.first_token_at = now
            ttft = max(0.0, now - req.submitted_at)
            self._h_ttft.observe(ttft)
            self._tenant_hist('serve.ttft_seconds',
                              req.tenant).observe(ttft)
            token_fields['ttft'] = ttft
        elif slot.last_token_at is not None:
            gap = max(0.0, now - slot.last_token_at)
            self._h_token.observe(gap)
            self._tenant_hist('serve.token_seconds',
                              req.tenant).observe(gap)
            token_fields['gap'] = gap
        slot.last_token_at = now
        if self._tick_device is not None:
            # Device share of the dispatch this token rode (REAL
            # seconds, the whole batch's program — per-token division
            # is the reader's policy choice, not the log's).
            token_fields['device_seconds'] = self._tick_device
        self._emit('serve.decode', **token_fields)
        if req.cancelled or (
                self.injector is not None
                and self.injector.should_abandon(
                    req.admit_index, slot.produced)):
            self._finish(slot, 'abandoned')
        elif req.deadline is not None and req.deadline <= now:
            self._finish(slot, 'deadline_expired')
        elif (self.cfg.eos_id is not None
                and tok == self.cfg.eos_id):
            self._finish(slot, 'completed')
        elif slot.produced >= req.max_new_tokens:
            self._finish(slot, 'completed')
        else:
            return False
        return True

    # -- the loop -------------------------------------------------------
    def step(self) -> bool:
        """One scheduler tick (admit → prefill chunk → decode step →
        retire). Returns True while work remains. An unhandled
        exception escaping the tick dumps a post-mortem bundle (the
        state that crashed the loop, captured before unwinding
        destroys it) and re-raises — the flight recorder observes
        failures, it never absorbs them."""
        try:
            return self._step_impl()
        except Exception as e:
            if self.cfg.flight_dump_on_exception:
                self._flight_dump(
                    'exception',
                    reason=f'{type(e).__name__}: {e}')
            raise

    def _step_impl(self) -> bool:
        # Dispatch-floor anchors: REAL tick start and the engine's
        # cumulative program-seconds odometer. Ticks that run a decode
        # dispatch close the loop at the bottom of this method —
        # tick wall time minus the program delta IS the host overhead.
        tick_t0 = time.perf_counter()
        dev_anchor = self.engine.program_seconds
        toks_anchor = self._c['tokens_generated'].value
        ran_decode = False
        now = self.clock()
        self.health.beat()
        self._admit_into_free_slots()

        for slot in self._slots:
            if slot.state is not _SlotState.PREFILL:
                continue
            req = slot.request
            if req.cancelled:
                self._finish(slot, 'abandoned')
                continue
            if req.deadline is not None and req.deadline <= now:
                self._finish(slot, 'deadline_expired')
                continue
            # ONE chunk per tick per slot: long prompts interleave with
            # decoding instead of monopolizing the loop.
            end = min(slot.prefill_pos + self.engine.prefill_chunk,
                      len(req.prompt) - 1)
            if end > slot.prefill_pos:
                self.engine.prefill(slot.index,
                                    req.prompt[slot.prefill_pos:end],
                                    request_id=req.id)
                slot.prefill_pos = end
                slot.last_progress = now
                self._emit('serve.prefill', request_id=req.id,
                           slot=slot.index, pos=end)
            if slot.prefill_pos >= len(req.prompt) - 1:
                slot.state = _SlotState.ACTIVE
                slot.input_token = int(req.prompt[-1])

        if self._paged:
            self._ensure_pages()
        active = np.array([s.state is _SlotState.ACTIVE
                           for s in self._slots])
        if active.any():
            if self.injector is not None:
                self.injector.on_decode_step(self._step_idx)
            poison = (self.injector.poison_slots(self._step_idx,
                                                 len(self._slots))
                      if self.injector is not None else None)
            # Request-id labels only materialize when spans are on —
            # the disabled default must stay allocation-free per step.
            request_ids = ([s.request.id if s.request is not None
                            else None for s in self._slots]
                           if obs_spans.enabled() else None)
            ran_decode = True
            t0 = time.perf_counter()
            tokens_in = np.array(
                [s.input_token for s in self._slots], np.int32)
            dev0 = self.engine.program_seconds
            with span('serve.decode_step', step=self._step_idx):
                toks, finite = self.engine.step(
                    tokens_in, active, poison, request_ids=request_ids)
            self._tick_device = self.engine.program_seconds - dev0
            self._h_step.observe(time.perf_counter() - t0)
            self.health.beat()   # the step returned: not stuck
            self._c['decode_steps'].inc()
            now = self.clock()
            for slot in self._slots:
                if slot.state is not _SlotState.ACTIVE:
                    continue
                if not finite[slot.index]:
                    self._quarantine(slot)
                    continue
                self._commit_token(slot, int(toks[slot.index]), now)
            self._step_idx += 1

        self._g_active.set(sum(s.state is not _SlotState.FREE
                               for s in self._slots))
        if self._paged:
            stats = self.engine.cache_stats()
            self._g_pages_used.set(stats['pages_used'])
            self._g_pages_free.set(stats['pages_free'])
            self._g_shared.set(stats['shared_pages'])
        # Flight-recorder sample (throttled inside to REAL seconds;
        # the shared null recorder makes the disabled path one method
        # call, no allocation).
        obs_flight.recorder().sample()
        self._update_readiness()
        if ran_decode:
            # Close the dispatch-floor loop for this tick: the REAL
            # wall time the whole tick body took vs the slice spent
            # inside compiled programs (prefill chunks included — they
            # are device work this tick paid for). Emitted per tick,
            # not per token: the floor is a loop property.
            tick_s = time.perf_counter() - tick_t0
            dev_s = max(0.0, self.engine.program_seconds - dev_anchor)
            overhead = max(0.0, tick_s - dev_s)
            self._h_device.observe(dev_s)
            self._h_dispatch.observe(overhead)
            self._emit('serve.dispatch', step=self._step_idx - 1,
                       tick_seconds=tick_s, device_seconds=dev_s,
                       overhead=overhead,
                       tokens=self._c['tokens_generated'].value
                       - toks_anchor)
        self._tick_device = None
        if self.on_tick is not None:
            self.on_tick(self)
        return bool(self.admission.depth) or any(
            s.state is not _SlotState.FREE for s in self._slots)

    def run_until_idle(self, max_ticks=100_000):
        """Drive ticks until queue and slots are empty. ``max_ticks``
        bounds runaway loops (a bug, not load, is the only way to hit
        it)."""
        ticks = 0
        while self.step():
            ticks += 1
            if ticks >= max_ticks:
                raise RuntimeError(
                    f'scheduler still busy after {max_ticks} ticks: '
                    f'queue={self.admission.depth} slots='
                    f'{[s.state.value for s in self._slots]}')
        return self.results

    def close(self):
        """Stop the watchdog and mark the surface STOPPED."""
        if not self._closed:
            self._closed = True
            obs_flight.remove_provider('scheduler',
                                       self._introspection_hook)
            self.health.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
