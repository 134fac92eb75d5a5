# -*- coding: utf-8 -*-
"""
Admission control and backpressure for the decode serving layer.

A serving process dies from its edges, not its kernels: an unbounded
queue OOMs the host, an oversized prompt wedges prefill, and a request
that can never meet its deadline burns decode slots other requests need.
This module owns the request boundary:

- **Bounded queue**: ``queue_limit`` pending requests, hard. Past it the
  scheduler sheds load (after trying eviction — scheduler.py's ladder).
- **Typed rejection**: every shed request raises/records a
  :class:`RejectedError` carrying a :class:`RejectReason` — operators
  alarm on reasons, not on string-matching log lines, and the soak
  invariant "zero dropped-without-reason" becomes checkable.
- **Per-request deadlines**: absolute wall-clock points (injectable
  clock for tests). Checked at submit (don't queue the doomed), while
  queued (don't prefill the expired), and mid-stream (free the slot).
- **Token budgets**: ``max_new_tokens`` clamped to the config cap and
  to the cache capacity ``t_max - len(prompt)``; a prompt that leaves
  no room to generate even one token is PROMPT_TOO_LONG.
- **Graceful degradation**: above ``degrade_watermark`` queue pressure,
  new requests are admitted with a REDUCED token budget
  (``degraded_max_new_tokens``) instead of being rejected — trade
  per-request depth for admission, shed only when that fails.

Copied from ``distributed_dot_product_tpu/serve/admission.py``.
"""

import collections
import dataclasses
import enum
import itertools
import time
from typing import List, Optional, Tuple

import numpy as np

from distributed_dot_product_tpu_torch.obs import events as obs_events

__all__ = ['RejectReason', 'RejectedError', 'Request', 'RequestResult',
           'AdmissionController']


class RejectReason(enum.Enum):
    """Why a request was shed. The complete taxonomy — a rejection never
    carries free text alone."""
    QUEUE_FULL = 'queue_full'
    DEADLINE_EXCEEDED = 'deadline_exceeded'
    PROMPT_TOO_LONG = 'prompt_too_long'
    # Paged KV pool (scheduler over a cache_mode='paged' engine): the
    # request needs more pool pages than the pool can EVER provide, or
    # mid-stream page exhaustion outlasted its preemption retries.
    CACHE_EXHAUSTED = 'cache_exhausted'
    # The request names a shared prefix that is not (or no longer)
    # registered — at submit, or unregistered while it sat queued.
    PREFIX_UNREGISTERED = 'prefix_unregistered'
    # Disaggregated serving (serve/router.py): no decode replica in the
    # pool can accept the request — every replica's admission queue is
    # at its bound (or the pool is empty). The router-level analog of
    # QUEUE_FULL, shed BEFORE any replica's ladder runs.
    NO_REPLICA = 'no_replica'
    # Disaggregated serving: the decode replica holding this in-flight
    # stream died, and the router could not re-place it — no surviving
    # replica, or the per-request ``max_recoveries`` budget is spent.
    # Terminal: the recovery ledger entry is finalized under this reason.
    REPLICA_LOST = 'replica_lost'
    # KV page integrity: the stream's context touched a pool page that
    # failed checksum verification, and the router could not heal it —
    # recovery budget spent, or no clean replica to replay on. Terminal
    # under the same ledger discipline as REPLICA_LOST; the page(s)
    # stay quarantined.
    KV_CORRUPT = 'kv_corrupt'


class RejectedError(Exception):
    """A request was refused admission (or expired in the queue).
    ``reason`` is always a :class:`RejectReason`."""

    def __init__(self, reason: RejectReason, message: str):
        super().__init__(f'[{reason.value}] {message}')
        self.reason = reason


_ids = itertools.count()


@dataclasses.dataclass
class Request:
    """One generation request plus its runtime bookkeeping (owned by the
    scheduler once admitted). ``deadline`` is an ABSOLUTE clock value on
    the scheduler's clock, or None for no deadline."""
    prompt: np.ndarray
    max_new_tokens: int
    deadline: Optional[float] = None
    id: str = ''
    submitted_at: float = 0.0
    # Tenant label for multi-tenant accounting: stamped on every
    # admit/reject event (EVENT_SCHEMA v2) and keyed into the
    # tenant-labeled metrics series, so per-tenant goodput is derivable
    # both live (/metrics) and offline (obs/slo.py).
    tenant: str = 'default'
    # Paged serving: id of a registered shared prefix the prompt
    # CONTINUES (the prompt tokens come after it), and its length —
    # admission budgets against prefix_len + len(prompt).
    prefix_id: Optional[int] = None
    prefix_len: int = 0
    # -- runtime state (scheduler-owned) --------------------------------
    tokens: List[int] = dataclasses.field(default_factory=list)
    requeues: int = 0
    degraded: bool = False
    cancelled: bool = False
    admit_index: Optional[int] = None   # admission order, fault-stable
    # -- timeline anchors (scheduler clock; observability) --------------
    queued_since: Optional[float] = None    # last enqueue time
    admitted_at: Optional[float] = None     # last slot assignment
    first_token_at: Optional[float] = None  # TTFT anchor

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if not self.id:
            self.id = f'req-{next(_ids)}'
        self.tenant = str(self.tenant or 'default')


@dataclasses.dataclass
class RequestResult:
    """Terminal record for one request. ``status`` is one of
    ``'completed' | 'deadline_expired' | 'evicted' | 'abandoned' |
    'failed_nan' | 'rejected'``; ``reason`` is the typed
    :class:`RejectReason` when ``status == 'rejected'`` (else None).
    Partial tokens are kept for every non-completed terminal state —
    an evicted or expired stream still delivers what it produced."""
    id: str
    status: str
    tokens: List[int]
    prompt_len: int
    reason: Optional[RejectReason] = None
    requeues: int = 0
    degraded: bool = False
    finished_at: float = 0.0
    tenant: str = 'default'


class AdmissionController:
    """Bounded admission queue with validation, degradation and typed
    shedding. The scheduler composes this with the slot engine; tests
    drive it standalone with a virtual clock."""

    def __init__(self, *, queue_limit, t_max, max_new_tokens,
                 degrade_watermark=0.75, degraded_max_new_tokens=None,
                 clock=time.monotonic, registry=None, event_log=None,
                 capacity_tokens=None):
        if queue_limit < 1:
            raise ValueError(f'queue_limit must be >= 1, got {queue_limit}')
        self.queue_limit = queue_limit
        self.t_max = t_max
        # Paged pool: most rows ONE request can ever hold (pool pages ×
        # page size, capped by t_max). None = slab (t_max governs).
        self.capacity_tokens = capacity_tokens
        self.max_new_tokens = max_new_tokens
        self.degrade_watermark = degrade_watermark
        self.degraded_max_new_tokens = (degraded_max_new_tokens
                                        or max(1, max_new_tokens // 4))
        self.clock = clock
        self.event_log = event_log
        self._queue = collections.deque()
        self._registry = registry
        if registry is not None:
            self._c_admit = registry.counter('serve.admitted')
            self._c_degraded = registry.counter('serve.degraded')
            self._c_reject = {r: registry.counter(f'serve.rejected.{r.value}')
                              for r in RejectReason}
            self._g_depth = registry.gauge('serve.queue_depth')
        else:
            self._c_admit = self._c_degraded = self._g_depth = None
            self._c_reject = {}

    def _count_tenant(self, name, tenant):
        """Bump the tenant-labeled twin of an admit/reject counter —
        same family name, ``tenant=`` label (the exporter renders both;
        external Prometheus computes per-tenant goodput from the
        labeled series)."""
        if self._registry is not None and tenant is not None:
            self._registry.counter(name, labels={'tenant': tenant}).inc()

    # -- introspection --------------------------------------------------
    @property
    def depth(self):
        return len(self._queue)

    @property
    def full(self):
        return len(self._queue) >= self.queue_limit

    @property
    def pressure(self):
        """Queue fullness in [0, 1] — the degradation ladder's input."""
        return len(self._queue) / self.queue_limit

    def queued_by_tenant(self):
        """``{tenant: queued count}`` over the live queue — the
        policy-relevant placement signal ``Scheduler.load()`` exposes
        (fair-share routing and the controller's per-tenant view)."""
        out: dict = {}
        for req in self._queue:
            out[req.tenant] = out.get(req.tenant, 0) + 1
        return out

    def oldest_deadline(self):
        """Earliest absolute deadline among queued requests, or None
        when nothing queued carries one — how urgent the backlog is."""
        deadlines = [req.deadline for req in self._queue
                     if req.deadline is not None]
        return min(deadlines) if deadlines else None

    def _update_depth(self):
        if self._g_depth is not None:
            self._g_depth.set(len(self._queue))

    def _emit(self, event, **fields):
        log = (self.event_log if self.event_log is not None
               else obs_events.get_active())
        if log is not None:
            log.emit(event, **fields)

    def _reject(self, reason: RejectReason, message: str,
                request_id=None, tenant=None):
        if reason in self._c_reject:
            self._c_reject[reason].inc()
        self._count_tenant(f'serve.rejected.{reason.value}',
                           tenant or 'default')
        if request_id is not None:
            # Submit-time shed: the request's entire recorded lifecycle
            # is this one typed event.
            self._emit('serve.reject', request_id=request_id,
                       reason=reason.value, queued=False,
                       tenant=tenant or 'default')
        raise RejectedError(reason, message)

    def reject(self, reason: RejectReason, message: str,
               request_id=None, tenant=None):
        """Public typed shed: counter + submit-time event + raise —
        for reject conditions the CALLER owns (the scheduler's paged
        checks), so they account exactly like queue/deadline sheds."""
        self._reject(reason, message, request_id=request_id,
                     tenant=tenant)

    def reject_count(self, reason: RejectReason):
        c = self._c_reject.get(reason)
        return c.value if c is not None else 0

    def count_reject(self, reason: RejectReason, tenant=None):
        """Count a scheduler-owned shed that is FINALIZED rather than
        raised (tick-time rejects of already-queued requests): same
        counters as submit-time sheds, no exception — dashboards see
        every typed reject however it was delivered."""
        if reason in self._c_reject:
            self._c_reject[reason].inc()
        self._count_tenant(f'serve.rejected.{reason.value}',
                           tenant or 'default')

    # -- admission ------------------------------------------------------
    def validate(self, request: Request, now=None):
        """Typed-reject anything that can never be served: an expired
        deadline, a prompt leaving no room to generate one token, or —
        paged — a sequence no pool-sized allocation can ever hold.
        Clamps the token budget to the config cap and cache capacity."""
        now = self.clock() if now is None else now
        if request.deadline is not None and request.deadline <= now:
            self._reject(RejectReason.DEADLINE_EXCEEDED,
                         f'request {request.id}: deadline already passed '
                         f'at submit', request_id=request.id,
                         tenant=request.tenant)
        full_len = request.prefix_len + len(request.prompt)
        room = self.t_max - full_len
        if len(request.prompt) < 1 or room < 1:
            self._reject(RejectReason.PROMPT_TOO_LONG,
                         f'request {request.id}: prompt of '
                         f'{full_len} tokens (prefix included) leaves '
                         f'no room to generate in a t_max={self.t_max} '
                         f'cache', request_id=request.id,
                         tenant=request.tenant)
        if self.capacity_tokens is not None \
                and full_len + 1 > self.capacity_tokens:
            # Statically impossible however long it waits: the POOL
            # cannot hold the prompt plus one generated token.
            self._reject(RejectReason.CACHE_EXHAUSTED,
                         f'request {request.id}: {full_len} prompt rows '
                         f'+ 1 exceed the page pool\'s '
                         f'{self.capacity_tokens}-row capacity',
                         request_id=request.id, tenant=request.tenant)
        self.clamp_budget(request)

    def clamp_budget(self, request: Request):
        """Clamp the token budget to the config cap and the cache/pool
        capacity. This is the ONE place the budget policy lives:
        submit-time :meth:`validate` and the scheduler's ``fork`` (which
        places a branch without queueing) both apply it, so a forked
        branch can never hold a slot or commit pool pages past what a
        submitted request could."""
        full_len = request.prefix_len + len(request.prompt)
        room = self.t_max - full_len
        if self.capacity_tokens is not None:
            room = min(room, self.capacity_tokens - full_len)
        request.max_new_tokens = max(1, min(request.max_new_tokens,
                                            self.max_new_tokens, room))

    def count_admit(self, tenant=None):
        """Count an admission that never crossed the queue (the
        scheduler's ``fork`` places the branch straight into a slot):
        same counter as queued admissions, so in-flight accounting over
        admitted − terminal stays balanced when fork is used."""
        if self._c_admit is not None:
            self._c_admit.inc()
        self._count_tenant('serve.admitted', tenant)

    def maybe_degrade(self, request: Request, pressure=None,
                      reason=None):
        """Above the pressure watermark, cap the request's token budget
        instead of rejecting it — rung one of the degradation ladder.
        ``pressure`` overrides the queue-depth default (the scheduler
        passes max(queue, page-pool) pressure on paged engines, so page
        exhaustion degrades before it evicts before it rejects).
        ``reason`` names the pressure source (``queue`` /
        ``page_pool``) on the ``serve.degrade`` event — the rung used
        to engage SILENTLY; now every degraded admission is a
        closed-vocabulary record the timeline and doctor can see."""
        pressure = self.pressure if pressure is None else pressure
        if pressure >= self.degrade_watermark \
                and request.max_new_tokens > self.degraded_max_new_tokens:
            request.max_new_tokens = self.degraded_max_new_tokens
            request.degraded = True
            if self._c_degraded is not None:
                self._c_degraded.inc()
            self._emit('serve.degrade', request_id=request.id,
                       watermark=self.degrade_watermark,
                       reason=reason or 'queue', pressure=pressure,
                       tenant=request.tenant)

    def push(self, request: Request):
        """Enqueue an ADMITTED request; caller has already resolved the
        queue-full ladder (this raises QUEUE_FULL as the last resort)."""
        if self.full:
            self._reject(RejectReason.QUEUE_FULL,
                         f'request {request.id}: queue at limit '
                         f'{self.queue_limit}', request_id=request.id,
                         tenant=request.tenant)
        request.queued_since = self.clock()
        self._queue.append(request)
        if self._c_admit is not None:
            self._c_admit.inc()
        self._count_tenant('serve.admitted', request.tenant)
        self._update_depth()

    def push_front(self, request: Request):
        """Requeue already-admitted work (NaN-quarantine retry) at the
        FRONT, bypassing the bound: admitted work is never dropped by
        capacity — that would convert a fault into a silent loss."""
        request.queued_since = self.clock()
        self._queue.appendleft(request)
        self._update_depth()

    def pop_ready(self, now=None, chooser=None) -> Tuple[
            Optional[Request], List[Request]]:
        """Next serviceable request plus any that expired while queued
        (the caller finalizes those as typed DEADLINE_EXCEEDED
        rejections — queue death is never silent). ``chooser`` is the
        policy hook (serve/policy.py): called with the FULL list of
        live queued requests, it returns the index to admit — the
        whole queue is deadline-swept first, so a policy pick never
        skips past (and thereby hides) an expired request. Without a
        chooser, FIFO semantics are byte-identical to before: only
        the head's expired prefix is swept."""
        now = self.clock() if now is None else now
        expired = []
        if chooser is None:
            while self._queue:
                req = self._queue.popleft()
                if req.cancelled:
                    expired.append(req)   # caller records 'abandoned'
                    continue
                if req.deadline is not None and req.deadline <= now:
                    if RejectReason.DEADLINE_EXCEEDED in self._c_reject:
                        self._c_reject[
                            RejectReason.DEADLINE_EXCEEDED].inc()
                    expired.append(req)
                    continue
                self._update_depth()
                return req, expired
            self._update_depth()
            return None, expired
        live = []
        for req in self._queue:
            if req.cancelled:
                expired.append(req)
            elif req.deadline is not None and req.deadline <= now:
                if RejectReason.DEADLINE_EXCEEDED in self._c_reject:
                    self._c_reject[RejectReason.DEADLINE_EXCEEDED].inc()
                expired.append(req)
            else:
                live.append(req)
        if not live:
            self._queue.clear()
            self._update_depth()
            return None, expired
        picked = live.pop(chooser(live))
        self._queue = collections.deque(live)
        self._update_depth()
        return picked, expired
