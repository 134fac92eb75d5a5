# -*- coding: utf-8 -*-
"""
Request-timeline reconstruction over the JSONL event log.

The serving scheduler stamps its latency observations INTO the events
it emits (``queue_wait`` on admit, ``ttft``/``gap`` on decode,
``total_seconds`` on retire — measured on the scheduler's own clock, so
reconstruction is immune to wall-clock skew between the scheduler and
the log). This module turns the flat event stream back into per-request
lifecycles and checks them against the serving contract:

    admit → (prefill* | decode* | quarantine)* → retire(status)
  | reject(reason)                       # shed at submit or in queue
  | retire(abandoned)                    # cancelled while still queued
  | recovered → re-admit | reject        # replica died mid-stream

A :class:`Timeline` whose ``complete`` is False carries the specific
violations in ``errors`` — an audit of a served log fails on any of
them, which is what makes "every request reconstructable from the log
alone" a standing contract rather than a hope.

Copied from ``distributed_dot_product_tpu/obs/timeline.py``: the port's
scheduler emits the reference's events with the reference's fields, so
the same automaton reads both packages' logs.
"""

import dataclasses
import os
from typing import Dict, List, Optional

from distributed_dot_product_tpu_torch.obs.events import (
    EventLog, merge_events, read_events,
)

__all__ = ['Timeline', 'timeline', 'reconstruct']

# Events that end a request's lifecycle.
_TERMINAL = {'serve.retire', 'serve.reject'}
# Events legal only while the request holds a slot.
_RUNNING_ONLY = {'serve.prefill', 'serve.decode', 'serve.evict',
                 'serve.quarantine', 'serve.preempt',
                 'spec.propose', 'spec.verify'}


@dataclasses.dataclass
class Timeline:
    """One request's reconstructed lifecycle. Latency fields are None
    when the log carries no observation for them (e.g. a rejected
    request has no TTFT)."""
    request_id: str
    events: List[dict]
    status: Optional[str] = None       # terminal status, None if absent
    reason: Optional[str] = None
    # Tenant label (schema v2 admit/reject/retire events carry it) —
    # what per-tenant goodput accounting (obs/slo.py) groups by.
    tenant: Optional[str] = None
    # Replica labels this request's events came from (multi-source
    # merge_events reconstruction): a disaggregated request's timeline
    # legitimately spans a prefill pool and a decode pool.
    replicas: List[str] = dataclasses.field(default_factory=list)
    complete: bool = False
    errors: List[str] = dataclasses.field(default_factory=list)
    queue_wait: Optional[float] = None
    ttft: Optional[float] = None
    token_gaps: List[float] = dataclasses.field(default_factory=list)
    total_seconds: Optional[float] = None
    admits: int = 0
    quarantines: int = 0
    preempts: int = 0
    tokens: int = 0
    # Speculative-decoding arcs (spec.propose / spec.verify): how many
    # verify steps served this request, how many tokens its proposers
    # guessed and how many of those greedy verification accepted — the
    # amortization record (committed tokens per verify step =
    # accepted/spec_steps + 1), reconstructed from the log alone.
    spec_steps: int = 0
    spec_proposed: int = 0
    spec_accepted: int = 0
    # Disaggregated-serving arcs: router placements (router.route, in
    # the router's log) and prefill→decode KV handoffs
    # (prefill.handoff, in the prefill pool's) — a routed request's
    # lifecycle legitimately spans up to three logs.
    routes: int = 0
    handoffs: int = 0
    # Degradation-ladder engagements (serve.degrade — the rung used to
    # fire silently): admissions of this request with a capped budget.
    degrades: int = 0
    # Replica-loss recovery arcs (request.recovered, in the router's
    # log): times this request's stream was resolved off a dead replica
    # — re-dispatched to a survivor or terminally rejected replica_lost.
    recoveries: int = 0
    # The subset of those displacements caused by a KV page corruption
    # verdict (request.recovered with reason=kv_corrupt): the stream
    # was expelled off poisoned pages and healed on a clean replica
    # (or terminally rejected kv_corrupt past the recovery budget).
    corruptions: int = 0

    def phases(self):
        """Compact ``{phase: seconds}`` view for printing."""
        out = {}
        if self.queue_wait is not None:
            out['queue_wait'] = self.queue_wait
        if self.ttft is not None:
            out['ttft'] = self.ttft
        if self.token_gaps:
            out['decode'] = sum(self.token_gaps)
        if self.total_seconds is not None:
            out['total'] = self.total_seconds
        return out


def _reset_delivered_latency(tl: Timeline):
    """A requeue (quarantine or preemption) DISCARDS the attempt's
    stream — the retry regenerates it from scratch. The timeline's
    latency verdict describes the DELIVERED stream, so the aborted
    attempt's TTFT and gaps are dropped here; the next stamped TTFT
    (still measured from the ORIGINAL submit on the scheduler's clock
    — _commit_token anchors at submitted_at) wins. ``tokens`` stays
    cumulative: work done is work done, delivered or not."""
    tl.ttft = None
    tl.token_gaps = []


def _validate(tl: Timeline):
    """Run the lifecycle automaton over ``tl.events`` (already
    seq-sorted), populating status/errors/derived fields."""
    state = 'submitted'     # submitted -> running -> (queued ->) done
    for rec in tl.events:
        ev = rec['event']
        if tl.tenant is None and rec.get('tenant') is not None:
            tl.tenant = rec['tenant']
        replica = rec.get('replica')
        if replica is not None and replica not in tl.replicas:
            tl.replicas.append(replica)
        if ev == 'router.route':
            # Placement rides its OWN log: at equal timestamps the
            # merge may order it before or after the replica-side
            # lifecycle (a one-tick request can even retire at the
            # route's ts), so it is state-exempt — counted, never a
            # transition and never an after-terminal violation.
            tl.routes += 1
            continue
        if ev == 'prefill.handoff':
            tl.handoffs += 1
            continue
        if ev == 'serve.degrade':
            # The degrade rung fires at SUBMIT, before the admit (or
            # queue-full reject) verdict, and a drained-and-requeued
            # request may degrade again on resubmission after its
            # terminal would have been legal — state-exempt, counted.
            tl.degrades += 1
            continue
        if ev == 'serve.preempt' and rec.get('expel'):
            # Corruption-containment expulsion rides the DIRTY
            # replica's log; at equal timestamps the merge may order
            # it after the router's request.recovered already returned
            # the request to 'queued' (or after the no-survivor
            # terminal reject) — state-exempt, counted, slot freed if
            # still held.
            tl.preempts += 1
            if state == 'running':
                state = 'queued'
                _reset_delivered_latency(tl)
            continue
        if state == 'done':
            tl.errors.append(f'event {ev} after terminal state')
            continue
        if ev == 'serve.admit':
            if state == 'running':
                tl.errors.append('admit while already running')
            state = 'running'
            tl.admits += 1
            if tl.queue_wait is None:
                tl.queue_wait = rec.get('queue_wait')
        elif ev in _RUNNING_ONLY:
            if state != 'running':
                tl.errors.append(f'{ev} without a slot (state={state})')
            if ev == 'serve.decode':
                tl.tokens += 1
                if rec.get('ttft') is not None and tl.ttft is None:
                    tl.ttft = rec['ttft']
                if rec.get('gap') is not None:
                    tl.token_gaps.append(rec['gap'])
            elif ev == 'spec.verify':
                tl.spec_steps += 1
                tl.spec_proposed += rec.get('proposed', 0)
                tl.spec_accepted += rec.get('accepted', 0)
            elif ev == 'serve.quarantine':
                tl.quarantines += 1
                # Quarantine frees the slot: a requeued request must be
                # re-admitted; an exhausted one goes straight to retire.
                state = 'queued' if rec.get('requeued') else 'running'
                if rec.get('requeued'):
                    _reset_delivered_latency(tl)
            elif ev == 'serve.preempt':
                # Page-pool preemption: same slot-freeing arc as a
                # quarantine (requeued → re-admit; exhausted retries →
                # the terminal evict/retire follows while 'running').
                tl.preempts += 1
                state = 'queued' if rec.get('requeued') else 'running'
                if rec.get('requeued'):
                    _reset_delivered_latency(tl)
        elif ev == 'request.recovered':
            # The replica holding this stream died. The slot died with
            # it, so the request returns to 'queued' whatever the
            # requeued flag says: requeued=True is followed by a
            # survivor's admit, requeued=False by a terminal
            # serve.reject reason=replica_lost — both legal from
            # 'queued'. This is how a recovery arc CLOSES across the
            # dead replica's torn log: the victim's record ends
            # mid-stream with no terminal, and the router log alone
            # supplies the transition out of it. Delivered latency of
            # the aborted attempt is discarded like any requeue; the
            # next TTFT is still anchored at the ORIGINAL submit.
            tl.recoveries += 1
            if rec.get('reason') == 'kv_corrupt':
                # Displaced by a corruption verdict, not a dead
                # replica — same automaton arc, separate tally.
                tl.corruptions += 1
            state = 'queued'
            _reset_delivered_latency(tl)
        elif ev == 'serve.retire':
            tl.status = rec.get('status')
            tl.reason = rec.get('reason')
            tl.total_seconds = rec.get('total_seconds')
            if state == 'submitted' and tl.status != 'abandoned':
                tl.errors.append(
                    f'retire({tl.status}) without an admit')
            state = 'done'
        elif ev == 'serve.reject':
            tl.status = 'rejected'
            tl.reason = rec.get('reason')
            if tl.reason is None:
                tl.errors.append('reject without a reason')
            if state == 'running':
                tl.errors.append('reject while holding a slot')
            state = 'done'
        else:
            tl.errors.append(f'non-serve event {ev} in request timeline')
    if state != 'done':
        tl.errors.append(f'no terminal event (ended in state {state})')
    if tl.status == 'evicted' and not any(
            r['event'] == 'serve.evict' for r in tl.events):
        tl.errors.append('retire(evicted) without a serve.evict event')
    tl.complete = not tl.errors
    return tl


def _is_multi_source(source):
    """A list/tuple of log paths (or ``(replica, path)`` pairs) — as
    opposed to a list of already-decoded records, which read_events
    handles directly."""
    if not isinstance(source, (list, tuple)) or not source:
        return False
    first = source[0]
    if isinstance(first, (str, os.PathLike, EventLog)):
        return True
    return (isinstance(first, (tuple, list)) and len(first) == 2
            and isinstance(first[1], (str, os.PathLike)))


def reconstruct(source) -> Dict[str, Timeline]:
    """Rebuild EVERY request's timeline from ``source`` (an EventLog, a
    log path — rotated set included — or decoded records). A LIST of
    paths (or ``(replica, path)`` pairs) reconstructs across the merged
    multi-replica stream (:func:`~distributed_dot_product_tpu_torch.obs
    .events.merge_events`): one request's timeline may then span a
    prefill pool's log and a decode pool's. Returns
    ``{request_id: Timeline}``."""
    records = (merge_events(source) if _is_multi_source(source)
               else read_events(source))
    per_request: Dict[str, List[dict]] = {}
    for rec in records:
        rid = rec.get('request_id')
        ev = rec.get('event', '')
        if rid is not None and ev.startswith(('serve.', 'spec.',
                                              'router.', 'prefill.',
                                              'request.')):
            per_request.setdefault(rid, []).append(rec)
    return {rid: _validate(Timeline(request_id=rid, events=evs))
            for rid, evs in per_request.items()}


def timeline(request_id, source) -> Timeline:
    """One request's reconstructed :class:`Timeline`. A request that
    never reached the log yields an (incomplete) empty timeline rather
    than a KeyError — absence is itself an audit finding."""
    tl = reconstruct(source).get(request_id)
    if tl is None:
        tl = Timeline(request_id=request_id, events=[],
                      errors=['no events recorded'])
    return tl
