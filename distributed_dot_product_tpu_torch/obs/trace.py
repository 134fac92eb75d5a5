# -*- coding: utf-8 -*-
"""
Chrome-trace / Perfetto export of the JSONL event log — a VISUAL
timeline of a serving run or incident. Copied from
``distributed_dot_product_tpu/obs/trace.py``.

:func:`export_trace` folds one or many (labeled) event logs into the
Chrome Trace Event Format (the JSON flavor ``chrome://tracing`` and
https://ui.perfetto.dev load directly):

- one **process track per replica** (the merge label), one **thread
  track per slot** — a disaggregated run renders as router / prefill /
  replica lanes side by side;
- one **complete slice ("X") per critical-path phase segment** of every
  request (queue / handoff / prefill / decode / stall / commit, from
  :mod:`distributed_dot_product_tpu_torch.obs.critpath` — the slices are the
  partition, so the lane visually accounts for the request's whole e2e);
- **instant markers ("i")** for the discrete incidents an operator
  scrubs for: fault injections, preemptions, quarantines, anomaly
  detections, KV handoffs, page-corruption verdicts, replica losses,
  recoveries, post-mortem dumps.

Timestamps are the log's ``ts`` rebased to the earliest record and
scaled to microseconds (the format's unit); on a virtual-clock run the
trace is in virtual time — exactly the timeline the phase partition is
proved against. :func:`validate_trace` is the gate: required keys on
every event, non-negative durations, per-track monotone ``ts``.

CLI: ``python -m distributed_dot_product_tpu_torch.obs trace export LOG
[replica=LOG ...] -o trace.json``.
"""

import json
from typing import Dict, List

from distributed_dot_product_tpu_torch.obs.critpath import (
    _attribute_one, _REQ_PREFIXES,
)
from distributed_dot_product_tpu_torch.obs.events import (
    merge_events, read_events,
)
from distributed_dot_product_tpu_torch.obs.timeline import _is_multi_source

__all__ = ['export_trace', 'write_trace', 'validate_trace',
           'INSTANT_EVENTS']

# Discrete incidents worth a marker on the timeline (event name →
# rendered marker name). Everything else is either a phase slice
# (request lifecycle) or bookkeeping the visual view would drown in.
INSTANT_EVENTS = {
    'fault.inject': 'fault',
    'serve.preempt': 'preempt',
    'serve.quarantine': 'quarantine',
    'serve.evict': 'evict',
    'anomaly.detected': 'anomaly',
    'prefill.handoff': 'handoff',
    'kv.corrupt': 'kv_corrupt',
    'replica.lost': 'replica_lost',
    'replica.rejoin': 'replica_rejoin',
    'prefill.lost': 'prefill_lost',
    'request.recovered': 'recovered',
    'postmortem.dump': 'postmortem',
    'profile.capture': 'profile',
}

# Marker fields worth carrying into args (small, readable — not the
# whole record: Perfetto renders args as a flat table).
_MARKER_FIELDS = ('request_id', 'reason', 'requeued', 'slot', 'kind',
                  'metric', 'detector', 'value', 'target', 'pages',
                  'site', 'trigger', 'status')


def _records(source):
    return (merge_events(source) if _is_multi_source(source)
            else read_events(source))


def export_trace(source) -> dict:
    """Build the Chrome-trace object (``{'traceEvents': [...]}``) from
    ``source`` — a log path, decoded records, or a list of paths /
    ``(replica, path)`` pairs merged with replica labels."""
    records = _records(source)
    if not records:
        return {'traceEvents': [], 'displayTimeUnit': 'ms'}
    t0 = min(r.get('ts', 0.0) for r in records)

    def us(ts):
        return max(0.0, (ts - t0) * 1e6)

    # pid per replica label, in first-seen order; pid 1.. (0 renders
    # oddly in some viewers). Unlabeled single-log exports get one
    # 'log' process.
    pids: Dict[str, int] = {}

    def pid_of(label):
        label = label or 'log'
        if label not in pids:
            pids[label] = len(pids) + 1
        return pids[label]

    events: List[dict] = []
    # Request phase slices: group request-scoped records, attribute,
    # and render each partition segment as one complete slice on the
    # (terminal replica, admit slot) track.
    per_request: Dict[str, List[dict]] = {}
    for rec in records:
        rid = rec.get('request_id')
        if rid is not None \
                and rec.get('event', '').startswith(_REQ_PREFIXES):
            per_request.setdefault(rid, []).append(rec)
    for rid, recs in per_request.items():
        chain = _attribute_one(rid, recs)
        label = chain.replicas[-1] if chain.replicas else None
        slot = next((r['slot'] for r in recs
                     if r.get('event') == 'serve.admit'
                     and r.get('slot') is not None), 0)
        pid = pid_of(label)
        for phase, start, end in chain.segments:
            events.append({
                'name': phase, 'cat': 'phase', 'ph': 'X',
                'ts': us(start), 'dur': max(0.0, (end - start) * 1e6),
                'pid': pid, 'tid': int(slot),
                'args': {'request_id': rid,
                         'tenant': chain.tenant or 'default'}})
    # Instant markers for the discrete incidents.
    for rec in records:
        name = INSTANT_EVENTS.get(rec.get('event'))
        if name is None:
            continue
        slot = rec.get('slot')
        args = {k: rec[k] for k in _MARKER_FIELDS
                if rec.get(k) is not None}
        args['event'] = rec['event']
        events.append({
            'name': name, 'cat': 'incident', 'ph': 'i',
            'ts': us(rec.get('ts', t0)),
            'pid': pid_of(rec.get('replica')),
            'tid': int(slot) if slot is not None else 0,
            's': 't' if slot is not None else 'p',
            'args': args})
    # Per-track monotone ts is part of the exported contract (CI
    # validates it) — sort by (ts, pid, tid), stably.
    events.sort(key=lambda e: (e['ts'], e['pid'], e['tid']))
    # Track naming metadata (ph='M') leads the stream.
    meta = []
    for label, pid in sorted(pids.items(), key=lambda kv: kv[1]):
        meta.append({'name': 'process_name', 'ph': 'M', 'ts': 0.0,
                     'pid': pid, 'tid': 0,
                     'args': {'name': label}})
    return {'traceEvents': meta + events, 'displayTimeUnit': 'ms'}


def write_trace(source, path) -> dict:
    """Export and write ``path``; returns the trace object."""
    trace = export_trace(source)
    with open(path, 'w', encoding='utf-8') as f:
        json.dump(trace, f, separators=(',', ':'))
    return trace


def validate_trace(trace) -> List[str]:
    """Schema-check a Chrome-trace object (or JSON string): required
    keys on every event, non-negative ``dur`` on complete slices,
    non-decreasing ``ts`` per (pid, tid) track. Returns error strings
    (empty = valid) — the ``obs trace export`` gate re-loads the
    emitted file through this."""
    errors = []
    if isinstance(trace, (str, bytes)):
        try:
            trace = json.loads(trace)
        except json.JSONDecodeError as e:
            return [f'not JSON: {e}']
    if not isinstance(trace, dict) or 'traceEvents' not in trace:
        return ["missing top-level 'traceEvents'"]
    evs = trace['traceEvents']
    if not isinstance(evs, list):
        return ["'traceEvents' is not a list"]
    last_ts: Dict[tuple, float] = {}
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            errors.append(f'event {i}: not an object')
            continue
        for key in ('name', 'ph', 'ts', 'pid', 'tid'):
            if key not in ev:
                errors.append(f'event {i}: missing {key!r}')
        ph, ts = ev.get('ph'), ev.get('ts')
        if not isinstance(ts, (int, float)):
            errors.append(f'event {i}: non-numeric ts {ts!r}')
            continue
        if ph == 'X':
            dur = ev.get('dur')
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f'event {i}: X without dur>=0 '
                              f'(dur={dur!r})')
        if ph == 'M':
            continue       # metadata is unordered by convention
        track = (ev.get('pid'), ev.get('tid'))
        if ts < last_ts.get(track, float('-inf')):
            errors.append(
                f'event {i}: ts {ts} regresses on track {track}')
        last_ts[track] = ts
    return errors
