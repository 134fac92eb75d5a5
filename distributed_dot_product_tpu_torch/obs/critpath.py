# -*- coding: utf-8 -*-
"""
Critical-path latency attribution over the JSONL event log. Copied
from ``distributed_dot_product_tpu/obs/critpath.py``: the port's serving
path emits the reference's events and fields, so the same log gives the
same chains.

obs/timeline.py answers "did every request live a legal lifecycle";
this module answers "where did its time GO". From the merged
multi-replica stream alone it reconstructs each request's causal phase
chain —

    submit ──queue──▶ admit ──prefill──▶ first token ──decode──▶ …
           … ──stall──▶ re-admit … ──commit──▶ retire
    (with `handoff` segments where the prefill pool built and
    transferred the KV, and `queue` collapsing to the whole chain for
    a shed request)

— as adjacent timestamp segments that PARTITION the request's e2e
latency exactly. The submit anchor is derived from the terminal record
(`ts − total_seconds`, both stamped on the scheduler's own clock), so
on a virtual-clock run the partition is exact to float rounding: the
check `sum(phases) == e2e` within 1e-6 is a standing gate (``obs
critpath`` exits 1 on a failure), not a hope.

Two aggregations ride on the chains:

- :func:`profile` — per-tenant / per-replica phase totals plus the
  tail cohort ("where does p99 e2e go": the mean phase split of the
  requests at or above the p99 e2e), the view ROADMAP item 5 needs
  before attacking any one phase.
- :func:`dispatch_floor` — the host-loop share of each decode tick,
  folded from `serve.dispatch` records (tick wall seconds vs device-
  program seconds, REAL time): the measured ~0.212 ms/step floor as a
  per-replica, per-token number next to the virtual-time phases it
  does NOT contaminate.

CLI: ``python -m distributed_dot_product_tpu_torch.obs critpath LOG
[replica=LOG ...] [--json]`` — exits non-zero when any completed
request's phases fail to partition its e2e.
"""

import dataclasses
import json
from typing import Dict, List, Optional

from distributed_dot_product_tpu_torch.obs.events import (
    merge_events, read_events,
)
from distributed_dot_product_tpu_torch.obs.timeline import _is_multi_source

__all__ = ['PhaseChain', 'attribute', 'profile', 'dispatch_floor',
           'summarize_records', 'render_report', 'PARTITION_TOL',
           'PHASES']

# The closed phase vocabulary, in causal order. Every e2e second of
# every request lands in exactly one of these.
PHASES = ('queue', 'handoff', 'prefill', 'decode', 'stall', 'commit')

# |sum(phases) − e2e| gate. Virtual-clock runs are exact to float
# rounding; this absorbs the rounding, nothing else.
PARTITION_TOL = 1e-6

# Request-scoped events the attribution walks (the same prefixes the
# timeline automaton collects — serve.dispatch carries no request_id
# and is aggregated separately by dispatch_floor).
_REQ_PREFIXES = ('serve.', 'spec.', 'router.', 'prefill.', 'request.')


@dataclasses.dataclass
class PhaseChain:
    """One request's phase-attributed lifecycle."""
    request_id: str
    tenant: Optional[str] = None
    status: Optional[str] = None       # terminal status, None = torn
    reason: Optional[str] = None
    replicas: List[str] = dataclasses.field(default_factory=list)
    # Adjacent (phase, start_ts, end_ts) segments covering
    # [submit_ts, terminal_ts]; zero-width segments are dropped.
    segments: List[tuple] = dataclasses.field(default_factory=list)
    # {phase: seconds} — the partition. Phases with zero time absent.
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)
    e2e: Optional[float] = None        # stamped total_seconds
    submit_ts: Optional[float] = None
    # handoff build/transfer split (REAL seconds, summed over the
    # request's prefill.handoff records) — rides alongside the
    # virtual-time phases, never inside them.
    handoff_build: float = 0.0
    handoff_transfer: float = 0.0
    tokens: int = 0
    stalls: int = 0                    # requeue arcs (preempt/
    #                                    quarantine/recovery)
    partial: bool = False              # no terminal / no e2e anchor:
    #                                    attributed best-effort, never
    #                                    asserted against
    errors: List[str] = dataclasses.field(default_factory=list)

    @property
    def partition_error(self) -> Optional[float]:
        """|sum(phases) − e2e|, None while unanchored."""
        if self.e2e is None:
            return None
        return abs(sum(self.phases.values()) - self.e2e)

    @property
    def ok(self) -> bool:
        """Partition holds and the chain closed cleanly."""
        if self.partial:
            return not self.errors
        err = self.partition_error
        return not self.errors and err is not None \
            and err <= PARTITION_TOL


def _submit_anchor(recs):
    """The submit-time anchor, in preference order: terminal ts −
    total_seconds (exact — both stamps share the scheduler clock),
    else first admit ts − queue_wait, else the first record's ts
    (partial chain, zero-width first segment). Returns
    ``(submit_ts, e2e, partial)``."""
    terminal_ts = total = None
    for rec in recs:
        if rec.get('event') in ('serve.retire', 'serve.reject') \
                and rec.get('total_seconds') is not None:
            terminal_ts, total = rec['ts'], rec['total_seconds']
    if terminal_ts is not None:
        return terminal_ts - total, total, False
    for rec in recs:
        if rec.get('event') == 'serve.admit' \
                and rec.get('queue_wait') is not None:
            return rec['ts'] - rec['queue_wait'], None, True
    return (recs[0].get('ts', 0.0), None, True) if recs \
        else (0.0, None, True)


def _attribute_one(rid, recs) -> PhaseChain:
    """Walk one request's merged records, cutting a phase segment at
    every record boundary. State machine mirrors the timeline
    automaton; the phase of a segment is a function of the state the
    request was IN while the segment elapsed (plus the handoff
    override — the pool's build+transfer is its own causal link)."""
    chain = PhaseChain(request_id=rid)
    submit_ts, e2e, partial = _submit_anchor(recs)
    chain.submit_ts, chain.e2e, chain.partial = submit_ts, e2e, partial
    state = 'queued'        # queued | prefill | decode | stalled | done
    prev_ts = submit_ts
    phases = {}

    def cut(phase, ts):
        nonlocal prev_ts
        dur = ts - prev_ts
        if dur < -PARTITION_TOL:
            chain.errors.append(
                f'non-monotone ts at {phase}: {ts} < {prev_ts}')
            dur = 0.0
        dur = max(0.0, dur)
        if dur > 0.0:
            phases[phase] = phases.get(phase, 0.0) + dur
            chain.segments.append((phase, prev_ts, ts))
        prev_ts = max(prev_ts, ts)

    for rec in recs:
        ev = rec.get('event', '')
        ts = rec.get('ts', prev_ts)
        if chain.tenant is None and rec.get('tenant') is not None:
            chain.tenant = rec['tenant']
        replica = rec.get('replica')
        if replica is not None and replica not in chain.replicas:
            chain.replicas.append(replica)
        if state == 'done':
            # After-terminal records are the timeline automaton's
            # violation to flag; attribution just stops the clock.
            continue
        if ev == 'prefill.handoff':
            cut('handoff', ts)
            chain.handoff_build += rec.get('build_seconds') or 0.0
            chain.handoff_transfer += rec.get('transfer_seconds') or 0.0
            continue
        if ev in ('router.route', 'serve.degrade', 'spec.propose',
                  'spec.verify', 'serve.prefill', 'serve.evict'):
            # Same-state markers: the segment they end stays in the
            # current phase (route/degrade elapse in the queue,
            # prefill chunks in the prefill phase, spec bookkeeping in
            # decode, the evict instant in whatever preceded its
            # terminal).
            cut(_STATE_PHASE[state], ts)
            continue
        if ev == 'serve.admit':
            cut(_STATE_PHASE[state], ts)
            state = 'prefill'
        elif ev == 'serve.decode':
            cut('prefill' if state == 'prefill' else 'decode', ts)
            state = 'decode'
            chain.tokens += 1
        elif ev in ('serve.quarantine', 'serve.preempt'):
            cut(_STATE_PHASE[state], ts)
            if rec.get('requeued'):
                state = 'stalled'
                chain.stalls += 1
        elif ev == 'request.recovered':
            cut(_STATE_PHASE[state], ts)
            state = 'stalled'
            chain.stalls += 1
        elif ev in ('serve.retire', 'serve.reject'):
            cut('commit' if state == 'decode'
                else _STATE_PHASE[state], ts)
            chain.status = ('rejected' if ev == 'serve.reject'
                            else rec.get('status'))
            chain.reason = rec.get('reason')
            state = 'done'
        else:
            cut(_STATE_PHASE[state], ts)
    if state != 'done':
        chain.partial = True
    chain.phases = phases
    return chain


# Phase a second belongs to while the request sits in each automaton
# state (the queued→'queue' vs →'stall' split is first-attempt-aware
# at the call sites above).
_STATE_PHASE = {'queued': 'queue', 'prefill': 'prefill',
                'decode': 'decode', 'stalled': 'stall',
                'done': 'commit'}


def attribute(source) -> Dict[str, PhaseChain]:
    """Phase-attribute EVERY request in ``source`` (a log path, an
    EventLog, decoded records, or a list of paths / ``(replica,
    path)`` pairs merged via
    :func:`~distributed_dot_product_tpu_torch.obs.events.merge_events`).
    Returns ``{request_id: PhaseChain}``."""
    records = (merge_events(source) if _is_multi_source(source)
               else read_events(source))
    per_request: Dict[str, List[dict]] = {}
    for rec in records:
        rid = rec.get('request_id')
        if rid is not None \
                and rec.get('event', '').startswith(_REQ_PREFIXES):
            per_request.setdefault(rid, []).append(rec)
    return {rid: _attribute_one(rid, recs)
            for rid, recs in per_request.items()}


def _percentile(values, q):
    if not values:
        return None
    vals = sorted(values)
    idx = min(len(vals) - 1, int(round(q / 100.0 * (len(vals) - 1))))
    return vals[idx]


def _phase_totals(chains):
    out = {p: 0.0 for p in PHASES}
    for c in chains:
        for p, v in c.phases.items():
            out[p] = out.get(p, 0.0) + v
    return {p: v for p, v in out.items() if v > 0.0}


def profile(chains, dispatch=None) -> dict:
    """Aggregate critical-path profile over ``chains`` (an
    :func:`attribute` result or its values). Returns a plain dict
    (JSON-ready):

    - ``requests`` / ``complete`` / ``partial`` / ``partition_failures``
    - ``phases``: total seconds per phase, all requests
    - ``tail``: the p99-e2e cohort's phase split — "where does p99 go"
    - ``ttft_tail``: same cohort cut on p99 TTFT-side phases
      (queue+handoff+prefill)
    - ``by_tenant`` / ``by_replica``: per-group phase totals + e2e p50/p99
    - ``handoff``: build/transfer REAL-seconds split summed
    - ``dispatch``: :func:`dispatch_floor` result, when records given
    """
    if isinstance(chains, dict):
        chains = list(chains.values())
    anchored = [c for c in chains if not c.partial]
    failures = [c for c in anchored
                if (c.partition_error or 0.0) > PARTITION_TOL
                or c.errors]
    out = {
        'requests': len(chains),
        'complete': len(anchored),
        'partial': sum(c.partial for c in chains),
        'partition_failures': [c.request_id for c in failures],
        'phases': _phase_totals(chains),
        'handoff': {
            'build_seconds': sum(c.handoff_build for c in chains),
            'transfer_seconds': sum(c.handoff_transfer
                                    for c in chains),
        },
    }
    e2es = [c.e2e for c in anchored if c.e2e is not None]
    out['e2e'] = {'p50': _percentile(e2es, 50),
                  'p99': _percentile(e2es, 99),
                  'count': len(e2es)}
    p99 = _percentile(e2es, 99)
    if p99 is not None:
        cohort = [c for c in anchored
                  if c.e2e is not None and c.e2e >= p99]
        out['tail'] = {'cohort': len(cohort),
                       'phases': _phase_totals(cohort)}
    ttfts = [sum(c.phases.get(p, 0.0)
                 for p in ('queue', 'handoff', 'prefill'))
             for c in anchored if c.tokens]
    t99 = _percentile(ttfts, 99)
    if t99 is not None:
        cohort = [c for c in anchored if c.tokens and
                  sum(c.phases.get(p, 0.0)
                      for p in ('queue', 'handoff', 'prefill')) >= t99]
        out['ttft_tail'] = {'cohort': len(cohort),
                            'phases': _phase_totals(cohort)}
    for key, group in (('by_tenant', lambda c: c.tenant or 'default'),
                       ('by_replica',
                        lambda c: c.replicas[-1] if c.replicas
                        else 'unlabeled')):
        buckets: Dict[str, list] = {}
        for c in chains:
            buckets.setdefault(group(c), []).append(c)
        out[key] = {
            name: {
                'requests': len(cs),
                'phases': _phase_totals(cs),
                'e2e_p99': _percentile(
                    [c.e2e for c in cs if c.e2e is not None], 99),
            } for name, cs in sorted(buckets.items())}
    if dispatch is not None:
        out['dispatch'] = dispatch
    return out


def dispatch_floor(source) -> dict:
    """Fold ``serve.dispatch`` records (per decode tick: REAL tick
    wall seconds vs device-program seconds) into the host-loop floor
    per replica: tick count, total/mean overhead, overhead share of
    tick time, and overhead per committed token — the number ROADMAP
    item 5's multi-tick decode has to beat."""
    records = (merge_events(source) if _is_multi_source(source)
               else read_events(source))
    per_replica: Dict[str, dict] = {}
    for rec in records:
        if rec.get('event') != 'serve.dispatch':
            continue
        name = rec.get('replica', 'unlabeled')
        agg = per_replica.setdefault(
            name, {'ticks': 0, 'tick_seconds': 0.0,
                   'device_seconds': 0.0, 'overhead_seconds': 0.0,
                   'tokens': 0})
        agg['ticks'] += 1
        tick = rec.get('tick_seconds') or 0.0
        dev = rec.get('device_seconds') or 0.0
        agg['tick_seconds'] += tick
        agg['device_seconds'] += dev
        agg['overhead_seconds'] += rec.get('overhead',
                                           max(0.0, tick - dev))
        agg['tokens'] += rec.get('tokens') or 0
    for agg in per_replica.values():
        agg['overhead_share'] = (
            agg['overhead_seconds'] / agg['tick_seconds']
            if agg['tick_seconds'] > 0 else None)
        agg['overhead_per_token'] = (
            agg['overhead_seconds'] / agg['tokens']
            if agg['tokens'] > 0 else None)
    total = {'ticks': sum(a['ticks'] for a in per_replica.values()),
             'overhead_seconds': sum(a['overhead_seconds']
                                     for a in per_replica.values()),
             'tokens': sum(a['tokens']
                           for a in per_replica.values())}
    total['overhead_per_token'] = (
        total['overhead_seconds'] / total['tokens']
        if total['tokens'] > 0 else None)
    return {'per_replica': per_replica, 'total': total}


def summarize_records(records) -> dict:
    """One-shot critpath summary over already-decoded records — the
    flight-recorder provider's entry point (the post-mortem ring IS a
    record list; no filesystem round trip at dump time). The ring may
    interleave several logs' tee streams (router + replicas in one
    process share one recorder), so records order by ``(ts, seq)``
    here — NOT per-source seq, which the ring does not preserve."""
    recs = sorted(records,
                  key=lambda r: (r.get('ts', 0), r.get('seq', 0)))
    per_request: Dict[str, List[dict]] = {}
    for rec in recs:
        rid = rec.get('request_id')
        if rid is not None \
                and rec.get('event', '').startswith(_REQ_PREFIXES):
            per_request.setdefault(rid, []).append(rec)
    chains = {rid: _attribute_one(rid, rs)
              for rid, rs in per_request.items()}
    return profile(chains, dispatch=dispatch_floor(recs))


def _fmt_s(v):
    return '-' if v is None else f'{v * 1000:.3f}ms'


def render_report(prof: dict) -> str:
    """The human-facing ``obs critpath`` text report."""
    lines = []
    lines.append(
        f"requests={prof['requests']} complete={prof['complete']} "
        f"partial={prof['partial']} "
        f"partition_failures={len(prof['partition_failures'])}")
    e2e = prof.get('e2e') or {}
    lines.append(f"e2e: p50={_fmt_s(e2e.get('p50'))} "
                 f"p99={_fmt_s(e2e.get('p99'))} "
                 f"n={e2e.get('count', 0)}")
    total = sum(prof.get('phases', {}).values()) or 1.0
    lines.append('phase totals (all requests):')
    for p in PHASES:
        v = prof.get('phases', {}).get(p)
        if v:
            lines.append(f'  {p:<8} {v:12.6f}s  '
                         f'{100.0 * v / total:5.1f}%')
    for key, title in (('tail', 'p99-e2e cohort'),
                       ('ttft_tail', 'p99-TTFT cohort')):
        sec = prof.get(key)
        if sec:
            split = sec.get('phases', {})
            tot = sum(split.values()) or 1.0
            parts = ' '.join(
                f'{p}={100.0 * split[p] / tot:.1f}%'
                for p in PHASES if p in split)
            lines.append(f"{title} (n={sec['cohort']}): {parts}")
    ho = prof.get('handoff') or {}
    if ho.get('build_seconds') or ho.get('transfer_seconds'):
        lines.append(
            f"handoff split (real): "
            f"build={ho['build_seconds']:.6f}s "
            f"transfer={ho['transfer_seconds']:.6f}s")
    for key in ('by_tenant', 'by_replica'):
        groups = prof.get(key) or {}
        if len(groups) > 1 or key == 'by_replica':
            lines.append(f'{key[3:]} breakdown:')
            for name, g in groups.items():
                split = g.get('phases', {})
                tot = sum(split.values()) or 1.0
                parts = ' '.join(
                    f'{p}={100.0 * split[p] / tot:.1f}%'
                    for p in PHASES if p in split)
                lines.append(
                    f"  {name:<12} n={g['requests']:<4} "
                    f"e2e_p99={_fmt_s(g.get('e2e_p99'))} {parts}")
    disp = prof.get('dispatch') or {}
    if disp.get('total', {}).get('ticks'):
        lines.append('dispatch floor (REAL seconds, host-loop share '
                     'of decode ticks):')
        for name, agg in sorted(disp['per_replica'].items()):
            share = agg.get('overhead_share')
            ptok = agg.get('overhead_per_token')
            lines.append(
                f"  {name:<12} ticks={agg['ticks']:<6} "
                f"overhead={agg['overhead_seconds']:.6f}s "
                f"share={share * 100:.1f}% "
                f"per_token={_fmt_s(ptok)}"
                if share is not None else
                f"  {name:<12} ticks={agg['ticks']}")
        tot = disp['total']
        lines.append(
            f"  total        ticks={tot['ticks']:<6} "
            f"overhead={tot['overhead_seconds']:.6f}s "
            f"per_token={_fmt_s(tot.get('overhead_per_token'))}")
    if prof.get('partition_failures'):
        lines.append('PARTITION FAILURES: '
                     + ', '.join(prof['partition_failures']))
    return '\n'.join(lines)


def to_json(prof: dict) -> str:
    return json.dumps(prof, indent=2, sort_keys=True, default=str)
