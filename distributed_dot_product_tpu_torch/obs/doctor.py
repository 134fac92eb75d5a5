# -*- coding: utf-8 -*-
"""
Post-mortem bundle diagnosis — ``obs doctor BUNDLE``. Copied from
``distributed_dot_product_tpu/obs/doctor.py``: the port's flight bundles
have the reference's layout, so both packages' bundles diagnose alike.

Given a flight-recorder bundle (obs/flight.py), classify the incident
FROM THE BUNDLE ALONE — no live process, no source log — and name who
it hurt. The classifier scores seven incident classes against the
evidence in the ring's event window, the metric snapshot, the thread
stacks and the MANIFEST trigger:

- ``kv_corruption``  — KV pages failed checksum verification:
  ``kv.corrupt`` verdicts, injected ``page_corrupt`` chaos, the
  ``kv_corrupt`` dump trigger, corruption-tagged recovery arcs and
  typed ``kv_corrupt`` terminals. The verdict names the DIRTY member
  (from the kv.corrupt declaration) and the victim streams healed off
  its poisoned pages.
- ``replica_loss``   — a decode replica died mid-stream: a
  ``replica.lost`` declaration, probe-miss streaks, injected replica
  crashes, ``request.recovered`` arcs and typed ``replica_lost``
  terminals. The verdict names the LOST replica (from the declaration
  — the dead member cannot speak for itself).
- ``stuck_step``     — the decode loop stopped beating: watchdog
  liveness-stall transitions, a ``stall`` dump trigger, an injected
  ``stuck_step`` fault, a scheduler thread blocked in a sleep/step.
- ``nan_storm``      — numerics went bad: quarantine events piling up,
  ``failed_nan`` terminals, injected NaN faults, a ``nan_storm`` dump.
- ``cache_exhaustion`` — the paged KV pool ran dry: typed
  ``cache_exhausted`` sheds, preemption events, ``pages_free`` at 0.
- ``deadline_storm`` — latency ate the deadlines: ``deadline_exceeded``
  rejects and ``deadline_expired`` retirements dominating.
- ``overload``       — more traffic than capacity: ``queue_full``
  sheds, NOT_READY(queue full) readiness excursions, degradation.

Every class reports its evidence lines; the primary classification is
the highest score (ties resolve in the order above — a stall is a
sharper finding than the overload it causes). Affected parties come
from the same window via :mod:`~distributed_dot_product_tpu_torch.obs.slo`:
per-tenant goodput over the ring's events, plus the concrete request
ids the incident touched (quarantined / preempted / shed / failed).
"""

import dataclasses
from typing import Dict, List, Optional

from distributed_dot_product_tpu_torch.obs import slo as obs_slo
from distributed_dot_product_tpu_torch.obs.timeline import reconstruct

__all__ = ['Incident', 'diagnose', 'diagnose_bundles',
           'render_incident']

# Classification order = tie-break priority (sharper findings first —
# a dead replica explains the deadline/overload storms downstream of
# it, never the other way around; a corruption verdict explains the
# expulsions and recoveries downstream of IT, so it outranks the
# loss class its healing arc borrows).
CLASSES = ('kv_corruption', 'replica_loss', 'stuck_step', 'nan_storm',
           'cache_exhaustion', 'deadline_storm', 'overload')

_MAX_LISTED = 16    # request ids printed per affected category


@dataclasses.dataclass
class Incident:
    """One diagnosis. ``classes`` maps every incident class to
    ``{'score': float, 'evidence': [str, ...]}``; ``primary`` is the
    winning class (None only for an empty window)."""
    primary: Optional[str]
    classes: Dict[str, dict]
    trigger: Optional[str]
    reason: str
    window: dict
    tenants: Dict[str, dict]
    affected: Dict[str, List[str]]
    anomalies: List[dict]
    notes: List[str]
    # Multi-bundle diagnosis (one bundle per serving replica): the
    # replica whose bundle carries the primary class's strongest
    # evidence — None on a single-bundle diagnosis. A `replica_loss`
    # primary OVERRIDES this with the LOST replica's name (from the
    # replica.lost declaration): the verdict points at the dead
    # member, not at the router whose bundle narrates the loss.
    replica: Optional[str] = None

    def to_dict(self):
        return dataclasses.asdict(self)


def _count(events, name, **match):
    out = 0
    for rec in events:
        if rec.get('event') != name:
            continue
        if all(rec.get(k) == v for k, v in match.items()):
            out += 1
    return out


def _stack_evidence(stacks):
    """Frames that look like a blocked serving loop: a sleep inside
    the fault injector's stuck-step hook, or a thread wedged in the
    engine's compiled dispatch."""
    hits = []
    for thread, frames in (stacks or {}).items():
        text = '\n'.join(frames)
        if 'on_decode_step' in text and 'sleep' in text:
            hits.append(f'thread {thread} blocked in an injected '
                        f'stuck step (fault sleep on the loop stack)')
        elif 'decode_step' in text and 'sleep' in text:
            hits.append(f'thread {thread} sleeping inside a decode '
                        f'step')
    return hits


def diagnose(bundle) -> Incident:
    """Classify ``bundle`` (a dict from
    :func:`~distributed_dot_product_tpu_torch.obs.flight.load_bundle`, or
    a path handed straight to it)."""
    if not isinstance(bundle, dict):
        from distributed_dot_product_tpu_torch.obs import flight
        bundle = flight.load_bundle(bundle)
    manifest = bundle.get('manifest', {})
    events = bundle.get('events', [])
    trigger = manifest.get('trigger')
    reason = manifest.get('reason', '')
    notes = []
    ring = manifest.get('ring', {})
    if ring.get('dropped'):
        notes.append(f'ring evicted {ring["dropped"]} records — the '
                     f'window is truncated; early lifecycle events '
                     f'may be missing')

    scores = {c: {'score': 0.0, 'evidence': []} for c in CLASSES}

    def vote(cls, points, evidence):
        scores[cls]['score'] += points
        scores[cls]['evidence'].append(evidence)

    sched_section = (bundle.get('sections') or {}).get('scheduler') or {}

    # -- KV-corruption evidence -----------------------------------------
    corrupt = [r for r in events if r.get('event') == 'kv.corrupt']
    dirty = [str(r.get('target')) for r in corrupt
             if r.get('target') is not None]
    if corrupt:
        pages = sorted({int(p) for r in corrupt
                        for p in (r.get('pages') or [])})
        # Sequence-sharded replicas attach the owning kv shard(s) to
        # the verdict — fold them in so the diagnosis localizes the
        # flip within the mesh, not just within the pool.
        shards = sorted({int(s) for r in corrupt
                         for s in (r.get('shards') or [])})
        where = f' on kv shard(s) {shards}' if shards else ''
        vote('kv_corruption', 6.0 * len(corrupt),
             f'kv.corrupt verdict(s) on {", ".join(sorted(set(dirty)))}'
             f' — page(s) {pages}{where} quarantined')
    inj_corrupt = _count(events, 'fault.inject', kind='page_corrupt')
    if inj_corrupt:
        vote('kv_corruption', 4.0 * inj_corrupt,
             f'injected fault: page_corrupt x{inj_corrupt}')
    if trigger == 'kv_corrupt':
        vote('kv_corruption', 4.0,
             'bundle dumped by the kv_corrupt trigger')
    corrupt_rec = sum(1 for r in events
                      if r.get('event') == 'request.recovered'
                      and r.get('reason') == 'kv_corrupt')
    if corrupt_rec:
        vote('kv_corruption', min(1.0 * corrupt_rec, 8.0),
             f'{corrupt_rec} victim stream(s) healed off poisoned '
             f'pages through the recovery ledger')
    corrupt_rej = sum(1 for r in events
                      if r.get('event') == 'serve.reject'
                      and r.get('reason') == 'kv_corrupt')
    if corrupt_rej:
        vote('kv_corruption', 2.0 * corrupt_rej,
             f'{corrupt_rej} typed kv_corrupt terminal(s)')

    # -- replica-loss evidence ------------------------------------------
    lost = [str(r.get('target')) for r in events
            if r.get('event') == 'replica.lost'
            and r.get('target') is not None]
    if lost:
        vote('replica_loss', 6.0 * len(lost),
             f'replica.lost declared for {", ".join(lost)}')
    inj_crash = (_count(events, 'fault.inject', kind='replica_crash')
                 + _count(events, 'fault.inject', kind='handoff_crash')
                 + _count(events, 'fault.inject',
                          kind='probe_blackhole'))
    if inj_crash:
        vote('replica_loss', 4.0 * inj_crash,
             f'injected fault: replica-scoped chaos x{inj_crash}')
    if trigger == 'replica_lost':
        vote('replica_loss', 4.0,
             'bundle dumped by the replica_lost trigger')
    # Corruption-tagged recoveries vote for kv_corruption above, not
    # here: the ledger arc is shared, the root cause is not.
    recovered = sum(1 for r in events
                    if r.get('event') == 'request.recovered'
                    and r.get('reason') != 'kv_corrupt')
    if recovered:
        vote('replica_loss', min(1.0 * recovered, 8.0),
             f'{recovered} stream(s) resolved through the recovery '
             f'ledger')
    lost_rej = sum(1 for r in events
                   if r.get('event') == 'serve.reject'
                   and r.get('reason') == 'replica_lost')
    if lost_rej:
        vote('replica_loss', 2.0 * lost_rej,
             f'{lost_rej} typed replica_lost terminal(s)')
    probe_missed = _count(events, 'replica.probe', state='missed')
    if probe_missed:
        vote('replica_loss', min(0.5 * probe_missed, 2.0),
             f'{probe_missed} liveness probe miss(es)')

    # -- stall evidence -------------------------------------------------
    stalls = _count(events, 'health.liveness', state='stalled')
    if stalls:
        vote('stuck_step', 6.0 * stalls,
             f'watchdog liveness went STALLED {stalls}x')
    inj_stuck = _count(events, 'fault.inject', kind='stuck_step')
    if inj_stuck:
        vote('stuck_step', 4.0 * inj_stuck,
             f'injected fault: stuck_step x{inj_stuck}')
    if trigger == 'stall':
        vote('stuck_step', 4.0, 'bundle dumped by the stall trigger')
    if sched_section.get('liveness') == 'stalled':
        age = sched_section.get('last_beat_age_s')
        vote('stuck_step', 3.0,
             'scheduler introspection shows liveness STALLED at dump '
             'time' + (f' (last beat {age:.2f}s ago)'
                       if isinstance(age, (int, float)) else ''))
    for hit in _stack_evidence(bundle.get('stacks')):
        vote('stuck_step', 2.0, hit)

    # -- NaN evidence ---------------------------------------------------
    quarantines = _count(events, 'serve.quarantine')
    if quarantines:
        vote('nan_storm', 2.0 * quarantines,
             f'{quarantines} slot quarantine(s)')
    failed = _count(events, 'serve.retire', status='failed_nan')
    if failed:
        vote('nan_storm', 3.0 * failed,
             f'{failed} request(s) failed_nan (requeues exhausted)')
    inj_nan = (_count(events, 'fault.inject', kind='nan_slot')
               + _count(events, 'fault.inject', kind='nan_batch'))
    if inj_nan:
        vote('nan_storm', 2.0 * inj_nan,
             f'injected fault: nan x{inj_nan}')
    if trigger == 'nan_storm':
        vote('nan_storm', 4.0, 'bundle dumped by the NaN-storm trigger')

    # -- cache-exhaustion evidence --------------------------------------
    # Drain preempts (serve.preempt with drain=true) are elastic
    # membership changes, not a dry pool — they must not vote here.
    preempts = sum(1 for r in events
                   if r.get('event') == 'serve.preempt'
                   and not r.get('drain'))
    if preempts:
        vote('cache_exhaustion', 2.0 * preempts,
             f'{preempts} page-pool preemption(s)')
    cache_rej = sum(1 for r in events
                    if r.get('event') in ('serve.reject', 'serve.retire')
                    and r.get('reason') == 'cache_exhausted')
    if cache_rej:
        vote('cache_exhaustion', 3.0 * cache_rej,
             f'{cache_rej} typed cache_exhausted shed(s)')
    for sample in bundle.get('metric_samples', []):
        gauges = (sample.get('metrics') or {}).get('gauges', {})
        free = gauges.get('serve.cache.pages_free')
        total_used = gauges.get('serve.cache.pages_used', 0)
        if free == 0 and total_used:
            vote('cache_exhaustion', 2.0,
                 'a metric sample shows pages_free == 0')
            break

    # -- deadline evidence ----------------------------------------------
    dl = (sum(1 for r in events if r.get('event') == 'serve.reject'
              and r.get('reason') == 'deadline_exceeded')
          + _count(events, 'serve.retire', status='deadline_expired'))
    if dl:
        vote('deadline_storm', min(1.0 * dl, 10.0),
             f'{dl} deadline miss(es) (typed rejects + expirations)')

    # -- overload evidence ----------------------------------------------
    qfull = sum(1 for r in events if r.get('event') == 'serve.reject'
                and r.get('reason') == 'queue_full')
    if qfull:
        vote('overload', min(1.0 * qfull, 8.0),
             f'{qfull} queue_full shed(s)')
    not_ready = sum(1 for r in events
                    if r.get('event') == 'health.readiness'
                    and r.get('state') == 'not_ready'
                    and 'queue' in str(r.get('reason', '')))
    if not_ready:
        vote('overload', min(1.0 * not_ready, 4.0),
             f'readiness went NOT_READY (queue full) {not_ready}x')
    degraded = sum(1 for r in events
                   if r.get('event') == 'health.readiness'
                   and r.get('state') == 'degraded')
    if degraded:
        vote('overload', min(0.5 * degraded, 2.0),
             f'readiness DEGRADED under pressure {degraded}x')

    # -- control-plane arcs (serve/control.py) --------------------------
    # The controller's own record of the incident: tightening and
    # scale-ups are overload evidence (the loop SAW more traffic than
    # capacity and acted); page-driven tightening points at the pool.
    adjusts = [r for r in events if r.get('event') == 'control.adjust']
    tightened = [r for r in adjusts
                 if str(r.get('reason', '')).startswith(
                     ('breach', 'pressure'))]
    if tightened:
        vote('overload', min(0.5 * len(tightened), 2.0),
             f'controller tightened admission {len(tightened)}x')
    # 'breach:pages_free' and 'pressure:page_pool:<v>' both point at
    # the paged KV pool as the tightening driver.
    pages_driven = [r for r in tightened
                    if 'page' in str(r.get('reason', ''))]
    if pages_driven:
        vote('cache_exhaustion', min(0.5 * len(pages_driven), 2.0),
             f'controller tightened on page-pool signals '
             f'{len(pages_driven)}x')
    ups = _count(events, 'control.scale', direction='up')
    if ups:
        vote('overload', min(1.0 * ups, 4.0),
             f'controller scaled decode replicas up {ups}x')
    drains = _count(events, 'control.drain')
    scale_downs = _count(events, 'control.scale', direction='down')
    if adjusts or ups or drains or scale_downs:
        notes.append(f'control plane acted in this window: '
                     f'{len(adjusts)} knob adjust(s), {ups} scale-up(s), '
                     f'{scale_downs} scale-down(s), {drains} drain(s)')

    # -- anomaly verdicts ride along as supporting context --------------
    anomalies = [r for r in events if r.get('event') == 'anomaly.detected']
    for rec in anomalies:
        watch = str(rec.get('watch', rec.get('metric', '')))
        if 'ttft' in watch or 'token' in watch:
            vote('stuck_step', 0.5,
                 f'anomaly detector tripped on {watch}')
        if 'queue' in watch or 'reject' in watch:
            vote('overload', 0.5,
                 f'anomaly detector tripped on {watch}')
        if 'pages' in watch:
            vote('cache_exhaustion', 0.5,
                 f'anomaly detector tripped on {watch}')

    # -- critpath section: where the window's time actually went --------
    # The flight recorder's stock provider (obs/flight.py) embeds the
    # ring's critical-path summary; the dominant phase is evidence in
    # its own right (queue-dominant windows are overload, stall-
    # dominant ones point at the pool's preempt/requeue churn) and the
    # verdict names it either way.
    crit = (bundle.get('sections') or {}).get('critpath') or {}
    crit_phases = crit.get('phases') or {}
    if crit_phases:
        dominant = max(crit_phases, key=crit_phases.get)
        total_s = sum(crit_phases.values()) or 1.0
        share = 100.0 * crit_phases[dominant] / total_s
        notes.append(
            f'critpath: dominant phase of the incident window is '
            f'{dominant!r} ({share:.0f}% of the attributed time over '
            f'{crit.get("requests", 0)} request(s))')
        if dominant == 'queue':
            vote('overload', 1.0,
                 f'critpath: queue is the dominant phase '
                 f'({share:.0f}% of attributed time)')
        elif dominant == 'stall':
            vote('cache_exhaustion', 1.0,
                 f'critpath: requeue stalls dominate '
                 f'({share:.0f}% of attributed time)')
        disp = (crit.get('dispatch') or {}).get('total') or {}
        if disp.get('overhead_per_token') is not None:
            notes.append(
                f'critpath: host dispatch overhead '
                f'{disp["overhead_per_token"] * 1e3:.3f} ms/token '
                f'over {disp.get("ticks", 0)} decode tick(s)')

    ranked = sorted(CLASSES,
                    key=lambda c: (-scores[c]['score'],
                                   CLASSES.index(c)))
    primary = ranked[0] if scores[ranked[0]]['score'] > 0 else None

    # -- who it hurt: per-tenant goodput + concrete request ids --------
    timelines = reconstruct(events)
    spec = obs_slo.SloSpec()        # deadline-free: classes met /
    report = obs_slo.goodput(events, spec)  # rejected / incomplete
    tenants = {t: {'requests': tb['requests'],
                   'met': tb['counts']['met'],
                   'rejected': tb['counts']['rejected'],
                   'incomplete': tb['counts']['incomplete']}
               for t, tb in sorted(report.per_tenant.items())}
    affected = {'quarantined': [], 'preempted': [], 'recovered': [],
                'rejected': [], 'failed': [], 'incomplete': [],
                'in_flight': []}
    # The slot table at dump time: who was ON the device when the
    # incident hit (a mid-run bundle's events alone can't tell which
    # incompletes actually held slots).
    for slot in sched_section.get('slots', []):
        rid = slot.get('request_id')
        if rid and rid not in affected['in_flight']:
            affected['in_flight'].append(rid)
    for rid, tl in sorted(timelines.items()):
        if tl.quarantines:
            affected['quarantined'].append(rid)
        if tl.preempts:
            affected['preempted'].append(rid)
        if tl.recoveries:
            affected['recovered'].append(rid)
        if tl.status == 'rejected':
            affected['rejected'].append(rid)
        elif tl.status in ('failed_nan', 'evicted', 'deadline_expired'):
            affected['failed'].append(rid)
        elif tl.status is None:
            affected['incomplete'].append(rid)

    ts = [r['ts'] for r in events
          if isinstance(r.get('ts'), (int, float))]
    window = {'events': len(events),
              'first_ts': min(ts) if ts else None,
              'last_ts': max(ts) if ts else None,
              'ring_dropped': ring.get('dropped', 0)}
    if not events:
        notes.append('the bundle carries no events — was an event log '
                     'active when the recorder ran?')
    # A replica_loss verdict names the DEAD member from the
    # declaration (the latest, if several fell); a kv_corruption
    # verdict names the DIRTY one the same way.
    where = None
    if primary == 'replica_loss' and lost:
        where = lost[-1]
    elif primary == 'kv_corruption' and dirty:
        where = dirty[-1]
    return Incident(primary=primary, classes=scores, trigger=trigger,
                    reason=reason, window=window, tenants=tenants,
                    affected=affected, anomalies=anomalies, notes=notes,
                    replica=where)


def diagnose_bundles(labeled) -> Incident:
    """Diagnose a SET of per-replica bundles — a disaggregated
    topology dumps one black box per decode pool, and the incident
    verdict must say WHICH replica it happened on. ``labeled`` is an
    iterable of ``(replica, bundle_or_path)`` pairs; one pair
    degenerates to :func:`diagnose` (no labels in the output, the
    single-process contract unchanged).

    Merge semantics: per-class scores SUM across bundles (evidence
    lines are prefixed ``[replica]``), the primary class is the
    argmax of the merged scores, and :attr:`Incident.replica` names
    the bundle contributing the most primary-class score — the
    replica the verdict points at. Affected request ids are prefixed
    ``replica:`` so an id names where its lifecycle ran; per-tenant
    counts sum (a tenant's requests span replicas)."""
    labeled = list(labeled)
    if not labeled:
        raise ValueError('diagnose_bundles needs at least one bundle')
    if len(labeled) == 1:
        return diagnose(labeled[0][1])
    incidents = [(str(label), diagnose(bundle))
                 for label, bundle in labeled]
    scores = {c: {'score': 0.0, 'evidence': []} for c in CLASSES}
    tenants: Dict[str, dict] = {}
    affected = {}
    anomalies, notes = [], []
    first_ts, last_ts = [], []
    n_events = dropped = 0
    for label, inc in incidents:
        for cls in CLASSES:
            info = inc.classes[cls]
            scores[cls]['score'] += info['score']
            scores[cls]['evidence'] += [f'[{label}] {ev}'
                                        for ev in info['evidence']]
        for tenant, tb in inc.tenants.items():
            agg = tenants.setdefault(tenant, {k: 0 for k in tb})
            for k, v in tb.items():
                agg[k] = agg.get(k, 0) + v
        for cat, ids in inc.affected.items():
            affected.setdefault(cat, []).extend(
                f'{label}:{rid}' for rid in ids)
        # Anomaly records carry their replica too (every other merged
        # field names its source — an unattributed anomaly would read
        # as the wrong replica's).
        anomalies += [{**rec, 'replica': label}
                      for rec in inc.anomalies]
        notes += [f'[{label}] {n}' for n in inc.notes]
        w = inc.window
        n_events += w['events']
        dropped += w.get('ring_dropped', 0)
        if w['first_ts'] is not None:
            first_ts.append(w['first_ts'])
            last_ts.append(w['last_ts'])
    ranked = sorted(CLASSES, key=lambda c: (-scores[c]['score'],
                                            CLASSES.index(c)))
    primary = ranked[0] if scores[ranked[0]]['score'] > 0 else None
    where = trigger = None
    reason = ''
    if primary is not None:
        where, inc = max(
            incidents, key=lambda li: li[1].classes[primary]['score'])
        trigger, reason = inc.trigger, inc.reason
        if primary in ('replica_loss', 'kv_corruption') \
                and inc.replica is not None:
            # The strongest evidence lives in the ROUTER's bundle (the
            # corpse cannot narrate its own death, and the corruption
            # verdict is the router's) — but the verdict must name the
            # replica it happened ON, not the narrator.
            where = inc.replica
    window = {'events': n_events,
              'first_ts': min(first_ts) if first_ts else None,
              'last_ts': max(last_ts) if last_ts else None,
              'ring_dropped': dropped}
    return Incident(primary=primary, classes=scores, trigger=trigger,
                    reason=reason, window=window,
                    tenants=dict(sorted(tenants.items())),
                    affected=affected, anomalies=anomalies,
                    notes=notes, replica=where)


def _fmt_ids(ids):
    shown = ' '.join(ids[:_MAX_LISTED])
    more = len(ids) - _MAX_LISTED
    return shown + (f' (+{more} more)' if more > 0 else '')


def render_incident(incident: Incident) -> str:
    """The human incident report ``obs doctor`` prints."""
    parts = []
    primary = incident.primary or 'inconclusive'
    score = (incident.classes.get(incident.primary, {}).get('score', 0)
             if incident.primary else 0)
    parts.append(f'INCIDENT: {primary} (score {score:.1f}'
                 + (f', replica {incident.replica}'
                    if incident.replica else '')
                 + (f', dump trigger: {incident.trigger}'
                    if incident.trigger else '') + ')')
    if incident.reason:
        parts.append(f'  reason: {incident.reason}')
    w = incident.window
    parts.append(f'  window: {w["events"]} events'
                 + (f' over {w["last_ts"] - w["first_ts"]:.2f}s'
                    if w['first_ts'] is not None else '')
                 + (f', ring dropped {w["ring_dropped"]}'
                    if w['ring_dropped'] else ''))
    parts.append('classification:')
    for cls in sorted(incident.classes,
                      key=lambda c: -incident.classes[c]['score']):
        info = incident.classes[cls]
        if not info['score']:
            continue
        parts.append(f'  {cls:18} {info["score"]:6.1f}')
        for ev in info['evidence']:
            parts.append(f'      - {ev}')
    if not any(i['score'] for i in incident.classes.values()):
        parts.append('  (no incident evidence in the window)')
    if incident.anomalies:
        parts.append(f'anomaly verdicts: {len(incident.anomalies)}')
        for rec in incident.anomalies[:8]:
            where = (f'[{rec["replica"]}] ' if rec.get('replica')
                     else '')
            parts.append(f'  - {where}'
                         f'{rec.get("watch", rec.get("metric"))}: '
                         f'{rec.get("detector")} value='
                         f'{rec.get("value")}')
    parts.append('affected tenants:')
    if incident.tenants:
        for tenant, tb in incident.tenants.items():
            parts.append(f'  {tenant:12} {tb["requests"]:4d} requests: '
                         f'{tb["met"]} completed in-SLO-window, '
                         f'{tb["rejected"]} rejected, '
                         f'{tb["incomplete"]} incomplete/failed')
    else:
        parts.append('  (no request lifecycle in the window)')
    for cat, ids in incident.affected.items():
        if ids:
            parts.append(f'affected requests ({cat}): {_fmt_ids(ids)}')
    for note in incident.notes:
        parts.append(f'note: {note}')
    return '\n'.join(parts)
