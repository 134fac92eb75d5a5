# -*- coding: utf-8 -*-
"""
Offline event-log tooling::

    python -m distributed_dot_product_tpu_torch.obs validate LOG [LOG...]
        [--require event[,event...]] [--timelines]
    python -m distributed_dot_product_tpu_torch.obs stats LOG [LOG...]
        [--percentiles] [--json]
    python -m distributed_dot_product_tpu_torch.obs timeline LOG REQUEST_ID
        [--json]
    python -m distributed_dot_product_tpu_torch.obs slo report LOG [LOG...]
        [--ttft S] [--per-token S] [--e2e S] [--spec SPEC.json]
        [--baseline-out SLO_BASELINE.json] [--json]
    python -m distributed_dot_product_tpu_torch.obs slo check LOG [LOG...]
        --against SLO_BASELINE.json [--json]
    python -m distributed_dot_product_tpu_torch.obs doctor BUNDLE
        [BUNDLE...] [--json]
    python -m distributed_dot_product_tpu_torch.obs critpath LOG
        [replica=LOG ...] [--json]
    python -m distributed_dot_product_tpu_torch.obs trace export LOG
        [replica=LOG ...] -o trace.json

``validate`` schema-checks every record of each log's rotated set
against :data:`~distributed_dot_product_tpu_torch.obs.events.EVENT_SCHEMA`
(exit 1 on any violation). ``--require`` additionally demands that the
named events appear at least once — how a chaos run asserts its
injected faults actually landed in the log (``chip_smoke.py``'s
``chaos_serve`` phase). ``--timelines``
reconstructs every request and fails on incomplete lifecycles.

``stats`` summarizes a log operationally: per-event-type counts, the
wall-clock span and sustained events/sec, and the rotated-file
accounting (which files exist, their sizes and record counts) —
``--json`` emits the same as one machine-readable object.
``--percentiles`` additionally reconstructs every request and prints
p50/p95/p99 of TTFT, queue wait and inter-token gap — latency
distributions without writing python.

``slo`` is the goodput observatory (obs/slo.py): ``report`` classifies
every submitted request against an :class:`~distributed_dot_product_tpu_torch
.obs.slo.SloSpec` (met / missed_ttft / missed_token / missed_e2e /
rejected / incomplete) with per-tenant breakdowns; ``check`` gates a
log against the committed ``SLO_BASELINE.json`` with tolerances (exit 1
on violation, each naming the metric and tenant). Multi-replica log
sets merge:
pass several paths, optionally labeled ``replica=path``.

``critpath`` is the latency-attribution observatory (obs/critpath.py):
per-request causal phase chains (queue / handoff / prefill / decode /
stall / commit) whose durations PARTITION each request's e2e latency
exactly, aggregated into per-tenant / per-replica profiles and the
p99 tail cohorts, plus the dispatch-floor split folded from
``serve.dispatch`` records — exit 1 when any completed request fails
the partition check.

``trace export`` emits Chrome-trace/Perfetto JSON from the same merged
sources (obs/trace.py): one process track per replica, one thread per
slot, phase slices per request, instant markers for faults / preempts /
anomalies / handoffs — load the file in ``ui.perfetto.dev``.

``timeline`` prints one request's reconstructed lifecycle; ``--json``
switches to compact machine-readable output with the FULL event
records (the default renders ``(seq, event)`` pairs for humans).

``doctor`` diagnoses flight-recorder post-mortem bundle(s)
(obs/flight.py) FROM THE BUNDLES ALONE: classifies the incident
(stuck_step / nan_storm / cache_exhaustion / deadline_storm /
overload) from the ring's events, the metric samples and the thread
stacks, and names the affected tenants and request ids — exit 1 only
on an unreadable/invalid bundle (the ``chaos_serve`` phase checks its
classification against the injected fault). Several bundles
(one per serving replica, optionally labeled ``replica=path``) merge
into one diagnosis whose verdict names the replica the incident
happened on and prefixes affected request ids with their replica.

Runs on plain files — no devices touched, safe anywhere. Copied from
``distributed_dot_product_tpu/obs/__main__.py``.
"""

import argparse
import collections
import json
import os
import sys

from distributed_dot_product_tpu_torch.obs import slo as obs_slo
from distributed_dot_product_tpu_torch.obs.events import (
    _log_files, read_events, validate_file,
)
from distributed_dot_product_tpu_torch.obs.timeline import (
    reconstruct, timeline,
)


def _parse_labeled(items):
    """``replica=path`` CLI args → ``([(label, path), ...], labeled)``
    — bare paths get positional ``r0, r1, ...`` labels. The ONE place
    the label grammar lives (log sets and bundle sets share it)."""
    parsed = []
    labeled = False
    for i, arg in enumerate(items):
        if '=' in arg and not os.path.exists(arg):
            label, path = arg.split('=', 1)
            labeled = True
        else:
            label, path = f'r{i}', arg
        parsed.append((label, path))
    return parsed, labeled


def _parse_log_args(logs):
    """CLI log args → a reconstruct() source: one bare path stays a
    path; several (or any ``replica=path`` labeled one) become a
    multi-source list with per-replica labels."""
    parsed, labeled = _parse_labeled(logs)
    if len(parsed) == 1 and not labeled:
        return parsed[0][1]
    return parsed


def _cmd_validate(args):
    rc = 0
    for path in args.logs:
        records, errors = validate_file(path)
        counts = collections.Counter(r.get('event') for r in records)
        for err in errors:
            print(f'{path}: SCHEMA: {err}')
            rc = 1
        missing = [ev for ev in args.require if not counts.get(ev)]
        for ev in missing:
            print(f'{path}: REQUIRED event never recorded: {ev}')
            rc = 1
        if args.timelines:
            for rid, tl in sorted(reconstruct(records).items()):
                for err in tl.errors:
                    print(f'{path}: TIMELINE {rid}: {err}')
                    rc = 1
        summary = ' '.join(f'{ev}={n}' for ev, n in sorted(counts.items()))
        print(f'{path}: {len(records)} events '
              f'({"OK" if rc == 0 else "INVALID"}) {summary}')
    return rc


def _cmd_stats(args):
    rc = 0
    reports = []
    parsed, labeled = _parse_labeled(args.logs)
    multi = labeled or len(parsed) > 1
    for label, path in parsed:
        if not _log_files(path):
            print(f'{path}: no such log (nor rotated set)',
                  file=sys.stderr)
            rc = 1
            continue
        try:
            records = read_events(path)
        except (ValueError, OSError) as e:
            print(f'{path}: UNREADABLE: {e}', file=sys.stderr)
            rc = 1
            continue
        counts = collections.Counter(r.get('event') for r in records)
        ts = [r['ts'] for r in records if isinstance(
            r.get('ts'), (int, float))]
        span_s = (max(ts) - min(ts)) if len(ts) >= 2 else 0.0
        files = []
        for fname in _log_files(path):
            with open(fname, encoding='utf-8') as f:
                n_lines = sum(1 for line in f if line.strip())
            # `lines` is the RAW non-empty line count — it can exceed
            # the parsed `events` total by one when the newest file
            # ends in a crash-torn tail line (which read_events
            # tolerates and skips).
            files.append({'path': fname,
                          'bytes': os.path.getsize(fname),
                          'lines': n_lines})
        rep = {
            'log': path, 'replica': label, 'events': len(records),
            'wall_span_seconds': span_s,
            'events_per_second': (len(records) / span_s if span_s
                                  else None),
            'first_ts': min(ts) if ts else None,
            'last_ts': max(ts) if ts else None,
            'by_event': dict(sorted(counts.items(),
                                    key=lambda kv: str(kv[0]))),
            'files': files,
        }
        if args.percentiles:
            # Latency distributions over every reconstructed request:
            # the stamped observations (ttft/queue_wait/gap), not ts
            # arithmetic — same numbers obs/slo.py's report carries.
            ttfts, waits, gaps = [], [], []
            for tl in reconstruct(records).values():
                if tl.ttft is not None:
                    ttfts.append(tl.ttft)
                if tl.queue_wait is not None:
                    waits.append(tl.queue_wait)
                gaps.extend(tl.token_gaps)
            rep['latency_percentiles'] = {
                name: obs_slo._percentile_block(vals)
                for name, vals in (('ttft', ttfts),
                                   ('queue_wait', waits),
                                   ('gap', gaps))}
        reports.append(rep)
    merged = None
    if multi and reports:
        # Per-replica breakdown of the MERGED source set: the counts
        # table keyed by replica label, so a disaggregated run's
        # router/prefill/replica event mix is visible without opening
        # each log (before this, merging collapsed the labels away).
        events = sorted({ev for rep in reports
                         for ev in rep['by_event']})
        merged = {
            'log': '<merged>',
            'events': sum(rep['events'] for rep in reports),
            'by_replica': {
                rep['replica']: {'events': rep['events'],
                                 'by_event': rep['by_event']}
                for rep in reports},
            'event_names': events,
        }
        reports.append(merged)
    if args.json:
        # Always a list — one element per readable log (plus one
        # trailing '<merged>' per-replica breakdown object when
        # several / labeled sources were passed) — so consumers get a
        # stable shape regardless of how many paths were passed.
        print(json.dumps(reports, indent=2, default=str))
        return rc
    for rep in reports:
        if rep.get('log') == '<merged>':
            print(f'merged ({len(rep["by_replica"])} replicas, '
                  f'{rep["events"]} events) — per-replica breakdown:')
            width = max(len(ev) for ev in rep['event_names']) + 2
            names = list(rep['by_replica'])
            print('  ' + ' ' * width
                  + ' '.join(f'{n:>10}' for n in names))
            for ev in rep['event_names']:
                row = ' '.join(
                    f'{rep["by_replica"][n]["by_event"].get(ev, 0):>10}'
                    for n in names)
                print(f'  {ev:<{width}}{row}')
            continue
        rate = (f'{rep["events_per_second"]:.1f}/s'
                if rep['events_per_second'] else 'n/a')
        print(f'{rep["log"]}: {rep["events"]} events over '
              f'{rep["wall_span_seconds"]:.2f}s ({rate}) in '
              f'{len(rep["files"])} file(s)')
        for ev, n in rep['by_event'].items():
            print(f'  {ev:24} {n}')
        for fi in rep['files']:
            print(f'  file {fi["path"]}: {fi["lines"]} lines, '
                  f'{fi["bytes"]} bytes')
        for name, blk in rep.get('latency_percentiles', {}).items():
            def _ms(v):
                return 'n/a' if v is None else f'{v * 1e3:.1f}ms'
            print(f'  {name:11} p50={_ms(blk["p50"])} '
                  f'p95={_ms(blk["p95"])} p99={_ms(blk["p99"])} '
                  f'over {blk["count"]}')
    return rc


def _load_spec(args):
    spec = obs_slo.SloSpec(ttft=args.ttft, per_token=args.per_token,
                           e2e=args.e2e)
    if getattr(args, 'spec', None):
        with open(args.spec, encoding='utf-8') as f:
            d = json.load(f)
        # Accept a bare SloSpec dict OR a whole SLO_BASELINE.json
        # (whose contract lives under 'spec') — so the refresh loop is
        # `slo report LOG --spec SLO_BASELINE.json --baseline-out
        # SLO_BASELINE.json` with no spec duplication.
        if isinstance(d.get('spec'), dict):
            d = d['spec']
        spec = obs_slo.SloSpec.from_dict(d)
    return spec


def _cmd_slo_report(args):
    report = obs_slo.goodput(_parse_log_args(args.logs),
                             _load_spec(args))
    if args.baseline_out:
        with open(args.baseline_out, 'w', encoding='utf-8') as f:
            json.dump(obs_slo.make_baseline(report), f, indent=2)
            f.write('\n')
        print(f'baseline written to {args.baseline_out}')
    if args.json:
        print(json.dumps(report.to_dict(), indent=2, default=str))
    else:
        print(obs_slo.render_report(report))
    return 0


def _cmd_slo_check(args):
    baseline = obs_slo.load_baseline(args.against)
    # The spec under test is the BASELINE's: a check must measure the
    # same contract the baseline recorded, or the comparison is moot.
    spec = obs_slo.SloSpec.from_dict(baseline.get('spec', {}))
    report = obs_slo.goodput(_parse_log_args(args.logs), spec)
    violations = obs_slo.check_baseline(report, baseline)
    if args.json:
        print(json.dumps({'violations': violations,
                          'report': report.to_dict(brief=True)},
                         indent=2, default=str))
    else:
        for v in violations:
            print(f'SLO VIOLATION: {v}')
        print(obs_slo.render_report(report))
        print(f'slo check vs {args.against}: '
              f'{"FAIL" if violations else "OK"} '
              f'({len(violations)} violation(s))')
    return 1 if violations else 0


def _cmd_doctor(args):
    from distributed_dot_product_tpu_torch.obs import doctor as obs_doctor
    from distributed_dot_product_tpu_torch.obs import flight as obs_flight
    labeled = []
    for label, path in _parse_labeled(args.bundle)[0]:
        try:
            labeled.append((label, obs_flight.load_bundle(path)))
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f'{path}: unreadable bundle: {e}', file=sys.stderr)
            return 1
    incident = obs_doctor.diagnose_bundles(labeled)
    if args.json:
        print(json.dumps(incident.to_dict(), indent=2, default=str))
    else:
        print(obs_doctor.render_incident(incident))
    return 0


def _cmd_critpath(args):
    from distributed_dot_product_tpu_torch.obs import critpath as obs_critpath
    source = _parse_log_args(args.logs)
    try:
        chains = obs_critpath.attribute(source)
        dispatch = obs_critpath.dispatch_floor(source)
    except (ValueError, OSError) as e:
        print(f'critpath: unreadable source: {e}', file=sys.stderr)
        return 1
    prof = obs_critpath.profile(chains, dispatch=dispatch)
    if args.json:
        print(obs_critpath.to_json(prof))
    else:
        print(obs_critpath.render_report(prof))
    # The contract: every COMPLETED request's phases partition its
    # e2e within tolerance (partial chains — torn logs — are reported,
    # never asserted against).
    return 1 if prof['partition_failures'] else 0


def _cmd_trace_export(args):
    from distributed_dot_product_tpu_torch.obs import trace as obs_trace
    source = _parse_log_args(args.logs)
    try:
        trace = obs_trace.write_trace(source, args.out)
    except (ValueError, OSError) as e:
        print(f'trace export: {e}', file=sys.stderr)
        return 1
    errors = obs_trace.validate_trace(trace)
    for err in errors:
        print(f'trace export: INVALID: {err}', file=sys.stderr)
    n = len(trace['traceEvents'])
    print(f'{args.out}: {n} trace events '
          f'({"OK" if not errors else "INVALID"})')
    return 1 if errors else 0


def _cmd_timeline(args):
    tl = timeline(args.request_id, args.log)
    payload = {
        'request_id': tl.request_id, 'status': tl.status,
        'reason': tl.reason, 'tenant': tl.tenant,
        'complete': tl.complete,
        'errors': tl.errors, 'phases': tl.phases(),
        'admits': tl.admits, 'quarantines': tl.quarantines,
        'preempts': tl.preempts, 'tokens': tl.tokens,
    }
    if args.json:
        # Machine-readable: full event records, compact encoding.
        payload['events'] = tl.events
        print(json.dumps(payload, separators=(',', ':'), default=str))
    else:
        payload['events'] = [(r['seq'], r['event']) for r in tl.events]
        print(json.dumps(payload, indent=2, default=str))
    return 0 if tl.complete else 1


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='python -m distributed_dot_product_tpu_torch.obs',
        description=__doc__)
    sub = parser.add_subparsers(dest='cmd', required=True)

    v = sub.add_parser('validate', help='schema-check JSONL event logs')
    v.add_argument('logs', nargs='+')
    v.add_argument('--require', default='',
                   type=lambda s: [e for e in s.split(',') if e],
                   help='comma-separated events that must appear')
    v.add_argument('--timelines', action='store_true',
                   help='also require every request lifecycle complete')
    v.set_defaults(fn=_cmd_validate)

    s = sub.add_parser('stats', help='operational summary of a log '
                                     '(counts, rate, rotation files)')
    s.add_argument('logs', nargs='+')
    s.add_argument('--percentiles', action='store_true',
                   help='also reconstruct requests and print p50/p95/'
                        'p99 of ttft, queue wait and inter-token gap')
    s.add_argument('--json', action='store_true',
                   help='one machine-readable JSON object instead of '
                        'the human table')
    s.set_defaults(fn=_cmd_stats)

    slo = sub.add_parser(
        'slo', help='goodput-under-SLO accounting over the event log')
    slo_sub = slo.add_subparsers(dest='slo_cmd', required=True)
    r = slo_sub.add_parser(
        'report', help='classify every request against an SloSpec')
    r.add_argument('logs', nargs='+',
                   help='log path(s); several merge as replicas '
                        '(optionally labeled replica=path)')
    r.add_argument('--ttft', type=float, default=None,
                   help='TTFT deadline, seconds')
    r.add_argument('--per-token', type=float, default=None,
                   help='max inter-token gap, seconds')
    r.add_argument('--e2e', type=float, default=None,
                   help='end-to-end deadline, seconds')
    r.add_argument('--spec', default=None,
                   help='JSON SloSpec file (overrides the flags; may '
                        'carry per-tenant overrides)')
    r.add_argument('--baseline-out', default=None,
                   help='also write an SLO_BASELINE.json payload here '
                        '(the baseline refresh path)')
    r.add_argument('--json', action='store_true')
    r.set_defaults(fn=_cmd_slo_report)
    c = slo_sub.add_parser(
        'check', help='gate a log against a committed SLO baseline '
                      '(exit 1 on violations, each naming metric and '
                      'tenant)')
    c.add_argument('logs', nargs='+')
    c.add_argument('--against', required=True,
                   help='committed SLO_BASELINE.json (its embedded '
                        'spec is the contract checked)')
    c.add_argument('--json', action='store_true')
    c.set_defaults(fn=_cmd_slo_check)

    d = sub.add_parser(
        'doctor', help='diagnose flight-recorder post-mortem bundle(s) '
                       '(classify the incident, name the replica and '
                       'affected tenants/requests) from the bundles '
                       'alone')
    d.add_argument('bundle', nargs='+',
                   help='bundle director(ies) (MANIFEST.json + ring '
                        'JSONL + snapshots); several merge as '
                        'per-replica bundles, optionally labeled '
                        'replica=path — the verdict then names the '
                        'replica')
    d.add_argument('--json', action='store_true',
                   help='machine-readable incident object')
    d.set_defaults(fn=_cmd_doctor)

    cp = sub.add_parser(
        'critpath',
        help='critical-path latency attribution: per-request phase '
             'chains (queue/handoff/prefill/decode/stall/commit) that '
             'partition e2e exactly, aggregated per tenant/replica, '
             'plus the dispatch-floor split (exit 1 when any '
             'completed request fails the partition check)')
    cp.add_argument('logs', nargs='+',
                    help='log path(s); several merge as replicas '
                         '(optionally labeled replica=path)')
    cp.add_argument('--json', action='store_true',
                    help='machine-readable profile object')
    cp.set_defaults(fn=_cmd_critpath)

    tr = sub.add_parser(
        'trace', help='Chrome-trace / Perfetto export of the event log')
    tr_sub = tr.add_subparsers(dest='trace_cmd', required=True)
    te = tr_sub.add_parser(
        'export',
        help='emit Chrome-trace JSON: one track per replica/slot, '
             'phase slices per request, instant markers for faults/'
             'preempts/anomalies/handoffs (load in ui.perfetto.dev)')
    te.add_argument('logs', nargs='+',
                    help='log path(s); several merge as replicas '
                         '(optionally labeled replica=path)')
    te.add_argument('-o', '--out', required=True,
                    help='output trace JSON path')
    te.set_defaults(fn=_cmd_trace_export)

    t = sub.add_parser('timeline', help='print one request lifecycle')
    t.add_argument('log')
    t.add_argument('request_id')
    t.add_argument('--json', action='store_true',
                   help='compact machine-readable output with full '
                        'event records')
    t.set_defaults(fn=_cmd_timeline)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == '__main__':
    sys.exit(main())
