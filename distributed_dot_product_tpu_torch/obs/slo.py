# -*- coding: utf-8 -*-
"""
Goodput-under-SLO accounting over the JSONL event log — the operator
number a serving stack is actually judged by.

The scheduler stamps its latency observations INTO the events it emits
(``queue_wait`` on admit, ``ttft``/``gap`` on decode, ``total_seconds``
on retire — all on its own injectable clock), so a request's entire SLO
verdict is derivable OFFLINE from the log alone. This module does that
derivation:

- :class:`SloSpec`: the contract — TTFT deadline, per-token (inter-
  token gap) deadline, optional end-to-end deadline, per-tenant
  overrides.
- :func:`goodput`: reconstruct every request's timeline (multi-replica
  log sets merge through ``events.merge_events``) and classify each
  submitted request into EXACTLY ONE of ``met`` / ``missed_ttft`` /
  ``missed_token`` / ``missed_e2e`` / ``rejected`` / ``incomplete`` —
  the classes partition the submitted set, so
  ``sum(counts) == requests`` is a standing invariant, per tenant and
  in aggregate. Goodput % = met / submitted.
- :func:`check_baseline`: the CI gate — compare a report against a
  committed ``SLO_BASELINE.json`` with tolerances, emitting
  ``slo.violation`` events into the active log, exactly mirroring the
  ``perf check`` gate (obs/perf.py).

Copied from ``distributed_dot_product_tpu/obs/slo.py`` (the reference's
``obs slo`` command line is not ported): the same log gives the same
report.

Classification semantics: ``rejected`` = typed shed (at submit or in
queue); ``incomplete`` = the stream did not complete — either a
non-completed terminal (evicted / deadline_expired / failed_nan /
abandoned) or no terminal in the log at all (truncated log, live run);
the ``missed_*`` classes apply to COMPLETED streams only, checked in
TTFT → per-token → e2e order so each request lands in one class.
"""

import dataclasses
import json
from typing import Dict, List, Optional

from distributed_dot_product_tpu_torch.obs import events as obs_events
from distributed_dot_product_tpu_torch.obs.timeline import reconstruct

__all__ = ['SLO_BASELINE_SCHEMA', 'CLASSES', 'SloSpec', 'SloReport',
           'classify', 'goodput', 'check_baseline', 'render_report']

SLO_BASELINE_SCHEMA = 1

# The complete partition, in classification order.
CLASSES = ('met', 'missed_ttft', 'missed_token', 'missed_e2e',
           'rejected', 'incomplete')


@dataclasses.dataclass
class SloSpec:
    """The service-level contract. All deadlines in seconds; ``None``
    disables that check. ``tenants`` maps tenant name → override dict
    with any of the ``ttft``/``per_token``/``e2e`` keys (unset keys
    inherit the global value)."""
    ttft: Optional[float] = None
    per_token: Optional[float] = None
    e2e: Optional[float] = None
    tenants: Dict[str, dict] = dataclasses.field(default_factory=dict)

    def resolve(self, tenant):
        """Effective ``(ttft, per_token, e2e)`` for ``tenant``."""
        o = self.tenants.get(tenant, {})
        return (o.get('ttft', self.ttft),
                o.get('per_token', self.per_token),
                o.get('e2e', self.e2e))

    def to_dict(self):
        return {'ttft': self.ttft, 'per_token': self.per_token,
                'e2e': self.e2e, 'tenants': self.tenants}

    @classmethod
    def from_dict(cls, d):
        return cls(ttft=d.get('ttft'), per_token=d.get('per_token'),
                   e2e=d.get('e2e'), tenants=dict(d.get('tenants', {})))


def classify(tl, spec: SloSpec) -> str:
    """One timeline → one class (see module docstring for semantics)."""
    if tl.status == 'rejected':
        return 'rejected'
    if not tl.complete or tl.status != 'completed':
        return 'incomplete'
    ttft_d, tok_d, e2e_d = spec.resolve(tl.tenant or 'default')
    if ttft_d is not None and (tl.ttft is None or tl.ttft > ttft_d):
        return 'missed_ttft'
    if tok_d is not None and tl.token_gaps \
            and max(tl.token_gaps) > tok_d:
        return 'missed_token'
    if e2e_d is not None and (tl.total_seconds is None
                              or tl.total_seconds > e2e_d):
        return 'missed_e2e'
    return 'met'


def _pct(values, p):
    """Nearest-rank percentile (same rule as utils.tracing.Histogram),
    None on empty."""
    if not values:
        return None
    vals = sorted(values)
    idx = min(len(vals) - 1,
              max(0, int(round((p / 100.0) * (len(vals) - 1)))))
    return vals[idx]


def _percentile_block(values):
    return {'count': len(values), 'p50': _pct(values, 50),
            'p95': _pct(values, 95), 'p99': _pct(values, 99),
            'max': max(values) if values else None}


@dataclasses.dataclass
class SloReport:
    """The goodput verdict for one log (set). ``counts`` partitions
    the submitted requests over :data:`CLASSES`; ``per_tenant`` holds
    the same shape per tenant and sums back to the aggregate."""
    spec: dict
    requests: int
    counts: Dict[str, int]
    goodput_pct: float
    per_tenant: Dict[str, dict]
    percentiles: Dict[str, dict]
    statuses: Dict[str, int]
    by_request: Dict[str, str]

    def to_dict(self, *, brief=False):
        out = {
            'spec': self.spec, 'requests': self.requests,
            'counts': dict(self.counts),
            'goodput_pct': self.goodput_pct,
            'per_tenant': {t: dict(v)
                           for t, v in sorted(self.per_tenant.items())},
            'percentiles': self.percentiles,
            'statuses': dict(sorted(self.statuses.items())),
        }
        if not brief:
            out['by_request'] = dict(sorted(self.by_request.items()))
        return out


def goodput(source, spec: SloSpec) -> SloReport:
    """Compute the goodput report for ``source`` — a log path, an
    EventLog, decoded records, or a LIST of per-replica paths /
    ``(replica, path)`` pairs (merged; one request's lifecycle may span
    a prefill pool's log and a decode pool's)."""
    timelines = reconstruct(source)
    counts = {c: 0 for c in CLASSES}
    per_tenant: Dict[str, dict] = {}
    statuses: Dict[str, int] = {}
    by_request: Dict[str, str] = {}
    ttfts, waits, gaps = [], [], []
    for rid, tl in sorted(timelines.items()):
        cls = classify(tl, spec)
        by_request[rid] = cls
        counts[cls] += 1
        tenant = tl.tenant or 'default'
        tb = per_tenant.setdefault(
            tenant, {'requests': 0, 'goodput_pct': 0.0,
                     'counts': {c: 0 for c in CLASSES}})
        tb['requests'] += 1
        tb['counts'][cls] += 1
        status = tl.status or 'in_flight'
        statuses[status] = statuses.get(status, 0) + 1
        if tl.ttft is not None:
            ttfts.append(tl.ttft)
        if tl.queue_wait is not None:
            waits.append(tl.queue_wait)
        gaps.extend(tl.token_gaps)
    total = sum(counts.values())
    for tb in per_tenant.values():
        tb['goodput_pct'] = (100.0 * tb['counts']['met']
                             / tb['requests'] if tb['requests'] else 0.0)
    return SloReport(
        spec=spec.to_dict(), requests=total, counts=counts,
        goodput_pct=(100.0 * counts['met'] / total if total else 0.0),
        per_tenant=per_tenant,
        percentiles={'ttft': _percentile_block(ttfts),
                     'queue_wait': _percentile_block(waits),
                     'gap': _percentile_block(gaps)},
        statuses=statuses, by_request=by_request)


# -- the regression gate ------------------------------------------------

DEFAULT_TOLERANCES = {
    # Generous CPU tolerances (mirroring the PERF_BASELINE convention):
    # the virtual clock makes a clean rerun EXACTLY reproducible, so
    # these absorb intentional small config drift, not noise.
    'goodput_abs': 10.0,          # percentage points, aggregate
    'tenant_goodput_abs': 15.0,   # percentage points, per tenant
}


def make_baseline(report: SloReport, *, tolerances=None, note=None):
    """The committed-baseline payload for ``report`` (what
    ``slo report --baseline-out`` writes)."""
    return {
        'schema': SLO_BASELINE_SCHEMA,
        '_refresh': note or (
            'Refresh IN THE SAME DIFF as an intentional serving/load '
            'change: rerun the load with its event log, then write '
            'make_baseline(goodput(log, spec)) over this file'),
        'spec': report.spec,
        'requests': report.requests,
        'goodput_pct': report.goodput_pct,
        'per_tenant': {t: v['goodput_pct']
                       for t, v in sorted(report.per_tenant.items())},
        'tolerances': dict(tolerances or DEFAULT_TOLERANCES),
    }


def check_baseline(report: SloReport, baseline: dict, *,
                   emit_events=True) -> List[str]:
    """Gate ``report`` against a committed baseline; returns violation
    strings (empty = pass). Every violation names the metric (and the
    tenant, when per-tenant) and also lands in the active event log as
    an ``slo.violation`` — same discipline as ``perf check``."""
    violations = []

    def _flag(metric, msg, tenant=None, cur=None, base=None):
        where = f'tenant {tenant}: ' if tenant else ''
        violations.append(f'{where}{metric}: {msg}')
        if emit_events and obs_events.get_active() is not None:
            obs_events.emit('slo.violation', metric=metric,
                            tenant=tenant, current=cur, baseline=base,
                            detail=msg)

    if baseline.get('schema') != SLO_BASELINE_SCHEMA:
        return [f'schema: baseline has schema='
                f'{baseline.get("schema")!r} (expected '
                f'{SLO_BASELINE_SCHEMA}) — refresh it']
    tol = {**DEFAULT_TOLERANCES, **baseline.get('tolerances', {})}
    base_req = baseline.get('requests')
    if base_req is not None and report.requests != base_req:
        _flag('requests',
              f'{report.requests} classified vs baseline {base_req} — '
              f'the smoke config drifted from the one the baseline '
              f'was recorded with (refresh both together)',
              cur=report.requests, base=base_req)
    limit = baseline['goodput_pct'] - tol['goodput_abs']
    if report.goodput_pct < limit:
        _flag('goodput_pct',
              f'{report.goodput_pct:.1f}% vs baseline '
              f'{baseline["goodput_pct"]:.1f}% (floor {limit:.1f}% at '
              f'-{tol["goodput_abs"]} pts)',
              cur=report.goodput_pct, base=baseline['goodput_pct'])
    for tenant, base_gp in sorted(baseline.get('per_tenant',
                                               {}).items()):
        tb = report.per_tenant.get(tenant)
        if tb is None:
            _flag('coverage', 'tenant present in the baseline but '
                  'absent from the log (trace config drifted? refresh '
                  'the baseline if intentional)', tenant=tenant)
            continue
        limit = base_gp - tol['tenant_goodput_abs']
        if tb['goodput_pct'] < limit:
            _flag('goodput_pct',
                  f'{tb["goodput_pct"]:.1f}% vs baseline '
                  f'{base_gp:.1f}% (floor {limit:.1f}% at '
                  f'-{tol["tenant_goodput_abs"]} pts)',
                  tenant=tenant, cur=tb['goodput_pct'], base=base_gp)
    for tenant in sorted(report.per_tenant):
        if tenant not in baseline.get('per_tenant', {}):
            _flag('coverage', 'tenant not in the baseline — refresh '
                  'SLO_BASELINE.json in the same change that added '
                  'the tenant', tenant=tenant)
    return violations


# -- rendering ----------------------------------------------------------

def _fmt_s(v):
    return 'n/a' if v is None else f'{v * 1e3:.1f}ms'


def render_report(report: SloReport) -> str:
    """Human goodput table: aggregate verdict, per-tenant breakdown,
    latency percentiles."""
    spec = report.spec
    parts = [
        f'SLO: ttft<{spec.get("ttft")}s per_token<'
        f'{spec.get("per_token")}s e2e<{spec.get("e2e")}s '
        f'({len(spec.get("tenants", {}))} tenant overrides)',
        f'goodput: {report.goodput_pct:.1f}% '
        f'({report.counts["met"]}/{report.requests} met)',
        '  ' + ' '.join(f'{c}={report.counts[c]}' for c in CLASSES),
    ]
    for tenant, tb in sorted(report.per_tenant.items()):
        parts.append(
            f'  tenant {tenant:10} {tb["goodput_pct"]:5.1f}% of '
            f'{tb["requests"]:4d}  ' + ' '.join(
                f'{c}={tb["counts"][c]}' for c in CLASSES
                if tb['counts'][c]))
    for name, blk in report.percentiles.items():
        parts.append(
            f'  {name:11} p50={_fmt_s(blk["p50"])} '
            f'p95={_fmt_s(blk["p95"])} p99={_fmt_s(blk["p99"])} '
            f'max={_fmt_s(blk["max"])} over {blk["count"]}')
    parts.append('  statuses: ' + ' '.join(
        f'{k}={v}' for k, v in sorted(report.statuses.items())))
    return '\n'.join(parts)


def load_baseline(path):
    with open(path, encoding='utf-8') as f:
        return json.load(f)
