# -*- coding: utf-8 -*-
"""
The port's request timelines (``obs/timeline.py``) and goodput-under-SLO
accounting (``obs/slo.py``) over the port scheduler's event log, against
the reference's over its own log of the same seeded run (the reference
engine and the port engine with the same weights, on the virtual clock):

- ``reconstruct`` and ``timeline``: every request's lifecycle —
  status, reason, tenant, latencies, token gaps and counts, the event
  sequence — equal, and every one complete;
- ``goodput``: the same report, whole (counts, per-tenant goodput,
  percentiles, statuses, the class of every request);
- ``classify``, ``make_baseline``/``check_baseline`` (violations and the
  ``slo.violation`` events) and ``render_report``: the same results and
  the same text.
"""

import dataclasses
import json

import numpy as np

from distributed_dot_product_tpu.obs import EventLog as JaxEventLog
from distributed_dot_product_tpu.obs import slo as jax_slo
from distributed_dot_product_tpu.obs.timeline import (
    reconstruct as jax_reconstruct, timeline as jax_timeline,
)
from distributed_dot_product_tpu.serve import (
    KernelEngine as JaxEngine, LoadGenConfig as JaxLoadCfg,
    PolicyConfig as JaxPolicyCfg, ServeConfig as JaxServeCfg,
    TenantPolicy as JaxTenantPolicy, default_tenants as jax_tenants,
    run_load as jax_run_load,
)
from distributed_dot_product_tpu.utils.tracing import (
    MetricsRegistry as JaxRegistry,
)
from distributed_dot_product_tpu_torch.convert import engine_state_from_jax
from distributed_dot_product_tpu_torch.obs import (
    EventLog, activate, read_events, slo,
)
from distributed_dot_product_tpu_torch.obs.timeline import (
    reconstruct, timeline,
)
from distributed_dot_product_tpu_torch.serve import (
    KernelEngine, LoadGenConfig, PolicyConfig, ServeConfig, TenantPolicy,
    default_tenants, run_load,
)
from distributed_dot_product_tpu_torch.utils.tracing import MetricsRegistry

ENGINE = dict(slots=2, t_max=64, vocab=64, prefill_chunk=4, seed=1,
              cache_mode='paged', page_size=8)
LOAD = dict(seed=5, rate=500.0, requests=28, vocab=64)
SERVE = dict(queue_limit=3, max_new_tokens=24, watchdog=False)
SPEC = dict(ttft=0.02, per_token=0.004, e2e=0.08,
            tenants={'t1': {'ttft': 0.05}})


def _logs(tmp_path):
    """The seeded two-tenant run under a priority policy through both
    stacks, each writing its own event log: the two log paths."""
    je = JaxEngine(decode_impl='xla', **ENGINE)
    te = KernelEngine(device='cpu', **ENGINE)
    te.load_weights(engine_state_from_jax(
        {n: np.asarray(getattr(je, n))
         for n in ('_embed', '_wq', '_wk', '_wv', '_wo')}))
    jpath, tpath = tmp_path / 'jax.jsonl', tmp_path / 'port.jsonl'
    jlog, tlog = JaxEventLog(str(jpath)), EventLog(str(tpath))
    jax_run_load(JaxLoadCfg(tenants=jax_tenants(2), **LOAD), engine=je,
                 serve_config=JaxServeCfg(**SERVE), registry=JaxRegistry(),
                 event_log=jlog, policy=JaxPolicyCfg(
                     tenants={'t0': JaxTenantPolicy(priority=1)}))
    run_load(LoadGenConfig(tenants=default_tenants(2), **LOAD), engine=te,
             serve_config=ServeConfig(**SERVE), registry=MetricsRegistry(),
             event_log=tlog, policy=PolicyConfig(
                 tenants={'t0': TenantPolicy(priority=1)}))
    jlog.close()
    tlog.close()
    return str(jpath), str(tpath)


def _view(tl):
    """A timeline's fields with its events' envelopes and real-time
    readings left out (wall stamps and each decode's measured
    ``device_seconds`` are the run's own; every latency the timeline
    reads is on the virtual clock)."""
    d = dataclasses.asdict(tl)
    d['events'] = [{k: v for k, v in e.items()
                    if k not in ('ts', 'wall', 'pid', 'host', 'seq',
                                 'device_seconds')}
                   for e in d['events']]
    return d


def test_timelines_and_goodput_equal_the_reference(tmp_path):
    jpath, tpath = _logs(tmp_path)
    want, got = jax_reconstruct(jpath), reconstruct(tpath)
    assert got.keys() == want.keys() and len(got) == LOAD['requests']
    for rid in want:
        assert _view(got[rid]) == _view(want[rid]), rid
        assert got[rid].complete, (rid, got[rid].errors)
    statuses = {tl.status for tl in got.values()}
    assert {'completed', 'evicted'} <= statuses
    one = sorted(want)[3]
    assert _view(timeline(one, tpath)) == _view(
        jax_timeline(one, jpath))
    assert timeline('nobody', tpath).errors == ['no events recorded']
    rep = slo.goodput(tpath, slo.SloSpec(**SPEC))
    jrep = jax_slo.goodput(jpath, jax_slo.SloSpec(**SPEC))
    assert rep.to_dict() == jrep.to_dict()
    assert sum(rep.counts.values()) == rep.requests == LOAD['requests']
    assert 0 < rep.counts['met'] < rep.requests
    assert set(rep.per_tenant) == {'t0', 't1'}


def test_classify_baseline_and_report_text_equal(tmp_path):
    jpath, tpath = _logs(tmp_path)
    tls, jtls = reconstruct(tpath), jax_reconstruct(jpath)
    spec, jspec = slo.SloSpec(**SPEC), jax_slo.SloSpec(**SPEC)
    for loose in (dict(ttft=1.0), dict(per_token=1e-4), dict(e2e=1e-3), {}):
        s = slo.SloSpec.from_dict({**spec.to_dict(), **loose})
        js = jax_slo.SloSpec.from_dict({**jspec.to_dict(), **loose})
        assert {rid: slo.classify(tl, s) for rid, tl in tls.items()} == {
            rid: jax_slo.classify(tl, js) for rid, tl in jtls.items()}
    rep, jrep = slo.goodput(tpath, spec), jax_slo.goodput(jpath, jspec)
    assert slo.render_report(rep) == jax_slo.render_report(jrep)
    base = slo.make_baseline(rep, note='n')
    assert base == jax_slo.make_baseline(jrep, note='n')
    assert slo.check_baseline(rep, base) == []
    # A baseline the run falls short of: the same violations, each also
    # an slo.violation event in the active log.
    strict = dict(base, goodput_pct=100.0, requests=base['requests'] + 1,
                  per_tenant={**base['per_tenant'], 't1': 100.0,
                              't9': 50.0})
    log = EventLog(str(tmp_path / 'gate.jsonl'))
    with activate(log):
        got = slo.check_baseline(rep, strict)
    log.close()
    assert got == jax_slo.check_baseline(jrep, strict, emit_events=False)
    assert len(got) >= 3
    events = [e for e in read_events(str(tmp_path / 'gate.jsonl'))
              if e['event'] == 'slo.violation']
    assert [e['metric'] for e in events] == [
        g.split(': ')[1] if g.startswith('tenant ') else g.split(': ')[0]
        for g in got]
    path = tmp_path / 'base.json'
    path.write_text(json.dumps(base))
    assert slo.load_baseline(str(path)) == base
    assert slo.check_baseline(rep, dict(base, schema=99))[0].startswith(
        'schema')
