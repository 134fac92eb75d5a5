# -*- coding: utf-8 -*-
"""
The port's incident tooling against the reference package on the CPU:
``obs/doctor.py``, ``obs/critpath.py``, ``obs/trace.py`` and the offline
CLI ``python -m distributed_dot_product_tpu_torch.obs`` — twins of
``tests/test_obs_doctor.py``, ``tests/test_obs_critpath.py`` and
``tests/test_obs_trace.py`` (no test there needs a multi-device mesh).

Held EQUAL, not close:

- the doctor's incident (``to_dict``) and its rendering, each package's
  doctor on each package's bundle of the same events;
- critpath chains, profiles and dispatch floors, and the Perfetto export,
  of the SAME logs (a port run's and a reference run's) through both
  packages; and the phase chains of a port run against the reference
  run's of the same workload (both on the same virtual clock; the
  ``serve.dispatch`` records carry real seconds and are left out there);
- the CLI's ``--json`` output and exit codes of both packages on the same
  files.
"""

import dataclasses
import itertools
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from distributed_dot_product_tpu import obs as jobs
from distributed_dot_product_tpu import serve as jserve
from distributed_dot_product_tpu.obs import __main__ as jcli
from distributed_dot_product_tpu.obs import critpath as jcritpath
from distributed_dot_product_tpu.obs import doctor as jdoctor
from distributed_dot_product_tpu.obs import flight as jflight
from distributed_dot_product_tpu.obs import trace as jtrace
from distributed_dot_product_tpu.utils import faults as jfaults
from distributed_dot_product_tpu.utils.tracing import (
    MetricsRegistry as JRegistry,
)
from distributed_dot_product_tpu_torch import obs as tobs
from distributed_dot_product_tpu_torch import serve as tserve
from distributed_dot_product_tpu_torch.obs import __main__ as tcli
from distributed_dot_product_tpu_torch.obs import critpath as tcritpath
from distributed_dot_product_tpu_torch.obs import doctor as tdoctor
from distributed_dot_product_tpu_torch.obs import flight as tflight
from distributed_dot_product_tpu_torch.obs import trace as ttrace
from distributed_dot_product_tpu_torch.utils import faults as tfaults
from distributed_dot_product_tpu_torch.utils.tracing import (
    MetricsRegistry as TRegistry,
)
from torch_serving import state
from torch_serving import cyclic_gc_paused  # noqa: E402,F401  autouse

JAX = types.SimpleNamespace(
    name='jax', obs=jobs, serve=jserve, cli=jcli, critpath=jcritpath,
    doctor=jdoctor, flight=jflight, trace=jtrace, faults=jfaults,
    Registry=JRegistry)
PORT = types.SimpleNamespace(
    name='port', obs=tobs, serve=tserve, cli=tcli, critpath=tcritpath,
    doctor=tdoctor, flight=tflight, trace=ttrace, faults=tfaults,
    Registry=TRegistry)
SIDES = (PORT, JAX)
VOCAB = 16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_retrace_sentinel(monkeypatch):
    monkeypatch.setenv('DDP_TPU_RETRACE_SENTINEL', '0')


# -- the doctor ---------------------------------------------------------

def _bundle(m, tmp_path, emit_fn, *, trigger='manual', registry_fn=None,
            **rec_kw):
    reg = m.Registry()
    if registry_fn is not None:
        registry_fn(reg)
    ticks = itertools.count()
    with m.flight.recording(base_dir=tmp_path / m.name / 'flight',
                            registry=reg, **rec_kw) as rec:
        # A deterministic clock: both packages' bundles stamp the same ts.
        log = m.obs.EventLog(tmp_path / m.name / 'ev.jsonl',
                             clock=lambda: 0.5 * next(ticks))
        emit_fn(log)
        log.close()
        return rec.dump_bundle(trigger=trigger)


def _diagnosed(tmp_path, emit_fn, **kw):
    """Each package's doctor on each package's bundle: the four
    incidents (and renderings) must be equal; the port's is returned."""
    paths = {m.name: _bundle(m, tmp_path, emit_fn, **kw) for m in SIDES}
    seen = []
    for path in paths.values():
        for reader in SIDES:
            inc = reader.doctor.diagnose(reader.flight.load_bundle(path))
            seen.append((inc.to_dict(), reader.doctor.render_incident(inc)))
    assert all(s == seen[0] for s in seen[1:])
    return tdoctor.Incident(**seen[0][0]), seen[0][1]


def _emit_exhaustion(log):
    log.emit('serve.admit', request_id='a', slot=0, tenant='t0',
             queue_wait=0.0)
    log.emit('serve.preempt', request_id='a', slot=0, requeued=True)
    log.emit('serve.admit', request_id='a', slot=1, tenant='t0',
             queue_wait=0.1)
    log.emit('serve.preempt', request_id='a', slot=1, requeued=False)
    log.emit('serve.evict', request_id='a', slot=1)
    log.emit('serve.retire', request_id='a', status='evicted',
             reason='cache_exhausted', tenant='t0')
    log.emit('serve.reject', request_id='b', reason='cache_exhausted',
             tenant='t0')


def test_cache_exhaustion_classified(tmp_path):
    incident, out = _diagnosed(tmp_path, _emit_exhaustion)
    assert incident.primary == 'cache_exhaustion'
    assert incident.affected['preempted'] == ['a']
    assert incident.affected['rejected'] == ['b']
    assert 'cache_exhausted' in out and 'preemption' in out


def _pages_free(reg):
    reg.gauge('serve.cache.pages_free').set(0)
    reg.gauge('serve.cache.pages_used').set(16)


def test_cache_exhaustion_pages_free_sample_counts(tmp_path):
    incident, _ = _diagnosed(tmp_path, lambda log: None,
                             registry_fn=_pages_free)
    assert incident.classes['cache_exhaustion']['score'] > 0
    assert incident.primary == 'cache_exhaustion'


def _emit_deadlines(log):
    for i in range(4):
        log.emit('serve.reject', request_id=f'd{i}',
                 reason='deadline_exceeded', tenant='t0')
    log.emit('serve.admit', request_id='e', slot=0, tenant='t0',
             queue_wait=0.0)
    log.emit('serve.retire', request_id='e', status='deadline_expired',
             tenant='t0')


def test_deadline_storm_classified(tmp_path):
    incident, _ = _diagnosed(tmp_path, _emit_deadlines)
    assert incident.primary == 'deadline_storm'
    assert incident.affected['rejected'] == [f'd{i}' for i in range(4)]
    assert incident.affected['failed'] == ['e']


def _emit_overload(log):
    for i in range(6):
        log.emit('serve.reject', request_id=f'q{i}', reason='queue_full',
                 tenant='free' if i % 2 else 'paid')
    log.emit('health.readiness', state='not_ready', reason='queue full')
    log.emit('serve.admit', request_id='ok', slot=0, tenant='paid',
             queue_wait=0.0)
    log.emit('serve.decode', request_id='ok', slot=0, token_index=0,
             ttft=0.01)
    log.emit('serve.retire', request_id='ok', status='completed',
             total_seconds=0.05, tenant='paid')


def test_overload_classified_and_tenants_named(tmp_path):
    incident, out = _diagnosed(tmp_path, _emit_overload)
    assert incident.primary == 'overload'
    assert set(incident.tenants) == {'free', 'paid'}
    assert incident.tenants['paid']['met'] == 1
    assert incident.tenants['free']['rejected'] == 3
    assert 'queue_full' in out and 'free' in out and 'paid' in out


def test_empty_bundle_is_inconclusive_with_note(tmp_path):
    incident, out = _diagnosed(tmp_path, lambda log: None)
    assert incident.primary is None
    assert any('no events' in n for n in incident.notes)
    assert 'inconclusive' in out


def _emit_rejects(log):
    for i in range(10):
        log.emit('serve.reject', request_id=f'r{i}', reason='queue_full',
                 tenant='t0')


def test_ring_truncation_is_noted(tmp_path):
    incident, _ = _diagnosed(tmp_path, _emit_rejects, max_records=4)
    assert incident.window['ring_dropped'] >= 6
    assert any('truncated' in n for n in incident.notes)


def _emit_anomaly(log):
    log.emit('anomaly.detected', metric='serve.cache.pages_free',
             detector='StaticThreshold', value=0.0, watch='pages_free')


def test_anomaly_verdicts_ride_along(tmp_path):
    incident, out = _diagnosed(tmp_path, _emit_anomaly)
    assert len(incident.anomalies) == 1
    assert incident.classes['cache_exhaustion']['score'] > 0
    assert 'anomaly' in out and 'pages_free' in out


def _emit_quiet(log):
    log.emit('serve.admit', request_id='ok-1', slot=0, tenant='t0',
             queue_wait=0.0)
    log.emit('serve.retire', request_id='ok-1', status='completed',
             tenant='t0')


def _emit_nan_storm(log):
    for i in range(3):
        log.emit('serve.admit', request_id=f'n{i}', slot=i, tenant='t1',
                 queue_wait=0.0)
        log.emit('serve.quarantine', request_id=f'n{i}', slot=i,
                 requeued=False)
        log.emit('serve.retire', request_id=f'n{i}', status='failed_nan',
                 tenant='t1')


def _multi(m, tmp_path):
    quiet = m.flight.load_bundle(_bundle(m, tmp_path / 'q', _emit_quiet))
    stormy = m.flight.load_bundle(_bundle(m, tmp_path / 's', _emit_nan_storm,
                                          trigger='nan_storm'))
    out = []
    for reader in SIDES:
        inc = reader.doctor.diagnose_bundles([('r0', quiet), ('r1', stormy)])
        solo = reader.doctor.diagnose_bundles([('r1', stormy)])
        out.append((inc.to_dict(), reader.doctor.render_incident(inc),
                    solo.to_dict()))
    assert out[0] == out[1]
    return out[0]


def test_multi_bundle_diagnosis_names_the_replica(tmp_path):
    """Per-replica bundles merge into ONE diagnosis naming the replica of
    the primary evidence, affected ids prefixed with their replica; one
    bundle degenerates to the single-bundle contract."""
    got = {m.name: _multi(m, tmp_path) for m in SIDES}
    assert got['port'] == got['jax']
    inc, out, solo = got['port']
    assert inc['primary'] == 'nan_storm' and inc['replica'] == 'r1'
    assert inc['affected']['quarantined'] == ['r1:n0', 'r1:n1', 'r1:n2']
    assert any(ev.startswith('[r1]')
               for ev in inc['classes']['nan_storm']['evidence'])
    assert inc['tenants']['t0']['requests'] == 1
    assert inc['tenants']['t1']['requests'] == 3
    assert 'replica r1' in out and 'r1:n0' in out
    assert solo['replica'] is None
    assert solo['affected']['quarantined'] == ['n0', 'n1', 'n2']


def _run_cli(m, argv, capsys):
    rc = m.cli.main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def test_multi_bundle_doctor_cli(tmp_path):
    """``obs doctor r0=B0 r1=B1 --json`` run as a module: the reference
    CLI's JSON on the same bundles, naming the replica; exit 0."""
    def emit(log):
        log.emit('serve.admit', request_id='a', slot=0, tenant='t0',
                 queue_wait=0.0)
        log.emit('serve.quarantine', request_id='a', slot=0, requeued=False)
        log.emit('serve.retire', request_id='a', status='failed_nan',
                 tenant='t0')

    b0 = _bundle(PORT, tmp_path / 'f0',
                 lambda log: log.emit('health.liveness', state='alive'))
    b1 = _bundle(PORT, tmp_path / 'f1', emit, trigger='nan_storm')
    payloads = []
    for pkg in ('distributed_dot_product_tpu_torch.obs',
                'distributed_dot_product_tpu.obs'):
        proc = subprocess.run(
            [sys.executable, '-m', pkg, 'doctor', f'r0={b0}', f'r1={b1}',
             '--json'], capture_output=True, text=True, timeout=240,
            cwd=REPO, env=dict(os.environ, JAX_PLATFORMS='cpu'))
        assert proc.returncode == 0, proc.stderr
        payloads.append(json.loads(proc.stdout))
    assert payloads[0] == payloads[1]
    assert payloads[0]['primary'] == 'nan_storm'
    assert payloads[0]['replica'] == 'r1'
    assert 'r1:a' in payloads[0]['affected']['failed']


# -- critpath: synthetic arcs -------------------------------------------

def _rec(seq, ts, event, **fields):
    rec = {'schema': 2, 'seq': seq, 'ts': ts, 'event': event}
    rec.update(fields)
    return rec


_SYNTHETIC = {
    'chain': [
        _rec(0, 11.0, 'serve.admit', request_id='r', slot=0, tenant='t0',
             queue_wait=1.0),
        _rec(1, 12.0, 'serve.prefill', request_id='r', slot=0, pos=4),
        _rec(2, 13.0, 'serve.decode', request_id='r', slot=0,
             token_index=0),
        _rec(3, 16.0, 'serve.decode', request_id='r', slot=0,
             token_index=1),
        _rec(4, 16.5, 'serve.retire', request_id='r', status='completed',
             total_seconds=6.5)],
    'stall': [
        _rec(0, 1.0, 'serve.admit', request_id='r', slot=0, tenant='t'),
        _rec(1, 2.0, 'serve.decode', request_id='r', slot=0,
             token_index=0),
        _rec(2, 3.0, 'serve.preempt', request_id='r', slot=0,
             requeued=True),
        _rec(3, 5.0, 'serve.admit', request_id='r', slot=1, tenant='t'),
        _rec(4, 6.0, 'serve.decode', request_id='r', slot=1,
             token_index=1),
        _rec(5, 6.5, 'serve.retire', request_id='r', status='completed',
             total_seconds=6.0)],
    'reject': [
        _rec(0, 4.0, 'serve.reject', request_id='r',
             reason='deadline_exceeded', tenant='t', total_seconds=3.0)],
    'torn': [
        _rec(0, 1.0, 'serve.admit', request_id='r', slot=0, tenant='t',
             queue_wait=0.5),
        _rec(1, 2.0, 'serve.decode', request_id='r', slot=0,
             token_index=0)],
    'handoff': [
        _rec(0, 1.0, 'router.route', request_id='r', target='r0'),
        _rec(1, 3.0, 'prefill.handoff', request_id='r', target='r0',
             pages=2, build_seconds=0.25, transfer_seconds=0.125),
        _rec(2, 4.0, 'serve.admit', request_id='r', slot=0, tenant='t'),
        _rec(3, 5.0, 'serve.decode', request_id='r', slot=0,
             token_index=0),
        _rec(4, 5.5, 'serve.retire', request_id='r', status='completed',
             total_seconds=5.0)],
}


def _chains(m, source):
    return {rid: dict(dataclasses.asdict(c), ok=c.ok,
                      partition_error=c.partition_error)
            for rid, c in m.critpath.attribute(source).items()}


def _profile(m, source):
    chains = m.critpath.attribute(source)
    prof = m.critpath.profile(chains,
                              dispatch=m.critpath.dispatch_floor(source))
    return prof, m.critpath.render_report(prof), m.critpath.to_json(prof)


@pytest.mark.parametrize('case', sorted(_SYNTHETIC))
def test_synthetic_chains_match_the_reference(case):
    """The attribution state machine on hand-built arcs — a clean chain,
    a requeue stall, a queue-death reject, a torn chain, a handoff: the
    reference's chains and profile, and the reference test's numbers."""
    recs = _SYNTHETIC[case]
    got = _chains(PORT, [dict(r) for r in recs])
    assert got == _chains(JAX, [dict(r) for r in recs])
    assert _profile(PORT, [dict(r) for r in recs]) == _profile(
        JAX, [dict(r) for r in recs])
    c = got['r']
    if case == 'chain':
        assert c['submit_ts'] == pytest.approx(10.0)
        assert c['phases'] == pytest.approx(
            {'queue': 1.0, 'prefill': 2.0, 'decode': 3.0, 'commit': 0.5})
        assert c['tokens'] == 2 and c['tenant'] == 't0'
    elif case == 'stall':
        assert c['stalls'] == 1
        assert c['phases']['stall'] == pytest.approx(2.0)
        assert c['phases']['prefill'] == pytest.approx(2.0)
    elif case == 'reject':
        assert c['status'] == 'rejected'
        assert c['phases'] == pytest.approx({'queue': 3.0})
    elif case == 'torn':
        assert c['partial'] and c['e2e'] is None
        prof = tcritpath.profile(tcritpath.attribute(
            [dict(r) for r in recs]))
        assert prof['partial'] == 1 and prof['partition_failures'] == []
    else:
        assert c['phases']['queue'] == pytest.approx(1.5)
        assert c['phases']['handoff'] == pytest.approx(2.0)
        assert c['handoff_build'] == pytest.approx(0.25)
        assert c['handoff_transfer'] == pytest.approx(0.125)


def _tie_logs(m, tmp_path):
    t = [10.0]

    def clock():
        return t[0]
    d = tmp_path / m.name
    d.mkdir(parents=True, exist_ok=True)
    router = m.obs.EventLog(d / 'router.jsonl', clock=clock)
    prefill = m.obs.EventLog(d / 'prefill.jsonl', clock=clock)
    rep = m.obs.EventLog(d / 'r0.jsonl', clock=clock)
    router.emit('router.route', request_id='x', target='r0')
    prefill.emit('prefill.handoff', request_id='x', target='r0', pages=1)
    rep.emit('serve.admit', request_id='x', slot=0, tenant='t')
    t[0] = 11.0
    rep.emit('serve.decode', request_id='x', slot=0, token_index=0)
    t[0] = 11.5
    rep.emit('serve.retire', request_id='x', status='completed',
             total_seconds=1.5)
    for log in (router, prefill, rep):
        log.close()
    return [('router', router.path), ('prefill', prefill.path),
            ('r0', rep.path)]


def test_three_source_ts_tie_merge_is_stable(tmp_path):
    """Records of three logs tying on ts merge in SOURCE order; the
    chains of the port's logs and the reference's logs, through both
    packages, are one."""
    sources = {m.name: _tie_logs(m, tmp_path) for m in SIDES}
    got = [_chains(reader, sources[maker])
           for maker in ('port', 'jax') for reader in SIDES]
    assert all(g == got[0] for g in got[1:])
    merged = tobs.merge_events(sources['port'])
    assert [r['replica'] for r in merged if r['ts'] == 10.0] == [
        'router', 'prefill', 'r0']
    x = got[0]['x']
    assert x['ok'] and sum(x['phases'].values()) == pytest.approx(1.5)
    assert x['replicas'][-1] == 'r0'


# -- critpath and trace on real scheduler runs --------------------------

def _sched_run(m, tmp_path, *, tick_dt=0.01, slots=2, t_max=32,
               engine_kw=None, injector=None, submits=None, **cfg_kw):
    """A virtual-clock scheduler run with an attached log (the clock
    drives the stamps and ``ts``); returns the log path and outcomes."""
    clock = m.serve.VirtualClock()
    d = tmp_path / m.name
    d.mkdir(parents=True, exist_ok=True)
    log = m.obs.EventLog(d / 'serve.jsonl', clock=clock)
    cfg_kw.setdefault('queue_limit', 8)
    cfg_kw.setdefault('max_new_tokens', 6)
    kw = dict(heads=2, head_dim=4, prefill_chunk=4, seed=5)
    kw.update(engine_kw or {})
    if m is PORT:
        eng = m.serve.KernelEngine(slots=slots, t_max=t_max, vocab=VOCAB,
                                   device='cpu', **kw)
        eng.load_weights(state(5, vocab=VOCAB, heads=2,
                               head_dim=kw['head_dim']))
    else:
        eng = m.serve.KernelEngine(slots=slots, t_max=t_max, vocab=VOCAB,
                                   decode_impl='xla', **kw)
    sched = m.serve.Scheduler(
        eng, m.serve.ServeConfig(watchdog=False, **cfg_kw), clock=clock,
        registry=m.Registry(),
        fault_injector=injector(m) if injector else False, event_log=log,
        on_tick=lambda s: clock.advance(tick_dt))
    for rid, prompt in (submits or [(f'r{i}', [i + 1]) for i in range(5)]):
        sched.submit(np.asarray(prompt, np.int32), request_id=rid)
    results = sched.run_until_idle()
    sched.close()
    log.close()
    return log.path, {rid: (r.status, list(r.tokens))
                      for rid, r in results.items()}


def _virtual(chains):
    """The virtual-time part of the chains (a run's ``serve.dispatch``
    real seconds do not enter them)."""
    return {rid: {k: c[k] for k in ('segments', 'phases', 'e2e', 'status',
                                    'reason', 'tenant', 'tokens', 'stalls',
                                    'partial', 'ok', 'partition_error')}
            for rid, c in chains.items()}


def _same_log_everywhere(paths):
    """Each log through both packages' critpath and trace export: equal
    outputs; the port's (per log) returned."""
    out = {}
    for maker, path in paths.items():
        seen = [(_chains(reader, path), _profile(reader, path),
                 reader.trace.export_trace(path)) for reader in SIDES]
        assert seen[0] == seen[1], maker
        out[maker] = seen[0]
    return out


def _assert_partitions(chains):
    anchored = [c for c in chains.values() if not c['partial']]
    assert anchored
    for c in anchored:
        assert c['ok'], (c['request_id'], c['errors'])
        assert c['partition_error'] <= tcritpath.PARTITION_TOL
        for (_, s0, e0), (_, s1, _) in zip(c['segments'], c['segments'][1:]):
            assert e0 == s1
        assert set(c['phases']) <= set(tcritpath.PHASES)


def test_scheduler_run_partitions_every_request(tmp_path):
    """Every request of a scheduler run partitions its e2e exactly; the
    port run's phase chains equal the reference run's, and either log
    gives the same critpath and trace through both packages."""
    runs = {m.name: _sched_run(m, tmp_path) for m in SIDES}
    assert runs['port'][1] == runs['jax'][1]
    same = _same_log_everywhere({k: v[0] for k, v in runs.items()})
    assert _virtual(same['port'][0]) == _virtual(same['jax'][0])
    chains, (prof, report, _), trace = same['port']
    assert set(chains) == {f'r{i}' for i in range(5)}
    _assert_partitions(chains)
    assert prof['partition_failures'] == []
    assert prof['phases'].get('decode', 0) > 0
    assert prof['dispatch']['total']['ticks'] > 0
    assert 'phase totals' in report
    assert ttrace.validate_trace(trace) == []


def test_preempt_requeue_arc_attributes_stall(tmp_path):
    """Page exhaustion preempts a stream: its requeue window lands in
    ``stall`` and the partition closes on the original submit — on the
    port's log and the reference's, through both packages."""
    kw = dict(max_new_tokens=8, max_requeues=6, evict_before_reject=False,
              engine_kw=dict(cache_mode='paged', page_size=2, pages=5),
              t_max=16, submits=[('a', [1]), ('b', [2])])
    runs = {m.name: _sched_run(m, tmp_path, **kw) for m in SIDES}
    assert runs['port'][1] == runs['jax'][1]
    same = _same_log_everywhere({k: v[0] for k, v in runs.items()})
    assert _virtual(same['port'][0]) == _virtual(same['jax'][0])
    chains = same['port'][0]
    _assert_partitions(chains)
    stalled = [c for c in chains.values() if c['stalls']]
    assert stalled and all(c['phases'].get('stall', 0) > 0 for c in stalled)
    marks = {e['name'] for e in same['port'][2]['traceEvents']
             if e['ph'] == 'i'}
    assert 'preempt' in marks
    assert any(e['ph'] == 'X' and e['name'] == 'stall'
               for e in same['port'][2]['traceEvents'])


def test_ring_decode_kv_shards_partitions(tmp_path):
    """The port's ``kv_shards`` engine emits the same lifecycle
    vocabulary; its log partitions exactly through both packages'
    critpath (the reference's own sharded decode cannot run on this jax,
    ROADMAP §3, so its log is the port's alone)."""
    path, results = _sched_run(
        PORT, tmp_path, t_max=64,
        engine_kw=dict(cache_mode='paged', page_size=16, pages=None,
                       head_dim=8, kv_shards=2),
        submits=[(f'r{i}', ((np.arange(6) * 3 + i) % (VOCAB - 1) + 1))
                 for i in range(3)])
    assert all(st == 'completed' for st, _ in results.values())
    chains = _same_log_everywhere({'port': path})['port'][0]
    assert len(chains) == 3
    _assert_partitions(chains)
    assert all(c['phases'].get('decode', 0) > 0 for c in chains.values())


def test_dispatch_floor_folds_serve_dispatch(tmp_path):
    """``serve.dispatch`` records fold into the dispatch floor; the
    record-list summarizer the flight recorder uses agrees."""
    path, results = _sched_run(PORT, tmp_path,
                               submits=[('r', [1, 2, 3])])
    recs = tobs.read_events(path)
    disp = [r for r in recs if r['event'] == 'serve.dispatch']
    assert disp
    for r in disp:
        assert 0 <= r['device_seconds'] <= r['tick_seconds'] + 1e-9
        assert r['overhead'] >= 0 and 'request_id' not in r
    floors = [m.critpath.dispatch_floor(path) for m in SIDES]
    assert floors[0] == floors[1]
    agg = floors[0]['per_replica']['unlabeled']
    assert agg['ticks'] == len(disp)
    assert agg['tokens'] == len(results['r'][1])
    summaries = [m.critpath.summarize_records(recs) for m in SIDES]
    assert summaries[0] == summaries[1]
    assert summaries[0]['requests'] == 1
    assert summaries[0]['dispatch']['total']['ticks'] == len(disp)


def test_flight_bundle_carries_critpath_section(tmp_path):
    """Every post-mortem bundle carries the ring window's critpath
    summary, and the doctor cites the dominant phase from it — the
    reference's doctor reads the port's bundle the same way."""
    rec = tflight.FlightRecorder(base_dir=str(tmp_path),
                                 registry=TRegistry())
    tflight.install(rec)
    try:
        _sched_run(PORT, tmp_path, max_new_tokens=5,
                   submits=[(f'r{i}', [i + 1]) for i in range(3)])
        path = rec.dump_bundle(trigger='manual', reason='test')
    finally:
        tflight.install(None)
    with open(os.path.join(path, 'critpath.json'), encoding='utf-8') as fh:
        crit = json.load(fh)
    assert crit['requests'] == 3 and crit['partition_failures'] == []
    assert crit['dispatch']['total']['ticks'] > 0
    diags = [m.doctor.diagnose(m.flight.load_bundle(path)).to_dict()
             for m in SIDES]
    assert diags[0] == diags[1]
    notes = [n for n in diags[0]['notes'] if 'critpath' in n]
    assert any('dominant phase' in n for n in notes)
    assert any('dispatch overhead' in n for n in notes)


def test_flight_provider_empty_without_recorder():
    assert tflight._critpath_section() == jflight._critpath_section()
    section = tflight._critpath_section()
    assert section['requests'] == 0 and section['partition_failures'] == []


# -- the Perfetto export ------------------------------------------------

def _nan_injector(m):
    return m.faults.ServeFaultInjector(
        m.faults.ServeFaultPlan(nan_at_step=2, nan_slot=0))


def test_faulted_run_gets_instant_markers(tmp_path):
    """NaN quarantine and the fault injection render as instant markers:
    the reference's export of both runs' logs."""
    runs = {m.name: _sched_run(m, tmp_path, injector=_nan_injector,
                               max_new_tokens=5,
                               submits=[(f'r{i}', [i + 1])
                                        for i in range(4)])
            for m in SIDES}
    assert runs['port'][1] == runs['jax'][1]
    same = _same_log_everywhere({k: v[0] for k, v in runs.items()})
    trace = same['port'][2]
    assert ttrace.validate_trace(trace) == []
    marks = [e for e in trace['traceEvents'] if e['ph'] == 'i']
    assert {'fault', 'quarantine'} <= {e['name'] for e in marks}
    for e in marks:
        assert e['s'] in ('t', 'p')
        assert e['args']['event'] in ttrace.INSTANT_EVENTS
    slices = [e for e in trace['traceEvents'] if e['ph'] == 'X']
    assert {e['args']['request_id'] for e in slices} == set(runs['port'][1])
    assert min(e['ts'] for e in trace['traceEvents'] if e['ph'] != 'M') \
        == 0.0


def _two_tracks(m, tmp_path):
    t = [0.0]

    def clock():
        t[0] += 1.0
        return t[0]
    d = tmp_path / m.name
    d.mkdir(parents=True, exist_ok=True)
    a = m.obs.EventLog(d / 'a.jsonl', clock=clock)
    b = m.obs.EventLog(d / 'b.jsonl', clock=clock)
    a.emit('serve.admit', request_id='x', slot=0, tenant='t')
    a.emit('serve.decode', request_id='x', slot=0, token_index=0)
    a.emit('serve.retire', request_id='x', status='completed',
           total_seconds=2.5)
    b.emit('serve.admit', request_id='y', slot=1, tenant='t')
    b.emit('serve.retire', request_id='y', status='completed',
           total_seconds=1.0)
    a.close()
    b.close()
    return [('r0', a.path), ('r1', b.path)]


def test_multi_source_tracks_one_pid_per_replica(tmp_path):
    srcs = {m.name: _two_tracks(m, tmp_path) for m in SIDES}
    traces = [reader.trace.export_trace(srcs[maker])
              for maker in ('port', 'jax') for reader in SIDES]
    assert all(t == traces[0] for t in traces[1:])
    evs = traces[0]['traceEvents']
    pids = {e['args']['name']: e['pid'] for e in evs if e['ph'] == 'M'}
    assert set(pids) == {'r0', 'r1'}
    xs = [e for e in evs if e['ph'] == 'X']
    assert {e['pid'] for e in xs if e['args']['request_id'] == 'x'} == {
        pids['r0']}
    assert {e['pid'] for e in xs if e['args']['request_id'] == 'y'} == {
        pids['r1']}


def test_write_trace_round_trips(tmp_path):
    path, _ = _sched_run(PORT, tmp_path)
    outs = []
    for m in SIDES:
        out = tmp_path / f'{m.name}-trace.json'
        trace = m.trace.write_trace(path, out)
        on_disk = json.loads(out.read_text())
        assert on_disk == json.loads(json.dumps(trace))
        assert on_disk['displayTimeUnit'] == 'ms'
        outs.append(on_disk)
    assert outs[0] == outs[1]


_MALFORMED = [
    {'traceEvents': [
        {'name': 'a', 'ph': 'X', 'ts': 0.0, 'dur': 1.0, 'pid': 1, 'tid': 0},
        {'name': 'b', 'ph': 'i', 'ts': 2.0, 'pid': 1, 'tid': 0}]},
    '{nope',
    {},
    {'traceEvents': [{'ph': 'X', 'ts': 0.0, 'dur': 1.0, 'pid': 1,
                      'tid': 0}]},
    {'traceEvents': [{'name': 'a', 'ph': 'X', 'ts': 0.0, 'dur': -1.0,
                      'pid': 1, 'tid': 0}]},
    {'traceEvents': [
        {'name': 'a', 'ph': 'i', 'ts': 5.0, 'pid': 1, 'tid': 0},
        {'name': 'b', 'ph': 'i', 'ts': 1.0, 'pid': 1, 'tid': 0}]},
    {'traceEvents': [
        {'name': 'a', 'ph': 'i', 'ts': 5.0, 'pid': 1, 'tid': 0},
        {'name': 'b', 'ph': 'i', 'ts': 1.0, 'pid': 2, 'tid': 0}]},
]


def test_validator_rejects_malformed_traces():
    got = [ttrace.validate_trace(t) for t in _MALFORMED]
    assert got == [jtrace.validate_trace(t) for t in _MALFORMED]
    assert got[0] == [] and got[6] == []
    assert got[1][0].startswith('not JSON')
    assert got[2] == ["missing top-level 'traceEvents'"]
    assert any('missing' in e for e in got[3])
    assert any('dur' in e for e in got[4])
    assert any('regresses' in e for e in got[5])


# -- the CLI ------------------------------------------------------------

def test_cli_json_outputs_match_the_reference(tmp_path, capsys):
    """Each subcommand's output and exit code on the same files:
    ``validate`` (with ``--require`` and ``--timelines``), ``stats
    --json`` (with ``--percentiles``, one log and a labeled pair),
    ``timeline --json``, ``slo report --json``, ``critpath --json`` and
    ``trace export``."""
    path, _ = _sched_run(PORT, tmp_path)
    jpath, _ = _sched_run(JAX, tmp_path)
    spec = tmp_path / 'spec.json'
    spec.write_text(json.dumps({'ttft': 0.05, 'per_token': 0.02}))
    argvs = [
        ['validate', str(path), str(jpath), '--timelines'],
        ['validate', str(path), '--require', 'serve.retire,replica.lost'],
        ['stats', str(path), '--json', '--percentiles'],
        ['stats', f'a={path}', f'b={jpath}', '--json'],
        ['stats', str(path)],
        ['timeline', str(path), 'r2', '--json'],
        ['timeline', str(path), 'nope', '--json'],
        ['slo', 'report', str(path), '--json', '--spec', str(spec)],
        ['slo', 'report', f'a={path}', f'b={jpath}', '--ttft', '0.05'],
        ['critpath', str(path), '--json'],
        ['critpath', str(path)],
        ['critpath', f'a={path}', f'b={jpath}', '--json'],
    ]
    for argv in argvs:
        got = _run_cli(PORT, argv, capsys)
        assert got == _run_cli(JAX, argv, capsys), argv
    assert _run_cli(PORT, argvs[1], capsys)[0] == 1
    rc, out, _ = _run_cli(PORT, ['critpath', str(path), '--json'], capsys)
    prof = json.loads(out)
    assert rc == 0 and prof['requests'] == 5
    assert not prof['partition_failures']
    assert prof['dispatch']['total']['ticks'] > 0
    rc, out, _ = _run_cli(PORT, ['critpath', str(path)], capsys)
    assert 'partition_failures=0' in out
    outs = []
    for m in SIDES:
        out_path = tmp_path / f'{m.name}-cli-trace.json'
        rc, text, _ = _run_cli(m, ['trace', 'export', str(path), '-o',
                                   str(out_path)], capsys)
        assert rc == 0 and 'OK' in text
        outs.append(json.loads(out_path.read_text()))
    assert outs[0] == outs[1]
    assert ttrace.validate_trace(outs[0]) == []


def test_cli_subcommands_match_the_reference(capsys):
    """The port's CLI offers the reference's subcommands and no others:
    an unknown one (``perf`` is the reference's separate ``obs.perf``
    tool, not a subcommand) is turned away by both with the same usage
    error listing the same choices."""
    errs = []
    for m in SIDES:
        with pytest.raises(SystemExit) as exc:
            m.cli.main(['perf', 'snapshot'])
        assert exc.value.code == 2
        err = capsys.readouterr().err
        errs.append(err[err.index('error:'):])
    assert errs[0] == errs[1]
    assert "invalid choice: 'perf'" in errs[0]
