# -*- coding: utf-8 -*-
"""
The port's anomaly watchdog (``obs/anomaly.py``) against the reference
package on the CPU: twins of all fifteen tests of
``tests/test_obs_anomaly.py`` — detector semantics (EWMA z-score warmup
and re-baseline, static thresholds, rate-of-change cliffs), watch reading
(gauge / percentile / counter rate / fn, absent series skipped), breach
events and cooldowns, the profile and dump actions, and the scheduler
integration (``Scheduler(anomaly=...)``, ``ServeConfig(anomaly=True)``).

Each scenario runs on both packages' modules; what it returns (every
verdict dict, every read, the breach records, the counters) must be
EQUAL, then the reference test's own assertions run on the port's
result. A seeded sweep feeds the same random series to every detector of
both packages and holds the verdicts equal.
"""

import types

import numpy as np
import pytest

from distributed_dot_product_tpu import obs as jobs
from distributed_dot_product_tpu import serve as jserve
from distributed_dot_product_tpu.obs import anomaly as janomaly
from distributed_dot_product_tpu.obs import flight as jflight
from distributed_dot_product_tpu.utils.tracing import (
    MetricsRegistry as JRegistry,
)
from distributed_dot_product_tpu_torch import obs as tobs
from distributed_dot_product_tpu_torch import serve as tserve
from distributed_dot_product_tpu_torch.obs import anomaly as tanomaly
from distributed_dot_product_tpu_torch.obs import flight as tflight
from distributed_dot_product_tpu_torch.utils.tracing import (
    MetricsRegistry as TRegistry,
)
from torch_serving import state
from torch_serving import cyclic_gc_paused  # noqa: E402,F401  autouse

JAX = types.SimpleNamespace(name='jax', a=janomaly, obs=jobs, flight=jflight,
                            Registry=JRegistry, serve=jserve)
PORT = types.SimpleNamespace(name='port', a=tanomaly, obs=tobs,
                             flight=tflight, Registry=TRegistry,
                             serve=tserve)


@pytest.fixture(autouse=True)
def _no_retrace_sentinel(monkeypatch):
    monkeypatch.setenv('DDP_TPU_RETRACE_SENTINEL', '0')


def _both(fn, *args):
    """``fn(side, *args)`` on the port and on the reference: equal, and
    the port's returned."""
    got = fn(PORT, *args)
    assert got == fn(JAX, *args)
    return got


# -- detectors -----------------------------------------------------------

def _static(m):
    above = m.a.StaticThreshold(above=10.0)
    below = m.a.StaticThreshold(below=1.0)
    with pytest.raises(ValueError) as exc:
        m.a.StaticThreshold()
    return ([above.update(9.9), above.update(10.1)],
            [below.update(1.0), below.update(0.0)], str(exc.value))


def test_static_threshold_above_below():
    above, below, err = _both(_static)
    assert above[0] is None
    assert above[1]['kind'] == 'above' and above[1]['threshold'] == 10.0
    assert below[0] is None and below[1]['kind'] == 'below'
    assert 'above= or below=' in err


def _warmup(m):
    det = m.a.EwmaZScore(z=4.0, alpha=0.2, min_samples=16)
    out = [det.update(v) for v in [0.01, 0.5, 0.01] + [0.01] * 13]
    out += [det.update(0.0101) for _ in range(20)]
    out.append(det.update(5.0))
    return out


def test_ewma_zscore_warms_up_then_flags_spikes():
    out = _both(_warmup)
    assert all(v is None for v in out[:-1])
    verdict = out[-1]
    assert verdict['kind'] == 'zscore' and abs(verdict['z']) > 4.0
    assert verdict['mean'] < 0.1 and verdict['threshold'] == 4.0


def _rebaseline(m):
    det = m.a.EwmaZScore(z=4.0, alpha=0.3, min_samples=8)
    for _ in range(20):
        det.update(1.0)
    shift = det.update(100.0)
    for _ in range(30):
        det.update(100.0)
    quiet = det.update(100.5)
    det.reset()
    return shift, quiet, det._n


def test_ewma_zscore_rebaselines_on_sustained_shift():
    shift, quiet, n = _both(_rebaseline)
    assert shift is not None and quiet is None and n == 0


def _constant(m):
    det = m.a.EwmaZScore(z=4.0, min_samples=8, min_sigma=1e-3)
    for _ in range(20):
        det.update(1.0)
    return det.update(1.001)


def test_ewma_constant_stream_does_not_flag_jitter():
    assert _both(_constant) is None


def _rate(m):
    det = m.a.RateOfChange(max_delta=5.0)
    rel = m.a.RateOfChange(max_ratio=0.5)
    with pytest.raises(ValueError) as exc:
        m.a.RateOfChange()
    return ([det.update(10.0), det.update(12.0), det.update(30.0)],
            [rel.update(100.0), rel.update(120.0), rel.update(10.0)],
            str(exc.value))


def test_rate_of_change_delta_and_ratio():
    delta, ratio, err = _both(_rate)
    assert delta[:2] == [None, None]
    assert delta[2]['kind'] == 'delta' and delta[2]['previous'] == 12.0
    assert ratio[1] is None and ratio[2]['kind'] == 'ratio'
    assert 'max_delta= or' in err


def _series(m, seed):
    """One seeded series (steady, noisy, a level shift, spikes, a cliff)
    through every detector family, every verdict kept."""
    rng = np.random.default_rng(seed)
    base = np.concatenate([
        np.full(20, 1.0) + rng.normal(0, 1e-3, 20),
        rng.normal(1.0, 0.05, 40),
        rng.normal(3.0, 0.2, 40),
        rng.normal(3.0, 0.2, 20) * (1 + 4 * (rng.random(20) < 0.1)),
        np.linspace(3.0, 0.0, 10)])
    dets = [m.a.EwmaZScore(), m.a.EwmaZScore(z=2.5, alpha=0.1,
                                             min_samples=4),
            m.a.StaticThreshold(above=3.5, below=0.2),
            m.a.RateOfChange(max_delta=1.0),
            m.a.RateOfChange(max_ratio=0.3)]
    return [[d.update(float(v)) for v in base] for d in dets]


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_detector_verdicts_equal_on_seeded_series(seed):
    """Every detector family on the same seeded series: the reference's
    verdicts, value for value (float math in the same order)."""
    out = _both(_series, seed)
    assert any(v is not None for row in out for v in row)


# -- watch reading -------------------------------------------------------

def _reads(m):
    reg = m.Registry()
    out = []
    w_gauge = m.a.Watch(name='g', metric='serve.queue_depth',
                        detector=m.a.StaticThreshold(above=5),
                        signal='gauge')
    out.append(w_gauge.read(reg, now=0.0))
    out.append(reg.snapshot()['gauges'])
    reg.gauge('serve.queue_depth').set(7)
    out.append(w_gauge.read(reg, now=1.0))
    w_p99 = m.a.Watch(name='p', metric='serve.ttft_seconds',
                      detector=m.a.StaticThreshold(above=5), signal='p99')
    out.append(w_p99.read(reg, now=0.0))
    h = reg.histogram('serve.ttft_seconds')
    out.append(w_p99.read(reg, now=0.0))
    h.observe(0.25)
    out.append(w_p99.read(reg, now=1.0))
    w_rate = m.a.Watch(name='r', metric='serve.tokens_generated',
                       detector=m.a.StaticThreshold(above=1e9),
                       signal='counter', rate=True)
    reg.counter('serve.tokens_generated').inc(10)
    out.append(w_rate.read(reg, now=10.0))
    reg.counter('serve.tokens_generated').inc(10)
    out.append(w_rate.read(reg, now=12.0))
    w_fn = m.a.Watch(name='f', metric='x', signal='fn',
                     fn=lambda r: 42.0,
                     detector=m.a.StaticThreshold(above=41))
    out.append(w_fn.read(reg, now=0.0))
    bad = m.a.Watch(name='b', metric='x', signal='p42',
                    detector=m.a.StaticThreshold(above=1))
    with pytest.raises(ValueError) as exc:
        bad.read(reg, now=0.0)
    out.append(str(exc.value))
    return out


def test_watch_reads_signals_and_skips_absent_series():
    out = _both(_reads)
    assert out[0] is None and out[1] == {}
    assert out[2] == 7.0
    assert out[3] is None and out[4] is None and out[5] == 0.25
    assert out[6] is None and out[7] == pytest.approx(5.0)
    assert out[8] == 42.0
    assert 'unknown signal' in out[9]


# -- the watchdog --------------------------------------------------------

class _FakeProfiler:
    def __init__(self):
        self.calls = []

    def start(self, seconds=None, *, trigger='manual', event_log=None,
              **extra):
        self.calls.append((trigger, seconds, extra))
        return {'path': '/nowhere', 'seconds': seconds, 'trigger': trigger}


def _breach(m, tmp_path):
    reg = m.Registry()
    reg.gauge('serve.queue_depth').set(100)
    prof = _FakeProfiler()
    log = m.obs.EventLog(tmp_path / f'{m.name}-ev.jsonl')
    dog = m.a.AnomalyWatchdog(
        reg,
        [m.a.Watch(name='depth', metric='serve.queue_depth',
                   detector=m.a.StaticThreshold(above=10), signal='gauge',
                   actions=('profile', 'dump'))],
        profiler=prof, event_log=log, min_interval=0.0)
    with m.flight.recording(base_dir=tmp_path / m.name / 'flight',
                            registry=reg) as rec:
        fired = dog.tick(force=True)
    log.close()
    records, errors = m.obs.validate_file(log.path)
    breach = [{k: v for k, v in r.items() if k not in ('ts', 'seq')}
              for r in records if r['event'] == 'anomaly.detected']
    counters = reg.snapshot()['counters']
    return dict(fired=[(w.name, v) for w, v in fired], errors=errors,
                breach=breach, calls=prof.calls,
                dumps=[(d['trigger'], d['reason']) for d in rec.dumps],
                breaches=dog.breaches,
                counters={k: v for k, v in counters.items()
                          if k.startswith('anomaly.')})


def test_breach_emits_event_chains_profiler_and_dump(tmp_path):
    got = _both(_breach, tmp_path)
    assert len(got['fired']) == 1 and got['errors'] == []
    assert len(got['breach']) == 1
    b = got['breach'][0]
    assert (b['metric'], b['detector'], b['value'], b['watch']) == (
        'serve.queue_depth', 'StaticThreshold', 100.0, 'depth')
    assert [c[0] for c in got['calls']] == ['anomaly.depth']
    assert len(got['dumps']) == 1 and got['dumps'][0][0] == 'anomaly'
    assert 'depth' in got['dumps'][0][1]
    assert got['counters'] == {'anomaly.breaches': 1,
                               'anomaly.breaches.depth': 1}


def _no_refeed(m):
    reg = m.Registry()
    h = reg.histogram('serve.ttft_seconds')
    det = m.a.EwmaZScore(z=4.0, min_samples=4)
    dog = m.a.AnomalyWatchdog(
        reg, [m.a.Watch(name='ttft', metric='serve.ttft_seconds',
                        detector=det, signal='p99')], min_interval=0.0)
    for v in (0.010, 0.011, 0.0105, 0.0102, 0.0108, 0.0101):
        h.observe(v)
        dog.tick(force=True)
    n_before = det._n
    idle = [dog.tick(force=True) for _ in range(200)]
    n_after = det._n
    h.observe(0.0115)
    return n_before, n_after, idle, dog.tick(force=True), dog.breaches


def test_unchanged_reading_not_refed_no_variance_collapse():
    n_before, n_after, idle, fresh, breaches = _both(_no_refeed)
    assert n_before == n_after and all(t == [] for t in idle)
    assert fresh == [] and breaches == []


def _cooldown(m):
    reg = m.Registry()
    reg.gauge('serve.queue_depth').set(100)
    dog = m.a.AnomalyWatchdog(
        reg, [m.a.Watch(name='depth', metric='serve.queue_depth',
                        detector=m.a.StaticThreshold(above=10),
                        signal='gauge', cooldown=3600.0)],
        min_interval=0.0)
    return (len(dog.tick(force=True)), dog.tick(force=True),
            len(dog.breaches))


def test_breach_cooldown_suppresses_re_alerts():
    assert _both(_cooldown) == (1, [], 1)


def _throttle(m):
    reg = m.Registry()
    dog = m.a.AnomalyWatchdog(reg, [], min_interval=3600.0)
    first = dog.tick()
    reg.gauge('serve.queue_depth').set(100)
    dog.watches.append(m.a.Watch(name='depth', metric='serve.queue_depth',
                                 detector=m.a.StaticThreshold(above=10),
                                 signal='gauge'))
    return first, dog.tick(), len(dog.tick(force=True))


def test_tick_throttles_on_real_time():
    assert _both(_throttle) == ([], [], 1)


def _virtual_clock(m):
    """The clock the controller injects: the throttle, the cooldowns and
    the rate differentiate on it."""
    clock = m.serve.VirtualClock()
    reg = m.Registry()
    c = reg.counter('serve.tokens_generated')
    dog = m.a.AnomalyWatchdog(
        reg, [m.a.Watch(name='tps', metric='serve.tokens_generated',
                        signal='counter', rate=True, cooldown=0.05,
                        detector=m.a.EwmaZScore(min_samples=4))],
        min_interval=0.01, clock=clock)
    out = []
    for i in range(40):
        c.inc(10 if i != 30 else 400)
        out.append([(w.name, v) for w, v in dog.tick()])
        clock.advance(0.005)
    return out, dog.breaches


def test_watchdog_on_an_injected_clock():
    out, breaches = _both(_virtual_clock)
    assert breaches and any(out)


def _contained(m):
    reg = m.Registry()
    reg.gauge('g').set(1)
    dog = m.a.AnomalyWatchdog(
        reg,
        [m.a.Watch(name='bad', metric='g', signal='fn',
                   fn=lambda r: (_ for _ in ()).throw(RuntimeError('x')),
                   detector=m.a.StaticThreshold(above=0)),
         m.a.Watch(name='good', metric='g', signal='gauge',
                   detector=m.a.StaticThreshold(above=0))],
        min_interval=0.0)
    fired = dog.tick(force=True)
    return ([w.name for w, _ in fired],
            reg.snapshot()['counters']['exceptions_swallowed.anomaly.read'])


def test_broken_detector_is_contained():
    assert _both(_contained) == (['good'], 1)


def _catalog(m, kw):
    return [(w.name, w.metric, w.signal, w.rate, w.cooldown, w.actions,
             type(w.detector).__name__, dict(vars(w.detector)))
            for w in m.a.default_watches(**kw)]


@pytest.mark.parametrize('kw', [dict(queue_limit=8, paged=True), dict(),
                                dict(queue_limit=3, ttft_z=2.0,
                                     cooldown=0.01)])
def test_default_watches_catalog(kw):
    """The stock catalog, watch for watch, detector settings included."""
    got = _both(_catalog, kw)
    by_name = {row[0]: row for row in got}
    if kw.get('paged'):
        assert set(by_name) == {'ttft_p99', 'dispatch_overhead_p99',
                                'tokens_per_s', 'queue_depth',
                                'reject_rate', 'pages_free', 'kv_corrupt'}
        assert by_name['ttft_p99'][5] == ('profile', 'dump')
        assert by_name['dispatch_overhead_p99'][1] == \
            'serve.dispatch_overhead_seconds'
        assert by_name['dispatch_overhead_p99'][5] == ('dump',)
        assert by_name['queue_depth'][6] == 'StaticThreshold'
        assert by_name['queue_depth'][7]['above'] == pytest.approx(7.2)
        assert by_name['pages_free'][7]['below'] == 1
    if not kw:
        assert 'pages_free' not in by_name
        assert by_name['queue_depth'][6] == 'EwmaZScore'


def _reject_total(m):
    reg = m.Registry()
    reg.counter('serve.rejected.queue_full').inc(3)
    reg.counter('serve.rejected.deadline_exceeded').inc(2)
    reg.counter('serve.rejected.no_replica').inc(4)
    return m.a._reject_total(reg)


def test_reject_total_sums_typed_counters():
    assert _both(_reject_total) == 9.0


# -- scheduler integration ----------------------------------------------

def _engine(m, **kw):
    if m is PORT:
        eng = m.serve.KernelEngine(device='cpu', **kw)
        eng.load_weights(state(kw['seed'], vocab=kw['vocab'],
                               heads=kw['heads'], head_dim=kw['head_dim']))
        return eng
    return m.serve.KernelEngine(decode_impl='xla', **kw)


def _scheduler_tick(m, tmp_path):
    reg = m.Registry()
    log = m.obs.EventLog(tmp_path / f'{m.name}-sched.jsonl')
    dog = m.a.AnomalyWatchdog(
        reg, [m.a.Watch(name='queue_depth', metric='serve.queue_depth',
                        detector=m.a.StaticThreshold(above=2.5),
                        signal='gauge', actions=('dump',))],
        event_log=log, min_interval=0.0)
    eng = _engine(m, slots=2, t_max=32, vocab=16, heads=2, head_dim=4,
                  prefill_chunk=4, seed=5)
    with m.flight.recording(base_dir=tmp_path / m.name / 'flight',
                            registry=reg) as rec:
        sched = m.serve.Scheduler(
            eng, m.serve.ServeConfig(queue_limit=6, max_new_tokens=3,
                                     watchdog=False,
                                     evict_before_reject=False),
            fault_injector=False, registry=reg, event_log=log, anomaly=dog)
        rng = np.random.default_rng(3)
        rejected = []
        for i in range(10):
            try:
                sched.submit(rng.integers(0, 16, size=3).astype(np.int32),
                             request_id=f'r{i}')
            except m.serve.RejectedError:
                rejected.append(i)
        results = sched.run_until_idle()
        sched.close()
    log.close()
    records, errors = m.obs.validate_file(log.path)
    return dict(breaches=dog.breaches, errors=errors, rejected=rejected,
                results={rid: (r.status, list(r.tokens))
                         for rid, r in results.items()},
                detected=[r['watch'] for r in records
                          if r['event'] == 'anomaly.detected'],
                dumps=[d['trigger'] for d in rec.dumps])


def test_scheduler_anomaly_tick_fires_and_logs(tmp_path):
    """A scheduler armed with a custom watchdog breaches under an
    overflowing burst, the breach lands in the run's log and the chained
    flight dump is written: the reference's breaches and streams."""
    got = _both(_scheduler_tick, tmp_path)
    assert got['breaches'] and got['errors'] == []
    assert 'queue_depth' in got['detected'] and 'anomaly' in got['dumps']


def _stock(m):
    eng = _engine(m, slots=2, t_max=16, vocab=16, heads=2, head_dim=4,
                  seed=0)
    sched = m.serve.Scheduler(eng, m.serve.ServeConfig(watchdog=False,
                                                       anomaly=True),
                              registry=m.Registry())
    try:
        return [(w.name, type(w.detector).__name__)
                for w in sched._anomaly.watches]
    finally:
        sched.close()


def test_serveconfig_anomaly_true_builds_stock_catalog():
    names = {n for n, _ in _both(_stock)}
    assert names >= {'ttft_p99', 'tokens_per_s', 'queue_depth',
                     'reject_rate'}
