# -*- coding: utf-8 -*-
"""
Device telemetry and on-demand profiling of the port (``obs/devmon.py``)
— the cases of ``tests/test_obs_devmon.py`` against the port, on the CPU:
memory-stats gauges over injectable devices (and the same gauges as the
reference's monitor for the same devices), the card's counters under the
reference's names, guarded ``ProfileCapture`` (one trace at a time — the
``/profile`` endpoint's 409 contract), the ``profile.capture`` event, and
the scheduler's adaptive ttft-p99 trigger beside the reference
scheduler's on the same burst.
"""

import json
import math
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from distributed_dot_product_tpu.obs import devmon as jdevmon
from distributed_dot_product_tpu.serve import KernelEngine as JEngine
from distributed_dot_product_tpu.serve import Scheduler as JScheduler
from distributed_dot_product_tpu.serve import ServeConfig as JServeConfig
from distributed_dot_product_tpu.utils.tracing import (
    MetricsRegistry as JRegistry,
)
from distributed_dot_product_tpu_torch import obs as tobs
from distributed_dot_product_tpu_torch.obs import events as obs_events
from distributed_dot_product_tpu_torch.obs import flight as tflight
from distributed_dot_product_tpu_torch.obs.devmon import (
    CaptureInFlight, CudaDevice, DeviceMonitor, ProfileCapture,
    device_stats_snapshot,
)
from distributed_dot_product_tpu_torch.obs.events import EventLog, activate
from distributed_dot_product_tpu_torch.obs.exporter import (
    MetricsServer, render_prometheus,
)
from distributed_dot_product_tpu_torch.obs.spans import collecting, span
from distributed_dot_product_tpu_torch.serve import (
    KernelEngine, Scheduler, ServeConfig,
)
from distributed_dot_product_tpu_torch.utils.tracing import MetricsRegistry
from torch_serving import cyclic_gc_paused  # noqa: E402,F401  autouse


class FakeDevice:
    platform = 'cuda'
    device_kind = 'fake H9'

    def __init__(self, dev_id, stats):
        self.id = dev_id
        self._stats = stats

    def memory_stats(self):
        if self._stats is None:
            raise NotImplementedError('no stats on this device')
        return self._stats


@pytest.fixture(autouse=True)
def _no_retrace_sentinel(monkeypatch):
    monkeypatch.setenv('DDP_TPU_RETRACE_SENTINEL', '0')


# -- DeviceMonitor ------------------------------------------------------

def test_poll_once_fills_labeled_gauges():
    reg = MetricsRegistry()
    devs = [FakeDevice(0, {'bytes_in_use': 5 * 2**20,
                           'peak_bytes_in_use': 9 * 2**20,
                           'bytes_limit': 16 * 2**30,
                           'ignored_key': 'not-a-number'}),
            FakeDevice(1, None)]          # a device without stats
    mon = DeviceMonitor(reg, devices=devs)
    out = mon.poll_once()
    assert set(out) == {'cuda:0'}
    g = reg.gauge('device.memory.bytes_in_use', labels={'device': 'cuda:0'})
    assert g.value == 5 * 2**20
    assert reg.gauge('device.memory.devices_reporting').value == 1
    assert reg.counter('device.memory.polls').value == 1
    text = render_prometheus(reg)
    assert ('ddp_device_memory_bytes_in_use{device="cuda:0"} '
            f'{5 * 2**20}') in text
    assert f'ddp_device_memory_bytes_limit{{device="cuda:0"}} ' \
           f'{16 * 2**30}' in text


def test_gauges_go_nan_when_device_stops_reporting():
    reg = MetricsRegistry()
    dev = FakeDevice(0, {'bytes_in_use': 5})
    mon = DeviceMonitor(reg, devices=[dev])
    mon.poll_once()
    g = reg.gauge('device.memory.bytes_in_use', labels={'device': 'cuda:0'})
    assert g.value == 5
    dev._stats = None
    mon.poll_once()
    assert math.isnan(g.value)
    assert reg.gauge('device.memory.devices_reporting').value == 0
    dev._stats = {'bytes_in_use': 7}
    mon.poll_once()
    assert g.value == 7


def test_monitor_gauges_equal_the_references():
    """The same devices through both monitors: the same gauges, polls
    and NaN flips (the label is the device's own platform:id)."""
    seq = [{'bytes_in_use': 5, 'bytes_limit': 80, 'num_allocs': 3},
           None, {'bytes_in_use': 7, 'bytes_reserved': 64}]
    snaps = []
    for mod, reg in ((jdevmon, JRegistry()), (tobs.devmon,
                                              MetricsRegistry())):
        dev = FakeDevice(0, None)
        mon = mod.DeviceMonitor(reg, devices=[dev, FakeDevice(1, None)])
        for stats in seq:
            dev._stats = stats
            mon.poll_once()
        snaps.append(json.dumps(reg.snapshot(), sort_keys=True,
                                default=str))
    assert snaps[0] == snaps[1]


def test_monitor_thread_polls_on_interval():
    reg = MetricsRegistry()
    mon = DeviceMonitor(reg, devices=[FakeDevice(0, {'bytes_in_use': 1})],
                        interval=0.01)
    with mon:
        deadline = time.monotonic() + 5.0
        while (reg.counter('device.memory.polls').value < 3
               and time.monotonic() < deadline):
            time.sleep(0.01)
    assert reg.counter('device.memory.polls').value >= 3
    assert mon._thread is None


def test_device_stats_snapshot_shapes():
    snap = device_stats_snapshot(devices=[
        FakeDevice(0, {'bytes_in_use': 7}), FakeDevice(1, None)])
    assert snap[0]['device'] == 'cuda:0'
    assert snap[0]['memory_stats'] == {'bytes_in_use': 7}
    assert snap[1]['memory_stats'] is None
    # No card here: the one visible device is the CPU, without stats —
    # and the monitor reports nothing, as the reference's on a backend
    # without stats.
    real = device_stats_snapshot()
    assert real == [{'device': 'cpu:0', 'platform': 'cpu',
                     'device_kind': 'cpu', 'memory_stats': None}]
    reg = MetricsRegistry()
    assert DeviceMonitor(reg).poll_once() == {}
    assert reg.gauge('device.memory.devices_reporting').value == 0
    # The snapshot moved here from the flight recorder, which samples it.
    assert tflight.device_stats_snapshot is device_stats_snapshot
    assert tobs.device_stats_snapshot is device_stats_snapshot


def test_cuda_device_maps_torch_counters(monkeypatch):
    """The card's counters under the reference's keys."""
    stats = {'allocated_bytes.all.current': 11,
             'allocated_bytes.all.peak': 29,
             'reserved_bytes.all.current': 64,
             'allocation.all.allocated': 5}
    monkeypatch.setattr(torch.cuda, 'memory_stats', lambda i: stats)
    monkeypatch.setattr(torch.cuda, 'mem_get_info', lambda i: (3, 80))
    reg = MetricsRegistry()
    DeviceMonitor(reg, devices=[CudaDevice(0)]).poll_once()
    got = {k: reg.gauge(f'device.memory.{k}',
                        labels={'device': 'cuda:0'}).value
           for k in ('bytes_in_use', 'peak_bytes_in_use', 'bytes_reserved',
                     'num_allocs', 'bytes_limit')}
    assert got == {'bytes_in_use': 11, 'peak_bytes_in_use': 29,
                   'bytes_reserved': 64, 'num_allocs': 5, 'bytes_limit': 80}
    assert reg.peek('gauge', 'device.memory.largest_free_block_bytes',
                    {'device': 'cuda:0'}) is None


# -- ProfileCapture -----------------------------------------------------

def _trace(path):
    with open(os.path.join(path, 'trace.json')) as f:
        return json.load(f)['traceEvents']


def test_capture_writes_loadable_trace_and_event(tmp_path):
    """A capture started here and stopped by its worker records this
    thread's spans and ops (every thread is profiled)."""
    reg = MetricsRegistry()
    prof = ProfileCapture(tmp_path / 'traces', registry=reg,
                          max_seconds=1.0)
    log_path = tmp_path / 'ev.jsonl'
    with activate(EventLog(log_path)) as log, collecting():
        info = prof.start(0.2, trigger='unit-test')
        deadline = time.monotonic() + 0.3
        while time.monotonic() < deadline:
            with span('serve.step'):
                torch.ones(32, 32).sum()
        assert prof.join(60.0)
        log.flush()
    assert info['seconds'] == 0.2
    assert info['trigger'] == 'unit-test'
    names = {e.get('name') for e in _trace(info['path'])}
    assert 'serve.step' in names and 'aten::sum' in names
    assert reg.counter('profile.captures').value == 1
    assert reg.gauge('profile.capture_in_flight').value == 0
    records, errors = obs_events.validate_file(str(log_path))
    assert errors == []
    caps = [r for r in records if r['event'] == 'profile.capture']
    assert caps and caps[0]['trigger'] == 'unit-test'
    assert caps[0]['path'] == info['path']


def test_warmup_pays_init_once_and_is_guarded(tmp_path):
    reg = MetricsRegistry()
    prof = ProfileCapture(tmp_path / 'traces', registry=reg)
    assert not prof.warmed
    assert prof.warmup() is True
    assert prof.warmed
    assert (tmp_path / 'traces' / 'warmup').exists()
    assert prof.warmup() is False        # idempotent
    assert reg.counter('profile.captures').value == 0
    assert reg.gauge('profile.capture_in_flight').value == 0

    prof2 = ProfileCapture(tmp_path / 't2', registry=MetricsRegistry())
    prof2._in_flight = True
    with pytest.raises(CaptureInFlight):
        prof2.warmup()
    prof2._in_flight = False
    # A real capture pays the init too: the instance comes out warmed.
    prof2.start(0.01)
    assert prof2.join(60.0)
    assert prof2.warmed
    assert prof2.warmup() is False


def test_capture_seconds_clamped_and_validated(tmp_path):
    prof = ProfileCapture(tmp_path, registry=MetricsRegistry(),
                          max_seconds=0.05, clock=lambda s: None)
    info = prof.start(3600)
    assert info['seconds'] == 0.05
    assert prof.join(60.0)
    with pytest.raises(ValueError):
        prof.start(0)
    with pytest.raises(ValueError):
        prof.start(-1)


def test_second_capture_while_in_flight_raises(tmp_path):
    release = threading.Event()
    prof = ProfileCapture(tmp_path, registry=MetricsRegistry(),
                          clock=lambda s: release.wait(60))
    prof.start(0.2)
    try:
        assert prof.busy
        with pytest.raises(CaptureInFlight):
            prof.start(0.2)
    finally:
        release.set()
    assert prof.join(60.0)
    prof.start(0.01)
    assert prof.join(60.0)


def test_capture_never_reuses_populated_trace_dir(tmp_path):
    base = tmp_path / 'traces'
    stale = base / 'trace-0001'
    stale.mkdir(parents=True)
    (stale / 'old.json').write_text('previous run')
    prof = ProfileCapture(base, registry=MetricsRegistry(),
                          clock=lambda s: None)
    info = prof.start(0.01)
    assert prof.join(60.0)
    assert info['path'] != str(stale)
    assert 'old.json' not in os.listdir(info['path'])


# -- /profile endpoint --------------------------------------------------

def _get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.status, resp.read().decode()


def test_profile_endpoint_guarded_concurrency(tmp_path):
    release = threading.Event()
    started = threading.Event()

    def gated_sleep(seconds):
        started.set()
        release.wait(60)

    reg = MetricsRegistry()
    prof = ProfileCapture(tmp_path / 'traces', registry=reg,
                          clock=gated_sleep)
    with MetricsServer(reg, profiler=prof) as srv:
        code, body = _get(srv.url + '/profile?seconds=0.2')
        assert code == 200
        first = json.loads(body)
        assert first['status'] == 'capturing'
        assert started.wait(60)
        for query, status in (('seconds=0.2', 409), ('seconds=nope', 400),
                              ('seconds=-3', 400)):
            with pytest.raises(urllib.error.HTTPError) as exc:
                _get(srv.url + '/profile?' + query)
            assert exc.value.code == status
        release.set()
        assert prof.join(60.0)
        code, body = _get(srv.url + '/profile?seconds=0.01')
        assert code == 200
        assert json.loads(body)['path'] != first['path']
        assert prof.join(60.0)
    assert _trace(first['path']) is not None


def test_profile_endpoint_404_without_profiler():
    with MetricsServer(MetricsRegistry()) as srv:
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(srv.url + '/profile?seconds=1')
        assert exc.value.code == 404


# -- scheduler adaptive trigger (tests/test_obs_devmon.py:310-340) ------

class StubProfiler:
    def __init__(self, busy=False):
        self.busy = busy
        self.calls = []

    def start(self, seconds, **kw):
        self.calls.append((seconds, kw))
        return {'path': 'stub', 'seconds': seconds}


def _run_burst(side, profiler, **cfg_kw):
    if side == 'jax':
        reg = JRegistry()
        eng = JEngine(slots=2, t_max=32, vocab=16, heads=2, head_dim=4,
                      prefill_chunk=4, seed=3)
        make, cfg = JScheduler, JServeConfig
    else:
        reg = MetricsRegistry()
        eng = KernelEngine(slots=2, t_max=32, vocab=16, heads=2, head_dim=4,
                           prefill_chunk=4, seed=3, device='cpu')
        make, cfg = Scheduler, ServeConfig
    sched = make(eng, cfg(watchdog=False, queue_limit=16, max_new_tokens=4,
                          **cfg_kw),
                 registry=reg, profiler=profiler)
    for i in range(6):
        sched.submit(np.array([1, 2, 3], np.int32), request_id=f'r{i}')
    sched.run_until_idle()
    sched.close()
    return reg


@pytest.mark.parametrize('case', ['fires_once_under_cooldown',
                                  'skips_while_in_flight',
                                  'disarmed_by_default',
                                  'respects_threshold'])
def test_ttft_trigger_matches_the_reference(case):
    kw, busy = {
        'fires_once_under_cooldown': (dict(
            profile_ttft_p99=0.0, profile_seconds=1.5,
            profile_cooldown=3600.0), False),
        'skips_while_in_flight': (dict(profile_ttft_p99=0.0,
                                       profile_cooldown=0.0), True),
        'disarmed_by_default': ({}, False),
        'respects_threshold': (dict(profile_ttft_p99=3600.0,
                                    profile_cooldown=0.0), False),
    }[case]
    calls, fired = [], []
    for side in ('jax', 'port'):
        stub = StubProfiler(busy=busy)
        reg = _run_burst(side, stub, **kw)
        calls.append([(s, {k: v for k, v in c.items() if k != 'ttft_p99'})
                      for s, c in stub.calls])
        fired.append(reg.counter('serve.profile_triggers').value)
        for _, c in stub.calls:
            assert c['ttft_p99'] > c['threshold']
    assert calls[0] == calls[1] and fired[0] == fired[1]
    want = 1 if case == 'fires_once_under_cooldown' else 0
    assert fired[1] == len(calls[1]) == want
    if want:
        seconds, c = calls[1][0]
        assert seconds == 1.5 and c['trigger'] == 'serve.ttft_p99'
        assert c['threshold'] == 0.0


def test_profile_warmup_at_construction_and_anomaly_profiler(tmp_path):
    """``profile_warmup`` pays the profiler's init when the scheduler is
    built; the anomaly watchdog the config arms holds the same profiler
    (its ``'profile'`` action)."""
    prof = ProfileCapture(tmp_path, registry=MetricsRegistry())
    eng = KernelEngine(slots=2, t_max=32, vocab=16, heads=2, head_dim=4,
                       prefill_chunk=4, seed=3, device='cpu')
    sched = Scheduler(eng, ServeConfig(watchdog=False, anomaly=True,
                                       profile_warmup=True),
                      registry=MetricsRegistry(), profiler=prof)
    try:
        assert prof.warmed
        assert sched._anomaly.profiler is prof
    finally:
        sched.close()
