# -*- coding: utf-8 -*-
"""
The port's Prometheus exporter (``obs/exporter.py``) against the
reference's, on the CPU:

- the JAX and the port registries fed the same sequence of operations
  (counters, gauges, labeled series with characters to escape,
  histograms with and without buckets, empty ones, NaN and infinities)
  render byte for byte the same text, apart from the build-info family,
  which names torch and CUDA where the reference names jax;
- the build info: schema and python versions as the reference's, the
  torch and CUDA versions, the same values in a flight bundle's
  MANIFEST;
- the endpoints' status codes: ``/metrics`` 200, ``/healthz`` 503 while
  starting and 200 ready or degraded (200 without a monitor), ``/dump``
  200 with a bundle written and 404 without a recorder, ``/profile``
  404 without a profiler, unknown paths 404.
"""

import json
import platform
import urllib.error
import urllib.request

import pytest
import torch

from distributed_dot_product_tpu.obs import exporter as jexporter
from distributed_dot_product_tpu.utils.tracing import (
    MetricsRegistry as JRegistry,
)
from distributed_dot_product_tpu_torch.obs import events as tevents
from distributed_dot_product_tpu_torch.obs import exporter as texporter
from distributed_dot_product_tpu_torch.obs import flight as tflight
from distributed_dot_product_tpu_torch.obs.exporter import (
    MetricsServer, build_info_labels, render_prometheus,
)
from distributed_dot_product_tpu_torch.serve.health import (
    HealthMonitor, Readiness,
)
from distributed_dot_product_tpu_torch.utils.tracing import MetricsRegistry


def _feed(reg):
    """One sequence of registry operations."""
    reg.counter('serve.admitted').inc(5)
    reg.counter('serve.rejected', labels={'reason': 'queue_full'}).inc(2)
    reg.counter('serve.rejected', labels={'reason': 'a"b\\c\nd'}).inc()
    reg.gauge('serve.queue_depth').set(3)
    reg.gauge('device.memory.bytes_in_use',
              labels={'device': 'cuda:0'}).set(5 * 2**20)
    reg.gauge('weird-name.with/chars').set(float('nan'))
    reg.gauge('serve.inf').set(float('inf'))
    reg.gauge('serve.ninf').set(float('-inf'))
    reg.gauge('serve.frac').set(0.125)
    h = reg.histogram('serve.step_seconds')
    for v in (0.1, 0.2, 0.3, 7.5):
        h.observe(v)
    reg.histogram('serve.empty_seconds')
    nb = reg.histogram('serve.cache.request_pages', buckets=())
    for v in (1, 4, 9):
        nb.observe(v)
    for tenant, vals in (('t0', (0.01, 0.02)), ('t1', (0.5,))):
        th = reg.histogram('serve.ttft_seconds', labels={'tenant': tenant})
        for v in vals:
            th.observe(v)
    reg.counter('serve.admitted').inc(1)
    return reg


def _split(text):
    """(lines but the build-info family's, that family's lines)."""
    lines = text.split('\n')
    info = [x for x in lines if 'build_info' in x]
    return [x for x in lines if 'build_info' not in x], info


@pytest.mark.parametrize('namespace', ['ddp', ''])
def test_render_equals_the_references(namespace):
    port = render_prometheus(_feed(MetricsRegistry()), namespace=namespace)
    ref = jexporter.render_prometheus(_feed(JRegistry()),
                                      namespace=namespace)
    port_body, port_info = _split(port)
    ref_body, ref_info = _split(ref)
    assert port_body == ref_body
    assert port.endswith('\n') and ref.endswith('\n')
    fam = f'{namespace}_build_info' if namespace else 'build_info'
    assert len(port_info) == len(ref_info) == 3
    assert port_info[1] == ref_info[1] == f'# TYPE {fam} gauge'
    assert f'{namespace}_serve_admitted_total 6'.lstrip('_') in port


def test_label_escaping_matches_the_reference():
    for value in ('plain', 'a"b', 'back\\slash', 'new\nline', 'ünï'):
        assert texporter.escape_label_value(value) == \
            jexporter.escape_label_value(value)


def test_build_info_names_torch_and_cuda():
    info = build_info_labels()
    ref = jexporter.build_info_labels()
    assert info['schema_version'] == ref['schema_version'] == str(
        tevents.SCHEMA_VERSION)
    assert info['python_version'] == ref['python_version'] == \
        platform.python_version()
    assert info['torch_version'] == torch.__version__
    assert info['cuda_version'] == (torch.version.cuda or 'none')
    assert set(info) == {'schema_version', 'torch_version', 'cuda_version',
                         'python_version'}
    text = render_prometheus(MetricsRegistry())
    assert (f'ddp_build_info{{schema_version="{info["schema_version"]}",'
            f'torch_version="{info["torch_version"]}",'
            f'cuda_version="{info["cuda_version"]}",'
            f'python_version="{info["python_version"]}"}} 1') in text


def test_flight_manifest_carries_the_build_info(tmp_path):
    rec = tflight.FlightRecorder(tmp_path / 'flight',
                                 registry=MetricsRegistry())
    manifest = tflight.load_bundle(rec.dump_bundle(trigger='manual'))[
        'manifest']
    info = build_info_labels()
    for key in ('torch_version', 'cuda_version', 'python_version'):
        assert manifest[key] == info[key]


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.status, resp.read().decode()


def _status(url):
    try:
        return _get(url)[0]
    except urllib.error.HTTPError as e:
        return e.code


def test_endpoint_status_codes(tmp_path):
    reg = MetricsRegistry()
    reg.counter('serve.admitted').inc(2)
    mon = HealthMonitor(stall_timeout=5.0, registry=reg)
    rec = tflight.FlightRecorder(tmp_path / 'flight', registry=reg)
    with MetricsServer(reg, health=mon, flight=rec) as srv:
        assert _status(srv.url + '/healthz') == 503      # starting
        mon.beat()
        mon.set_readiness(Readiness.READY, 'serving')
        code, body = _get(srv.url + '/healthz')
        assert code == 200 and json.loads(body)['readiness'] == 'ready'
        mon.set_readiness(Readiness.DEGRADED, 'pressure')
        assert _status(srv.url + '/healthz') == 200
        code, text = _get(srv.url + '/metrics')
        assert code == 200 and 'ddp_serve_admitted_total 2' in text
        code, body = _get(srv.url + '/dump?reason=probe')
        bundle = json.loads(body)['path']
        assert code == 200
        assert tflight.load_bundle(bundle)['manifest']['reason'] == 'probe'
        assert _status(srv.url + '/profile?seconds=1') == 404
        assert _status(srv.url + '/nope') == 404
    with MetricsServer(MetricsRegistry()) as srv:
        code, body = _get(srv.url + '/healthz')
        assert code == 200 and json.loads(body)['health'] is None
        assert tflight.get_recorder() is None
        assert _status(srv.url + '/dump') == 404
