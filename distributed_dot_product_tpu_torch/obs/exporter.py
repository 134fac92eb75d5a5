# -*- coding: utf-8 -*-
"""
Prometheus-text exporter for the in-process metrics registry, plus an
optional stdlib HTTP endpoint serving ``/metrics``, ``/healthz``,
``/profile`` and ``/dump``. Copied from
``distributed_dot_product_tpu/obs/exporter.py``: the same registry
operations render the same text, but for the build-info family.

No external metrics dependency is used, so this renders the
`Prometheus exposition format (0.0.4)` by hand from
``MetricsRegistry`` state:

- counters  → ``<ns>_<name>_total`` (``# TYPE counter``)
- gauges    → ``<ns>_<name>`` (``# TYPE gauge``)
- histograms → a summary family: ``{quantile="0.5"|"0.99"}`` lines from
  the aged reservoir (CURRENT behavior — what an alert wants) plus the
  Prometheus-mandated cumulative ``_count``/``_sum`` from the lifetime
  totals (``Histogram.summary()``'s ``total_count``/``total_sum``);
  histograms with bucket bounds ALSO render a real cumulative
  histogram family ``<fam>_hist`` with ``_bucket{le="..."}`` lines —
  lifetime counters an external Prometheus can sum across replicas.

Dotted registry names are sanitized (``serve.queue_depth`` →
``ddp_serve_queue_depth``); labeled metrics (``registry.counter(name,
labels={...})``) render with escaped label values per the exposition
rules (backslash, double-quote, newline).

The server is **off by default** — construct and :meth:`~MetricsServer.
start` it explicitly::

    srv = MetricsServer(registry, health=monitor, port=9100).start()
    ...  # curl localhost:9100/metrics ; curl localhost:9100/healthz
    srv.stop()

``/healthz`` returns the :class:`~distributed_dot_product_tpu_torch.
serve.health.HealthMonitor` snapshot, status 200 while readiness is
``ready``/``degraded`` (degraded still serves) and 503 otherwise — the
shape a load-balancer probe consumes.

With a ``profiler`` (:class:`~distributed_dot_product_tpu_torch.obs.
devmon.ProfileCapture`), ``/profile?seconds=N`` begins one bounded
``torch.profiler`` capture — 200 with the trace directory, 409 while
one is already in flight (never two traces), 400 on a bad duration, 404
when the server carries no profiler.

``GET /dump[?reason=...]`` writes one flight-recorder post-mortem
bundle (obs/flight.py) — the server's explicit ``flight=`` recorder or
the process-installed one; 404 without either. Every render also
carries the constant ``<ns>_build_info{schema_version,torch_version,
cuda_version,python_version}`` gauge so merged multi-replica scrapes
can detect version skew.
"""

import http.server
import json
import math
import re
import threading
import urllib.parse
from typing import Optional

from distributed_dot_product_tpu_torch.utils import tracing

__all__ = ['render_prometheus', 'escape_label_value', 'MetricsServer',
           'build_info_labels']

_NAME_SANITIZE = re.compile(r'[^a-zA-Z0-9_:]')


def _metric_name(namespace, name):
    base = _NAME_SANITIZE.sub('_', name)
    return f'{namespace}_{base}' if namespace else base


def escape_label_value(value):
    """Escape a label value per the exposition format: backslash,
    double-quote and newline."""
    return (str(value).replace('\\', '\\\\').replace('"', '\\"')
            .replace('\n', '\\n'))


def _labels_str(labels, extra=()):
    items = list(labels.items()) + list(extra)
    if not items:
        return ''
    body = ','.join(f'{k}="{escape_label_value(v)}"' for k, v in items)
    return '{' + body + '}'


def _fmt(value):
    v = float(value)
    if math.isnan(v):
        return 'NaN'
    if math.isinf(v):
        return '+Inf' if v > 0 else '-Inf'
    return repr(v) if not v.is_integer() else str(int(v))


def build_info_labels():
    """The constant build-info label set (computed once per process):
    event-schema version, torch version, the CUDA version torch was
    built for (``'none'`` for a CPU build), python version — the torch
    and CUDA versions in place of the reference's ``jax_version``. A
    Prometheus merging several replicas' scrapes joins on these to
    detect version skew across the fleet; flight-recorder bundle
    MANIFESTs embed the same values (ONE probe — the scrape and the
    bundle can never disagree about the process that wrote them)."""
    global _BUILD_INFO
    if _BUILD_INFO is None:
        import platform

        import torch

        from distributed_dot_product_tpu_torch.obs import events as _events
        _BUILD_INFO = {
            'schema_version': str(_events.SCHEMA_VERSION),
            'torch_version': torch.__version__,
            'cuda_version': torch.version.cuda or 'none',
            'python_version': platform.python_version(),
        }
    return _BUILD_INFO


_BUILD_INFO = None


def render_prometheus(registry: Optional['tracing.MetricsRegistry'] = None,
                      *, namespace='ddp') -> str:
    """Render ``registry`` (default: the process registry) as Prometheus
    exposition text. Reads are snapshot-consistent per metric (each
    counter/gauge read is atomic, each histogram summary is computed
    under its own lock), so concurrent writers never produce torn
    values — only values at least as fresh as the render's start.

    Always includes the constant ``<ns>_build_info`` gauge (value 1,
    labels ``schema_version``/``torch_version``/``cuda_version``/
    ``python_version``) —
    the standard build-info idiom, so a multi-replica merge can detect
    version skew from the scrape alone."""
    registry = registry or tracing.get_registry()
    info_fam = _metric_name(namespace, 'build_info')
    lines = [
        f'# HELP {info_fam} constant build/version info '
        f'(schema_version, torch_version, cuda_version, python_version)',
        f'# TYPE {info_fam} gauge',
        f'{info_fam}{_labels_str(build_info_labels())} 1',
    ]
    # Cumulative-bucket histogram families are buffered and emitted
    # after the main body: interleaving `<fam>` summary lines and
    # `<fam>_hist` bucket lines per label set would split each family
    # into non-contiguous groups, which strict exposition parsers
    # (OpenMetrics, promtool) reject. iter_metrics() yields label sets
    # of one family adjacently, so each buffer stays grouped.
    hist_lines = []
    typed = {info_fam}

    def _head(kind, fam, comment, out=None):
        if fam not in typed:
            typed.add(fam)
            out = lines if out is None else out
            out.append(f'# HELP {fam} {comment}')
            out.append(f'# TYPE {fam} {kind}')

    for kind, name, labels, value in registry.iter_metrics():
        if kind == 'counter':
            fam = _metric_name(namespace, name) + '_total'
            _head('counter', fam, f'counter {name}')
            lines.append(f'{fam}{_labels_str(labels)} {_fmt(value)}')
        elif kind == 'gauge':
            fam = _metric_name(namespace, name)
            _head('gauge', fam, f'gauge {name}')
            lines.append(f'{fam}{_labels_str(labels)} {_fmt(value)}')
        else:   # histogram summary: value is Histogram.summary()
            fam = _metric_name(namespace, name)
            _head('summary', fam, f'histogram {name} '
                                  f'(quantiles over the aged reservoir)')
            for q, key in (('0.5', 'p50'), ('0.99', 'p99')):
                lines.append(
                    f'{fam}{_labels_str(labels, [("quantile", q)])} '
                    f'{_fmt(value[key])}')
            lines.append(f'{fam}_count{_labels_str(labels)} '
                         f'{_fmt(value["total_count"])}')
            lines.append(f'{fam}_sum{_labels_str(labels)} '
                         f'{_fmt(value["total_sum"])}')
            buckets = value.get('buckets')
            if buckets:
                # Real cumulative histogram series under a SEPARATE
                # family (`<fam>` is already TYPE summary; mixing
                # children kinds under one family is invalid
                # exposition). These are lifetime counters, so an
                # external Prometheus can sum them across replicas —
                # the aggregation the reservoir quantiles can't give.
                famh = fam + '_hist'
                _head('histogram', famh,
                      f'histogram {name} (cumulative lifetime buckets)',
                      out=hist_lines)
                for le, n in buckets:
                    hist_lines.append(
                        f'{famh}_bucket'
                        f'{_labels_str(labels, [("le", _fmt(le))])} '
                        f'{_fmt(n)}')
                hist_lines.append(
                    f'{famh}_bucket'
                    f'{_labels_str(labels, [("le", "+Inf")])} '
                    f'{_fmt(value["total_count"])}')
                hist_lines.append(f'{famh}_count{_labels_str(labels)} '
                                  f'{_fmt(value["total_count"])}')
                hist_lines.append(f'{famh}_sum{_labels_str(labels)} '
                                  f'{_fmt(value["total_sum"])}')
    lines += hist_lines
    return '\n'.join(lines) + '\n'


_HEALTHY = ('ready', 'degraded')


class _ObsHTTPServer(http.server.ThreadingHTTPServer):
    daemon_threads = True
    # Exporter endpoints hold references, not state:
    registry = None
    health = None
    profiler = None
    flight = None
    namespace = 'ddp'


class _Handler(http.server.BaseHTTPRequestHandler):
    server_version = 'ddp-obs/1'

    def _send(self, code, body, content_type):
        data = body.encode('utf-8')
        self.send_response(code)
        self.send_header('Content-Type', content_type)
        self.send_header('Content-Length', str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):     # noqa: N802 (stdlib API name)
        path = self.path.split('?', 1)[0].rstrip('/') or '/'
        if path == '/metrics':
            body = render_prometheus(self.server.registry,
                                     namespace=self.server.namespace)
            self._send(200, body,
                       'text/plain; version=0.0.4; charset=utf-8')
        elif path == '/healthz':
            health = self.server.health
            if health is None:
                self._send(200, json.dumps({'status': 'ok',
                                            'health': None}) + '\n',
                           'application/json')
                return
            snap = health.snapshot()
            ok = (snap['readiness'] in _HEALTHY
                  and snap['liveness'] == 'alive')
            self._send(200 if ok else 503,
                       json.dumps(snap, default=str) + '\n',
                       'application/json')
        elif path == '/profile':
            self._do_profile()
        elif path == '/dump':
            self._do_dump()
        else:
            self._send(404, 'not found\n', 'text/plain')

    def _do_dump(self):
        """``GET /dump[?reason=...]``: write one flight-recorder
        post-mortem bundle (obs/flight.py) on demand — the operator's
        "grab the black box NOW" button. Uses the server's explicit
        recorder, else the process-installed one; 404 when neither
        exists (the recorder is opt-in like the profiler). The dump is
        direct (not cooldown-limited): an explicit human request
        always gets a bundle."""
        from distributed_dot_product_tpu_torch.obs import flight as _flight
        rec = self.server.flight or _flight.get_recorder()
        if rec is None:
            self._send(404, json.dumps(
                {'error': 'no flight recorder installed in this '
                          'process'}) + '\n', 'application/json')
            return
        query = urllib.parse.parse_qs(
            urllib.parse.urlsplit(self.path).query)
        reason = query.get('reason', [''])[0]
        try:
            path = rec.dump_bundle(trigger='http', reason=reason)
        except Exception as e:
            # Answer 500 instead of dropping the connection, but keep
            # the failure observable (silent-except contract).
            tracing.log_exception('exporter.dump_endpoint', e,
                                  registry=self.server.registry)
            self._send(500, json.dumps(
                {'error': f'{type(e).__name__}: {e}'}) + '\n',
                'application/json')
            return
        self._send(200, json.dumps({'status': 'dumped', 'path': path})
                   + '\n', 'application/json')

    def _do_profile(self):
        """``GET /profile?seconds=N``: begin one bounded profiler
        capture (obs/devmon.py ProfileCapture). 409 while a capture is
        in flight — never two traces; 404 when the server was built
        without a profiler (the guarded-off default)."""
        from distributed_dot_product_tpu_torch.obs.devmon import CaptureInFlight
        profiler = self.server.profiler
        if profiler is None:
            self._send(404, json.dumps(
                {'error': 'no profiler configured on this server'})
                + '\n', 'application/json')
            return
        query = urllib.parse.parse_qs(
            urllib.parse.urlsplit(self.path).query)
        try:
            seconds = float(query['seconds'][0]) if 'seconds' in query \
                else None
            if seconds is not None and not seconds > 0:
                raise ValueError(seconds)
        except (ValueError, TypeError):
            self._send(400, json.dumps(
                {'error': 'seconds must be a positive number'}) + '\n',
                'application/json')
            return
        try:
            info = profiler.start(seconds, trigger='http')
        except CaptureInFlight as e:
            self._send(409, json.dumps({'error': str(e)}) + '\n',
                       'application/json')
            return
        self._send(200, json.dumps({'status': 'capturing', **info})
                   + '\n', 'application/json')

    def log_message(self, fmt, *args):
        # Probes hit /healthz every few seconds — stay silent.
        pass


class MetricsServer:
    """Background ``/metrics`` + ``/healthz`` endpoint. OFF by default:
    nothing binds a port until :meth:`start`. ``port=0`` picks an
    ephemeral port (read it back from ``.port`` — how tests avoid
    collisions)."""

    def __init__(self, registry=None, *, health=None, profiler=None,
                 flight=None, host='127.0.0.1', port=0,
                 namespace='ddp'):
        self.registry = registry or tracing.get_registry()
        self.health = health
        # Optional obs.devmon.ProfileCapture: enables the guarded
        # /profile?seconds=N endpoint (404 without one).
        self.profiler = profiler
        # Optional obs.flight.FlightRecorder for GET /dump (falls back
        # to the process-installed recorder; 404 without either).
        self.flight = flight
        self.host = host
        self.port = port
        self.namespace = namespace
        self._server: Optional[_ObsHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self):
        if self._server is not None:
            return self
        srv = _ObsHTTPServer((self.host, self.port), _Handler)
        srv.registry = self.registry
        srv.health = self.health
        srv.profiler = self.profiler
        srv.flight = self.flight
        srv.namespace = self.namespace
        self.port = srv.server_address[1]
        self._server = srv
        self._thread = threading.Thread(target=srv.serve_forever,
                                        name='obs-metrics-server',
                                        daemon=True)
        self._thread.start()
        return self

    @property
    def url(self):
        return f'http://{self.host}:{self.port}'

    def stop(self):
        if self._server is None:
            return
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._server = None
        self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
