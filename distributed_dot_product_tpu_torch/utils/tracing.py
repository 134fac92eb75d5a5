# -*- coding: utf-8 -*-
"""
Tracing and metrics of the PyTorch port, copied from
``distributed_dot_product_tpu/utils/tracing.py``: the metrics registry
(counters, gauges, bounded-reservoir histograms with lifetime bucket
counts), :func:`log_exception`, the training loop's :func:`log_step`,
and the timers :func:`measure`, :class:`timed` and :func:`time_fn`.

The timers fence the card with ``torch.cuda.synchronize()``
(:func:`hard_sync`) before they read the host clock, so they time the
work and not its enqueue; without an initialised card they time the
host. Kernel times in this repository are taken with CUDA events
(``chip_smoke.py``); these timers are the reference's debugging and
wall-clock helpers.
"""

import bisect
import collections
import functools
import os
import threading
import time

import torch

# Same env-var name as the reference package, so users flip one switch.
DEBUG_ENV_VAR = 'DISTRIBUTED_DOT_DEBUG'


def _debug_enabled():
    return bool(os.environ.get(DEBUG_ENV_VAR))


def log_exception(context, exc, registry=None):
    """Record a swallowed-but-survivable exception so fault paths stay
    observable: bumps ``exceptions_swallowed`` (total + per-context)
    in the metrics registry — a health endpoint or operator sees the
    count move even when nothing prints — and prints the exception
    under the ``DISTRIBUTED_DOT_DEBUG`` switch.

    This is the logging half of the ``silent-except`` lint contract
    (the reference's analysis/astlint.py): a broad handler must
    re-raise, narrow its type, or route through here. ``context`` is a
    short dotted site name (e.g. ``'health.on_stall_callback'``).

    When an observability event log is active (obs/events.py), the
    exception also lands there as an ``exception`` event — swallowed
    failures share the durable JSONL stream with the serve/train
    lifecycle they interrupted."""
    reg = registry if registry is not None else _DEFAULT_REGISTRY
    reg.counter('exceptions_swallowed').inc()
    reg.counter(f'exceptions_swallowed.{context}').inc()
    _emit_event('exception', context=context,
                type=type(exc).__name__, message=str(exc))
    if _debug_enabled():
        print(f'[{DEBUG_ENV_VAR}] swallowed exception in {context}: '
              f'{type(exc).__name__}: {exc}', flush=True)


def _emit_event(event, **fields):
    """Route into the active observability event log, if any. Lazy
    import: utils.tracing is imported by nearly everything, so it must
    not pull the obs package at module load."""
    from distributed_dot_product_tpu_torch.obs import events as _events
    if _events.get_active() is not None:
        _events.emit(event, **fields)


def device_peak_bytes(device=None):
    """Peak bytes allocated on the card (``torch.cuda.max_memory_allocated``),
    or None without an initialised card."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    return torch.cuda.max_memory_allocated(device)


def hard_sync(out=None):
    """Wait for the card's queued work (``torch.cuda.synchronize()``);
    nothing to wait for without an initialised card. ``out`` is accepted
    for the reference's signature: a synchronise fences every stream's
    work at once."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _shape_of(x):
    return tuple(getattr(x, 'shape', ())) or None


def measure(fn):
    """Decorator: when ``DISTRIBUTED_DOT_DEBUG`` is set, print wall time
    (the card fenced), operand shapes and the peak-memory growth of each
    call. Zero overhead when disabled."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not _debug_enabled():
            return fn(*args, **kwargs)
        hard_sync()
        peak_before = device_peak_bytes()
        start = time.perf_counter()
        result = fn(*args, **kwargs)
        hard_sync()
        elapsed = time.perf_counter() - start
        shapes = [_shape_of(a) for a in args if _shape_of(a) is not None]
        peak_after = device_peak_bytes()
        if peak_before is None or peak_after is None:
            peak_s = 'n/a'
        else:
            peak_s = f'+{(peak_after - peak_before) / 2 ** 30:.3f} GiB'
        print(f'[{DEBUG_ENV_VAR}] {fn.__name__}: {elapsed * 1000:.3f} ms'
              f' shapes={shapes} peak_mem_delta={peak_s}')
        return result

    return wrapper


def log_step(step, loss, grad_norm=None, bad=False, seconds=None,
             extra='', force=False):
    """One-line per-step training log, gated by ``DISTRIBUTED_DOT_DEBUG``
    (``force=True`` prints unconditionally — the training loop's periodic log
    cadence). Independently of the print gate, every record goes into the
    active observability event log when there is one (``train.step``,
    and ``train.bad_step`` for a bad step)."""
    _emit_event('train.step', step=int(step), loss=float(loss),
                grad_norm=(None if grad_norm is None
                           else float(grad_norm)),
                bad=bool(bad), seconds=seconds, extra=extra or None)
    if bad:
        _emit_event('train.bad_step', step=int(step), loss=float(loss))
    if not (force or _debug_enabled()):
        return
    parts = [f'step {step}: loss={loss:.6f}']
    if grad_norm is not None:
        parts.append(f'grad_norm={grad_norm:.4g}')
    if bad:
        parts.append('BAD (non-finite; update skipped)')
    if seconds is not None:
        parts.append(f'({seconds * 1000:.1f} ms)')
    if extra:
        parts.append(extra)
    print(' '.join(parts), flush=True)


class timed:
    """Context manager for block timing (host clock)::

        with timed() as t:
            out = step(x)
        print(t.seconds)
    """

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._start
        return False


def _timed_sync(out):
    t0 = time.perf_counter()
    hard_sync(out)
    return time.perf_counter() - t0


def time_fn(fn, *args, iters=5, warmup=2, inner=None, max_inner=512,
            **kwargs):
    """Wall-clock time of ``fn(*args)`` with the card fenced: returns
    ``(best_seconds, mean_seconds)`` per call. Each sample queues
    ``inner`` calls, synchronises once and subtracts the measured cost
    of a synchronise; ``inner=None`` scales it so the window dominates
    that cost."""
    out = fn(*args, **kwargs)
    hard_sync(out)
    for _ in range(max(warmup - 1, 0)):
        out = fn(*args, **kwargs)
    hard_sync(out)
    overhead = min(_timed_sync(out) for _ in range(3))
    if inner is None:
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        hard_sync(out)
        est = max(time.perf_counter() - t0 - overhead, 1e-5)
        inner = max(1, min(max_inner, int(8 * overhead / est)))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        for _ in range(inner):
            out = fn(*args, **kwargs)
        hard_sync(out)
        dt = time.perf_counter() - t0 - overhead
        times.append(max(dt, 1e-9) / inner)
    return min(times), sum(times) / len(times)


# ---------------------------------------------------------------------------
# Lightweight metrics registry (serving observability)
#
# The serving scheduler (serve/scheduler.py) needs queue depth, admissions,
# rejections-by-reason, evictions and step-latency percentiles exported
# somewhere a health endpoint / operator can read them. No external metrics
# dependency is available in the image, so this is the minimal honest core:
# monotonic counters, last-value gauges, and a bounded-reservoir histogram
# with nearest-rank percentiles. Thread-safe (the watchdog thread reads
# while the scheduler loop writes).
# ---------------------------------------------------------------------------


class Counter:
    """Monotonic event counter."""

    def __init__(self):
        self._value = 0         # guarded-by: self._lock
        self._lock = threading.Lock()

    def inc(self, n=1):
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge:
    """Last-value gauge (queue depth, active slots, readiness code)."""

    def __init__(self):
        self._value = 0.0       # guarded-by: self._lock
        self._lock = threading.Lock()

    def set(self, value):
        with self._lock:
            self._value = float(value)

    @property
    def value(self):
        with self._lock:
            return self._value


# Default cumulative-bucket bounds (seconds): spans the sub-ms decode
# dispatch floor through multi-second compile phases. A Prometheus
# scraping several replicas can SUM _bucket series across them — the
# one aggregation the reservoir quantiles cannot support.
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


class Histogram:
    """Bounded reservoir of the most recent ``maxlen`` observations with
    nearest-rank percentiles — enough for honest p50/p99 step latency
    without an external metrics stack. Older observations age out, so
    the percentiles track CURRENT behavior (what a readiness probe
    wants), not the run's whole history.

    Independently, LIFETIME cumulative bucket counts are kept over
    ``buckets`` (upper bounds, ``le`` semantics; default
    :data:`DEFAULT_BUCKETS`, ``()`` disables) — these never age out,
    which is what lets an external Prometheus aggregate histograms
    across replicas (sum of cumulative counters is meaningful; merged
    reservoir quantiles are not)."""

    def __init__(self, maxlen=4096, buckets=DEFAULT_BUCKETS):
        self._values = collections.deque(maxlen=maxlen)  # guarded-by: self._lock
        self._count = 0         # guarded-by: self._lock
        self._sum = 0.0         # guarded-by: self._lock
        # _bounds is immutable after construction — reads need no lock.
        self._bounds = (tuple(sorted({float(b) for b in buckets}))
                        if buckets else ())
        self._bucket_counts = [0] * len(self._bounds)  # guarded-by: self._lock
        self._lock = threading.Lock()

    def observe(self, value):
        with self._lock:
            v = float(value)
            self._values.append(v)
            self._count += 1
            self._sum += v
            if self._bounds:
                i = bisect.bisect_left(self._bounds, v)
                if i < len(self._bounds):
                    self._bucket_counts[i] += 1

    @property
    def bucket_bounds(self):
        return self._bounds

    def _cumulative(self, counts):
        """Per-bucket counts → cumulative ``[(le, count), ...]`` (the
        ONE place the le accumulation rule lives — buckets() and
        summary() both render through it)."""
        out, cum = [], 0
        for le, c in zip(self._bounds, counts):
            cum += c
            out.append((le, cum))
        return out

    def buckets(self):
        """Cumulative ``[(le, count), ...]`` over the lifetime counts
        (ascending bounds; observations above the last bound appear
        only in ``total_count`` — the exporter's ``+Inf`` line)."""
        with self._lock:
            counts = list(self._bucket_counts)
        return self._cumulative(counts)

    @property
    def count(self):
        with self._lock:
            return self._count

    def percentile(self, p):
        """Nearest-rank percentile over the reservoir (NaN when empty)."""
        with self._lock:
            vals = sorted(self._values)
        if not vals:
            return float('nan')
        idx = min(len(vals) - 1, max(0, int(round(
            (p / 100.0) * (len(vals) - 1)))))
        return vals[idx]

    @property
    def total_count(self):
        """Lifetime observation count (never ages out)."""
        with self._lock:
            return self._count

    @property
    def total_sum(self):
        """Lifetime observation sum (never ages out)."""
        with self._lock:
            return self._sum

    def summary(self):
        """Reservoir-local ``count``/``mean``/``p50``/``p99``/``max``
        — ALL five describe the same aged window, so they are mutually
        consistent (a lifetime mean next to reservoir percentiles would
        describe two different distributions once anything has aged
        out) — plus the lifetime ``total_count``/``total_sum`` the
        Prometheus exporter needs for its cumulative _count/_sum
        series. Histograms with bucket bounds additionally carry
        ``'buckets'`` (the cumulative lifetime counts) for the
        exporter's real ``_bucket{le=...}`` lines."""
        with self._lock:
            vals = sorted(self._values)
            count, total = self._count, self._sum
            # Bucket counts read in the SAME locked snapshot as
            # total_count: a cumulative bucket exceeding the +Inf line
            # (rendered from total_count) is corrupt data to a
            # Prometheus consumer.
            bucket_counts = list(self._bucket_counts)
        buckets = ({'buckets': [[le, n] for le, n
                                in self._cumulative(bucket_counts)]}
                   if self._bounds else {})
        if not vals:
            return {'count': 0, 'mean': float('nan'),
                    'p50': float('nan'), 'p99': float('nan'),
                    'max': float('nan'),
                    'total_count': count, 'total_sum': total, **buckets}

        def _pct(p):
            return vals[min(len(vals) - 1,
                            max(0, int(round((p / 100.0)
                                             * (len(vals) - 1)))))]

        return {'count': len(vals), 'mean': sum(vals) / len(vals),
                'p50': _pct(50), 'p99': _pct(99), 'max': vals[-1],
                'total_count': count, 'total_sum': total, **buckets}


def _metric_key(name, labels):
    """Internal storage key: the bare name, or ``(name, ((k, v), ...))``
    with sorted stringified label pairs for labeled metrics."""
    if not labels:
        return name
    return (name, tuple(sorted((str(k), str(v))
                               for k, v in labels.items())))


def _flat_name(key):
    """Display/JSON form of a storage key: ``name`` or
    ``name{k=v,...}``."""
    if isinstance(key, str):
        return key
    name, items = key
    return name + '{' + ','.join(f'{k}={v}' for k, v in items) + '}'


class MetricsRegistry:
    """Named metric store with one-call :meth:`snapshot`. Get-or-create
    accessors, so call sites never coordinate registration order.

    ``labels`` (optional dict on every accessor) keys a separate series
    per label set under one family name — the Prometheus exporter
    (obs/exporter.py) renders them as real labels with value escaping;
    :meth:`snapshot` flattens them to ``name{k=v,...}`` strings."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters = {}     # guarded-by: self._lock
        self._gauges = {}       # guarded-by: self._lock
        self._histograms = {}   # guarded-by: self._lock

    def counter(self, name, labels=None) -> Counter:
        with self._lock:
            return self._counters.setdefault(
                _metric_key(name, labels), Counter())

    def gauge(self, name, labels=None) -> Gauge:
        with self._lock:
            return self._gauges.setdefault(
                _metric_key(name, labels), Gauge())

    def histogram(self, name, maxlen=4096, labels=None,
                  buckets=None) -> Histogram:
        """``buckets``: cumulative-bucket upper bounds for this series
        (None → :data:`DEFAULT_BUCKETS`, ``()`` disables). Get-or-create
        semantics: the first registration's bounds win."""
        with self._lock:
            key = _metric_key(name, labels)
            h = self._histograms.get(key)
            if h is None:
                h = self._histograms[key] = Histogram(
                    maxlen,
                    buckets=DEFAULT_BUCKETS if buckets is None
                    else buckets)
            return h

    def peek(self, kind, name, labels=None):
        """The EXISTING metric of ``kind`` (``'counter'``/``'gauge'``/
        ``'histogram'``) under ``name``/``labels``, or None — read-only
        probing that never creates a series. The anomaly watchdog
        (obs/anomaly.py) polls metric streams other layers may not have
        created yet; the get-or-create accessors would materialize an
        empty series and teach its detectors a phantom zero."""
        with self._lock:
            table = {'counter': self._counters, 'gauge': self._gauges,
                     'histogram': self._histograms}[kind]
            return table.get(_metric_key(name, labels))

    def iter_metrics(self):
        """Structured iteration for exporters: yields ``(kind, name,
        labels_dict, value)`` with ``value`` the counter/gauge value or
        the histogram :meth:`~Histogram.summary` dict. Metric names are
        iterated from a snapshot of the key tables; each value read is
        atomic (counters/gauges) or lock-consistent (histograms), so a
        concurrent writer can never produce a torn read."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        for table, kind in ((counters, 'counter'), (gauges, 'gauge'),
                            (histograms, 'histogram')):
            for key in sorted(table, key=_flat_name):
                name = key if isinstance(key, str) else key[0]
                labels = {} if isinstance(key, str) else dict(key[1])
                value = (table[key].summary() if kind == 'histogram'
                         else table[key].value)
                yield kind, name, labels, value

    def snapshot(self):
        """Plain-dict view: ``{'counters': {name: int}, 'gauges':
        {name: float}, 'histograms': {name: {count, mean, p50, p99,
        max, total_count, total_sum}}}`` — JSON-serializable, safe to
        hand to a health endpoint. Labeled series flatten to
        ``name{k=v,...}`` keys."""
        out = {'counters': {}, 'gauges': {}, 'histograms': {}}
        for kind, name, labels, value in self.iter_metrics():
            key = _flat_name(_metric_key(name, labels))
            out[kind + 's'][key] = value
        return out

    def reset(self):
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


_DEFAULT_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-default registry (the serving layer's default sink)."""
    return _DEFAULT_REGISTRY


def metrics():
    """Snapshot of the process-default registry."""
    return _DEFAULT_REGISTRY.snapshot()
