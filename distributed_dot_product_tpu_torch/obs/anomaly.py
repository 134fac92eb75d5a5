# -*- coding: utf-8 -*-
"""
Online anomaly detection over the metric streams the serving loop
already emits — the generalization of the perf observatory's one
hard-coded TTFT-p99 profile trigger into a pluggable watchdog.

Three detector families, each a tiny online algorithm over ONE scalar
stream (no history buffers beyond O(1) state):

- :class:`StaticThreshold` — breach when the value crosses a fixed
  ``above``/``below`` bound (page-pool exhaustion, queue-full).
- :class:`EwmaZScore` — exponentially-weighted mean/variance; breach
  when the standardized residual exceeds ``z`` sigmas after a warmup
  (latency regressions, throughput collapses — no tuning per service).
- :class:`RateOfChange` — breach when one update moves more than
  ``max_delta`` (absolute) or ``max_ratio`` × the previous value
  (cliff detection on gauges that should move smoothly).

A :class:`Watch` binds a detector to a registry stream (gauge value,
histogram percentile, counter rate, or a custom ``fn``) with a
per-watch real-time cooldown and an ``actions`` tuple naming what a
breach chains: ``'profile'`` begins one bounded capture on the
watchdog's ``profiler`` (an ``obs/devmon.py``
:class:`~distributed_dot_product_tpu_torch.obs.devmon.ProfileCapture`) —
the regression gets profiled WHILE it happens — and ``'dump'`` writes a
flight post-mortem bundle (obs/flight.py). Every breach emits a
closed-vocabulary ``anomaly.detected`` event into the event log, so
``obs doctor`` sees the detector's verdict next to the lifecycle it
judged.

:class:`AnomalyWatchdog` evaluates its watch list from the scheduler's
tick (throttled to ``min_interval`` REAL seconds — between evaluations
a tick costs one clock read), or from any caller's own cadence.
:func:`default_watches` is the stock catalog: TTFT p99, tokens/s,
queue depth, ``serve.cache.pages_free``, reject rate.

Copied from ``distributed_dot_product_tpu/obs/anomaly.py``: the same
series give the same verdicts.
"""

import dataclasses
import math
import time
from typing import Callable, Optional, Sequence, Tuple

from distributed_dot_product_tpu_torch.obs import events as obs_events
from distributed_dot_product_tpu_torch.obs import flight as obs_flight
from distributed_dot_product_tpu_torch.utils import tracing

__all__ = ['Detector', 'StaticThreshold', 'EwmaZScore', 'RateOfChange',
           'Watch', 'AnomalyWatchdog', 'default_watches']


class Detector:
    """One online detector over one scalar stream. :meth:`update`
    consumes the next observation and returns None (in spec) or a
    JSON-able dict describing the breach (stamped onto the
    ``anomaly.detected`` event)."""

    def update(self, value) -> Optional[dict]:
        raise NotImplementedError

    def reset(self):
        """Forget learned state (a quarantine/requeue storm ends; the
        operator wants fresh baselines, not poisoned ones)."""


class StaticThreshold(Detector):
    """Breach when ``value > above`` or ``value < below``."""

    def __init__(self, *, above=None, below=None):
        if above is None and below is None:
            raise ValueError('StaticThreshold needs above= or below=')
        self.above = above
        self.below = below

    def update(self, value):
        if self.above is not None and value > self.above:
            return {'kind': 'above', 'threshold': self.above}
        if self.below is not None and value < self.below:
            return {'kind': 'below', 'threshold': self.below}
        return None


class EwmaZScore(Detector):
    """Exponentially-weighted mean/variance z-score.

    The first ``min_samples`` observations only TRAIN the baseline
    (every stream starts cold — flagging the first request's TTFT
    against an empty history would alert on every startup). After
    warmup, an observation more than ``z`` sigmas from the EWMA mean
    breaches; breaching observations still update the baseline (with
    weight ``alpha``), so a sustained level shift re-baselines instead
    of alerting forever. Two sigma floors keep a near-constant stream
    honest — ``min_sigma`` absolute and ``rel_floor`` as a fraction of
    the mean — so variance ~0 must not turn the first harmless jitter
    into an astronomical z."""

    def __init__(self, *, z=4.0, alpha=0.2, min_samples=16,
                 min_sigma=1e-9, rel_floor=0.05):
        self.z = float(z)
        self.alpha = float(alpha)
        self.min_samples = int(min_samples)
        self.min_sigma = float(min_sigma)
        self.rel_floor = float(rel_floor)
        self.reset()

    def reset(self):
        self._n = 0
        self._mean = 0.0
        self._var = 0.0

    def update(self, value):
        v = float(value)
        verdict = None
        if self._n >= self.min_samples:
            sigma = max(math.sqrt(self._var), self.min_sigma,
                        abs(self._mean) * self.rel_floor)
            score = (v - self._mean) / sigma
            if abs(score) > self.z:
                verdict = {'kind': 'zscore', 'z': score,
                           'mean': self._mean, 'sigma': sigma,
                           'threshold': self.z}
        # Welford-flavored EWMA update (West 1979): one pass, O(1).
        a = self.alpha if self._n else 1.0
        delta = v - self._mean
        self._mean += a * delta
        self._var = (1.0 - a) * (self._var + a * delta * delta)
        self._n += 1
        return verdict


class RateOfChange(Detector):
    """Breach when one observation moves more than ``max_delta``
    (absolute) or ``max_ratio`` times the previous magnitude from the
    last one — cliffs on streams that should move smoothly
    (pages_free collapsing within one tick)."""

    def __init__(self, *, max_delta=None, max_ratio=None):
        if max_delta is None and max_ratio is None:
            raise ValueError('RateOfChange needs max_delta= or '
                             'max_ratio=')
        self.max_delta = max_delta
        self.max_ratio = max_ratio
        self.reset()

    def reset(self):
        self._prev = None

    def update(self, value):
        v = float(value)
        prev, self._prev = self._prev, v
        if prev is None:
            return None
        delta = v - prev
        if self.max_delta is not None and abs(delta) > self.max_delta:
            return {'kind': 'delta', 'delta': delta, 'previous': prev,
                    'threshold': self.max_delta}
        if self.max_ratio is not None and abs(prev) > 0 \
                and abs(delta) > self.max_ratio * abs(prev):
            return {'kind': 'ratio', 'delta': delta, 'previous': prev,
                    'threshold': self.max_ratio}
        return None


@dataclasses.dataclass
class Watch:
    """One watched stream. ``signal`` selects how ``metric`` is read
    from the registry: ``'gauge'``/``'counter'`` read the value,
    ``'p50'``/``'p99'`` a histogram's reservoir percentile, ``'fn'``
    calls ``fn(registry)``. ``rate=True`` differentiates the read
    value against real time (counters → per-second rates). A stream
    with no series yet (or a NaN read) is skipped — absence of traffic
    is not an anomaly. ``actions``: any of ``'profile'``/``'dump'``,
    fired on breach when the watchdog holds a profiler / a flight
    recorder is installed. ``cooldown`` is the per-watch re-alert
    floor (REAL seconds)."""
    name: str
    metric: str
    detector: Detector
    signal: str = 'gauge'
    fn: Optional[Callable] = None
    rate: bool = False
    cooldown: float = 30.0
    actions: Tuple[str, ...] = ()
    # runtime state (not config)
    _last_breach: Optional[float] = dataclasses.field(
        default=None, repr=False, compare=False)
    _rate_anchor: Optional[tuple] = dataclasses.field(
        default=None, repr=False, compare=False)
    _last_fed: Optional[float] = dataclasses.field(
        default=None, repr=False, compare=False)

    def read(self, registry, now):
        """Current observation, or None (no series / empty / first
        rate sample)."""
        if self.signal == 'fn':
            value = self.fn(registry)
        elif self.signal in ('gauge', 'counter'):
            m = registry.peek(self.signal, self.metric)
            value = None if m is None else m.value
        elif self.signal in ('p50', 'p99'):
            h = registry.peek('histogram', self.metric)
            value = None if h is None else h.percentile(
                50 if self.signal == 'p50' else 99)
        else:
            raise ValueError(f'unknown signal {self.signal!r}')
        if value is None or (isinstance(value, float)
                             and math.isnan(value)):
            return None
        if not self.rate:
            return float(value)
        anchor, self._rate_anchor = self._rate_anchor, (now, value)
        if anchor is None or now <= anchor[0]:
            return None
        return (value - anchor[1]) / (now - anchor[0])


class AnomalyWatchdog:
    """Evaluate a watch list against ``registry`` (see module
    docstring). ``profiler`` (optional
    :class:`~distributed_dot_product_tpu_torch.obs.devmon.ProfileCapture`)
    serves the ``'profile'`` action; the ``'dump'`` action resolves
    the process flight recorder at breach time. ``event_log``: the
    explicit sink, else the active log (the events idiom)."""

    def __init__(self, registry=None, watches: Sequence[Watch] = (),
                 *, profiler=None, event_log=None, min_interval=0.25,
                 profile_seconds=2.0, clock=None):
        self.registry = registry or tracing.get_registry()
        self.watches = list(watches)
        self.profiler = profiler
        self.event_log = event_log
        self.min_interval = float(min_interval)
        self.profile_seconds = float(profile_seconds)
        # ``clock`` times the tick throttle, the per-watch breach
        # cooldowns and the rate differentiation. Default REAL time
        # (the live-serving contract this module documents); the
        # closed-loop controller (serve/control.py) injects the
        # scheduler's virtual clock so a seeded load run's breach
        # sequence — and therefore its control history — replays
        # bit-identically.
        self.clock = clock or time.monotonic
        self._last_tick = None
        self.breaches = []      # [(watch name, verdict dict)]
        self._c_breach = self.registry.counter('anomaly.breaches')

    def tick(self, force=False):
        """Evaluate every watch once, throttled to ``min_interval``
        seconds on the watchdog's clock (REAL by default) unless
        ``force``. Returns the breaches fired this evaluation as
        ``[(watch, verdict), ...]``."""
        now = self.clock()
        if not force and self._last_tick is not None \
                and now - self._last_tick < self.min_interval:
            return []
        self._last_tick = now
        fired = []
        for watch in self.watches:
            try:
                value = watch.read(self.registry, now)
            except Exception as e:
                tracing.log_exception('anomaly.read', e,
                                      registry=self.registry)
                continue
            if value is None:
                continue
            # A non-rate reading identical to the last one fed carries
            # NO new information (a histogram p99 is constant between
            # admissions; the tick cadence outruns the stream): feeding
            # it anyway would collapse an EWMA detector's variance
            # toward zero and turn the next real observation's tiny
            # jitter into an astronomical z — a false breach on a
            # healthy service. Rates are fresh per interval by
            # construction and always feed.
            if not watch.rate and value == watch._last_fed:
                continue
            watch._last_fed = value
            verdict = watch.detector.update(value)
            if verdict is None:
                continue
            if watch._last_breach is not None \
                    and now - watch._last_breach < watch.cooldown:
                continue
            watch._last_breach = now
            self._breach(watch, value, verdict)
            fired.append((watch, verdict))
        return fired

    def _breach(self, watch: Watch, value, verdict):
        self._c_breach.inc()
        self.registry.counter('anomaly.breaches.' + watch.name).inc()
        self.breaches.append((watch.name, dict(verdict, value=value)))
        obs_events.emit('anomaly.detected', _log=self.event_log,
                        metric=watch.metric,
                        detector=type(watch.detector).__name__,
                        value=value, watch=watch.name, **verdict)
        if 'profile' in watch.actions and self.profiler is not None:
            try:
                self.profiler.start(
                    self.profile_seconds,
                    trigger=f'anomaly.{watch.name}',
                    event_log=self.event_log, value=value)
            except Exception as e:
                # CaptureInFlight included: contention, never a crash.
                tracing.log_exception('anomaly.profile', e,
                                      registry=self.registry)
        if 'dump' in watch.actions:
            try:
                obs_flight.recorder().maybe_dump(
                    trigger='anomaly',
                    reason=f'{watch.name}: {verdict}')
            except Exception as e:
                tracing.log_exception('anomaly.dump', e,
                                      registry=self.registry)


def _reject_total(registry):
    """Sum of the typed per-reason reject counters (lazy import — obs
    must not pull the serve package at module load)."""
    from distributed_dot_product_tpu_torch.serve.admission import RejectReason
    total = 0
    for reason in RejectReason:
        c = registry.peek('counter', f'serve.rejected.{reason.value}')
        if c is not None:
            total += c.value
    return float(total)


def default_watches(*, queue_limit=None, paged=False,
                    ttft_z=4.0, cooldown=30.0) -> list:
    """The stock serving catalog (every stream already emitted by the
    scheduler/admission layers — arming the watchdog adds no new
    instrumentation):

    - ``ttft_p99``: EWMA z-score on the ``serve.ttft_seconds``
      reservoir p99 (chains a profile capture + a flight dump — the
      generalization of the old one-off scheduler trigger).
    - ``tokens_per_s``: EWMA z-score on the
      ``serve.tokens_generated`` rate (throughput collapse).
    - ``queue_depth``: static threshold at 90% of ``queue_limit``
      when given, else EWMA (overload).
    - ``pages_free`` (paged engines): static threshold below 1 —
      pool exhaustion (chains a flight dump).
    - ``reject_rate``: EWMA z-score on the summed typed-reject rate.
    - ``kv_corrupt``: static threshold on the router's corruption
      counter — ANY checksum-failed page chains a flight dump (the
      post-mortem bundle is how the doctor attributes the verdict).
    - ``dispatch_overhead_p99``: EWMA z-score on the
      ``serve.dispatch_overhead_seconds`` reservoir p99 — a
      dispatch-floor regression (host loop suddenly eating more of
      each decode tick) auto-captures a flight bundle carrying the
      critpath summary that names where the time went.
    """
    watches = [
        Watch(name='ttft_p99', metric='serve.ttft_seconds',
              signal='p99', detector=EwmaZScore(z=ttft_z),
              cooldown=cooldown, actions=('profile', 'dump')),
        Watch(name='tokens_per_s', metric='serve.tokens_generated',
              signal='counter', rate=True,
              detector=EwmaZScore(z=ttft_z), cooldown=cooldown),
        Watch(name='queue_depth', metric='serve.queue_depth',
              signal='gauge',
              detector=(StaticThreshold(above=0.9 * queue_limit)
                        if queue_limit else EwmaZScore(z=ttft_z)),
              cooldown=cooldown),
        Watch(name='reject_rate', metric='serve.rejected',
              signal='fn', fn=_reject_total, rate=True,
              detector=EwmaZScore(z=ttft_z), cooldown=cooldown),
        Watch(name='kv_corrupt', metric='router.kv_corrupt',
              signal='counter', detector=StaticThreshold(above=0),
              cooldown=cooldown, actions=('dump',)),
        Watch(name='dispatch_overhead_p99',
              metric='serve.dispatch_overhead_seconds', signal='p99',
              detector=EwmaZScore(z=ttft_z), cooldown=cooldown,
              actions=('dump',)),
    ]
    if paged:
        watches.append(
            Watch(name='pages_free', metric='serve.cache.pages_free',
                  signal='gauge', detector=StaticThreshold(below=1),
                  cooldown=cooldown, actions=('dump',)))
    return watches
