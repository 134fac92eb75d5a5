# -*- coding: utf-8 -*-
"""
Watchdog and health surface for the decode serving loop.

A compiled decode step that hangs (wedged runtime, pathological retrace,
dead interconnect) blocks the scheduler thread on the device — the loop
itself can't report that it's stuck. So liveness is judged from OUTSIDE
the loop: the scheduler heartbeats (:meth:`HealthMonitor.beat`) every
tick, and a daemon watchdog thread flips liveness to STALLED when the
last beat ages past ``stall_timeout``. The serving layer's contract:

- **Liveness** (is the loop making progress): ``ALIVE`` ↔ ``STALLED``.
  A stall marks readiness NOT_READY (drain traffic away) and counts a
  ``serve.watchdog_stalls`` event; the NEXT beat recovers liveness and
  the scheduler's own readiness logic re-asserts READY — the soak test
  pins "readiness restored after the stall clears".
- **Readiness** (should a load balancer send traffic): ``STARTING →
  READY`` with ``DEGRADED`` (pressure-capped admissions) and
  ``NOT_READY`` (queue full / stalled) excursions, ``STOPPED`` at
  close. Set by the scheduler; the watchdog only forces NOT_READY.
- Every transition is recorded (state, reason, timestamp) and mirrored
  to gauges in the :mod:`~distributed_dot_product_tpu_torch.utils.tracing`
  registry, next to the scheduler's queue-depth and step-latency
  metrics — one snapshot serves a health endpoint.

The watchdog measures REAL time (``time.monotonic``) independently of
the scheduler's injectable clock: a virtual-clock test must not
self-trigger stalls, and a real stall must fire even when the
scheduler's clock is frozen.

Copied from ``distributed_dot_product_tpu/serve/health.py``.
"""

import enum
import threading
import time
from typing import Callable, List, Optional, Tuple

from distributed_dot_product_tpu_torch.obs import events as obs_events
from distributed_dot_product_tpu_torch.utils import tracing

__all__ = ['Liveness', 'Readiness', 'HealthMonitor']


class Liveness(enum.Enum):
    ALIVE = 'alive'
    STALLED = 'stalled'


class Readiness(enum.Enum):
    STARTING = 'starting'
    READY = 'ready'
    DEGRADED = 'degraded'
    NOT_READY = 'not_ready'
    STOPPED = 'stopped'


_READINESS_CODE = {Readiness.STARTING: 0, Readiness.READY: 1,
                   Readiness.DEGRADED: 2, Readiness.NOT_READY: 3,
                   Readiness.STOPPED: 4}


class HealthMonitor:
    """Heartbeat-driven liveness + scheduler-driven readiness.

    Use::

        mon = HealthMonitor(stall_timeout=0.5)
        mon.start()                  # spawns the watchdog daemon thread
        ...
        mon.beat()                   # scheduler, every tick
        mon.set_readiness(Readiness.READY)
        ...
        mon.stop()

    ``on_stall`` (optional) is called from the watchdog thread when a
    stall is detected — keep it cheap and thread-safe.
    """

    def __init__(self, *, stall_timeout=2.0, poll_interval=None,
                 registry: Optional[tracing.MetricsRegistry] = None,
                 on_stall: Optional[Callable] = None, event_log=None):
        if stall_timeout <= 0:
            raise ValueError(f'stall_timeout must be > 0, '
                             f'got {stall_timeout}')
        self.stall_timeout = stall_timeout
        self.poll_interval = poll_interval or min(0.05, stall_timeout / 4)
        self.registry = registry or tracing.get_registry()
        self.on_stall = on_stall
        self.event_log = event_log
        self._lock = threading.Lock()
        self._last_beat: Optional[float] = None  # guarded-by: self._lock
        self._liveness = Liveness.ALIVE          # guarded-by: self._lock
        self._readiness = Readiness.STARTING     # guarded-by: self._lock
        self._transitions: List[Tuple[float, str, str, str]] = []  # guarded-by: self._lock
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._c_stalls = self.registry.counter('serve.watchdog_stalls')
        self._c_recovered = self.registry.counter(
            'serve.watchdog_recoveries')
        self._g_ready = self.registry.gauge('serve.readiness')
        self._g_live = self.registry.gauge('serve.liveness')
        self._g_live.set(1)

    # -- lifecycle ------------------------------------------------------
    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._watch,
                                        name='serve-watchdog',
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5 * self.poll_interval + 1.0)
            self._thread = None
        self.set_readiness(Readiness.STOPPED, 'monitor stopped')

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def _emit(self, event, **fields):
        """Transition → the explicit event log, else the active one.
        NEVER called while holding ``self._lock`` (the log does I/O)."""
        log = (self.event_log if self.event_log is not None
               else obs_events.get_active())
        if log is not None:
            log.emit(event, **fields)

    # -- heartbeat / state ---------------------------------------------
    def beat(self):
        """Scheduler tick heartbeat. Recovers liveness after a stall —
        readiness stays NOT_READY until the scheduler re-asserts it
        (the next readiness update), so recovery is an explicit
        transition, not a silent flag flip."""
        recovered = False
        with self._lock:
            self._last_beat = time.monotonic()
            if self._liveness is Liveness.STALLED:
                self._liveness = Liveness.ALIVE
                self._g_live.set(1)
                self._c_recovered.inc()
                self._transitions.append(
                    (self._last_beat, 'liveness', Liveness.ALIVE.value,
                     'heartbeat resumed'))
                recovered = True
        if recovered:
            self._emit('health.liveness', state=Liveness.ALIVE.value,
                       reason='heartbeat resumed')

    def set_readiness(self, state: Readiness, reason=''):
        with self._lock:
            if state is self._readiness:
                return
            self._readiness = state
            self._g_ready.set(_READINESS_CODE[state])
            self._transitions.append(
                (time.monotonic(), 'readiness', state.value, reason))
        self._emit('health.readiness', state=state.value, reason=reason)

    @property
    def liveness(self) -> Liveness:
        with self._lock:
            return self._liveness

    @property
    def readiness(self) -> Readiness:
        with self._lock:
            return self._readiness

    @property
    def transitions(self):
        """``[(monotonic_time, 'liveness'|'readiness', value, reason)]``
        — the audit trail the health tests assert on."""
        with self._lock:
            return list(self._transitions)

    @property
    def stall_events(self):
        return self._c_stalls.value

    def last_beat_age(self):
        with self._lock:
            if self._last_beat is None:
                return None
            return time.monotonic() - self._last_beat

    def snapshot(self):
        """One JSON-able dict for a health endpoint: liveness,
        readiness, beat age, stall counters, and the full metrics
        registry snapshot (queue depth, step latency, ...)."""
        age = self.last_beat_age()
        with self._lock:
            live, ready = self._liveness, self._readiness
            n_trans = len(self._transitions)
        return {
            'liveness': live.value,
            'readiness': ready.value,
            'last_beat_age_s': age,
            'stall_events': self._c_stalls.value,
            'stall_recoveries': self._c_recovered.value,
            'transitions': n_trans,
            'metrics': self.registry.snapshot(),
        }

    # -- watchdog thread ------------------------------------------------
    def _watch(self):
        while not self._stop.wait(self.poll_interval):
            with self._lock:
                beat = self._last_beat
                live = self._liveness
            if beat is None or live is Liveness.STALLED:
                continue
            age = time.monotonic() - beat
            if age <= self.stall_timeout:
                continue
            with self._lock:
                # Re-check under the lock: a beat may have landed.
                if self._last_beat is None or \
                        time.monotonic() - self._last_beat \
                        <= self.stall_timeout:
                    continue
                self._liveness = Liveness.STALLED
                self._g_live.set(0)
                self._c_stalls.inc()
                self._transitions.append(
                    (time.monotonic(), 'liveness', Liveness.STALLED.value,
                     f'no heartbeat for {age:.2f}s '
                     f'(timeout {self.stall_timeout:.2f}s)'))
            self._emit('health.liveness', state=Liveness.STALLED.value,
                       reason=f'no heartbeat for {age:.2f}s')
            self.set_readiness(Readiness.NOT_READY, 'watchdog stall')
            if self.on_stall is not None:
                try:
                    self.on_stall()
                except Exception as e:
                    # A broken callback must not kill the watchdog —
                    # but its failure has to stay observable.
                    tracing.log_exception('health.on_stall_callback', e,
                                          registry=self.registry)
