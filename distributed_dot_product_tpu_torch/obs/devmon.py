# -*- coding: utf-8 -*-
"""
Live device telemetry and on-demand profiler capture — the runtime half
of the perf observatory (``obs/perf.py`` is the static, program half).
Copied from ``distributed_dot_product_tpu/obs/devmon.py``.

Two pieces:

- :class:`DeviceMonitor` polls every visible card's memory counters
  (:class:`CudaDevice`: ``torch.cuda.memory_stats`` and
  ``torch.cuda.mem_get_info``) into labeled gauges under the reference's
  names (``device.memory.bytes_in_use{device="cuda:0"}`` …) on a
  background thread, so the ``/metrics`` endpoint answers "how full is
  each card RIGHT NOW" without any run touching the devices itself.
  Without a card the visible device is the CPU, which has no stats: the
  monitor reports no gauges, and ``device.memory.devices_reporting`` says
  how many devices answered (0), as the reference does for a backend
  without stats.
- :class:`ProfileCapture` owns bounded on-demand ``torch.profiler``
  captures (CPU and CUDA activities): one at a time (a second request
  while one is in flight raises :class:`CaptureInFlight` — the
  ``/profile`` endpoint maps it to HTTP 409), each clamped to
  ``max_seconds``, each recorded as a ``profile.capture`` event, each a
  Chrome trace ``trace.json`` under ``base_dir/trace-<n>``. The spans
  layer wraps every serve / train phase in a
  ``torch.profiler.record_function`` scope, so the trace shows those
  names beside the kernels.

A capture is started and stopped on a worker thread, as in the
reference. ``torch.profiler`` records CPU ops per thread unless told
otherwise, so the capture profiles every thread
(``_ExperimentalConfig(profile_all_threads=True)``): the serving
thread's spans and launches land in the trace, and CUPTI's kernel
records are process-wide. The profiler's first start in a process is
slow, and made on a worker thread it records nothing (the profiler
registers its client on the thread of that first start):
:meth:`ProfileCapture.warmup` pays it on the calling thread, and
:meth:`ProfileCapture.start` warms up first when no capture has.

The serving scheduler uses :class:`ProfileCapture` for its adaptive
trigger: when the ``serve.ttft`` p99 crosses a configured threshold it
captures one trace (with a cooldown) — the profile of a latency
regression gets taken WHILE it is happening, not re-created later.
"""

import os
import threading
import time
from typing import Optional

from distributed_dot_product_tpu_torch.utils import tracing

__all__ = ['DeviceMonitor', 'CudaDevice', 'visible_devices',
           'device_stats_snapshot', 'ProfileCapture', 'CaptureInFlight']

# The Chrome trace a capture writes into its directory.
TRACE_FILE = 'trace.json'

# memory_stats() keys worth exporting, when present (the reference's
# names; CudaDevice maps torch's counters onto them).
_STAT_KEYS = ('bytes_in_use', 'peak_bytes_in_use', 'bytes_limit',
              'largest_free_block_bytes', 'bytes_reserved',
              'num_allocs')


class CudaDevice:
    """One card as the monitor sees it: ``platform``/``id`` name its
    gauge label (``cuda:N``), ``memory_stats()`` gives the reference's
    keys from the caching allocator's counters — ``bytes_in_use`` and
    ``peak_bytes_in_use`` (``allocated_bytes.all.current`` / ``.peak``),
    ``bytes_reserved`` (``reserved_bytes.all.current``), ``num_allocs``
    (``allocation.all.allocated``) — and ``bytes_limit``, the card's
    total memory from ``mem_get_info``. The allocator keeps no largest
    free block, so that key is not reported."""
    platform = 'cuda'

    def __init__(self, index):
        self.id = int(index)

    @property
    def device_kind(self):
        import torch
        return torch.cuda.get_device_name(self.id)

    def memory_stats(self):
        import torch
        st = torch.cuda.memory_stats(self.id)
        return {'bytes_in_use': st.get('allocated_bytes.all.current', 0),
                'peak_bytes_in_use': st.get('allocated_bytes.all.peak', 0),
                'bytes_reserved': st.get('reserved_bytes.all.current', 0),
                'num_allocs': st.get('allocation.all.allocated', 0),
                'bytes_limit': torch.cuda.mem_get_info(self.id)[1]}


class _CpuDevice:
    """The host, the one visible device without a card: no stats."""
    platform = 'cpu'
    id = 0
    device_kind = 'cpu'

    def memory_stats(self):
        return None


def visible_devices():
    """Every visible card as a :class:`CudaDevice`, or the stats-less
    CPU device without one."""
    import torch
    if not torch.cuda.is_available():
        return [_CpuDevice()]
    return [CudaDevice(i) for i in range(torch.cuda.device_count())]


def _device_label(device):
    plat = getattr(device, 'platform', 'dev')
    return f'{plat}:{getattr(device, "id", 0)}'


def _safe_memory_stats(device):
    """``device.memory_stats()`` or None — the narrowed exception set is
    every "stats unsupported here" shape."""
    try:
        return device.memory_stats() or None
    except (AttributeError, NotImplementedError, RuntimeError, TypeError):
        return None


def device_stats_snapshot(devices=None):
    """One-shot plain-dict view of every device's memory stats (None for
    a device without them) — the form the flight recorder samples and a
    benchmark artifact embeds."""
    if devices is None:
        devices = visible_devices()
    return [{'device': _device_label(d),
             'platform': getattr(d, 'platform', None),
             'device_kind': getattr(d, 'device_kind', None),
             'memory_stats': _safe_memory_stats(d)}
            for d in devices]


class DeviceMonitor:
    """Poll device memory stats into labeled gauges.

    ``devices`` is injectable (tests use fakes; default: every visible
    device, resolved lazily at first poll so constructing a monitor
    never initialises CUDA). ``interval`` is the polling period of the
    background thread; :meth:`poll_once` works without the thread for
    callers that poll on their own cadence."""

    def __init__(self, registry: Optional[tracing.MetricsRegistry] = None,
                 *, devices=None, interval=5.0, prefix='device.memory'):
        self.registry = registry or tracing.get_registry()
        self.interval = float(interval)
        self.prefix = prefix
        self._devices = devices
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # label -> keys set on the last poll: lets a later poll mark a
        # device's gauges NaN when it STOPS reporting, instead of
        # serving its last value as if it were live forever.
        self._last_keys = {}
        self._polls = self.registry.counter(f'{prefix}.polls')
        self._reporting = self.registry.gauge(
            f'{prefix}.devices_reporting')

    def _resolve_devices(self):
        if self._devices is None:
            self._devices = visible_devices()
        return self._devices

    def poll_once(self):
        """One polling pass; returns ``{device_label: stats_dict}`` for
        the devices that reported (and updates the gauges). A device
        (or stat key) that previously reported and now does not gets
        its gauge set to NaN — a frozen last value would be
        indistinguishable from a live reading at ``/metrics``."""
        out = {}
        seen_keys = {}
        for dev in self._resolve_devices():
            stats = _safe_memory_stats(dev)
            label = _device_label(dev)
            if not stats:
                seen_keys[label] = set()
                continue
            out[label] = stats
            exported = set()
            for key in _STAT_KEYS:
                val = stats.get(key)
                if isinstance(val, (int, float)):
                    exported.add(key)
                    self.registry.gauge(
                        f'{self.prefix}.{key}',
                        labels={'device': label}).set(val)
            seen_keys[label] = exported
        for label, prev in self._last_keys.items():
            for key in prev - seen_keys.get(label, set()):
                self.registry.gauge(f'{self.prefix}.{key}',
                                    labels={'device': label}
                                    ).set(float('nan'))
        self._last_keys = {k: v for k, v in seen_keys.items() if v}
        self._polls.inc()
        self._reporting.set(len(out))
        return out

    # -- background thread ---------------------------------------------
    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name='obs-devmon', daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as e:
                tracing.log_exception('devmon.poll', e,
                                      registry=self.registry)
            self._stop.wait(self.interval)

    def stop(self):
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


class CaptureInFlight(RuntimeError):
    """A trace capture was requested while one is already running."""


def _profiler():
    """A ``torch.profiler.profile`` over CPU (and, with a card, CUDA)
    activities that records every thread's ops."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts, experimental_config=_ExperimentalConfig(
        profile_all_threads=True))


class ProfileCapture:
    """Guarded, bounded ``torch.profiler`` captures.

    One capture at a time per instance: :meth:`start` raises
    :class:`CaptureInFlight` while a capture is in flight (the
    ``/profile`` endpoint answers 409; the scheduler's adaptive trigger
    just skips). Durations are clamped to ``(0, max_seconds]`` — an
    unbounded capture would grow without limit and stall the profiler
    for every later request.

    Captures run on a worker thread: ``start`` returns immediately with
    the trace directory (``base_dir/trace-<n>``, the Chrome trace
    ``trace.json`` in it once the capture lands), emits a
    ``profile.capture`` event, and bumps the ``profile.captures``
    counter. ``join()`` blocks until the in-flight capture (if any)
    lands — tests and shutdown paths use it."""

    def __init__(self, base_dir, *, max_seconds=60.0,
                 default_seconds=3.0,
                 registry: Optional[tracing.MetricsRegistry] = None,
                 clock=time.sleep):
        self.base_dir = os.fspath(base_dir)
        self.max_seconds = float(max_seconds)
        self.default_seconds = float(default_seconds)
        self.registry = registry or tracing.get_registry()
        self._sleep = clock
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        # Explicit in-flight flag, flipped under the lock: a freshly
        # CREATED thread is not yet alive, so Thread.is_alive() alone
        # would let two concurrent start() calls both pass the guard.
        self._in_flight = False     # guarded-by: self._lock
        self._n = 0                 # guarded-by: self._lock
        self._warmed = False
        self._captures = self.registry.counter('profile.captures')
        self._g_busy = self.registry.gauge('profile.capture_in_flight')

    @property
    def busy(self) -> bool:
        with self._lock:
            return self._in_flight

    @property
    def warmed(self) -> bool:
        return self._warmed

    def warmup(self):
        """Pay the profiler's one-time native initialisation NOW (the
        first CUPTI start in a process is slow; every later capture is
        quick). An anomaly- or ttft-triggered capture taken before
        warmup would spend its bounded window inside that start and
        record little of the regression it fired on. Synchronous,
        idempotent (returns False when already warmed), guarded like a
        capture (raises :class:`CaptureInFlight` while one runs). The
        throwaway trace lands in ``base_dir/warmup``; no
        ``profile.capture`` event or counter — it observed nothing."""
        if self._warmed:
            return False
        with self._lock:
            if self._in_flight:
                raise CaptureInFlight(
                    'cannot warm up while a capture is in flight')
            self._in_flight = True
            self._g_busy.set(1)
        path = os.path.join(self.base_dir, 'warmup')
        try:
            os.makedirs(path, exist_ok=True)
            prof = _profiler()
            prof.start()
            prof.stop()
            prof.export_chrome_trace(os.path.join(path, TRACE_FILE))
            self._warmed = True
        except Exception as e:
            # A build without a profiler must not fail startup — the
            # later real capture will report its own failure.
            tracing.log_exception('profile.warmup', e,
                                  registry=self.registry)
        finally:
            with self._lock:
                self._in_flight = False
                self._g_busy.set(0)
        return self._warmed

    def start(self, seconds=None, *, trigger='manual', event_log=None,
              **extra):
        """Begin one bounded capture; returns ``{'path', 'seconds',
        'trigger'}``. Raises :class:`CaptureInFlight` when one is
        already running. ``extra`` fields ride on the emitted
        ``profile.capture`` event (the adaptive trigger stamps the p99
        that tripped it)."""
        seconds = (self.default_seconds if seconds is None
                   else float(seconds))
        if not (seconds > 0):
            raise ValueError(f'capture seconds must be > 0, '
                             f'got {seconds}')
        seconds = min(seconds, self.max_seconds)
        if not self._warmed:
            self.warmup()
        with self._lock:
            if self._in_flight:
                raise CaptureInFlight(
                    'a profiler capture is already in flight — one '
                    'trace at a time (retry after it lands)')
            self._in_flight = True
            # Never hand out a directory that already has contents: a
            # restarted process reusing base_dir would otherwise return
            # a path holding the PREVIOUS run's trace.
            while True:
                self._n += 1
                path = os.path.join(self.base_dir,
                                    f'trace-{self._n:04d}')
                if not os.path.exists(path):
                    break
        try:
            os.makedirs(path, exist_ok=False)
            thread = threading.Thread(
                target=self._capture, args=(path, seconds),
                name='obs-profile-capture', daemon=True)
            self._thread = thread
            # Gauge updates happen under the SAME lock as _in_flight
            # flips (here and in _capture's finally): a finishing
            # worker's set(0) must not land after a newer capture's
            # set(1) and report an in-flight capture as idle.
            with self._lock:
                self._g_busy.set(1)
            thread.start()
        except BaseException:
            # The capture never began: release the guard so the next
            # request isn't refused (409) forever.
            with self._lock:
                self._in_flight = False
                self._g_busy.set(0)
            raise
        # Accounting only after the worker is really running — a failed
        # start must not leave a phantom capture in the metrics or the
        # event log.
        self._captures.inc()
        from distributed_dot_product_tpu_torch.obs import events
        events.emit('profile.capture', _log=event_log,
                    trigger=trigger, seconds=seconds, path=path, **extra)
        return {'path': path, 'seconds': seconds, 'trigger': trigger}

    def _capture(self, path, seconds):
        try:
            prof = _profiler()
            prof.start()
            self._warmed = True     # the native init is paid now
            try:
                self._sleep(seconds)
            finally:
                prof.stop()
            prof.export_chrome_trace(os.path.join(path, TRACE_FILE))
        except Exception as e:
            # A failed capture must never wedge the guard (the next
            # request would 409 forever) or crash the server thread.
            tracing.log_exception('profile.capture', e,
                                  registry=self.registry)
        finally:
            with self._lock:
                self._in_flight = False
                self._g_busy.set(0)

    def join(self, timeout=None):
        t = self._thread
        if t is not None:
            t.join(timeout)
        return not self.busy
