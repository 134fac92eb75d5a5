# -*- coding: utf-8 -*-
"""
Incident flight recorder — a bounded in-memory black box that captures
the service's state AT the moment of failure, and the post-mortem
bundle a human (or ``obs doctor``) can diagnose from alone.

The obs stack can already explain a run *after the fact* (event log +
timelines, perf observatory, goodput accounting); this module owns the
incident-response half:

- :class:`FlightRecorder`: a hard-bounded ring (records AND bytes) that
  tees every record the active :class:`~distributed_dot_product_tpu_torch
  .obs.events.EventLog` emits (already-encoded lines — no second
  serialization) plus periodic metric-registry samples and
  :func:`device_stats_snapshot` polls. Always-on cheap when enabled;
  **zero-alloc when disabled** — the events tee is one global
  None-check (the spans contract), and :func:`recorder` returns one
  shared null object so call sites never branch.
- :meth:`FlightRecorder.dump_bundle`: writes a schema-versioned bundle
  directory — MANIFEST + the ring's event window as VALID event-log
  JSONL (``obs validate`` / ``reconstruct`` / ``goodput`` work on it
  unchanged) + the full metrics snapshot + device stats + all-thread
  stack dumps (``sys._current_frames``) + any registered introspection
  sections (the scheduler contributes its slot table / queue depth /
  page-pool stats via :func:`add_provider`).

Copied from ``distributed_dot_product_tpu/obs/flight.py``. The device
samples read ``torch.cuda`` memory statistics, the MANIFEST names the
torch version, and the reference's critpath section is left out with
the critical-path module it summarises.

Triggers (each emits a ``postmortem.dump`` event): the serving
watchdog's stall callback, an unhandled scheduler-loop exception, a
NaN-quarantine storm, SIGTERM (:meth:`FlightRecorder.install_sigterm`),
and manual calls. Auto triggers go through :meth:`FlightRecorder
.maybe_dump`, which rate-limits per trigger so a stall that repeats
does not dump a storm of bundles.

Usage::

    from distributed_dot_product_tpu_torch.obs import flight

    with flight.recording(base_dir='/tmp/flight') as rec:
        ...                              # serve under traffic
        rec.dump_bundle(trigger='manual')

    # or process-wide via the env knob a shell script sets:
    rec = flight.open_from_env()         # $DDP_TPU_FLIGHT_DIR
"""

import collections
import contextlib
import json
import os
import signal
import sys
import threading
import time
import traceback
from typing import Dict, Optional

from distributed_dot_product_tpu_torch.obs import events as obs_events
from distributed_dot_product_tpu_torch.utils import tracing

__all__ = ['BUNDLE_SCHEMA', 'ENV_VAR', 'FlightRecorder', 'recorder',
           'device_stats_snapshot',
           'get_recorder', 'install', 'recording', 'open_from_env',
           'add_provider', 'remove_provider', 'load_bundle']

BUNDLE_SCHEMA = 1
ENV_VAR = 'DDP_TPU_FLIGHT_DIR'

# Bundle file names (MANIFEST lists them; load_bundle reads them).
_EVENTS_FILE = 'events.jsonl'
_METRICS_FILE = 'metrics.json'
_SAMPLES_FILE = 'metric_samples.jsonl'
_DEVICES_FILE = 'device_samples.jsonl'
_STACKS_FILE = 'stacks.json'


def device_stats_snapshot(devices=None):
    """``[{'device', 'kind', 'bytes_in_use', 'peak_bytes_in_use'}, ...]``
    for each CUDA device (``devices``: indices, default all), or None
    without a card — the port's counterpart of the reference's
    ``obs.devmon.device_stats_snapshot``."""
    import torch
    if not torch.cuda.is_available():
        return None
    out = []
    for i in (devices if devices is not None
              else range(torch.cuda.device_count())):
        out.append({'device': i, 'kind': torch.cuda.get_device_name(i),
                    'bytes_in_use': torch.cuda.memory_allocated(i),
                    'peak_bytes_in_use': torch.cuda.max_memory_allocated(i)})
    return out


def _thread_stacks():
    """``{thread_name: [frame lines...]}`` for every live thread —
    what a hung scheduler looks like from the inside (the watchdog
    thread dumping this while the loop thread sleeps inside a wedged
    step is exactly the post-mortem a stall needs)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for ident, frame in sys._current_frames().items():
        label = names.get(ident, f'thread-{ident}')
        out[label] = [line.rstrip('\n')
                      for line in traceback.format_stack(frame)]
    return out


class FlightRecorder:
    """Bounded black-box ring + bundle dumper (see module docstring).

    ``max_records`` / ``max_bytes`` hard-bound the ring — whichever
    fills first evicts from the oldest end, and the eviction count is
    recorded in the MANIFEST (a truncated window is an audit fact, not
    a silent gap). ``sample_interval`` throttles the periodic metric /
    device samples (REAL seconds — :meth:`sample` is safe to call every
    scheduler tick); ``dump_cooldown`` rate-limits :meth:`maybe_dump`
    per trigger. ``registry`` is the metrics registry sampled into the
    ring and snapshotted into bundles (default: the process registry).
    """

    def __init__(self, base_dir, *, max_records=2048,
                 max_bytes=2 * 2 ** 20, sample_interval=1.0,
                 dump_cooldown=30.0,
                 registry: Optional[tracing.MetricsRegistry] = None,
                 devices=None, clock=time.time):
        self.base_dir = os.fspath(base_dir)
        self.max_records = int(max_records)
        self.max_bytes = int(max_bytes)
        self.sample_interval = float(sample_interval)
        self.dump_cooldown = float(dump_cooldown)
        self.registry = registry or tracing.get_registry()
        self.clock = clock
        self._devices = devices
        self._lock = threading.Lock()
        self._ring = collections.deque()     # guarded-by: self._lock
        self._bytes = 0                      # guarded-by: self._lock
        self._dropped = 0                    # guarded-by: self._lock
        self._teed = 0                       # guarded-by: self._lock
        self._last_sample = None             # real-time throttle anchor
        self._last_dump: Dict[str, float] = {}
        self._n_dumps = 0                    # guarded-by: self._lock
        self.dumps = []                      # [{'path','trigger',...}]
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._prev_sigterm = None
        self._c_dumps = self.registry.counter('flight.dumps')
        self._g_records = self.registry.gauge('flight.ring_records')
        self._g_bytes = self.registry.gauge('flight.ring_bytes')

    # -- the ring -------------------------------------------------------
    def _add(self, kind, line, teed=False):
        with self._lock:
            if teed:
                self._teed += 1
            self._ring.append((kind, line))
            self._bytes += len(line)
            while self._ring and (len(self._ring) > self.max_records
                                  or self._bytes > self.max_bytes):
                _, old = self._ring.popleft()
                self._bytes -= len(old)
                self._dropped += 1

    def _tee_event(self, rec, line):
        """The events-module hook: every record any EventLog emits
        lands here as its already-encoded line (installed via
        :func:`install`; one global None-check when not). The tee
        count rides ``_add``'s lock — this runs under the SOURCE
        log's lock while the sampling thread holds ours."""
        self._add('event', line, teed=True)

    def sample(self, force=False):
        """One metric-registry sample + device-stats poll into the
        ring, throttled to ``sample_interval`` REAL seconds unless
        ``force`` — the scheduler calls this every tick; steady-state
        cost between samples is one clock read and a compare."""
        now = time.monotonic()
        if not force and self._last_sample is not None \
                and now - self._last_sample < self.sample_interval:
            return False
        self._last_sample = now
        ts = self.clock()
        snap = self.registry.snapshot()
        self._add('metrics', json.dumps(
            {'ts': ts, 'metrics': snap},
            separators=(',', ':'), default=str))
        try:
            devs = device_stats_snapshot(self._devices)
        except Exception as e:      # a dead backend must not kill obs
            tracing.log_exception('flight.device_sample', e,
                                  registry=self.registry)
            devs = None
        self._add('devices', json.dumps(
            {'ts': ts, 'devices': devs},
            separators=(',', ':'), default=str))
        # Gauge values read under the ring lock: the scheduler tick and
        # the background sampling thread both land here, and a torn
        # read would export a records/bytes pair from two moments.
        with self._lock:
            records, ring_bytes = len(self._ring), self._bytes
        self._g_records.set(records)
        self._g_bytes.set(ring_bytes)
        return True

    def stats(self):
        with self._lock:
            return {'records': len(self._ring), 'bytes': self._bytes,
                    'dropped': self._dropped, 'teed': self._teed,
                    'max_records': self.max_records,
                    'max_bytes': self.max_bytes,
                    'dumps': self._n_dumps}

    # -- background sampling thread (optional; the scheduler's per-tick
    # sample() calls make it unnecessary under a serving loop) ---------
    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name='obs-flight', daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.is_set():
            try:
                self.sample()
            except Exception as e:
                tracing.log_exception('flight.sample', e,
                                      registry=self.registry)
            self._stop.wait(self.sample_interval)

    def stop(self):
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None

    # -- dumping --------------------------------------------------------
    def maybe_dump(self, *, trigger, reason='', sections=None):
        """Rate-limited :meth:`dump_bundle` for AUTO triggers: at most
        one bundle per ``dump_cooldown`` REAL seconds per trigger kind
        (a stall that repeats while an operator reacts must not fill
        the disk with near-identical bundles). Returns the bundle path,
        or None when suppressed."""
        now = time.monotonic()
        last = self._last_dump.get(trigger)
        if last is not None and now - last < self.dump_cooldown:
            return None
        path = self.dump_bundle(trigger=trigger, reason=reason,
                                sections=sections)
        # Cooldown anchors on SUCCESS only: a dump that failed (disk
        # full, base_dir transiently unwritable) must not suppress the
        # retry the still-firing trigger will request.
        self._last_dump[trigger] = time.monotonic()
        return path

    def dump_bundle(self, out_dir=None, *, trigger='manual', reason='',
                    sections=None, event_log=None):
        """Write one post-mortem bundle directory and return its path.

        Layout (all files listed in MANIFEST.json):

        - ``events.jsonl`` — the ring's event window, byte-identical to
          the lines the source log wrote (``obs validate`` /
          ``reconstruct`` / ``goodput`` run on it unchanged).
        - ``metric_samples.jsonl`` / ``device_samples.jsonl`` — the
          ring's periodic samples (one final forced sample is taken
          here, so a bundle always carries the state AT dump time).
        - ``metrics.json`` — the full registry snapshot at dump time.
        - ``stacks.json`` — every live thread's stack.
        - ``<name>.json`` per introspection section: ``sections``
          passed by the caller (the scheduler's triggers hand their
          slot table in directly) merged over the module-level
          :func:`add_provider` registry (the ``/dump`` endpoint's
          path); explicit sections win on name collision.

        Emits a ``postmortem.dump`` event into ``event_log`` (or the
        active log) AFTER the files land — the bundle never contains
        its own dump record, the next one does.
        """
        self.sample(force=True)
        with self._lock:
            entries = list(self._ring)
            ring_stats = {'records': len(self._ring),
                          'bytes': self._bytes,
                          'dropped': self._dropped,
                          'max_records': self.max_records,
                          'max_bytes': self.max_bytes}
            self._n_dumps += 1
            n = self._n_dumps
        if out_dir is None:
            out_dir = os.path.join(self.base_dir,
                                   f'bundle-{n:04d}-{trigger}')
        out_dir = os.fspath(out_dir)
        os.makedirs(out_dir, exist_ok=True)

        by_kind = {'event': [], 'metrics': [], 'devices': []}
        for kind, line in entries:
            by_kind.setdefault(kind, []).append(line)
        for fname, kind in ((_EVENTS_FILE, 'event'),
                            (_SAMPLES_FILE, 'metrics'),
                            (_DEVICES_FILE, 'devices')):
            with open(os.path.join(out_dir, fname), 'w',
                      encoding='utf-8') as f:
                for line in by_kind[kind]:
                    f.write(line + '\n')
        with open(os.path.join(out_dir, _METRICS_FILE), 'w',
                  encoding='utf-8') as f:
            json.dump(self.registry.snapshot(), f, indent=2,
                      default=str)
        with open(os.path.join(out_dir, _STACKS_FILE), 'w',
                  encoding='utf-8') as f:
            json.dump(_thread_stacks(), f, indent=2)

        merged = {}
        for name, fn in list(_PROVIDERS.items()):
            try:
                merged[name] = fn()
            except Exception as e:  # a broken provider can't block a dump
                tracing.log_exception('flight.provider', e,
                                      registry=self.registry)
        merged.update(sections or {})
        section_files = {}
        for name, payload in merged.items():
            fname = f'{name}.json'
            section_files[name] = fname
            with open(os.path.join(out_dir, fname), 'w',
                      encoding='utf-8') as f:
                json.dump(payload, f, indent=2, default=str)

        import torch
        manifest = {
            'schema': BUNDLE_SCHEMA,
            'bundle': 'ddp-flight-postmortem',
            'created_ts': self.clock(),
            'trigger': trigger,
            'reason': reason,
            'event_schema_version': obs_events.SCHEMA_VERSION,
            'torch_version': torch.__version__,
            'python_version': sys.version.split()[0],
            'ring': ring_stats,
            'files': {'events': _EVENTS_FILE,
                      'metrics': _METRICS_FILE,
                      'metric_samples': _SAMPLES_FILE,
                      'device_samples': _DEVICES_FILE,
                      'stacks': _STACKS_FILE,
                      'sections': section_files},
        }
        with open(os.path.join(out_dir, 'MANIFEST.json'), 'w',
                  encoding='utf-8') as f:
            json.dump(manifest, f, indent=2)
        self._c_dumps.inc()
        info = {'path': out_dir, 'trigger': trigger, 'reason': reason,
                'ts': manifest['created_ts']}
        self.dumps.append(info)
        obs_events.emit('postmortem.dump', _log=event_log,
                        trigger=trigger, path=out_dir, reason=reason)
        return out_dir

    # -- SIGTERM trigger ------------------------------------------------
    def install_sigterm(self, *, dump_timeout=5.0):
        """Chain a SIGTERM handler that dumps one bundle (trigger
        ``'sigterm'``) and then invokes whatever handler was installed
        before (the training loop's final-save handler keeps
        working). Main-thread only (signal module contract); opt-in —
        a library must not steal signals by default.

        The dump runs on a WORKER thread with a bounded join, never
        inline in the handler: the signal can interrupt the main
        thread while it holds the event-log / ring / registry locks
        (all non-reentrant — ``EventLog.emit`` calls the tee under its
        lock), and an inline dump re-acquiring them would deadlock the
        handler and make the process ignore SIGTERM entirely. With the
        worker, a blocked dump merely times out after ``dump_timeout``
        seconds, finishes in the background once the interrupted frame
        releases its lock, and the chained handler always runs."""
        def _dump():
            try:
                self.maybe_dump(trigger='sigterm', reason='SIGTERM')
            except Exception as e:
                tracing.log_exception('flight.sigterm_dump', e,
                                      registry=self.registry)

        def _handler(signum, frame):
            worker = threading.Thread(target=_dump,
                                      name='obs-flight-sigterm',
                                      daemon=True)
            worker.start()
            worker.join(dump_timeout)
            prev = self._prev_sigterm
            if callable(prev):
                prev(signum, frame)
            elif prev == signal.SIG_DFL:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

        self._prev_sigterm = signal.signal(signal.SIGTERM, _handler)
        return self

    def uninstall_sigterm(self):
        if self._prev_sigterm is not None:
            signal.signal(signal.SIGTERM, self._prev_sigterm)
            self._prev_sigterm = None


class _NullRecorder:
    """The disabled path: one shared, stateless no-op recorder —
    :func:`recorder` returns it when nothing is installed, so hot call
    sites (the scheduler's per-tick ``sample()``) never allocate or
    branch (the spans ``_NullSpan`` contract)."""

    __slots__ = ()

    def sample(self, force=False):
        return False

    def maybe_dump(self, **kwargs):
        return None

    def dump_bundle(self, *args, **kwargs):
        return None

    def stats(self):
        return {'records': 0, 'bytes': 0, 'dropped': 0, 'teed': 0,
                'max_records': 0, 'max_bytes': 0, 'dumps': 0}


_NULL = _NullRecorder()
_RECORDER: Optional[FlightRecorder] = None

# Introspection providers: name -> zero-arg callable returning a
# JSON-able section for every bundle (the scheduler registers its slot
# table / queue / page-pool introspection here so even an HTTP /dump
# with no scheduler in hand captures it). Module-level, not per
# recorder: a provider registered before the recorder is installed
# still contributes.
_PROVIDERS: Dict[str, object] = {}


def add_provider(name, fn):
    """Register ``fn()`` to be embedded as ``<name>.json`` in every
    bundle. Returns ``fn`` (decorator-friendly)."""
    _PROVIDERS[name] = fn
    return fn


def remove_provider(name, fn=None):
    """Remove a provider; with ``fn`` given, only when it is still the
    registered one (a closed scheduler must not unregister its
    replacement's section)."""
    if fn is None or _PROVIDERS.get(name) is fn:
        _PROVIDERS.pop(name, None)


def get_recorder() -> Optional[FlightRecorder]:
    return _RECORDER


def recorder():
    """The installed :class:`FlightRecorder`, or the shared null
    recorder — call sites use the result unconditionally."""
    return _RECORDER if _RECORDER is not None else _NULL


def install(rec: Optional[FlightRecorder]) -> Optional[FlightRecorder]:
    """Install ``rec`` as the process-wide recorder (None uninstalls);
    wires the events-module tee. Returns the previous recorder."""
    global _RECORDER
    prev = _RECORDER
    _RECORDER = rec
    obs_events._TEE = rec._tee_event if rec is not None else None
    return prev


@contextlib.contextmanager
def recording(base_dir=None, **kwargs):
    """Scoped enablement (the normal way to wire a run)::

        with flight.recording(base_dir='/tmp/flight') as rec:
            ...
            rec.dump_bundle(trigger='manual')
    """
    import tempfile
    if base_dir is None:
        base_dir = tempfile.mkdtemp(prefix='ddp_flight_')
    rec = FlightRecorder(base_dir, **kwargs)
    prev = install(rec)
    try:
        yield rec
    finally:
        install(prev)
        rec.stop()


def open_from_env(environ=None, **kwargs) -> Optional[FlightRecorder]:
    """A :class:`FlightRecorder` rooted at ``$DDP_TPU_FLIGHT_DIR`` (or
    None when the knob is unset) — how shell scripts
    (scripts/smoke_serve.sh) arm the black box without touching
    python. NOT auto-installed; callers decide the scope."""
    env = os.environ if environ is None else environ
    path = env.get(ENV_VAR)
    return FlightRecorder(path, **kwargs) if path else None


# -- read side ------------------------------------------------------------

def load_bundle(path):
    """Read a bundle directory back into one dict: ``manifest``,
    decoded ``events`` (seq-sorted, via ``events.read_events`` — a
    crash-torn tail line is tolerated), ``metrics``, ``metric_samples``
    / ``device_samples`` (decoded lines), ``stacks``, and ``sections``.
    Raises ``FileNotFoundError``/``ValueError`` on a directory that is
    not a bundle — ``obs doctor`` maps that to exit 1."""
    path = os.fspath(path)
    mpath = os.path.join(path, 'MANIFEST.json')
    if not os.path.exists(mpath):
        raise FileNotFoundError(f'{path}: no MANIFEST.json — not a '
                                f'flight bundle')
    with open(mpath, encoding='utf-8') as f:
        manifest = json.load(f)
    if manifest.get('schema') != BUNDLE_SCHEMA:
        raise ValueError(f'{path}: bundle schema '
                         f'{manifest.get("schema")!r} (supported: '
                         f'{BUNDLE_SCHEMA})')
    files = manifest.get('files', {})

    def _read_json(key, default):
        fname = files.get(key)
        fpath = fname and os.path.join(path, fname)
        if not fpath or not os.path.exists(fpath):
            return default
        with open(fpath, encoding='utf-8') as f:
            return json.load(f)

    def _read_jsonl(key):
        fname = files.get(key)
        fpath = fname and os.path.join(path, fname)
        if not fpath or not os.path.exists(fpath):
            return []
        out = []
        with open(fpath, encoding='utf-8') as f:
            lines = f.read().splitlines()
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                if i != len(lines) - 1:     # torn tail tolerated
                    raise
        return out

    events_path = os.path.join(path, files.get('events', _EVENTS_FILE))
    events = (obs_events.read_events(events_path)
              if os.path.exists(events_path) else [])
    sections = {name: _read_json_name(path, fname)
                for name, fname in files.get('sections', {}).items()}
    return {
        'path': path,
        'manifest': manifest,
        'events': events,
        'events_path': events_path,
        'metrics': _read_json('metrics', {}),
        'metric_samples': _read_jsonl('metric_samples'),
        'device_samples': _read_jsonl('device_samples'),
        'stacks': _read_json('stacks', {}),
        'sections': sections,
    }


def _read_json_name(bundle_path, fname):
    fpath = os.path.join(bundle_path, fname)
    if not os.path.exists(fpath):
        return None
    with open(fpath, encoding='utf-8') as f:
        return json.load(f)
