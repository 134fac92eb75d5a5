# -*- coding: utf-8 -*-
"""
Deterministic fault injection, copied from
``distributed_dot_product_tpu/utils/faults.py``: its training half for the
resilient training loop (:mod:`~distributed_dot_product_tpu_torch.train_loop`)
and its serving half for the scheduler.

Training faults (compose freely in one :class:`FaultPlan`):

- **NaN at step S** (``nan_at_steps``): every floating tensor of the batch
  the wrapped batch function returns becomes NaN, so the step's loss and
  gradients come out NaN and its guard must skip the update. One-shot by
  default: the replay after a rollback gets the clean batch.
- **Transient checkpoint I/O errors** (``io_error_saves``): the first N
  ``checkpoint.save`` attempts raise ``OSError``.
- **Crash mid-save** (``crash_in_save_at_step``): the save of step S
  leaves an unfinished ``*.ckpt-tmp*`` write on disk and raises
  :class:`SimulatedCrash` (a ``BaseException``: no retry or
  ``except Exception`` swallows a "dead" process).
- **SIGTERM** (``sigterm_at_step``): a real ``SIGTERM`` is delivered to
  this process when the batch of step S is requested.

Serving faults: a stuck decode step (the watchdog must fire), NaN logits
in one slot (the per-slot quarantine must absorb them), and a client
abandoning mid-stream.

Replica-scoped chaos for the disaggregated topology (:class:`ChaosPlan`,
:class:`ChaosInjector`): a decode replica killed at a virtual tick or in
the middle of a KV handoff, a replica whose probes go unanswered, one bit
flipped in a tracked KV page, the prefill pool killed. Everything is keyed
by replica name and virtual tick, so a seeded trace replays the same fault
at the same instant (``serve/loadgen.py`` :class:`ChaosSchedule` fires the
tick-keyed ones; the router asks the handoff and probe hooks).

Env knobs: :func:`plan_from_env` reads ``DDP_TPU_FAULT_NAN_STEPS``,
``_IO_ERRORS``, ``_CRASH_SAVE_STEP`` and ``_SIGTERM_STEP`` (the training
loop reads them when no injector is passed); :func:`serve_plan_from_env`
reads ``DDP_TPU_FAULT_STUCK_STEP``, ``_STUCK_SECONDS``,
``_NAN_DECODE_STEP``, ``_NAN_DECODE_SLOT``, ``_ABANDON_REQUEST``,
``_ABANDON_AFTER``, ``_BURST`` and ``_NAN_REPEAT`` (the scheduler reads
them when no injector is passed); :func:`chaos_plan_from_env` reads
``DDP_TPU_FAULT_REPLICA_CRASH``, ``_HANDOFF_CRASH``, ``_PROBE_BLACKHOLE``,
``_PAGE_CORRUPT`` and ``_PREFILL_CRASH``.
"""

import dataclasses
import os
import signal
import time
from typing import FrozenSet, Optional, Tuple

import torch

from distributed_dot_product_tpu_torch.obs import events as obs_events
from distributed_dot_product_tpu_torch.utils import checkpoint as _ckpt

__all__ = ['FaultPlan', 'FaultInjector', 'SimulatedCrash', 'plan_from_env',
           'poison_batch', 'ServeFaultPlan', 'ServeFaultInjector',
           'serve_plan_from_env', 'burst_prompts',
           'ChaosPlan', 'ChaosInjector', 'chaos_plan_from_env',
           'ChaosSpecError']


class SimulatedCrash(BaseException):
    """Raised to simulate the process dying mid-save. Derives from
    ``BaseException`` so no retry loop or ``except Exception`` recovery
    path can accidentally swallow a "dead" process."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """What to inject into training, and when. Immutable; runtime
    countdown state lives in the :class:`FaultInjector`."""
    nan_at_steps: FrozenSet[int] = frozenset()
    io_error_saves: int = 0
    crash_in_save_at_step: Optional[int] = None
    sigterm_at_step: Optional[int] = None
    fire_once: bool = True

    def any(self):
        return bool(self.nan_at_steps or self.io_error_saves
                    or self.crash_in_save_at_step is not None
                    or self.sigterm_at_step is not None)


def plan_from_env(environ=None) -> FaultPlan:
    """Build a :class:`FaultPlan` from the ``DDP_TPU_FAULT_*`` env knobs
    (an empty plan when none are set):

    - ``DDP_TPU_FAULT_NAN_STEPS=5,7``      NaN batches at steps 5 and 7
    - ``DDP_TPU_FAULT_IO_ERRORS=2``        the first 2 saves raise OSError
    - ``DDP_TPU_FAULT_CRASH_SAVE_STEP=10`` crash mid-save of step 10
    - ``DDP_TPU_FAULT_SIGTERM_STEP=20``    deliver SIGTERM at step 20
    """
    env = os.environ if environ is None else environ

    def _int(name):
        v = env.get(name)
        return int(v) if v not in (None, '') else None

    nan_steps = frozenset(
        int(s) for s in env.get('DDP_TPU_FAULT_NAN_STEPS', '').split(',')
        if s.strip())
    return FaultPlan(
        nan_at_steps=nan_steps,
        io_error_saves=_int('DDP_TPU_FAULT_IO_ERRORS') or 0,
        crash_in_save_at_step=_int('DDP_TPU_FAULT_CRASH_SAVE_STEP'),
        sigterm_at_step=_int('DDP_TPU_FAULT_SIGTERM_STEP'),
    )


def poison_batch(batch):
    """Every floating tensor of ``batch`` (nested tuples, lists, dicts)
    becomes all-NaN; integer and bool tensors and ``None`` pass through.
    Raises ``ValueError`` when the batch has NO floating tensor (an
    integer-token batch cannot carry a NaN, and silently not injecting
    would fake guard coverage)."""
    hit = []

    def _poison(x):
        if isinstance(x, torch.Tensor):
            if x.is_floating_point():
                hit.append(True)
                return torch.full_like(x, float('nan'))
            return x
        if isinstance(x, dict):
            return type(x)((k, _poison(v)) for k, v in x.items())
        if isinstance(x, (list, tuple)):
            return type(x)(_poison(v) for v in x)
        return x

    out = _poison(batch)
    if not hit:
        raise ValueError(
            'cannot inject NaN: the batch has no floating-point tensors '
            '(integer-token batches reach the loss through an embedding '
            '— poison a float input or test the guard with a float-batch '
            'model instead)')
    return out


def _step_of(target_dir):
    name = getattr(target_dir, 'name', str(target_dir))
    try:
        return int(str(name).rsplit('step_', 1)[-1])
    except ValueError:
        return None


class FaultInjector:
    """Runtime for a :class:`FaultPlan`. Use as a context manager (it
    installs the checkpoint save hook) and wrap the loop's batch
    function, or pass it to ``run_training(fault_injector=...)``, which
    wires both seams itself::

        with FaultInjector(FaultPlan(nan_at_steps=frozenset({3}))) as inj:
            run_training(step_fn, state, inj.wrap_batch_fn(batch_fn), cfg)
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._io_errors_left = plan.io_error_saves
        self._nan_fired = set()
        self._crash_fired = False
        self._sigterm_fired = False
        # ONE bound-method object, for the identity checks below.
        self._hook = self._save_hook

    def install(self):
        if _ckpt._SAVE_FAULT_HOOK is not None \
                and _ckpt._SAVE_FAULT_HOOK is not self._hook:
            raise RuntimeError('another FaultInjector is already installed')
        _ckpt._SAVE_FAULT_HOOK = self._hook
        return self

    def uninstall(self):
        if _ckpt._SAVE_FAULT_HOOK is self._hook:
            _ckpt._SAVE_FAULT_HOOK = None

    __enter__ = install

    def __exit__(self, *exc):
        self.uninstall()
        return False

    def wrap_batch_fn(self, batch_fn):
        def wrapped(step):
            self.on_step(step)
            batch = batch_fn(step)
            if self._should_nan(step):
                batch = poison_batch(batch)
            return batch
        return wrapped

    def on_step(self, step):
        """Per-step trigger point: delivers the synthetic SIGTERM — a real
        signal through the OS, which the loop's handler must catch."""
        p = self.plan
        if p.sigterm_at_step is not None and step == p.sigterm_at_step \
                and not self._sigterm_fired:
            self._sigterm_fired = True
            obs_events.emit('fault.inject', kind='sigterm', step=step)
            os.kill(os.getpid(), signal.SIGTERM)

    def _should_nan(self, step):
        if step not in self.plan.nan_at_steps:
            return False
        if self.plan.fire_once:
            if step in self._nan_fired:
                return False
            self._nan_fired.add(step)
        obs_events.emit('fault.inject', kind='nan_batch', step=step)
        return True

    def _save_hook(self, target_dir):
        p = self.plan
        if p.crash_in_save_at_step is not None and not self._crash_fired \
                and _step_of(target_dir) == p.crash_in_save_at_step:
            if p.fire_once:
                self._crash_fired = True
            # What a real crash mid-save leaves: an unfinished write.
            partial = target_dir.parent / (
                target_dir.name + _ckpt._TMP + '-0')
            partial.mkdir(parents=True, exist_ok=True)
            (partial / 'partial_write').write_text('simulated crash')
            obs_events.emit('fault.inject', kind='crash_in_save',
                            step=_step_of(target_dir))
            raise SimulatedCrash(f'simulated crash mid-save of {target_dir}')
        if self._io_errors_left > 0:
            self._io_errors_left -= 1
            obs_events.emit('fault.inject', kind='io_error',
                            step=_step_of(target_dir))
            raise OSError(
                f'injected transient checkpoint I/O failure '
                f'({self._io_errors_left} more to come)')


@dataclasses.dataclass(frozen=True)
class ServeFaultPlan:
    """What to inject into the serving loop, and when. ``fire_once``
    (default) makes every fault one-shot so recovery is provable."""
    stuck_at_step: Optional[int] = None     # decode step index to stall
    stuck_seconds: float = 0.75             # how long the stall lasts
    nan_at_step: Optional[int] = None       # decode step to poison
    nan_slot: int = 0                       # slot whose logits go NaN
    abandon_request: Optional[int] = None   # k-th ADMITTED request (0-based)
    abandon_after_tokens: int = 2           # ...after this many tokens
    burst: int = 0                          # request-burst size (callers)
    fire_once: bool = True

    def any(self):
        return (self.stuck_at_step is not None
                or self.nan_at_step is not None
                or self.abandon_request is not None
                or self.burst > 0)


def serve_plan_from_env(environ=None) -> ServeFaultPlan:
    """Build a :class:`ServeFaultPlan` from ``DDP_TPU_FAULT_*`` env knobs
    (an empty plan when none are set):

    - ``DDP_TPU_FAULT_STUCK_STEP=5``          stall decode step 5
    - ``DDP_TPU_FAULT_STUCK_SECONDS=1.5``     ...for 1.5 s
    - ``DDP_TPU_FAULT_NAN_DECODE_STEP=8``     NaN logits at decode step 8
    - ``DDP_TPU_FAULT_NAN_DECODE_SLOT=2``     ...in slot 2
    - ``DDP_TPU_FAULT_ABANDON_REQUEST=3``     4th admitted request abandons
    - ``DDP_TPU_FAULT_ABANDON_AFTER=4``       ...after 4 tokens
    - ``DDP_TPU_FAULT_BURST=64``              callers submit a 64-request
      burst (examples/serve_lm.py, scripts/smoke_serve.sh)
    - ``DDP_TPU_FAULT_NAN_REPEAT=1``          the NaN fault fires on EVERY
      step from ``nan_at_step`` on (``fire_once=False``) — the
      quarantine STORM that exhausts ``max_requeues`` into typed
      failures and trips the flight recorder's nan_storm auto-dump
      (obs/flight.py), instead of the default one-shot glitch
    """
    env = os.environ if environ is None else environ

    def _int(name):
        v = env.get(name)
        return int(v) if v not in (None, '') else None

    def _float(name, default):
        v = env.get(name)
        return float(v) if v not in (None, '') else default

    def _int_default(name, default):
        # Explicit None check: `or default` would rewrite a deliberate
        # 0 (e.g. abandon after 0 tokens) to the default.
        v = _int(name)
        return default if v is None else v

    return ServeFaultPlan(
        stuck_at_step=_int('DDP_TPU_FAULT_STUCK_STEP'),
        stuck_seconds=_float('DDP_TPU_FAULT_STUCK_SECONDS', 0.75),
        nan_at_step=_int('DDP_TPU_FAULT_NAN_DECODE_STEP'),
        nan_slot=_int_default('DDP_TPU_FAULT_NAN_DECODE_SLOT', 0),
        abandon_request=_int('DDP_TPU_FAULT_ABANDON_REQUEST'),
        abandon_after_tokens=_int_default('DDP_TPU_FAULT_ABANDON_AFTER',
                                          2),
        burst=_int_default('DDP_TPU_FAULT_BURST', 0),
        fire_once=not _int_default('DDP_TPU_FAULT_NAN_REPEAT', 0),
    )


def burst_prompts(n, prompt_len=8, vocab=64, seed=0):
    """Deterministic request burst: ``n`` prompts of ``prompt_len``
    tokens drawn from ``[0, vocab)`` — the adversarial admission load
    for soak tests and :mod:`scripts/smoke_serve.sh`. Seeded numpy, no
    device work: generating the burst must not perturb the run being
    faulted."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=prompt_len).astype(np.int32)
            for _ in range(n)]


class ServeFaultInjector:
    """Runtime for a :class:`ServeFaultPlan`. The scheduler calls the
    three hooks at its seams:

    - :meth:`on_decode_step` right before dispatching decode step ``i``
      — a stuck-step plan sleeps here, exactly what a hung compiled
      step looks like to the watchdog (no heartbeat while the host is
      blocked on the device).
    - :meth:`poison_slots` — the per-step NaN mask the engine applies
      to its logits IN-PROGRAM, so the per-slot finite predicate is
      exercised on real NaNs flowing out of the compiled step.
    - :meth:`should_abandon` after each token — mid-stream client
      abandon, keyed by admission order (stable under rescheduling).
    """

    def __init__(self, plan: ServeFaultPlan):
        self.plan = plan
        self._stuck_fired = False
        self._nan_fired = False
        self._abandon_fired = False
        self.stalls_injected = 0
        # Observability sink: the scheduler points this at its own
        # event log so injections land in the same stream as the
        # lifecycle they disrupt; None falls back to the active log.
        self.event_log = None

    def on_decode_step(self, step):
        p = self.plan
        if p.stuck_at_step is not None and step == p.stuck_at_step \
                and not (p.fire_once and self._stuck_fired):
            self._stuck_fired = True
            self.stalls_injected += 1
            obs_events.emit('fault.inject', _log=self.event_log,
                            kind='stuck_step', step=step,
                            seconds=p.stuck_seconds)
            time.sleep(p.stuck_seconds)

    def poison_slots(self, step, n_slots):
        """Bool list of slots whose logits the engine must NaN at this
        step, or None for a clean step. ``fire_once=True`` (default)
        poisons exactly decode step ``nan_at_step`` — a transient
        glitch the quarantine+retry must fully absorb;
        ``fire_once=False`` poisons EVERY step from ``nan_at_step`` on
        — a persistently bad path that must exhaust ``max_requeues``
        into a typed failure instead of retrying forever."""
        p = self.plan
        if p.nan_at_step is None:
            return None
        if p.fire_once:
            if step != p.nan_at_step or self._nan_fired:
                return None
        elif step < p.nan_at_step:
            return None
        self._nan_fired = True
        if not 0 <= p.nan_slot < n_slots:
            raise ValueError(f'nan_slot {p.nan_slot} out of range for '
                             f'{n_slots} slots')
        obs_events.emit('fault.inject', _log=self.event_log,
                        kind='nan_slot', step=step, slot=p.nan_slot)
        return [i == p.nan_slot for i in range(n_slots)]

    def should_abandon(self, admit_index, tokens_done):
        p = self.plan
        if p.abandon_request is None or admit_index != p.abandon_request \
                or tokens_done < p.abandon_after_tokens \
                or (p.fire_once and self._abandon_fired):
            return False
        self._abandon_fired = True
        obs_events.emit('fault.inject', _log=self.event_log,
                        kind='abandon', admit_index=admit_index,
                        tokens_done=tokens_done)
        return True


# ---------------------------------------------------------------------------
# Replica-scoped chaos (serve/replica.py, serve/router.py)
#
# The disaggregated layer's failure domain is a whole decode REPLICA, not
# a slot: a crashed replica takes its in-flight streams, its paged KV and
# its share of the cluster prefix cache down at once. Every knob here is
# keyed by replica name and virtual-time tick so a crash replays
# bit-identically (serve/loadgen.py ChaosSchedule drives crash_due from
# run_trace's on_tick; the router consults the handoff/probe hooks).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChaosPlan:
    """Replica-scoped faults, keyed by name + virtual tick. Immutable;
    runtime one-shot state lives in the :class:`ChaosInjector`."""
    # Kill this replica when the loadgen reaches this tick (name, tick).
    replica_crash: Optional[Tuple[str, int]] = None
    # Kill this replica DURING its next prefill->decode KV handoff —
    # after adopt_prefix, before the router records the placement (the
    # worst moment: pages adopted, stream never admitted).
    crash_in_handoff: Optional[str] = None
    # This replica stops answering router liveness probes (process
    # alive, network dead): loss must come from the probe timeout path.
    probe_blackhole: Optional[str] = None
    # Flip one bit in a live KV page of this replica at this tick
    # (name, page, tick). `page` indexes the replica's TRACKED
    # (registry) pages — sorted order, modulo the tracked count — so a
    # seeded trace corrupts the same prefix page whatever the pool's
    # allocation history; the flip defers to the first tick at/after
    # `tick` with any tracked page.
    page_corrupt: Optional[Tuple[str, int, int]] = None
    # Kill the shared prefill pool at this tick: routing must fall
    # back to flat prefill on the decode replicas, never block.
    prefill_crash: Optional[int] = None
    fire_once: bool = True

    def any(self):
        return (self.replica_crash is not None
                or self.crash_in_handoff is not None
                or self.probe_blackhole is not None
                or self.page_corrupt is not None
                or self.prefill_crash is not None)


class ChaosSpecError(ValueError):
    """A ``DDP_TPU_FAULT_*`` chaos knob holds a malformed spec. The
    message names the knob and its grammar — a typo'd chaos run must
    die loudly, not silently run fault-free."""


def _spec_name(spec):
    return spec


def _spec_tick(spec):
    return int(spec)


def _spec_name_tick(spec):
    name, _, tick = spec.rpartition(':')
    if not name:
        raise ValueError(spec)
    return (name, int(tick))


def _spec_name_page_tick(spec):
    parts = spec.split(':')
    if len(parts) != 3 or not parts[0]:
        raise ValueError(spec)
    return (parts[0], int(parts[1]), int(parts[2]))


# The one knob table: env key -> (plan field, spec parser, grammar).
# Adding a chaos knob is one row; the parser below gives every row the
# same typed-error discipline.
_CHAOS_KNOBS = (
    ('DDP_TPU_FAULT_REPLICA_CRASH', 'replica_crash',
     _spec_name_tick, '<replica>:<tick>'),
    ('DDP_TPU_FAULT_HANDOFF_CRASH', 'crash_in_handoff',
     _spec_name, '<replica>'),
    ('DDP_TPU_FAULT_PROBE_BLACKHOLE', 'probe_blackhole',
     _spec_name, '<replica>'),
    ('DDP_TPU_FAULT_PAGE_CORRUPT', 'page_corrupt',
     _spec_name_page_tick, '<replica>:<page>:<tick>'),
    ('DDP_TPU_FAULT_PREFILL_CRASH', 'prefill_crash',
     _spec_tick, '<tick>'),
)


def chaos_plan_from_env(environ=None) -> ChaosPlan:
    """Build a :class:`ChaosPlan` from the ``DDP_TPU_FAULT_*`` env
    knobs (an empty plan when none are set), table-driven over
    ``_CHAOS_KNOBS``:

    - ``DDP_TPU_FAULT_REPLICA_CRASH=r1:40``   kill replica r1 at tick 40
    - ``DDP_TPU_FAULT_HANDOFF_CRASH=r1``      kill r1 mid-KV-handoff
    - ``DDP_TPU_FAULT_PROBE_BLACKHOLE=r1``    r1 stops answering probes
    - ``DDP_TPU_FAULT_PAGE_CORRUPT=r1:0:40``  flip a bit in r1's
      tracked page #0 at tick 40
    - ``DDP_TPU_FAULT_PREFILL_CRASH=40``      kill the prefill pool at
      tick 40

    Malformed specs raise :class:`ChaosSpecError` naming the knob and
    its grammar."""
    env = os.environ if environ is None else environ
    fields = {}
    for key, field, parse, grammar in _CHAOS_KNOBS:
        spec = env.get(key, '').strip()
        if not spec:
            continue
        try:
            fields[field] = parse(spec)
        except ValueError as exc:
            raise ChaosSpecError(
                f'{key}={spec!r}: expected {grammar}') from exc
    return ChaosPlan(**fields)


class ChaosInjector:
    """Runtime for a :class:`ChaosPlan`. Three hooks, all pure functions
    of plan + one-shot state (no clock reads — chaos timing arrives as
    tick indices from the loadgen, so a seeded trace replays the same
    crash at the same virtual instant every run):

    - :meth:`crash_due` — the loadgen's per-tick hook; returns the name
      of the replica to kill at this tick (once), else None.
    - :meth:`crash_on_handoff` — the router asks right after a KV
      handoff lands on ``target``; True means kill it there.
    - :meth:`blackholed` — the router's prober asks before counting a
      probe answer; True means the replica never answers.
    """

    def __init__(self, plan: ChaosPlan):
        self.plan = plan
        self._crash_fired = False
        self._handoff_fired = False
        self._blackhole_announced = False
        self._corrupt_fired = False
        self._prefill_fired = False
        # Observability sink: the driver points this at the ROUTER's
        # log — injections land next to the loss/recovery arc they
        # cause; None falls back to the active log.
        self.event_log = None

    def crash_due(self, tick):
        p = self.plan
        if p.replica_crash is None:
            return None
        name, at_tick = p.replica_crash
        if tick != at_tick or (p.fire_once and self._crash_fired):
            return None
        self._crash_fired = True
        obs_events.emit('fault.inject', _log=self.event_log,
                        kind='replica_crash', target=name, tick=tick)
        return name

    def crash_on_handoff(self, target):
        p = self.plan
        if p.crash_in_handoff != target \
                or (p.fire_once and self._handoff_fired):
            return False
        self._handoff_fired = True
        obs_events.emit('fault.inject', _log=self.event_log,
                        kind='handoff_crash', target=target)
        return True

    def corrupt_due(self, tick):
        """The loadgen's per-tick corruption hook: at/after the planned
        tick, return ``(replica, page_index)`` once — the ChaosSchedule
        resolves the index over the replica's tracked pages and flips
        one bit host-side. None otherwise."""
        p = self.plan
        if p.page_corrupt is None:
            return None
        name, page, at_tick = p.page_corrupt
        if tick < at_tick or (p.fire_once and self._corrupt_fired):
            return None
        self._corrupt_fired = True
        obs_events.emit('fault.inject', _log=self.event_log,
                        kind='page_corrupt', target=name, page=page,
                        tick=tick)
        return (name, page)

    def prefill_crash_due(self, tick):
        """True exactly once when the planned prefill-pool crash tick
        arrives — the ChaosSchedule kills the pool there."""
        p = self.plan
        if p.prefill_crash is None or tick != p.prefill_crash \
                or (p.fire_once and self._prefill_fired):
            return False
        self._prefill_fired = True
        obs_events.emit('fault.inject', _log=self.event_log,
                        kind='prefill_crash', tick=tick)
        return True

    def blackholed(self, name):
        if self.plan.probe_blackhole != name:
            return False
        # Announce the blackhole once; the probe-miss stream itself is
        # the router's to narrate (replica.probe state=missed).
        if not self._blackhole_announced:
            self._blackhole_announced = True
            obs_events.emit('fault.inject', _log=self.event_log,
                            kind='probe_blackhole', target=name)
        return True
