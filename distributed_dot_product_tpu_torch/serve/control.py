# -*- coding: utf-8 -*-
"""
Closed-loop SLO control: the plane that ACTS on the signals the
observatory already measures (the loadgen and goodput grading, the
online anomaly detectors, the replica pool and router) — this module
closes the loop from observed latency back into admission, eviction and
replica count. Copied from ``distributed_dot_product_tpu/serve/control.py``:

- **Watchdog-driven watermark actuation**: the :class:`Controller`
  evaluates an :class:`~distributed_dot_product_tpu_torch.obs.anomaly
  .AnomalyWatchdog` (queue depth, pages free, TTFT p99, reject rate)
  plus a direct pressure probe of every scheduler on its own cadence.
  A breach TIGHTENS admission — the degradation watermark drops (new
  requests degrade to capped budgets sooner) and the queue bound
  shrinks (a full queue flips ``accepting`` sooner, spilling new
  arrivals to a standby replica through the router's least-loaded
  ladder). Sustained headroom RELAXES both, stepwise, back to the
  configured ceiling.
- **Elastic decode autoscaling** (router mode): sustained backlog
  (queued per slot across the pool) scales decode replicas up;
  sustained idleness scales down — the victim replica is DRAINED
  first (``Scheduler.drain``: every in-flight request preempts with
  ``serve.preempt requeued=true drain=true`` and resubmits through
  the router onto the remaining replicas), so no stream is ever
  dropped without a typed reason.
- **Every action is a closed-vocabulary event** (``control.adjust``,
  ``control.scale``, ``control.drain`` — obs/events.py): a run's
  entire control history reconstructs from the JSONL alone, and
  ``obs doctor`` folds the control arcs into its incident evidence.

Determinism: the controller reads ONLY its injected clock and the
schedulers' live state; pairing it with the loadgen's
:class:`~distributed_dot_product_tpu_torch.serve.loadgen.VirtualClock` (and
handing the watchdog the same clock) makes a seeded trace's breach
sequence — and therefore its control history — replay bit-identically,
which is what lets a run gate the controlled config's goodput and its
control history against a second run of the same trace.
"""

import dataclasses
import time
from typing import Optional

from distributed_dot_product_tpu_torch.obs import events as obs_events

__all__ = ['ControlConfig', 'Controller']

# determlint: the evaluation loop runs from the scheduler tick — every
# decision derives from the injected clock and the probed state.
GRAPHLINT_TICK_ROOTS = ('Controller.tick',)

# Watchdog watches whose breach tightens admission (the stock catalog
# names — obs/anomaly.py default_watches).
TIGHTEN_WATCHES = frozenset(
    {'queue_depth', 'pages_free', 'ttft_p99', 'reject_rate'})


@dataclasses.dataclass
class ControlConfig:
    """Knobs of the control loop. All times on the controller's
    (injected) clock. ``interval`` is the evaluation cadence;
    ``tighten_pressure``/``relax_pressure`` bound the direct probe's
    hysteresis band; ``relax_after`` healthy evaluations undo one
    tighten step. Scaling (router mode only): ``scale_up_backlog``
    queued-per-slot across the pool for ``scale_up_after`` consecutive
    evaluations adds a replica (to ``max_replicas``);
    ``scale_down_backlog`` for ``scale_down_after`` drains the
    least-loaded one (to ``min_replicas``)."""
    interval: float = 0.02
    # watermark actuation
    min_watermark: float = 0.3
    max_watermark: Optional[float] = None   # None = the config's own
    tighten_step: float = 0.15
    relax_step: float = 0.05
    relax_after: int = 6
    tighten_pressure: float = 0.9
    relax_pressure: float = 0.5
    # queue-bound actuation (the router-spill knob)
    queue_scale_min: float = 0.25
    queue_scale_step: float = 0.5
    # elastic decode scaling
    scale: bool = True
    min_replicas: int = 1
    max_replicas: int = 4
    scale_up_backlog: float = 1.0
    scale_up_after: int = 2
    scale_down_backlog: float = 0.05
    scale_down_after: int = 10

    def validate(self):
        if self.interval <= 0:
            raise ValueError(f'interval must be > 0, got '
                             f'{self.interval}')
        if not 0 < self.min_watermark <= 1.0:
            raise ValueError(f'min_watermark must be in (0, 1], got '
                             f'{self.min_watermark}')
        if not 0 < self.queue_scale_min <= 1.0 \
                or not 0 < self.queue_scale_step < 1.0:
            raise ValueError('queue scale knobs must sit in (0, 1]')
        if self.min_replicas < 1 \
                or self.max_replicas < self.min_replicas:
            raise ValueError(f'need 1 <= min_replicas <= max_replicas, '
                             f'got {self.min_replicas}/'
                             f'{self.max_replicas}')


class Controller:
    """Drive scheduler knobs and the replica count from observed
    signals (see module docstring). Exactly one of ``scheduler`` (a
    single :class:`~distributed_dot_product_tpu_torch.serve.scheduler
    .Scheduler`) or ``router`` (a :class:`~distributed_dot_product_tpu_torch
    .serve.router.Router` over a ReplicaPool — arms autoscaling) is
    given. ``watchdog``: an :class:`~distributed_dot_product_tpu_torch.obs
    .anomaly.AnomalyWatchdog` evaluated each controller tick; in
    scheduler mode the stock catalog is built automatically over the
    scheduler's registry ON THE CONTROLLER'S CLOCK. Call :meth:`tick`
    from the serving loop (``scheduler.on_tick`` / after
    ``router.step``) — it self-throttles to ``cfg.interval``."""

    def __init__(self, *, scheduler=None, router=None, config=None,
                 watchdog=None, clock=time.monotonic, event_log=None,
                 registry=None):
        if (scheduler is None) == (router is None):
            raise ValueError('Controller needs exactly one of '
                             'scheduler= or router=')
        self.scheduler = scheduler
        self.router = router
        self.cfg = config or ControlConfig()
        self.cfg.validate()
        self.clock = clock
        self.event_log = event_log
        if registry is None:
            registry = (scheduler.registry if scheduler is not None
                        else router.registry)
        self.registry = registry
        if watchdog is None and scheduler is not None:
            from distributed_dot_product_tpu_torch.obs.anomaly import (
                AnomalyWatchdog, default_watches,
            )
            watchdog = AnomalyWatchdog(
                scheduler.registry,
                default_watches(queue_limit=scheduler.cfg.queue_limit,
                                paged=scheduler._paged,
                                cooldown=self.cfg.interval),
                event_log=event_log, min_interval=0.0, clock=clock)
        self.watchdog = watchdog
        # Knob state: ONE controller-wide target applied to every
        # scheduler (replicas joining mid-run inherit it), so a knob
        # change is one control.adjust event, not one per replica.
        base = self._schedulers()[0].cfg
        ceiling = (self.cfg.max_watermark
                   if self.cfg.max_watermark is not None
                   else base.degrade_watermark)
        self._watermark_ceiling = ceiling
        self._watermark = min(ceiling, base.degrade_watermark)
        self._queue_base = base.queue_limit
        self._queue_scale = 1.0
        self._last_eval = None
        self._healthy = 0
        self._busy_evals = 0
        self._idle_evals = 0
        self.actions = []       # every action dict, run-lifetime
        self._g_watermark = registry.gauge('control.watermark')
        self._g_watermark.set(self._watermark)
        self._g_replicas = registry.gauge('control.replicas')
        self._g_replicas.set(len(self._schedulers()))
        self._c_adjust = registry.counter('control.adjusts')
        self._c_scale = registry.counter('control.scales')

    # -- plumbing -------------------------------------------------------
    def _schedulers(self):
        if self.scheduler is not None:
            return [self.scheduler]
        return [r.scheduler for r in self.router.pool.replicas]

    def _emit(self, event, **fields):
        log = (self.event_log if self.event_log is not None
               else obs_events.get_active())
        if log is not None:
            log.emit(event, **fields)

    def _record(self, action):
        self.actions.append(action)
        return action

    # -- the evaluation loop --------------------------------------------
    def tick(self, now=None):
        """One control evaluation (self-throttled to ``cfg.interval``
        on the controller clock). Returns the actions taken this
        evaluation as a list of dicts (empty between intervals)."""
        now = self.clock() if now is None else now
        if self._last_eval is not None \
                and now - self._last_eval < self.cfg.interval:
            return []
        self._last_eval = now
        taken = []
        breaches = (self.watchdog.tick(force=True)
                    if self.watchdog is not None else [])
        breach_names = {w.name for w, _ in breaches}
        # Highest pressure across the fleet, WITH its source (queue /
        # page_pool) — the source rides the adjust reason so a
        # post-mortem (obs doctor) can tell pool-driven tightening
        # from queue-driven.
        pressure, source = 0.0, 'queue'
        for sched in self._schedulers():
            p, src = sched._pressure_info()
            if p > pressure:
                pressure, source = p, src
        tighten = bool(breach_names & TIGHTEN_WATCHES) \
            or pressure >= self.cfg.tighten_pressure
        if tighten:
            self._healthy = 0
            reason = ('breach:' + ','.join(
                sorted(breach_names & TIGHTEN_WATCHES))
                if breach_names & TIGHTEN_WATCHES
                else f'pressure:{source}:{pressure:.2f}')
            taken += self._tighten(reason)
        elif pressure <= self.cfg.relax_pressure:
            self._healthy += 1
            if self._healthy >= self.cfg.relax_after:
                self._healthy = 0
                taken += self._relax('sustained_headroom')
        else:
            self._healthy = 0
        if self.router is not None and self.cfg.scale:
            taken += self._maybe_scale()
        return taken

    # -- watermark / queue-bound actuation ------------------------------
    def _apply_knobs(self, scheduler):
        """Push the controller's current targets onto one scheduler
        (every knob change, and every replica the controller adds)."""
        scheduler.set_watermark(self._watermark)
        scheduler.set_queue_limit(
            max(1, round(self._queue_base * self._queue_scale)))

    def _adjust(self, knob, value, previous, reason):
        for sched in self._schedulers():
            self._apply_knobs(sched)
        self._c_adjust.inc()
        self._emit('control.adjust', knob=knob, value=value,
                   reason=reason, previous=previous)
        return self._record({'action': 'adjust', 'knob': knob,
                             'value': value, 'previous': previous,
                             'reason': reason})

    def _tighten(self, reason):
        out = []
        new = max(self.cfg.min_watermark,
                  self._watermark - self.cfg.tighten_step)
        if new != self._watermark:
            prev, self._watermark = self._watermark, new
            self._g_watermark.set(new)
            out.append(self._adjust('degrade_watermark', new, prev,
                                    reason))
        new_scale = max(self.cfg.queue_scale_min,
                        self._queue_scale * self.cfg.queue_scale_step)
        if new_scale != self._queue_scale:
            prev_limit = max(1, round(self._queue_base
                                      * self._queue_scale))
            self._queue_scale = new_scale
            limit = max(1, round(self._queue_base * new_scale))
            if limit != prev_limit:
                out.append(self._adjust('queue_limit', limit,
                                        prev_limit, reason))
        return out

    def _relax(self, reason):
        out = []
        new = min(self._watermark_ceiling,
                  self._watermark + self.cfg.relax_step)
        if new != self._watermark:
            prev, self._watermark = self._watermark, new
            self._g_watermark.set(new)
            out.append(self._adjust('degrade_watermark', new, prev,
                                    reason))
        if self._queue_scale != 1.0:
            prev_limit = max(1, round(self._queue_base
                                      * self._queue_scale))
            self._queue_scale = min(
                1.0, self._queue_scale / self.cfg.queue_scale_step)
            limit = max(1, round(self._queue_base * self._queue_scale))
            if limit != prev_limit:
                out.append(self._adjust('queue_limit', limit,
                                        prev_limit, reason))
        return out

    # -- elastic decode scaling -----------------------------------------
    def _maybe_scale(self):
        pool = self.router.pool
        loads = {r.name: r.load() for r in pool.replicas}
        slots = sum(r.engine.slots for r in pool.replicas)
        queued = sum(ld['queued'] for ld in loads.values())
        busy = sum(ld['busy'] for ld in loads.values())
        backlog = queued / max(1, slots)
        if backlog >= self.cfg.scale_up_backlog:
            self._busy_evals += 1
            self._idle_evals = 0
        elif queued == 0 and busy / max(1, slots) \
                <= self.cfg.scale_down_backlog:
            self._idle_evals += 1
            self._busy_evals = 0
        else:
            self._busy_evals = self._idle_evals = 0
        out = []
        if self._busy_evals >= self.cfg.scale_up_after \
                and len(pool.replicas) < self.cfg.max_replicas:
            self._busy_evals = 0
            replica = self.router.add_replica()
            self._apply_knobs(replica.scheduler)
            n = len(pool.replicas)
            self._g_replicas.set(n)
            self._c_scale.inc()
            reason = f'backlog:{backlog:.2f}'
            self._emit('control.scale', direction='up', replicas=n,
                       reason=reason, target=replica.name)
            out.append(self._record(
                {'action': 'scale', 'direction': 'up', 'replicas': n,
                 'target': replica.name, 'reason': reason}))
        elif self._idle_evals >= self.cfg.scale_down_after \
                and len(pool.replicas) > self.cfg.min_replicas:
            self._idle_evals = 0
            # Drain the least-loaded member (fewest in-flight — the
            # cheapest preempt+requeue bill), newest name on ties so
            # the original r0 is the last to go.
            victim = min(pool.replicas,
                         key=lambda r: (loads[r.name]['queued']
                                        + loads[r.name]['busy'],
                                        -int(r.name.lstrip('r') or 0)))
            requeued = self.router.drain_replica(victim.name)
            n = len(pool.replicas)
            self._g_replicas.set(n)
            self._c_scale.inc()
            self._emit('control.drain', target=victim.name,
                       requeued=requeued)
            reason = 'sustained_idle'
            self._emit('control.scale', direction='down', replicas=n,
                       reason=reason, target=victim.name)
            out.append(self._record(
                {'action': 'scale', 'direction': 'down', 'replicas': n,
                 'target': victim.name, 'requeued': requeued,
                 'reason': reason}))
        return out
