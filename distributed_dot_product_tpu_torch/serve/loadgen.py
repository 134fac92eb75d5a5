# -*- coding: utf-8 -*-
"""
Seeded open-loop traffic generator for the serving scheduler — the port
of ``distributed_dot_product_tpu/serve/loadgen.py``; one seed gives the
reference's trace, arrival for arrival (numpy's generator on both
sides), and ``save_trace`` files load in either package.

The fault cocktail and fixed bursts exercise the scheduler's FAILURE
paths; nobody had ever offered it realistic LOAD. This module
generates a reproducible request trace and drives the scheduler with
it in-process, entirely in **virtual time**:

- **Open loop**: arrivals follow the configured process (Poisson, or a
  two-state ON/OFF bursty modulation) regardless of how the server is
  doing — the load does not politely wait for completions, which is
  exactly what makes queue growth, rejection and goodput measurable.
- **Heavy-tailed mixes**: prompt and output lengths come from a
  bounded-Pareto sample per tenant (most requests short, a fat tail of
  long ones — the shape real serving traffic has, and the one that
  breaks schedulers tuned on uniform bursts).
- **Tenants**: each request carries a tenant label drawn by per-tenant
  rate shares; the label threads through admission → scheduler →
  events → metrics, so per-tenant goodput is derivable offline
  (obs/slo.py) and live (the tenant-labeled metrics series).
- **Fully seeded and replayable**: one integer seed determines the
  whole trace (arrival times, tenants, prompts, budgets). The load loop
  runs on a :class:`VirtualClock` injected into the scheduler, so a
  test serves minutes of simulated traffic in milliseconds of wall
  time and the SAME seed yields the IDENTICAL goodput report.

Usage::

    cfg = LoadGenConfig(seed=7, rate=300.0, requests=64)
    res = run_load(cfg, engine=KernelEngine(slots=4, t_max=128),
                   event_log=EventLog('load.jsonl'))
    # then: obs.slo.goodput('load.jsonl', SloSpec(ttft=0.2, ...))

``run_trace`` drives anything with the Scheduler's surface, a
``serve.router.Router`` over a whole topology included. Not ported yet
(ROADMAP §1 item 4b): the closed-loop controller (``run_load(control=...)``
raises ``NotImplementedError``) and the router-driven ``ChaosSchedule``.
"""

import dataclasses
import json
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from distributed_dot_product_tpu_torch.serve.admission import RejectedError
from distributed_dot_product_tpu_torch.serve.errors import ServeContractError
from distributed_dot_product_tpu_torch.serve.scheduler import (
    Scheduler, ServeConfig,
)

__all__ = ['TenantSpec', 'LoadGenConfig', 'Arrival', 'VirtualClock',
           'generate_trace', 'run_trace', 'run_load', 'LoadResult',
           'default_tenants', 'TRACE_SCHEMA', 'save_trace',
           'load_trace']


class VirtualClock:
    """Deterministic injectable clock: calling it reads the time,
    :meth:`advance` moves it. The scheduler's deadline/idleness clock
    and the event log's ``ts`` stamps both take a callable, so one
    instance makes an entire serving run virtual-time."""

    def __init__(self, start=0.0):
        self._t = float(start)

    def __call__(self):
        return self._t

    def advance(self, dt):
        if dt < 0:
            raise ValueError(f'clock cannot go backwards (dt={dt})')
        self._t += dt
        return self._t


@dataclasses.dataclass
class TenantSpec:
    """One tenant's traffic shape. ``share`` is its relative weight of
    the aggregate arrival rate. Lengths are bounded-Pareto sampled in
    ``[lo, hi]`` with tail index ``alpha`` (smaller = heavier tail).
    ``deadline_s``: optional per-request deadline (seconds after
    arrival) submitted with every request — None for no deadline."""
    name: str
    share: float = 1.0
    prompt_lo: int = 2
    prompt_hi: int = 24
    new_lo: int = 4
    new_hi: int = 24
    alpha: float = 1.5
    deadline_s: Optional[float] = None


def default_tenants(n=2):
    """The stock mix: ``t0`` interactive (short prompts, short outputs,
    2/3 of traffic) and ``t1`` batchy (longer both ways); further
    tenants split the remainder evenly with t1's shape."""
    specs = [TenantSpec('t0', share=2.0, prompt_lo=2, prompt_hi=12,
                        new_lo=4, new_hi=12),
             TenantSpec('t1', share=1.0, prompt_lo=4, prompt_hi=24,
                        new_lo=8, new_hi=24)]
    for i in range(2, n):
        specs.append(dataclasses.replace(specs[1], name=f't{i}'))
    return specs[:max(1, n)]


@dataclasses.dataclass
class LoadGenConfig:
    """Knobs of the generator. ``rate`` is the aggregate offered rate
    (requests per virtual second); ``arrival='poisson'`` draws i.i.d.
    exponential inter-arrivals, ``'bursty'`` modulates them with a
    two-state ON/OFF process (ON bursts at ``rate * burst_factor``,
    exponential dwells sized so the AVERAGE offered rate stays
    ``rate``). ``'ramp'`` climbs the instantaneous rate linearly from
    ``rate`` to ``rate * ramp_factor`` across the trace; ``'step'``
    jumps it from ``rate`` to ``rate * ramp_factor`` at the
    ``step_at`` fraction of the requests — the two deterministic
    shapes that exercise elastic scale-up/scale-down.
    ``tick_seconds`` is the virtual duration of
    one scheduler tick — the simulated cost of the compiled decode
    step."""
    seed: int = 0
    rate: float = 200.0
    requests: int = 64
    arrival: str = 'poisson'   # 'poisson' | 'bursty' | 'ramp' | 'step'
    burst_factor: float = 4.0
    burst_dwell_s: float = 0.25     # mean ON-state dwell
    ramp_factor: float = 4.0        # peak rate multiple (ramp/step)
    step_at: float = 0.5            # 'step': jump after this fraction
    tenants: List[TenantSpec] = dataclasses.field(
        default_factory=default_tenants)
    vocab: int = 64
    tick_seconds: float = 0.002

    def validate(self):
        if self.rate <= 0 or self.requests < 1:
            raise ValueError(f'need rate > 0 and requests >= 1, got '
                             f'{self.rate}/{self.requests}')
        if self.arrival not in ('poisson', 'bursty', 'ramp', 'step'):
            raise ValueError(f"arrival must be 'poisson', 'bursty', "
                             f"'ramp' or 'step', got {self.arrival!r}")
        if self.arrival == 'bursty' and not self.burst_factor > 1.0:
            # The OFF dwell is sized from (burst_factor - 1); <= 1
            # would ask for a negative exponential scale deep inside
            # the generator — reject it here, typed.
            raise ValueError(f'bursty arrivals need burst_factor > 1, '
                             f'got {self.burst_factor}')
        if self.arrival in ('ramp', 'step') and not self.ramp_factor > 0:
            raise ValueError(f'{self.arrival} arrivals need '
                             f'ramp_factor > 0, got {self.ramp_factor}')
        if self.arrival == 'step' and not 0.0 <= self.step_at <= 1.0:
            raise ValueError(f'step_at must sit in [0, 1], got '
                             f'{self.step_at}')
        if not self.tenants:
            raise ValueError('need at least one TenantSpec')


@dataclasses.dataclass
class Arrival:
    """One scheduled request of a trace (virtual arrival time)."""
    at: float
    request_id: str
    tenant: str
    prompt: np.ndarray
    max_new_tokens: int
    deadline_s: Optional[float] = None


def _pareto_int(rng, lo, hi, alpha):
    """Bounded-Pareto integer in [lo, hi]: heavy-tailed (most draws
    near ``lo``, occasional ones out at ``hi``), closed under the
    bounds so a draw can never overflow the cache budget math."""
    lo, hi = int(lo), int(hi)
    if hi <= lo:
        return lo
    u = rng.random()
    ratio = (lo / hi) ** alpha
    x = lo / (1.0 - u * (1.0 - ratio)) ** (1.0 / alpha)
    return int(min(hi, max(lo, round(x))))


def generate_trace(cfg: LoadGenConfig) -> List[Arrival]:
    """The deterministic trace for ``cfg``: same seed, same trace,
    byte for byte — what makes a goodput report replayable."""
    cfg.validate()
    rng = np.random.default_rng(cfg.seed)
    shares = np.array([max(0.0, t.share) for t in cfg.tenants])
    if shares.sum() <= 0:
        raise ValueError('tenant shares sum to zero')
    shares = shares / shares.sum()
    trace = []
    t = 0.0
    # Bursty = ON/OFF modulated Poisson: ON bursts at rate*factor,
    # OFF emits nothing; dwell means sized so ON occupies 1/factor of
    # the time and the long-run offered rate stays cfg.rate.
    on = True
    state_left = (rng.exponential(cfg.burst_dwell_s)
                  if cfg.arrival == 'bursty' else float('inf'))
    for i in range(cfg.requests):
        if cfg.arrival == 'poisson':
            t += rng.exponential(1.0 / cfg.rate)
        elif cfg.arrival in ('ramp', 'step'):
            # Deterministic rate SHAPE over the request index: 'ramp'
            # climbs linearly to rate*ramp_factor at the last arrival,
            # 'step' jumps there after the step_at fraction. Each gap
            # is exponential at the instantaneous rate — a seeded
            # inhomogeneous-Poisson stand-in that round-trips through
            # save_trace/load_trace unchanged (only times serialize).
            if cfg.arrival == 'ramp':
                frac = i / max(1, cfg.requests - 1)
                r = cfg.rate * (1.0 + (cfg.ramp_factor - 1.0) * frac)
            else:
                r = (cfg.rate if i < cfg.requests * cfg.step_at
                     else cfg.rate * cfg.ramp_factor)
            t += rng.exponential(1.0 / r)
        else:
            # `gap` is ON-time until the next arrival (arrivals only
            # happen in the ON state, at rate*factor); OFF dwells are
            # dead time inserted whenever the gap crosses a state edge.
            gap = rng.exponential(1.0 / (cfg.rate * cfg.burst_factor))
            while not on or gap > state_left:
                t += state_left
                if on:
                    gap -= state_left
                state_left = rng.exponential(
                    cfg.burst_dwell_s * (cfg.burst_factor - 1.0)
                    if on else cfg.burst_dwell_s)
                on = not on
            t += gap
            state_left -= gap
        ti = int(rng.choice(len(cfg.tenants), p=shares))
        spec = cfg.tenants[ti]
        plen = _pareto_int(rng, spec.prompt_lo, spec.prompt_hi,
                           spec.alpha)
        prompt = rng.integers(0, cfg.vocab, size=plen).astype(np.int32)
        trace.append(Arrival(
            at=t, request_id=f'{spec.name}-{i:04d}', tenant=spec.name,
            prompt=prompt,
            max_new_tokens=_pareto_int(rng, spec.new_lo, spec.new_hi,
                                       spec.alpha),
            deadline_s=spec.deadline_s))
    return trace


TRACE_SCHEMA = 1


def save_trace(path, trace: List[Arrival], *, note=None):
    """Serialize a generated trace to schema-versioned JSON so the
    IDENTICAL request stream can drive two systems — the router
    topology and its single-process twin — byte for byte, or replay a
    recorded incident's load later. Floats round-trip exactly through
    JSON (repr-based), so ``load_trace(save_trace(t)) == t`` to the
    last bit; prompts serialize as plain int lists."""
    payload = {
        'schema': TRACE_SCHEMA,
        'arrivals': [
            {'at': a.at, 'request_id': a.request_id,
             'tenant': a.tenant,
             'prompt': [int(t) for t in a.prompt],
             'max_new_tokens': int(a.max_new_tokens),
             'deadline_s': a.deadline_s}
            for a in trace],
    }
    if note:
        payload['note'] = str(note)
    with open(path, 'w', encoding='utf-8') as f:
        json.dump(payload, f, separators=(',', ':'), allow_nan=False)
        f.write('\n')
    return path


def load_trace(path) -> List[Arrival]:
    """Read a :func:`save_trace` file back into the arrival list.
    Typed errors on an unknown schema version or a malformed arrival
    — a trace drives SLO-graded runs, silently coercing a broken one
    would grade garbage."""
    with open(path, encoding='utf-8') as f:
        payload = json.load(f)
    schema = payload.get('schema') if isinstance(payload, dict) else None
    if schema != TRACE_SCHEMA:
        raise ValueError(f'{path}: trace schema {schema!r} '
                         f'(supported: {TRACE_SCHEMA}) — regenerate '
                         f'the trace with this version\'s save_trace')
    trace = []
    for i, a in enumerate(payload.get('arrivals', [])):
        try:
            deadline = a.get('deadline_s')
            trace.append(Arrival(
                at=float(a['at']),
                request_id=str(a['request_id']),
                tenant=str(a['tenant']),
                prompt=np.asarray(a['prompt'], np.int32).reshape(-1),
                max_new_tokens=int(a['max_new_tokens']),
                deadline_s=None if deadline is None
                else float(deadline)))
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(
                f'{path}: arrival {i} is malformed '
                f'({type(e).__name__}: {e})') from e
    return trace


@dataclasses.dataclass
class LoadResult:
    """One load run's in-process accounting. The authoritative SLO
    verdict comes from the EVENT LOG (obs/slo.py goodput()); this is
    the load loop's own view for quick printing and cross-checks."""
    submitted: List[Tuple[str, str]]          # (request_id, tenant)
    rejected_at_submit: Dict[str, object]     # rid -> RejectReason
    results: Dict[str, object]                # rid -> RequestResult
    virtual_seconds: float
    wall_seconds: float
    offered_rate: float
    ticks: int

    @property
    def accounted(self):
        """True iff every submitted request has a terminal record —
        the zero-dropped-without-reason serving contract."""
        return all(rid in self.results or rid in self.rejected_at_submit
                   for rid, _ in self.submitted)


def run_trace(scheduler: Scheduler, trace: List[Arrival],
              clock: VirtualClock,
              tick_seconds: float = 0.002,
              on_tick=None) -> LoadResult:
    """Drive ``scheduler`` (constructed on ``clock``) through
    ``trace`` open-loop: each tick submits every arrival whose time
    has come, runs ONE scheduler step, and advances virtual time by
    ``tick_seconds``; an idle scheduler jumps straight to the next
    arrival. Returns when the trace is exhausted and the scheduler
    has drained. ``on_tick()`` (no arguments) runs after every step."""
    if tick_seconds <= 0:
        raise ServeContractError(
            f'tick_seconds must be > 0, got {tick_seconds}')
    t0 = time.perf_counter()
    start = clock()
    submitted, rejected = [], {}
    i = 0
    ticks = 0
    busy = True
    while i < len(trace) or busy:
        now = clock()
        while i < len(trace) and trace[i].at <= now:
            a = trace[i]
            i += 1
            submitted.append((a.request_id, a.tenant))
            deadline = (None if a.deadline_s is None
                        else a.at + a.deadline_s)
            try:
                scheduler.submit(a.prompt,
                                 max_new_tokens=a.max_new_tokens,
                                 deadline=deadline,
                                 request_id=a.request_id,
                                 tenant=a.tenant)
            except RejectedError as e:
                rejected[a.request_id] = e.reason
        busy = scheduler.step()
        ticks += 1
        if on_tick is not None:
            on_tick()
        clock.advance(tick_seconds)
        if not busy and i < len(trace) and trace[i].at > clock():
            # Idle gap: jump to the next arrival instead of spinning
            # empty ticks through it (open-loop, but not busy-waiting).
            clock.advance(trace[i].at - clock())
    n = len(trace)
    span = (trace[-1].at - trace[0].at) if n > 1 else 0.0
    return LoadResult(
        submitted=submitted, rejected_at_submit=rejected,
        results=dict(scheduler.results),
        virtual_seconds=clock() - start,
        wall_seconds=time.perf_counter() - t0,
        offered_rate=(n / span if span > 0 else float('inf')),
        ticks=ticks)


def run_load(cfg: LoadGenConfig, *, engine, serve_config=None,
             registry=None, event_log=None, fault_injector=False,
             clock=None, policy=None, control=None) -> LoadResult:
    """One-call surface: generate the trace for ``cfg``, build a
    virtual-clock :class:`Scheduler` over ``engine`` (watchdog off —
    real-time heartbeats are meaningless in virtual time), run it, and
    close it. ``event_log`` should share the virtual clock so its
    ``ts`` stamps line up with the scheduler's observations (pass an
    EventLog built with ``clock=VirtualClock`` or let this function
    re-point it). ``fault_injector=False`` = explicitly unfaulted
    (the default trace is a LOAD experiment, not a fault one); pass an
    injector to combine both.

    ``policy`` (a :class:`~distributed_dot_product_tpu_torch.serve.policy
    .PolicyConfig`) arms fair-share/priority admission and
    deadline-aware eviction. ``control`` (the reference's closed-loop
    controller) is not ported yet and raises ``NotImplementedError``."""
    if control is not None:
        raise NotImplementedError(
            'run_load(control=...) needs the closed-loop Controller '
            '(serve/control.py), not ported yet: ROADMAP.md §1 item 4b')
    cfg.validate()
    clock = clock or VirtualClock()
    if event_log is not None:
        # One time base for stamps and envelopes: goodput math uses
        # the stamped observations, but operators correlate on ts.
        event_log.clock = clock
    serve_config = serve_config or ServeConfig(
        queue_limit=16, max_new_tokens=max(t.new_hi
                                           for t in cfg.tenants))
    if serve_config.watchdog or (policy is not None
                                 and serve_config.policy is None):
        serve_config = dataclasses.replace(
            serve_config, watchdog=False,
            policy=serve_config.policy or policy)
    trace = generate_trace(cfg)
    sched = Scheduler(engine, serve_config, clock=clock,
                      registry=registry, event_log=event_log,
                      fault_injector=fault_injector)
    try:
        return run_trace(sched, trace, clock,
                         tick_seconds=cfg.tick_seconds)
    finally:
        sched.close()
