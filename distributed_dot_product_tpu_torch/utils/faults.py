# -*- coding: utf-8 -*-
"""
Deterministic serving-path fault injection — ``ServeFaultPlan``,
``serve_plan_from_env``, ``burst_prompts`` and ``ServeFaultInjector``,
copied from ``distributed_dot_product_tpu/utils/faults.py``. The
scheduler calls the injector's hooks at its seams: a stuck decode step
(the watchdog must fire), NaN logits in one slot (the per-slot
quarantine must absorb them), and a client abandoning mid-stream.

Env knobs (read by :func:`serve_plan_from_env`; the scheduler reads
them when no injector is passed): ``DDP_TPU_FAULT_STUCK_STEP``,
``_STUCK_SECONDS``, ``_NAN_DECODE_STEP``, ``_NAN_DECODE_SLOT``,
``_ABANDON_REQUEST``, ``_ABANDON_AFTER``, ``_BURST``, ``_NAN_REPEAT``.
"""

import dataclasses
import os
import time
from typing import Optional

from distributed_dot_product_tpu_torch.obs import events as obs_events

__all__ = ['ServeFaultPlan', 'ServeFaultInjector', 'serve_plan_from_env',
           'burst_prompts']

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
