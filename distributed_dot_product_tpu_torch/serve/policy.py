# -*- coding: utf-8 -*-
"""
Scheduling policy for the serving loop — the layer that decides WHO is
served when capacity is contested, extending the mechanical
degrade→evict→reject ladder (scheduler.py) with intent:

- **Priority classes + per-tenant fair share** (:meth:`SchedulingPolicy
  .select`): when free slots pull from the admission queue, the next
  request comes from the highest-priority class present; within a
  class, from the tenant holding the smallest weighted share of slots
  (held / weight — the classic weighted-fair-queueing argmin over the
  live slot table); within a tenant, FIFO. A burst from one tenant can
  no longer starve another of its share, and a carpool-lane tenant
  (higher ``priority``) always boards first.
- **Deadline-aware eviction** (:meth:`SchedulingPolicy
  .eviction_victim`): when the ladder must evict (queue full, page
  deficit), predict each running request's finish time from its
  remaining token budget and the LIVE inter-token-gap percentile, and
  evict one that will miss its deadline anyway — a stream that was
  already lost, instead of the longest-idle one that might still be
  delivered in-SLO. Falls back to longest-idle when nobody is
  provably doomed (the mechanical rung is unchanged as rung two).
- **Chunked-prefill/decode interleaving tuned against the measured
  TTFT histogram** (:meth:`SchedulingPolicy.prefill_chunks`): the
  scheduler normally appends ONE prompt chunk per slot per tick; when
  the live TTFT p99 runs past ``target_ttft``, prefilling slots get up
  to ``max_prefill_boost`` chunks per tick — prompts reach their first
  token sooner at a bounded cost to inter-token gaps, and the boost
  collapses back to 1 the moment TTFT recovers.

Everything here is a pure function of the injected inputs (the queue,
the slot table, the clock reading, histogram percentiles) — no wall
clock, no host randomness — so a policy-scheduled run replays
bit-identically under the loadgen's virtual clock, and the CI goodput
gate grades policy changes deterministically.

Copied from ``distributed_dot_product_tpu/serve/policy.py``: the
decisions are the reference's, input for input.
"""

import dataclasses
import math
from typing import Dict, Optional

__all__ = ['TenantPolicy', 'PolicyConfig', 'SchedulingPolicy']

# determlint: selection and eviction run inside the scheduler tick —
# they derive everything from the injected clock/queue/histograms.
GRAPHLINT_TICK_ROOTS = ('SchedulingPolicy.select',
                        'SchedulingPolicy.eviction_victim',
                        'SchedulingPolicy.prefill_chunks')


@dataclasses.dataclass
class TenantPolicy:
    """One tenant's service class. ``priority``: strict class — higher
    admits first, whatever the shares say. ``weight``: fair-share
    weight within a priority class (a weight-2 tenant is entitled to
    twice the slots of a weight-1 tenant under contention)."""
    priority: int = 0
    weight: float = 1.0

    def validate(self, name):
        if not self.weight > 0:
            raise ValueError(f'tenant {name!r}: weight must be > 0, '
                             f'got {self.weight}')


@dataclasses.dataclass
class PolicyConfig:
    """Knobs of the policy layer. ``tenants`` maps tenant name →
    :class:`TenantPolicy`; unnamed tenants get ``default``.
    ``fair_share=False`` keeps FIFO admission (priority classes and
    eviction/interleaving still apply). ``deadline_eviction=False``
    keeps the mechanical longest-idle rung. ``target_ttft`` (seconds,
    scheduler clock) arms the prefill-interleave boost; None disables
    it. ``gap_percentile`` picks which live gap percentile predicts a
    stream's pace (p50 = typical; p99 = conservative)."""
    tenants: Dict[str, TenantPolicy] = dataclasses.field(
        default_factory=dict)
    default: TenantPolicy = dataclasses.field(
        default_factory=TenantPolicy)
    fair_share: bool = True
    deadline_eviction: bool = True
    target_ttft: Optional[float] = None
    max_prefill_boost: int = 4
    gap_percentile: int = 50

    def validate(self):
        for name, t in self.tenants.items():
            t.validate(name)
        self.default.validate('default')
        if self.max_prefill_boost < 1:
            raise ValueError(f'max_prefill_boost must be >= 1, got '
                             f'{self.max_prefill_boost}')
        if not 0 < self.gap_percentile <= 100:
            raise ValueError(f'gap_percentile must be in (0, 100], got '
                             f'{self.gap_percentile}')


class SchedulingPolicy:
    """The policy engine the scheduler consults (see module
    docstring). Stateless between calls — every decision is recomputed
    from the live inputs, so there is no drift to reconcile after
    preemptions, drains or controller knob changes."""

    def __init__(self, config: Optional[PolicyConfig] = None):
        self.cfg = config or PolicyConfig()
        self.cfg.validate()

    def tenant(self, name) -> TenantPolicy:
        return self.cfg.tenants.get(name, self.cfg.default)

    # -- fair-share admission -------------------------------------------
    def select(self, queued, held_by_tenant) -> int:
        """Index into ``queued`` (live, deadline-checked Requests in
        FIFO order) of the next request to admit. ``held_by_tenant``
        maps tenant → slots currently held (the scheduler's live slot
        table). Strict priority first; then the smallest weighted
        share ``held / weight``; then FIFO."""
        if not queued:
            raise ValueError('select() needs a non-empty queue')
        if not self.cfg.fair_share and not self.cfg.tenants:
            return 0

        def key(i):
            req = queued[i]
            pol = self.tenant(req.tenant)
            share = (held_by_tenant.get(req.tenant, 0) / pol.weight
                     if self.cfg.fair_share else 0.0)
            return (-pol.priority, share, i)

        return min(range(len(queued)), key=key)

    # -- deadline-aware eviction ----------------------------------------
    def predicted_finish(self, now, produced, max_new_tokens,
                         gap_estimate):
        """When the stream's LAST token lands, predicted from the
        remaining budget at the live pace."""
        remaining = max(0, max_new_tokens - produced)
        return now + remaining * max(0.0, gap_estimate)

    def eviction_victim(self, candidates, now, gap_estimate):
        """Among ``candidates`` — ``(slot, request, produced)`` tuples
        for busy slots — the one whose request is predicted to miss
        its deadline anyway (largest predicted overshoot wins: the
        most-lost stream frees capacity for streams still in SLO), or
        None when nobody is provably doomed (caller falls back to
        longest-idle). A finite gap estimate is required to call a
        stream doomed — with no pace signal yet, predicting a miss
        would evict on a guess."""
        if not self.cfg.deadline_eviction or not candidates \
                or not math.isfinite(gap_estimate):
            return None
        doomed = []
        for slot, req, produced in candidates:
            if req.deadline is None:
                continue
            finish = self.predicted_finish(now, produced,
                                           req.max_new_tokens,
                                           gap_estimate)
            if finish > req.deadline:
                doomed.append((finish - req.deadline, slot))
        if not doomed:
            return None
        return max(doomed, key=lambda ds: (ds[0], ds[1].index))[1]

    # -- prefill/decode interleaving ------------------------------------
    def prefill_chunks(self, ttft_p99) -> int:
        """Prompt chunks each prefilling slot may append this tick: 1
        normally; scaled up toward ``max_prefill_boost`` as the live
        TTFT p99 runs past ``target_ttft`` (2x the target saturates
        the boost). NaN p99 (no TTFT observed yet) stays at 1."""
        target = self.cfg.target_ttft
        if target is None or ttft_p99 is None \
                or not math.isfinite(ttft_p99) or ttft_p99 <= target:
            return 1
        frac = min(1.0, (ttft_p99 - target) / target)
        return 1 + int(round(frac * (self.cfg.max_prefill_boost - 1)))
