# -*- coding: utf-8 -*-
"""Seeded flowlint reason-coverage regression: a RejectReason member
no code path can produce (analysis/flowlint.py). The live members show
the full healthy ladder — a reference site, a ``serve.reject`` emit,
and the canonical dynamic per-reason counter loop; ``GHOST_CAUSE`` has
none of the first and flags as dead taxonomy."""

from enum import Enum


class RejectReason(Enum):
    QUEUE_FULL = 'queue_full'
    QUOTA_EXCEEDED = 'quota_exceeded'
    GHOST_CAUSE = 'ghost_cause'  # VIOLATION: reason-coverage


def admit(queue, log):
    if queue.full():
        _reject(log, RejectReason.QUEUE_FULL)
        return False
    return True


def charge(budget, log):
    if budget <= 0:
        _reject(log, RejectReason.QUOTA_EXCEEDED)
        return False
    return True


def _reject(log, reason):
    log.emit('serve.reject', **_payload(reason))


def _payload(reason):
    return {'reason': reason.value}


def install_counters(registry):
    # Dynamic per-member loop: covers the counter leg for EVERY
    # member, so GHOST_CAUSE flags only for its missing raise site.
    for r in RejectReason:
        registry.counter(f'serve.rejected.{r.value}')
