# -*- coding: utf-8 -*-
"""Seeded determlint regressions: real-time / random / environment
reads inside a declared virtual-clock tick path (and transitively
through an intra-module helper), plus a loop-blocking sleep."""
import os
import random
import time

GRAPHLINT_TICK_ROOTS = ('drive',)


def drive(scheduler, clock, trace):
    t0 = time.time()                     # VIOLATION: tick-determinism
    jitter = random.random()             # VIOLATION: tick-determinism
    debug = os.environ.get('FX_DEBUG')   # VIOLATION: tick-determinism
    _throttle(scheduler)
    while trace:
        scheduler.submit(trace.pop(0))
        scheduler.step()
        clock.advance(0.002)
    return t0, jitter, debug


def _throttle(scheduler):
    # Reached through the closure from `drive` — flagged transitively.
    time.sleep(0.01)                     # VIOLATION: tick-determinism


def fine_outside_closure(cfg):
    # Not reachable from a tick root: real time is fine here.
    return time.time()
