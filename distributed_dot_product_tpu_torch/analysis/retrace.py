# -*- coding: utf-8 -*-
"""
Retrace sentinel: signature budgets for the serving and decode programs
— the port of ``distributed_dot_product_tpu/analysis/retrace.py``, with
the same API.

The hazard class: a per-token step that silently changes what it runs
on every call. In the reference that is a jitted step re-tracing per
call (an unhashable module field made ``decode_seq_parallel`` rebuild
and re-trace its compiled step EVERY token; the LRU step cache in
models/attention.py is the fix). The port runs eagerly, and the same
discipline is what a captured CUDA graph needs: a fixed-shape step
keeps its shapes, dtypes and devices from call to call.

So a *trace* here is the first call with a new input SIGNATURE — what
``jax.jit`` keys its cache on: each tensor (or numpy array) argument's
shape, dtype and device, the structure of tuples, lists, dicts and
named tuples around them, and the hashable non-tensor arguments by
value. Python numbers count as 0-d arrays, keyed by their type and not
their value, as ``jax.jit`` traces them. Wrap a step with
:func:`watch_traces`: the wrapper keeps the signatures it has seen,
counts each new one, and raises :class:`RetraceBudgetExceeded` the
moment a step sees more signatures than its declared budget. A
fixed-shape step counts 1 however many tokens it serves; a step rebuilt
per token gets a fresh counter each time, and :func:`total` over its
name exposes the storm.

Enablement: the ``DDP_TPU_RETRACE_SENTINEL`` env var (1/0). Unset, the
sentinel is ON under pytest (``PYTEST_CURRENT_TEST`` present — every
decode/serve suite then runs under its budgets, which is the point:
signature storms become test failures, not perf mysteries) and OFF
otherwise (production keeps counting — the counters are cheap and
:func:`snapshot` exposes them — but never raises).

Budget semantics: a budget of ``n`` allows ``n`` signatures over the
wrapper's lifetime. Per-token loops own ONE wrapper per step (e.g.
``make_decode_step`` wraps at build time), so legitimate shape-driven
new signatures of a *new* step get a fresh budget while the per-token
storm on a single step trips immediately.
"""

import collections
import functools
import os
import threading
import weakref

__all__ = ['RetraceBudgetExceeded', 'TraceCounter', 'watch_traces',
           'sentinel_enabled', 'snapshot', 'total', 'totals', 'reset',
           'signature', 'ENV_VAR']

ENV_VAR = 'DDP_TPU_RETRACE_SENTINEL'


class RetraceBudgetExceeded(RuntimeError):
    """A watched entrypoint saw more input signatures than its declared
    budget."""


def sentinel_enabled():
    """Raise-on-exceed policy: the env var wins; unset, on under pytest
    (so the suites enforce budgets) and off elsewhere (counters still
    count — see :func:`snapshot`)."""
    v = os.environ.get(ENV_VAR)
    if v is not None:
        return v.strip().lower() in ('1', 'true', 'on', 'yes')
    return 'PYTEST_CURRENT_TEST' in os.environ


class TraceCounter:
    """Count + budget for one watched callable (thread-safe: serving
    watchdog threads may trigger traces)."""

    __slots__ = ('name', 'budget', 'count', '_lock', '__weakref__')

    def __init__(self, name, budget):
        if budget < 1:
            raise ValueError(f'trace budget must be >= 1, got {budget}')
        self.name = name
        self.budget = budget
        self.count = 0
        self._lock = threading.Lock()

    def __del__(self):
        # Hand the final count to the per-name retired total so total()
        # stays exact however the GC times wrapper teardown (the
        # rebuild-storm path discards one wrapper per token). No lock
        # here: a watched step lives in a reference cycle with its engine
        # or module, so the cyclic collector may finalize it at any
        # allocation — inside a section that holds _COUNTERS_LOCK, too.
        # The append is atomic; the readers fold it in (_live_counters).
        try:
            _DYING.append((self.name, self.count))
        except Exception:  # graphlint: allow[silent-except]
            pass           # interpreter shutdown: globals may be gone

    def hit(self):
        with self._lock:
            self.count += 1
            count = self.count
        if count > self.budget and sentinel_enabled():
            raise RetraceBudgetExceeded(
                f'retrace budget exceeded: {self.name!r} traced {count} '
                f'times (budget {self.budget}). A decode/serve step '
                f'whose input signature changes per call cannot keep one '
                f'captured program — hold ONE step across calls at fixed '
                f'shapes (check for per-call shapes, python-object keys, '
                f'or a step rebuilt inside the token loop).')


# Counter registry for snapshot()/total()/reset() and the pytest
# fixture: WEAK references, so a counter lives exactly as long as its
# wrapper (the pathological case the sentinel observes — a step rebuilt
# per token — discards one wrapper per token; holding them strongly
# here would turn the observer into its own leak). A dying counter hands
# its count to _DYING (TraceCounter.__del__), folded into the per-name
# _RETIRED total by the next reader, so total() is exact regardless of
# GC timing, and reset() always reaches every counter that could still
# raise.
_COUNTERS = []                   # weakref.ref(TraceCounter)
_RETIRED = {}                    # name -> folded count from dead
_DYING = collections.deque()     # (name, count) of finalized counters
_COUNTERS_LOCK = threading.Lock()


def _live_counters():
    """Strong refs to the live counters; prunes dead weakrefs in place
    and folds the dead counters' counts into _RETIRED (after the prune:
    a counter whose reference is dead has handed its count over).
    Callers must hold _COUNTERS_LOCK."""
    live, refs = [], []
    for ref in _COUNTERS:
        c = ref()
        if c is not None:
            live.append(c)
            refs.append(ref)
    _COUNTERS[:] = refs
    while _DYING:
        name, count = _DYING.popleft()
        _RETIRED[name] = _RETIRED.get(name, 0) + count
    return live


def signature(args, kwargs=None):
    """The key a call is counted under: tensors and numpy arrays by
    shape, dtype and device; tuples, lists, dicts and named tuples by
    structure; python and numpy numbers by kind — bool, int, float or
    complex (0-d arrays, as ``jax.jit`` traces them); every other
    hashable argument by value, an unhashable one by its type."""
    return (_sig(tuple(args)), _sig(dict(kwargs or {})))


def _sig(x):
    import numpy as np
    if hasattr(x, 'shape') and hasattr(x, 'dtype') \
            and not isinstance(x, np.generic):
        dev = getattr(x, 'device', 'host')
        return ('array', tuple(x.shape), str(x.dtype), str(dev))
    if isinstance(x, (bool, np.bool_)):
        return ('scalar', 'bool')
    if isinstance(x, (int, np.integer)):
        return ('scalar', 'int')
    if isinstance(x, (float, complex, np.number)):
        return ('scalar', 'float' if isinstance(x, (float, np.floating))
                else 'complex')
    if isinstance(x, tuple):
        return (type(x).__name__, tuple(_sig(v) for v in x))
    if isinstance(x, list):
        return ('list', tuple(_sig(v) for v in x))
    if isinstance(x, dict):
        return ('dict', tuple(sorted((repr(k), _sig(v))
                                     for k, v in x.items())))
    try:
        hash(x)
    except TypeError:
        return ('opaque', type(x).__name__)
    return ('static', x)


def watch_traces(fn, name, budget=2):
    """Wrap a step so that every call with a new input signature
    (:func:`signature`) counts against ``budget``. Returns the wrapped
    callable; call THAT in place of the step::

        self._decode = watch_traces(self._decode_impl, 'engine.decode',
                                    budget=2)

    The counter rides the wrapper as ``_graphlint_counter`` (tests and
    budget assertions read it)."""
    counter = TraceCounter(name, budget)
    with _COUNTERS_LOCK:
        _live_counters()             # prune dead refs opportunistically
        _COUNTERS.append(weakref.ref(counter))
    seen = set()

    @functools.wraps(fn)
    def counted(*args, **kwargs):
        key = signature(args, kwargs)
        if key not in seen:
            seen.add(key)
            counter.hit()
        return fn(*args, **kwargs)

    counted._graphlint_counter = counter
    return counted


def snapshot():
    """``{name: (count, budget)}`` over every live counter (names can
    repeat across instances; later registrations win the key — use the
    per-wrapper ``_graphlint_counter`` for exact assertions)."""
    with _COUNTERS_LOCK:
        return {c.name: (c.count, c.budget) for c in _live_counters()}


def total(name):
    """Cumulative trace count across EVERY counter registered under
    ``name`` (live + folded-at-death). Per-instance budgets can't see
    the rebuild-storm variant (a step rebuilt per token gets a fresh
    counter each time — each counts 1); the name total exposes it: N
    tokens through a properly cached step total 1 trace, through a
    rebuilt-per-token step they total N. tests/test_torch_retrace.py
    pins both numbers for decode_seq_parallel's LRU step cache."""
    with _COUNTERS_LOCK:
        live = _live_counters()
        return (_RETIRED.get(name, 0)
                + sum(c.count for c in live if c.name == name))


def totals():
    """``{name: cumulative count}`` over EVERY name ever watched —
    live counters plus the folded-at-death totals. Unlike
    :func:`snapshot` (live only), the key set is stable across GC
    timing, which is what lets a before/after diff of this mapping
    (obs/perf.py's snapshot accounting) be deterministic regardless of
    what the process traced — and retired — earlier."""
    with _COUNTERS_LOCK:
        live = _live_counters()
        out = dict(_RETIRED)
        for c in live:
            out[c.name] = out.get(c.name, 0) + c.count
        return out


def reset():
    """Zero every live counter and the folded totals (test isolation —
    the pytest fixture calls this so one test's traces never charge
    another's budget; weak registration means every counter that could
    still raise is reachable here)."""
    with _COUNTERS_LOCK:
        for c in _live_counters():
            c.count = 0
        _RETIRED.clear()
        _DYING.clear()
