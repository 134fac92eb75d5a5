# -*- coding: utf-8 -*-
"""
determlint: the seeded bit-reproducible-replay contract, machine-checked
— the servelint family guarding the virtual-clock tick paths.

The port's copy of ``distributed_dot_product_tpu/analysis/determlint.py``:
the same rules and rule ids, with the package name, scopes and
tables rewritten for ``distributed_dot_product_tpu_torch``.

The serving layer's replay story (loadgen → scheduler → router) rests on
one invariant: inside a tick path, every observable value derives from
the injected clock and the seeded trace, never from the host's wall
clock, the ``random`` module, or the process environment. A single
``time.time()`` in a tick path silently turns "same seed, identical
goodput report" into "same seed, usually identical".

Mechanics:

- A module DECLARES its tick roots with a module-level literal::

      GRAPHLINT_TICK_ROOTS = ('Scheduler.step', 'Scheduler.submit')

  (function names, or ``Class.method`` qualnames). determlint computes
  the intra-module call closure of those roots — ``self._foo()`` to
  methods of the same class, bare calls to module functions — and
  flags, anywhere in the closure:

  * real-time reads: ``time.time/monotonic/perf_counter/process_time``
    and ``time.sleep`` (a sleep additionally blocks the loop);
  * ``random.*`` and ``np.random.*`` calls (unseeded host randomness —
    seeded generators are constructed OUTSIDE the tick and passed in);
  * ``os.environ`` reads / ``os.getenv`` (config resolution belongs at
    construction time, where it is recorded, not per tick).

- Modules that are intentionally REAL-TIME (the health watchdog judges
  liveness in wall time by contract; devmon polls; flight throttles;
  anomaly cooldowns) are declared in :data:`REAL_TIME_CONTRACT` below —
  a per-module table with reasons, not scattered pragmas. ``'*'``
  exempts the whole module (it must then declare no tick roots);
  a ``{qualname: reason}`` dict waives individual functions inside a
  tick closure (the scheduler's step-duration histogram measures the
  REAL cost of the compiled step — that is the point of the metric).

- Any module that declares tick roots is additionally swept for
  ``time.sleep`` OUTSIDE the closure too: a sleep anywhere in a
  tick-path module stalls the loop that module drives.

Suppression: the contract table is the intended mechanism; a trailing
``# graphlint: allow[tick-determinism]`` pragma still works for
one-off sites (see analysis/base.py).
"""

import ast
import os

from distributed_dot_product_tpu_torch.analysis.base import (
    Violation, allowed_by_pragma,
)

__all__ = ['DETERM_RULES', 'REAL_TIME_CONTRACT', 'lint_file',
           'lint_paths']

DETERM_RULES = ('tick-determinism',)

_SCOPE_FRAGMENTS = ('distributed_dot_product_tpu_torch' + os.sep,
                    'graphlint_fixtures')

# The per-module real-time contract (repo-relative path suffix, '/'
# separators). '*' = the whole module is real-time BY DESIGN (it must
# not declare tick roots); {qualname: reason} = these functions inside
# a tick closure may read real time, for the stated reason. This table
# is the allowlist the README documents — adding to it is a reviewed
# design decision, not a pragma sprinkle.
REAL_TIME_CONTRACT = {
    'serve/health.py': '*',     # the watchdog judges liveness in REAL
    #   time independently of the scheduler clock — a virtual-clock
    #   test must not self-trigger stalls (module docstring contract)
    'obs/devmon.py': '*',       # device polling + profiler capture
    #   windows are wall-time by nature
    'obs/flight.py': '*',       # ring sample throttle and per-trigger
    #   dump cooldowns are REAL seconds (storm control)
    'obs/anomaly.py': '*',      # detector tick throttle and breach
    #   cooldowns are REAL seconds
    'obs/spans.py': '*',        # spans measure host wall time — that
    #   is their one job
    'serve/scheduler.py': {
        'Scheduler._step_impl':
            'serve.step_seconds measures the REAL cost of the compiled '
            'decode dispatch (time.perf_counter) — virtual ticks would '
            'record the simulation, not the hardware',
        'Scheduler._maybe_profile':
            'the adaptive-profile cooldown is REAL time by design '
            '(captures are real however the scheduler clock runs)',
    },
    'serve/loadgen.py': {
        'run_trace':
            'wall_seconds is reporting-only wall-clock accounting '
            '(time.perf_counter) — it never feeds control flow or the '
            'virtual timeline',
    },
    'serve/router.py': {
        'Router._handoff':
            'the prefill.handoff build/transfer split measures the '
            'REAL cost of KV compute vs page movement '
            '(time.perf_counter) — reporting-only additive event '
            'fields, never control flow or the virtual timeline',
    },
}

_TIME_FNS = {'time', 'monotonic', 'sleep', 'perf_counter',
             'process_time', 'thread_time'}


def _module_key(rel):
    """Normalized '/'-separated repo-relative path for table lookup."""
    return rel.replace(os.sep, '/')


def _contract_for(rel):
    key = _module_key(rel)
    for suffix, entry in REAL_TIME_CONTRACT.items():
        if key.endswith(suffix):
            return entry
    return None


def _tick_roots(tree):
    """``(roots, bad_lineno)``: the module's ``GRAPHLINT_TICK_ROOTS``
    literal, or ``((), lineno)`` when the declaration exists but is not
    a literal — the caller reports that, because a computed declaration
    silently disabling the whole check would be the worst failure mode
    this rule can have."""
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) \
                        and tgt.id == 'GRAPHLINT_TICK_ROOTS':
                    try:
                        val = ast.literal_eval(node.value)
                    except (ValueError, SyntaxError):
                        return (), node.lineno
                    return tuple(str(v) for v in val), None
    return (), None


def _functions_by_qualname(tree):
    """``{qualname: FunctionDef}`` for module functions and class
    methods (one level of class nesting — the shape this codebase
    uses)."""
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    out[f'{node.name}.{sub.name}'] = sub
    return out


def _callees(qualname, fn_node, functions):
    """Intra-module callees of one function: ``self._foo()`` resolves
    into the same class, bare ``foo()`` into module functions."""
    cls = qualname.split('.')[0] if '.' in qualname else None
    found = set()
    for node in ast.walk(fn_node):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if (cls is not None and isinstance(fn, ast.Attribute)
                and isinstance(fn.value, ast.Name)
                and fn.value.id == 'self'):
            cand = f'{cls}.{fn.attr}'
            if cand in functions:
                found.add(cand)
        elif isinstance(fn, ast.Name) and fn.id in functions:
            found.add(fn.id)
    return found


def _closure(roots, functions):
    """Transitive intra-module call closure of the declared roots."""
    seen, stack = set(), [r for r in roots if r in functions]
    while stack:
        qn = stack.pop()
        if qn in seen:
            continue
        seen.add(qn)
        stack.extend(_callees(qn, functions[qn], functions))
    return seen


def _nondeterministic_call(node):
    """(kind, detail) when ``node`` is a forbidden call, else None."""
    fn = node.func
    if isinstance(fn, ast.Attribute):
        root = fn.value.id if isinstance(fn.value, ast.Name) else None
        inner = (fn.value.attr if isinstance(fn.value, ast.Attribute)
                 else None)
        inner_root = (fn.value.value.id
                      if isinstance(fn.value, ast.Attribute)
                      and isinstance(fn.value.value, ast.Name) else None)
        if root == 'time' and fn.attr in _TIME_FNS:
            return ('real-time read', f'time.{fn.attr}()')
        if root == 'random':
            return ('host randomness', f'random.{fn.attr}()')
        if inner == 'random' and inner_root in ('np', 'numpy'):
            return ('host randomness', f'{inner_root}.random.{fn.attr}()')
        if root == 'os' and fn.attr == 'getenv':
            return ('environment read', 'os.getenv()')
        if (fn.attr == 'get' and inner == 'environ'
                and inner_root == 'os'):
            return ('environment read', 'os.environ.get()')
    return None


def _environ_subscript(node):
    """``os.environ[...]`` reads (not calls)."""
    return (isinstance(node, ast.Subscript)
            and isinstance(node.value, ast.Attribute)
            and node.value.attr == 'environ'
            and isinstance(node.value.value, ast.Name)
            and node.value.value.id == 'os')


def lint_file(path, repo_root=None, rules=None):
    """Run determlint over one file; returns a Violation list. Files
    outside the package / fixture scope, and modules declared wholly
    real-time in :data:`REAL_TIME_CONTRACT`, return []."""
    rules = set(rules or DETERM_RULES)
    if 'tick-determinism' not in rules:
        return []
    rel = (os.path.relpath(path, repo_root) if repo_root
           else os.fspath(path))
    if not any(frag in rel for frag in _SCOPE_FRAGMENTS):
        return []
    with open(path, encoding='utf-8') as f:
        src = f.read()
    try:
        tree = ast.parse(src, filename=rel)
    except SyntaxError:
        return []       # astlint owns parse-error reporting
    roots, bad_decl = _tick_roots(tree)
    contract = _contract_for(rel)
    out = []
    lines = src.splitlines()
    if bad_decl is not None:
        return [Violation(
            rule='tick-determinism', file=rel, line=bad_decl,
            message='GRAPHLINT_TICK_ROOTS must be a literal tuple/list '
                    'of function qualnames — a computed declaration '
                    'cannot be read statically and would silently '
                    'disable determinism checking for this module')]
    if contract == '*':
        if roots:
            out.append(Violation(
                rule='tick-determinism', file=rel, line=1,
                message=f'{_module_key(rel)} declares tick roots '
                        f'{roots} but is listed as wholly real-time in '
                        f'REAL_TIME_CONTRACT — a module cannot be '
                        f'both; fix the contract table'))
        return out
    if not roots:
        return []
    allow = contract if isinstance(contract, dict) else {}
    functions = _functions_by_qualname(tree)
    unknown = [r for r in roots if r not in functions]
    for r in unknown:
        out.append(Violation(
            rule='tick-determinism', file=rel, line=1,
            message=f'GRAPHLINT_TICK_ROOTS names {r!r} but no such '
                    f'function/method exists in this module — the '
                    f'declaration rotted'))
    closure = _closure(roots, functions)

    def flag(node, qualname, kind, detail):
        if allowed_by_pragma(lines, node.lineno, 'tick-determinism'):
            return
        out.append(Violation(
            rule='tick-determinism', file=rel, line=node.lineno,
            message=f'{detail}: {kind} inside the virtual-clock tick '
                    f'path ({qualname}, reachable from '
                    f'{"/".join(sorted(roots))}) breaks seeded '
                    f'bit-reproducible replay — derive it from the '
                    f'injected clock/trace, hoist it to construction '
                    f'time, or add a reviewed REAL_TIME_CONTRACT entry'))

    for qualname in sorted(closure):
        if qualname in allow:
            continue
        fn_node = functions[qualname]
        for node in ast.walk(fn_node):
            if isinstance(node, ast.Call):
                hit = _nondeterministic_call(node)
                if hit:
                    flag(node, qualname, *hit)
            elif _environ_subscript(node):
                flag(node, qualname, 'environment read',
                     'os.environ[...]')

    # Module-wide sleep sweep: a sleep ANYWHERE in a tick-path module
    # stalls the loop that module drives, closure or not.
    flagged = {v.line for v in out}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == 'sleep'
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == 'time'
                and node.lineno not in flagged
                and not allowed_by_pragma(lines, node.lineno,
                                          'tick-determinism')):
            out.append(Violation(
                rule='tick-determinism', file=rel, line=node.lineno,
                message='time.sleep() in a module that declares '
                        'virtual-clock tick roots blocks the serving '
                        'loop — use the injected clock / event waits'))
    return out


def lint_paths(paths, repo_root=None, rules=None):
    from distributed_dot_product_tpu_torch.analysis.astlint import (
        iter_python_files,
    )
    out = []
    for path in iter_python_files(paths):
        out.extend(lint_file(path, repo_root=repo_root, rules=rules))
    return out
