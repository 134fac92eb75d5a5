# -*- coding: utf-8 -*-
"""
conclint: lock-discipline and thread-discipline for the serving/obs
concurrency surface — the servelint family that machine-checks the
convention the EventLog tee, SpanCollector, MetricsRegistry and
HealthMonitor already follow by hand.

The port's copy of ``distributed_dot_product_tpu/analysis/conclint.py``:
the same rules and rule ids, with the package name, scopes and
tables rewritten for ``distributed_dot_product_tpu_torch``.

- ``guarded-by`` — a field ANNOTATED at its assignment site with a
  trailing ``# guarded-by: self._lock`` comment may only be read or
  written inside a ``with self._lock:`` block of the same class.
  Exemptions, by convention:

  * ``__init__`` (construction happens before the object is shared);
  * methods whose name ends in ``_locked`` (the caller holds the lock
    — ``EventLog._rotate_locked`` is the canonical case);
  * an explicit ``# graphlint: allow[guarded-by]`` pragma for the
    deliberate torn-read sites (the scheduler's watchdog-thread
    introspection documents exactly why it reads without locks).

  The annotation is declarative: it rides the line that assigns the
  field (usually in ``__init__``), so the lock contract lives NEXT TO
  the state it protects and a new method touching the field off-lock
  fails CI instead of racing in production.

- ``thread-discipline`` — every ``threading.Thread(...)`` construction
  must pass ``daemon=True`` (a non-daemon worker blocks interpreter
  shutdown when a compiled step wedges — the exact situation the
  watchdog exists for) and a ``name=`` (anonymous threads are
  unidentifiable in the flight recorder's ``stacks.json``).

Scope: the package (``distributed_dot_product_tpu_torch/``) plus explicitly
named ``graphlint_fixtures`` files — tests spawn short-lived helper
threads that legitimately join before teardown.

Suppression: ``# graphlint: allow[<rule>]`` on the line or the line
above (see analysis/base.py).
"""

import ast
import os
import re

from distributed_dot_product_tpu_torch.analysis.base import (
    Violation, allowed_by_pragma,
)

__all__ = ['CONC_RULES', 'lint_file', 'lint_paths']

CONC_RULES = ('guarded-by', 'thread-discipline')

_SCOPE_FRAGMENTS = ('distributed_dot_product_tpu_torch' + os.sep,
                    'graphlint_fixtures')

_GUARDED_BY = re.compile(r'#\s*guarded-by:\s*(self\.[A-Za-z_][\w.]*)')


def _annotations(cls_node, lines):
    """``{field: lock_expr}`` from ``self.<field> = ...`` assignment
    lines carrying a ``# guarded-by:`` comment anywhere in the class
    body (typically ``__init__``)."""
    guarded = {}
    for node in ast.walk(cls_node):
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            targets = [node.target]
        else:
            continue
        m = _GUARDED_BY.search(lines[node.lineno - 1]) \
            if node.lineno <= len(lines) else None
        if not m:
            continue
        for tgt in targets:
            if (isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == 'self'):
                guarded[tgt.attr] = m.group(1)
    return guarded


class _LockScopeChecker(ast.NodeVisitor):
    """Walk one method tracking which annotated locks are held (via
    ``with self._lock:`` nesting) and flag annotated-field accesses
    made while their lock is not."""

    def __init__(self, guarded, rel, lines, out):
        self.guarded = guarded          # field -> lock expr string
        self.rel = rel
        self.lines = lines
        self.out = out
        self.held = []                  # stack of held lock exprs

    # A function DEFINED inside a `with self._lock:` block does not
    # RUN there — the classic deferred race is exactly a closure built
    # under the lock and executed later as a thread target. Its body
    # is judged with an empty held stack.
    def visit_FunctionDef(self, node):
        inner = _LockScopeChecker(self.guarded, self.rel, self.lines,
                                  self.out)
        for stmt in node.body:
            inner.visit(stmt)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        inner = _LockScopeChecker(self.guarded, self.rel, self.lines,
                                  self.out)
        inner.visit(node.body)

    def visit_With(self, node):
        acquired = []
        for item in node.items:
            try:
                expr = ast.unparse(item.context_expr)
            except Exception:   # graphlint: allow[silent-except] ast-only
                expr = ''
            acquired.append(expr)
        self.held.extend(acquired)
        for stmt in node.body:
            self.visit(stmt)
        del self.held[len(self.held) - len(acquired):]

    visit_AsyncWith = visit_With

    def visit_Attribute(self, node):
        if (isinstance(node.value, ast.Name) and node.value.id == 'self'
                and node.attr in self.guarded
                and self.guarded[node.attr] not in self.held
                and not allowed_by_pragma(self.lines, node.lineno,
                                          'guarded-by')):
            lock = self.guarded[node.attr]
            kind = ('write' if isinstance(node.ctx,
                                          (ast.Store, ast.Del))
                    else 'read')
            self.out.append(Violation(
                rule='guarded-by', file=self.rel, line=node.lineno,
                message=f'{kind} of self.{node.attr} (annotated '
                        f'guarded-by: {lock}) outside a `with {lock}:` '
                        f'block — another thread can observe torn '
                        f'state; take the lock or rename the method '
                        f'*_locked if the caller holds it'))
        self.generic_visit(node)


def _check_guarded(tree, rel, lines, out):
    for cls in [n for n in ast.walk(tree)
                if isinstance(n, ast.ClassDef)]:
        guarded = _annotations(cls, lines)
        if not guarded:
            continue
        for method in cls.body:
            if not isinstance(method, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                continue
            if method.name == '__init__' \
                    or method.name.endswith('_locked'):
                continue
            checker = _LockScopeChecker(guarded, rel, lines, out)
            for stmt in method.body:
                checker.visit(stmt)


def _kw(node, name):
    for kw in node.keywords:
        if kw.arg == name:
            return kw
    return None


def _check_threads(tree, rel, lines, out):
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        name = (fn.attr if isinstance(fn, ast.Attribute)
                else getattr(fn, 'id', None))
        root = (fn.value.id if isinstance(fn, ast.Attribute)
                and isinstance(fn.value, ast.Name) else None)
        if name != 'Thread' or (root is not None
                                and root != 'threading'):
            continue
        if allowed_by_pragma(lines, node.lineno, 'thread-discipline'):
            continue
        problems = []
        daemon = _kw(node, 'daemon')
        if daemon is None or not (isinstance(daemon.value, ast.Constant)
                                  and daemon.value.value is True):
            problems.append('daemon=True (a non-daemon worker blocks '
                            'interpreter shutdown on a wedged step)')
        if _kw(node, 'name') is None:
            problems.append('name= (anonymous threads are invisible '
                            'in flight-recorder stack dumps)')
        if problems:
            out.append(Violation(
                rule='thread-discipline', file=rel, line=node.lineno,
                message='threading.Thread(...) must pass '
                        + ' and '.join(problems)))


def lint_file(path, repo_root=None, rules=None):
    """Run the conclint ruleset over one file; returns a Violation
    list. Files outside the package / fixture scope return []."""
    rules = set(rules or CONC_RULES)
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
    lines = src.splitlines()
    out = []
    if 'guarded-by' in rules:
        _check_guarded(tree, rel, lines, out)
    if 'thread-discipline' in rules:
        _check_threads(tree, rel, lines, out)
    return out


def lint_paths(paths, repo_root=None, rules=None):
    from distributed_dot_product_tpu_torch.analysis.astlint import (
        iter_python_files,
    )
    out = []
    for path in iter_python_files(paths):
        out.extend(lint_file(path, repo_root=repo_root, rules=rules))
    return out
