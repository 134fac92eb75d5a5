# -*- coding: utf-8 -*-
"""
protolint: static checks of the event-log PROTOCOL at every emit call
site — the servelint family that turns an EVENT_SCHEMA violation from
a ``ValueError`` mid-incident into a lint error at PR time.

The port's copy of ``distributed_dot_product_tpu/analysis/protolint.py``:
the same rules and rule ids, with the package name, scopes and
tables rewritten for ``distributed_dot_product_tpu_torch``.

``obs/events.py`` owns the closed vocabulary (:data:`EVENT_SCHEMA`) and
already validates every record at runtime; this module checks the same
contract *statically* against the call sites sprinkled through serve/,
obs/, utils/ and the train loop. Three rules:

- ``event-vocab``   — a LITERAL event kind passed to ``emit(...)`` /
  ``log.emit(...)`` / ``self._emit(...)`` must exist in EVENT_SCHEMA.
- ``event-fields``  — when the payload is statically complete (keyword
  arguments only, no ``**kwargs`` forwarding), every field the schema
  requires for that kind must be present. ``_log=`` is transport, not
  payload.
- ``reject-reason`` — the ``reason`` of a ``serve.reject`` must be a
  :class:`~distributed_dot_product_tpu_torch.serve.admission.RejectReason`
  member: a literal string must be one of the enum VALUES, and a
  ``RejectReason.X`` attribute must name a real member and end in
  ``.value`` (emitting the enum object would serialize as its repr).

Scope: the package itself (``distributed_dot_product_tpu_torch/``) plus the
negative-fixture tree (``graphlint_fixtures``) when its files are named
explicitly — tests legitimately emit malformed events on purpose to
exercise the runtime validator, so tests/ stays out of the sweep.

The schema and the enum are imported at lint time from the modules that
own them — the write-side contract, the offline validator and this
linter can never drift apart.

Suppression: ``# graphlint: allow[<rule>]`` on the line or the line
above (see analysis/base.py).
"""

import ast
import os

from distributed_dot_product_tpu_torch.analysis.base import (
    Violation, allowed_by_pragma,
)

__all__ = ['PROTO_RULES', 'lint_file', 'lint_paths']

PROTO_RULES = ('event-vocab', 'event-fields', 'reject-reason')

# Files protolint judges: the package plus explicitly-named fixtures.
# The analysis subtree is excluded — its AST checkers have their own
# internal `_emit(rule, ...)` helpers that are not event emits.
_SCOPE_FRAGMENTS = ('distributed_dot_product_tpu_torch' + os.sep,
                    'graphlint_fixtures')
_EXCLUDE_FRAGMENTS = ('distributed_dot_product_tpu_torch' + os.sep
                      + 'analysis' + os.sep,)

# Transport-level keywords of the emit surfaces — never payload fields.
_TRANSPORT_KWARGS = {'_log'}


def _schema():
    """The closed vocabulary, read from its owner at lint time."""
    from distributed_dot_product_tpu_torch.obs.events import EVENT_SCHEMA
    return EVENT_SCHEMA


def _reject_reasons():
    """``{member_name: value}`` of the typed-reject taxonomy."""
    from distributed_dot_product_tpu_torch.serve.admission import RejectReason
    return {r.name: r.value for r in RejectReason}


def _is_emit_call(node):
    """``emit('kind', ...)`` / ``<anything>.emit('kind', ...)`` /
    ``self._emit('kind', ...)`` with a LITERAL first argument — the
    wrapper definitions themselves forward a variable and are never
    judged."""
    fn = node.func
    name = (fn.id if isinstance(fn, ast.Name)
            else fn.attr if isinstance(fn, ast.Attribute) else None)
    if name not in ('emit', '_emit'):
        return False
    return (bool(node.args)
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str))


def _attr_chain(node):
    """Dotted name of an attribute expression (``RejectReason.X.value``
    → ``['RejectReason', 'X', 'value']``), or None when any link is not
    a plain Name/Attribute."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return list(reversed(parts))


def _check_reject_reason(node, kw, reasons, emitv):
    """Judge the ``reason=`` keyword of a serve.reject emit."""
    val = kw.value
    if isinstance(val, ast.Constant):
        if isinstance(val.value, str) and val.value not in reasons.values():
            emitv('reject-reason', val,
                  f'serve.reject reason {val.value!r} is not a '
                  f'RejectReason value — the typed-reject taxonomy is '
                  f'{sorted(reasons.values())}')
        return
    chain = _attr_chain(val)
    if not chain or 'RejectReason' not in chain:
        return      # a variable / expression: runtime validation owns it
    i = chain.index('RejectReason')
    tail = chain[i + 1:]
    if not tail or tail[0] not in reasons:
        emitv('reject-reason', val,
              f'RejectReason has no member '
              f'{tail[0] if tail else "<none>"!r}')
    elif tail[-1] != 'value':
        emitv('reject-reason', val,
              f'serve.reject reason must emit RejectReason.'
              f'{tail[0]}.value — the bare enum member would '
              f'serialize as its repr, not the typed string')


def lint_file(path, repo_root=None, rules=None):
    """Run the protolint ruleset over one file; returns a Violation
    list. Files outside the package / fixture scope return []."""
    rules = set(rules or PROTO_RULES)
    rel = (os.path.relpath(path, repo_root) if repo_root
           else os.fspath(path))
    if not any(frag in rel for frag in _SCOPE_FRAGMENTS) \
            or any(frag in rel for frag in _EXCLUDE_FRAGMENTS):
        return []
    with open(path, encoding='utf-8') as f:
        src = f.read()
    try:
        tree = ast.parse(src, filename=rel)
    except SyntaxError:
        return []       # astlint owns parse-error reporting
    lines = src.splitlines()
    schema = _schema()
    reasons = _reject_reasons()
    out = []

    def emitv(rule, node, msg):
        if rule in rules and not allowed_by_pragma(lines, node.lineno,
                                                   rule):
            out.append(Violation(rule=rule, message=msg, file=rel,
                                 line=node.lineno))

    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and _is_emit_call(node)):
            continue
        kind = node.args[0].value
        if kind not in schema:
            emitv('event-vocab', node,
                  f'emit of unknown event kind {kind!r} — the closed '
                  f'vocabulary is EVENT_SCHEMA (obs/events.py); this '
                  f'call raises ValueError at runtime')
            continue        # field checks need a known kind
        kwargs = {kw.arg for kw in node.keywords if kw.arg is not None}
        has_star = (any(kw.arg is None for kw in node.keywords)
                    or len(node.args) > 1)
        required = set(schema[kind])
        missing = required - (kwargs - _TRANSPORT_KWARGS)
        if missing and not has_star:
            emitv('event-fields', node,
                  f'emit of {kind!r} is missing required field'
                  f'{"s" if len(missing) != 1 else ""} '
                  f'{sorted(missing)} (EVENT_SCHEMA) — this call '
                  f'raises ValueError at runtime')
        if kind == 'serve.reject':
            for kw in node.keywords:
                if kw.arg == 'reason':
                    _check_reject_reason(node, kw, reasons, emitv)
    return out


def lint_paths(paths, repo_root=None, rules=None):
    from distributed_dot_product_tpu_torch.analysis.astlint import (
        iter_python_files,
    )
    out = []
    for path in iter_python_files(paths):
        out.extend(lint_file(path, repo_root=repo_root, rules=rules))
    return out
