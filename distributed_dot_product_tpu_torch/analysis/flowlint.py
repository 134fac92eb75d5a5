# -*- coding: utf-8 -*-
"""
flowlint — interprocedural typed-failure-flow lint for the serving
stack (the third AST engine, next to graphlint's jaxpr/ast rules and
servelint's protocol/concurrency/determinism families).

The port's copy of ``distributed_dot_product_tpu/analysis/flowlint.py``:
the same rules and rule ids, with the package name, scopes and
tables rewritten for ``distributed_dot_product_tpu_torch``.

The repo's load-bearing production invariant is that every request
entering the serving stack leaves with a CLOSED-VOCABULARY event and a
TYPED reason. Runtime soaks exercise it; nothing before this pass
*proved* statically that an exception cannot escape a tick root
untyped. A drive-found bug of the reference — ``deque.remove`` hitting
``Request.__eq__`` on numpy prompts and throwing an untyped
``ValueError`` out of ``Scheduler.step`` — is exactly the defect class
this engine mechanizes away.

Four rules:

- **typed-escape**: build the intra-package call graph, compute each
  function's MAY-RAISE set (raise sites plus callee escapes, minus
  classes caught on the path — ``except`` clauses that re-raise are
  transparent), and require every class escaping a declared serving
  root (:data:`SERVING_ROOTS`) to be in the typed contract
  (:data:`TYPED_CONTRACT`, hierarchy-aware). A raw ``KeyError`` /
  ``IndexError`` / ``ValueError`` escape flags with its propagation
  chain rendered ``file:line → file:line``. Unresolvable attribute
  calls named ``remove``/``index`` count as implicit ``ValueError``
  raisers (:data:`IMPLICIT_RAISES`) — the deque.remove shape — unless the
  receiver is an imported module (``os.remove``).
- **handler-totality**: every ``except`` of a typed serving error
  (``RejectedError`` / ``PageCorruptionError`` or an in-tree subclass)
  must re-raise, route the failure into the event/metric ladder
  (``emit`` / ``log_exception`` / ``count_reject`` / ``reject`` —
  directly or through an intra-package call), or consume the typed
  payload (``e.reason`` / ``e.pages`` / ``e.site``). A handler doing
  none of those swallows a typed failure silently.
- **reason-coverage**: every ``RejectReason`` member needs ≥ 1
  raise/convert reference site, and the tree needs a ``serve.reject``
  emit plus per-reason counter coverage (literal
  ``...rejected.<value>`` names, or the canonical dynamic
  ``f'serve.rejected.{r.value}'`` loop which covers all members). A
  dead enum member — a reason no code path can produce — flags.
- **shard-ownership**: host code outside ``models/decode.py`` must
  reach :class:`ShardedPageTable` geometry through its helpers
  (``gpage`` / ``gsplit`` / ``page_shard`` / ``owner`` /
  ``owned_range`` / ``tracked_pages``), never raw
  ``pages_per_shard + 1`` stride arithmetic — the contiguous-
  ownership contract has exactly one home.

Scope: the installed package (minus ``analysis/`` itself — the linter
does not lint the linter) is ALWAYS parsed in full as the
interprocedural universe, whatever path subset was requested, so
``--changed-only`` keeps whole-graph soundness; violations are then
reported only when they touch a requested file. Files under
``graphlint_fixtures`` are each analyzed as a standalone universe
(their ``FLOWLINT_ROOTS`` / ``FLOWLINT_CONTRACT`` module literals
stand in for the central tables).

Suppression: ``# flowlint: allow[<rule>]`` on the flagged line or the
line above (``# graphlint: allow[...]`` is accepted too — one pragma
grammar). Unlike the other families, a pragma-waived flowlint site
stays VISIBLE as an ``allowed`` record — waived failure-flow debt is
enumerable in ``--format json``/``sarif`` and the clean-tree gate
asserts the set stays empty.
"""

import ast
import os
import re

from distributed_dot_product_tpu_torch.analysis.astlint import (
    iter_python_files,
)
from distributed_dot_product_tpu_torch.analysis.base import (
    Violation, allowed_by_pragma,
)

__all__ = ['FLOW_RULES', 'SERVING_ROOTS', 'TYPED_CONTRACT',
           'IMPLICIT_RAISES', 'lint_paths', 'lint_file']

FLOW_RULES = ('typed-escape', 'handler-totality', 'reason-coverage',
              'shard-ownership')

# Declared serving roots: the host-surface entrypoints a request's
# whole lifecycle flows through. Keyed by path suffix; values are the
# qualnames whose may-raise sets are judged against TYPED_CONTRACT.
SERVING_ROOTS = {
    'serve/scheduler.py': ('Scheduler.step', 'Scheduler.submit'),
    'serve/router.py': ('Router.step', 'Router.submit'),
    'serve/engine.py': ('KernelEngine.step', 'KernelEngine.prefill',
                        'KernelEngine.verify_step'),
    'serve/loadgen.py': ('run_trace',),
}

# The typed failure contract at those roots (hierarchy-aware: a
# subclass of a contract class is covered). RejectedError carries the
# RejectReason taxonomy; PageCorruptionError the integrity verdicts;
# RuntimeError is the declared shard/pool-exhaustion shape ("size the
# pool larger" — an operator capacity fact, not a request fault);
# ServeContractError/UnknownReplicaError are the typed narrowings of
# the caller-contract ValueError/KeyError raises this pass forced out
# of the bare builtins (they subclass them, so callers keep catching
# the builtin).
TYPED_CONTRACT = ('RejectedError', 'PageCorruptionError',
                  'RuntimeError', 'ServeContractError',
                  'UnknownReplicaError')

# Unresolvable attribute calls that may raise UNTYPED builtins by
# value-equality semantics: list/deque `.remove`/`.index` walk
# `__eq__` and raise ValueError on no-match — the deque.remove regression
# shape (numpy-array fields make the walk itself throw). Calls whose
# receiver resolves to an imported module (os.remove) are exempt.
IMPLICIT_RAISES = {
    'remove': ('ValueError', 'container .remove() raises untyped '
                             'ValueError when the value is missing '
                             '(and walks __eq__ — the '
                             'deque.remove shape); delete by index'),
    'index': ('ValueError', 'container .index() raises untyped '
                            'ValueError when the value is missing; '
                            'guard membership or delete by index'),
}

# `self.<attr>` receiver types the constructor cannot infer (the attr
# is assigned from a parameter): (class, attr) -> receiver class.
TYPE_BINDINGS = {
    ('Scheduler', 'engine'): ('KernelEngine',),
    ('Router', 'pool'): ('ReplicaPool',),
}

# handler-totality: an except of one of these (or an in-universe
# subclass) must route the failure onward.
TOTALITY_BASES = ('RejectedError', 'PageCorruptionError')

# Routing a failure into the observability ladder: these call names
# (directly, or transitively through intra-package calls) satisfy
# handler-totality.
EMITISH_NAMES = frozenset({
    'emit', '_emit', 'log_exception', 'count_reject', '_count_reject',
    'reject', '_reject',
})

# Reading the typed payload off the caught exception also satisfies
# totality — the reason/verdict is consumed, not dropped.
PAYLOAD_ATTRS = frozenset({'reason', 'pages', 'site', 'args'})

# Builtin exception hierarchy (name -> base name), enough to make both
# the catch filter and the contract check subclass-aware.
_BUILTIN_BASES = {
    'KeyError': 'LookupError', 'IndexError': 'LookupError',
    'LookupError': 'Exception', 'ValueError': 'Exception',
    'TypeError': 'Exception', 'AttributeError': 'Exception',
    'RuntimeError': 'Exception', 'NotImplementedError': 'RuntimeError',
    'RecursionError': 'RuntimeError', 'ArithmeticError': 'Exception',
    'ZeroDivisionError': 'ArithmeticError',
    'OverflowError': 'ArithmeticError',
    'FloatingPointError': 'ArithmeticError',
    'OSError': 'Exception', 'IOError': 'OSError',
    'FileNotFoundError': 'OSError', 'FileExistsError': 'OSError',
    'PermissionError': 'OSError', 'TimeoutError': 'OSError',
    'ConnectionError': 'OSError', 'BrokenPipeError': 'ConnectionError',
    'StopIteration': 'Exception', 'StopAsyncIteration': 'Exception',
    'AssertionError': 'Exception', 'ImportError': 'Exception',
    'ModuleNotFoundError': 'ImportError', 'NameError': 'Exception',
    'UnboundLocalError': 'NameError', 'MemoryError': 'Exception',
    'BufferError': 'Exception', 'ReferenceError': 'Exception',
    'SystemError': 'Exception', 'EOFError': 'Exception',
    'UnicodeError': 'ValueError', 'UnicodeDecodeError': 'UnicodeError',
    'UnicodeEncodeError': 'UnicodeError',
    'Exception': 'BaseException', 'KeyboardInterrupt': 'BaseException',
    'SystemExit': 'BaseException', 'GeneratorExit': 'BaseException',
}

_PKG_PREFIX = 'distributed_dot_product_tpu_torch.'
_MAX_HOPS = 64


# -- per-file collection ------------------------------------------------

class _Handler:
    """One except clause: what it catches, whether it re-raises, how
    its body behaves (for handler-totality)."""

    __slots__ = ('caught', 'transparent', 'lineno', 'name',
                 'raises_any', 'call_names', 'payload_read')

    def __init__(self, caught, transparent, lineno, name):
        self.caught = caught            # tuple of class names ('BaseException' = bare)
        self.transparent = transparent  # contains a bare re-raise
        self.lineno = lineno
        self.name = name                # `as e` binding (or None)
        self.raises_any = False         # any raise statement in body
        self.call_names = set()         # call names made in the body
        self.payload_read = False       # reads e.reason/e.pages/...


class _Func:
    __slots__ = ('rel', 'path', 'qual', 'cls', 'lineno', 'raises',
                 'calls', 'handlers', 'emitish', 'local_types')

    def __init__(self, rel, path, qual, cls, lineno):
        self.rel = rel
        self.path = path
        self.qual = qual
        self.cls = cls                  # enclosing class name or None
        self.lineno = lineno
        self.raises = []                # (exc_name, lineno, guards)
        self.calls = []                 # (kind, data, lineno, guards)
        self.handlers = []              # _Handler
        self.emitish = False
        self.local_types = {}           # local var -> set of class names


class _FileInfo:
    __slots__ = ('path', 'rel', 'lines', 'tree', 'modules',
                 'from_imports', 'functions', 'classes', 'literals')

    def __init__(self, path, rel):
        self.path = path
        self.rel = rel
        self.lines = []
        self.tree = None
        self.modules = set()        # `import os` / `import numpy as np` aliases
        self.from_imports = {}      # name -> package module rel path
        self.functions = {}         # qualname -> _Func
        self.classes = {}           # class name -> _Class
        self.literals = {}          # module-level UPPERCASE literal decls


class _Class:
    __slots__ = ('name', 'rel', 'bases', 'lineno', 'methods',
                 'attr_types', 'enum_members')

    def __init__(self, name, rel, bases, lineno):
        self.name = name
        self.rel = rel
        self.bases = bases          # base name strings
        self.lineno = lineno
        self.methods = set()
        self.attr_types = {}        # self.<attr> -> set of class names
        self.enum_members = {}      # member name -> (lineno, value literal)


def _name_of(node):
    """Rightmost identifier of a Name/Attribute, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _is_enum_class(node):
    for b in node.bases:
        if _name_of(b) in ('Enum', 'IntEnum', 'StrEnum'):
            return True
    return False


def _parse_file(path, rel):
    info = _FileInfo(path, rel)
    try:
        with open(path, encoding='utf-8') as f:
            src = f.read()
        info.lines = src.splitlines()
        info.tree = ast.parse(src, filename=path)
    except (OSError, SyntaxError, ValueError):
        return None     # astlint owns parse-error reporting
    for node in info.tree.body:
        if isinstance(node, ast.Import):
            for a in node.names:
                info.modules.add(a.asname or a.name.split('.')[0])
        elif isinstance(node, ast.ImportFrom):
            if node.module and node.module.startswith(
                    _PKG_PREFIX.rstrip('.')):
                target = node.module.replace('.', '/') + '.py'
                for a in node.names:
                    info.from_imports[a.asname or a.name] = target
        elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id.isupper():
            try:
                info.literals[node.targets[0].id] = \
                    ast.literal_eval(node.value)
            except ValueError:
                pass
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            info.functions[node.name] = _collect_function(
                node, info, cls=None)
        elif isinstance(node, ast.ClassDef):
            _collect_class(node, info)
    return info


def _collect_class(node, info):
    ci = _Class(node.name, info.rel,
                tuple(n for n in (_name_of(b) for b in node.bases) if n),
                node.lineno)
    info.classes[node.name] = ci
    if _is_enum_class(node):
        for st in node.body:
            if isinstance(st, ast.Assign) and len(st.targets) == 1 \
                    and isinstance(st.targets[0], ast.Name):
                val = None
                if isinstance(st.value, ast.Constant):
                    val = st.value.value
                ci.enum_members[st.targets[0].id] = (st.lineno, val)
        return
    for st in node.body:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            ci.methods.add(st.name)
            qual = f'{node.name}.{st.name}'
            info.functions[qual] = _collect_function(
                st, info, cls=node.name)
            if st.name == '__init__':
                _infer_attr_types(st, ci)


def _infer_attr_types(init_node, ci):
    """``self.x = ClassName(...)`` (anywhere in the value expression —
    conditional constructions included) types the attribute for
    ``self.x.m()`` resolution."""
    for st in ast.walk(init_node):
        if not (isinstance(st, ast.Assign) and len(st.targets) == 1):
            continue
        tgt = st.targets[0]
        if not (isinstance(tgt, ast.Attribute)
                and isinstance(tgt.value, ast.Name)
                and tgt.value.id == 'self'):
            continue
        names = {n.func.id for n in ast.walk(st.value)
                 if isinstance(n, ast.Call)
                 and isinstance(n.func, ast.Name)
                 and n.func.id[:1].isupper()}
        if names:
            ci.attr_types.setdefault(tgt.attr, set()).update(names)


def _collect_function(node, info, cls):
    fn = _Func(info.rel, info.path,
               f'{cls}.{node.name}' if cls else node.name,
               cls, node.lineno)
    # Local aliases: `eng = self.engine` / `p = PagePool(...)`.
    for st in ast.walk(node):
        if isinstance(st, ast.Assign) and len(st.targets) == 1 \
                and isinstance(st.targets[0], ast.Name):
            v = st.value
            if isinstance(v, ast.Attribute) \
                    and isinstance(v.value, ast.Name) \
                    and v.value.id == 'self':
                fn.local_types[st.targets[0].id] = ('self-attr', v.attr)
            elif isinstance(v, ast.Call) \
                    and isinstance(v.func, ast.Name) \
                    and v.func.id[:1].isupper():
                fn.local_types[st.targets[0].id] = ('class', v.func.id)
    _walk_body(node.body, fn, info, guards=(), handler=None)
    return fn


def _parse_handlers(try_node, info):
    out = []
    for h in try_node.handlers:
        if h.type is None:
            caught = ('BaseException',)
        elif isinstance(h.type, ast.Tuple):
            caught = tuple(n for n in (_name_of(e) for e in h.type.elts)
                           if n)
        else:
            caught = tuple(n for n in (_name_of(h.type),) if n)
        transparent = any(
            isinstance(n, ast.Raise)
            and (n.exc is None
                 or (isinstance(n.exc, ast.Name) and h.name
                     and n.exc.id == h.name))
            for n in _walk_no_nested(h.body))
        out.append(_Handler(caught or ('BaseException',), transparent,
                            h.lineno, h.name))
    return tuple(out)


def _walk_no_nested(stmts):
    """Every node under ``stmts``, not descending into nested
    function/class scopes."""
    stack = list(stmts)
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(n))


def _walk_body(stmts, fn, info, guards, handler):
    for node in stmts:
        _walk_node(node, fn, info, guards, handler)


def _walk_node(node, fn, info, guards, handler):
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.Lambda, ast.ClassDef)):
        return      # nested scope: raises there don't fire here
    if isinstance(node, ast.Try):
        hs = _parse_handlers(node, info)
        inner = guards + (hs,)
        _walk_body(node.body, fn, info, inner, handler)
        for h, hnode in zip(hs, node.handlers):
            fn.handlers.append(h)
            for st in _walk_no_nested(hnode.body):
                if isinstance(st, ast.Raise):
                    h.raises_any = True
                if isinstance(st, ast.Call):
                    nm = _name_of(st.func)
                    if nm:
                        h.call_names.add(nm)
                if h.name and isinstance(st, ast.Attribute) \
                        and isinstance(st.value, ast.Name) \
                        and st.value.id == h.name \
                        and st.attr in PAYLOAD_ATTRS:
                    h.payload_read = True
            # Handler bodies run unprotected by their own try.
            _walk_body(hnode.body, fn, info, guards, h)
        _walk_body(node.orelse, fn, info, guards, handler)
        _walk_body(node.finalbody, fn, info, guards, handler)
        return
    if isinstance(node, ast.Raise):
        exc = node.exc
        if exc is None or (handler is not None and handler.name
                           and isinstance(exc, ast.Name)
                           and exc.id == handler.name):
            pass    # bare re-raise: modeled by handler transparency
        else:
            if isinstance(exc, ast.Call):
                exc = exc.func
            name = _name_of(exc)
            if name:
                fn.raises.append((name, node.lineno, guards))
        # fall through: raise operands may contain calls
    if isinstance(node, ast.Call):
        _record_call(node, fn, info, guards)
    for child in ast.iter_child_nodes(node):
        _walk_node(child, fn, info, guards, handler)


def _record_call(node, fn, info, guards):
    f = node.func
    if isinstance(f, ast.Name):
        if f.id in EMITISH_NAMES:
            fn.emitish = True
        fn.calls.append(('bare', f.id, node.lineno, guards))
        return
    if not isinstance(f, ast.Attribute):
        return
    if f.attr in EMITISH_NAMES:
        fn.emitish = True
    base = f.value
    if isinstance(base, ast.Name):
        if base.id == 'self':
            fn.calls.append(('self', f.attr, node.lineno, guards))
            return
        if base.id in info.modules:
            return      # module-attr call (os.remove, np.asarray): external
        local = fn.local_types.get(base.id)
        if local is not None:
            fn.calls.append(('local', (local, f.attr), node.lineno,
                             guards))
            return
        fn.calls.append(('unknown', f.attr, node.lineno, guards))
        return
    if isinstance(base, ast.Attribute) \
            and isinstance(base.value, ast.Name) \
            and base.value.id == 'self':
        fn.calls.append(('self-attr', (base.attr, f.attr), node.lineno,
                         guards))
        return
    fn.calls.append(('unknown', f.attr, node.lineno, guards))


# -- the universe -------------------------------------------------------

class _Universe:
    def __init__(self, files):
        self.files = files                      # rel -> _FileInfo
        self.functions = {}                     # (rel, qual) -> _Func
        self.classes = {}                       # name -> [_Class]
        self.bases = dict(_BUILTIN_BASES)       # exc name -> base name
        for fi in files.values():
            for qual, fn in fi.functions.items():
                self.functions[(fi.rel, qual)] = fn
            for name, ci in fi.classes.items():
                self.classes.setdefault(name, []).append(ci)
                if ci.bases:
                    self.bases.setdefault(name, ci.bases[0])

    def ancestry(self, exc):
        """``exc`` and its base chain. Unknown classes are assumed to
        sit directly under Exception."""
        chain, seen = [exc], {exc}
        cur = exc
        while True:
            nxt = self.bases.get(cur)
            if nxt is None:
                if cur not in ('BaseException',):
                    chain.append('Exception')
                    chain.append('BaseException')
                break
            if nxt in seen:
                break
            chain.append(nxt)
            seen.add(nxt)
            cur = nxt
        return chain

    def catches(self, exc, caught_names):
        anc = self.ancestry(exc)
        return any(c in anc for c in caught_names)

    def resolve_method(self, cls_name, meth, _depth=0):
        """(rel, qual) of ``cls_name.meth``, following in-universe base
        classes; None when the universe doesn't define it."""
        if _depth > 8:
            return None
        for ci in self.classes.get(cls_name, ()):
            if meth in ci.methods:
                return (ci.rel, f'{ci.name}.{meth}')
            for b in ci.bases:
                hit = self.resolve_method(b, meth, _depth + 1)
                if hit is not None:
                    return hit
        return None

    def attr_candidates(self, cls_name, attr):
        out = set()
        for ci in self.classes.get(cls_name, ()):
            out.update(ci.attr_types.get(attr, ()))
        out.update(TYPE_BINDINGS.get((cls_name, attr), ()))
        return out

    def resolve_call(self, fn, kind, data):
        """Resolve one recorded call site to ``[(rel, qual), ...]``
        universe functions; ``None`` marks 'unresolved' (a candidate
        for IMPLICIT_RAISES)."""
        fi = self.files[fn.rel]
        if kind == 'bare':
            if data in fi.functions and fi.functions[data].cls is None:
                return [(fn.rel, data)]
            if data in fi.classes:
                return self._init_of(data)
            target = fi.from_imports.get(data)
            if target is not None:
                for rel, tfi in self.files.items():
                    if rel.replace(os.sep, '/').endswith(target):
                        if data in tfi.functions \
                                and tfi.functions[data].cls is None:
                            return [(rel, data)]
                        if data in tfi.classes:
                            return self._init_of(data)
            if data in self.classes:
                return self._init_of(data)
            return []       # builtins (len, int, ...): no raises tracked
        if kind == 'self':
            if fn.cls is None:
                return None
            hit = self.resolve_method(fn.cls, data)
            return [hit] if hit else None
        if kind == 'self-attr':
            attr, meth = data
            if fn.cls is None:
                return None
            cands = self.attr_candidates(fn.cls, attr)
            out = []
            for c in sorted(cands):
                hit = self.resolve_method(c, meth)
                if hit:
                    out.append(hit)
            return out or None
        if kind == 'local':
            (lk, lv), meth = data
            if lk == 'class':
                hit = self.resolve_method(lv, meth)
                return [hit] if hit else None
            if lk == 'self-attr' and fn.cls is not None:
                out = []
                for c in sorted(self.attr_candidates(fn.cls, lv)):
                    hit = self.resolve_method(c, meth)
                    if hit:
                        out.append(hit)
                return out or None
            return None
        return None     # 'unknown'

    def _init_of(self, cls_name):
        hit = self.resolve_method(cls_name, '__init__')
        return [hit] if hit else []


def _package_universe_paths():
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = []
    for base, dirs, names in os.walk(pkg):
        dirs[:] = [d for d in dirs
                   if d not in ('__pycache__', 'analysis')]
        for n in sorted(names):
            if n.endswith('.py'):
                out.append(os.path.join(base, n))
    return out


def _build_universe(paths, repo_root):
    files = {}
    for p in paths:
        rel = (os.path.relpath(p, repo_root) if repo_root
               else p).replace(os.sep, '/')
        fi = _parse_file(p, rel)
        if fi is not None:
            files[fi.rel] = fi
    return _Universe(files)


# -- may-raise fixpoint -------------------------------------------------

def _escapes_guards(uni, exc, guards):
    """Does ``exc`` raised under ``guards`` (outer→inner handler
    levels) leave the function? First matching clause per level wins:
    transparent → keeps propagating, else absorbed."""
    for level in reversed(guards):
        for h in level:
            if uni.catches(exc, h.caught):
                if not h.transparent:
                    return False
                break
    return True


def _may_raise_fixpoint(uni):
    """``{(rel, qual): {exc: (lineno, callee_key|None, note)}}`` —
    witness-carrying may-raise sets. The witness is the FIRST site
    observed (deterministic: sites are walked in source order)."""
    may = {k: {} for k in uni.functions}
    changed = True
    while changed:
        changed = False
        for key, fn in uni.functions.items():
            cur = may[key]
            for exc, lineno, guards in fn.raises:
                if exc not in cur and _escapes_guards(uni, exc, guards):
                    cur[exc] = (lineno, None, 'raise')
                    changed = True
            for kind, data, lineno, guards in fn.calls:
                callees = uni.resolve_call(fn, kind, data)
                if callees is None:
                    meth = data[1] if isinstance(data, tuple) else data
                    imp = IMPLICIT_RAISES.get(meth)
                    if imp and imp[0] not in cur \
                            and _escapes_guards(uni, imp[0], guards):
                        cur[imp[0]] = (lineno, None, imp[1])
                        changed = True
                    continue
                for ck in callees:
                    for exc in may.get(ck, ()):
                        if exc not in cur \
                                and _escapes_guards(uni, exc, guards):
                            cur[exc] = (lineno, ck, 'call')
                            changed = True
    return may


def _witness_chain(uni, may, key, exc):
    """Call-site hops from ``key`` down to the origin raise, as
    ``(rel, lineno, note)`` triples."""
    chain = []
    for _ in range(_MAX_HOPS):
        fn = uni.functions[key]
        lineno, callee, note = may[key][exc]
        chain.append((fn.rel, lineno, note))
        if callee is None:
            return chain
        if exc not in may.get(callee, ()):
            return chain
        key = callee
    return chain


# -- rules --------------------------------------------------------------

def _v(rule, msg, fi, lineno, chain=None):
    waived = allowed_by_pragma(fi.lines, lineno, rule)
    return Violation(rule=rule, message=msg, file=fi.rel, line=lineno,
                     allowed=waived, chain=chain)


def _roots_of(uni, fixture):
    """``[(rel, qual), ...]`` declared roots present in the universe."""
    out = []
    for rel, fi in uni.files.items():
        quals = ()
        if fixture:
            decl = fi.literals.get('FLOWLINT_ROOTS')
            if decl:
                quals = tuple(decl)
        else:
            for suffix, names in SERVING_ROOTS.items():
                if rel.endswith(suffix):
                    quals = names
        for q in quals:
            if (rel, q) in uni.functions:
                out.append((rel, q))
    return out


def _contract_of(uni, fixture):
    if fixture:
        for fi in uni.files.values():
            decl = fi.literals.get('FLOWLINT_CONTRACT')
            if decl:
                return tuple(decl)
    return TYPED_CONTRACT


def _check_typed_escape(uni, may, fixture, out):
    contract = _contract_of(uni, fixture)
    for rel, qual in _roots_of(uni, fixture):
        root_fi = uni.files[rel]
        root_fn = uni.functions[(rel, qual)]
        for exc in sorted(may[(rel, qual)]):
            if any(c in uni.ancestry(exc) for c in contract):
                continue
            chain = _witness_chain(uni, may, (rel, qual), exc)
            origin_rel, origin_line, note = chain[-1]
            origin_fi = uni.files[origin_rel]
            rendered = ' → '.join(f'{r}:{ln}' for r, ln, _ in chain)
            detail = ('' if note in ('raise', 'call')
                      else f' ({note})')
            msg = (f'{qual} may leak untyped {exc} — {rendered}'
                   f'{detail}; raise a TYPED_CONTRACT class '
                   f'({", ".join(contract)}) or convert it inside the '
                   f'serving stack')
            waived = (allowed_by_pragma(origin_fi.lines, origin_line,
                                        'typed-escape')
                      or allowed_by_pragma(root_fi.lines,
                                           root_fn.lineno,
                                           'typed-escape'))
            out.append(Violation(
                rule='typed-escape', message=msg, file=origin_rel,
                line=origin_line, allowed=waived,
                chain=tuple(f'{r}:{ln}' for r, ln, _ in chain)))


def _may_emit_fixpoint(uni):
    emits = {k for k, fn in uni.functions.items() if fn.emitish}
    changed = True
    while changed:
        changed = False
        for key, fn in uni.functions.items():
            if key in emits:
                continue
            for kind, data, _lineno, _guards in fn.calls:
                callees = uni.resolve_call(fn, kind, data) or ()
                if any(c in emits for c in callees):
                    emits.add(key)
                    changed = True
                    break
    return emits


def _typed_handler_names(uni):
    names = set(TOTALITY_BASES)
    changed = True
    while changed:
        changed = False
        for name, base in list(uni.bases.items()):
            if base in names and name not in names:
                names.add(name)
                changed = True
    return names


def _check_handler_totality(uni, out):
    typed = _typed_handler_names(uni)
    emits = _may_emit_fixpoint(uni)
    for key, fn in uni.functions.items():
        fi = uni.files[fn.rel]
        for h in fn.handlers:
            if not any(c in typed for c in h.caught):
                continue
            if h.transparent or h.raises_any or h.payload_read:
                continue
            if h.call_names & EMITISH_NAMES:
                continue
            routed = False
            for nm in sorted(h.call_names):
                for kind in ('self', 'bare'):
                    callees = uni.resolve_call(fn, kind, nm)
                    if callees and any(c in emits for c in callees):
                        routed = True
                        break
                if routed:
                    break
            if routed:
                continue
            caught = '/'.join(h.caught)
            out.append(_v(
                'handler-totality',
                f'{fn.qual} catches typed serving error {caught} and '
                f'drops it — emit a closed-vocab event, route '
                f'log_exception/count_reject, consume the typed '
                f'payload (e.g. .reason), or re-raise',
                fi, h.lineno))


_REJECTED_COUNTER = re.compile(r'rejected\.([a-z0-9_]+)$')


def _check_reason_coverage(uni, out):
    enums = [(fi, ci) for fi in uni.files.values()
             for ci in fi.classes.values()
             if ci.name == 'RejectReason' and ci.enum_members]
    if not enums:
        return
    refs = {}           # member -> count of reference sites
    counter_lits = set()
    counter_dynamic = False
    emit_reject = False
    for fi in uni.files.values():
        for node in ast.walk(fi.tree):
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == 'RejectReason':
                refs[node.attr] = refs.get(node.attr, 0) + 1
            if isinstance(node, ast.Call):
                nm = _name_of(node.func)
                if nm in ('emit', '_emit') and node.args \
                        and isinstance(node.args[0], ast.Constant) \
                        and node.args[0].value == 'serve.reject':
                    emit_reject = True
                if nm == 'counter' and node.args:
                    arg = node.args[0]
                    if isinstance(arg, ast.Constant) \
                            and isinstance(arg.value, str):
                        m = _REJECTED_COUNTER.search(arg.value)
                        if m:
                            counter_lits.add(m.group(1))
                    elif isinstance(arg, ast.JoinedStr) and arg.values:
                        head = arg.values[0]
                        if isinstance(head, ast.Constant) \
                                and isinstance(head.value, str) \
                                and head.value.endswith('rejected.'):
                            counter_dynamic = True
    for fi, ci in enums:
        if not emit_reject:
            out.append(_v(
                'reason-coverage',
                'RejectReason declared but no serve.reject emit site '
                'exists — typed rejects would leave no event',
                fi, ci.lineno))
        for member, (lineno, value) in ci.enum_members.items():
            missing = []
            if not refs.get(member):
                missing.append('no raise/convert site references it')
            if not counter_dynamic and (
                    value is None or str(value) not in counter_lits):
                missing.append('no per-reason counter covers it')
            if missing:
                out.append(_v(
                    'reason-coverage',
                    f'RejectReason.{member} is dead taxonomy — '
                    f'{"; ".join(missing)} — wire it into the '
                    f'reject ladder or delete the member',
                    fi, lineno))


def _check_shard_ownership(uni, anchor_rels, out):
    for rel, fi in uni.files.items():
        if rel.endswith('models/decode.py'):
            continue    # the geometry's one home
        if anchor_rels is not None and rel not in anchor_rels:
            continue
        flagged = set()
        for node in ast.walk(fi.tree):
            if not isinstance(node, ast.BinOp):
                continue
            hit = any(isinstance(n, ast.Attribute)
                      and n.attr == 'pages_per_shard'
                      for n in ast.walk(node))
            if hit and node.lineno not in flagged:
                flagged.add(node.lineno)
                out.append(_v(
                    'shard-ownership',
                    'raw pages_per_shard stride arithmetic outside '
                    'models/decode.py — go through the '
                    'ShardedPageTable helpers (gpage/gsplit/'
                    'page_shard/owner/owned_range) so the contiguous-'
                    'ownership layout has exactly one home',
                    fi, node.lineno))


# -- entry points -------------------------------------------------------

def _lint_universe(uni, fixture, anchor_rels, rules):
    out = []
    run = (lambda r: rules is None or r in rules)
    if run('typed-escape') or run('handler-totality'):
        may = _may_raise_fixpoint(uni) if run('typed-escape') else None
        if run('typed-escape'):
            _check_typed_escape(uni, may, fixture, out)
        if run('handler-totality'):
            _check_handler_totality(uni, out)
    if run('reason-coverage'):
        _check_reason_coverage(uni, out)
    if run('shard-ownership'):
        _check_shard_ownership(uni, anchor_rels, out)
    if anchor_rels is not None:
        out = [v for v in out
               if v.file in anchor_rels
               or (v.chain is not None
                   and any(h.rsplit(':', 1)[0] in anchor_rels
                           for h in v.chain))]
    return out


def _in_package(path):
    norm = os.path.abspath(path).replace(os.sep, '/')
    return f'/{_PKG_PREFIX.rstrip(".")}/' in norm \
        and '/analysis/' not in norm


def lint_paths(paths, repo_root=None, rules=None):
    """Run flowlint over ``paths``. Fixture files (under
    ``graphlint_fixtures``) are standalone universes; package files are
    judged against the full-package universe (interprocedural
    soundness survives ``--changed-only``), with findings filtered to
    the requested set. Non-package files (tests/, scripts/) are out of
    scope — the serving stack is the contract surface."""
    if rules is not None and not set(rules) & set(FLOW_RULES):
        return []
    violations = []
    package_anchor = set()
    for path in iter_python_files(paths):
        if 'graphlint_fixtures' in path.replace(os.sep, '/'):
            uni = _build_universe(
                [path], repo_root or os.path.dirname(path))
            violations.extend(
                _lint_universe(uni, fixture=True, anchor_rels=None,
                               rules=rules))
        elif _in_package(path):
            package_anchor.add(path)
    if package_anchor:
        pkg_paths = _package_universe_paths()
        root = repo_root
        if root is None:
            pkg = os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))
            root = os.path.dirname(pkg)
        uni = _build_universe(pkg_paths, root)
        anchor_rels = {os.path.relpath(p, root).replace(os.sep, '/')
                       for p in package_anchor}
        violations.extend(
            _lint_universe(uni, fixture=False, anchor_rels=anchor_rels,
                           rules=rules))
    return violations


def lint_file(path, repo_root=None, rules=None):
    return lint_paths([path], repo_root=repo_root, rules=rules)
