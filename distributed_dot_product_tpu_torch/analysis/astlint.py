# -*- coding: utf-8 -*-
"""
AST ruleset: project-specific hazard patterns that a run of the
registered entrypoints can't show (either because the code is host
control flow — branches, exception handlers — or because the hazard
only costs on the card). The port of
``distributed_dot_product_tpu/analysis/astlint.py``: the same four rules
and scopes, with "traced" read as "torch-derived".

Pure ``ast``, no third-party dependency: this is deliberately NOT a
generic style linter (ruff owns hygiene — see pyproject.toml); every
rule here encodes a contract of the port. Scope is per rule: the
torch-value rules (``host-pull``, ``traced-bool-branch``) only police
the hot paths (``ops/``, ``models/``, ``serve/``, ``obs/``), where a
read-back of a tensor is a card sync on every call; ``clock-in-jit``
and ``silent-except`` apply package-wide plus ``scripts/``.

A value is *torch-derived*, statically and conservatively, when it is a
``torch.* / F.*`` call, a method call on a torch-derived value (other
than the host metadata reads: ``.shape``, ``.size()``, ``.numel()``,
``.dim()``, ``.dtype``, ``.device``, ...), or an attribute/index/binop
over one; a local name is torch-derived when it was assigned one inside
the same function. Only torch-derived values and direct torch-predicate
calls trigger the torch-value rules, so static-config idioms
(``float(scale)`` on a kwarg, ``int(x.shape[0])``) stay clean.

``clock-in-jit`` reads "compiled" as a ``torch.compile`` /
``torch.jit.script`` / ``@triton.jit`` function, or the body of a
``with torch.cuda.graph(...)`` capture: the clock is read once, when
the region is compiled or captured, and the constant replays.

Suppression: ``# graphlint: allow[<rule>]`` on the line or the line
above (see analysis/base.py).
"""

import ast
import os

from distributed_dot_product_tpu_torch.analysis.base import (
    Violation, allowed_by_pragma,
)

__all__ = ['lint_file', 'lint_paths', 'iter_python_files', 'AST_RULES']

AST_RULES = ('host-pull', 'traced-bool-branch', 'clock-in-jit',
             'silent-except')

# Rules whose scope is the hot paths only (path fragments matched
# against the repo-relative file path): the serving tick and the obs
# sampling paths launch kernels per token, so a host read of a tensor
# there stalls the same loop the kernel rules protect.
_HOT_PATH_FRAGMENTS = (os.sep + 'ops' + os.sep,
                       os.sep + 'models' + os.sep,
                       os.sep + 'serve' + os.sep,
                       os.sep + 'obs' + os.sep)

_TORCH_ROOTS = {'torch', 'F'}
_PREDICATE_FNS = {'any', 'all', 'isfinite', 'isnan', 'allclose',
                  'equal', 'isin'}
_HOST_CASTS = {'float', 'int', 'bool'}
# Tensor reads that give host values without touching the data.
_HOST_META = {'shape', 'size', 'numel', 'dim', 'ndim', 'ndimension',
              'dtype', 'device', 'is_cuda', 'data_ptr', 'element_size',
              'stride', 'nbytes', 'itemsize', 'untyped_storage',
              'storage_offset', 'is_contiguous', 'get_device',
              'requires_grad', 'layout', 'names', 'is_floating_point',
              'is_complex', 'is_leaf', 'grad_fn'}
# torch namespaces and functions whose calls give host values.
_HOST_TORCH = {'cuda', 'device', 'finfo', 'iinfo', 'Generator', 'is_tensor',
               'get_default_dtype', 'backends', 'distributed', 'Size',
               'is_grad_enabled', 'version', 'utils', 'compiler', 'profiler',
               'no_grad', 'inference_mode', 'enable_grad', 'manual_seed',
               'initial_seed', 'set_grad_enabled', 'promote_types',
               'result_type', 'can_cast', 'is_floating_point', 'dtype',
               'get_rng_state', 'set_default_dtype', 'library', 'jit',
               'autocast', 'use_deterministic_algorithms',
               'are_deterministic_algorithms_enabled'}
_CLOCK_FNS = {'time', 'perf_counter', 'monotonic', 'process_time',
              'thread_time'}
_LOGGY_NAMES = {'log_exception', 'warn', 'warning', 'error', 'exception',
                'print', 'log', 'log_step', 'debug', 'info'}


def _root_name(node):
    """Leftmost Name of a dotted/indexed/called expression, or None."""
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        node = node.func if isinstance(node, ast.Call) else node.value
    return node.id if isinstance(node, ast.Name) else None


def _torch_path(node):
    """``['torch', 'cuda', 'synchronize']`` for ``torch.cuda.synchronize``
    — the dotted attribute path of a plain name chain, or None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    return [node.id] + parts[::-1]


def _is_torch_call(node):
    """``torch.foo(...)`` / ``torch.nn.functional.bar(...)`` /
    ``F.baz(...)`` — but not the torch namespaces that answer on the host
    (``torch.cuda.*``, ``torch.finfo``, ``torch.device``, ...)."""
    if not isinstance(node, ast.Call):
        return False
    path = _torch_path(node.func)
    if not path or path[0] not in _TORCH_ROOTS:
        return False
    return not (path[0] == 'torch' and len(path) > 1
                and path[1] in _HOST_TORCH)


# The obs spans layer (obs/spans.py): roots its calls may appear under.
_SPAN_ROOTS = {'obs', 'spans', 'obs_spans'}
_SPAN_NAMES = {'span', 'spanned'}


def _is_span_call(node):
    """``span(...)`` / ``spanned(...)`` / ``obs.span(...)`` /
    ``spans.span(...)`` — the obs layer's clock-reading context
    managers. A bare name matches only the exact identifiers (so a
    regex ``m.span()`` attribute on a non-obs object never fires: its
    root is the match object, not an obs module)."""
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    if isinstance(fn, ast.Name):
        return fn.id in _SPAN_NAMES
    if isinstance(fn, ast.Attribute):
        return fn.attr in _SPAN_NAMES and _root_name(fn) in _SPAN_ROOTS
    return False


def _is_torch_predicate_call(node):
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _PREDICATE_FNS
            and _root_name(node.func) in _TORCH_ROOTS)


def _compile_decorated(fn_node):
    """Does this function's decorator list compile it?  Covers
    ``@torch.compile``, ``@torch.compile(...)``, ``@torch.jit.script``,
    ``@triton.jit``, ``@jit`` and ``@partial(torch.compile, ...)``."""
    for dec in fn_node.decorator_list:
        target = dec
        if isinstance(dec, ast.Call):
            # partial(torch.compile, ...): the compiler is arg 0.
            if (getattr(dec.func, 'attr', None) == 'partial'
                    or getattr(dec.func, 'id', None) == 'partial'):
                if dec.args:
                    target = dec.args[0]
            else:
                target = dec.func
        name = (target.attr if isinstance(target, ast.Attribute)
                else getattr(target, 'id', None))
        if name == 'jit':
            return True
        if name in ('compile', 'script') and _root_name(target) == 'torch':
            return True
    return False


def _is_graph_capture(item):
    """``with torch.cuda.graph(g):`` — a CUDA-graph capture region."""
    ctx = item.context_expr
    return (isinstance(ctx, ast.Call)
            and isinstance(ctx.func, ast.Attribute)
            and ctx.func.attr == 'graph'
            and _root_name(ctx.func) == 'torch')


class _FunctionChecker(ast.NodeVisitor):
    """Per-function pass: infer torch-derived locals, then flag host
    pulls and tensor-predicate branches on them."""

    def __init__(self, fn_node, rel, src_lines, out, hot, in_jit):
        self.fn = fn_node
        self.rel = rel
        self.lines = src_lines
        self.out = out
        self.hot = hot
        self.in_jit = in_jit or _compile_decorated(fn_node)
        self.torch_locals = set()
        # Pass 1: names assigned from torch values anywhere in this
        # function body (order-insensitive), to a fixed point so that a
        # method chain over a torch-derived local is torch-derived too.
        assigns = []
        for node in ast.walk(fn_node):
            if isinstance(node, ast.Assign):
                assigns.append((node.targets, node.value))
            elif (isinstance(node, (ast.AugAssign, ast.AnnAssign))
                  and node.value is not None):
                assigns.append(([node.target], node.value))
        changed = True
        while changed:
            changed = False
            for targets, value in assigns:
                if not self._is_torch_value(value):
                    continue
                for tgt in targets:
                    for el in _name_targets(tgt):
                        if el not in self.torch_locals:
                            self.torch_locals.add(el)
                            changed = True

    def _is_torch_value(self, node):
        """An expression that produces a tensor: a torch call, a method
        call on one (host metadata reads excepted), or an attribute/
        index/binop over one; a torch-derived local name."""
        if _is_torch_call(node):
            return True
        if isinstance(node, ast.Name):
            return node.id in self.torch_locals
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute):
            if node.func.attr in _HOST_META:
                return False
            return self._is_torch_value(node.func.value)
        if isinstance(node, ast.Attribute):
            if node.attr in _HOST_META:
                return False
            return self._is_torch_value(node.value)
        if isinstance(node, ast.Subscript):
            return self._is_torch_value(node.value)
        if isinstance(node, ast.BinOp):
            return (self._is_torch_value(node.left)
                    or self._is_torch_value(node.right))
        return False

    def _emit(self, rule, node, msg):
        if not allowed_by_pragma(self.lines, node.lineno, rule):
            self.out.append(Violation(rule=rule, message=msg,
                                      file=self.rel, line=node.lineno))

    def _is_traced_expr(self, node):
        if _is_torch_predicate_call(node):
            return True
        if isinstance(node, ast.Name) and node.id in self.torch_locals:
            return True
        if isinstance(node, ast.UnaryOp):
            return self._is_traced_expr(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self._is_traced_expr(v) for v in node.values)
        if isinstance(node, ast.Compare):
            # Identity checks (`x is None` / `x is not None`) are host
            # predicates even on tensors — never a read-back.
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False
            return any(self._is_traced_expr(n)
                       for n in [node.left, *node.comparators])
        return False

    # -- nested functions get their own checker (compile context
    # inherits) ---------------------------------------------------------
    def visit_FunctionDef(self, node):
        if node is self.fn:
            self.generic_visit(node)
        else:
            _FunctionChecker(node, self.rel, self.lines, self.out,
                             self.hot, self.in_jit).visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_With(self, node):
        if not self.in_jit and any(_is_graph_capture(i) for i in node.items):
            # The capture body runs once, at capture time: the clock
            # rule holds inside it as inside a compiled function.
            self.in_jit = True
            try:
                self.generic_visit(node)
            finally:
                self.in_jit = False
            return
        self.generic_visit(node)

    def visit_Call(self, node):
        if self.hot:
            # .item() — always a host read of a device value.
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr == 'item' and not node.args):
                self._emit('host-pull', node,
                           '.item() reads the tensor back to the host (a '
                           'device sync on the card) — keep the value on '
                           'the device or read it back once outside the '
                           'hot path')
            # .cpu() / .tolist() on a torch-derived value.
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr in ('cpu', 'tolist')
                  and not node.args
                  and self._is_torch_value(node.func.value)):
                self._emit('host-pull', node,
                           f'.{node.func.attr}() of a torch-derived value '
                           f'(`{ast.unparse(node)[:60]}`) reads it back '
                           f'to the host — a device sync on the card')
            # float/int/bool/np.asarray/np.array on a torch-derived value.
            target = None
            if (isinstance(node.func, ast.Name)
                    and node.func.id in _HOST_CASTS and node.args):
                target = node.args[0]
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr in ('asarray', 'array')
                  and _root_name(node.func) in ('np', 'numpy')
                  and node.args):
                target = node.args[0]
            if (target is not None
                    and (self._is_traced_expr(target)
                         or self._is_torch_value(target))):
                self._emit('host-pull', node,
                           f'host conversion of a torch-derived value '
                           f'(`{ast.unparse(node)[:60]}`) syncs the card '
                           f'in the hot path — keep it a tensor')
        if self.in_jit and isinstance(node.func, ast.Attribute):
            if (node.func.attr in _CLOCK_FNS
                    and _root_name(node.func) == 'time'):
                self._emit('clock-in-jit', node,
                           f'time.{node.func.attr}() inside a compiled '
                           f'function or a CUDA-graph capture reads the '
                           f'clock once, at compile or capture time, and '
                           f'replays the constant — time outside it')
        if self.in_jit and _is_span_call(node):
            # The obs layer's spans read the host clock: inside a
            # compiled region they time the compilation or the capture,
            # not the execution. Spans wrap host-side launches.
            self._emit('clock-in-jit', node,
                       'obs span inside a compiled function or a CUDA-'
                       'graph capture reads the host clock at compile '
                       'time — wrap the launch of the compiled step, '
                       'not its body')
        self.generic_visit(node)

    def visit_If(self, node):
        if self.hot and self._is_traced_expr(node.test):
            self._emit('traced-bool-branch', node,
                       'python `if` on a tensor predicate syncs the card '
                       'to branch on the host — use torch.where / a mask')
        self.generic_visit(node)

    def visit_While(self, node):
        if self.hot and self._is_traced_expr(node.test):
            self._emit('traced-bool-branch', node,
                       'python `while` on a tensor predicate syncs the '
                       'card on every iteration — bound the loop on the '
                       'host')
        self.generic_visit(node)


def _name_targets(tgt):
    if isinstance(tgt, ast.Name):
        yield tgt.id
    elif isinstance(tgt, (ast.Tuple, ast.List)):
        for el in tgt.elts:
            yield from _name_targets(el)


def _outermost_functions(tree):
    """Functions not nested inside another function (module-level and
    method definitions; recursion stops at each found function)."""
    found = []

    def scan(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                found.append(child)
            else:
                scan(child)

    scan(tree)
    return found


def _is_broad_handler(handler):
    t = handler.type
    if t is None:
        return True
    names = t.elts if isinstance(t, ast.Tuple) else [t]
    for n in names:
        name = n.attr if isinstance(n, ast.Attribute) else \
            getattr(n, 'id', None)
        if name in ('Exception', 'BaseException'):
            return True
    return False


def _handler_is_silent(handler):
    """No raise and no logging-ish call anywhere in the handler body."""
    for node in ast.walk(ast.Module(body=handler.body,
                                    type_ignores=[])):
        if isinstance(node, ast.Raise):
            return False
        if isinstance(node, ast.Call):
            name = (node.func.attr if isinstance(node.func, ast.Attribute)
                    else getattr(node.func, 'id', None))
            if name in _LOGGY_NAMES:
                return False
    return True


def _check_silent_except(tree, rel, lines, out):
    for node in ast.walk(tree):
        if not isinstance(node, ast.Try):
            continue
        for handler in node.handlers:
            if _is_broad_handler(handler) and _handler_is_silent(handler):
                if not allowed_by_pragma(lines, handler.lineno,
                                         'silent-except'):
                    out.append(Violation(
                        rule='silent-except',
                        message='broad except that neither re-raises '
                                'nor logs swallows real failures — '
                                'log through utils.tracing.'
                                'log_exception or narrow the type',
                        file=rel, line=handler.lineno))


def lint_file(path, repo_root=None, rules=None):
    """Run the AST ruleset over one file; returns a Violation list."""
    rules = set(rules or AST_RULES)
    rel = (os.path.relpath(path, repo_root) if repo_root
           else os.fspath(path))
    with open(path, encoding='utf-8') as f:
        src = f.read()
    try:
        tree = ast.parse(src, filename=rel)
    except SyntaxError as e:
        # Deliberately NOT subject to the rules filter: a file that
        # doesn't parse can hide any violation, so it always surfaces.
        return [Violation(rule='parse-error', file=rel,
                          line=e.lineno or 0,
                          message=f'file does not parse: {e.msg}')]
    lines = src.splitlines()
    hot = any(frag in os.sep + rel for frag in _HOT_PATH_FRAGMENTS)
    out = []
    if rules & {'host-pull', 'traced-bool-branch', 'clock-in-jit'}:
        # Checker roots are OUTERMOST functions only — nested defs are
        # reached through visit_FunctionDef's recursion, which is also
        # the only path that propagates the enclosing compile context.
        for node in _outermost_functions(tree):
            _FunctionChecker(node, rel, lines, out, hot,
                             in_jit=False).visit(node)
    if 'silent-except' in rules:
        _check_silent_except(tree, rel, lines, out)
    return [v for v in out if v.rule in rules]


def iter_python_files(paths, exclude_fragments=('graphlint_fixtures',
                                                '__pycache__')):
    """Yield .py files under the given files/directories, skipping
    deliberate-violation fixture trees and caches."""
    for p in paths:
        if os.path.isfile(p) and p.endswith('.py'):
            yield p          # explicitly-named files are never excluded
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = [d for d in dirnames
                           if not any(f in d for f in exclude_fragments)]
            for fn in sorted(filenames):
                if fn.endswith('.py'):
                    yield os.path.join(dirpath, fn)


def lint_paths(paths, repo_root=None, rules=None):
    out = []
    for path in iter_python_files(paths):
        out.extend(lint_file(path, repo_root=repo_root, rules=rules))
    return out
