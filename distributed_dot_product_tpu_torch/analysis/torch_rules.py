# -*- coding: utf-8 -*-
"""
Graph rules: run a registered entrypoint once, on the device it is
given, under a dispatch mode, and judge the aten ops it issues — the
port's counterpart of ``distributed_dot_product_tpu/analysis/
jaxpr_rules.py``, with the same rule ids (:data:`JAXPR_RULES`). The
reference traces a jaxpr without running it; the port runs eagerly, so
its graph is the stream of aten ops one call dispatches, seen through
the byte-counting mode of ``obs/perf.py`` (:func:`~distributed_dot_
product_tpu_torch.obs.perf._byte_mode`'s ``observe`` hook):

- ``f32-accum``   — every matmul-family op (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, ``_int_mm``, ``linear``) with a bf16/f16/int8 operand
  gives a float32 / int32 result, or runs with cuBLAS's reduced-
  precision reduction off (``torch.backends.cuda.matmul.allow_bf16_
  reduced_precision_reduction`` / ``allow_fp16_...``).
- ``cache-upcast`` — no ``_to_copy`` widens a tensor whose shape is a
  declared cache's (``TraceSpec.cache_in``).
- ``cache-alias`` — each ``cache_in`` buffer comes back in ``cache_out``
  as the same storage, and no op builds a cache-shaped tensor out of
  place from a cache input (``cat``, ``clone``, out-of-place
  ``index_put`` / ``scatter``, arithmetic): the in-place append stays in
  place.
- ``donation`` — a spec declared ``expect_donation`` hands back at least
  ``min_donated`` of its inputs' storages.
- ``collective-axis`` — every collective issued through
  ``utils/comm.py`` runs on the process group of an axis of the
  declared mesh (``TraceSpec.mesh_axes``): the groups of the meshes the
  spec built (``parallel/mesh.py``), by axis name.
- ``trace-error`` — a builder or a run that raises is reported, never
  crashes the whole run.

The CUDA kernels are invisible here: they are launched through their
own bindings, not registered as torch ops, so the mode sees only the
aten ops around them. Their float32 accumulation is held by
``chip_smoke.py``'s comparisons with their plain versions; on the CPU
the plain versions themselves run, and their ops are judged like any
other.
"""

import dataclasses
import os
import traceback

from distributed_dot_product_tpu_torch.analysis.base import Violation

__all__ = ['JAXPR_RULES', 'lint_spec', 'lint_entrypoints']

JAXPR_RULES = ('f32-accum', 'cache-alias', 'cache-upcast',
               'collective-axis', 'donation', 'trace-error')

_MATMULS = ('mm', 'bmm', 'addmm', 'baddbmm', '_int_mm', 'linear')
# Out-of-place ops that rebuild a whole buffer from their input (the
# in-place twins end in '_' and write their input): given a cache, each
# materializes a copy of it. A read (a gather, a product) makes no
# cache-shaped tensor of the cache and is not one.
_REMATERIALIZERS = ('cat', 'stack', 'clone', 'copy', 'index_put',
                    'index_copy', 'index_add', 'index_fill', 'scatter',
                    'scatter_add', 'scatter_reduce', 'masked_scatter',
                    'masked_fill', 'where', 'add', 'sub', 'mul', 'div')

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(_PKG_DIR)
_SKIP_DIRS = (os.path.join(_PKG_DIR, 'analysis'),
              os.path.join(_PKG_DIR, 'obs', 'perf.py'))


def _src():
    """(file, line) of the innermost frame outside torch and this
    subsystem that issued the current op — repo-relative where the file
    is in the repo — or (None, None)."""
    import torch
    torch_dir = os.path.dirname(os.path.abspath(torch.__file__))
    for frame in reversed(traceback.extract_stack()):
        f = os.path.abspath(frame.filename)
        if f.startswith(torch_dir) or f.startswith(_SKIP_DIRS):
            continue
        if f.startswith(_REPO + os.sep):
            f = os.path.relpath(f, _REPO)
        return f, frame.lineno
    return None, None


def _leaves(obj, out=None):
    """Every tensor in ``obj``: tensors, tuples, lists, dicts, named
    tuples and dataclasses of them, and a module's parameters and
    buffers."""
    import torch
    out = [] if out is None else out
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            _leaves(v, out)
    elif isinstance(obj, dict):
        for v in obj.values():
            _leaves(v, out)
    elif isinstance(obj, torch.nn.Module):
        out.extend(obj.parameters())
        out.extend(obj.buffers())
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _leaves(getattr(obj, f.name), out)
    return out


def _storage(t):
    return t.untyped_storage().data_ptr()


def _wide(dtype, low_int):
    import torch
    if low_int:
        return dtype in (torch.int32, torch.int64)
    return dtype in (torch.float32, torch.float64)


class _Recorder:
    """The observer the byte mode calls after each aten op: counts the
    ops and judges each one against the per-op rules as it runs (the
    stack then still names the line that issued it)."""

    def __init__(self, spec, rules, cache_shapes, cache_storages):
        import torch
        self.spec = spec
        self.rules = rules
        self.cache_shapes = cache_shapes
        self.cache_storages = cache_storages
        self.ops = 0
        self.out = []
        self._low_f = (torch.bfloat16, torch.float16)
        self._low_i = (torch.int8, torch.uint8)

    def _flag(self, rule, msg):
        f, ln = _src()
        self.out.append(Violation(rule=rule, file=f, line=ln,
                                  entrypoint=self.spec.name, message=msg))

    def __call__(self, func, args, kwargs, out):
        import torch
        self.ops += 1
        name = func._schema.name.split('::')[-1]
        ins = _leaves((args, kwargs))
        outs = _leaves(out)
        if name in _MATMULS and 'f32-accum' in self.rules:
            self._check_matmul(name, ins, outs)
        if not self.cache_shapes:
            return
        if name == '_to_copy' and 'cache-upcast' in self.rules:
            src = ins[0]
            dst = outs[0] if outs else None
            if (tuple(src.shape) in self.cache_shapes and dst is not None
                    and dst.element_size() > src.element_size()):
                self._flag('cache-upcast',
                           f'cache-shaped {tuple(src.shape)} tensor upcast '
                           f'{src.dtype} → {dst.dtype}: this materializes a '
                           f'full-size copy of the cache every step — keep '
                           f'the buffer narrow and accumulate wide in the '
                           f'product instead')
        if 'cache-alias' in self.rules and name in _REMATERIALIZERS:
            from_cache = any(t.numel() and _storage(t) in self.cache_storages
                             for t in ins)
            if from_cache and any(
                    tuple(o.shape) in self.cache_shapes
                    and _storage(o) not in self.cache_storages
                    for o in outs):
                self._flag('cache-alias',
                           f'{name} builds a cache-shaped tensor out of '
                           f'place from a cache buffer — the in-place '
                           f'append degrades into a full cache copy per '
                           f'step')

    def _check_matmul(self, name, ins, outs):
        import torch
        dtypes = [t.dtype for t in ins]
        low_f = any(d in self._low_f for d in dtypes)
        low_i = any(d in self._low_i for d in dtypes)
        if not (low_f or low_i) or not outs:
            return
        res = outs[0].dtype
        if _wide(res, low_i):
            return
        flags = torch.backends.cuda.matmul
        reduced = ((torch.bfloat16 in dtypes
                    and flags.allow_bf16_reduced_precision_reduction)
                   or (torch.float16 in dtypes
                       and flags.allow_fp16_reduced_precision_reduction))
        if low_f and not low_i and not reduced:
            return
        self._flag('f32-accum',
                   f'{name} on {"/".join(str(d) for d in dtypes)} operands '
                   f'gives {res} with reduced-precision reduction allowed '
                   f'— ask for a {"int32" if low_i else "float32"} result '
                   f'(or turn the reduced-precision reduction off) so the '
                   f'contraction accumulates wide')


def _check_collectives(spec, calls, meshes, out):
    declared = set(spec.mesh_axes)
    for kind, group in calls:
        axes = {axis for m in meshes
                for axis, g in m.axis_groups().items() if g is group}
        if axes & declared:
            continue
        where = (f'the group of axis {sorted(axes)}' if axes
                 else 'a group of no mesh the entrypoint built')
        out.append(Violation(
            rule='collective-axis', entrypoint=spec.name,
            message=f'{kind} on {where}, which is not on the declared '
                    f'mesh (mesh_axes={sorted(declared) or "()"})'))


def _check_donation(spec, in_leaves, out_leaves, out):
    ins = {_storage(t) for t in in_leaves if t.numel()}
    back = {_storage(t) for t in out_leaves if t.numel()} & ins
    needed = max(1, spec.min_donated)
    if len(back) < needed:
        out.append(Violation(
            rule='donation', entrypoint=spec.name,
            message=f'entrypoint declares donated buffers but hands back '
                    f'{len(back)} of its input storage(s) (expected >= '
                    f'{needed}) — every step then writes fresh buffers '
                    f'in place of appending to its inputs'))


def _check_cache_storages(spec, cache_in, cache_out, out):
    for i, (a, b) in enumerate(zip(cache_in, cache_out)):
        if _storage(a) != _storage(b):
            out.append(Violation(
                rule='cache-alias', entrypoint=spec.name,
                message=f'cache buffer {i} ({tuple(a.shape)} {a.dtype}) '
                        f'comes back as a different storage — it is '
                        f're-materialized, so the in-place append '
                        f'degrades into a full cache copy per step'))


def _first_line(e):
    return str(e).splitlines()[0] if str(e) else repr(e)


def lint_spec(spec, rules=None, stats=None, meshes=()):
    """Run one TraceSpec once under the rules' dispatch mode; returns a
    Violation list. ``meshes``: the meshes its builder made (the run's
    own are added); ``stats``, a dict, receives ``ops`` (the aten ops
    the run dispatched, all of them checked)."""
    from distributed_dot_product_tpu_torch.obs.perf import _byte_mode
    from distributed_dot_product_tpu_torch.parallel import mesh as mesh_mod
    from distributed_dot_product_tpu_torch.utils import comm
    rules = set(rules or JAXPR_RULES)
    cache_in = list(spec.cache_in(spec.args)) if spec.cache_in else []
    cache_shapes = {tuple(t.shape) for t in cache_in}
    rec = _Recorder(spec, rules, cache_shapes,
                    {_storage(t) for t in cache_in})
    calls, meshes = [], list(meshes)
    note = lambda kind, group: calls.append((kind, group))
    comm._OBSERVERS.append(note)
    mesh_mod._OBSERVERS.append(meshes.append)
    try:
        in_leaves = _leaves(spec.args)
        with _byte_mode(observe=rec):
            result = spec.fn(*spec.args)
    except Exception as e:  # graphlint: allow[silent-except]
        return [Violation(    # reported AS a violation, not swallowed
            rule='trace-error', entrypoint=spec.name,
            message=f'entrypoint failed to run at its registered '
                    f'shapes: {type(e).__name__}: {_first_line(e)}')]
    finally:
        comm._OBSERVERS.remove(note)
        mesh_mod._OBSERVERS.remove(meshes.append)
        if stats is not None:
            stats['ops'] = rec.ops
    out = rec.out
    if 'cache-alias' in rules and spec.cache_out is not None:
        cache_out = list(spec.cache_out(result))
        if len(cache_out) != len(cache_in):
            raise ValueError(f'{spec.name}: cache_in/cache_out selector '
                             f'arity mismatch')
        _check_cache_storages(spec, cache_in, cache_out, out)
    if 'collective-axis' in rules:
        _check_collectives(spec, calls, meshes, out)
    if 'donation' in rules and spec.expect_donation:
        _check_donation(spec, in_leaves, _leaves(result), out)
    if spec.allow:
        # Registration-level waiver (TraceSpec.allow): the violation
        # stays in the output as visible debt, flagged allowed so the
        # CLI exit code and the clean-tree gate ignore it.
        out = [dataclasses.replace(v, allowed=True)
               if v.rule in spec.allow else v for v in out]
    return out


def _kernel_launches():
    """``{kernel: launches}`` of the port's CUDA kernel wrappers."""
    from distributed_dot_product_tpu_torch.obs.perf import KERNEL_COSTS
    import distributed_dot_product_tpu_torch as ddp
    return {name: getattr(getattr(ddp, name), 'launches', 0)
            for name in KERNEL_COSTS}


def lint_entrypoints(entrypoints, rules=None, device='cuda', stats=None):
    """Lint a registry mapping ``{name: builder}``, each built on
    ``device``; builder errors are reported as trace-error violations,
    never raised. ``stats``, a dict, receives per entry ``{'ops': aten
    ops checked, 'kernels': {kernel: launches in the run}}``."""
    from distributed_dot_product_tpu_torch.parallel import mesh as mesh_mod
    out = []
    for name, build in entrypoints.items():
        meshes = []
        mesh_mod._OBSERVERS.append(meshes.append)
        try:
            spec = build(device)
            if spec.name != name:
                spec = spec.replace(name=name)
        except Exception as e:  # graphlint: allow[silent-except]
            out.append(Violation(  # reported AS a violation, not swallowed
                rule='trace-error', entrypoint=name,
                message=f'entrypoint builder failed: '
                        f'{type(e).__name__}: {_first_line(e)}'))
            if stats is not None:
                stats[name] = {'ops': 0, 'kernels': {}}
            continue
        finally:
            mesh_mod._OBSERVERS.remove(meshes.append)
        before = _kernel_launches()
        entry = {}
        out.extend(lint_spec(spec, rules=rules, stats=entry, meshes=meshes))
        if stats is not None:
            after = _kernel_launches()
            entry['kernels'] = {k: after[k] - before[k] for k in after
                                if after[k] != before[k]}
            stats[name] = entry
    return out
