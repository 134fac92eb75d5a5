# -*- coding: utf-8 -*-
"""
Central entrypoint registry: the single place where every public
computation of the port declares example inputs, so that ``obs/perf.py``
can run and account for it and ``analysis/torch_rules.py`` can judge the
ops it issues (the port of
``distributed_dot_product_tpu/analysis/registry.py``).

The examples live NEXT TO the code they describe: each layer module
(``ops/functions.py``, ``ops/flash_attention.py``,
``models/attention.py``, ``models/decode.py``, ``models/lm.py``,
``serve/engine.py``, ``train.py``, ``obs/__init__.py``) exposes a
``graphlint_entrypoints()`` hook returning ``{name: builder}``; this
module aggregates them. The names are the reference's, one port entry
per reference entry.

A builder is lazy: ``builder(device)`` makes the module, cache or
engine and the example tensors on ``device`` (``'cpu'`` or ``'cuda'``)
at the reference's registered shapes — but for head dims, which are 32
where the reference registers 8: 32 is the CUDA kernels' narrowest
instantiation (an 8-wide head is padded to it), and one shape on both
devices keeps the CPU baseline and a card snapshot comparable. A spec's ``fn(*args)`` may be called
again and again with the same result: a stateful callable (a decode step
appends in place) restores what it advances. Entries declared over a
mesh (``mesh_axes``) build the seq mesh of the current process group —
the one-rank mesh in a single process, where every collective still
runs (and counts) as the identity.
"""

import dataclasses
from collections import OrderedDict
from typing import Any, Callable, Optional, Tuple

__all__ = ['TraceSpec', 'default_entrypoints', 'resolve_registry_arg',
           'LAYER_HOOKS', 'HEAD_DIM', 'example']

# The head dim of every registered example (the reference's is 8).
HEAD_DIM = 32


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """One runnable entrypoint example.

    ``fn``/``args``: the callable and its example arguments (tensors on
    the builder's device, modules, caches). ``obs/perf.py`` reads these
    two. The others are the declarations the graph rules
    (``analysis/torch_rules.py``) judge the run against: ``mesh_axes``
    (the mesh axes the entrypoint runs over; a collective on the group
    of any other axis violates ``collective-axis``), ``cache_in`` /
    ``cache_out`` (selectors — given ``args`` / the output, return the
    cache buffers, pairwise aligned — for ``cache-alias`` and
    ``cache-upcast``), ``expect_donation`` with ``min_donated`` (the
    step hands back at least that many of its inputs' storages:
    ``donation``), and ``allow`` (rule ids waived for this entry: known
    debt, reported as ``(allowed)``). ``prejitted``, ``donate_argnums``
    and ``static_argnums`` keep the reference's declarations and mean
    nothing to an eager step.
    """
    name: str
    fn: Callable
    args: Tuple[Any, ...]
    mesh_axes: Tuple[str, ...] = ()
    cache_in: Optional[Callable] = None
    cache_out: Optional[Callable] = None
    expect_donation: bool = False
    prejitted: bool = False
    donate_argnums: Tuple[int, ...] = ()
    static_argnums: Tuple[int, ...] = ()
    min_donated: int = 1
    allow: Tuple[str, ...] = ()

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


# Every layer that registers entrypoints (the reference's list).
LAYER_HOOKS = (
    'distributed_dot_product_tpu_torch.ops.functions',
    'distributed_dot_product_tpu_torch.ops.flash_attention',
    'distributed_dot_product_tpu_torch.models.attention',
    'distributed_dot_product_tpu_torch.models.decode',
    'distributed_dot_product_tpu_torch.models.lm',
    'distributed_dot_product_tpu_torch.serve.engine',
    'distributed_dot_product_tpu_torch.train',
    'distributed_dot_product_tpu_torch.obs',
)


def resolve_registry_arg(arg):
    """``MODULE:ATTR`` → a ``{name: builder}`` mapping (callables are
    called) — the ``--registry`` escape hatch of the perf CLI. Raises
    ValueError on a malformed argument."""
    import importlib
    modpath, _, attr = arg.partition(':')
    if not attr:
        raise ValueError('--registry takes MODULE:ATTR')
    obj = getattr(importlib.import_module(modpath), attr)
    return obj() if callable(obj) else obj


def default_entrypoints():
    """Aggregate every layer's ``graphlint_entrypoints()`` hook into one
    ordered ``{name: builder}`` registry. Name collisions are an error —
    the registry is the namespace perf reports against."""
    import importlib
    registry = OrderedDict()
    for modpath in LAYER_HOOKS:
        mod = importlib.import_module(modpath)
        hook = getattr(mod, 'graphlint_entrypoints', None)
        if hook is None:
            raise AttributeError(
                f'{modpath} is listed in LAYER_HOOKS but defines no '
                f'graphlint_entrypoints() hook')
        for name, builder in hook().items():
            if name in registry:
                raise ValueError(f'duplicate entrypoint registration: '
                                 f'{name!r} (from {modpath})')
            registry[name] = builder
    return registry


def example(shape, dtype, device, seed=0):
    """A seeded standard-normal example tensor on ``device``."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen).to(device=device, dtype=dtype)

