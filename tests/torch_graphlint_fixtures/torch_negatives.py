# -*- coding: utf-8 -*-
"""Seeded graph-rule regressions: TraceSpec builders that each break
exactly ONE contract the port's graph rules (analysis/torch_rules.py)
enforce — the torch twins of tests/graphlint_fixtures/jaxpr_negatives.py,
one per case, under the same names. tests/test_torch_graphlint.py lints
them and asserts each fires the rule id the JAX linter gives its
original. Builders take the device, as the port's registry's do."""

import torch

from distributed_dot_product_tpu_torch.analysis.registry import (
    HEAD_DIM, TraceSpec, example,
)
from distributed_dot_product_tpu_torch.models.decode import (
    append_kv, decode_step, init_cache, init_paged_cache,
    paged_append_kv_slots,
)
from distributed_dot_product_tpu_torch.parallel.mesh import seq_mesh
from distributed_dot_product_tpu_torch.utils.comm import all_gather


def _cache_and_new(device):
    cache = init_cache(1, 2, 32, HEAD_DIM, dtype=torch.bfloat16,
                       device=device)
    new = example((1, 2, 1, HEAD_DIM), torch.bfloat16, device)
    return cache, new


def bad_f32_accum(device):
    """bf16 mm giving bf16 with cuBLAS's reduced-precision reduction
    allowed (torch's default) → the contraction may accumulate narrow."""

    def fn(a, b):
        return torch.mm(a, b)

    return TraceSpec(name='neg.f32_accum', fn=fn,
                     args=(example((16, 8), torch.bfloat16, device),
                           example((8, 16), torch.bfloat16, device, 1)))


def bad_cache_rematerialize(device):
    """The appended cache K buffer is re-materialized by arithmetic
    (`k * 1`) on the way out — the in-place append contract is broken
    even though the VALUES are identical."""

    def fn(cache, k_new, v_new):
        cache = append_kv(cache, k_new, v_new)
        return cache._replace(k=cache.k * 1)

    cache, new = _cache_and_new(device)
    return TraceSpec(
        name='neg.cache_rematerialize', fn=fn, args=(cache, new, new),
        cache_in=lambda a: [a[0].k, a[0].v],
        cache_out=lambda o: [o.k, o.v])


def bad_full_shape_dus(device):
    """An out-of-place index_put whose update is the FULL buffer shape —
    the degenerate 'append' that rewrites the whole cache per step."""

    def fn(cache, k_new, v_new):
        full = torch.broadcast_to(k_new, cache.k.shape)
        rows = torch.arange(cache.k.shape[0], device=cache.k.device)
        return cache._replace(k=cache.k.index_put((rows,), full))

    cache, new = _cache_and_new(device)
    return TraceSpec(
        name='neg.full_shape_dus', fn=fn, args=(cache, new, new),
        cache_in=lambda a: [a[0].k],
        cache_out=lambda o: [o.k])


def bad_paged_pool_rematerialize(device):
    """The paged append done WRONG: the pool buffer is re-materialized
    by arithmetic (`pool * 1`) on the way out — every decode step would
    copy the ENTIRE pool, the exact failure paging exists to avoid."""

    def fn(cache, k_new, v_new):
        cache = paged_append_kv_slots(cache, k_new, v_new)
        return cache._replace(k_pool=cache.k_pool * 1)

    cache = init_paged_cache(1, 2, 32, HEAD_DIM, pages=4, page_size=8,
                             dtype=torch.bfloat16, device=device)
    cache.page_table[0, 0] = 0
    new = example((1, 2, 1, HEAD_DIM), torch.bfloat16, device)
    return TraceSpec(
        name='neg.paged_pool_rematerialize', fn=fn,
        args=(cache, new, new),
        cache_in=lambda a: [a[0].k_pool, a[0].v_pool],
        cache_out=lambda o: [o.k_pool, o.v_pool])


def bad_cache_upcast(device):
    """The upcast formulation: widen the whole K/V buffers to float32
    before the products (full-size copies per step)."""

    def fn(q, cache):
        s = torch.einsum('bhqd,bhtd->bhqt', q.float(), cache.k.float())
        p = torch.softmax(s, dim=-1)
        return torch.einsum('bhqt,bhtd->bhqd', p, cache.v.float())

    cache, new = _cache_and_new(device)
    return TraceSpec(
        name='neg.cache_upcast', fn=fn, args=(new, cache),
        cache_in=lambda a: [a[1].k, a[1].v],
        cache_out=lambda o: [o, o])      # unused by the upcast rule


def bad_missing_donation(device):
    """The real decode step — but returning fresh copies of its cache
    buffers, as if the step had stopped appending in place: it hands
    back none of its input storages and every step copies the cache."""

    def fn(q, cache, k_new, v_new):
        cache, out = decode_step(q, cache, k_new, v_new, impl='plain')
        return cache._replace(k=cache.k.clone(), v=cache.v.clone()), out

    cache, new = _cache_and_new(device)
    return TraceSpec(
        name='neg.missing_donation', fn=fn, args=(new, cache, new, new),
        expect_donation=True, donate_argnums=(), min_donated=2)


def bad_collective_axis(device):
    """A collective on the group of mesh axis 'seq' while the
    registration declares the mesh as ('data',) — topology drift."""
    mesh = seq_mesh()

    def fn(x):
        return all_gather(x, mesh.seq_group)

    return TraceSpec(name='neg.collective_axis', fn=fn,
                     args=(example((1, 8, 4), torch.float32, device),),
                     mesh_axes=('data',))


def bad_trace_error(device):
    """A registration whose entrypoint no longer runs at its declared
    shapes (here: a shape assertion that fires) — reported as
    trace-error, not a crash of the whole run."""

    def fn(x):
        raise ValueError('entrypoint regressed')

    return TraceSpec(name='neg.trace_error', fn=fn,
                     args=(example((4, 4), torch.bfloat16, device),))


ALL = {
    'neg.f32_accum': (bad_f32_accum, 'f32-accum'),
    'neg.cache_rematerialize': (bad_cache_rematerialize, 'cache-alias'),
    'neg.paged_pool_rematerialize': (bad_paged_pool_rematerialize,
                                     'cache-alias'),
    'neg.full_shape_dus': (bad_full_shape_dus, 'cache-alias'),
    'neg.cache_upcast': (bad_cache_upcast, 'cache-upcast'),
    'neg.missing_donation': (bad_missing_donation, 'donation'),
    'neg.collective_axis': (bad_collective_axis, 'collective-axis'),
    'neg.trace_error': (bad_trace_error, 'trace-error'),
}


# CLI-shaped view ({name: builder}) for --registry MODULE:ATTR runs.
REGISTRY = {name: builder for name, (builder, _rule) in ALL.items()}
