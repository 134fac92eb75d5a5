# -*- coding: utf-8 -*-
"""
Shared harness of the port's serving tests that run one scenario on both
packages: the port's topology (every member loaded with the reference
engine's weights, float32 on the CPU) and the reference's
``build_serving`` with the same settings, driven on the same virtual clock.
A scenario is ``scenario(side, tmp_path)``; :func:`both` runs it on each
side and asserts the two returns are equal.
"""

import gc
import types

import numpy as np
import pytest

from distributed_dot_product_tpu import obs as jobs
from distributed_dot_product_tpu import serve as jserve
from distributed_dot_product_tpu.obs import doctor as jdoctor
from distributed_dot_product_tpu.obs import flight as jflight
from distributed_dot_product_tpu.utils import faults as jfaults
from distributed_dot_product_tpu.utils import tracing as jtracing
from distributed_dot_product_tpu_torch import obs as tobs
from distributed_dot_product_tpu_torch import serve as tserve
from distributed_dot_product_tpu_torch.convert import engine_state_from_jax
from distributed_dot_product_tpu_torch.obs import doctor as tdoctor
from distributed_dot_product_tpu_torch.obs import flight as tflight
from distributed_dot_product_tpu_torch.utils import faults as tfaults
from distributed_dot_product_tpu_torch.utils import tracing as ttracing

JAX = types.SimpleNamespace(
    name='jax', serve=jserve, faults=jfaults, read=jobs.read_events,
    recon=jobs.reconstruct, flight=jflight, doctor=jdoctor,
    registry=jtracing.MetricsRegistry, obs=jobs)
PORT = types.SimpleNamespace(
    name='port', serve=tserve, faults=tfaults, read=tobs.read_events,
    recon=tobs.reconstruct, flight=tflight, doctor=tdoctor,
    registry=ttracing.MetricsRegistry, obs=tobs)
SIDES = (PORT, JAX)


@pytest.fixture(scope='module', autouse=True)
def cyclic_gc_paused():
    """Autouse in every test module that imports it: the reference's
    retrace counters take their registry's lock in their finalizer, and
    its engines sit in reference cycles, so a cyclic collection inside
    one of its locked sections deadlocks the thread (ROADMAP §3). The
    module's tests run with the collector paused, and collections run
    only before its first test and after its last, where no such section
    is open: the module collects inside none, and leaves none of its
    engines' cycles for a later module's sections."""
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.collect()
        gc.enable()

_STATES = {}


def state(seed, vocab=32, **kw):
    """The reference engine's weights of ``seed`` (and ``heads`` /
    ``head_dim`` in ``kw``), as the port loads them."""
    key = (seed, vocab, tuple(sorted(kw.items())))
    if key not in _STATES:
        je = jserve.KernelEngine(slots=1, t_max=16, vocab=vocab, seed=seed,
                                 decode_impl='xla', **kw)
        _STATES[key] = engine_state_from_jax(
            {n: np.asarray(getattr(je, n))
             for n in ('_embed', '_wq', '_wk', '_wv', '_wo')})
    return _STATES[key]


def load(router, members=None, weights=None):
    """The reference's weights (``weights``, default seed 3's) into every
    (or the named) port member."""
    engines = [r.engine for r in router.pool.replicas
               if members is None or r.name in members]
    if router.pool.prefill is not None and (
            members is None or router.pool.prefill.name in members):
        engines.append(router.pool.prefill.engine)
    for eng in engines:
        eng.load_weights(weights if weights is not None else state(3))


def serving(side, tmp_path, clock, *, chaos=None, replicas=2,
            threshold=100, queue_limit=8, max_new=6, slots=2,
            integrity=False, **router_kw):
    """A topology with FAST probes on the virtual clock (and an every-tick
    scrub when ``integrity``), ``chaos`` armed."""
    router_kw.setdefault('probe_interval', 0.02)
    router_kw.setdefault('probe_backoff_max', 0.04)
    if integrity:
        router_kw.setdefault('integrity_interval', 0.0)
    topo = dict(decode_replicas=replicas, slots=slots, t_max=64,
                page_size=16, vocab=32, seed=3)
    topo.update(device='cpu') if side is PORT else topo.update(
        decode_impl='xla')
    router = side.serve.build_serving(
        side.serve.TopologyConfig(**topo),
        serve_config=side.serve.ServeConfig(
            watchdog=False, queue_limit=queue_limit,
            max_new_tokens=max_new),
        router_config=side.serve.RouterConfig(prefill_threshold=threshold,
                                              **router_kw),
        clock=clock, log_dir=tmp_path / side.name / 'logs', chaos=chaos)
    if side is PORT:
        load(router)
    return router


def settle(router, clock, dt=0.01, max_ticks=5000):
    """run_until_idle with the clock ADVANCING: probe deadlines are
    virtual time, so a static clock would never detect a loss."""
    ticks = 0
    while router.step():
        clock.advance(dt)
        ticks += 1
        assert ticks < max_ticks, 'topology never settled'
    return router.results


def prompts(n, length=6):
    return {f'p{i}': list(((np.arange(length) * 3 + i) % 32) + 1)
            for i in range(n)}


def long_prompt(length=18, salt=0):
    return list(((np.arange(length) * 5 + salt) % 31) + 1)


def member(router, name):
    return next(r for r in router.pool.replicas if r.name == name)


ARC_FIELDS = ('event', 'request_id', 'target', 'reason', 'in_flight',
              'requeued', 'state', 'misses', 'from_replica', 'recoveries',
              'policy', 'pages', 'site', 'replicas', 'kind', 'tick', 'page',
              'knob', 'value', 'previous', 'direction', 'ts')
ARCS = ('replica.lost', 'replica.probe', 'request.recovered',
        'replica.rejoin', 'router.route', 'serve.reject', 'kv.corrupt',
        'prefill.lost', 'fault.inject', 'control.adjust', 'control.scale',
        'control.drain', 'anomaly.detected')


def arcs(side, router, name='router'):
    """The log's failure-domain, chaos, control and routing records, in
    order, with the fields both packages write (``ts`` included: both
    run the same virtual clock)."""
    path = dict(router.pool.logs())[name]
    return [{k: r.get(k) for k in ARC_FIELDS}
            for r in side.read(path) if r['event'] in ARCS]


def outcomes(results):
    return {rid: (r.status, r.reason.value if r.reason else None,
                  list(r.tokens)) for rid, r in results.items()}


def counters(router):
    return dict(router.registry.snapshot()['counters'])


def both(tmp_path, scenario):
    """``scenario(side, tmp_path)`` on the port, then on the reference;
    returns the port's result after asserting the two are equal."""
    port = scenario(PORT, tmp_path)
    assert port == scenario(JAX, tmp_path)
    return port
