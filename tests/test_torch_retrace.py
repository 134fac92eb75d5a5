# -*- coding: utf-8 -*-
"""
The port's retrace sentinel (analysis/retrace.py) held against the
reference's: the counterparts of tests/test_graphlint.py's sentinel tests,
each with the JAX count of the same call sequence beside the port's.

A *trace* in the port is the first call with a new input signature (each
tensor argument's shape, dtype and device, plus the hashable non-tensor
arguments), what ``jax.jit`` keys its cache on. So a fixed-shape step
counts 1 however many tokens it serves, and a step rebuilt per token
gets a fresh counter each time — the name total exposes the storm.

The JAX side runs with ``DDP_TPU_RETRACE_SENTINEL=0`` where its serving
engine's prefill trips its own budget (ROADMAP §3); the port's sentinel
stays on (it is on under pytest).
"""

import numpy as np
import pytest
import torch

from distributed_dot_product_tpu.analysis import retrace as jretrace
from distributed_dot_product_tpu_torch.analysis import retrace

pytestmark = pytest.mark.analysis


@pytest.fixture(autouse=True)
def _port_retrace_isolation():
    """The port's counters start at zero in every test (the reference's
    conftest resets its own)."""
    retrace.reset()
    yield
    retrace.reset()


@pytest.fixture(autouse=True)
def _cyclic_gc_paused():
    """The reference's retrace counters take their registry's lock in
    their finalizer, and its engines sit in reference cycles: a cyclic
    collection inside one of its locked sections deadlocks the thread
    (ROADMAP §3). The JAX side of these tests runs with the collector
    paused, and collections run only before and after each test, where
    no such section is open (so no test leaves its engines' cycles for
    a later test's section to collect)."""
    import gc
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.collect()
        gc.enable()


def test_api_is_the_references():
    for name in jretrace.__all__:
        assert hasattr(retrace, name), name
    assert retrace.ENV_VAR == jretrace.ENV_VAR == 'DDP_TPU_RETRACE_SENTINEL'
    assert issubclass(retrace.RetraceBudgetExceeded, RuntimeError)


def _jax_storm_counts():
    """The reference's storm sequence: two calls at one shape, then a
    new shape — its counts after each, and whether the third raised."""
    import jax
    import jax.numpy as jnp
    watched = jretrace.watch_traces(lambda x: x * 2, 'unit.storm', budget=1)
    step = jax.jit(watched)
    counts = []
    step(jnp.ones((2,)))
    counts.append(watched._graphlint_counter.count)
    step(jnp.ones((2,)))
    counts.append(watched._graphlint_counter.count)
    try:
        step(jnp.ones((3,)))
        raised = False
    except jretrace.RetraceBudgetExceeded:
        raised = True
    return counts, raised


def test_retrace_budget_raises_on_seeded_storm():
    want_counts, want_raised = _jax_storm_counts()
    watched = retrace.watch_traces(lambda x: x * 2, 'unit.storm', budget=1)
    watched(torch.ones(2))
    counts = [watched._graphlint_counter.count]
    watched(torch.ones(2))            # same signature: no new trace
    counts.append(watched._graphlint_counter.count)
    assert counts == want_counts == [1, 1]
    assert want_raised
    with pytest.raises(retrace.RetraceBudgetExceeded, match='unit.storm'):
        watched(torch.ones(3))        # new shape → second trace > budget


def test_retrace_disabled_counts_but_never_raises(monkeypatch):
    import jax
    import jax.numpy as jnp
    monkeypatch.setenv(retrace.ENV_VAR, '0')
    jw = jretrace.watch_traces(lambda x: x + 1, 'unit.disabled', budget=1)
    jstep = jax.jit(jw)
    jstep(jnp.ones((2,)))
    jstep(jnp.ones((3,)))
    watched = retrace.watch_traces(lambda x: x + 1, 'unit.disabled',
                                   budget=1)
    watched(torch.ones(2))
    watched(torch.ones(3))            # over budget, but sentinel is off
    assert watched._graphlint_counter.count == \
        jw._graphlint_counter.count == 2


def test_signature_keys():
    """Shapes, dtypes and devices count; values do not; python and
    numpy integers are one kind (0-d ints, as jax.jit traces them);
    hashable non-tensor arguments count by value."""
    seen = []
    watched = retrace.watch_traces(lambda *a, **k: seen.append(a), 'unit.sig',
                                   budget=10)
    c = watched._graphlint_counter
    watched(torch.zeros(2, 3), 1, np.zeros(4, np.int64), flag='a')
    watched(torch.ones(2, 3), np.int64(7), np.ones(4, np.int64), flag='a')
    assert c.count == 1
    watched(torch.ones(2, 3, dtype=torch.bfloat16), 1, np.ones(4, np.int64),
            flag='a')
    assert c.count == 2
    watched(torch.ones(2, 3), 1.0, np.ones(4, np.int64), flag='a')
    assert c.count == 3
    watched(torch.ones(2, 3), 1, np.ones(4, np.int64), flag='b')
    assert c.count == 4
    assert retrace.total('unit.sig') == 4
    assert retrace.snapshot()['unit.sig'] == (4, 10)


def _jax_decode(devices, rebuild, monkeypatch, tokens=6):
    """The reference's decode_seq_parallel over ``tokens`` tokens — its
    LRU-cached step (``rebuild=False``) or the unhashable-module storm —
    and the name total after each token. The reference's
    ``_axis_env_size`` calls ``jax.core.axis_frame``, which this jax
    lacks (ROADMAP §3): inside the 2-wide mesh it is answered here with
    the mesh's width, at run time — the package is not edited."""
    import jax
    import jax.numpy as jnp
    from distributed_dot_product_tpu.models import attention as A
    from distributed_dot_product_tpu.models import decode as jdecode
    from distributed_dot_product_tpu.parallel.mesh import seq_mesh
    if not hasattr(jax.core, 'axis_frame'):
        monkeypatch.setattr(jdecode, '_axis_env_size',
                            lambda name: 1 if name is None else 2)
    kw = ({'alibi_slopes': np.array([0.25, 0.5], np.float32)} if rebuild
          else {})
    module = A.DistributedDotProductAttn(
        key_dim=8, num_heads=2, causal=True, softmax_impl='flash',
        dtype=jnp.float32, **kw)
    mesh = seq_mesh(2, devices=devices)
    x = jnp.zeros((1, 8, 8), jnp.float32)
    params = module.init(jax.random.key(0), x, x, x, None)
    cache = module.make_decode_cache(1, 16)
    tok = jnp.zeros((1, 1, 8), jnp.float32)
    A._DECODE_STEPS.clear()
    jretrace.reset()
    totals = []
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        for _ in range(tokens):
            cache, _out = A.decode_seq_parallel(module, params, mesh, tok,
                                                tok, tok, cache)
            totals.append(jretrace.total('attention.make_decode_step'))
    return totals


def _port_decode(rebuild, tokens=6):
    """The port's twin call sequence: decode_seq_parallel's cached step,
    or a step rebuilt per token (make_decode_step inside the loop)."""
    from distributed_dot_product_tpu_torch.models import attention as A
    from distributed_dot_product_tpu_torch.parallel.mesh import (
        seq_mesh, shard_decode_cache,
    )
    module = A.DistributedDotProductAttn(
        key_dim=64, num_heads=2, causal=True, softmax_impl='flash',
        dtype=torch.float32, device='cpu',
        generator=torch.Generator().manual_seed(0))
    mesh = seq_mesh()
    cache = shard_decode_cache(module.make_decode_cache(1, 16), mesh)
    tok = torch.zeros((1, 1, 64))
    totals = []
    with torch.no_grad():
        for _ in range(tokens):
            if rebuild:
                step = A.make_decode_step(module, mesh)
                cache, _out = step(tok, tok, tok, cache)
            else:
                cache, _out = A.decode_seq_parallel(module, mesh, tok, tok,
                                                    tok, cache)
            totals.append(retrace.total('attention.make_decode_step'))
    return totals


def test_decode_seq_parallel_traces_once_across_tokens(devices,
                                                      monkeypatch):
    """Tokens through decode_seq_parallel's cached step cost a fixed
    number of traces, however many tokens: the reference's jit traces
    the first token and at most once more (when the fresh cache's weakly
    typed length becomes the step's int32 one); the port's signature
    stays the first one, so it counts 1 — never more than the
    reference."""
    want = _jax_decode(devices, False, monkeypatch)
    got = _port_decode(False)
    assert got == [1] * len(got)
    assert want[-1] == want[2] <= 2          # steady after the respin
    assert all(g <= w for g, w in zip(got, want))


def test_decode_step_rebuild_storm_is_visible(devices, monkeypatch):
    """A step rebuilt per token can't trip a per-instance budget — each
    rebuild gets a fresh counter — but the name total exposes it: N
    tokens, N traces, as the reference's unhashable-module storm."""
    want = _jax_decode(devices, True, monkeypatch)
    got = _port_decode(True)
    assert got == want == list(range(1, len(got) + 1))


def test_engine_programs_trace_once():
    """The serving engine's fixed-shape decode program traces exactly
    once across a multi-step serve loop, as the reference's."""
    from distributed_dot_product_tpu.serve.engine import (
        KernelEngine as JEngine,
    )
    from distributed_dot_product_tpu_torch.serve.engine import KernelEngine
    jretrace.reset()
    jeng = JEngine(slots=2, t_max=8, decode_impl='xla')
    eng = KernelEngine(slots=2, t_max=8, decode_impl='plain', device='cpu')
    for e in (jeng, eng):
        tokens = np.zeros(2, np.int32)
        active = np.ones(2, bool)
        for _ in range(4):
            tokens, _finite = e.step(tokens, active)
    assert retrace.total('engine.decode') == \
        jretrace.total('engine.decode') == 1


def _burst(serve, rt, **eng_kw):
    """Six seeded requests through a paged engine's Scheduler to the
    end; the watched programs' totals."""
    rt.reset()
    eng = serve.KernelEngine(slots=2, t_max=64, vocab=32, seed=3,
                             prefill_chunk=8, cache_mode='paged',
                             page_size=16, **eng_kw)
    sched = serve.Scheduler(eng, serve.ServeConfig(watchdog=False))
    rng = np.random.default_rng(0)
    for _ in range(6):
        sched.submit(rng.integers(1, 32, size=int(rng.integers(2, 20))),
                     max_new_tokens=6)
    for _ in range(200):
        sched.step()
    return {n: c for n, c in rt.totals().items() if n.startswith('engine.')}


def test_serving_burst_totals_equal_the_references(monkeypatch):
    """Every program of a paged serving burst (decode, prefill, reset)
    sees one signature: the port's totals are the reference's."""
    from distributed_dot_product_tpu import serve as jserve
    from distributed_dot_product_tpu_torch import serve as tserve
    monkeypatch.setenv(retrace.ENV_VAR, '0')
    want = _burst(jserve, jretrace, decode_impl='xla')
    monkeypatch.delenv(retrace.ENV_VAR)
    got = _burst(tserve, retrace, decode_impl='plain', device='cpu')
    assert got == want
    assert got['engine.decode'] == got['engine.prefill'] == 1


def test_lm_generation_programs_trace_once():
    """greedy_generate keeps one prefill and one step program per
    (batch, prompt, t_max): two calls, N tokens each, one trace each."""
    from distributed_dot_product_tpu_torch.models.lm import (
        TransformerLM, greedy_generate,
    )
    model = TransformerLM(vocab_size=32, dim=64, num_heads=2, n_layers=1,
                          device='cpu',
                          generator=torch.Generator().manual_seed(0))
    prompt = torch.zeros((1, 4), dtype=torch.int64)
    a = greedy_generate(model, prompt, 5, 16)
    b = greedy_generate(model, prompt, 5, 16)
    assert torch.equal(a, b)
    assert retrace.total('lm.generate_prefill') == 1
    assert retrace.total('lm.generate_step') == 1


def test_totals_survive_a_dropped_step():
    """A counter folds its count into the name total when its wrapper is
    collected, so totals() is exact whatever the GC timing."""
    import gc
    w = retrace.watch_traces(lambda x: x, 'unit.gone', budget=2)
    w(torch.ones(1))
    del w
    gc.collect()
    assert retrace.totals()['unit.gone'] == 1
    retrace.reset()
    assert retrace.total('unit.gone') == 0


def test_finalizing_a_counter_under_the_registry_lock_does_not_deadlock():
    """A watched step sits in a reference cycle with its engine or module,
    so the cyclic collector may finalize its counter at any allocation —
    also inside a section of this thread that holds the registry's lock
    (a whole-suite stall showed it). The count still reaches the total."""
    import gc
    import threading
    done = []

    def run():
        class Holder:
            pass
        h = Holder()
        h.step = retrace.watch_traces(lambda x: x, 'unit.cycle', budget=2)
        h.step(torch.ones(1))
        h.me = h                  # a cycle: only the collector frees it
        del h
        with retrace._COUNTERS_LOCK:
            gc.collect()
        done.append(retrace.total('unit.cycle'))

    t = threading.Thread(target=run, daemon=True, name='retrace-gc-test')
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), 'finalizing a counter under the lock hung'
    assert done == [1]
