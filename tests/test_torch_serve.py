# -*- coding: utf-8 -*-
"""
The port's continuous-batching ``Scheduler`` over the port's engine
against the reference ``Scheduler`` over the reference engine with the
same weights, on ``examples/serve_lm.py``'s seeded burst (mixed prompt
lengths, a tick every four submissions, a queue small enough to shed
typed rejections), slab and paged, clean and under a NaN + abandon fault
plan: every request's rejection reason, terminal status, typed reason
and tokens must be equal.

Then two of the reference's paged-serving acceptance checks
(``tests/test_serve_paged.py``), run on the port alone: 4x the
concurrent sequences on the slab's KV bytes, and paged streams
bit-identical to slab streams under the fault cocktail.
"""

import numpy as np
import pytest

from distributed_dot_product_tpu.serve import (
    KernelEngine as JaxEngine, RejectedError as JaxRejected,
    Scheduler as JaxScheduler, ServeConfig as JaxConfig,
)
from distributed_dot_product_tpu.utils import faults as jax_faults
from distributed_dot_product_tpu.utils.tracing import (
    MetricsRegistry as JaxRegistry,
)
from distributed_dot_product_tpu_torch.convert import engine_state_from_jax
from distributed_dot_product_tpu_torch.serve import (
    KernelEngine, PolicyConfig, RejectedError, RejectReason, Scheduler,
    ServeConfig, TenantPolicy,
)
from distributed_dot_product_tpu_torch.utils import faults
from distributed_dot_product_tpu_torch.utils.tracing import MetricsRegistry

# examples/serve_lm.py's defaults.
SLOTS, T_MAX, VOCAB, REQUESTS, PROMPT, CHUNK, MAX_NEW, QUEUE = (
    4, 64, 48, 24, 12, 4, 8, 8)
FAULTS = dict(nan_at_step=5, nan_slot=1, abandon_request=3,
              abandon_after_tokens=2)
TERMINAL = {'completed', 'deadline_expired', 'evicted', 'abandoned',
            'failed_nan', 'rejected'}


def build_requests(seed=0):
    """``examples/serve_lm.py``'s ``build_requests``."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(REQUESTS):
        plen = int(rng.integers(1, PROMPT + 1))
        reqs.append((f'req-{i:03d}',
                     rng.integers(0, VOCAB, size=plen).astype(np.int32)))
    return reqs


def run_burst(scheduler, rejected_error):
    """Submit the burst with a tick every four submissions, drain, and
    return ``(rejections, {id: (status, reason, tokens)})``."""
    rejected = {}
    for i, (rid, prompt) in enumerate(build_requests()):
        try:
            scheduler.submit(prompt, request_id=rid)
        except rejected_error as e:
            rejected[rid] = e.reason.value
        if i % 4 == 3:
            scheduler.step()
    results = scheduler.run_until_idle()
    scheduler.close()
    return rejected, {rid: (r.status, r.reason.value if r.reason else None,
                            list(r.tokens)) for rid, r in results.items()}


def _engine_kw(mode):
    kw = dict(slots=SLOTS, t_max=T_MAX, vocab=VOCAB, prefill_chunk=CHUNK,
              seed=0)
    if mode == 'paged':
        kw.update(cache_mode='paged', page_size=4)
    return kw


def _config(cls):
    return cls(queue_limit=QUEUE, max_new_tokens=MAX_NEW, watchdog=False,
               evict_before_reject=False)


@pytest.mark.parametrize('faulted', [False, True],
                         ids=['clean', 'nan_abandon'])
@pytest.mark.parametrize('mode', ['slab', 'paged'])
def test_scheduler_matches_jax(mode, faulted):
    je = JaxEngine(decode_impl='xla', **_engine_kw(mode))
    te = KernelEngine(device='cpu', **_engine_kw(mode))
    te.load_weights(engine_state_from_jax(
        {name: np.asarray(getattr(je, name))
         for name in ('_embed', '_wq', '_wk', '_wv', '_wo')}))
    want = run_burst(JaxScheduler(
        je, _config(JaxConfig), registry=JaxRegistry(),
        fault_injector=(jax_faults.ServeFaultInjector(
            jax_faults.ServeFaultPlan(**FAULTS)) if faulted else False)),
        JaxRejected)
    sched = Scheduler(te, _config(ServeConfig), registry=MetricsRegistry(),
                      fault_injector=(faults.ServeFaultInjector(
                          faults.ServeFaultPlan(**FAULTS)) if faulted
                          else False))
    got = run_burst(sched, RejectedError)
    assert got == want
    rejected, results = got
    assert rejected and all(r == 'queue_full' for r in rejected.values())
    assert set(results) | set(rejected) == {r for r, _ in build_requests()}
    counters = sched.registry.snapshot()['counters']
    if faulted:
        assert counters['serve.nan_quarantined'] == 1
        assert counters['serve.abandoned'] == 1
    assert {s for s, _, _ in results.values()} <= TERMINAL


# -- the reference's paged acceptance checks, on the port ------------------

PS, SLAB_SLOTS = 4, 4
BUDGET_ROWS = SLAB_SLOTS * T_MAX
PAGED_SLOTS, PAGES = 4 * SLAB_SLOTS, BUDGET_ROWS // PS


def _run(mode, slots, n, injector=None, decode_impl='kernel', on_tick=None):
    paged = dict(cache_mode='paged', page_size=PS, pages=PAGES) \
        if mode == 'paged' else {}
    engine = KernelEngine(slots=slots, t_max=T_MAX, vocab=16, heads=2,
                          head_dim=4, prefill_chunk=4, seed=5,
                          decode_impl=decode_impl, device='cpu', **paged)
    sched = Scheduler(engine, ServeConfig(queue_limit=48, max_new_tokens=3,
                                          watchdog=False,
                                          evict_before_reject=False),
                      fault_injector=injector if injector else False,
                      registry=MetricsRegistry(), on_tick=on_tick)
    rng = np.random.default_rng(11)
    burst = [(f'r{i:03d}', rng.integers(0, 16, size=int(rng.integers(1, 7))
                                        ).astype(np.int32))
             for i in range(n)]
    rejected = {}
    for rid, prompt in burst:
        try:
            sched.submit(prompt, request_id=rid)
        except RejectedError as e:
            rejected[rid] = e.reason
    results = sched.run_until_idle()
    sched.close()
    return sched, burst, rejected, results


def test_paged_serves_4x_concurrency_on_slab_bytes():
    """The paged pool holds exactly the slab's KV bytes yet serves 4x
    the concurrent sequences: short requests hold pages for their fill,
    not a t_max strip."""
    peak = {'busy': 0}

    def on_tick(s):
        peak['busy'] = max(peak['busy'], sum(sl.request is not None
                                             for sl in s._slots))

    sched, burst, rejected, results = _run('paged', PAGED_SLOTS,
                                           3 * PAGED_SLOTS, on_tick=on_tick)
    assert peak['busy'] >= 4 * SLAB_SLOTS, peak
    assert not rejected and len(results) == len(burst)
    assert all(r.status == 'completed' for r in results.values())
    assert sched.engine.pool.pages * sched.engine.page_size == BUDGET_ROWS
    assert sched.engine.cache_stats()['pages_used'] == 0


@pytest.mark.parametrize('decode_impl', ['kernel', 'plain'])
def test_paged_streams_bit_identical_to_slab_under_faults(decode_impl):
    """Same traffic and stuck/NaN faults through a slab scheduler and a
    paged one (4x slots, same bytes): every request both complete has the
    same tokens."""
    plan = dict(stuck_at_step=3, stuck_seconds=0.02, nan_at_step=5,
                nan_slot=1)
    n = 20
    _, _, _, res_s = _run('slab', SLAB_SLOTS, n, faults.ServeFaultInjector(
        faults.ServeFaultPlan(**plan)), decode_impl)
    sched, burst, rej_p, res_p = _run(
        'paged', PAGED_SLOTS, n,
        faults.ServeFaultInjector(faults.ServeFaultPlan(**plan)), decode_impl)
    assert sched.registry.snapshot()['counters']['serve.nan_quarantined'] >= 1
    compared = 0
    for rid, rp in res_p.items():
        rs = res_s.get(rid)
        if rs is None or 'completed' not in (rp.status, rs.status) \
                or rp.status != rs.status:
            continue
        assert rp.tokens == rs.tokens, rid
        compared += 1
    assert compared >= 5
    for rid, _ in burst:
        assert rid in res_p or rej_p.get(rid) is not None
        if rid in res_p:
            assert res_p[rid].status in TERMINAL


def test_unported_config_fields_raise_type_error():
    """The fields of what is not ported raise; the speculative-decoding
    and policy fields (ported since) are the reference's."""
    for field in ('anomaly', 'profile_ttft_p99', 'profile_warmup'):
        with pytest.raises(TypeError):
            ServeConfig(**{field: None})
    assert ServeConfig().policy is None
    policy = PolicyConfig(tenants={'t0': TenantPolicy(priority=1)})
    sched = Scheduler(KernelEngine(slots=2, t_max=16, device='cpu'),
                      ServeConfig(policy=policy, watchdog=False),
                      registry=MetricsRegistry(), fault_injector=False)
    assert sched._policy.tenant('t0').priority == 1
    sched.close()
    cfg = ServeConfig(spec='ngram', spec_k=3, spec_max_ngram=2)
    assert (cfg.spec, cfg.spec_k, cfg.spec_max_ngram) == ('ngram', 3, 2)
    default = ServeConfig()
    assert (default.spec, default.spec_k, default.spec_max_ngram) == (
        None, 4, 3)


def test_prefix_riders_and_typed_rejections():
    """Two requests ride one registered prefix (its pages counted once),
    an unknown prefix and an over-long prompt reject with typed reasons."""
    engine = KernelEngine(slots=4, t_max=T_MAX, vocab=16, heads=2,
                          head_dim=4, prefill_chunk=4, seed=5, device='cpu',
                          cache_mode='paged', page_size=PS, pages=PAGES)
    sched = Scheduler(engine, ServeConfig(queue_limit=8, max_new_tokens=4,
                                          watchdog=False),
                      registry=MetricsRegistry(), fault_injector=False)
    pid = engine.register_prefix(np.arange(2 * PS, dtype=np.int32) % 16)
    pages = engine._prefix_registry[pid][0]
    sched.submit([1, 2], prefix_id=pid, request_id='a')
    sched.submit([3, 4], prefix_id=pid, request_id='b')
    sched.step()
    assert all(engine.pool.refcount[p] == 3 for p in pages)
    assert engine.cache_stats()['shared_pages'] == 2
    with pytest.raises(RejectedError) as exc:
        sched.submit([1], prefix_id=99)
    assert exc.value.reason is RejectReason.PREFIX_UNREGISTERED
    with pytest.raises(RejectedError) as exc:
        sched.submit(np.zeros(T_MAX, np.int32))
    assert exc.value.reason is RejectReason.PROMPT_TOO_LONG
    results = sched.run_until_idle()
    sched.close()
    assert {results[r].status for r in ('a', 'b')} == {'completed'}
    assert all(engine.pool.refcount[p] == 1 for p in pages)
