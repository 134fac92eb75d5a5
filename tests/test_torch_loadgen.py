# -*- coding: utf-8 -*-
"""
The port's seeded load generator (``serve/loadgen.py``) and scheduling
policy (``serve/policy.py``, armed through ``ServeConfig.policy``)
against the reference package on the CPU:

- ``generate_trace``: the reference's trace, field for field, for each
  arrival process (poisson, bursty, ramp, step) and a tenant mix with
  deadlines;
- ``save_trace`` files of either package load in the other, unchanged;
- ``run_load`` over the port engine and over the reference engine with
  the same weights, without a policy and with priority / fair-share /
  deadline eviction / the prefill boost: every request's status, tokens
  and rejection reason, the ticks and the virtual seconds equal, and the
  policy changes the outcome;
- ``run_load(control=...)`` raises ``NotImplementedError``;
- ``SchedulingPolicy``'s three decisions equal the reference's on the
  same seeded inputs.
"""

import dataclasses
import math

import numpy as np
import pytest

from distributed_dot_product_tpu.serve import (
    KernelEngine as JaxEngine, LoadGenConfig as JaxLoadCfg,
    PolicyConfig as JaxPolicyCfg, SchedulingPolicy as JaxPolicy,
    ServeConfig as JaxServeCfg, TenantPolicy as JaxTenantPolicy,
    TenantSpec as JaxTenantSpec, generate_trace as jax_generate,
    load_trace as jax_load, run_load as jax_run_load,
    save_trace as jax_save,
)
from distributed_dot_product_tpu.utils.tracing import (
    MetricsRegistry as JaxRegistry,
)
from distributed_dot_product_tpu_torch.convert import engine_state_from_jax
from distributed_dot_product_tpu_torch.serve import (
    KernelEngine, LoadGenConfig, PolicyConfig, SchedulingPolicy, ServeConfig,
    TenantPolicy, TenantSpec, default_tenants, generate_trace, load_trace,
    run_load, save_trace,
)
from distributed_dot_product_tpu_torch.serve.admission import Request
from distributed_dot_product_tpu_torch.utils.tracing import MetricsRegistry

ARRIVALS = ('poisson', 'bursty', 'ramp', 'step')


def _tenants(spec_cls):
    """The stock two-tenant mix with a deadline on the batchy tenant."""
    return [spec_cls('t0', share=2.0, prompt_lo=2, prompt_hi=12, new_lo=4,
                     new_hi=12),
            spec_cls('t1', share=1.0, prompt_lo=4, prompt_hi=24, new_lo=8,
                     new_hi=24, deadline_s=0.05)]


def _fields(trace):
    return [(a.at, a.request_id, a.tenant, a.prompt.tolist(),
             a.max_new_tokens, a.deadline_s) for a in trace]


@pytest.mark.parametrize('arrival', ARRIVALS)
def test_generate_trace_equals_the_reference(arrival):
    kw = dict(seed=7, rate=300.0, requests=40, arrival=arrival, vocab=64)
    want = jax_generate(JaxLoadCfg(tenants=_tenants(JaxTenantSpec), **kw))
    got = generate_trace(LoadGenConfig(tenants=_tenants(TenantSpec), **kw))
    assert _fields(got) == _fields(want)
    assert all(a.prompt.dtype == np.int32 for a in got)


def test_traces_load_in_either_package(tmp_path):
    kw = dict(seed=3, rate=200.0, requests=12, arrival='bursty')
    trace = generate_trace(LoadGenConfig(tenants=_tenants(TenantSpec), **kw))
    save_trace(tmp_path / 'port.json', trace, note='port')
    assert _fields(jax_load(tmp_path / 'port.json')) == _fields(trace)
    jtrace = jax_generate(JaxLoadCfg(tenants=_tenants(JaxTenantSpec), **kw))
    jax_save(tmp_path / 'jax.json', jtrace)
    assert _fields(load_trace(tmp_path / 'jax.json')) == _fields(jtrace)
    assert (tmp_path / 'port.json').read_text().replace(
        ',"note":"port"', '') == (tmp_path / 'jax.json').read_text()


# -- run_load against the reference --------------------------------------

_WEIGHTS = ('_embed', '_wq', '_wk', '_wv', '_wo')
ENGINE = dict(slots=2, t_max=64, vocab=64, prefill_chunk=4, seed=0,
              cache_mode='paged', page_size=8)
LOAD = dict(seed=7, rate=600.0, requests=32, vocab=64)


def _policy(cls_cfg, cls_tenant):
    return cls_cfg(tenants={'t0': cls_tenant(priority=1),
                            't1': cls_tenant(weight=2.0)},
                   target_ttft=0.004, max_prefill_boost=3)


def _outcomes(res):
    return ({rid: (r.status, r.reason.value if r.reason else None,
                   list(r.tokens)) for rid, r in res.results.items()},
            {rid: r.value for rid, r in res.rejected_at_submit.items()},
            res.ticks, res.virtual_seconds, res.accounted)


def run_pair(policy, event_logs=(None, None)):
    """One seeded load through the reference scheduler over its engine
    and through the port's over the port engine with the same weights:
    ``(reference outcomes, port outcomes)``."""
    je = JaxEngine(decode_impl='xla', **ENGINE)
    te = KernelEngine(device='cpu', **ENGINE)
    te.load_weights(engine_state_from_jax(
        {n: np.asarray(getattr(je, n)) for n in _WEIGHTS}))
    serve = dict(queue_limit=4, max_new_tokens=24, watchdog=False)
    want = jax_run_load(
        JaxLoadCfg(tenants=_tenants(JaxTenantSpec), **LOAD), engine=je,
        serve_config=JaxServeCfg(**serve), registry=JaxRegistry(),
        event_log=event_logs[0],
        policy=_policy(JaxPolicyCfg, JaxTenantPolicy) if policy else None)
    got = run_load(
        LoadGenConfig(tenants=_tenants(TenantSpec), **LOAD), engine=te,
        serve_config=ServeConfig(**serve), registry=MetricsRegistry(),
        event_log=event_logs[1],
        policy=_policy(PolicyConfig, TenantPolicy) if policy else None)
    return _outcomes(want), _outcomes(got)


def test_run_load_matches_the_reference_with_and_without_a_policy():
    plain_want, plain_got = run_pair(False)
    assert plain_got == plain_want
    pol_want, pol_got = run_pair(True)
    assert pol_got == pol_want
    results, _, _, _, accounted = pol_got
    assert accounted and plain_got[-1]
    statuses = {s for s, _, _ in results.values()}
    assert {'completed', 'evicted'} <= statuses
    # The policy is at work: the same trace ends otherwise.
    assert pol_got[0] != plain_got[0]


def test_run_load_control_is_not_ported():
    with pytest.raises(NotImplementedError, match='item 4'):
        run_load(LoadGenConfig(requests=1), engine=None, control=object())


# -- the policy's decisions ----------------------------------------------

def _requests(rng, n, tenants, now):
    reqs = []
    for i in range(n):
        req = Request(id=f'r{i}', prompt=np.zeros(2, np.int32),
                      max_new_tokens=int(rng.integers(1, 30)),
                      tenant=str(rng.choice(tenants)),
                      deadline=(None if rng.random() < 0.3
                                else now + float(rng.random()) * 0.2))
        reqs.append(req)
    return reqs


@dataclasses.dataclass
class _Slot:
    index: int


def test_policy_decisions_equal_the_reference():
    rng = np.random.default_rng(12)
    tenants = ['t0', 't1', 't2']
    cfgs = [dict(tenants={'t0': dict(priority=1), 't1': dict(weight=3.0)}),
            dict(tenants={'t2': dict(weight=0.5)}, fair_share=False),
            dict(fair_share=False, deadline_eviction=False),
            dict(target_ttft=0.1, max_prefill_boost=5, gap_percentile=99)]
    for cfg in cfgs:
        def build(cls_cfg, cls_tenant):
            kw = dict(cfg)
            kw['tenants'] = {k: cls_tenant(**v)
                             for k, v in cfg.get('tenants', {}).items()}
            return cls_cfg(**kw)
        port = SchedulingPolicy(build(PolicyConfig, TenantPolicy))
        ref = JaxPolicy(build(JaxPolicyCfg, JaxTenantPolicy))
        for _ in range(40):
            now = float(rng.random())
            queued = _requests(rng, int(rng.integers(1, 8)), tenants, now)
            held = {t: int(rng.integers(0, 4)) for t in tenants}
            assert port.select(queued, held) == ref.select(queued, held)
            cands = [(_Slot(i), r, int(rng.integers(0, 20)))
                     for i, r in enumerate(queued)]
            gap = float(rng.choice([math.nan, rng.random() * 0.05]))
            assert port.eviction_victim(cands, now, gap) is \
                ref.eviction_victim(cands, now, gap)
            ttft = float(rng.choice([math.nan, rng.random() * 0.3]))
            assert port.prefill_chunks(ttft) == ref.prefill_chunks(ttft)
    with pytest.raises(ValueError, match='weight'):
        SchedulingPolicy(PolicyConfig(tenants={'a': TenantPolicy(weight=0)}))
    assert [t.name for t in default_tenants(3)] == ['t0', 't1', 't2']
