# -*- coding: utf-8 -*-
"""
Disaggregated serving on the port (``serve/replica.py``,
``serve/router.py``) against the reference package, float32 on the CPU:
twins of ``tests/test_serve_router.py``. Each scenario runs on the port's
topology (every member loaded with the reference engine's weights) and,
where it routes, on the reference's ``build_serving`` with the same
settings: routed targets, policies, statuses, token streams and the
router's counters must be equal.

- topology plumbing: ``parse_topology``, ``maybe_init_distributed`` (a
  no-op unconfigured; a one-rank gloo group when configured), the chaos
  refusal, the one-rank prefill pool;
- the prefill pool's pages bit for bit the engine's own prefill, and
  streams on adopted prefixes equal to the reference's;
- placement: least-loaded spreading, session affinity, the typed
  ``NO_REPLICA`` shed in the router's log only, prefix affinity to the
  page holder, the LRU entry cap, the page-pin budget, a too-long prompt
  as the typed ``PROMPT_TOO_LONG`` reject;
- the seeded trace (``LoadGenConfig(seed=7, rate=1200, requests=48)``)
  through a 1 x 2 topology: every request reconstructed exactly once over
  the merged logs, the reference topology's outcomes, routes and counters,
  goodput at least the port's single-scheduler twin's.

The reference's retrace sentinel is switched off for its runs
(``DDP_TPU_RETRACE_SENTINEL=0``): it polices the reference's jit caching,
which decides no value compared here, and it is what made the reference's
own topology acceptance test flip between runs (ROADMAP §3).
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from distributed_dot_product_tpu import serve as jserve
from distributed_dot_product_tpu.obs import slo as jslo
from distributed_dot_product_tpu.obs.events import read_events as jread
from distributed_dot_product_tpu.obs.timeline import reconstruct as jrecon
from distributed_dot_product_tpu.utils.tracing import (
    MetricsRegistry as JRegistry,
)
from distributed_dot_product_tpu_torch import serve as tserve
from distributed_dot_product_tpu_torch.convert import engine_state_from_jax
from distributed_dot_product_tpu_torch.obs import slo as tslo
from distributed_dot_product_tpu_torch.obs.events import EventLog, read_events
from distributed_dot_product_tpu_torch.obs.timeline import reconstruct
from distributed_dot_product_tpu_torch.parallel.mesh import Mesh
from distributed_dot_product_tpu_torch.serve import (
    KernelEngine, PrefillPool, RejectReason, Scheduler, ServeConfig,
    TopologyConfig, VirtualClock, build_serving, maybe_init_distributed,
    parse_topology,
)
from distributed_dot_product_tpu_torch.utils.tracing import MetricsRegistry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX = types.SimpleNamespace(serve=jserve, read=jread, recon=jrecon,
                            slo=jslo, registry=JRegistry)
PORT = types.SimpleNamespace(serve=tserve, read=read_events,
                             recon=reconstruct, slo=tslo,
                             registry=MetricsRegistry)


@pytest.fixture(autouse=True)
def _no_retrace_sentinel(monkeypatch):
    monkeypatch.setenv('DDP_TPU_RETRACE_SENTINEL', '0')


_STATES = {}


def _state(seed, vocab):
    """The reference engine's seeded weights (every member's)."""
    key = (seed, vocab)
    if key not in _STATES:
        je = jserve.KernelEngine(slots=1, t_max=16, vocab=vocab, seed=seed,
                                 decode_impl='xla')
        _STATES[key] = engine_state_from_jax(
            {n: np.asarray(getattr(je, n))
             for n in ('_embed', '_wq', '_wk', '_wv', '_wo')})
    return _STATES[key]


def _load(router, state):
    """The reference's weights into every member of a port topology."""
    members = [r.engine for r in router.pool.replicas]
    if router.pool.prefill is not None:
        members.append(router.pool.prefill.engine)
    for eng in members:
        eng.load_weights(state)


def _topo(side, replicas=2, slots=2, t_max=64, page_size=16, vocab=32,
          seed=3, **kw):
    if side is PORT:
        kw['device'] = 'cpu'
    else:
        kw['decode_impl'] = 'xla'
    return side.serve.TopologyConfig(
        decode_replicas=replicas, slots=slots, t_max=t_max,
        page_size=page_size, vocab=vocab, seed=seed, **kw)


def _serving(side, tmp_path, clock, *, replicas=2, threshold=4,
             queue_limit=4, max_new=8, cap=32, **topo_kw):
    router = side.serve.build_serving(
        _topo(side, replicas=replicas, **topo_kw),
        serve_config=side.serve.ServeConfig(watchdog=False,
                                            queue_limit=queue_limit,
                                            max_new_tokens=max_new),
        router_config=side.serve.RouterConfig(prefill_threshold=threshold,
                                              prefix_cache_cap=cap),
        clock=clock, log_dir=tmp_path / ('port' if side is PORT else 'jax')
        / 'logs')
    if side is PORT:
        _load(router, _state(3, topo_kw.get('vocab', 32)))
    return router


def _routes(side, router):
    """``[(request_id, target, policy)]`` from the router's log."""
    path = dict(router.pool.logs())['router']
    return [(r['request_id'], r['target'], r['policy'])
            for r in side.read(path) if r['event'] == 'router.route']


def _outcomes(results):
    return {rid: (r.status, r.reason.value if r.reason else None,
                  list(r.tokens)) for rid, r in results.items()}


def _counters(router):
    return dict(router.registry.snapshot()['counters'])


# -- topology plumbing --------------------------------------------------

def test_parse_topology():
    for text in ('1x2', '0x1', ' 1x3 '):
        assert parse_topology(text) == jserve.parse_topology(text)
    for text, match in (('2-3', 'look like'), ('2x2', 'prefill pools'),
                        ('1x0', 'decode replica')):
        with pytest.raises(ValueError, match=match):
            parse_topology(text)
        with pytest.raises(ValueError, match=match):
            jserve.parse_topology(text)
    with pytest.raises(ValueError, match='prefill_pools'):
        TopologyConfig(prefill_pools=2).validate()
    with pytest.raises(ValueError, match='divide'):
        TopologyConfig(t_max=100, page_size=16).validate()


def test_maybe_init_distributed_is_a_noop_unconfigured(tmp_path):
    """Without a coordinator the single-process multi-replica mode needs
    no process group; with one it joins ``torch.distributed`` with the
    backend asked for (a one-rank gloo group in a subprocess here)."""
    assert maybe_init_distributed(environ={}) is False
    assert jserve.maybe_init_distributed(environ={}) is False
    code = (
        'import torch.distributed as dist\n'
        'from distributed_dot_product_tpu_torch.serve import '
        'maybe_init_distributed\n'
        f'env = {{"DDP_TPU_COORDINATOR": "file://{tmp_path}/store",\n'
        '       "DDP_TPU_NUM_PROCESSES": "1", "DDP_TPU_PROCESS_ID": "0"}\n'
        'assert maybe_init_distributed(environ=env, backend="gloo")\n'
        'assert dist.get_world_size() == 1 and dist.get_rank() == 0\n'
        'assert dist.get_backend() == "gloo"\n'
        'dist.destroy_process_group()\n'
        'print("joined")\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and 'joined' in out.stdout, out.stderr


def test_chaos_and_multi_rank_pools_are_refused(tmp_path):
    """The chaos injector and the multi-rank prefill split are not ported:
    typed refusals naming the ROADMAP items, never a silent partial run."""
    with pytest.raises(NotImplementedError, match='item 4b'):
        build_serving(_topo(PORT), chaos=object(),
                      log_dir=tmp_path / 'logs')
    with pytest.raises(NotImplementedError, match='item 4c'):
        PrefillPool(t_max=64, page_size=16, device='cpu',
                    mesh=Mesh(None, 0, 2))
    pool = PrefillPool(t_max=64, page_size=16, device='cpu')
    assert pool.n_shards == 1 and pool.engine.slots == 1
    assert pool.engine.pool.pages == 8


# -- prefill pool: KV bit-identical to local ----------------------------

def test_prefill_pool_kv_bitwise_matches_local_prefill():
    """The pool's pages are BITWISE the engine's own chunked
    ``register_prefix`` of the same tokens; release returns every page
    and a second build reuses the pool."""
    tokens = (np.arange(1, 25, dtype=np.int32) * 5) % 32
    pf = PrefillPool(t_max=64, page_size=16, vocab=32, seed=3, device='cpu')
    handle = pf.build(tokens)
    ref = KernelEngine(slots=2, t_max=64, vocab=32, seed=3,
                       cache_mode='paged', page_size=16, device='cpu')
    ref_pages, ref_n = ref._prefix_registry[ref.register_prefix(tokens)]
    assert handle.length == ref_n == len(tokens)
    assert len(handle.pages) == len(ref_pages) == 2
    for sp, rp in zip(handle.pages, ref_pages):
        for name in ('k_pool', 'v_pool'):
            assert torch.equal(getattr(pf.engine.cache, name)[sp],
                               getattr(ref.cache, name)[rp]), name
    pf.release(handle)
    assert pf.engine.pool.free_pages == pf.engine.pool.pages
    pf.build(tokens)
    pf.kill()
    with pytest.raises(RuntimeError, match='dead'):
        pf.build(tokens)


@pytest.mark.parametrize('length', [16, 19, 40])
def test_adopt_prefix_stream_identity_and_validation(length):
    """A stream started on a handed-off prefix is token for token the
    reference's handed-off stream and the port's flat-prompt stream (a
    prefix on a page boundary, a tail page, three pages); a short prompt
    is refused typed."""
    state = _state(3, 32)
    tokens = (np.arange(length) * 7 + 1) % 32
    prompt = list(tokens) + [5]
    streams = []
    for side in (PORT, JAX):
        pkw = dict(t_max=64, page_size=16, vocab=32, seed=3)
        ekw = dict(slots=2, cache_mode='paged', **pkw)
        if side is PORT:
            pf = PrefillPool(device='cpu', **pkw)
            pf.engine.load_weights(state)
            dec = KernelEngine(device='cpu', **ekw)
            dec.load_weights(state)
        else:
            pf = jserve.PrefillPool(**pkw)
            dec = jserve.KernelEngine(decode_impl='xla', **ekw)
        handle = pf.build(tokens)
        pid = dec.adopt_prefix(pf.engine.cache, handle.pages, handle.length,
                               src_checksums=pf.engine.checksums)
        pf.release(handle)
        sched = side.serve.Scheduler(
            dec, side.serve.ServeConfig(watchdog=False, max_new_tokens=8),
            registry=side.registry(), fault_injector=False)
        r = sched.submit([prompt[-1]], prefix_id=pid, max_new_tokens=8)
        streams.append(sched.run_until_idle()[r.id].tokens)
        sched.close()
    flat = KernelEngine(device='cpu', slots=2, cache_mode='paged',
                        t_max=64, page_size=16, vocab=32, seed=3)
    flat.load_weights(state)
    with Scheduler(flat, ServeConfig(watchdog=False, max_new_tokens=8),
                   registry=MetricsRegistry(), fault_injector=False) as s:
        r = s.submit(prompt, max_new_tokens=8)
        streams.append(s.run_until_idle()[r.id].tokens)
    assert streams[0] == streams[1] == streams[2]
    with pytest.raises(ValueError, match='empty prefix'):
        PrefillPool(t_max=64, page_size=16, device='cpu').build([])


# -- router placement ---------------------------------------------------

def _spread(side, tmp_path):
    clock = side.serve.VirtualClock()
    router = _serving(side, tmp_path, clock, threshold=100, queue_limit=8,
                      slots=1)
    try:
        for i in range(4):
            router.submit([1 + i, 2, 3], request_id=f'a{i}')
        loads = router.loads()
        router.run_until_idle()
        for i in range(3):
            router.submit([7, 8, 9 + i], request_id=f's{i}',
                          session='sess-1')
            router.run_until_idle()
        tls = side.recon(router.pool.logs())
        homes = [tls[f's{i}'].replicas[-1] for i in range(3)]
        return (loads, homes, _routes(side, router),
                _outcomes(router.results), _counters(router))
    finally:
        router.close()


def test_router_spreads_load_and_sticks_sessions(tmp_path, devices):
    """Least-loaded placement alternates over the two replicas, and a
    session sticks to its replica even when the other is emptier — the
    reference's placements, loads and streams."""
    port, ref = _spread(PORT, tmp_path), _spread(JAX, tmp_path)
    loads, homes = port[0], port[1]
    assert all(lo['queued'] + lo['busy'] == 2 for lo in loads.values())
    assert len(set(homes)) == 1
    assert port == ref


def _no_replica(side, tmp_path):
    clock = side.serve.VirtualClock()
    router = _serving(side, tmp_path, clock, queue_limit=1, slots=1,
                      threshold=100)
    try:
        for i in range(2):
            router.submit([1, 2], request_id=f'f{i}', max_new_tokens=4)
        with pytest.raises(side.serve.RejectedError) as exc:
            router.submit([1, 2], request_id='shed', max_new_tokens=4)
        router.run_until_idle()
    finally:
        router.close()
    tl = side.recon(router.pool.logs())['shed']
    leaked = [name for name, path in router.pool.logs()
              if name not in ('router', 'prefill')
              and any(r.get('request_id') == 'shed'
                      for r in side.read(path))]
    return (exc.value.reason.value, _counters(router), tl.status, tl.reason,
            tl.complete, tl.replicas, leaked, _outcomes(router.results))


def test_router_no_replica_typed_reject(tmp_path, devices):
    """Every replica queue at its bound: the router sheds with the typed
    NO_REPLICA reason BEFORE any replica's ladder runs — only the router's
    log carries the request — as the reference does."""
    port = _no_replica(PORT, tmp_path)
    assert port[0] == RejectReason.NO_REPLICA.value
    assert port[1]['router.rejected.no_replica{tenant=default}'] == 1
    assert port[2:6] == ('rejected', 'no_replica', True, ['router'])
    assert port[6] == []
    assert port == _no_replica(JAX, tmp_path)


def _affinity(side, tmp_path):
    clock = side.serve.VirtualClock()
    router = _serving(side, tmp_path, clock, threshold=4, max_new=6)
    prompt = list((np.arange(18) * 3 + 1) % 32) + [9]
    try:
        router.submit(prompt, request_id='first')
        router.run_until_idle()
        home = side.recon(router.pool.logs())['first'].replicas[-1]
        router.submit(prompt, request_id='again')
        router.step()          # admission attaches the shared prefix
        stats = {r.name: r.engine.cache_stats()['shared_pages']
                 for r in router.pool.replicas}
        router.run_until_idle()
        tls = side.recon(router.pool.logs())
        return (home, stats, tls['first'].handoffs, tls['again'].handoffs,
                tls['again'].replicas[-1], _routes(side, router),
                _outcomes(router.results), _counters(router))
    finally:
        router.close()


def test_prefix_affinity_routes_to_the_page_holder(tmp_path, devices):
    """A re-submitted registered prefix lands on the replica already
    holding its pages — shared pages there, none elsewhere — with no
    second transfer and the first run's stream, as in the reference."""
    port = _affinity(PORT, tmp_path)
    home, stats = port[0], port[1]
    assert stats[home] > 0 and all(v == 0 for n, v in stats.items()
                                   if n != home)
    assert port[2:5] == (1, 0, home)
    results, counters = port[6], port[7]
    assert results['again'][2] == results['first'][2]
    assert counters['router.prefix_hits'] == 1
    assert counters['router.handoffs'] == 1
    assert port == _affinity(JAX, tmp_path)


def _lru(side, tmp_path):
    clock = side.serve.VirtualClock()
    router = _serving(side, tmp_path, clock, replicas=1, threshold=4,
                      cap=2, max_new=4, t_max=96, slots=2)
    try:
        prompts = [list((np.arange(8) + 7 * j) % 32) + [j + 1]
                   for j in range(3)]
        seen = []
        for j, p in enumerate(prompts):
            router.submit(p, request_id=f'p{j}')
            router.run_until_idle()
        seen.append((_counters(router), len(router._prefix_map)))
        for rid, p in (('again0', prompts[0]), ('again2', prompts[2])):
            router.submit(p, request_id=rid)
            router.run_until_idle()
            seen.append(_counters(router))
        return seen, _routes(side, router), _outcomes(router.results)
    finally:
        router.close()


def test_prefix_cache_lru_cap_unregisters(tmp_path, devices):
    """Past ``prefix_cache_cap`` the least-recently-hit prefix is
    unregistered: a later identical prompt misses (a fourth handoff) while
    a cached one hits — the reference's counters and routes."""
    port = _lru(PORT, tmp_path)
    (after3, entries), after0, after2 = port[0]
    assert after3['router.handoffs'] == 3
    assert after3['router.prefix_unregistered'] == 1 and entries == 2
    assert after0['router.handoffs'] == 4
    assert after2['router.prefix_hits'] == 1
    assert after2['router.handoffs'] == 4
    assert port == _lru(JAX, tmp_path)


def _too_long(side, tmp_path):
    clock = side.serve.VirtualClock()
    router = _serving(side, tmp_path, clock, threshold=4)
    prompt = [(i % 31) + 1 for i in range(70)]     # 70 > t_max=64
    try:
        with pytest.raises(side.serve.RejectedError) as exc:
            router.submit(prompt, request_id='long')
        router.run_until_idle()
    finally:
        router.close()
    tl = side.recon(router.pool.logs())['long']
    return exc.value.reason.value, tl.complete, tl.status, tl.reason


def test_router_too_long_prompt_sheds_typed_not_crash(tmp_path, devices):
    """A prompt past t_max that crosses the prefill threshold comes out
    as the replica's typed PROMPT_TOO_LONG reject (the pool's ValueError
    falls through to the flat submit), as in the reference."""
    port = _too_long(PORT, tmp_path)
    assert port == ('prompt_too_long', True, 'rejected', 'prompt_too_long')
    assert port == _too_long(JAX, tmp_path)


def _pins(side, tmp_path):
    clock = side.serve.VirtualClock()
    router = _serving(side, tmp_path, clock, replicas=1, threshold=4,
                      cap=100, max_new=4, slots=2)
    try:
        for j in range(4):      # 2 pinned pages per distinct prefix
            p = [int(t) for t in (np.arange(18) + 11 * j) % 32] + [j + 1]
            router.submit(p, request_id=f'p{j}')
            router.run_until_idle()
        eng = router.pool.replicas[0].engine
        return (eng.pinned_pages, eng.pool.pages, eng.free_pages,
                _counters(router), _outcomes(router.results))
    finally:
        router.close()


def test_prefix_pin_budget_bounds_the_registry(tmp_path, devices):
    """Distinct long prompts never pin a replica's whole pool: past
    ``prefix_pin_fraction`` of the pages the LRU prefixes unregister even
    under the entry cap, leaving decode headroom."""
    port = _pins(PORT, tmp_path)
    pinned, pages, free, counters, _ = port
    assert pinned <= pages // 2
    assert counters['router.prefix_unregistered'] >= 1
    assert free >= pages - pages // 2
    assert port == _pins(JAX, tmp_path)


# -- acceptance: a seeded trace through the topology vs the twin --------

def _trace_run(side, tmp_path, trace_path, serve_cfg_kw):
    clock = side.serve.VirtualClock()
    router = side.serve.build_serving(
        _topo(side, replicas=2, slots=4, t_max=96, vocab=64, seed=0),
        serve_config=side.serve.ServeConfig(**serve_cfg_kw),
        router_config=side.serve.RouterConfig(prefill_threshold=8),
        clock=clock, log_dir=tmp_path / ('port' if side is PORT else 'jax')
        / 'topo')
    if side is PORT:
        _load(router, _state(0, 64))
    try:
        res = side.serve.run_trace(router, side.serve.load_trace(trace_path),
                                   clock, tick_seconds=0.002)
    finally:
        router.close()
    return router, res


def test_trace_topology_acceptance(tmp_path, devices):
    """The seeded serve-load trace at 2x the CI offered rate through a
    1-router / 2-decode-pool topology: every submitted request
    reconstructs EXACTLY ONCE over the merged logs; outcomes, routes,
    ticks and counters equal the reference topology's on the same saved
    trace; offloaded requests span the router, prefill and replica logs;
    goodput at least the port's single-scheduler twin's."""
    cfg = tserve.LoadGenConfig(seed=7, rate=1200.0, requests=48,
                               tenants=tserve.default_tenants(2), vocab=64,
                               tick_seconds=0.002)
    trace_path = tmp_path / 'trace.json'
    tserve.save_trace(trace_path, tserve.generate_trace(cfg))
    serve_kw = dict(watchdog=False, queue_limit=12, max_new_tokens=24)
    router, res = _trace_run(PORT, tmp_path, trace_path, serve_kw)
    jrouter, jres = _trace_run(JAX, tmp_path, trace_path, serve_kw)
    assert res.accounted and jres.accounted
    sources = router.pool.logs()
    assert [n for n, _ in sources][:2] == ['router', 'prefill']
    tls = reconstruct(sources)
    assert len(tls) == len(res.submitted) == 48
    for rid, tl in tls.items():
        assert tl.complete, (rid, tl.errors)
        assert tl.routes <= 1
    offloaded = [tl for tl in tls.values() if tl.handoffs]
    assert offloaded, 'no prompt crossed the prefill threshold'
    for tl in offloaded:
        assert 'prefill' in tl.replicas and 'router' in tl.replicas
        assert any(r.startswith('r') and r != 'router'
                   for r in tl.replicas), tl.replicas

    assert _outcomes(res.results) == _outcomes(jres.results)
    assert _routes(PORT, router) == _routes(JAX, jrouter)
    assert _counters(router) == _counters(jrouter)
    assert res.ticks == jres.ticks
    assert {rid: tl.replicas for rid, tl in tls.items()} == {
        rid: tl.replicas for rid, tl in jrecon(jrouter.pool.logs()).items()}

    spec = tslo.SloSpec(ttft=0.25, per_token=0.05)
    report = tslo.goodput(sources, spec)
    assert report.requests == 48 and sum(report.counts.values()) == 48
    jreport = jslo.goodput(jrouter.pool.logs(),
                           jslo.SloSpec(ttft=0.25, per_token=0.05))
    assert report.goodput_pct == jreport.goodput_pct

    clock = VirtualClock()
    twin_log = EventLog(tmp_path / 'twin.jsonl', clock=clock)
    eng = KernelEngine(slots=4, t_max=96, vocab=64, seed=0,
                       cache_mode='paged', page_size=16, device='cpu')
    eng.load_weights(_state(0, 64))
    twin = Scheduler(eng, ServeConfig(**serve_kw), clock=clock,
                     event_log=twin_log, registry=MetricsRegistry(),
                     fault_injector=False)
    try:
        res_twin = tserve.run_trace(twin, tserve.load_trace(trace_path),
                                    clock, tick_seconds=cfg.tick_seconds)
    finally:
        twin.close()
        twin_log.close()
    assert res_twin.accounted
    twin_report = tslo.goodput(twin_log.path, spec)
    assert report.goodput_pct >= twin_report.goodput_pct, (
        report.goodput_pct, twin_report.goodput_pct)
    assert report.counts['met'] > twin_report.counts['met']
    # Streams depend on prompt and seed only: every request both completed
    # carries the same tokens on the topology and the twin, up to the
    # shorter budget (load degrades budgets differently on the two).
    for rid, r in res.results.items():
        t = res_twin.results.get(rid)
        if r.status == t.status == 'completed':
            n = min(len(r.tokens), len(t.tokens))
            assert n and r.tokens[:n] == t.tokens[:n], rid
