# -*- coding: utf-8 -*-
"""
Failure domains of the port's disaggregated serving against the reference
package, float32 on the CPU: twins of the chaos-free tests of
``tests/test_replica_failure.py`` and ``tests/test_kv_integrity.py``, and
of the drain tests of ``tests/test_serve_control.py``.

Each scenario runs on the port's topology (every member loaded with the
reference engine's weights) and on the reference's ``build_serving`` with
the same settings and the same virtual-clock ticks (a tick bound, never a
real clock): results, token streams, the router's lifecycle events and
its counters must be equal.

- a replica killed mid-stream: probes declare the loss, the ledger
  re-places its streams on the survivor bit-identically to a crash-free
  run, TTFT anchored at the original submit, the torn log merged; the
  typed ``REPLICA_LOST`` terminal past the budget or with no survivor;
  a rejoin under a fresh name; the flight recorder's dump;
- KV page integrity: a flipped page of a live prefix caught by the scrub,
  quarantined, the prefix invalidated and its rider healed bit-identically
  on the clean replica, or the typed ``KV_CORRUPT`` terminal past the
  budget; the flight recorder's dump;
- the prefill pool as a failure domain: killed mid-run, declared lost,
  long prompts served flat; ``rebuild_pool`` restores the offload (held
  within the port: the reference's rebuild path trips its own retrace
  budget on this jax, ROADMAP §3);
- ``drain_replica``: every drained request requeued exactly once, a rider
  of a vanished prefix finalized typed, the refusals;
- the failure-domain event schemas and the timeline's recovery arcs.

The reference's retrace sentinel is switched off for its runs
(``DDP_TPU_RETRACE_SENTINEL=0``): it polices the reference's jit caching,
which decides no value compared here.
"""

import collections
import types

import numpy as np
import pytest

from distributed_dot_product_tpu import serve as jserve
from distributed_dot_product_tpu.obs.events import merge_events as jmerge
from distributed_dot_product_tpu.obs.events import read_events as jread
from distributed_dot_product_tpu.obs.timeline import reconstruct as jrecon
from distributed_dot_product_tpu_torch import serve as tserve
from distributed_dot_product_tpu_torch.convert import engine_state_from_jax
from distributed_dot_product_tpu_torch.obs import flight as obs_flight
from distributed_dot_product_tpu_torch.obs.events import (
    EventLog, merge_events, read_events,
)
from distributed_dot_product_tpu_torch.obs.timeline import reconstruct
from distributed_dot_product_tpu_torch.serve import (
    RejectReason, UnknownReplicaError,
)
from distributed_dot_product_tpu_torch.utils.tracing import MetricsRegistry
from torch_serving import cyclic_gc_paused  # noqa: E402,F401  autouse

JAX = types.SimpleNamespace(serve=jserve, read=jread, recon=jrecon,
                            merge=jmerge)
PORT = types.SimpleNamespace(serve=tserve, read=read_events,
                             recon=reconstruct, merge=merge_events)
TORN_TAIL = '{"schema":2,"seq":'


@pytest.fixture(autouse=True)
def _no_retrace_sentinel(monkeypatch):
    monkeypatch.setenv('DDP_TPU_RETRACE_SENTINEL', '0')


_STATES = {}


def _state(seed, vocab=32, **kw):
    key = (seed, vocab, tuple(sorted(kw.items())))
    if key not in _STATES:
        je = jserve.KernelEngine(slots=1, t_max=16, vocab=vocab, seed=seed,
                                 decode_impl='xla', **kw)
        _STATES[key] = engine_state_from_jax(
            {n: np.asarray(getattr(je, n))
             for n in ('_embed', '_wq', '_wk', '_wv', '_wo')})
    return _STATES[key]


def _load(router, state, members=None):
    """The reference's weights into every (or the named) port member."""
    engines = [r.engine for r in router.pool.replicas
               if members is None or r.name in members]
    if router.pool.prefill is not None and (
            members is None or router.pool.prefill.name in members):
        engines.append(router.pool.prefill.engine)
    for eng in engines:
        eng.load_weights(state)


def _serving(side, tmp_path, clock, *, replicas=2, threshold=100,
             queue_limit=8, max_new=6, slots=2, integrity=False,
             **router_kw):
    """A topology with FAST probes on the virtual clock (and an
    every-tick scrub when ``integrity``)."""
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
        serve_config=side.serve.ServeConfig(watchdog=False,
                                            queue_limit=queue_limit,
                                            max_new_tokens=max_new),
        router_config=side.serve.RouterConfig(prefill_threshold=threshold,
                                              **router_kw),
        clock=clock, log_dir=tmp_path / ('port' if side is PORT else 'jax')
        / 'logs')
    if side is PORT:
        _load(router, _state(3))
    return router


def _settle(router, clock, dt=0.01, max_ticks=5000):
    """run_until_idle with the clock ADVANCING: probe deadlines are
    virtual time, so a static clock would never detect a loss."""
    ticks = 0
    while router.step():
        clock.advance(dt)
        ticks += 1
        assert ticks < max_ticks, 'topology never settled'
    return router.results


def _prompts(n, length=6):
    return {f'p{i}': list(((np.arange(length) * 3 + i) % 32) + 1)
            for i in range(n)}


def _long_prompt(length=18, salt=0):
    return list(((np.arange(length) * 5 + salt) % 31) + 1)


def _member(router, name):
    return next(r for r in router.pool.replicas if r.name == name)


_ARC_FIELDS = ('event', 'request_id', 'target', 'reason', 'in_flight',
               'requeued', 'state', 'misses', 'from_replica', 'recoveries',
               'policy', 'pages', 'site', 'replicas')
_ARCS = ('replica.lost', 'replica.probe', 'request.recovered',
         'replica.rejoin', 'router.route', 'serve.reject', 'kv.corrupt',
         'prefill.lost')


def _arcs(side, router, name='router'):
    """The log's failure-domain and routing records, fields the two
    packages share (``ts`` included: both run the same virtual clock)."""
    path = dict(router.pool.logs())[name]
    return [{k: r.get(k) for k in _ARC_FIELDS + ('ts',)}
            for r in side.read(path) if r['event'] in _ARCS]


def _outcomes(results):
    return {rid: (r.status, r.reason.value if r.reason else None,
                  list(r.tokens)) for rid, r in results.items()}


def _counters(router):
    return dict(router.registry.snapshot()['counters'])


def _both(tmp_path, scenario):
    """``scenario(side, tmp_path)`` on the port, then on the reference;
    returns the port's result after asserting the two are equal."""
    port = scenario(PORT, tmp_path)
    assert port == scenario(JAX, tmp_path)
    return port


# -- replica loss, recovered bit-identically ---------------------------

def _crash(side, tmp_path):
    prompts = _prompts(4)
    twin_clock = side.serve.VirtualClock()
    twin = _serving(side, tmp_path / 'twin', twin_clock, replicas=1)
    try:
        for rid, p in prompts.items():
            twin.submit(p, request_id=rid)
        base = _outcomes(_settle(twin, twin_clock))
    finally:
        twin.close()
    clock = side.serve.VirtualClock()
    router = _serving(side, tmp_path, clock)
    try:
        for rid, p in prompts.items():
            router.submit(p, request_id=rid)
        for _ in range(2):          # streams decoding on BOTH members
            router.step()
            clock.advance(0.01)
        victims = sorted(rid for rid, e in router._ledger.items()
                         if e['replica'] == 'r1')
        _member(router, 'r1').kill()
        results = _outcomes(_settle(router, clock))
    finally:
        router.close()
    with open(dict(router.pool.logs())['r1'], encoding='utf-8') as fh:
        tail = fh.read().rsplit('\n', 1)[-1]
    tls = side.recon(router.pool.logs())
    return dict(base=base, victims=victims, results=results,
                replicas=[r.name for r in router.pool.replicas],
                lost=[r.name for r in router.pool.lost],
                counters=_counters(router), arcs=_arcs(side, router),
                tail=tail, read_victim=bool(list(side.read(
                    dict(router.pool.logs())['r1']))),
                timelines={rid: (tl.complete, tl.recoveries, tl.replicas)
                           for rid, tl in tls.items()})


def test_crash_recovery_bit_identical_and_torn_log_merges(tmp_path):
    """Kill one of two replicas with streams in flight: probes declare the
    loss, every in-flight stream is re-placed on the survivor and equals a
    crash-free single-replica run, and every request reconstructs exactly
    once over the merged logs, the victim's torn tail included — the
    reference's events, counters and streams."""
    got = _both(tmp_path, _crash)
    victims = got['victims']
    assert victims and got['replicas'] == ['r0'] and got['lost'] == ['r1']
    assert got['counters']['router.replicas_lost'] == 1
    assert got['counters']['router.recovered'] == len(victims)
    assert got['results'] == got['base']
    assert all(st == 'completed' for st, _, _ in got['results'].values())
    lost = [a for a in got['arcs'] if a['event'] == 'replica.lost']
    assert len(lost) == 1 and lost[0]['target'] == 'r1'
    assert lost[0]['reason'] == 'probe_timeout'
    assert lost[0]['in_flight'] == len(victims)
    recovered = sorted(a['request_id'] for a in got['arcs']
                       if a['event'] == 'request.recovered'
                       and a['requeued'])
    assert recovered == victims
    assert any(a['event'] == 'replica.probe' and a['state'] == 'missed'
               for a in got['arcs'])
    assert got['tail'] == TORN_TAIL and got['read_victim']
    assert set(got['timelines']) == set(_prompts(4))
    for rid, (complete, recoveries, _) in got['timelines'].items():
        assert complete and recoveries == (1 if rid in victims else 0)


def _ttft(side, tmp_path):
    clock = side.serve.VirtualClock()
    router = _serving(side, tmp_path, clock, max_new=8)
    try:
        router.submit(list(range(1, 7)), request_id='v')
        router.step()
        clock.advance(1.0)          # a full virtual second passes...
        _member(router, router._ledger['v']['replica']).kill()
        results = _outcomes(_settle(router, clock))
    finally:
        router.close()
    tl = side.recon(router.pool.logs())['v']
    return results, tl.complete, tl.recoveries, tl.ttft


def test_recovered_ttft_anchored_at_original_submit(tmp_path):
    """The ledger keeps ``submitted_at``: a recovered stream's TTFT runs
    from the ORIGINAL submit (>= the virtual second before the crash)."""
    results, complete, recoveries, ttft = _both(tmp_path, _ttft)
    assert results['v'][0] == 'completed'
    assert complete and recoveries == 1
    assert ttft is not None and ttft >= 1.0


def _budget(side, tmp_path):
    clock = side.serve.VirtualClock()
    router = _serving(side, tmp_path, clock, max_recoveries=0)
    try:
        for rid, p in _prompts(2).items():
            router.submit(p, request_id=rid)
        router.step()
        victims = sorted(rid for rid, e in router._ledger.items()
                         if e['replica'] == 'r1')
        _member(router, 'r1').kill()
        results = _outcomes(_settle(router, clock))
    finally:
        router.close()
    tls = side.recon(router.pool.logs())
    return (victims, results, _counters(router), _arcs(side, router),
            {rid: (tls[rid].complete, tls[rid].status, tls[rid].reason)
             for rid in victims})


def test_recovery_budget_spent_is_a_typed_terminal(tmp_path):
    """``max_recoveries=0``: the in-flight stream on the dead replica ends
    as the typed REPLICA_LOST reject — accounted, complete in its
    timeline, never dropped."""
    victims, results, counters, arcs, tls = _both(tmp_path, _budget)
    assert victims
    for rid in victims:
        assert results[rid][:2] == ('rejected', 'replica_lost')
        assert tls[rid] == (True, 'rejected', 'replica_lost')
    assert counters['router.rejected.replica_lost{tenant=default}'] == \
        len(victims)
    assert sorted(a['request_id'] for a in arcs
                  if a['event'] == 'request.recovered'
                  and not a['requeued']) == victims


def _no_survivor(side, tmp_path):
    clock = side.serve.VirtualClock()
    router = _serving(side, tmp_path, clock, replicas=1)
    try:
        router.submit(list(range(1, 7)), request_id='solo')
        router.step()
        _member(router, 'r0').kill()
        results = _outcomes(_settle(router, clock))
    finally:
        router.close()
    return results, [r.name for r in router.pool.replicas]


def test_no_survivor_is_a_typed_terminal(tmp_path):
    """The LAST replica dying has nowhere to recover to: the same typed
    terminal, whatever the budget."""
    results, replicas = _both(tmp_path, _no_survivor)
    assert results['solo'][:2] == ('rejected', 'replica_lost')
    assert replicas == []


def _rejoin(side, tmp_path):
    clock = side.serve.VirtualClock()
    router = _serving(side, tmp_path, clock)
    try:
        router.mark_lost('r1', reason='crash')
        fresh = router.rejoin_replica()
        if side is PORT:
            _load(router, _state(3), members=(fresh.name,))
        for rid, p in _prompts(4).items():
            router.submit(p, request_id=rid)
        results = _outcomes(_settle(router, clock))
    finally:
        router.close()
    return (fresh.name, [r.name for r in router.pool.replicas], results,
            [a for a in _arcs(side, router)
             if a['event'] == 'replica.rejoin'], _counters(router))


def test_rejoin_after_loss_restores_capacity(tmp_path):
    """``rejoin_replica`` after a loss: a FRESH member (never a reused
    name) joins, the rejoin is audited, and it serves; unknown names are
    the typed UnknownReplicaError (a KeyError)."""
    name, replicas, results, rejoins, counters = _both(tmp_path, _rejoin)
    assert name == 'r2' and replicas == ['r0', 'r2']
    assert all(st == 'completed' for st, _, _ in results.values())
    assert len(rejoins) == 1 and rejoins[0]['target'] == 'r2'
    assert rejoins[0]['replicas'] == 2
    assert any(k.startswith('router.routed{replica=r2') for k in counters)
    router = _serving(PORT, tmp_path / 'unknown', tserve.VirtualClock())
    try:
        with pytest.raises(UnknownReplicaError, match='r9') as exc:
            router.mark_lost('r9')
        assert isinstance(exc.value, KeyError) and str(exc.value) == \
            "no replica named 'r9'"
    finally:
        router.close()


def test_replica_loss_auto_dumps_flight_bundle(tmp_path):
    """A replica loss is a post-mortem moment: the ROUTER dumps the armed
    flight recorder with trigger ``replica_lost``, the loss in the
    bundle's events and the router's introspection in its sections."""
    with obs_flight.recording(base_dir=tmp_path / 'flight',
                              registry=MetricsRegistry()) as rec:
        clock = tserve.VirtualClock()
        router = _serving(PORT, tmp_path, clock)
        try:
            for rid, p in _prompts(2).items():
                router.submit(p, request_id=rid)
            router.step()
            _member(router, 'r1').kill()
            _settle(router, clock)
        finally:
            router.close()
        dumps = [d for d in rec.dumps if d['trigger'] == 'replica_lost']
    assert len(dumps) == 1
    bundle = obs_flight.load_bundle(dumps[0]['path'])
    assert any(r.get('event') == 'replica.lost'
               for r in bundle.get('events', []))


def test_new_event_schemas_are_enforced(tmp_path):
    """The failure-domain events validate like every schema-2 event: all
    required fields or an immediate raise."""
    log = EventLog(tmp_path / 'ev.jsonl')
    log.emit('replica.lost', target='r1', reason='crash', in_flight=0)
    log.emit('replica.probe', target='r1', state='missed', misses=1)
    log.emit('replica.rejoin', target='r2', replicas=2)
    log.emit('request.recovered', request_id='a', from_replica='r1',
             requeued=True)
    log.emit('kv.corrupt', target='r0', pages=[3], site='scrub')
    log.emit('prefill.lost', target='prefill', reason='probe_timeout')
    for ev, kw in [
        ('replica.lost', {'target': 'r1', 'reason': 'crash'}),
        ('replica.probe', {'target': 'r1'}),
        ('replica.rejoin', {}),
        ('request.recovered', {'request_id': 'a', 'requeued': True}),
        ('kv.corrupt', {'target': 'r0', 'pages': [3]}),
        ('prefill.lost', {'target': 'prefill'}),
    ]:
        with pytest.raises(ValueError):
            log.emit(ev, **kw)
    log.close()
    assert len(list(read_events(log.path))) == 6


def _records(recs):
    for i, r in enumerate(recs):
        r.setdefault('seq', i)
        r.setdefault('ts', float(i))
        r.setdefault('schema', 2)
    return recs


def test_timeline_recovery_arcs():
    """The lifecycle automaton's recovery arcs — recovered → re-admit →
    complete, and recovered → typed reject — close the arc, the delivered
    latency restarting, as the reference's automaton reads them."""
    arcs = [
        [{'event': 'serve.admit', 'request_id': 'a', 'slot': 0,
          'queue_wait': 0.1},
         {'event': 'serve.decode', 'request_id': 'a', 'slot': 0,
          'token_index': 0, 'ttft': 0.5},
         {'event': 'request.recovered', 'request_id': 'a',
          'from_replica': 'r1', 'requeued': True},
         {'event': 'serve.admit', 'request_id': 'a', 'slot': 1,
          'queue_wait': 0.2},
         {'event': 'serve.decode', 'request_id': 'a', 'slot': 1,
          'token_index': 0, 'ttft': 2.1},
         {'event': 'serve.retire', 'request_id': 'a',
          'status': 'completed', 'total_seconds': 2.5}],
        [{'event': 'serve.admit', 'request_id': 'b', 'slot': 0,
          'queue_wait': 0.0},
         {'event': 'request.recovered', 'request_id': 'b',
          'from_replica': 'r1', 'requeued': False},
         {'event': 'serve.reject', 'request_id': 'b',
          'reason': 'replica_lost', 'tenant': 't0', 'queued': True}]]
    for recs in arcs:
        tl, = reconstruct(_records([dict(r) for r in recs])).values()
        jtl, = jrecon(_records([dict(r) for r in recs])).values()
        fields = ('complete', 'recoveries', 'admits', 'ttft', 'status',
                  'reason')
        assert ({f: getattr(tl, f) for f in fields}
                == {f: getattr(jtl, f) for f in fields})
        assert tl.complete and tl.recoveries == 1
    tl = reconstruct(_records([dict(r) for r in arcs[0]]))['a']
    assert tl.admits == 2 and tl.ttft == 2.1
    tl = reconstruct(_records([dict(r) for r in arcs[1]]))['b']
    assert (tl.status, tl.reason) == ('rejected', 'replica_lost')


# -- KV page integrity: the scrub and the healing ledger ----------------

def _scrub(side, tmp_path, max_recoveries=1, flight=None):
    prompt = _long_prompt(18)
    twin_clock = side.serve.VirtualClock()
    twin = _serving(side, tmp_path / 'twin', twin_clock, replicas=1,
                    threshold=4, max_new=8, integrity=True)
    try:
        twin.submit(prompt, request_id='v')
        base = _outcomes(_settle(twin, twin_clock))
    finally:
        twin.close()
    clock = side.serve.VirtualClock()
    router = _serving(side, tmp_path, clock, threshold=4, max_new=8,
                      integrity=True, max_recoveries=max_recoveries)
    try:
        router.submit(prompt, request_id='v')
        router.step()                   # handoff lands, decode starts
        clock.advance(0.01)
        target = router._ledger['v']['replica']
        eng = _member(router, target).engine
        tracked = eng.checksums.pages()
        assert tracked == eng.tracked_pages() and tracked
        eng.flip_page_bit(tracked[0])
        results = _outcomes(_settle(router, clock))
    finally:
        router.close()
    tl = side.recon(router.pool.logs())['v']
    return dict(base=base, results=results, target=target,
                page=tracked[0], quarantined=sorted(eng.pool.quarantined),
                registry=dict(eng._prefix_registry),
                replicas=sorted(r.name for r in router.pool.replicas),
                counters=_counters(router), arcs=_arcs(side, router),
                timeline=(tl.complete, tl.corruptions, tl.recoveries,
                          tl.status, tl.reason))


def test_scrub_detects_quarantines_and_heals_bit_identical(tmp_path):
    """A bit flips in a live shared prefix page while its rider decodes:
    the every-tick scrub detects it, the page is quarantined, the prefix
    invalidated, the rider expelled and healed on the clean replica —
    equal to a corruption-free twin — and the dirty replica stays in the
    pool; the reference's events and counters."""
    got = _both(tmp_path, _scrub)
    assert got['results'] == got['base']
    assert got['results']['v'][0] == 'completed'
    assert got['replicas'] == ['r0', 'r1']
    assert got['page'] in got['quarantined'] and got['registry'] == {}
    assert got['counters']['router.kv_corrupt'] == 1
    corrupt = [a for a in got['arcs'] if a['event'] == 'kv.corrupt']
    assert len(corrupt) == 1 and corrupt[0]['target'] == got['target']
    assert corrupt[0]['site'] == 'scrub' and got['page'] in \
        corrupt[0]['pages']
    healed = [a for a in got['arcs'] if a['event'] == 'request.recovered']
    assert len(healed) == 1 and healed[0]['requeued']
    assert healed[0]['reason'] == 'kv_corrupt'
    assert not [a for a in got['arcs'] if a['event'] == 'replica.lost']
    assert got['timeline'] == (True, 1, 1, 'completed', None)


def test_corruption_past_budget_is_a_typed_terminal(tmp_path):
    """``max_recoveries=0``: the corruption victim ends as the typed
    KV_CORRUPT reject, accounted and complete in its timeline."""
    got = _both(tmp_path, lambda side, tmp: _scrub(side, tmp, 0))
    assert got['results']['v'][:2] == ('rejected', 'kv_corrupt')
    assert got['counters'][
        'router.rejected.kv_corrupt{tenant=default}'] == 1
    assert got['timeline'][0] and got['timeline'][3:] == (
        'rejected', 'kv_corrupt')


def test_corruption_auto_dumps_flight_bundle(tmp_path):
    """A corruption verdict dumps the armed flight recorder with trigger
    ``kv_corrupt``."""
    with obs_flight.recording(base_dir=tmp_path / 'flight',
                              registry=MetricsRegistry()) as rec:
        _scrub(PORT, tmp_path)
        dumps = [d for d in rec.dumps if d['trigger'] == 'kv_corrupt']
    assert len(dumps) == 1
    bundle = obs_flight.load_bundle(dumps[0]['path'])
    assert any(r.get('event') == 'kv.corrupt'
               for r in bundle.get('events', []))


# -- the prefill pool is a failure domain too ---------------------------

def _prefill_crash(side, tmp_path):
    clock = side.serve.VirtualClock()
    router = _serving(side, tmp_path, clock, threshold=4, max_new=6)
    try:
        router.submit(_long_prompt(18, salt=1), request_id='before')
        router.step()
        clock.advance(0.01)
        assert router.pool.prefill is not None and router.pool.prefill.alive
        router.pool.prefill.kill()      # the router is told nothing
        router.submit(_long_prompt(18, salt=2), request_id='after')
        results = _outcomes(_settle(router, clock))
    finally:
        router.close()
    tls = side.recon(router.pool.logs())
    return (results, router.pool.prefill,
            [p.name for p in router.pool.prefill_lost], _counters(router),
            _arcs(side, router),
            bool(list(side.read(dict(router.pool.logs())['prefill']))),
            (tls['before'].complete, tls['after'].complete))


def test_prefill_crash_falls_back_to_flat_prefill(tmp_path):
    """Kill the pool mid-run: probes declare ``prefill.lost``, the later
    long prompt is served by flat prefill — never blocked — and the torn
    pool log still reads; no decode replica died."""
    results, live, lost, counters, arcs, readable, complete = _both(
        tmp_path, _prefill_crash)
    assert results['before'][0] == results['after'][0] == 'completed'
    assert live is None and lost == ['prefill']
    assert counters['router.prefill_lost'] == 1
    plost = [a for a in arcs if a['event'] == 'prefill.lost']
    assert len(plost) == 1 and plost[0]['target'] == 'prefill'
    assert plost[0]['reason'] in ('crash', 'probe_timeout')
    assert readable and complete == (True, True)
    assert not [a for a in arcs if a['event'] == 'replica.lost']


def test_rebuild_pool_restores_offload(tmp_path):
    """``rebuild_pool`` after a loss: a FRESH pool under a never-reused
    name joins, the rejoin is audited, and handoffs resume through it
    (held within the port; see the module docstring)."""
    clock = tserve.VirtualClock()
    router = _serving(PORT, tmp_path, clock, threshold=4, max_new=6)
    try:
        router.pool.prefill.kill()
        router.submit(_long_prompt(18, salt=3), request_id='flat')
        _settle(router, clock)
        assert router.pool.prefill is None
        fresh = router.rebuild_pool()
        _load(router, _state(3), members=(fresh.name,))
        assert fresh.name == 'prefill1'
        assert router.pool.prefill is fresh and fresh.alive
        with pytest.raises(ValueError, match='alive'):
            router.pool.rebuild_prefill()
        router.submit(_long_prompt(18, salt=4), request_id='offload')
        results = _settle(router, clock)
    finally:
        router.close()
    assert results['offload'].status == 'completed'
    assert results['flat'].status == 'completed'
    arcs = _arcs(PORT, router)
    assert any(a['event'] == 'replica.rejoin' and a['target'] == 'prefill1'
               for a in arcs)
    handoffs = [r for r in read_events(dict(router.pool.logs())['prefill1'])
                if r['event'] == 'prefill.handoff']
    assert [r['request_id'] for r in handoffs] == ['offload']
    assert [n for n, _ in router.pool.logs()][:3] == ['router', 'prefill',
                                                      'prefill1']


# -- drain_replica ------------------------------------------------------

def _drain_topology(side, tmp_path, clock, replicas=2):
    topo = dict(prefill_pools=0, decode_replicas=replicas, slots=2,
                t_max=64, page_size=16, vocab=32, heads=2, head_dim=4, seed=0)
    topo.update(device='cpu') if side is PORT else topo.update(
        decode_impl='xla')
    router = side.serve.build_serving(
        side.serve.TopologyConfig(**topo),
        serve_config=side.serve.ServeConfig(queue_limit=8,
                                            max_new_tokens=12,
                                            watchdog=False),
        clock=clock, log_dir=tmp_path / ('port' if side is PORT else 'jax'))
    if side is PORT:
        _load(router, _state(0, head_dim=4))
    return router


def _drain(side, tmp_path):
    clock = side.serve.VirtualClock()
    router = _drain_topology(side, tmp_path, clock)
    rng = np.random.default_rng(3)
    for i in range(8):
        router.submit([int(x) for x in rng.integers(1, 32, size=5)],
                      request_id=f'q{i}', max_new_tokens=10)
    for _ in range(4):          # streams mid-flight on both replicas
        router.step()
        clock.advance(0.002)
    busy = all(ld['busy'] for ld in router.loads().values())
    requeued = router.drain_replica('r1')
    names = [r.name for r in router.pool.replicas]
    while router.step():
        clock.advance(0.002)
    router.close()
    sources = router.pool.logs()
    records = side.merge(sources)
    retires = collections.Counter(r['request_id'] for r in records
                                  if r['event'] == 'serve.retire')
    drains = sorted((r['request_id'], r['replica'], r['requeued'])
                    for r in records if r['event'] == 'serve.preempt'
                    and r.get('drain'))
    tls = side.recon(sources)
    return dict(busy=busy, requeued=requeued, names=names,
                results=_outcomes(router.results), retires=dict(retires),
                drains=drains, arcs=_arcs(side, router),
                timelines={rid: (tl.complete, tl.admits, tl.preempts,
                                 sorted(tl.replicas))
                           for rid, tl in tls.items()})


def test_drain_mid_stream_requeues_exactly_once(tmp_path):
    """A replica drained mid-stream: every in-flight request preempts with
    the typed drain arc and requeues EXACTLY once, none retires twice,
    every timeline reconstructs — the reference's streams and routes."""
    got = _both(tmp_path, _drain)
    assert got['busy'] and got['requeued'] == 4 and got['names'] == ['r0']
    assert len(got['results']) == 8
    assert all(st == 'completed' for st, _, _ in got['results'].values())
    assert got['retires'] == {f'q{i}': 1 for i in range(8)}
    assert len(got['drains']) == 2
    assert all(rep == 'r1' and req for _, rep, req in got['drains'])
    for rid, _, _ in got['drains']:
        assert got['timelines'][rid] == (True, 2, 1, ['r0', 'r1', 'router'])
    assert all(tl[0] for tl in got['timelines'].values())


def _vanished(side, tmp_path):
    clock = side.serve.VirtualClock()
    router = _drain_topology(side, tmp_path, clock)
    r1 = router._by_name['r1']
    pid = r1.engine.register_prefix([1, 2, 3, 4])
    r1.scheduler.submit([5], prefix_id=pid, request_id='rider',
                        max_new_tokens=4)
    requeued = router.drain_replica('r1')
    res = router.results['rider']
    router.close()
    tl = side.recon(router.pool.logs())['rider']
    return requeued, res.status, res.reason.value, tl.complete, tl.reason


def test_drain_finalizes_vanished_prefix_rider_typed(tmp_path):
    """A drained rider whose prefix the router no longer tracks finalizes
    with the typed PREFIX_UNREGISTERED reason on the draining member."""
    assert _both(tmp_path, _vanished) == (
        0, 'rejected', 'prefix_unregistered', True, 'prefix_unregistered')


def test_drain_refuses_unknown_and_last_replica(tmp_path):
    router = _drain_topology(PORT, tmp_path, tserve.VirtualClock(),
                             replicas=1)
    try:
        with pytest.raises(KeyError, match='r9'):
            router.drain_replica('r9')
        with pytest.raises(ValueError, match='last'):
            router.drain_replica('r0')
        with pytest.raises(ValueError, match='last'):
            router.pool.remove_replica('r0')
    finally:
        router.close()
    assert RejectReason.PREFIX_UNREGISTERED.value == 'prefix_unregistered'
