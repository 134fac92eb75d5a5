# -*- coding: utf-8 -*-
"""
Replica-scoped chaos on the port (``utils/faults.py`` ``ChaosPlan`` /
``ChaosInjector``, ``serve/loadgen.py`` ``ChaosSchedule``, the router's
two chaos seams) against the reference package, float32 on the CPU: twins
of the chaos tests of ``tests/test_replica_failure.py`` and
``tests/test_kv_integrity.py``.

Each scenario runs on the port's topology (every member loaded with the
reference engine's weights) and on the reference's ``build_serving`` with
the same plan on the same virtual-clock ticks. Host-side outputs are held
EQUAL, not close: results and token streams, the ``fault.inject`` /
``replica.lost`` / ``request.recovered`` / ``kv.corrupt`` sequences by
name, fields and tick, the recovered and healed request ids, the counters,
``chaos_plan_from_env``'s plans and errors, and the doctor's verdict on
the same bundles. The recovered streams also equal the port's own
crash-free run.

The reference's retrace sentinel is switched off for its runs
(``DDP_TPU_RETRACE_SENTINEL=0``): it polices the reference's jit caching,
which decides no value compared here.
"""

import numpy as np
import pytest
import torch

from torch_serving import (
    JAX, PORT, SIDES, arcs, both, counters, long_prompt, member, outcomes,
    prompts, serving, settle,
)
from torch_serving import cyclic_gc_paused  # noqa: E402,F401  autouse


@pytest.fixture(autouse=True)
def _no_retrace_sentinel(monkeypatch):
    monkeypatch.setenv('DDP_TPU_RETRACE_SENTINEL', '0')


def _chaos(side, **plan):
    return side.faults.ChaosInjector(side.faults.ChaosPlan(**plan))


# -- the plan and its env knobs -----------------------------------------

_ENVS = [
    {'DDP_TPU_FAULT_REPLICA_CRASH': 'r1:40',
     'DDP_TPU_FAULT_HANDOFF_CRASH': 'r0',
     'DDP_TPU_FAULT_PROBE_BLACKHOLE': 'r2'},
    {'DDP_TPU_FAULT_PAGE_CORRUPT': 'r0:2:8',
     'DDP_TPU_FAULT_PREFILL_CRASH': '10'},
    {'DDP_TPU_FAULT_REPLICA_CRASH': ' host:r1:7 '},
    {},
    {'DDP_TPU_FAULT_REPLICA_CRASH': '40'},
    {'DDP_TPU_FAULT_REPLICA_CRASH': 'r1:x'},
    {'DDP_TPU_FAULT_PAGE_CORRUPT': 'r0:2'},
    {'DDP_TPU_FAULT_PAGE_CORRUPT': 'r0:x:8'},
    {'DDP_TPU_FAULT_PAGE_CORRUPT': ':1:8'},
    {'DDP_TPU_FAULT_PREFILL_CRASH': 'soon'},
]


def _plan_or_error(side, env):
    try:
        plan = side.faults.chaos_plan_from_env(env)
    except ValueError as e:
        return ('error', type(e).__name__, str(e),
                isinstance(e, side.faults.ChaosSpecError))
    return ('plan', plan.replica_crash, plan.crash_in_handoff,
            plan.probe_blackhole, plan.page_corrupt, plan.prefill_crash,
            plan.fire_once, plan.any())


@pytest.mark.parametrize('env', _ENVS)
def test_chaos_plan_from_env_matches_the_reference(env):
    """Every knob, its grammar and its typed error: the reference's plan,
    or its ``ChaosSpecError`` text, for the same environment."""
    got = _plan_or_error(PORT, env)
    assert got == _plan_or_error(JAX, env)
    if got[0] == 'error':
        assert got[3] and 'expected <' in got[2]


def test_chaos_plan_from_env():
    """Twin of the reference's own: the three replica knobs, an empty
    plan, and the crash knob's grammar error naming the knob."""
    plan = PORT.faults.chaos_plan_from_env({
        'DDP_TPU_FAULT_REPLICA_CRASH': 'r1:40',
        'DDP_TPU_FAULT_HANDOFF_CRASH': 'r0',
        'DDP_TPU_FAULT_PROBE_BLACKHOLE': 'r2',
    })
    assert plan.replica_crash == ('r1', 40)
    assert plan.crash_in_handoff == 'r0'
    assert plan.probe_blackhole == 'r2'
    assert plan.any()
    assert not PORT.faults.chaos_plan_from_env({}).any()
    with pytest.raises(ValueError, match='REPLICA_CRASH'):
        PORT.faults.chaos_plan_from_env(
            {'DDP_TPU_FAULT_REPLICA_CRASH': '40'})


def test_chaos_plan_from_env_new_knobs():
    plan = PORT.faults.chaos_plan_from_env({
        'DDP_TPU_FAULT_PAGE_CORRUPT': 'r0:2:8',
        'DDP_TPU_FAULT_PREFILL_CRASH': '10',
    })
    assert plan.page_corrupt == ('r0', 2, 8)
    assert plan.prefill_crash == 10
    assert plan.any()
    for env, knob in [
        ({'DDP_TPU_FAULT_PAGE_CORRUPT': 'r0:2'}, 'PAGE_CORRUPT'),
        ({'DDP_TPU_FAULT_PAGE_CORRUPT': 'r0:x:8'}, 'PAGE_CORRUPT'),
        ({'DDP_TPU_FAULT_PREFILL_CRASH': 'soon'}, 'PREFILL_CRASH'),
    ]:
        with pytest.raises(PORT.faults.ChaosSpecError, match=knob):
            PORT.faults.chaos_plan_from_env(env)


def _hooks(side, tmp_path, fire_once):
    """Every hook of one injector over 12 ticks, with the events it
    narrates."""
    log = side.obs.EventLog(tmp_path / f'{side.name}-{fire_once}.jsonl')
    inj = _chaos(side, replica_crash=('r1', 3), crash_in_handoff='r0',
                 probe_blackhole='r1', page_corrupt=('r0', 2, 5),
                 prefill_crash=7, fire_once=fire_once)
    inj.event_log = log
    calls = []
    for tick in range(12):
        calls.append((tick, inj.crash_due(tick), inj.corrupt_due(tick),
                      inj.prefill_crash_due(tick),
                      inj.crash_on_handoff('r0' if tick % 2 else 'r1'),
                      inj.blackholed('r1'), inj.blackholed('r0')))
    log.close()
    events = [{k: v for k, v in r.items() if k not in ('ts',)}
              for r in side.read(log.path)]
    return calls, events


@pytest.mark.parametrize('fire_once', [True, False])
def test_injector_hooks_and_events_match_the_reference(tmp_path, fire_once):
    """Each hook's answer tick by tick, one-shot or repeating, and the
    ``fault.inject`` records it writes (kind, target, tick, page; the
    blackhole announced once)."""
    got = _hooks(PORT, tmp_path, fire_once)
    assert got == _hooks(JAX, tmp_path, fire_once)
    calls, events = got
    kinds = [e['kind'] for e in events]
    assert kinds.count('probe_blackhole') == 1
    assert all(e['event'] == 'fault.inject' for e in events)
    if fire_once:
        assert sorted(kinds) == sorted(['replica_crash', 'page_corrupt',
                                        'prefill_crash', 'handoff_crash',
                                        'probe_blackhole'])
    else:
        assert kinds.count('page_corrupt') == 7      # every tick from 5


# -- the router's two seams ---------------------------------------------

def _handoff_crash(side, tmp_path):
    chaos = _chaos(side, crash_in_handoff='r0')
    clock = side.serve.VirtualClock()
    router = serving(side, tmp_path, clock, chaos=chaos, threshold=4)
    prompt = list((np.arange(18) * 3 + 1) % 31 + 1)
    try:
        router.submit(prompt, request_id='h')
        results = outcomes(settle(router, clock))
    finally:
        router.close()
    return dict(results=results,
                replicas=[r.name for r in router.pool.replicas],
                lost=[r.name for r in router.pool.lost],
                arcs=arcs(side, router), counters=counters(router),
                complete=side.recon(router.pool.logs())['h'].complete)


def test_handoff_crash_falls_back_to_a_survivor(tmp_path):
    """A replica dying DURING the prefill->decode handoff (pages adopted,
    stream never admitted): the router declares the loss inline and
    re-places the request on a survivor in the same submit — the
    reference's events, counters and stream."""
    got = both(tmp_path, _handoff_crash)
    assert got['results']['h'][0] == 'completed'
    assert got['replicas'] == ['r1'] and got['lost'] == ['r0']
    lost = [a for a in got['arcs'] if a['event'] == 'replica.lost']
    assert len(lost) == 1 and lost[0]['target'] == 'r0'
    assert lost[0]['reason'] == 'handoff_crash'
    assert any(a['event'] == 'fault.inject' and a['kind'] == 'handoff_crash'
               for a in got['arcs'])
    assert got['complete']


def _blackhole(side, tmp_path):
    chaos = _chaos(side, probe_blackhole='r1')
    clock = side.serve.VirtualClock()
    router = serving(side, tmp_path, clock, chaos=chaos)
    try:
        for rid, p in prompts(4).items():
            router.submit(p, request_id=rid)
        results = outcomes(settle(router, clock))
    finally:
        router.close()
    return dict(results=results, arcs=arcs(side, router),
                counters=counters(router),
                alive={r.name: r.alive for r in router.pool.lost})


def test_probe_blackhole_declares_loss(tmp_path):
    """A replica that stops ANSWERING (process alive, network dead) is
    lost through the probe timeout, and recovery proceeds: the
    reference's misses, loss and recoveries, tick for tick."""
    got = both(tmp_path, _blackhole)
    assert all(st == 'completed' for st, _, _ in got['results'].values())
    lost = [a for a in got['arcs'] if a['event'] == 'replica.lost']
    assert len(lost) == 1 and lost[0]['target'] == 'r1'
    assert lost[0]['reason'] == 'probe_timeout'
    misses = [a['misses'] for a in got['arcs']
              if a['event'] == 'replica.probe' and a['target'] == 'r1']
    assert misses == [1, 2, 3]
    assert [a['kind'] for a in got['arcs']
            if a['event'] == 'fault.inject'] == ['probe_blackhole']


def _prefill_blackhole(side, tmp_path):
    chaos = _chaos(side, probe_blackhole='prefill')
    clock = side.serve.VirtualClock()
    router = serving(side, tmp_path, clock, chaos=chaos, threshold=4)
    try:
        router.submit(long_prompt(18, salt=1), request_id='before')
        ticks = 0
        while router.pool.prefill is not None:
            router.step()
            clock.advance(0.01)
            ticks += 1
            assert ticks < 100, 'the blackholed pool was never declared'
        router.submit(long_prompt(18, salt=2), request_id='after')
        results = outcomes(settle(router, clock))
    finally:
        router.close()
    return dict(results=results, arcs=arcs(side, router),
                counters=counters(router),
                prefill=router.pool.prefill is None)


def test_prefill_probe_blackhole_falls_back_to_flat_prefill(tmp_path):
    """The prefill pool's probe has the same seam: blackholed, it is lost
    by the probe timeout and later long prompts prefill flat."""
    got = both(tmp_path, _prefill_blackhole)
    assert got['prefill']
    assert {st for st, _, _ in got['results'].values()} == {'completed'}
    plost = [a for a in got['arcs'] if a['event'] == 'prefill.lost']
    assert len(plost) == 1 and plost[0]['reason'] == 'probe_timeout'
    assert got['counters']['router.handoffs'] == 1


# -- ChaosSchedule over a seeded trace ----------------------------------

def _trace(side, tmp_path):
    cfg = side.serve.LoadGenConfig(
        seed=7, rate=400.0, requests=12, vocab=32,
        tenants=side.serve.default_tenants(2), tick_seconds=0.01)
    path = tmp_path / f'{side.name}-trace.json'
    side.serve.save_trace(path, side.serve.generate_trace(cfg))
    return path, cfg.tick_seconds


def _schedule_run(side, tmp_path, tag, plan, **kw):
    path, tick = _trace(side, tmp_path)
    chaos = _chaos(side, **plan)
    clock = side.serve.VirtualClock()
    router = serving(side, tmp_path / tag, clock, chaos=chaos, max_new=24,
                     **kw)
    sched = side.serve.ChaosSchedule(chaos, router)
    try:
        res = side.serve.run_trace(router, side.serve.load_trace(path),
                                   clock, tick_seconds=tick, on_tick=sched)
    finally:
        router.close()
    revs = arcs(side, router)
    return dict(
        results=outcomes(res.results), ticks=res.ticks,
        accounted=res.accounted, killed=sched.killed,
        corrupted=sched.corrupted, arcs=revs, counters=counters(router),
        recovered=sorted(a['request_id'] for a in revs
                         if a['event'] == 'request.recovered'
                         and a['requeued']),
        rejected={rid: r.value for rid, r in res.rejected_at_submit.items()})


def test_chaos_schedule_replays_bit_identically(tmp_path):
    """The same seeded trace and plan replay the crash at the same
    virtual instant: two port runs and the reference's run give the same
    results, ticks, kills and recovery sets, and every recovered stream
    equals the port's own crash-free run of the trace."""
    plan = dict(replica_crash=('r1', 8))
    a = _schedule_run(PORT, tmp_path, 'a', plan)
    b = _schedule_run(PORT, tmp_path, 'b', plan)
    assert a == b
    assert a == _schedule_run(JAX, tmp_path, 'a', plan)
    assert a['killed'] == ['r1'] and a['accounted']
    assert a['recovered'], 'the crash missed the busy window'
    injected = [x for x in a['arcs'] if x['event'] == 'fault.inject']
    assert [(x['kind'], x['target'], x['tick']) for x in injected] == [
        ('replica_crash', 'r1', 8)]
    clean = _schedule_run(PORT, tmp_path, 'clean', {})
    assert clean['killed'] == [] and clean['recovered'] == []
    for rid in a['recovered']:
        assert a['results'][rid][0] == 'completed'
        assert a['results'][rid] == clean['results'][rid], rid


def test_chaos_schedule_corruption_and_prefill_crash(tmp_path):
    """The other tick-keyed faults through the schedule: the page flip
    waits for the victim's first tracked page, is caught by the scrub and
    healed, and the prefill pool killed mid-trace falls back to flat
    prefill — the reference's flips, verdicts and healed ids."""
    plan = dict(page_corrupt=('r0', 1, 2), prefill_crash=20)
    got = _schedule_run(PORT, tmp_path, 'c', plan, threshold=4,
                        integrity_interval=0.0)
    assert got == _schedule_run(JAX, tmp_path, 'c', plan, threshold=4,
                                integrity_interval=0.0)
    assert got['accounted'] and len(got['corrupted']) == 1
    name, page, tick = got['corrupted'][0]
    assert name == 'r0' and tick >= 2
    corrupt = [x for x in got['arcs'] if x['event'] == 'kv.corrupt']
    assert corrupt and corrupt[0]['target'] == 'r0'
    assert page in corrupt[0]['pages']
    assert [x for x in got['arcs'] if x['event'] == 'prefill.lost']
    healed = [x['request_id'] for x in got['arcs']
              if x['event'] == 'request.recovered'
              and x['reason'] == 'kv_corrupt']
    clean = _schedule_run(PORT, tmp_path, 'clean', {}, threshold=4,
                          integrity_interval=0.0)
    for rid, (status, _, tokens) in got['results'].items():
        n = min(len(tokens), len(clean['results'][rid][2]))
        assert tokens[:n] == clean['results'][rid][2][:n], rid
    for rid in healed:
        assert got['results'][rid] == clean['results'][rid]


# -- the doctor names the member ----------------------------------------

def _bundle(side, tmp_path, emits, trigger):
    with side.flight.recording(base_dir=tmp_path / side.name / 'flight',
                               registry=side.registry()) as rec:
        log = side.obs.EventLog(tmp_path / side.name / 'ev.jsonl')
        for event, fields in emits:
            log.emit(event, **fields)
        log.close()
        return rec.dump_bundle(trigger=trigger)


_LOSS = [
    ('fault.inject', dict(kind='replica_crash', target='r1', tick=40)),
    ('replica.probe', dict(target='r1', state='missed', misses=3)),
    ('replica.lost', dict(target='r1', reason='probe_timeout', in_flight=2)),
    ('request.recovered', dict(request_id='a', from_replica='r1',
                               requeued=True)),
    ('request.recovered', dict(request_id='b', from_replica='r1',
                               requeued=False)),
    ('serve.reject', dict(request_id='b', reason='replica_lost', tenant='t0',
                          queued=True)),
]
_CORRUPT = [
    ('fault.inject', dict(kind='page_corrupt', target='r0', page=3, tick=8)),
    ('kv.corrupt', dict(target='r0', pages=[3], site='scrub')),
    ('request.recovered', dict(request_id='a', from_replica='r0',
                               requeued=True, reason='kv_corrupt')),
    ('request.recovered', dict(request_id='b', from_replica='r0',
                               requeued=False, reason='kv_corrupt')),
    ('serve.reject', dict(request_id='b', reason='kv_corrupt', tenant='t0',
                          queued=True)),
]


def _diagnosis(emits, trigger, tmp_path):
    """The port's and the reference's doctor on the port's bundle and on
    the reference's bundle of the same events."""
    out = {}
    for maker in SIDES:
        path = _bundle(maker, tmp_path, emits, trigger)
        for reader in SIDES:
            inc = reader.doctor.diagnose(reader.flight.load_bundle(path))
            out[(maker.name, reader.name)] = (
                inc, reader.doctor.render_incident(inc))
    return out


@pytest.mark.parametrize('case', ['replica_loss', 'kv_corruption'])
def test_doctor_names_the_member_as_the_reference(tmp_path, case):
    """``replica_loss`` names the DEAD replica, ``kv_corruption`` the
    DIRTY one (over the replica_loss class its healing would vote for):
    the port's doctor gives the reference's incident, field for field,
    on either package's bundle."""
    emits, trigger, member_name = {
        'replica_loss': (_LOSS, 'replica_lost', 'r1'),
        'kv_corruption': (_CORRUPT, 'kv_corrupt', 'r0')}[case]
    out = _diagnosis(emits, trigger, tmp_path)
    for maker in ('port', 'jax'):
        port_inc, port_text = out[(maker, 'port')]
        jax_inc, jax_text = out[(maker, 'jax')]
        assert port_inc.to_dict() == jax_inc.to_dict()
        assert port_text == jax_text
        assert port_inc.primary == case and port_inc.replica == member_name
        assert case in port_text and member_name in port_text


def test_doctor_classifies_replica_loss_naming_the_dead(tmp_path):
    path = _bundle(PORT, tmp_path, _LOSS, 'replica_lost')
    incident = PORT.doctor.diagnose(PORT.flight.load_bundle(path))
    assert incident.primary == 'replica_loss'
    assert incident.replica == 'r1'
    out = PORT.doctor.render_incident(incident)
    assert 'replica_loss' in out and 'r1' in out


def test_doctor_classifies_kv_corruption_naming_the_dirty(tmp_path):
    path = _bundle(PORT, tmp_path, _CORRUPT, 'kv_corrupt')
    incident = PORT.doctor.diagnose(PORT.flight.load_bundle(path))
    assert incident.primary == 'kv_corruption'
    assert incident.replica == 'r0'
    out = PORT.doctor.render_incident(incident)
    assert 'kv_corruption' in out and 'r0' in out


def test_default_watches_include_kv_corrupt():
    """The stock catalog watches the router's corruption counter and
    chains a flight dump."""
    from distributed_dot_product_tpu_torch.obs import anomaly
    watches = {w.name: w for w in anomaly.default_watches()}
    w = watches['kv_corrupt']
    assert w.metric == 'router.kv_corrupt'
    assert w.signal == 'counter'
    assert 'dump' in w.actions


# -- the seeded fuzz sweeps: one bit, any page --------------------------

def _flip_bit(side, eng, page, rng):
    """Flip one seeded bit of ``page``'s K or V buffer: the same draw on
    both packages, in place on the port's pool, through a host copy on the
    reference's."""
    use_k = rng.rand() < 0.5
    if side is PORT:
        pool = eng.cache.k_pool if use_k else eng.cache.v_pool
        flat = pool[int(page)].reshape(-1).view(torch.uint8)
        byte = int(rng.randint(flat.numel()))
        flat[byte] ^= 1 << int(rng.randint(8))
        return
    import jax.numpy as jnp
    k_pool = np.array(eng.cache.k_pool)
    v_pool = np.array(eng.cache.v_pool)
    buf = k_pool if use_k else v_pool
    flat = buf[int(page)].reshape(-1).view(np.uint8)
    flat[int(rng.randint(len(flat)))] ^= np.uint8(1 << int(rng.randint(8)))
    eng.cache = eng.cache._replace(k_pool=jnp.array(k_pool),
                                   v_pool=jnp.array(v_pool))


def _paged_engine(side, pages=16, slots=2):
    kw = dict(slots=slots, t_max=64, vocab=32, seed=3, cache_mode='paged',
              page_size=16, pages=pages)
    if side is PORT:
        from torch_serving import state
        eng = side.serve.KernelEngine(device='cpu', **kw)
        eng.load_weights(state(3))
        return eng
    return side.serve.KernelEngine(decode_impl='xla', **kw)


def _boundaries(side, tmp_path):
    rng = np.random.RandomState(42)
    pool = side.serve.PrefillPool(
        t_max=64, page_size=16, vocab=32, seed=3,
        event_log=side.obs.EventLog(tmp_path / f'{side.name}-p.jsonl'),
        **({'device': 'cpu'} if side is PORT else {}))
    if side is PORT:
        from torch_serving import state
        pool.engine.load_weights(state(3))
    found = []
    for trial in range(4):              # slab-handoff boundary
        eng = _paged_engine(side)
        handle = pool.build(long_prompt(int(rng.randint(17, 40)),
                                        salt=trial))
        page = handle.pages[int(rng.randint(len(handle.pages)))]
        _flip_bit(side, pool.engine, page, rng)
        with pytest.raises(side.serve.PageCorruptionError) as exc:
            eng.adopt_prefix(pool.engine.cache, handle.pages, handle.length,
                             src_checksums=pool.engine.checksums)
        assert int(page) in exc.value.pages
        found.append((exc.value.site, list(exc.value.pages),
                      list(handle.pages)))
        pool.release(handle)
    for trial in range(4):              # attach + fork boundaries
        eng = _paged_engine(side, slots=3)
        plen = int(rng.randint(17, 40))
        pid = eng.register_prefix(long_prompt(plen, salt=10 + trial))
        pages, _ = eng._prefix_registry[pid]
        assert eng.start_with_prefix(0, pid)
        full = pages[:-1] if plen % 16 else pages
        page = full[int(rng.randint(len(full)))]
        _flip_bit(side, eng, page, rng)
        with pytest.raises(side.serve.PageCorruptionError) as attach:
            eng.start_with_prefix(1, pid)
        with pytest.raises(side.serve.PageCorruptionError) as fork:
            eng.fork_slot(0, 2)
        found.append((int(page), attach.value.site, list(attach.value.pages),
                      fork.value.site, list(fork.value.pages)))
    return found


def test_fuzz_any_flip_detected_at_every_boundary(tmp_path):
    """A seeded rng flips ONE random bit of a random live page at each
    transfer boundary in turn — slab handoff, prefix attach, CoW fork —
    and every flip is detected before any sequence reads the page: the
    reference's sites and pages, trial for trial."""
    got = _boundaries(PORT, tmp_path)
    assert got == _boundaries(JAX, tmp_path)
    assert {g[0] for g in got[:4]} == {'handoff_src'}


def _healed(side, tmp_path):
    prompt = long_prompt(18)
    clock_twin = side.serve.VirtualClock()
    twin = serving(side, tmp_path / 'twin', clock_twin, replicas=1,
                   threshold=4, max_new=8, integrity=True)
    try:
        twin.submit(prompt, request_id='v')
        base = outcomes(settle(twin, clock_twin))
    finally:
        twin.close()
    rng = np.random.RandomState(7)
    trials = []
    for trial in range(3):
        clock = side.serve.VirtualClock()
        router = serving(side, tmp_path / f't{trial}', clock, threshold=4,
                         max_new=8, integrity=True)
        try:
            router.submit(prompt, request_id='v')
            router.step()
            clock.advance(0.01)
            target = router._ledger['v']['replica']
            eng = member(router, target).engine
            tracked = eng.checksums.pages()
            page = tracked[int(rng.randint(len(tracked)))]
            _flip_bit(side, eng, page, rng)
            results = outcomes(settle(router, clock))
        finally:
            router.close()
        trials.append(dict(results=results, target=target, page=int(page),
                           arcs=arcs(side, router)))
    return base, trials


def test_fuzz_healed_streams_bit_identical_to_twin(tmp_path):
    """A random bit of a random live tracked page flipped mid-decode: no
    silent wrong token — every stream equals the corruption-free twin's —
    and the verdict names the page; the reference's arcs, trial for
    trial."""
    got = both(tmp_path, _healed)
    base, trials = got
    for t in trials:
        assert t['results']['v'] == base['v']
        assert t['results']['v'][0] == 'completed'
        corrupt = [a for a in t['arcs'] if a['event'] == 'kv.corrupt']
        assert corrupt and corrupt[0]['target'] == t['target']
        assert t['page'] in corrupt[0]['pages']
