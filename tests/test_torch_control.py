# -*- coding: utf-8 -*-
"""
The port's closed-loop control plane (``serve/control.py``, the
scheduler's actuators ``set_watermark`` / ``set_queue_limit``, the
watchdog the controller builds, ``run_load(control=...)``) against the
reference package, float32 on the CPU: twins of
``tests/test_serve_control.py`` (its three drain tests are twinned in
``tests/test_torch_replica_failure.py``).

Each scenario runs on the port (engines loaded with the reference
engine's weights, replicas the controller adds included) and on the
reference with the same settings on the same virtual clock. Host-side
outputs are held EQUAL: every action the controller returns, the
``control.adjust`` / ``control.scale`` / ``control.drain`` and
``anomaly.detected`` sequences by name, fields and time, outcomes and
token streams, and goodput.

The reference's retrace sentinel is switched off for its runs
(``DDP_TPU_RETRACE_SENTINEL=0``): it polices the reference's jit caching,
which decides no value compared here.
"""

import collections
import json

import pytest

from torch_serving import JAX, PORT, both, load, outcomes, state
from torch_serving import cyclic_gc_paused  # noqa: E402,F401  autouse

SPEC = dict(ttft=0.25, per_token=0.05)
CONTROL_EVENTS = ('control.adjust', 'control.scale', 'control.drain',
                  'anomaly.detected')


@pytest.fixture(autouse=True)
def _no_retrace_sentinel(monkeypatch):
    monkeypatch.setenv('DDP_TPU_RETRACE_SENTINEL', '0')


def _control_records(side, path):
    """The log's control and anomaly records, every field but the
    envelope's sequence number."""
    return [{k: v for k, v in r.items() if k not in ('seq', 'schema')}
            for r in side.read(path) if r['event'] in CONTROL_EVENTS]


# -- watermark actuation (single scheduler) -----------------------------

def _tighten_relax(side, tmp_path):
    clock = side.serve.VirtualClock()
    log = side.obs.EventLog(tmp_path / f'{side.name}-ctl.jsonl', clock=clock)
    kw = dict(slots=2, t_max=64, vocab=32, heads=2, head_dim=4,
              prefill_chunk=4, seed=5)
    if side is PORT:
        eng = side.serve.KernelEngine(device='cpu', **kw)
        eng.load_weights(state(5, heads=2, head_dim=4))
    else:
        eng = side.serve.KernelEngine(decode_impl='xla', **kw)
    sched = side.serve.Scheduler(
        eng, side.serve.ServeConfig(queue_limit=4, max_new_tokens=8,
                                    degrade_watermark=0.75, watchdog=False),
        clock=clock, registry=side.registry(), event_log=log,
        fault_injector=False)
    ctrl = side.serve.Controller(
        scheduler=sched,
        config=side.serve.ControlConfig(interval=0.01, tighten_step=0.2,
                                        relax_step=0.2, relax_after=2,
                                        min_watermark=0.3),
        clock=clock, event_log=log)
    for i in range(4):
        sched.submit([1, 2], request_id=f'p{i}')
    acted = ctrl.tick()
    tightened = (sched.cfg.degrade_watermark,
                 sched.admission.degrade_watermark,
                 sched.admission.queue_limit, sched.cfg.queue_limit,
                 ctrl.registry.gauge('control.watermark').value)
    while sched.step():
        clock.advance(0.01)
    relaxes = []
    for _ in range(6):
        clock.advance(0.01)
        relaxes += ctrl.tick()
    relaxed = (sched.cfg.degrade_watermark, sched.admission.queue_limit)
    results = outcomes(sched.results)
    sched.close()
    log.close()
    records, errors = side.obs.validate_file(log.path)
    kinds = collections.Counter(r['event'] for r in records
                                if r['event'].startswith('control.'))
    return dict(acted=acted, tightened=tightened, relaxes=relaxes,
                relaxed=relaxed, actions=ctrl.actions, results=results,
                errors=errors, kinds=dict(kinds),
                records=_control_records(side, log.path))


def test_controller_tightens_on_pressure_and_relaxes_on_headroom(tmp_path):
    """A full queue tightens the watermark and the queue bound in one
    evaluation; sustained headroom relaxes both back stepwise — the
    reference's actions, knob values, events and streams."""
    got = both(tmp_path, _tighten_relax)
    assert any(a['action'] == 'adjust' and a['knob'] == 'degrade_watermark'
               and a['value'] == pytest.approx(0.55) for a in got['acted'])
    assert any(a['knob'] == 'queue_limit' and a['value'] == 2
               for a in got['acted'])
    wm, adm_wm, qlim, cfg_qlim, gauge = got['tightened']
    assert wm == adm_wm == pytest.approx(0.55) and gauge == pytest.approx(0.55)
    assert qlim == cfg_qlim == 2
    assert any(a['knob'] == 'degrade_watermark'
               and a['reason'] == 'sustained_headroom'
               for a in got['relaxes'])
    assert got['relaxed'][0] == pytest.approx(0.75)
    assert got['relaxed'][1] == 4
    assert got['errors'] == []
    assert got['kinds']['control.adjust'] == len(got['actions'])


def _refusals(side):
    out = []
    for make in (lambda: side.serve.Controller(
                     config=side.serve.ControlConfig()),
                 lambda: side.serve.ControlConfig(interval=0.0).validate(),
                 lambda: side.serve.ControlConfig(
                     min_replicas=2, max_replicas=1).validate(),
                 lambda: side.serve.ControlConfig(
                     min_watermark=1.5).validate(),
                 lambda: side.serve.ControlConfig(
                     queue_scale_step=1.0).validate()):
        with pytest.raises(ValueError) as exc:
            make()
        out.append(str(exc.value))
    return out


def test_controller_needs_exactly_one_target():
    """The refusals and their texts are the reference's."""
    got = _refusals(PORT)
    assert got == _refusals(JAX)
    assert 'exactly one' in got[0] and 'interval' in got[1]
    assert 'replicas' in got[2]


def test_actuators_clamp_as_the_reference():
    """``set_watermark`` clamps to [0.05, 1] and mirrors into the config
    and the admission controller; ``set_queue_limit`` to at least 1."""
    got = []
    for side in (PORT, JAX):
        kw = dict(slots=2, t_max=16, vocab=32)
        eng = (side.serve.KernelEngine(device='cpu', **kw) if side is PORT
               else side.serve.KernelEngine(decode_impl='xla', **kw))
        sched = side.serve.Scheduler(
            eng, side.serve.ServeConfig(watchdog=False),
            registry=side.registry(), fault_injector=False)
        row = []
        for wm, ql in ((0.5, 3), (-1, 0), (7.0, 2.7), (0.051, 100)):
            row.append((sched.set_watermark(wm), sched.cfg.degrade_watermark,
                        sched.admission.degrade_watermark,
                        sched.set_queue_limit(ql), sched.cfg.queue_limit,
                        sched.admission.queue_limit))
        sched.close()
        got.append(row)
    assert got[0] == got[1]
    assert got[0][1][0] == 0.05 and got[0][1][3] == 1


# -- elastic autoscaling ------------------------------------------------

def _topology(side, clock, log_dir, replicas=1, queue_limit=12,
              max_new_tokens=24, **topo_kw):
    kw = dict(prefill_pools=0, decode_replicas=replicas, slots=2, t_max=64,
              page_size=16, vocab=32, heads=2, head_dim=4, seed=0)
    kw.update(topo_kw)
    if side is PORT:
        kw['device'] = 'cpu'
    else:
        kw['decode_impl'] = 'xla'
    router = side.serve.build_serving(
        side.serve.TopologyConfig(**kw),
        serve_config=side.serve.ServeConfig(queue_limit=queue_limit,
                                            max_new_tokens=max_new_tokens,
                                            watchdog=False),
        clock=clock, log_dir=str(log_dir))
    if side is PORT:
        weights = state(kw['seed'], vocab=kw['vocab'], heads=kw['heads'],
                        head_dim=kw['head_dim'])
        load(router, weights=weights)
        add = router.add_replica

        def add_loaded():
            # A replica the controller adds carries the same weights.
            replica = add()
            replica.engine.load_weights(weights)
            return replica
        router.add_replica = add_loaded
    return router


def _autoscale(side, tmp_path):
    clock = side.serve.VirtualClock()
    router = _topology(side, clock, tmp_path / side.name)
    ctrl = side.serve.Controller(
        router=router,
        config=side.serve.ControlConfig(interval=0.01, scale_up_after=1,
                                        scale_down_after=3, max_replicas=3),
        clock=clock, event_log=router.event_log)
    cfg = side.serve.LoadGenConfig(
        seed=7, rate=250.0, requests=48, arrival='ramp', ramp_factor=8.0,
        tenants=side.serve.default_tenants(2), vocab=32)
    res = side.serve.run_trace(router, side.serve.generate_trace(cfg), clock,
                               tick_seconds=cfg.tick_seconds,
                               on_tick=ctrl.tick)
    peak = len(router.pool.replicas)
    for _ in range(40):
        router.step()
        ctrl.tick()
        clock.advance(0.002)
    router.close()
    sources = router.pool.logs()
    errors = [e for _, path in sources
              for e in side.obs.validate_file(path)[1]]
    records = side.obs.merge_events(sources)
    retires = collections.Counter(r['request_id'] for r in records
                                  if r['event'] == 'serve.retire')
    tls = side.recon(sources)
    return dict(
        accounted=res.accounted, ticks=res.ticks, peak=peak,
        actions=ctrl.actions, results=outcomes(res.results),
        replicas=[r.name for r in router.pool.replicas],
        retired=[r.name for r in router.pool.retired], errors=errors,
        control=_control_records(side, dict(sources)['router']),
        retires=dict(retires),
        submitted=sorted(rid for rid, _ in res.submitted),
        complete=all(tl.complete for tl in tls.values()))


def test_autoscale_up_then_down_with_drain(tmp_path):
    """A ramp trace scales the pool up; the idle tail scales it back down
    through drains — the reference's control history event for event,
    every lifecycle exactly once."""
    got = both(tmp_path, _autoscale)
    assert got['accounted'] and got['errors'] == [] and got['complete']
    ups = [a for a in got['actions']
           if a['action'] == 'scale' and a['direction'] == 'up']
    downs = [a for a in got['actions']
             if a['action'] == 'scale' and a['direction'] == 'down']
    assert ups and downs and got['peak'] > 1 and len(got['replicas']) == 1
    scale = [r for r in got['control'] if r['event'] == 'control.scale']
    assert [e['direction'] for e in scale] == (['up'] * len(ups)
                                               + ['down'] * len(downs))
    assert [e['replicas'] for e in scale[:len(ups)]] == list(
        range(2, 2 + len(ups)))
    assert len([r for r in got['control']
                if r['event'] == 'control.drain']) == len(downs)
    assert set(got['retires']) == set(got['submitted'])
    assert all(n == 1 for n in got['retires'].values())


def _seeded(side, tmp_path, tag):
    clock = side.serve.VirtualClock()
    router = _topology(side, clock, tmp_path / side.name / tag)
    ctrl = side.serve.Controller(
        router=router,
        config=side.serve.ControlConfig(interval=0.01, scale_up_after=1,
                                        scale_down_after=20, max_replicas=3),
        clock=clock, event_log=router.event_log)
    cfg = side.serve.LoadGenConfig(
        seed=11, rate=250.0, requests=40, arrival='ramp', ramp_factor=8.0,
        tenants=side.serve.default_tenants(2), vocab=32)
    side.serve.run_trace(router, side.serve.generate_trace(cfg), clock,
                         tick_seconds=cfg.tick_seconds, on_tick=ctrl.tick)
    router.close()
    slo = (PORT.obs if side is PORT else JAX.obs).slo
    report = slo.goodput(router.pool.logs(), slo.SloSpec(**SPEC))
    return (ctrl.actions, json.dumps(report.to_dict(), sort_keys=True),
            _control_records(side, dict(router.pool.logs())['router']))


def test_controlled_run_is_seeded_deterministic(tmp_path):
    """Same seed, same trace: the same control history and goodput report
    on two port runs, and the reference's."""
    a = _seeded(PORT, tmp_path, 'a')
    assert a == _seeded(PORT, tmp_path, 'b')
    assert a == _seeded(JAX, tmp_path, 'a')
    assert a[0], 'the run never exercised the controller'


def _acceptance(side, tmp_path):
    cfg = side.serve.LoadGenConfig(
        seed=7, rate=300.0, requests=64, arrival='ramp', ramp_factor=10.0,
        tenants=side.serve.default_tenants(2), vocab=32)
    slo = (PORT.obs if side is PORT else JAX.obs).slo
    out = {}
    for tag, control in (('static', False), ('ctl', True)):
        clock = side.serve.VirtualClock()
        router = _topology(side, clock, tmp_path / side.name / tag,
                           slots=4, t_max=96, vocab=64, head_dim=8)
        ctrl = side.serve.Controller(
            router=router,
            config=side.serve.ControlConfig(
                interval=0.01, scale_up_after=1, scale_down_after=20,
                max_replicas=3),
            clock=clock, event_log=router.event_log) if control else None
        res = side.serve.run_trace(router, side.serve.generate_trace(cfg),
                                   clock, tick_seconds=cfg.tick_seconds,
                                   on_tick=ctrl.tick if ctrl else None)
        router.close()
        report = slo.goodput(router.pool.logs(), slo.SloSpec(**SPEC))
        router_log = dict(router.pool.logs())['router']
        out[tag] = dict(
            accounted=res.accounted,
            per_tenant={t: v['goodput_pct']
                        for t, v in report.per_tenant.items()},
            errors=side.obs.validate_file(router_log)[1],
            control=_control_records(side, router_log),
            results=outcomes(res.results))
    return out


def test_controlled_topology_holds_slo_where_static_breaks(tmp_path):
    """A seeded ramp trace that breaks the static config's per-tenant SLO
    is held within the committed ``SLO_BASELINE.json`` tolerance by the
    controlled topology — per-tenant goodput, control history and streams
    equal to the reference's."""
    got = both(tmp_path, _acceptance)
    with open('SLO_BASELINE.json', encoding='utf-8') as f:
        base = json.load(f)
    tol = base['tolerances']['tenant_goodput_abs']
    floors = {t: gp - tol for t, gp in base['per_tenant'].items()}
    assert got['static']['accounted'] and got['ctl']['accounted']
    assert [t for t in floors
            if got['static']['per_tenant'][t] < floors[t]]
    for t, floor in floors.items():
        assert got['ctl']['per_tenant'][t] >= floor, t
    assert got['ctl']['errors'] == []
    assert any(r['event'] == 'control.scale' and r['direction'] == 'up'
               for r in got['ctl']['control'])
    assert any(r['event'] == 'control.adjust' for r in got['ctl']['control'])
    assert got['static']['control'] == []


def _run_load(side, tmp_path):
    kw = dict(slots=2, t_max=64, vocab=32, heads=2, head_dim=4, seed=1,
              prefill_chunk=8, cache_mode='paged', page_size=16)
    if side is PORT:
        eng = side.serve.KernelEngine(device='cpu', **kw)
        eng.load_weights(state(1, heads=2, head_dim=4))
    else:
        eng = side.serve.KernelEngine(decode_impl='xla', **kw)
    log = side.obs.EventLog(tmp_path / f'{side.name}-load.jsonl')
    res = side.serve.run_load(
        side.serve.LoadGenConfig(seed=7, rate=600.0, requests=32, vocab=32,
                                 tenants=side.serve.default_tenants(2)),
        engine=eng, registry=side.registry(), event_log=log,
        serve_config=side.serve.ServeConfig(queue_limit=4, max_new_tokens=24,
                                            watchdog=False),
        control=side.serve.ControlConfig(interval=0.004))
    log.close()
    return (outcomes(res.results), res.ticks, res.accounted,
            _control_records(side, log.path))


def test_run_load_control_matches_the_reference(tmp_path):
    """``run_load(control=...)``: the controller and its stock anomaly
    watchdog on the run's virtual clock — the reference's adjustments and
    breaches, event for event, and its outcomes."""
    results, ticks, accounted, records = both(tmp_path, _run_load)
    assert accounted
    assert any(r['event'] == 'control.adjust' for r in records)
    assert any(r['event'] == 'anomaly.detected' for r in records)


# -- obs doctor learns the control arcs ---------------------------------

def _control_incident(side):
    events = [
        {'schema': 2, 'seq': i, 'ts': float(i), **e}
        for i, e in enumerate([
            {'event': 'serve.reject', 'request_id': 'x',
             'reason': 'queue_full', 'tenant': 't0'},
            {'event': 'serve.preempt', 'request_id': 'x', 'slot': 0,
             'requeued': True, 'drain': True},
            {'event': 'control.adjust', 'knob': 'degrade_watermark',
             'value': 0.6, 'reason': 'breach:queue_depth',
             'previous': 0.75},
            {'event': 'control.scale', 'direction': 'up',
             'replicas': 2, 'reason': 'backlog:1.50'},
            {'event': 'control.drain', 'target': 'r1', 'requeued': 3},
            {'event': 'control.scale', 'direction': 'down',
             'replicas': 1, 'reason': 'sustained_idle'},
        ])]
    incident = side.doctor.diagnose(
        {'manifest': {'trigger': 'manual', 'reason': 'test'},
         'events': events})
    return incident.to_dict(), side.doctor.render_incident(incident)


def test_doctor_reports_control_arcs():
    """Drain preempts do not vote cache exhaustion, the control arcs are
    overload evidence and notes — the reference's incident and text."""
    got = _control_incident(PORT)
    assert got == _control_incident(JAX)
    incident, rendered = got
    assert incident['primary'] == 'overload'
    assert incident['classes']['cache_exhaustion']['score'] == 0
    evidence = ' | '.join(incident['classes']['overload']['evidence'])
    assert 'controller tightened admission' in evidence
    assert 'scaled decode replicas up' in evidence
    assert any('control plane acted' in n for n in incident['notes'])
    assert 'controller' in rendered
