# -*- coding: utf-8 -*-
"""
The serving front end of the disaggregated topology — the port of
``distributed_dot_product_tpu/serve/router.py``: admission, replica
placement, prefill→decode KV handoff, session affinity and
prefix-cache-aware routing over a
:class:`~distributed_dot_product_tpu_torch.serve.replica.ReplicaPool`.

Placement ladder, per request (first hit wins):

1. **Prefix affinity** — the prompt continues a prefix some replica
   already holds registered pages for: route THERE and ride the pages
   (``submit(prefix_id=...)`` → refcounted sharing, ``shared_pages > 0``
   on exactly that replica). The router's prefix map is the cluster
   index, the replicas' registries the storage.
2. **Session affinity** — ``submit(session=...)`` sticks a session to
   the replica that served it last.
3. **Least loaded** — fewest in-flight requests (queued + busy slots)
   among replicas whose admission queue has room.

A fresh long prompt (``prefix rows >= prefill_threshold``) is built by
the prefill pool and handed to the chosen replica as whole pages
(``KernelEngine.adopt_prefix``), registered, and entered into the prefix
map — the NEXT identical prompt takes rung 1. Short prompts route
directly; the replica's own chunked prefill serves them.

Every routed request leaves exactly ONE lifecycle in exactly ONE
replica's event log plus a ``router.route`` record in the router's own
log (and a ``prefill.handoff`` in the prefill pool's when pages moved).
When NO replica can accept, the router sheds with the typed
``NO_REPLICA`` reason BEFORE any replica's ladder runs.

**Failure domains.** A decode replica that dies mid-stream
(:meth:`~distributed_dot_product_tpu_torch.serve.replica.DecodeReplica
.kill`) is detected by the router's per-tick liveness probes — timeout
with bounded exponential backoff before :meth:`Router.mark_lost`
declares it — and its in-flight streams are RECOVERED from the router's
per-request ledger: each re-dispatches to a survivor by replay-prefill
and, greedy decoding being a pure function of prompt + seed, continues
bit-identically, TTFT still anchored at the original submit. Recovery is
bounded (``max_recoveries``, then the typed ``REPLICA_LOST`` terminal).

**Data integrity.** Engines keep host-side per-page checksums (transfer
boundaries only), and the router verifies at every handoff and attach. A
mismatch emits ``kv.corrupt``, quarantines the dirty pages,
invalidates every registered prefix built on them cluster-wide, and heals
the victim streams through the SAME recovery ledger (typed ``KV_CORRUPT``
past budget). An optional scrub (``integrity_interval``) re-verifies
every tracked digest on the router clock. The prefill pool is probed
like a replica; its loss falls back to flat prefill.

**Chaos.** ``Router(chaos=...)`` / ``build_serving(chaos=...)`` take a
:class:`~distributed_dot_product_tpu_torch.utils.faults.ChaosInjector`;
the router asks it at its two seams: right after a KV handoff lands
(:meth:`Router._handoff` — a planned crash kills the replica there, pages
adopted, placement not yet recorded, and the request is re-placed on a
survivor) and before counting a probe answer (:meth:`Router._probe_ok` — a
blackholed member never answers, decode replica or prefill pool, so its
loss comes from the probe timeout). The tick-keyed faults (a replica or
the prefill pool killed, a page bit flipped) are fired by
:class:`~distributed_dot_product_tpu_torch.serve.loadgen.ChaosSchedule`
on the member itself; the router learns of them only through its own
probes and checksums.

No wall-clock read decides placement: the ``build_seconds`` /
``transfer_seconds`` fields of ``prefill.handoff`` are the only
``perf_counter`` reads, and they time the host's calls (the card may still
be copying when ``adopt_prefix`` returns).
"""

import collections
import dataclasses
import itertools
import time
from typing import Optional

import numpy as np

from distributed_dot_product_tpu_torch.obs import events as obs_events
from distributed_dot_product_tpu_torch.obs import flight as obs_flight
from distributed_dot_product_tpu_torch.serve.admission import (
    RejectedError, RejectReason, Request, RequestResult,
)
from distributed_dot_product_tpu_torch.serve.engine import (
    PageCorruptionError,
)
from distributed_dot_product_tpu_torch.serve.errors import (
    UnknownReplicaError,
)
from distributed_dot_product_tpu_torch.serve.replica import (
    ReplicaPool, TopologyConfig,
)
from distributed_dot_product_tpu_torch.utils import tracing

__all__ = ['RouterConfig', 'Router', 'build_serving']

# Placement and the topology tick are pure functions of the injected
# clock, the load snapshot and the request stream.
GRAPHLINT_TICK_ROOTS = ('Router.step', 'Router.submit')


@dataclasses.dataclass
class RouterConfig:
    """Routing policy knobs. ``prefill_threshold``: prefix rows
    (``len(prompt) - 1``) at or above which a fresh prompt offloads to
    the prefill pool. ``prefix_cache_cap``: registered prefixes kept per
    replica — past it the replica's least-recently-hit prefix is
    unregistered. ``prefix_pin_fraction``: most of a replica's pool its
    registered prefixes may pin. ``max_recoveries``: times one request
    may be re-placed after losing its replica (0 = no recovery).
    ``probe_interval`` / ``probe_misses`` / ``probe_backoff`` /
    ``probe_backoff_max``: liveness probing on the router clock — a miss
    re-probes after ``interval * backoff**misses`` (capped), and
    ``probe_misses`` consecutive misses declare the member lost.
    ``integrity_interval``: background scrub period (None = no scrub,
    0.0 = every tick)."""
    prefill_threshold: int = 8
    prefix_cache: bool = True
    prefix_cache_cap: int = 32
    prefix_pin_fraction: float = 0.5
    session_affinity: bool = True
    max_recoveries: int = 1
    probe_interval: float = 0.05
    probe_misses: int = 3
    probe_backoff: float = 2.0
    probe_backoff_max: float = 0.2
    integrity_interval: Optional[float] = None


def _least_loaded(replicas, loads):
    """The placement key of rung 3 (and of every re-placement)."""
    return min(replicas, key=lambda r: (loads[r.name]['queued']
                                        + loads[r.name]['busy'], r.name))


class Router:
    """Front-end router over ``pool`` (see the module docstring). Exposes
    the Scheduler's driving surface — ``submit`` / ``step`` / ``results``
    / ``run_until_idle`` — so the loadgen's ``run_trace`` drives a whole
    topology exactly as it drives one scheduler."""

    def __init__(self, pool: ReplicaPool,
                 config: Optional[RouterConfig] = None, *,
                 clock=time.monotonic, event_log=None, registry=None,
                 chaos=None):
        self.pool = pool
        self.cfg = config or RouterConfig()
        self.clock = clock
        self.event_log = event_log
        self.registry = registry or tracing.MetricsRegistry()
        self.chaos = chaos          # ChaosInjector (utils/faults.py)
        self._by_name = {r.name: r for r in pool.replicas}
        self._sessions = {}
        # The recovery ledger, keyed by request id: everything needed to
        # re-place a stream whose replica dies (the scheduler-side Request
        # dies WITH the replica) — the FULL original prompt, the resolved
        # token budget, tenant, the ABSOLUTE deadline and the original
        # submit instant.
        self._ledger = {}
        # Terminal results the ROUTER owns (REPLICA_LOST / KV_CORRUPT
        # rejects have no live scheduler to finalize on).
        self._lost_results = {}
        self._probe_state = {}      # name -> {'next': t, 'misses': n}
        # prefix key (tuple of prefix tokens) -> (replica, pid, rows),
        # ordered by last hit for the per-replica LRU cap; the reverse map
        # (replica, pid) -> key lets a drain re-expand a stripped prompt.
        self._prefix_map = collections.OrderedDict()
        self._pid_tokens = {}
        self._rids = itertools.count()
        reg = self.registry
        self._c_hits = reg.counter('router.prefix_hits')
        self._c_miss = reg.counter('router.prefix_misses')
        self._c_handoffs = reg.counter('router.handoffs')
        self._c_handoff_pages = reg.counter('router.handoff_pages')
        self._c_unregistered = reg.counter('router.prefix_unregistered')
        self._c_lost = reg.counter('router.replicas_lost')
        self._c_recovered = reg.counter('router.recovered')
        self._c_corrupt = reg.counter('router.kv_corrupt')
        self._c_prefill_lost = reg.counter('router.prefill_lost')
        reg.gauge('router.replicas').set(len(pool.replicas))
        self._routed_series = {}
        self._noreplica_series = {}
        self._reject_series = {}
        self._integrity_next = None

    # -- observability ---------------------------------------------------
    def _emit(self, event, _log=None, **fields):
        """Into ``_log`` when given (the prefill pool's), else the router's
        own, else the process-active one, else nowhere."""
        log = _log if _log is not None else (
            self.event_log if self.event_log is not None
            else obs_events.get_active())
        if log is not None:
            log.emit(event, **fields)

    def _counter(self, series, key, name, labels):
        c = series.get(key)
        if c is None:
            c = series[key] = self.registry.counter(name, labels=labels)
        return c

    def _count_routed(self, replica, tenant):
        self._counter(self._routed_series, (replica, tenant),
                      'router.routed',
                      {'replica': replica, 'tenant': tenant}).inc()

    def _set_replica_gauge(self):
        self.registry.gauge('router.replicas').set(len(self.pool.replicas))

    # -- the cluster prefix cache ---------------------------------------
    def _cache_prefix(self, key, replica, pid, rows):
        self._prefix_map[key] = (replica.name, pid, rows)
        self._pid_tokens[(replica.name, pid)] = key
        self._prefix_map.move_to_end(key)
        held = [k for k, (name, _, _) in self._prefix_map.items()
                if name == replica.name]
        # Evict the replica's least-recently-HIT prefixes past EITHER
        # bound: the entry cap, or the page-pin budget (registry
        # references never free while registered, so without it varied
        # long prompts would pin the whole pool and starve decode slots).
        # Unregistering drops only the registry's references: pages still
        # shared by live riders survive until those retire, and a request
        # queued against an evicted pid resolves as the typed
        # PREFIX_UNREGISTERED terminal. The just-added entry is never the
        # victim.
        pin_budget = max(1, int(replica.engine.pool.pages
                                * self.cfg.prefix_pin_fraction))
        while held[:-1] and (len(held) > self.cfg.prefix_cache_cap
                             or replica.engine.pinned_pages > pin_budget):
            victim = held.pop(0)
            _, old_pid, _ = self._prefix_map.pop(victim)
            self._pid_tokens.pop((replica.name, old_pid), None)
            replica.engine.unregister_prefix(old_pid)
            self._c_unregistered.inc()

    def _prefix_hit(self, key, loads):
        """The replica already holding ``key``'s pages, if it can accept
        — consumes a rung-1 placement."""
        if not self.cfg.prefix_cache or key is None:
            return None
        hit = self._prefix_map.get(key)
        if hit is None:
            return None
        name, pid, rows = hit
        if not loads[name]['accepting']:
            return None
        replica = self._by_name[name]
        bad = replica.engine.verify_prefix(pid)
        if bad:
            # The hit's pages fail their checksums: contain the corruption
            # and treat this placement as a MISS — the rider must never
            # attach poisoned pages.
            self._handle_corruption(replica, bad, 'attach')
            return None
        self._prefix_map.move_to_end(key)
        return replica, pid, rows

    def _handoff(self, rid, replica, key, tenant):
        """Build ``key``'s KV in the prefill pool and adopt its pages into
        ``replica``'s — returns the registered prefix id, or None when the
        handoff cannot happen (no headroom on either side, or a detected
        corruption: the prompt then serves the plain way)."""
        prefill = self.pool.prefill
        rows = len(key)
        needed = replica.engine.pool.pages_for_rows(rows)
        free = replica.engine.free_pages
        if free is not None and free < needed:
            return None
        try:
            # ValueError covers data-dependent impossibility (a prompt too
            # long for t_max): the FLAT prompt then reaches the replica,
            # whose admission records the typed PROMPT_TOO_LONG reject.
            t0 = time.perf_counter()
            handle = prefill.build(np.asarray(key, np.int64))
            build_s = time.perf_counter() - t0
        except (RuntimeError, ValueError):
            return None
        try:
            t0 = time.perf_counter()
            pid = replica.engine.adopt_prefix(
                prefill.engine.cache, handle.pages, handle.length,
                src_checksums=prefill.engine.checksums)
            transfer_s = time.perf_counter() - t0
        except PageCorruptionError as exc:
            if exc.site == 'handoff_src':
                # The flip is in the PREFILL pool's staging pages, caught
                # BEFORE the transfer: the replica is clean. Quarantine at
                # the source; the prompt serves the flat way.
                prefill.engine.quarantine_pages(exc.pages)
                self._c_corrupt.inc()
                self._emit('kv.corrupt', target=prefill.name,
                           pages=exc.pages, site=exc.site)
                self._flight_dump(
                    'kv_corrupt',
                    f'prefill pool {prefill.name}: page(s) {exc.pages} '
                    f'failed checksum at {exc.site}')
            else:
                # The landed copy mismatches the source digest: the dirty
                # pages are on the REPLICA. Full containment.
                self._handle_corruption(replica, exc.pages, exc.site)
            return None
        finally:
            prefill.release(handle)
        if self.chaos is not None \
                and self.chaos.crash_on_handoff(replica.name):
            # The worst crash instant: pages adopted, placement not yet
            # recorded. The replica dies HERE — its other streams recover
            # through the ledger, and submit() re-places this request on a
            # survivor (it was never submitted anywhere).
            self.mark_lost(replica.name, reason='handoff_crash')
            return None
        self._cache_prefix(key, replica, pid, rows)
        self._c_handoffs.inc()
        self._c_handoff_pages.inc(needed)
        shard_extra = ({'kv_shards': replica.engine.kv_shards}
                       if replica.engine.kv_shards > 1 else {})
        # The build / transfer split (real seconds of the host's calls).
        self._emit('prefill.handoff', _log=prefill.event_log,
                   request_id=rid, target=replica.name, pages=needed,
                   rows=rows, tenant=tenant, build_seconds=build_s,
                   transfer_seconds=transfer_s, **shard_extra)
        return pid

    def _shed_no_replica(self, rid, tenant):
        """The router-level typed shed: counted, logged, raised."""
        self._counter(self._noreplica_series, (tenant,),
                      'router.rejected.no_replica', {'tenant': tenant}).inc()
        self._emit('serve.reject', request_id=rid,
                   reason=RejectReason.NO_REPLICA.value,
                   queued=False, tenant=tenant)
        raise RejectedError(
            RejectReason.NO_REPLICA,
            f'request {rid}: no decode replica accepting '
            f'({len(self.pool.replicas)} replicas, every queue at its '
            f'bound)')

    # -- submission surface ----------------------------------------------
    def submit(self, prompt, *, max_new_tokens=None, deadline=None,
               request_id=None, tenant=None, session=None):
        """Place one request on a decode replica (the ladder above) and
        submit it there. Raises the replica's own typed
        :class:`RejectedError` for per-request validation sheds, or a
        router-level NO_REPLICA when every replica's queue is at its
        bound."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        tenant = str(tenant or 'default')
        rid = request_id or f'rt-{next(self._rids)}'
        # One load() scan per replica per submit feeds the accepting
        # filter, the affinity probes and the least-loaded key.
        loads = {r.name: r.load() for r in self.pool.replicas}
        accepting = [r for r in self.pool.replicas
                     if loads[r.name]['accepting']]
        if not accepting:
            self._shed_no_replica(rid, tenant)
        key = (tuple(int(t) for t in prompt[:-1])
               if len(prompt) > 1 else None)
        replica = prefix_id = None
        sub_prompt = prompt
        policy = 'load'
        hit = self._prefix_hit(key, loads)
        if hit is not None:
            replica, prefix_id, rows = hit
            sub_prompt = prompt[rows:]
            policy = 'prefix'
            self._c_hits.inc()
        else:
            if key is not None and self.cfg.prefix_cache:
                self._c_miss.inc()
            if session is not None and self.cfg.session_affinity:
                name = self._sessions.get(session)
                if name is not None and loads[name]['accepting']:
                    replica, policy = self._by_name[name], 'session'
            if replica is None:
                replica = _least_loaded(accepting, loads)
            if self.pool.prefill is not None and key is not None \
                    and len(key) >= self.cfg.prefill_threshold:
                pid = self._handoff(rid, replica, key, tenant)
                if pid is not None:
                    prefix_id, sub_prompt = pid, prompt[-1:]
        if not replica.alive:
            # The chosen replica died during the handoff: re-place on the
            # least-loaded survivor (a fresh placement — the request was
            # never submitted anywhere) or shed typed.
            survivors = [r for r in self.pool.replicas
                         if r.load()['accepting']]
            if not survivors:
                self._shed_no_replica(rid, tenant)
            loads = {r.name: r.load() for r in survivors}
            replica = _least_loaded(survivors, loads)
            prefix_id, sub_prompt, policy = None, prompt, 'load'
        req = replica.scheduler.submit(
            sub_prompt, max_new_tokens=max_new_tokens,
            deadline=deadline, request_id=rid, prefix_id=prefix_id,
            tenant=tenant)
        # Ledger entry AFTER the replica admitted it (a typed reject
        # leaves nothing to recover): the full ORIGINAL prompt, the
        # RESOLVED budget (degradation caps survive recovery), and the
        # original submit / deadline anchors.
        self._ledger[req.id] = {
            'prompt': np.asarray(prompt, np.int32),
            'max_new_tokens': req.max_new_tokens,
            'deadline': req.deadline,
            'tenant': req.tenant,
            'session': session,
            'submitted_at': req.submitted_at,
            'replica': replica.name,
            'recoveries': 0,
        }
        if session is not None:
            self._sessions[session] = replica.name
        self._count_routed(replica.name, tenant)
        self._emit('router.route', request_id=req.id,
                   target=replica.name, policy=policy, tenant=tenant)
        return req

    # -- driving surface -------------------------------------------------
    def _pending(self, member):
        """A dead member, or one with missed probes, keeps the topology
        busy until the probes have narrated its loss."""
        return not member.alive or self._probe_state.get(
            member.name, {}).get('misses', 0) > 0

    def step(self) -> bool:
        self._probe_tick()
        self._integrity_tick()
        busy = self.pool.step_all()
        # A pending detection keeps the topology "busy": until the probe
        # timeout declares a dead member lost, its in-flight streams are
        # neither running nor recovered.
        prefill = self.pool.prefill
        return busy or any(self._pending(r) for r in self.pool.replicas) \
            or (prefill is not None and self._pending(prefill))

    @property
    def results(self):
        # Retired (drained) and lost (crashed) members' finalized results
        # stay part of the run's record, topped off by the router's own
        # terminals.
        out = {}
        for r in self.pool.retired + self.pool.lost + self.pool.replicas:
            out.update(r.results)
        out.update(self._lost_results)
        return out

    def run_until_idle(self, max_ticks=100_000):
        ticks = 0
        while self.step():
            ticks += 1
            if ticks >= max_ticks:
                raise RuntimeError(
                    f'topology still busy after {max_ticks} ticks: '
                    + ' '.join(f'{r.name}={r.load()}'
                               for r in self.pool.replicas))
        return self.results

    def loads(self):
        """Per-replica placement signals, by name (each the scheduler's
        full :meth:`~distributed_dot_product_tpu_torch.serve.scheduler
        .Scheduler.load` probe)."""
        return {r.name: r.load() for r in self.pool.replicas}

    # -- failure domains -------------------------------------------------
    def _probe_ok(self, member):
        """One liveness probe: does the member answer? A chaos blackhole
        (process alive, network dead) and a dead member look identical
        from here: loss is declared from the ROUTER's
        observation, never from shared memory."""
        if self.chaos is not None and self.chaos.blackholed(member.name):
            return False
        return member.alive

    def _probe_tick(self):
        """Per-tick liveness sweep on the router's clock. Misses re-probe
        with bounded exponential backoff and ``probe_misses`` consecutive
        misses declare the member lost — a timeout, not a first-miss hair
        trigger. The prefill pool is probed exactly like a decode replica;
        its timeout declares ``prefill.lost`` instead."""
        now = self.clock()
        cfg = self.cfg
        prefill = self.pool.prefill
        members = list(self.pool.replicas)
        if prefill is not None:
            members.append(prefill)
        for member in members:
            st = self._probe_state.get(member.name)
            if st is None:
                self._probe_state[member.name] = {
                    'next': now + cfg.probe_interval, 'misses': 0}
                continue
            if now < st['next']:
                continue
            if self._probe_ok(member):
                if st['misses']:
                    # Only transitions are narrated.
                    self._emit('replica.probe', target=member.name,
                               state='ok')
                st['misses'] = 0
                st['next'] = now + cfg.probe_interval
                continue
            st['misses'] += 1
            self._emit('replica.probe', target=member.name,
                       state='missed', misses=st['misses'])
            if st['misses'] >= cfg.probe_misses:
                if member is prefill:
                    self._mark_prefill_lost(reason='probe_timeout')
                else:
                    self.mark_lost(member.name, reason='probe_timeout')
                continue
            st['next'] = now + min(
                cfg.probe_interval * cfg.probe_backoff ** st['misses'],
                cfg.probe_backoff_max)

    def _drop_member_state(self, name):
        """Forget a departing member's prefix-map entries and session
        pins; returns ``{pid: prefix tokens}`` of the dropped entries."""
        tokens_by_pid = {}
        for (rname, pid), key in list(self._pid_tokens.items()):
            if rname == name:
                tokens_by_pid[pid] = key
                del self._pid_tokens[(rname, pid)]
                self._prefix_map.pop(key, None)
        self._sessions = {s: n for s, n in self._sessions.items()
                          if n != name}
        return tokens_by_pid

    def mark_lost(self, name, *, reason='crash'):
        """Declare one decode replica dead and recover its in-flight
        streams from the recovery ledger. The dead member's prefix-map
        entries, session pins and probe state drop at once; each stream
        still in flight there re-dispatches to the least-loaded survivor
        by replay-prefill with its ORIGINAL submit / deadline anchors
        (bounded by ``max_recoveries``, then the typed REPLICA_LOST
        terminal). Returns the number of streams re-dispatched."""
        if name not in self._by_name:
            raise UnknownReplicaError(f'no replica named {name!r}')
        victim = self.pool.mark_lost(name)   # kills it if still alive
        del self._by_name[name]
        self._probe_state.pop(name, None)
        self._drop_member_state(name)
        self._c_lost.inc()
        self._set_replica_gauge()
        # In flight = ledgered to the dead member, no terminal yet. Ledger
        # order is submission order; recovery front-pushes reversed to
        # keep it (recovered work is OLDER than the survivor's queue).
        inflight = [rid for rid, e in self._ledger.items()
                    if e['replica'] == name
                    and rid not in victim.results
                    and rid not in self._lost_results]
        self._emit('replica.lost', target=name, reason=reason,
                   in_flight=len(inflight))
        self._flight_dump(
            'replica_lost',
            f'replica {name} lost ({reason}), {len(inflight)} streams in '
            f'flight')
        survivors = list(self.pool.replicas)
        loads = {r.name: r.load() for r in survivors}
        recovered = 0
        for rid in reversed(inflight):
            if self._resolve_stream(
                    rid, from_replica=name, survivors=survivors,
                    loads=loads, reason=None,
                    reject_reason=RejectReason.REPLICA_LOST):
                recovered += 1
        return recovered

    def _count_reject(self, reason, tenant):
        """One router-owned typed-reject counter series per reason
        (``router.rejected.<reason>``), labeled by tenant."""
        self._counter(self._reject_series, (reason.value, tenant),
                      f'router.rejected.{reason.value}',
                      {'tenant': tenant}).inc()

    def _resolve_stream(self, rid, *, from_replica, survivors, loads,
                        reason, reject_reason):
        """Resolve ONE displaced in-flight stream through the recovery
        ledger: requeue on the least-loaded survivor (True) or — past
        ``max_recoveries``, or with no survivor — finalize with the typed
        ``reject_reason`` terminal the router owns (False). ``reason``
        (when set) tags the ``request.recovered`` events with WHY the
        stream was displaced."""
        entry = self._ledger[rid]
        entry['recoveries'] += 1
        extra = {} if reason is None else {'reason': reason}
        if not survivors \
                or entry['recoveries'] > self.cfg.max_recoveries:
            self._emit('request.recovered', request_id=rid,
                       from_replica=from_replica, requeued=False,
                       recoveries=entry['recoveries'], **extra)
            self._count_reject(reject_reason, entry['tenant'])
            self._emit('serve.reject', request_id=rid,
                       reason=reject_reason.value,
                       queued=True, tenant=entry['tenant'])
            self._lost_results[rid] = RequestResult(
                id=rid, status='rejected', tokens=[],
                prompt_len=len(entry['prompt']), reason=reject_reason,
                finished_at=self.clock(), tenant=entry['tenant'])
            return False
        # Replay-prefill re-dispatch from the ledger alone: the survivor
        # regenerates the SAME tokens from scratch, and the original submit
        # anchor keeps TTFT / deadline honest across the crash.
        target = _least_loaded(survivors, loads)
        loads[target.name]['queued'] += 1
        req = Request(prompt=entry['prompt'],
                      max_new_tokens=entry['max_new_tokens'],
                      deadline=entry['deadline'], id=rid,
                      tenant=entry['tenant'])
        req.submitted_at = entry['submitted_at']
        target.scheduler.admission.push_front(req)
        entry['replica'] = target.name
        if entry['session'] is not None:
            self._sessions[entry['session']] = target.name
        self._c_recovered.inc()
        self._count_routed(target.name, entry['tenant'])
        self._emit('request.recovered', request_id=rid,
                   from_replica=from_replica, requeued=True,
                   target=target.name, recoveries=entry['recoveries'],
                   **extra)
        self._emit('router.route', request_id=rid, target=target.name,
                   policy='recovery', tenant=entry['tenant'])
        return True

    # -- KV page integrity (the kv.corrupt arc) --------------------------
    def _integrity_tick(self):
        """Background scrub on the router clock: re-verify every tracked
        page digest at most every ``integrity_interval`` seconds. Purely
        additive detection (the transfer / attach sites verify
        regardless), entirely host-side."""
        iv = self.cfg.integrity_interval
        if iv is None:
            return
        now = self.clock()
        if self._integrity_next is not None and now < self._integrity_next:
            return
        self._integrity_next = now + iv
        for replica in list(self.pool.replicas):
            if not replica.alive:
                continue
            bad = replica.engine.verify_pages()
            if bad:
                self._handle_corruption(replica, bad, 'scrub')
        prefill = self.pool.prefill
        if prefill is not None and prefill.alive \
                and prefill.engine.checksums is not None:
            bad = prefill.engine.verify_pages()
            if bad:
                # Staged prefixes live within one submit — nothing
                # downstream holds them, so quarantine + narration is the
                # whole containment.
                prefill.engine.quarantine_pages(bad)
                self._c_corrupt.inc()
                self._emit('kv.corrupt', target=prefill.name,
                           pages=sorted(int(p) for p in bad), site='scrub')

    def _handle_corruption(self, replica, pages, site):
        """Contain and heal one corruption verdict on a decode replica:
        quarantine the dirty pages, expel every stream decoding on or
        queued against them, invalidate every registered prefix built on
        them cluster-wide, then heal the victims through the recovery
        ledger on CLEAN replicas — the dirty one stays in the pool (a page
        fault, not a process death) but never re-hosts a victim. Returns
        the number of streams healed."""
        eng = replica.engine
        pages = sorted(int(p) for p in pages)
        # Under kv_shards page ids are global stacked rows: name the
        # owning shard(s).
        shards = sorted({s for s in (eng.page_shard(p) for p in pages)
                         if s is not None}) or None
        dirty_pids = eng.prefixes_on(pages)
        victims = replica.scheduler.requests_on_slots(
            eng.slots_sharing(pages))
        victims += [rid for rid
                    in replica.scheduler.queued_with_prefix(dirty_pids)
                    if rid not in victims]
        # Quarantine FIRST: expelling a victim releases its page
        # references, and a not-yet-quarantined dirty page would re-enter
        # the free list on the way down.
        eng.quarantine_pages(pages)
        self._c_corrupt.inc()
        extra = {'shards': shards} if shards is not None else {}
        self._emit('kv.corrupt', target=replica.name, pages=pages,
                   site=site, **extra)
        where = f' (kv shard(s) {shards})' if shards is not None else ''
        self._flight_dump(
            'kv_corrupt',
            f'replica {replica.name}: page(s) {pages} failed checksum at '
            f'{site}{where}, {len(victims)} victim stream(s)')
        expelled = [rid for rid in victims
                    if replica.scheduler.expel(rid) is not None]
        # Invalidate the poisoned prefixes AFTER the expulsions (the
        # victims' releases must see the registry references) — map
        # entries first, so no new rider can route at them.
        for pid in dirty_pids:
            key = self._pid_tokens.pop((replica.name, pid), None)
            if key is not None:
                self._prefix_map.pop(key, None)
            eng.unregister_prefix(pid)
            self._c_unregistered.inc()
        survivors = [r for r in self.pool.replicas if r.name != replica.name]
        loads = {r.name: r.load() for r in survivors}
        healed = 0
        for rid in expelled:
            if rid in self._ledger and self._resolve_stream(
                    rid, from_replica=replica.name, survivors=survivors,
                    loads=loads, reason='kv_corrupt',
                    reject_reason=RejectReason.KV_CORRUPT):
                healed += 1
        return healed

    # -- the prefill failure domain --------------------------------------
    def _mark_prefill_lost(self, *, reason='crash'):
        """Declare the prefill pool dead (probe timeout). Routing falls
        back to the replicas' own flat prefill from the next submit on; no
        stream was in flight THERE, so there is nothing to heal."""
        pool = self.pool.prefill
        if pool is None:
            return None
        self._probe_state.pop(pool.name, None)
        self.pool.mark_prefill_lost()
        self._c_prefill_lost.inc()
        self._emit('prefill.lost', target=pool.name, reason=reason)
        self._flight_dump(
            'prefill_lost',
            f'prefill pool {pool.name} lost ({reason}): long prompts fall '
            f'back to flat prefill')
        return pool

    def rebuild_pool(self):
        """Restore prefill offload after a pool loss: a fresh pool under a
        fresh name enters the probe set on the next tick."""
        pool = self.pool.rebuild_prefill()
        self._emit('replica.rejoin', target=pool.name,
                   replicas=len(self.pool.replicas))
        return pool

    def rejoin_replica(self):
        """A restarted replica rejoins through :meth:`add_replica` with a
        fresh pool (names never reuse). It starts empty, so least-loaded
        placement routes the next arrivals there."""
        replica = self.add_replica()
        self._emit('replica.rejoin', target=replica.name,
                   replicas=len(self.pool.replicas))
        return replica

    def introspection(self):
        """Router state for the flight recorder's post-mortem bundle:
        membership, the probe ledger and the recovery ledger's shape."""
        prefill = self.pool.prefill
        return {
            'replicas': [r.name for r in self.pool.replicas],
            'lost': [r.name for r in self.pool.lost],
            'retired': [r.name for r in self.pool.retired],
            'prefill': prefill.name if prefill is not None else None,
            'prefill_lost': [p.name for p in self.pool.prefill_lost],
            'probes': {n: dict(st) for n, st in self._probe_state.items()},
            'ledger_size': len(self._ledger),
            'lost_terminals': len(self._lost_results),
            'sessions': len(self._sessions),
            'prefix_entries': len(self._prefix_map),
            'quarantined': {
                r.name: sorted(r.engine.pool.quarantined)
                for r in self.pool.replicas
                if r.engine.pool is not None
                and r.engine.pool.quarantined},
        }

    def _flight_dump(self, trigger, reason=''):
        """One rate-limited post-mortem bundle through the process flight
        recorder (no-op while none is installed). Never raises: the black
        box must not take down the recovery it records."""
        rec = obs_flight.get_recorder()
        if rec is None:
            return None
        try:
            return rec.maybe_dump(
                trigger=trigger, reason=reason,
                sections={'router': self.introspection()})
        except Exception as e:
            tracing.log_exception('router.flight_dump', e,
                                  registry=self.registry)
            return None

    # -- elastic membership ---------------------------------------------
    def add_replica(self):
        """Grow the decode pool by one member and enter it into the
        placement ladder (it starts empty, so least-loaded routes the next
        arrivals there)."""
        replica = self.pool.add_replica()
        self._by_name[replica.name] = replica
        self._set_replica_gauge()
        return replica

    def drain_replica(self, name):
        """Drain and retire one decode replica: every in-flight / queued
        request preempts out (``serve.preempt`` ``requeued=true
        drain=true`` in the member's log) and REQUEUES onto the
        least-loaded remaining replica by the admission queue's
        front-push (capacity may delay drained streams, never drop them).
        Prompts that rode a registered prefix are re-expanded to their
        full token stream first. Each placement leaves a ``router.route``
        record (``policy='drain'``). Returns the number of requests
        requeued — every drained one, except a rider whose prefix was
        LRU-evicted while it sat queued: that one finalizes on the
        draining member with the typed PREFIX_UNREGISTERED reason."""
        if name not in self._by_name:
            raise UnknownReplicaError(f'no replica named {name!r}')
        if len(self.pool.replicas) <= 1:
            raise ValueError('cannot drain the last decode replica')
        # The re-expansion table BEFORE the pool drops the member.
        tokens_by_pid = self._drop_member_state(name)
        # Drain through the MEMBER first (its log and results are still
        # open), so a rider whose prefix vanished finalizes THERE.
        victim = self._by_name[name]
        migrate = []
        for req in victim.scheduler.drain():
            if req.prefix_id is not None:
                pre = tokens_by_pid.get(req.prefix_id)
                if pre is None:
                    victim.scheduler.admission.count_reject(
                        RejectReason.PREFIX_UNREGISTERED,
                        tenant=req.tenant)
                    victim.scheduler._finalize_request(
                        req, 'rejected', RejectReason.PREFIX_UNREGISTERED)
                    continue
                req.prompt = np.concatenate(
                    [np.asarray(pre, np.int32), req.prompt])
                req.prefix_id = None
                req.prefix_len = 0
            migrate.append(req)
        self.pool.remove_replica(name)      # nothing left to drain
        del self._by_name[name]
        self._set_replica_gauge()
        loads = {r.name: r.load() for r in self.pool.replicas}
        # Front-push reversed: the drained set keeps its admission order
        # AHEAD of the target's own queue — it is older work.
        for req in reversed(migrate):
            target = _least_loaded(self.pool.replicas, loads)
            loads[target.name]['queued'] += 1
            target.scheduler.admission.push_front(req)
            # The ledger follows the member actually holding the stream.
            if req.id in self._ledger:
                self._ledger[req.id]['replica'] = target.name
            self._count_routed(target.name, req.tenant)
            self._emit('router.route', request_id=req.id,
                       target=target.name, policy='drain',
                       tenant=req.tenant)
        return len(migrate)

    def close(self):
        self.pool.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def build_serving(topology: Optional[TopologyConfig] = None, *,
                  serve_config=None, router_config=None,
                  clock=time.monotonic, log_dir=None, mesh=None,
                  fault_injector=False, registry=None,
                  chaos=None) -> Router:
    """Wire a whole single-process topology: the
    :class:`~distributed_dot_product_tpu_torch.serve.replica.ReplicaPool`
    (one paged engine + scheduler + event log per decode replica, plus the
    prefill pool), a router event log under ``log_dir``, and the
    :class:`Router` over it. The returned router's ``pool.logs()`` is the
    labeled multi-source set the obs layer merges. ``chaos`` (a
    :class:`~distributed_dot_product_tpu_torch.utils.faults.ChaosInjector`)
    arms the router's chaos seams; an injector with no ``event_log`` of
    its own narrates into the router's log."""
    pool = ReplicaPool(topology, serve_config=serve_config,
                       clock=clock, log_dir=log_dir, mesh=mesh,
                       fault_injector=fault_injector)
    router = Router(pool, router_config, clock=clock,
                    event_log=pool.open_log('router'),
                    registry=registry, chaos=chaos)
    if chaos is not None and chaos.event_log is None:
        # Injections narrate next to the loss/recovery arc they cause.
        chaos.event_log = router.event_log
    return router
