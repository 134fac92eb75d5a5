# -*- coding: utf-8 -*-
"""
Disaggregated serving substrate — the port of
``distributed_dot_product_tpu/serve/replica.py``: a PREFILL pool and a
pool of data-parallel DECODE replicas, the two halves the front-end
:class:`~distributed_dot_product_tpu_torch.serve.router.Router` composes.

- :class:`PrefillPool` projects a prompt's KV through the SAME seeded
  weights every decode replica holds and parks it in registry-owned pages
  of the pool's own paged cache. The page is then the **KV transfer
  unit**: ``KernelEngine.adopt_prefix`` copies whole pages cross-cache
  into a decode replica's pool and registers them as a shared prefix
  (riders share the pages refcounted, the paged engine's prefix
  machinery at cluster level).
- :class:`DecodeReplica` wraps one ``Scheduler`` + paged ``KernelEngine``
  with its own event log and metrics registry — the replicated,
  bandwidth-bound half, decoding through K5p. Token streams depend only
  on prompt + seed, so ANY replica serves ANY request identically.
- :class:`ReplicaPool` builds a whole single-process topology from a
  :class:`TopologyConfig`.

Port-idiom differences from the reference:

- :class:`TopologyConfig` gains ``dtype`` (default ``torch.float32``, the
  reference engine's) and ``device`` (default ``'cuda'``, the port's
  rule), passed to every member; K5p on the card takes bf16, so a card
  topology sets ``dtype=torch.bfloat16``.
- ``decode_impl=None`` resolves through the engine's own resolver (the
  kernel by default); the reference's ``'xla'`` is the port's
  ``'plain'``.
- ``PrefillPool(mesh=...)`` takes the port's 1-D
  :class:`~distributed_dot_product_tpu_torch.parallel.mesh.Mesh`, a
  process group: every rank of it builds each prefix together (SPMD, as
  the reference's one program over the mesh). Rank ``r`` projects rows
  ``[r·bucket/N, (r+1)·bucket/N)`` of the padded token buffer, the
  ``all_gather`` of ``utils/comm.py`` collects the rows, and every rank
  fills its own pool's pages with all of them (the reference's
  replicated output), so any rank's handle feeds ``adopt_prefix``. The
  projection body is the engine's own ``_project_kv``, called on
  ``prefill_chunk``-row chunks at the offsets :meth:`KernelEngine
  .register_prefix` uses: cuBLAS (and MKL on the CPU) pick a GEMM by its
  row count, so one shape on every path is what keeps a handed-off
  prefix bit for bit the K/V a replica's own prefill writes, whatever
  the rank count.
- :func:`maybe_init_distributed` joins a ``torch.distributed`` process
  group from the same arguments and ``DDP_TPU_*`` variables, with an
  explicit backend; it is a no-op returning False when nothing is
  configured.
"""

import dataclasses
import os
import re
import time
from typing import Optional

import numpy as np
import torch

from distributed_dot_product_tpu_torch.models.decode import (
    _to_device, paged_append_rows,
)
from distributed_dot_product_tpu_torch.obs.events import EventLog
from distributed_dot_product_tpu_torch.obs.spans import span
from distributed_dot_product_tpu_torch.parallel.mesh import Mesh
from distributed_dot_product_tpu_torch.serve.engine import KernelEngine
from distributed_dot_product_tpu_torch.serve.errors import (
    UnknownReplicaError,
)
from distributed_dot_product_tpu_torch.serve.scheduler import (
    Scheduler, ServeConfig,
)
from distributed_dot_product_tpu_torch.utils import comm, tracing

__all__ = ['TopologyConfig', 'parse_topology', 'PrefixHandle',
           'PrefillPool', 'DecodeReplica', 'ReplicaPool',
           'maybe_init_distributed']


def _decode_impl(name):
    """The reference's decode-path names on the port: ``'xla'`` is
    ``'plain'``; None is left to the engine's resolver."""
    return 'plain' if name == 'xla' else name


@dataclasses.dataclass
class TopologyConfig:
    """Shape of one serving topology. ``prefill_pools`` is 0 (no KV
    handoff — every replica prefills its own prompts) or 1;
    ``decode_replicas`` data-parallel decode pools of ``slots`` slots
    each. Engines are paged (``pages`` per replica defaults to the
    slab-equivalent ``slots * t_max / page_size``) so the prefix registry
    is the handoff target; all replicas and the prefill pool share
    ``seed`` — identical weights are what make placement free.
    ``kv_shards > 1`` shards every replica's page table (``pages`` then
    counts PER SHARD); ``kv_checksums=False`` builds the no-integrity
    twin. ``dtype`` and ``device`` go to every member."""
    prefill_pools: int = 1
    decode_replicas: int = 2
    slots: int = 4
    t_max: int = 96
    page_size: int = 16
    pages: Optional[int] = None            # per decode replica
    prefill_pages: Optional[int] = None    # the prefill pool's own
    vocab: int = 64
    heads: int = 2
    head_dim: int = 8
    seed: int = 0
    decode_impl: Optional[str] = None
    prefill_chunk: int = 8
    kv_shards: int = 1
    kv_checksums: bool = True
    dtype: torch.dtype = torch.float32
    device: str = 'cuda'

    def validate(self):
        if self.decode_replicas < 1:
            raise ValueError(f'need >= 1 decode replica, got '
                             f'{self.decode_replicas}')
        if self.prefill_pools not in (0, 1):
            raise ValueError(f'prefill_pools must be 0 or 1, got '
                             f'{self.prefill_pools}')
        if self.page_size < 1 or self.t_max % self.page_size:
            raise ValueError(f'page_size {self.page_size} must divide '
                             f't_max {self.t_max}')
        if self.kv_shards < 1:
            raise ValueError(f'kv_shards must be >= 1, got '
                             f'{self.kv_shards}')


def parse_topology(text):
    """``'PxD'`` → ``(prefill_pools, decode_replicas)`` — the
    ``--topology 1x2`` grammar."""
    m = re.fullmatch(r'(\d+)x(\d+)', str(text).strip())
    if not m:
        raise ValueError(f"topology must look like '1x2' "
                         f'(prefill_pools x decode_replicas), got '
                         f'{text!r}')
    p, d = int(m.group(1)), int(m.group(2))
    if p not in (0, 1):
        raise ValueError(f'only 0 or 1 prefill pools are supported, '
                         f'got {p}')
    if d < 1:
        raise ValueError(f'need >= 1 decode replica, got {d}')
    return p, d


@dataclasses.dataclass
class PrefixHandle:
    """One built prefix awaiting handoff: the prefill pool's pages
    holding its KV, registered in the pool's own registry until
    :meth:`PrefillPool.release` returns them."""
    prefix_id: int
    pages: list
    length: int


class PrefillPool:
    """The sequence-sharded prefill half: prompts project to KV with
    their rows split across ``mesh``'s ranks (the buffer padded to a
    power-of-two length bucket, :meth:`_bucket`), land in registry pages
    of the pool's own paged cache, and hand off to a decode replica as
    whole pages (``KernelEngine.adopt_prefix``). Over a multi-rank mesh
    every rank calls :meth:`build` with the same tokens, in the same
    order (it runs a collective).

    The pool's weights come from the same seeded constructor every
    decode replica uses, and the projection body IS the engine's
    ``_project_kv``: a handed-off prefix is bit-identical to the KV the
    replica would have prefilled itself, which the tests pin."""

    def __init__(self, *, t_max, page_size, pages=None, vocab=64,
                 heads=2, head_dim=8, seed=0, dtype=torch.float32,
                 prefill_chunk=8, mesh=None, name='prefill',
                 event_log=None, kv_checksums=True, device='cuda'):
        self.name = name
        self.event_log = event_log
        self.alive = True
        self.mesh = mesh if mesh is not None else Mesh(None, 0, 1)
        if self.mesh.data_size != 1 or not self.mesh.member:
            raise ValueError('a prefill pool splits its rows over a 1-D '
                             'seq mesh this rank belongs to')
        self.n_shards = self.mesh.seq_size
        # Sized for prefixes in flight, not a decode batch: a built
        # prefix is released right after its pages are adopted. The
        # pool never decodes.
        self.engine = KernelEngine(
            slots=1, t_max=t_max, vocab=vocab, heads=heads,
            head_dim=head_dim, prefill_chunk=prefill_chunk, seed=seed,
            dtype=dtype, decode_impl='kernel', cache_mode='paged',
            page_size=page_size,
            pages=(pages if pages is not None
                   else 2 * (t_max // page_size)),
            kv_checksums=kv_checksums, device=device)
        self._kv_programs = {}
        self._fill_programs = {}

    def _bucket(self, n):
        """Smallest power-of-two multiple of the shard count covering
        ``n`` rows — the reference's log-bounded program count over any
        prompt mix; here the width of the padded token buffer."""
        per = -(-n // self.n_shards)
        return self.n_shards * (1 << max(0, per - 1).bit_length())

    def build(self, tokens) -> PrefixHandle:
        """Compute ``tokens``' KV and park it in freshly allocated
        registry pages of this pool's cache. The returned handle feeds
        ``KernelEngine.adopt_prefix`` on a decode replica; :meth:`release`
        it afterwards (the prefill pool is a staging area, not a cache —
        the CLUSTER cache is the decode replicas' registries plus the
        router's prefix map)."""
        if not self.alive:
            # A dead pool builds nothing — the router's probe / fallback
            # path keeps every prompt off this seam, so reaching it is a
            # routing bug, not a capacity condition.
            raise RuntimeError(f'prefill pool {self.name!r} is dead')
        eng = self.engine
        tokens = np.asarray(tokens, np.int64).reshape(-1)
        n = len(tokens)
        if n < 1:
            raise ValueError('empty prefix')
        if n + 1 > eng.t_max:
            raise ValueError(f'prefix of {n} tokens leaves no room to '
                             f'generate in a t_max={eng.t_max} cache')
        needed = eng.pool.pages_for_rows(n)
        pages = eng.pool.alloc_block(needed)
        if pages is None:
            raise RuntimeError(
                f'prefill pool exhausted building a {n}-row prefix '
                f'({needed} pages needed, {eng.pool.free_pages} free) '
                f'— a handle was not released after handoff?')
        row = np.full(eng.pool.pages_per_slot, -1, np.int64)
        row[:needed] = pages
        bucket = self._bucket(n)
        padded = np.zeros(bucket, np.int64)
        padded[:n] = tokens
        with span('prefill.build', rows=n, shards=self.n_shards):
            kv = self._kv_program(bucket)(padded)
            self._fill_program(bucket)(kv[0], kv[1], row, n)
        pid = eng._register_pages(pages, n)
        return PrefixHandle(prefix_id=pid, pages=pages, length=n)

    def _kv_program(self, bucket):
        """The watched projection program of one length bucket: this
        rank's share of the ``bucket``-row padded buffer, all-gathered
        into ``(2, H, bucket, D)`` (k and v). One per bucket, so a
        prompt mix sees log-many programs (analysis/retrace.py)."""
        prog = self._kv_programs.get(bucket)
        if prog is None:
            from distributed_dot_product_tpu_torch.analysis.retrace import (
                watch_traces,
            )

            def body(padded):
                kv = torch.stack(self._project_share(padded))
                if self.n_shards > 1:
                    # None: a mesh over the whole world is the default
                    # group.
                    kv = comm.all_gather(kv, self.mesh.seq_group, dim=2)
                return kv

            prog = self._kv_programs[bucket] = watch_traces(
                body, f'prefill.kv_{bucket}', budget=2)
        return prog

    def _fill_program(self, bucket):
        """The watched fill program of one length bucket: the first
        ``count`` gathered rows into the registry pages ``page_row``."""
        prog = self._fill_programs.get(bucket)
        if prog is None:
            from distributed_dot_product_tpu_torch.analysis.retrace import (
                watch_traces,
            )

            def body(k, v, page_row, count):
                paged_append_rows(self.engine.cache, k, v, page_row, 0,
                                  count)

            prog = self._fill_programs[bucket] = watch_traces(
                body, f'prefill.fill_{bucket}', budget=2)
        return prog

    def _project_share(self, tokens):
        """This rank's rows ``[lo, hi)`` of the ``_bucket(n)``-row padded
        buffer as cache-layout ``(k, v)``, each ``(H, hi - lo, D)``.
        The engine's own projection body, on the ``prefill_chunk``-row
        chunks :meth:`KernelEngine.register_prefix` projects (chunk ``c``
        holds rows ``[c·C, (c+1)·C)``): every row goes through a GEMM of
        the same shape at the same place in it on every path, so the rows
        keep their bits whatever the rank count; a chunk two ranks share
        is projected by both."""
        eng = self.engine
        c = eng.prefill_chunk
        per = self._bucket(len(tokens)) // self.n_shards
        lo = self.mesh.seq_rank * per
        hi = lo + per
        buf = np.zeros(-(-hi // c) * c, np.int64)
        n = min(len(tokens), len(buf))
        buf[:n] = tokens[:n]
        buf = _to_device(buf, eng.device)
        parts = []
        for start in range(lo - lo % c, hi, c):
            k, v = eng._project_kv(buf[start:start + c])
            keep = slice(max(lo, start) - start, min(hi, start + c) - start)
            parts.append((k[:, keep], v[:, keep]))
        return tuple(torch.cat(x, dim=1) for x in zip(*parts))

    def release(self, handle: PrefixHandle):
        """Return a built prefix's pages to the pool (freed pages zeroed
        — the allocator invariant)."""
        self.engine.unregister_prefix(handle.prefix_id)

    def kill(self):
        """The prefill pool's crash seam — the same discipline as
        :meth:`DecodeReplica.kill`: every staged prefix is lost, the pool
        emits nothing more, and its event log is TORN with a half-written
        record. The router's probes must notice the silence; routing
        falls back to flat prefill on the decode replicas. Idempotent."""
        if not self.alive:
            return
        self.alive = False
        if self.event_log is not None:
            self.event_log.close()
            with open(self.event_log.path, 'a', encoding='utf-8') as fh:
                fh.write('{"schema":2,"seq":')


class _DeadLog:
    """Event sink for a crashed replica's teardown: a dead process writes
    nothing, so the health monitor's clean 'stopped' transition must NOT
    land after the torn tail. The crash is narrated by the ROUTER
    (``replica.lost``), not by the corpse."""

    def emit(self, event, **fields):
        return None


_DEAD_LOG = _DeadLog()


class DecodeReplica:
    """One decode pool member: a paged :class:`KernelEngine` driven by its
    own :class:`Scheduler`, with its own event log and metrics registry —
    what ``obs.merge_events`` merges back into one request record."""

    def __init__(self, name, engine, config: Optional[ServeConfig] = None,
                 *, clock=time.monotonic, event_log=None, registry=None,
                 fault_injector=False):
        self.name = name
        self.engine = engine
        self.event_log = event_log
        self.registry = registry or tracing.MetricsRegistry()
        self.alive = True
        self.scheduler = Scheduler(
            engine, config, clock=clock, registry=self.registry,
            event_log=event_log, fault_injector=fault_injector)

    @property
    def results(self):
        return self.scheduler.results

    def load(self):
        if not self.alive:
            # A dead replica answers nothing; only callers that snapshot
            # loads before the router has declared the loss see this.
            return {'accepting': False, 'queued': 0, 'busy': 0,
                    'free_slots': 0, 'queued_by_tenant': {},
                    'oldest_deadline': None, 'free_pages': 0}
        return self.scheduler.load()

    def step(self):
        if not self.alive:
            return False
        return self.scheduler.step()

    def kill(self):
        """The crash seam: this replica's process "dies" mid-write.
        Everything in flight is lost — slots, paged KV, registered
        prefixes — and its event log is TORN: closed at the crash point
        with a partial trailing record (``read_events`` tolerates exactly
        this tail). A crashed process emits nothing more, so the health
        monitor's log is detached before teardown. Idempotent."""
        if not self.alive:
            return
        self.alive = False
        self.scheduler.health.event_log = _DEAD_LOG
        self.scheduler.close()
        if self.event_log is not None:
            self.event_log.close()
            with open(self.event_log.path, 'a', encoding='utf-8') as fh:
                # A record cut mid-serialization: no newline, invalid
                # JSON — the torn tail merge/reconstruct must absorb.
                fh.write('{"schema":2,"seq":')

    def close(self):
        if not self.alive:
            return
        self.scheduler.close()


class ReplicaPool:
    """A whole single-process topology: ``topology.decode_replicas``
    :class:`DecodeReplica`\\ s named ``r0..`` plus (optionally) one
    :class:`PrefillPool`. ``log_dir`` gives every member its own JSONL
    event log (``<log_dir>/<name>.jsonl``) on the shared ``clock``;
    :meth:`logs` returns the labeled set ``obs.reconstruct`` merges."""

    def __init__(self, topology: Optional[TopologyConfig] = None, *,
                 serve_config: Optional[ServeConfig] = None,
                 clock=time.monotonic, log_dir=None, mesh=None,
                 fault_injector=False):
        self.topology = topology or TopologyConfig()
        self.topology.validate()
        topo = self.topology
        self.clock = clock
        self.log_dir = log_dir
        self._logs = []            # (name, EventLog) — closed with us
        self.serve_config = serve_config or ServeConfig(watchdog=False)
        self._mesh = mesh
        self.prefill = None
        self.prefill_lost = []  # crashed pools: torn logs stay readable
        # Rebuild names never reuse (prefill, prefill1, ...): reopening
        # the old name would truncate the torn-tail crash evidence.
        self._prefill_seq = 0
        if topo.prefill_pools:
            self.prefill = self._build_prefill()
        self._fault_injector = fault_injector
        self.replicas = []
        # Drained-and-removed members: results and logs stay readable.
        self.retired = []
        # Crashed members: finalized results stay readable, but their
        # in-flight work was NOT drained — the router's ledger owns it.
        self.lost = []
        self._replica_seq = 0   # names never reuse: r0, r1, r2, ...
        for _ in range(topo.decode_replicas):
            self.add_replica()
        self._closed = False

    def _build_prefill(self) -> PrefillPool:
        topo = self.topology
        name = 'prefill' if self._prefill_seq == 0 \
            else f'prefill{self._prefill_seq}'
        self._prefill_seq += 1
        return PrefillPool(
            t_max=topo.t_max, page_size=topo.page_size,
            pages=topo.prefill_pages, vocab=topo.vocab,
            heads=topo.heads, head_dim=topo.head_dim,
            seed=topo.seed, dtype=topo.dtype,
            prefill_chunk=topo.prefill_chunk, mesh=self._mesh, name=name,
            event_log=self.open_log(name), kv_checksums=topo.kv_checksums,
            device=topo.device)

    def mark_prefill_lost(self) -> Optional[PrefillPool]:
        """Declare the prefill pool crashed and detach it: routing falls
        back to flat prefill on the decode replicas. The corpse's torn log
        stays in :meth:`logs` under :attr:`prefill_lost`. A pool-less
        topology returns None."""
        pool = self.prefill
        if pool is None:
            return None
        pool.kill()
        self.prefill = None
        self.prefill_lost.append(pool)
        return pool

    def rebuild_prefill(self) -> PrefillPool:
        """Restore prefill offload after a pool loss: a FRESH pool (empty
        cache, fresh log) under the next never-reused name. Refuses while
        a live pool exists, and in topologies configured without one."""
        if self.prefill is not None:
            raise ValueError('the prefill pool is alive — kill or '
                             'mark it lost before rebuilding')
        if not self.topology.prefill_pools:
            raise ValueError('this topology runs without a prefill '
                             'pool; nothing to rebuild')
        self.prefill = self._build_prefill()
        return self.prefill

    def add_replica(self) -> DecodeReplica:
        """Grow the decode pool by one member: a fresh paged engine +
        scheduler + event log under the next never-reused name. Safe
        mid-run: the shared clock and seed make its streams identical to
        any sibling's for the same prompts."""
        topo = self.topology
        name = f'r{self._replica_seq}'
        self._replica_seq += 1
        engine = KernelEngine(
            slots=topo.slots, t_max=topo.t_max, vocab=topo.vocab,
            heads=topo.heads, head_dim=topo.head_dim,
            prefill_chunk=topo.prefill_chunk, seed=topo.seed,
            dtype=topo.dtype, decode_impl=_decode_impl(topo.decode_impl),
            cache_mode='paged', page_size=topo.page_size, pages=topo.pages,
            kv_checksums=topo.kv_checksums,
            kv_shards=topo.kv_shards, device=topo.device)
        replica = DecodeReplica(
            name, engine, self.serve_config, clock=self.clock,
            event_log=self.open_log(name),
            fault_injector=self._fault_injector)
        self.replicas.append(replica)
        return replica

    def _index(self, name):
        idx = next((i for i, r in enumerate(self.replicas)
                    if r.name == name), None)
        if idx is None:
            raise UnknownReplicaError(
                f'no replica named {name!r} in the pool')
        return idx

    def remove_replica(self, name):
        """Drain one member and retire it from the pool (scale-down):
        every in-flight / queued request preempts out via
        :meth:`~distributed_dot_product_tpu_torch.serve.scheduler
        .Scheduler.drain` and is RETURNED for the caller (the router) to
        resubmit elsewhere. The member's log stays in :meth:`logs` and its
        finalized results under :attr:`retired`."""
        idx = self._index(name)
        if len(self.replicas) <= 1:
            raise ValueError('cannot remove the last decode replica')
        # Delete by INDEX: list.remove walks __eq__ and raises an untyped
        # ValueError.
        replica = self.replicas.pop(idx)
        drained = replica.scheduler.drain()
        replica.close()
        self.retired.append(replica)
        return drained

    def mark_lost(self, name) -> DecodeReplica:
        """Declare one member crashed and move it to :attr:`lost`. No
        drain — a dead scheduler cannot enumerate its queue; the router's
        recovery ledger re-places its work — and no last-member refusal:
        losing the whole pool is a fact, not a request.
        :meth:`DecodeReplica.kill` runs here if the crash seam has not
        fired already."""
        replica = self.replicas.pop(self._index(name))
        replica.kill()
        self.lost.append(replica)
        return replica

    def open_log(self, name):
        """One member's event log under ``log_dir`` (None without one) —
        tracked here so :meth:`close` closes the whole set."""
        if self.log_dir is None:
            return None
        os.makedirs(self.log_dir, exist_ok=True)
        log = EventLog(os.path.join(self.log_dir, f'{name}.jsonl'),
                       clock=self.clock)
        self._logs.append((name, log))
        return log

    def logs(self):
        """``[(name, path), ...]`` — the labeled multi-source set
        ``obs.reconstruct`` merges. Router first, then every prefill pool
        generation, then the replicas: equal-timestamp ties then resolve
        route-before-admit."""
        def order(name):
            if name == 'router':
                return 0
            return 1 if name.startswith('prefill') else 2
        return sorted(((name, log.path) for name, log in self._logs),
                      key=lambda nl: (order(nl[0]), nl[0]))

    def step_all(self):
        """One tick of every replica scheduler; True while any is busy.
        Evaluates ALL replicas (no short-circuit) — an idle replica's tick
        still refreshes its gauges and readiness."""
        busy = [r.step() for r in self.replicas]
        return any(busy)

    def close(self):
        if self._closed:
            return
        self._closed = True
        for r in self.replicas:
            r.close()
        for _, log in self._logs:
            log.close()


def maybe_init_distributed(coordinator=None, num_processes=None,
                           process_id=None, *, backend=None, environ=None):
    """Join a ``torch.distributed`` process group for a REAL multi-host
    topology — one process per host. Arguments fall back to the
    ``DDP_TPU_COORDINATOR`` (``host:port``, or any ``torch.distributed``
    init URL) / ``DDP_TPU_NUM_PROCESSES`` / ``DDP_TPU_PROCESS_ID``
    variables; ``backend`` None is ``'nccl'`` with a card and ``'gloo'``
    without. With no coordinator configured this is a NO-OP returning
    False — the single-process multi-replica mode needs no process
    group."""
    env = os.environ if environ is None else environ
    coordinator = coordinator or env.get('DDP_TPU_COORDINATOR')
    if not coordinator:
        return False
    num_processes = int(num_processes if num_processes is not None
                        else env.get('DDP_TPU_NUM_PROCESSES', '1'))
    process_id = int(process_id if process_id is not None
                     else env.get('DDP_TPU_PROCESS_ID', '0'))
    backend = backend or ('nccl' if torch.cuda.is_available() else 'gloo')
    init_method = (coordinator if '://' in coordinator
                   else f'tcp://{coordinator}')
    from distributed_dot_product_tpu_torch.utils import comm
    comm.init(backend, init_method, num_processes, process_id)
    return True
