# -*- coding: utf-8 -*-
"""
The prefill→decode page handoff on the port against the reference
package, float32 on the CPU:

- ``paged_transfer_pages`` against the reference function: -1-padded
  vectors, a source pool of another page count, the int8 K mirror rebuilt
  from the adopted K, the sink page never written;
- ``KernelEngine.adopt_prefix``: the pages a ``PrefillPool`` builds equal
  the reference pool's and the engine's own ``register_prefix`` (bit for
  bit within the port), a stream started on the adopted prefix equals the
  flat prompt's and the reference's, and the typed refusals (page size,
  geometry, length, page count, exhaustion);
- a corrupted source caught at ``'handoff_src'`` before any byte moves,
  a corrupted copy caught at ``'handoff_copy'`` with the prefix rolled
  back, as the reference's;
- the shard-local adoption of a ``kv_shards`` engine: every page on the
  shard owning its ordinal (the reference ``ShardedPageTable``'s
  ``owned_range``), holding the reference single-pool adoption's page for
  that ordinal; the stream after it equal to the reference single-pool
  engine's; all-or-nothing allocation with rollback; the landed-digest
  verdict naming the shard;
- the Scheduler's router hooks (``load``, ``requests_on_slots``,
  ``queued_with_prefix``, ``expel``, ``drain``) against the reference
  scheduler on the same submits, events included.

The reference's retrace sentinel is switched off for its serving runs
(``DDP_TPU_RETRACE_SENTINEL=0``): it polices the reference's jit caching,
which decides no value compared here.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_dot_product_tpu.models import decode as jdec
from distributed_dot_product_tpu.obs.events import EventLog as JEventLog
from distributed_dot_product_tpu.obs.events import read_events as jread
from distributed_dot_product_tpu.serve import KernelEngine as JaxEngine
from distributed_dot_product_tpu.serve import PrefillPool as JPrefillPool
from distributed_dot_product_tpu.serve import Scheduler as JScheduler
from distributed_dot_product_tpu.serve import ServeConfig as JServeConfig
from distributed_dot_product_tpu.serve.engine import (
    PageCorruptionError as JCorruption,
)
from distributed_dot_product_tpu.utils.tracing import (
    MetricsRegistry as JRegistry,
)
from distributed_dot_product_tpu_torch.convert import engine_state_from_jax
from distributed_dot_product_tpu_torch.models import decode as tdec
from distributed_dot_product_tpu_torch.obs.events import EventLog, read_events
from distributed_dot_product_tpu_torch.serve import (
    KernelEngine, PageCorruptionError, PrefillPool, Scheduler, ServeConfig,
    VirtualClock,
)
from distributed_dot_product_tpu_torch.utils.tracing import MetricsRegistry
from torch_serving import cyclic_gc_paused  # noqa: E402,F401  autouse

VOCAB = 32
# K/V pages against the reference: float32 GEMMs of two libraries round
# differently, so the pages agree to 1e-5 of the page's largest value.
REL = 1e-5


@pytest.fixture(autouse=True)
def _no_retrace_sentinel(monkeypatch):
    monkeypatch.setenv('DDP_TPU_RETRACE_SENTINEL', '0')


def _weights(je):
    return engine_state_from_jax({n: np.asarray(getattr(je, n)) for n in
                                  ('_embed', '_wq', '_wk', '_wv', '_wo')})


def _engine(state, **kw):
    kw.setdefault('slots', 2)
    kw.setdefault('page_size', 16)
    eng = KernelEngine(t_max=64, vocab=VOCAB, seed=3, cache_mode='paged',
                       decode_impl='kernel', device='cpu', **kw)
    eng.load_weights(state)
    return eng


def _pool(state, **kw):
    pool = PrefillPool(t_max=64, page_size=16, vocab=VOCAB, seed=3,
                       device='cpu', **kw)
    pool.engine.load_weights(state)
    return pool


def _jax_engine(**kw):
    kw.setdefault('slots', 2)
    return JaxEngine(t_max=64, vocab=VOCAB, seed=3, cache_mode='paged',
                     page_size=16, decode_impl='xla', **kw)


def _prompt(length, salt=0):
    return (((np.arange(length) * 5 + salt) % (VOCAB - 1)) + 1) \
        .astype(np.int32)


def _np(t):
    return t.detach().cpu().numpy()


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= REL * max(np.abs(want).max(), 1e-30), err


@pytest.fixture(scope='module')
def ref():
    """One reference prefill pool; its weights are every engine's."""
    pool = JPrefillPool(t_max=64, page_size=16, vocab=VOCAB, seed=3)
    return pool, _weights(pool.engine)


# -- paged_transfer_pages -----------------------------------------------

def _pools(rng, pages, quant=False):
    j = jdec.init_paged_cache(2, 2, 64, 8, pages=pages, page_size=16,
                              dtype=jnp.float32,
                              qk_quant='int8' if quant else None)
    k = rng.standard_normal(j.k_pool.shape).astype(np.float32)
    v = rng.standard_normal(j.v_pool.shape).astype(np.float32)
    j = j._replace(k_pool=jnp.asarray(k), v_pool=jnp.asarray(v))
    t = tdec.init_paged_cache(2, 2, 64, 8, pages=pages, page_size=16,
                              dtype=torch.float32, device='cpu',
                              qk_quant='int8' if quant else None)
    t.k_pool.copy_(torch.from_numpy(k))
    t.v_pool.copy_(torch.from_numpy(v))
    return j, t


@pytest.mark.parametrize('quant', [False, True])
def test_paged_transfer_pages_matches_jax(quant):
    """Padded vectors, a 5-page source into an 8-page destination, the
    int8 mirror rebuilt from the adopted K (bit for bit the reference's),
    the sink page and every unnamed page untouched."""
    rng = np.random.default_rng(0)
    jsrc, tsrc = _pools(rng, 5)
    jdst, tdst = _pools(rng, 8, quant=quant)
    src = np.array([3, 0, 4, -1, 2, -1], np.int32)
    dst = np.array([1, 6, -1, -1, 4, 7], np.int32)
    before = [_np(b).copy() for b in (tdst.k_pool, tdst.v_pool)]
    jout = jdec.paged_transfer_pages(jdst, jsrc.k_pool, jsrc.v_pool, src,
                                     dst)
    tout = tdec.paged_transfer_pages(tdst, tsrc.k_pool, tsrc.v_pool, src,
                                     dst)
    for name in ('k_pool', 'v_pool'):
        _close(_np(getattr(tout, name)), getattr(jout, name))
    for b, old in zip((tout.k_pool, tout.v_pool), before):
        moved = _np(b)
        # Copied pages hold the source's; pages 0, 2, 3, 5, 7 and the
        # sink row (8) keep their bits.
        np.testing.assert_array_equal(moved[[0, 2, 3, 5, 7, 8]],
                                      old[[0, 2, 3, 5, 7, 8]])
    np.testing.assert_array_equal(_np(tout.k_pool[[1, 6, 4]]),
                                  _np(tsrc.k_pool[[3, 0, 2]]))
    if quant:
        np.testing.assert_array_equal(_np(tout.k_q_pool[[1, 6, 4]]),
                                      np.asarray(jout.k_q_pool)[[1, 6, 4]])
        np.testing.assert_array_equal(
            _np(tout.k_scale_pool[[1, 6, 4]]),
            np.asarray(jout.k_scale_pool)[[1, 6, 4]])
        ki, sk = tdec.quantize_rows(tout.k_pool[[1, 6, 4]])
        assert torch.equal(tout.k_q_pool[[1, 6, 4]], ki)
        assert torch.equal(tout.k_scale_pool[[1, 6, 4]], sk)


def test_paged_transfer_pages_never_writes_the_sink():
    """A destination naming the sink row (the last pool row, K5p's) or a
    row past it copies nothing; a geometry mismatch is refused."""
    rng = np.random.default_rng(1)
    _, tsrc = _pools(rng, 5)
    _, tdst = _pools(rng, 8)
    sink = [_np(b[8]).copy() for b in (tdst.k_pool, tdst.v_pool)]
    tdec.paged_transfer_pages(tdst, tsrc.k_pool, tsrc.v_pool, [0, 1, 2],
                              [8, 9, 3])
    for b, old in zip((tdst.k_pool, tdst.v_pool), sink):
        np.testing.assert_array_equal(_np(b[8]), old)
    assert torch.equal(tdst.k_pool[3], tsrc.k_pool[2])
    bad = tdec.init_paged_cache(2, 2, 64, 4, pages=4, page_size=16,
                                dtype=torch.float32, device='cpu')
    with pytest.raises(ValueError, match='geometry'):
        tdec.paged_transfer_pages(tdst, bad.k_pool, bad.v_pool, [0], [0])


# -- adopt_prefix -------------------------------------------------------

@pytest.mark.parametrize('length', [19, 32, 47])
def test_prefill_pool_pages_match_jax_and_register_prefix(ref, length):
    """The pool's pages: within 1e-5 of the reference pool's, bit for bit
    the port engine's own ``register_prefix`` of the same tokens (a tail
    page, a page boundary, three pages); release frees every page."""
    jpool, state = ref
    tokens = _prompt(length)
    pool = _pool(state)
    handle = pool.build(tokens)
    jh = jpool.build(tokens)
    try:
        assert handle.length == jh.length
        assert len(handle.pages) == len(jh.pages)
        eng = _engine(state)
        pages, n = eng._prefix_registry[eng.register_prefix(tokens)]
        assert n == length and len(pages) == len(handle.pages)
        for sp, rp, jp in zip(handle.pages, pages, jh.pages):
            for name in ('k_pool', 'v_pool'):
                got = getattr(pool.engine.cache, name)[sp]
                assert torch.equal(got, getattr(eng.cache, name)[rp])
                _close(_np(got), getattr(jpool.engine.cache, name)[jp])
    finally:
        jpool.release(jh)
    pool.release(handle)
    assert pool.engine.pool.free_pages == pool.engine.pool.pages
    # The reference's bucket rule at one shard: the next power of two.
    assert pool.n_shards == 1
    assert pool._bucket(length) == 1 << (length - 1).bit_length()


def test_adopt_prefix_stream_identity_and_validation(ref):
    """A stream started on a handed-off prefix equals the same prompt
    served flat on an identical engine and the reference's adopted stream;
    mismatches are typed refusals that change nothing."""
    jpool, state = ref
    tokens = _prompt(19, 1)
    prompt = list(tokens) + [5]
    streams = []
    pool = _pool(state)
    handle = pool.build(tokens)
    dec = _engine(state)
    pid = dec.adopt_prefix(pool.engine.cache, handle.pages, handle.length,
                           src_checksums=pool.engine.checksums)
    pool.release(handle)
    flat = _engine(state)
    for eng, sub, prefix in ((dec, [prompt[-1]], pid), (flat, prompt, None)):
        with Scheduler(eng, ServeConfig(watchdog=False, max_new_tokens=8),
                       clock=VirtualClock(), registry=MetricsRegistry(),
                       fault_injector=False) as s:
            r = s.submit(sub, prefix_id=prefix, max_new_tokens=8)
            streams.append(s.run_until_idle()[r.id].tokens)
    jh = jpool.build(tokens)
    jdst = _jax_engine()
    jpid = jdst.adopt_prefix(jpool.engine.cache, jh.pages, jh.length,
                             src_checksums=jpool.engine.checksums)
    jpool.release(jh)
    s = JScheduler(jdst, JServeConfig(watchdog=False, max_new_tokens=8),
                   registry=JRegistry(), fault_injector=False)
    r = s.submit([prompt[-1]], prefix_id=jpid, max_new_tokens=8)
    streams.append(s.run_until_idle()[r.id].tokens)
    s.close()
    assert streams[0] == streams[1] == streams[2]
    for g in range(len(dec._prefix_registry[pid][0])):
        for name in ('k_pool', 'v_pool'):
            _close(_np(getattr(dec.cache, name)[
                dec._prefix_registry[pid][0][g]]),
                getattr(jdst.cache, name)[jdst._prefix_registry[jpid][0][g]])

    h2 = pool.build(tokens)
    free = dec.free_pages
    with pytest.raises(ValueError, match='page-size mismatch'):
        _engine(state, page_size=8).adopt_prefix(pool.engine.cache,
                                                 h2.pages, h2.length)
    with pytest.raises(ValueError, match='KV geometry mismatch'):
        KernelEngine(slots=2, t_max=64, vocab=VOCAB, heads=4, head_dim=4,
                     cache_mode='paged', page_size=16, device='cpu'
                     ).adopt_prefix(pool.engine.cache, h2.pages, h2.length)
    with pytest.raises(ValueError, match='source pages'):
        dec.adopt_prefix(pool.engine.cache, h2.pages[:1], h2.length)
    with pytest.raises(ValueError, match='no room'):
        dec.adopt_prefix(pool.engine.cache, h2.pages, 64)
    with pytest.raises(RuntimeError, match='exhausted'):
        _engine(state, pages=1).adopt_prefix(pool.engine.cache, h2.pages,
                                             h2.length)
    assert dec.free_pages == free and len(dec._prefix_registry) == 1
    pool.release(h2)


# -- transfer-boundary integrity ----------------------------------------

class _Lying:
    """A source table whose KV digests match nothing the copy produces —
    the wire-corruption stand-in of the reference's test."""

    def __init__(self, real):
        self._real = real

    def verify(self, cache, pages):
        return []

    def get(self, page):
        want = self._real.get(page)
        return None if want is None else (want[0] ^ 1, want[1])


def test_adopt_prefix_rejects_a_corrupted_source(ref):
    """The source pages are verified against their own table before one
    byte moves: the flipped page is named at ``'handoff_src'``, as the
    reference names it, and nothing is adopted."""
    jpool, state = ref
    tokens = _prompt(20, 2)
    pool = _pool(state)
    handle = pool.build(tokens)
    pool.engine.flip_page_bit(handle.pages[0])
    eng = _engine(state, pages=16)
    with pytest.raises(PageCorruptionError) as exc:
        eng.adopt_prefix(pool.engine.cache, handle.pages, handle.length,
                         src_checksums=pool.engine.checksums)
    jh = jpool.build(tokens)
    jpool.engine.flip_page_bit(jh.pages[0])
    with pytest.raises(JCorruption) as jexc:
        _jax_engine(pages=16).adopt_prefix(
            jpool.engine.cache, jh.pages, jh.length,
            src_checksums=jpool.engine.checksums)
    jpool.release(jh)
    assert exc.value.site == jexc.value.site == 'handoff_src'
    assert exc.value.pages == [handle.pages[0]]
    assert jexc.value.pages == [jh.pages[0]]
    assert eng._prefix_registry == {} and eng.free_pages == 16
    pool.release(handle)


@pytest.mark.parametrize('kv_shards', [1, 4])
def test_adopt_prefix_rejects_a_corrupted_copy(ref, kv_shards):
    """The LANDED copy is re-digested against the source's KV digest: a
    lying source table is caught after the copy at ``'handoff_copy'`` and
    the half-adopted prefix rolled back (every page free again); a
    kv_shards verdict names the owning shards."""
    _, state = ref
    src = _engine(state)
    pid = src.register_prefix(_prompt(37, 3))
    pages, length = src._prefix_registry[pid]
    dst = _engine(state, pages=3 if kv_shards > 1 else 16,
                  kv_shards=kv_shards)
    free = dst.pool.free_pages
    with pytest.raises(PageCorruptionError) as exc:
        dst.adopt_prefix(src.cache, pages, length,
                         src_checksums=_Lying(src.checksums))
    assert exc.value.site == 'handoff_copy'
    assert len(exc.value.pages) == 3
    if kv_shards > 1:
        assert exc.value.shards == [0, 1, 2]
    assert dst._prefix_registry == {} and dst.pool.free_pages == free
    jdst = _jax_engine(pages=16)
    jsrc = _jax_engine()
    jpid = jsrc.register_prefix(_prompt(37, 3))
    jpages, jlen = jsrc._prefix_registry[jpid]
    with pytest.raises(JCorruption) as jexc:
        jdst.adopt_prefix(jsrc.cache, jpages, jlen,
                          src_checksums=_Lying(jsrc.checksums))
    assert jexc.value.site == exc.value.site


# -- shard-local adoption -----------------------------------------------

def test_sharded_adoption_is_shard_local_and_matches_jax(ref):
    """``adopt_prefix`` into a ``kv_shards=4`` engine: each page lands on
    the shard owning its ordinal (the reference ``ShardedPageTable``'s
    ranges), holding the reference single-pool adoption's page for that
    ordinal, its landed digest the source's; the stream after it equals the
    reference single-pool engine's."""
    jpool, state = ref
    prompt = _prompt(37)
    pool = _pool(state)
    handle = pool.build(prompt)
    dst = _engine(state, pages=3, kv_shards=4)
    pid = dst.adopt_prefix(pool.engine.cache, handle.pages, handle.length,
                           src_checksums=pool.engine.checksums)
    jh = jpool.build(prompt)
    jdst = _jax_engine(pages=8)
    jpid = jdst.adopt_prefix(jpool.engine.cache, jh.pages, jh.length,
                             src_checksums=jpool.engine.checksums)
    jpool.release(jh)
    jtab = jdec.ShardedPageTable(4, 3, 16, 2, 4)
    gpages, length = dst._prefix_registry[pid]
    assert length == len(prompt) and len(gpages) == 3
    jpages = jdst._prefix_registry[jpid][0]
    for o, g in enumerate(gpages):
        s, p = dst._gsplit(g)
        assert dst.pool.owned_range(s) == jtab.owned_range(s)
        lo, hi = jtab.owned_range(s)
        assert lo <= o < hi and s == o
        cache = dst.shard_cache(s)
        for name in ('k_pool', 'v_pool'):
            _close(_np(getattr(cache, name)[p]),
                   getattr(jdst.cache, name)[jpages[o]])
            assert torch.equal(getattr(cache, name)[p],
                               getattr(pool.engine.cache,
                                       name)[handle.pages[o]])
        assert (dst.checksums[s].get(p)[0]
                == pool.engine.checksums.get(handle.pages[o])[0])
    pool.release(handle)
    assert dst.tracked_pages() == sorted(gpages)
    assert dst.prefixes_on([gpages[1]]) == [pid]

    streams = []
    for eng, p in ((dst, pid), (jdst, jpid)):
        assert eng.start_with_prefix(0, p)
        active = np.array([True, False])
        tok = np.array([int(prompt[-1])] * 2, np.int32)
        got = []
        for _ in range(16):
            tok, _ = eng.step(tok, active)
            got.append(int(tok[0]))
        streams.append(got)
    assert streams[0] == streams[1]
    # The rider shares the adopted full pages on their owners; the tail
    # ordinal's page was copied private on its owner (shard 2).
    assert dst.slots_sharing([gpages[0]]) == [0]
    assert dst.slots_sharing([gpages[2]]) == []
    dst.reset(0)
    dst.unregister_prefix(pid)
    assert dst.pool.free_pages_by_shard == [3, 3, 3, 3]


def test_sharded_adoption_rolls_back_on_one_shards_exhaustion(ref):
    """All or nothing: shard 1 out of pages fails the adoption with a
    RuntimeError naming it, and the blocks already taken on shard 0 go
    back — every shard's free count as before, nothing registered."""
    _, state = ref
    pool = _pool(state)
    handle = pool.build(_prompt(37))
    dst = _engine(state, pages=3, kv_shards=4)
    taken = dst.pool.shards[1].alloc_block(3)
    before = dst.pool.free_pages_by_shard
    with pytest.raises(RuntimeError, match='shard 1 has 0 of the 1 pages'):
        dst.adopt_prefix(pool.engine.cache, handle.pages, handle.length)
    assert dst.pool.free_pages_by_shard == before == [3, 0, 3, 3]
    assert dst._prefix_registry == {}
    dst.pool.shards[1].release_pages(taken)
    pid = dst.adopt_prefix(pool.engine.cache, handle.pages, handle.length)
    assert dst.pool.free_pages_by_shard == [2, 2, 2, 3]
    with pytest.raises(ValueError, match='adopt_prefix'):
        dst.register_prefix(_prompt(9))
    dst.unregister_prefix(pid)
    pool.release(handle)


# -- the Scheduler's router hooks ----------------------------------------

def _hook_run(sched, eng, prefill):
    """The same submits and ticks on either package's scheduler: a
    registered prefix, four requests on two slots (two riders of it),
    one tick; returns what the hooks report, then expels one running and
    one queued request and drains the rest."""
    pid = prefill(eng)
    p = _prompt(6, 4)
    sched.submit(p, request_id='a', tenant='t0')
    sched.submit([3], request_id='b', prefix_id=pid, tenant='t1')
    sched.submit(p[:4], request_id='c', tenant='t0', deadline=50.0)
    sched.submit([7], request_id='d', prefix_id=pid, tenant='t1')
    sched.step()
    load = sched.load()
    out = {'load': load,
           'on_slots': sched.requests_on_slots([0, 1]),
           'slot1': sched.requests_on_slots([1]),
           'queued_with_prefix': sched.queued_with_prefix([pid]),
           'expel_running': sched.expel('a').id,
           'expel_queued': sched.expel('d').id,
           'expel_unknown': sched.expel('zz'),
           'load_after': sched.load()}
    out['drained'] = [r.id for r in sched.drain()]
    out['load_drained'] = sched.load()
    return out


def test_scheduler_router_hooks_match_jax(ref, tmp_path):
    """``load``, ``requests_on_slots``, ``queued_with_prefix``, ``expel``
    and ``drain`` report the reference scheduler's values on the same
    submits, and emit its ``serve.preempt`` records (``expel`` /
    ``drain`` flags)."""
    _, state = ref
    runs, events = [], []
    for side in ('jax', 'port'):
        if side == 'jax':
            eng = _jax_engine(pages=16)
            log = JEventLog(tmp_path / 'jax.jsonl')
            sched = JScheduler(eng, JServeConfig(watchdog=False,
                                                 queue_limit=4),
                               registry=JRegistry(), fault_injector=False,
                               event_log=log, clock=lambda: 10.0)
        else:
            eng = _engine(state, pages=16)
            log = EventLog(tmp_path / 'port.jsonl')
            sched = Scheduler(eng, ServeConfig(watchdog=False,
                                               queue_limit=4),
                              registry=MetricsRegistry(),
                              fault_injector=False, event_log=log,
                              clock=lambda: 10.0)
        try:
            runs.append(_hook_run(sched, eng,
                                  lambda e: e.register_prefix(_prompt(20))))
        finally:
            sched.close()
            log.close()
        reader = jread if side == 'jax' else read_events
        events.append([{k: r.get(k) for k in ('request_id', 'slot',
                                              'requeued', 'drain', 'expel')}
                       for r in reader(log.path)
                       if r['event'] == 'serve.preempt'])
    assert runs[0] == runs[1]
    assert runs[1]['load']['busy'] == 2 and runs[1]['load']['queued'] == 2
    assert runs[1]['expel_running'] == 'a' and runs[1]['drained']
    assert events[0] == events[1] and events[1]
