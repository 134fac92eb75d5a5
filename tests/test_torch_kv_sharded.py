# -*- coding: utf-8 -*-
"""
The sequence-sharded page table on the port against the reference
package, float32 on the CPU:

- ``ShardedPageTable``'s host bookkeeping against the reference class:
  one seeded script of reserve_rows, prepare_append, release, truncate,
  attach and quarantine at 2 and 4 shards (one geometry whose last shard
  takes a remainder); every return value, table, count, refcount, free
  list, length and per-shard free count equal after every operation;
- ``init_sharded_paged_cache``: shapes, dtypes, table and errors;
- the single-process sharded step (``sharded_decode_step``: K5p's plain
  version with ``partials=True``, or the plain masked attention, on each
  shard's view, merged by ``merge_partials``) against the reference's
  SINGLE-POOL paged ``decode_step`` on the same rows: outputs within
  1e-5, every appended pool row bit for bit on its owner, the other
  shards' pools untouched, a shard that owns none of a slot's columns
  exactly ``(0, _NEG_BIG, 0)``; with and without a window;
- ``KernelEngine(kv_shards=N)`` streams (prefill, decode across shard
  boundaries, rollback across one, reset) against the reference's
  single-pool engine token for token (the reference's own sharded
  engine cannot step on this jax: ``ROADMAP.md`` §3);
- the engine's host surface against the reference's ``kv_shards``
  engine: ``capacity_tokens``, ``cache_stats``, the ``prepare_step``
  mask and the "free by shard" exhaustion error, the typed rejections,
  a flipped page found, named by shard and quarantined in global ids;
- the Scheduler's ladder ending a shard-starved request as
  ``CACHE_EXHAUSTED`` without a stall, and the shard geometry named by
  ``decode_kernel_eligible``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_dot_product_tpu.models import decode as jdec
from distributed_dot_product_tpu.serve import KernelEngine as JaxEngine
from distributed_dot_product_tpu.serve.engine import (
    PageCorruptionError as JaxCorruption,
)
from distributed_dot_product_tpu_torch.convert import engine_state_from_jax
from distributed_dot_product_tpu_torch.models import decode as tdec
from distributed_dot_product_tpu_torch.ops.flash_decode import _NEG_BIG
from distributed_dot_product_tpu_torch.serve import (
    KernelEngine, PageCorruptionError, RejectReason, Scheduler, ServeConfig,
)
from distributed_dot_product_tpu_torch.utils.faults import (
    ServeFaultInjector, ServeFaultPlan,
)
from distributed_dot_product_tpu_torch.utils.tracing import MetricsRegistry
from torch_serving import cyclic_gc_paused  # noqa: E402,F401  autouse

TOL = dict(atol=1e-5, rtol=1e-5)
VOCAB = 32


def _t(x):
    return torch.from_numpy(np.array(x))


# -- ShardedPageTable against the reference ------------------------------

# name: (n_shards, pages_per_shard, pages_per_slot); page size 4, 4 slots.
GEOMETRIES = {'2x8': (2, 10, 8), '4x8': (4, 5, 8), '4x7_remainder': (4, 5, 7)}
PT_PS, PT_SLOTS = 4, 4


def _state(tab):
    return dict(tables=tab.local_tables().tolist(),
                counts=[p.counts.tolist() for p in tab.shards],
                refcount=[p.refcount.tolist() for p in tab.shards],
                free=[list(map(int, p._free)) for p in tab.shards],
                lengths=tab.lengths.tolist(),
                free_by_shard=tab.free_pages_by_shard,
                quarantined=sorted(tab.quarantined),
                totals=(tab.pages, tab.free_pages, tab.used_pages,
                        tab.shared_pages, tab.dirty),
                covered=[tab.covered_rows(s) for s in range(PT_SLOTS)],
                slot_pages=[tab.slot_pages(s) for s in range(PT_SLOTS)])


def _norm(x):
    """Return values in comparable form (numpy scalars to ints)."""
    if isinstance(x, dict):
        return {int(k): _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, (bool, np.bool_)):
        return bool(x)
    if isinstance(x, (int, np.integer)):
        return int(x)
    return x


def _script(tab, seed, ops=200):
    """A seeded run of the table's mutators; the log of every return
    value and the whole state after each operation."""
    rng = np.random.default_rng(seed)
    log = []
    pps = tab.pages_per_slot
    for _ in range(ops):
        op = rng.choice(['reserve', 'append', 'append', 'release',
                         'truncate', 'attach', 'quarantine'],
                        p=[.2, .15, .15, .1, .15, .2, .05])
        slot = int(rng.integers(PT_SLOTS))
        if op == 'reserve':
            rows = int(rng.integers(1, 9))
            res = tab.reserve_rows(slot, rows)
            if res[0]:
                tab.lengths[slot] += rows
        elif op == 'append':
            res = tab.prepare_append(slot)
            if res[0] in ('ok', 'alloc', 'cow'):
                tab.lengths[slot] += 1
        elif op == 'release':
            res = tab.release(slot)
        elif op == 'truncate':
            res = tab.truncate(slot, int(rng.integers(
                0, int(tab.lengths[slot]) + 1)))
        elif op == 'attach':
            # An empty slot shares another slot's mapped prefix, then
            # rolls back into a shared page (its next append or
            # reservation copies it).
            empty = [s for s in range(PT_SLOTS)
                     if not tab.lengths[s] and not tab.slot_pages(s)]
            srcs = [s for s in range(PT_SLOTS)
                    if tab.lengths[s] and tab.covered_rows(s) >= tab.lengths[s]]
            if not empty or not srcs:
                res = 'skip'
            else:
                slot = empty[int(rng.integers(len(empty)))]
                src = srcs[int(rng.integers(len(srcs)))]
                length = int(tab.lengths[src])
                pages = np.full(pps, -1, np.int64)
                for o in range(tab.pages_for_rows(length)):
                    pages[o] = tab.shards[tab.owner(o)].table[src, o]
                res = [tab.attach(slot, pages, length)]
                if res[0][0] and length > PT_PS:
                    res.append(tab.truncate(slot, length - int(
                        rng.integers(1, PT_PS + 1))))
        else:
            shard = int(rng.integers(tab.n_shards))
            res = tab.quarantine(shard, [int(rng.integers(
                tab.pages_per_shard))])
        log.append((str(op), slot, _norm(res), _state(tab)))
    return log


@pytest.mark.parametrize('geom', sorted(GEOMETRIES))
def test_sharded_page_table_matches_jax(geom):
    n, pages, pps = GEOMETRIES[geom]
    want = jdec.ShardedPageTable(n, pages, PT_PS, PT_SLOTS, pps)
    got = tdec.ShardedPageTable(n, pages, PT_PS, PT_SLOTS, pps)
    assert got.ordinals_per_shard == want.ordinals_per_shard
    assert [got.owned_range(s) for s in range(n)] == \
        [want.owned_range(s) for s in range(n)]
    np.testing.assert_array_equal(got.owner_vector(), want.owner_vector())
    for g in range(n * (pages + 1)):
        assert got.gsplit(g) == want.gsplit(g)
        assert got.page_shard(g) == want.page_shard(g)
        assert got.gpage(*got.gsplit(g)) == g
    assert _state(got) == _state(want)
    for step, (a, b) in enumerate(zip(_script(got, n + pps),
                                      _script(want, n + pps))):
        assert a == b, f'operation {step}: {a[:3]} != {b[:3]}'


def test_sharded_page_table_refuses_one_shard():
    for cls in (jdec.ShardedPageTable, tdec.ShardedPageTable):
        with pytest.raises(ValueError, match='n_shards >= 2'):
            cls(1, 4, PT_PS, PT_SLOTS, 8)


def test_init_sharded_paged_cache_matches_jax():
    args = (4, 3, 2, 32, 8)
    for dtype, jdt in ((torch.bfloat16, jnp.bfloat16),
                       (torch.float32, jnp.float32)):
        want = jdec.init_sharded_paged_cache(*args, pages_per_shard=5,
                                             page_size=4, dtype=jdt)
        got = tdec.init_sharded_paged_cache(*args, pages_per_shard=5,
                                            page_size=4, dtype=dtype,
                                            device='cpu')
        for name in ('k_pool', 'v_pool', 'page_table'):
            w, g = getattr(want, name), getattr(got, name)
            assert tuple(g.shape) == w.shape, name
            assert str(g.dtype).split('.')[-1] == str(w.dtype), name
            np.testing.assert_array_equal(g.float().numpy(),
                                          np.asarray(w, np.float32))
        assert got.length.shape == want.length.shape
        assert not got.length.any() and got.k_q_pool is None
        # Shard s's view: its pool block, its table, the shared length.
        view = tdec.shard_view(got, 2)
        assert view.k_pool.data_ptr() == got.k_pool[12].data_ptr()
        assert view.pages == 5 and view.page_table.shape == (3, 8)
        assert view.length is got.length
    for kw in (dict(pages_per_shard=5, page_size=5),
               dict(pages_per_shard=0, page_size=4)):
        with pytest.raises(ValueError) as want_err:
            jdec.init_sharded_paged_cache(*args, **kw)
        with pytest.raises(ValueError) as got_err:
            tdec.init_sharded_paged_cache(*args, device='cpu', **kw)
        assert str(got_err.value) == str(want_err.value)
    with pytest.raises(ValueError, match='n_shards >= 2'):
        tdec.init_sharded_paged_cache(1, 3, 2, 32, 8, pages_per_shard=5,
                                      page_size=4, device='cpu')


# -- the sharded step against the single-pool reference ------------------

# 4 shards of 2 ordinals (page 4, t_max 32): slot 0 spans shards 0-1 and
# crosses into shard 2 during the steps, slot 1's columns all lie on
# shard 0, slot 2 starts empty and frozen, then appends on shard 0.
WORLD, B, H, HKV, D, PS, T = 4, 3, 4, 2, 8, 4, 32
PAGES_SHARD = 6
FILLS = (13, 4, 0)
ACTIVE = ((1, 1, 0), (1, 1, 0), (1, 1, 1), (1, 1, 1))


def _filled(seed):
    """The reference's single-pool cache and allocator, and the port's
    stacked sharded cache and table, holding the same rows."""
    rng = np.random.default_rng(seed)
    jc = jdec.init_paged_cache(B, HKV, T, D, pages=WORLD * PAGES_SHARD,
                               page_size=PS, dtype=jnp.float32)
    jpool = jdec.PagePool(WORLD * PAGES_SHARD, PS, B, T // PS)
    spt = tdec.ShardedPageTable(WORLD, PAGES_SHARD, PS, B, T // PS)
    tc = tdec.init_sharded_paged_cache(
        WORLD, B, HKV, T, D, pages_per_shard=PAGES_SHARD, page_size=PS,
        dtype=torch.float32, device='cpu')._replace(length=spt.lengths)
    for slot, n in enumerate(FILLS):
        if not n:
            continue
        k, v = (rng.standard_normal((B, HKV, n, D), dtype=np.float32)
                for _ in range(2))
        counts = np.where(np.arange(B) == slot, n, 0).astype(np.int32)
        assert jpool.reserve_rows(slot, n)[0] and spt.reserve_rows(slot, n)[0]
        jc = jdec.append_kv_slots(jc._replace(
            page_table=jnp.asarray(jpool.table)), jnp.asarray(k),
            jnp.asarray(v), counts=jnp.asarray(counts))
        tc.page_table.copy_(_t(spt.local_tables()))
        for s in range(WORLD):
            tdec.append_kv_slots(tdec.shard_view(tc, s), _t(k), _t(v),
                                 counts=counts)
        jpool.lengths[slot] += n
        spt.lengths[slot] += n
    return jc, jpool, tc, spt


def _owner_rows(tc, spt, slot, length):
    """K and V rows ``0..length-1`` of ``slot`` read from their owners'
    pools."""
    rows = []
    for pos in range(length):
        o, r = divmod(pos, PS)
        s = spt.owner(o)
        page = int(spt.shards[s].table[slot, o])
        view = tdec.shard_view(tc, s)
        rows.append((view.k_pool[page, :, r].numpy(),
                     view.v_pool[page, :, r].numpy()))
    return rows


@pytest.mark.parametrize('window', [None, 6], ids=str)
@pytest.mark.parametrize('impl', ['kernel', 'plain'])
def test_sharded_step_matches_jax_single_pool(impl, window):
    jc, jpool, tc, spt = _filled(1)
    rng = np.random.default_rng(2)
    owned = [set() for _ in range(WORLD)]     # (page) each shard mapped
    for active in ACTIVE:
        act = np.asarray(active, bool)
        q = rng.standard_normal((B, H, 1, D), dtype=np.float32)
        kn, vn = (rng.standard_normal((B, HKV, 1, D), dtype=np.float32)
                  for _ in range(2))
        for slot in np.nonzero(act)[0]:
            assert jpool.prepare_append(int(slot))[0] in ('ok', 'alloc')
            assert spt.prepare_append(int(slot))[0] in ('ok', 'alloc')
        jc = jc._replace(page_table=jnp.asarray(jpool.table))
        tc.page_table.copy_(_t(spt.local_tables()))
        jc, want = jdec.decode_step(jnp.asarray(q), jc, jnp.asarray(kn),
                                    jnp.asarray(vn), slot_mask=act,
                                    window=window, impl='xla')
        views = [tdec.shard_view(tc, s) for s in range(WORLD)]
        _, got = tdec.sharded_decode_step(_t(q), views, _t(kn), _t(vn),
                                          slot_mask=act, window=window,
                                          impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        jpool.lengths[act] += 1
        spt.lengths[act] += 1
    assert spt.lengths.tolist() == [17, 8, 2]
    assert spt.owner(16 // PS) == 2           # slot 0 crossed into shard 2
    # Every row bit for bit on its owner; unmapped pages stay zero.
    gk, gv = (np.asarray(x) for x in jdec.paged_gather(jc))
    for slot in range(B):
        ln = int(spt.lengths[slot])
        for pos, (k, v) in enumerate(_owner_rows(tc, spt, slot, ln)):
            np.testing.assert_array_equal(k, gk[slot, :, pos])
            np.testing.assert_array_equal(v, gv[slot, :, pos])
        for s, pool in enumerate(spt.shards):
            owned[s] |= {int(p) for p in pool.table[slot] if p >= 0}
    for s in range(WORLD):
        view = tdec.shard_view(tc, s)
        idle = [p for p in range(PAGES_SHARD + 1) if p not in owned[s]]
        assert not view.k_pool[idle].any() and not view.v_pool[idle].any()
    # Shards 1-3 own none of slot 1's or slot 2's columns: exactly (0,
    # _NEG_BIG, 0).
    q = _t(rng.standard_normal((B, H, 1, D), dtype=np.float32))
    frozen = np.zeros(B, bool)
    for s in range(1, WORLD):
        _, (num, m, l) = tdec.paged_partials_step(
            q, tdec.shard_view(tc, s), q[:, :HKV], q[:, :HKV],
            slot_mask=frozen, window=window, impl=impl)
        assert not num[1:].any() and not l[1:].any()
        assert (m[1:] == np.float32(_NEG_BIG)).all()


def test_sharded_step_refusals():
    jc, jpool, tc, spt = _filled(1)
    views = [tdec.shard_view(tc, s) for s in range(WORLD)]
    x = torch.zeros((B, H, 2, D))
    with pytest.raises(ValueError, match='single-token'):
        tdec.sharded_decode_step(x, views, x[:, :HKV], x[:, :HKV],
                                 impl='kernel')
    with pytest.raises(ValueError, match='counts'):
        tdec.decode_step(x, views[0], x[:, :HKV], x[:, :HKV],
                         counts=np.ones(B), group=object(), impl='plain')
    assert spt.lengths.tolist() == list(FILLS)


def test_eligible_explanations_name_shard_geometry():
    """The reference's own probes; the geometry text is the reference's
    word for word."""
    kw = dict(pages=4, page_size=8)
    jc = jdec.init_paged_cache(2, 2, 64, 8, dtype=jnp.float32, **kw)
    tc = tdec.init_paged_cache(2, 2, 64, 8, dtype=torch.float32,
                               device='cpu', **kw)
    probes = (dict(n_shards=4), dict(n_shards=4, shard=2),
              dict(n=2, n_shards=4, shard=1), dict())
    for probe in probes:
        ok, why = tdec.decode_kernel_eligible(tc, explain=True, **probe)
        jok, jwhy = jdec.decode_kernel_eligible(jc, explain=True, **probe)
        assert ok == jok
        assert (why or '').split(' — ')[0] == (jwhy or '').split(' — ')[0]
    assert 'contiguous run of 2' in tdec.decode_kernel_eligible(
        tc, explain=True, n_shards=4)[1]
    ok, why = tdec.decode_kernel_eligible(tc, n=2, explain=True, n_shards=4,
                                          shard=1)
    assert not ok and 'shard 1/4' in why and 'single-token' in why
    slab = tdec.init_cache(2, 2, 16, 8, dtype=torch.float32, device='cpu')
    jslab = jdec.init_cache(2, 2, 16, 8, dtype=jnp.float32)
    assert tdec.decode_kernel_eligible(slab, explain=True, n_shards=2,
                                       shard=1) == \
        jdec.decode_kernel_eligible(jslab, explain=True, n_shards=2,
                                    shard=1)
    assert tdec.decode_kernel_eligible(tc, explain=True) == (True, None)


# -- the kv_shards engine ------------------------------------------------

def _engine_kw(t_max=64, page_size=16, **kw):
    return dict(slots=2, t_max=t_max, vocab=VOCAB, heads=2, head_dim=8,
                prefill_chunk=8, seed=3, cache_mode='paged',
                page_size=page_size, **kw)


def _jax_engine(**kw):
    return JaxEngine(decode_impl='xla', **_engine_kw(**kw))


def _port_engine(je, impl='plain', **kw):
    te = KernelEngine(decode_impl=impl, device='cpu', **_engine_kw(**kw))
    te.load_weights(engine_state_from_jax(
        {name: np.asarray(getattr(je, name))
         for name in ('_embed', '_wq', '_wk', '_wv', '_wo')}))
    return te


def _prompt(length, salt=0):
    return (((np.arange(length) * 5 + salt) % (VOCAB - 1)) + 1) \
        .astype(np.int32)


def _stream(eng, prompt, steps, slot=0):
    for st in range(0, len(prompt), 8):
        eng.prefill(slot, prompt[st:st + 8])
    active = np.zeros(eng.slots, bool)
    active[slot] = True
    tok = np.full(eng.slots, int(prompt[-1]), np.int32)
    out = []
    for _ in range(steps):
        tok, _ = eng.step(tok, active)
        out.append(int(tok[slot]))
    return out


@pytest.mark.parametrize('impl', ['kernel', 'plain'])
def test_kv_sharded_stream_matches_jax_single_pool(impl):
    """4 shards of one ordinal each: the prompt fills shards 0-2, decoding
    crosses into shard 3."""
    ref = _jax_engine(pages=8)
    sh = _port_engine(ref, impl, pages=2, kv_shards=4)
    assert sh.placement == ['cpu'] * 4
    assert _stream(sh, _prompt(37), 24) == _stream(ref, _prompt(37), 24)
    assert sh.cache_stats()['kv_shards'] == 4
    assert sh.pool.lengths.tolist() == [61, 0]
    np.testing.assert_array_equal(sh.lengths(), ref.lengths())


def test_kv_sharded_rollback_and_reset_match_jax_single_pool():
    """Rollback across a shard boundary and a reset keep the sharded
    stream on the single-pool reference's."""
    ref = _jax_engine(pages=8)
    sh = _port_engine(ref, 'kernel', pages=2, kv_shards=4)
    a = _stream(ref, _prompt(21), 20)
    assert _stream(sh, _prompt(21), 20) == a
    keep = int(sh.pool.lengths[0]) - 7          # 41 -> 34: frees shard 2's
    big = np.iinfo(np.int32).max
    ref.rollback(np.array([keep, big]))
    sh.rollback(np.array([keep, big]))
    assert int(ref.pool.lengths[0]) == int(sh.pool.lengths[0]) == keep
    assert sh.pool.free_pages_by_shard == [1, 1, 1, 2]
    view = sh.shard_cache(2)
    assert not view.k_pool[:, :, keep % 16:].any()   # rejected rows zeroed
    active = np.array([True, False])
    tr = ts = np.array([a[-8]] * 2, np.int32)
    for _ in range(6):
        nr, _ = ref.step(tr, active)
        ns, _ = sh.step(ts, active)
        assert int(nr[0]) == int(ns[0])
        tr, ts = nr, ns
    ref.reset(0)
    sh.reset(0)
    assert ref.pool.used_pages == sh.pool.used_pages == 0
    assert not any(sh.shard_cache(s).k_pool.any() for s in range(4))
    assert _stream(ref, _prompt(19, salt=2), 8) \
        == _stream(sh, _prompt(19, salt=2), 8)


def test_capacity_and_stats_match_jax_kv_shards():
    caps = {}
    for n in (1, 2, 4):
        je = _jax_engine(t_max=1024, pages=4, kv_shards=n)
        te = _port_engine(je, t_max=1024, pages=4, kv_shards=n)
        caps[n] = te.capacity_tokens
        assert te.capacity_tokens == je.capacity_tokens
        assert te.cache_stats() == je.cache_stats()
        assert te.pool.pages == 4 * n
    assert caps[4] >= 3.5 * caps[1] and caps[2] >= 1.75 * caps[1]


def test_shard_exhaustion_matches_jax_kv_shards():
    """One shard's range out of pages while the others have headroom: the
    prepare_step mask and the step's "free by shard" error, the
    reference's word for word."""
    engines = []
    je = _jax_engine(kv_shards=4, pages=1)
    for eng in (je, _port_engine(je, kv_shards=4, pages=1)):
        assert eng.pool.reserve_rows(0, 16)[0]
        assert eng.pool.free_pages_by_shard == [0, 1, 1, 1]
        assert eng.pool.free_pages == 3
        assert not eng.pool.reserve_rows(1, 16)[0]
        assert list(eng.prepare_step(np.array([True, True]))) == [True,
                                                                  False]
        with pytest.raises(RuntimeError, match='free by shard') as err:
            eng.step(np.zeros(2, np.int32), np.array([True, True]))
        engines.append(str(err.value))
    assert engines[0] == engines[1]


def test_kv_shards_typed_rejections_match_jax():
    for make in (lambda **kw: JaxEngine(decode_impl='xla', **kw),
                 lambda **kw: KernelEngine(device='cpu', **kw)):
        with pytest.raises(ValueError, match='kv_shards'):
            make(slots=2, t_max=32, vocab=VOCAB, kv_shards=2)
        for kw in (dict(kv_shards=8), dict(kv_shards=0)):
            with pytest.raises(ValueError, match='kv_shards'):
                make(**_engine_kw(**kw))
        eng = make(**_engine_kw(kv_shards=2, pages=4))
        with pytest.raises(ValueError, match='kv_shards'):
            eng.register_prefix(_prompt(20))
        with pytest.raises(ValueError, match='kv_shards'):
            eng.fork_slot(0, 1)
        with pytest.raises(ValueError, match='kv_shards'):
            eng.verify_step(np.zeros((2, 2), np.int32), np.ones(2, int),
                            np.ones(2, bool))


def test_flip_detected_named_and_quarantined_match_jax():
    """A slot's pages digested at a transfer boundary (global ids), one
    flipped: verification names it, the error names its shard, and the
    quarantine pins the (shard, local) pair — as the reference's
    kv_shards engine does."""
    je = _jax_engine(pages=3, kv_shards=4)
    te = _port_engine(je, pages=3, kv_shards=4)
    verdicts = []
    for eng, error in ((je, JaxCorruption), (te, PageCorruptionError)):
        prompt = _prompt(37)
        for st in range(0, len(prompt), 8):
            eng.prefill(0, prompt[st:st + 8])
        pool = eng.pool
        gpages = [eng._gpage(pool.owner(o),
                             int(pool.shards[pool.owner(o)].table[0, o]))
                  for o in range(3)]
        eng._checksum_record(gpages)
        assert eng.verify_pages() == []
        victim = gpages[-1]                     # ordinal 2 -> shard 2
        shard = eng.page_shard(victim)
        assert shard == 2
        eng.flip_page_bit(victim)
        assert eng.verify_pages() == [victim]
        with pytest.raises(error) as err:
            eng.check_pages(gpages, 'attach')
        assert err.value.pages == [victim] and err.value.shards == [shard]
        assert f'kv shard(s) [{shard}]' in str(err.value)
        assert eng.quarantine_pages([victim]) == [victim]
        assert (shard, eng._gsplit(victim)[1]) in pool.quarantined
        assert eng.verify_pages() == []
        verdicts.append((gpages, str(err.value), sorted(pool.quarantined),
                         pool.free_pages_by_shard))
    assert verdicts[0] == verdicts[1]
    assert te.page_shard(0) == 0 and KernelEngine(
        device='cpu', **_engine_kw()).page_shard(0) is None


@pytest.mark.parametrize('impl', ['kernel', 'plain'])
def test_shard_exhaustion_walks_the_ladder(impl):
    """Two growing streams contend for ONE shard's range (the others stay
    free) under a stalled step: the scheduler preempts, the winner
    completes and the loser ends as the typed CACHE_EXHAUSTED eviction;
    the pool drains."""
    eng = KernelEngine(slots=2, t_max=16, vocab=VOCAB, heads=2, head_dim=4,
                       prefill_chunk=4, seed=5, cache_mode='paged',
                       page_size=2, pages=2, kv_shards=4, decode_impl=impl,
                       device='cpu')
    samples = []
    sched = Scheduler(
        eng, ServeConfig(queue_limit=4, max_new_tokens=10, watchdog=False,
                         evict_before_reject=False, max_requeues=0),
        registry=MetricsRegistry(),
        fault_injector=ServeFaultInjector(ServeFaultPlan(
            stuck_at_step=3, stuck_seconds=0.01)),
        on_tick=lambda s: samples.append(
            (s.engine.pool.free_pages_by_shard[0],
             s.engine.pool.free_pages)))
    sched.submit([1], request_id='a')
    sched.submit([2], request_id='b')
    results = sched.run_until_idle()
    assert sched.registry.snapshot()['counters']['serve.cache_preempted'] >= 1
    assert sorted(r.status for r in results.values()) == ['completed',
                                                          'evicted']
    loser = next(r for r in results.values() if r.status == 'evicted')
    assert loser.reason is RejectReason.CACHE_EXHAUSTED
    assert any(s0 == 0 and total > 0 for s0, total in samples), samples
    assert eng.pool.used_pages == 0
    sched.close()
