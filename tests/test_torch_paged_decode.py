# -*- coding: utf-8 -*-
"""
The port's per-slot and paged decode caches against the reference
package on the same float32 inputs (numpy, seeded):

- K5p's plain version (``flash_decode(page_table=...)`` on CPU tensors)
  against the reference ``flash_decode(page_table=...)`` in Pallas
  interpret mode, with a scrambled table, mixed fill, a page-boundary
  append, shared prefix pages and ``-1`` entries past each fill: outputs
  within 1e-5 relative (float32, exp2 vs exp2 in another reduction
  order), pools bit-identical on every page but the sink (the TPU kernel
  parks its block write-backs there);
- each paged op against the reference op, bit for bit;
- the port's ``PagePool`` against the reference ``PagePool`` over a
  seeded random sequence of allocator operations, state equal after
  every one;
- a paged and a slab ``decode_step`` of the port, bit-identical, with a
  fork whose shared tail page the host copies before the step writes;
- the per-slot slab ops against the contracts of the reference's
  ``tests/test_decode_slots.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_dot_product_tpu.models import decode as jdec
from distributed_dot_product_tpu.ops.pallas_decode import (
    flash_decode as jax_flash_decode,
)
from distributed_dot_product_tpu_torch.models import decode as tdec
from distributed_dot_product_tpu_torch.ops.flash_decode import flash_decode

TOL = dict(atol=1e-5, rtol=1e-5)
D = 8


def _rand(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _mixed_table(rng, b, pps, ps, pages, fills, append, share=(4, 5),
                 shared_pages=2):
    """A scrambled table for slots with ``fills`` rows (plus one where
    ``append``): slots ``share`` ride the same first ``shared_pages``
    pages (full and below both fills: an append never lands on a shared
    page, the host copies it first), -1 past each fill."""
    perm = rng.permutation(pages).tolist()
    table = np.full((b, pps), -1, np.int32)
    shared, nxt = perm[:shared_pages], shared_pages
    for i, (f, a) in enumerate(zip(fills, append)):
        n = -(-(f + int(a)) // ps)
        own = shared[:n] if i in share else []
        need = n - len(own)
        table[i, :n] = own + perm[nxt:nxt + need]
        nxt += need
    return table


@pytest.mark.parametrize('h,h_kv', [(2, 2), (8, 2)])
@pytest.mark.parametrize('ps', [4, 16])
def test_paged_flash_decode_matches_jax(h, h_kv, ps):
    """Slots: mid-generation, empty (row all -1), frozen, appending on a
    page boundary, two sharing prefix pages, the last row of t_max."""
    rng = np.random.default_rng(10 * ps + h)
    b, t_max = 7, 64
    pps, pages = t_max // ps, 48
    fills = [5, 0, 9, 2 * ps, 2 * ps + 3, 2 * ps + 1, t_max - 1]
    append = [True, False, False, True, True, True, True]
    table = _mixed_table(rng, b, pps, ps, pages, fills, append)
    valid_to = np.array([f if a else f - 1 for f, a in zip(fills, append)],
                        np.int32)
    append_at = np.array([f if a else -1 for f, a in zip(fills, append)],
                         np.int32)
    q = _rand(rng, b, h, 1, D)
    kn, vn = _rand(rng, b, h_kv, 1, D), _rand(rng, b, h_kv, 1, D)
    kp = _rand(rng, pages + 1, h_kv, ps, D)
    vp = _rand(rng, pages + 1, h_kv, ps, D)
    want, wk, wv, _, _ = jax_flash_decode(
        *(jnp.asarray(x) for x in (q, kn, vn, kp, vp, valid_to, append_at)),
        page_table=jnp.asarray(table), interpret=True)
    tk, tv = _t(kp), _t(vp)
    got, gk, gv = flash_decode(_t(q), _t(kn), _t(vn), tk, tv, _t(valid_to),
                               _t(append_at), page_table=_t(table))
    assert gk is tk and gv is tv                     # appended in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(tk.numpy()[:-1], np.asarray(wk)[:-1])
    np.testing.assert_array_equal(tv.numpy()[:-1], np.asarray(wv)[:-1])
    assert not got[1].any()                          # empty slot: exact 0
    # Only the appending slots' append pages changed, and nothing went to
    # the sink.
    changed = set(np.nonzero((tk.numpy() != kp).any(axis=(1, 2, 3)))[0])
    assert changed == {int(table[i, append_at[i] // ps])
                       for i in range(b) if append_at[i] >= 0}


# -- the paged ops, bit for bit ------------------------------------------


def _paged_pair(rng, b=4, h_kv=2, t_max=16, ps=4, pages=12):
    kp, vp = _rand(rng, pages + 1, h_kv, ps, D), _rand(rng, pages + 1, h_kv,
                                                       ps, D)
    table = _mixed_table(rng, b, t_max // ps, ps, pages, [6, 0, 9, 4],
                         [True] * b, share=(0, 2), shared_pages=1)
    table[3, 1] = -1                  # an unallocated entry inside a run
    length = np.array([6, 0, 9, 4], np.int64)
    jc = jdec.PagedDecodeCache(k_pool=jnp.asarray(kp), v_pool=jnp.asarray(vp),
                               page_table=jnp.asarray(table),
                               length=jnp.asarray(length, jnp.int32))
    tc = tdec.PagedDecodeCache(k_pool=_t(kp), v_pool=_t(vp),
                               page_table=_t(table), length=length.copy())
    return jc, tc


def _same(jc, tc):
    np.testing.assert_array_equal(tc.k_pool.numpy(), np.asarray(jc.k_pool))
    np.testing.assert_array_equal(tc.v_pool.numpy(), np.asarray(jc.v_pool))
    np.testing.assert_array_equal(tc.page_table.numpy(),
                                  np.asarray(jc.page_table))
    np.testing.assert_array_equal(tc.length, np.asarray(jc.length))


def _op_append_slots(rng, jc, tc):
    n = 3
    kn, vn = _rand(rng, 4, 2, n, D), _rand(rng, 4, 2, n, D)
    mask, counts = np.array([True, True, False, True]), np.array([3, 1, 2, 3])
    jc = jdec.paged_append_kv_slots(jc, jnp.asarray(kn), jnp.asarray(vn),
                                    slot_mask=jnp.asarray(mask),
                                    counts=jnp.asarray(counts, jnp.int32))
    tc = tdec.paged_append_kv_slots(tc, _t(kn), _t(vn), slot_mask=mask,
                                    counts=counts)
    return jc, tc


def _op_append_rows(rng, jc, tc):
    k, v = _rand(rng, 2, 6, D), _rand(rng, 2, 6, D)
    row = np.array([7, 8, -1, 9], np.int32)
    jc = jdec.paged_append_rows(jc, jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(row), jnp.int32(2), jnp.int32(5))
    tc = tdec.paged_append_rows(tc, _t(k), _t(v), row, 2, 5)
    return jc, tc


def _op_reset(rng, jc, tc):
    freed = np.array([int(np.asarray(jc.page_table)[2, 1]), 11, -1, -1],
                     np.int32)
    return (jdec.paged_reset_slot(jc, jnp.int32(2), jnp.asarray(freed)),
            tdec.paged_reset_slot(tc, 2, freed))


def _op_copy_attach(rng, jc, tc):
    for args in ((3, 10, 1, 7), (5, -1, -1, 0), (4, 11, -1, 0)):
        jc = jdec.paged_copy_attach(jc, *(jnp.int32(a) for a in args))
        tc = tdec.paged_copy_attach(tc, *args)
    return jc, tc


@pytest.mark.parametrize('op', [_op_append_slots, _op_append_rows, _op_reset,
                                _op_copy_attach], ids=lambda f: f.__name__)
def test_paged_op_matches_jax(op):
    rng = np.random.default_rng(1)
    jc, tc = _paged_pair(rng)
    _same(jc, tc)
    jc, tc = op(rng, jc, tc)
    _same(jc, tc)


def test_paged_append_overflow_raises_naming_slot():
    _, tc = _paged_pair(np.random.default_rng(2))
    one = torch.ones((4, 2, 8, D))
    before = tc.k_pool.clone()
    with pytest.raises(ValueError, match='slot 2'):
        tdec.paged_append_kv_slots(tc, one, one)
    assert torch.equal(tc.k_pool, before)


# -- PagePool against the reference allocator -----------------------------


def _pool_state(pool):
    return (pool.table.tolist(), pool.refcount.tolist(), list(pool._free),
            pool.counts.tolist(), pool.lengths.tolist(), pool.dirty,
            sorted(pool.quarantined))


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_page_pool_matches_jax(seed):
    """A seeded random walk of reserve_rows / prepare_append (with the
    step's length advance) / fork / attach / truncate / release /
    quarantine: every return value and the whole pool state equal after
    each operation."""
    rng = np.random.default_rng(seed)
    slots, ps, pps, pages = 4, 4, 6, 14
    pools = [jdec.PagePool(pages, ps, slots, pps),
             tdec.PagePool(pages, ps, slots, pps)]
    prefix = None
    for _ in range(120):
        op = rng.choice(['reserve', 'append', 'fork', 'attach', 'truncate',
                         'release', 'quarantine'])
        slot = int(rng.integers(slots))
        rows = int(rng.integers(1, 6))
        keep = int(rng.integers(0, int(pools[0].lengths[slot]) + 1))
        page = int(rng.integers(pages))
        empty = [s for s in range(slots) if not pools[0].counts[s]
                 and not pools[0].lengths[s]]
        if op == 'attach' and prefix is None:
            prefix = (pools[0].alloc_block(2), 7)
            assert pools[1].alloc_block(2) == prefix[0]
        outs = []
        for pool in pools:
            if op == 'reserve':
                out = pool.reserve_rows(slot, rows)
                if out[0]:
                    pool.lengths[slot] += rows
            elif op == 'append':
                out = pool.prepare_append(slot)
                if out[0] in ('ok', 'alloc', 'cow'):
                    pool.lengths[slot] += 1
            elif op in ('fork', 'attach'):
                if not empty:
                    out = None
                elif op == 'fork':
                    out = pool.fork(slot, empty[0])
                else:
                    out = pool.attach(empty[0], *prefix)
            elif op == 'truncate':
                out = pool.truncate(slot, keep)
            elif op == 'release':
                out = pool.release(slot)
            else:
                out = pool.quarantine([page])
            outs.append(out)
        assert outs[0] == outs[1], op
        assert _pool_state(pools[0]) == _pool_state(pools[1]), op


# -- the port's paged step is the slab step ------------------------------


@pytest.mark.parametrize('impl', ['kernel', 'plain'])
def test_paged_decode_step_bit_identical_to_slab(impl):
    """The engine's use: the host pool reserves pages (one slot forked
    from another, so their tail page is shared until copy-on-write gives
    each its own), the device table mirrors it, and every step's output
    and every slot's rows equal the slab cache's bit for bit."""
    rng = np.random.default_rng(5)
    slots, h, h_kv, t_max, ps = 4, 8, 2, 32, 4
    slab = tdec.init_slot_cache(slots, h_kv, t_max, D, dtype=torch.float32,
                                device='cpu')
    paged = tdec.init_paged_cache(slots, h_kv, t_max, D, pages=24,
                                  page_size=ps, dtype=torch.float32,
                                  device='cpu')
    pool = tdec.PagePool(24, ps, slots, t_max // ps)
    prompt = _rand(rng, 1, h_kv, 6, D), _rand(rng, 1, h_kv, 6, D)
    counts = np.array([6, 0, 0, 0])
    for i, c in enumerate(counts):
        assert pool.reserve_rows(i, int(c))[0]
        pool.lengths[i] += c
    paged.page_table.copy_(torch.from_numpy(pool.table))
    k = torch.cat([_t(prompt[0])] * slots)
    v = torch.cat([_t(prompt[1])] * slots)
    slab = tdec.append_kv_slots(slab, k, v, counts=counts)
    paged = tdec.append_kv_slots(paged, k, v, counts=counts)
    # Fork slot 0 into slot 1: shared full page, copied partial tail.
    ok, src, dst = pool.fork(0, 1)
    assert ok
    paged = tdec.paged_copy_attach(paged, src, dst, 1, 6)
    slab.k[1], slab.v[1] = slab.k[0], slab.v[0]
    slab = slab._replace(length=np.array([6, 6, 0, 0]))
    assert pool.refcount[pool.table[0, 0]] == 2
    for step in range(10):
        active = np.array([True, step % 3 != 1, step >= 2, step < 5])
        for i in np.nonzero(active)[0]:
            st, src, dst = pool.prepare_append(int(i))
            assert st != 'exhausted'
            if st == 'cow':
                paged = tdec.paged_copy_attach(paged, src, dst, -1, 0)
        paged.page_table.copy_(torch.from_numpy(pool.table))
        q = _t(_rand(rng, slots, h, 1, D))
        kn, vn = _t(_rand(rng, slots, h_kv, 1, D)), _t(_rand(rng, slots,
                                                              h_kv, 1, D))
        slab, want = tdec.decode_step(q, slab, kn, vn, slot_mask=active,
                                      impl=impl)
        paged, got = tdec.decode_step(q, paged, kn, vn, slot_mask=active,
                                      impl=impl)
        pool.lengths[active] += 1
        assert torch.equal(got, want), step
        np.testing.assert_array_equal(paged.length, slab.length)
        gk, gv = tdec.paged_gather(paged)
        for i in range(slots):
            n = int(slab.length[i])
            assert torch.equal(gk[i, :, :n], slab.k[i, :, :n])
            assert torch.equal(gv[i, :, :n], slab.v[i, :, :n])
    # The fork's shared prefix page is still shared; the tails diverged.
    assert pool.table[0, 0] == pool.table[1, 0]
    assert pool.table[0, 1] != pool.table[1, 1]


# -- per-slot slab ops: the reference's contracts --------------------------

B, H, T = 3, 2, 16
LENS = [5, 9, 1]


def _filled(rng, lens=LENS, chunk=4):
    """A slot cache filled by padded chunked appends with per-slot counts
    on both sides (the scheduler's prefill), and the rows used."""
    k, v = _rand(rng, B, H, max(lens), D), _rand(rng, B, H, max(lens), D)
    jc = jdec.init_slot_cache(B, H, T, D, dtype=jnp.float32)
    tc = tdec.init_slot_cache(B, H, T, D, dtype=torch.float32, device='cpu')
    for c0 in range(0, max(lens), chunk):
        n = k[:, :, c0:c0 + chunk].shape[2]
        counts = np.array([max(0, min(ln - c0, n)) for ln in lens])
        jc = jdec.append_kv_slots(jc, jnp.asarray(k[:, :, c0:c0 + chunk]),
                                  jnp.asarray(v[:, :, c0:c0 + chunk]),
                                  counts=jnp.asarray(counts, jnp.int32))
        tc = tdec.append_kv_slots(tc, _t(k[:, :, c0:c0 + chunk]),
                                  _t(v[:, :, c0:c0 + chunk]), counts=counts)
    return jc, tc, k, v


def _same_slab(jc, tc):
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))
    np.testing.assert_array_equal(tc.length, np.asarray(jc.length))


def test_slot_append_and_per_slot_attention_match_jax():
    rng = np.random.default_rng(0)
    jc, tc, _, _ = _filled(rng)
    _same_slab(jc, tc)
    q = _rand(rng, B, H, 1, D)
    np.testing.assert_allclose(
        tdec.decode_attention(_t(q), tc).numpy(),
        np.asarray(jdec.decode_attention(jnp.asarray(q), jc)), **TOL)
    # Each slot attends exactly as it would alone (the reference's test).
    out = tdec.decode_attention(_t(q), tc)
    for i, ln in enumerate(LENS):
        solo = tdec.init_cache(1, H, T, D, dtype=torch.float32, device='cpu')
        solo = tdec.append_kv(solo, tc.k[i:i + 1, :, :ln],
                              tc.v[i:i + 1, :, :ln])
        want = tdec.decode_attention(_t(q[i:i + 1]), solo)
        np.testing.assert_allclose(out[i:i + 1].numpy(), want.numpy(),
                                   atol=1e-6)


def test_empty_slot_outputs_zero():
    tc = tdec.init_slot_cache(B, H, T, D, dtype=torch.float32, device='cpu')
    assert not tdec.decode_attention(torch.ones((B, H, 1, D)), tc).any()


def test_reset_slot_and_slot_mask_match_jax():
    rng = np.random.default_rng(1)
    jc, tc, k, v = _filled(rng)
    jc, tc = jdec.reset_slot(jc, 1), tdec.reset_slot(tc, 1)
    _same_slab(jc, tc)
    assert tc.length.tolist() == [LENS[0], 0, LENS[2]]
    mask = np.array([True, False, True])
    jc = jdec.append_kv_slots(jc, jnp.asarray(k[:, :, :1]),
                              jnp.asarray(v[:, :, :1]),
                              slot_mask=jnp.asarray(mask))
    tc = tdec.append_kv_slots(tc, _t(k[:, :, :1]), _t(v[:, :, :1]),
                              slot_mask=mask)
    _same_slab(jc, tc)
    assert tc.length.tolist() == [6, 0, 2]


@pytest.mark.parametrize('impl', ['kernel', 'plain'])
def test_slot_decode_step_matches_jax(impl):
    """decode_step with slot_mask on the per-slot slab against the
    reference's xla and kernel steps: outputs within 1e-5, caches bit
    for bit, frozen slots attending their un-advanced prefix."""
    rng = np.random.default_rng(2)
    jc, tc, _, _ = _filled(rng)
    jcs = {'xla': jc, 'kernel': jc}
    for step in range(3):
        mask = np.array([True, step != 1, step != 0])
        q, kn, vn = (_rand(rng, B, H, 1, D), _rand(rng, B, H, 1, D),
                     _rand(rng, B, H, 1, D))
        tc, got = tdec.decode_step(_t(q), tc, _t(kn), _t(vn),
                                   slot_mask=mask, impl=impl)
        for name in jcs:
            kw = dict(interpret=True) if name == 'kernel' else {}
            jcs[name], want = jdec.decode_step(
                jnp.asarray(q), jcs[name], jnp.asarray(kn), jnp.asarray(vn),
                slot_mask=jnp.asarray(mask), impl=name, **kw)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
            _same_slab(jcs[name], tc)


@pytest.mark.parametrize('impl', ['kernel', 'plain'])
def test_slot_overflow_raises_naming_slot(impl):
    tc = tdec.init_slot_cache(2, H, 4, D, dtype=torch.float32, device='cpu')
    tc = tc._replace(length=np.array([4, 0]))
    one = torch.ones((2, H, 1, D))
    before = tc.k.clone()
    with pytest.raises(ValueError, match='slot 0'):
        tdec.decode_step(one, tc, one, one, impl=impl)
    assert torch.equal(tc.k, before)
    with pytest.raises(ValueError, match='slot 0'):
        tdec.append_kv_slots(tc, one, one)


def test_scalar_cache_rejects_slot_ops():
    tc = tdec.init_cache(B, H, T, D, dtype=torch.float32, device='cpu')
    one = torch.ones((B, H, 1, D))
    with pytest.raises(ValueError, match='init_slot_cache'):
        tdec.append_kv_slots(tc, one, one)
    with pytest.raises(ValueError, match='init_slot_cache'):
        tdec.reset_slot(tc, 0)
    with pytest.raises(ValueError, match='per-slot'):
        tdec.decode_step(one, tc, one, one, slot_mask=[True] * B)


def test_slots_all_finite():
    x = torch.tensor([[1.0, 2.0], [float('nan'), 1.0], [3.0, float('inf')]])
    assert tdec.slots_all_finite(x).tolist() == [True, False, False]
    y = torch.zeros((2, 3, 4))
    y[1, 2, 1] = float('nan')
    assert tdec.slots_all_finite(y).tolist() == [True, False]


def test_page_checksums_flag_a_flipped_page():
    rng = np.random.default_rng(3)
    _, tc = _paged_pair(rng)
    sums = tdec.PageChecksums()
    sums.record(tc, [1, 2, 3])
    assert sums.verify(tc) == []
    tc.v_pool[2, 0, 0, 0] += 1.0
    assert sums.verify(tc) == [2]
    sums.drop([2])
    assert sums.verify(tc) == [] and 2 not in sums and len(sums) == 2
