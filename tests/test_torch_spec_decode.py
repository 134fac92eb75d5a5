# -*- coding: utf-8 -*-
"""
Verify-k decode and acceptance-prefix rollback of the port (the kernel
half of speculative decoding) against the reference package.

- ``decode_step`` with ``q (B, H, k, d)`` and per-slot ``counts`` on
  slab and paged caches, MHA and GQA, with and without a window, counts
  0 / 1 / partial / full and a frozen slot: both port impls against the
  reference's ``impl='xla'`` and its Pallas kernel (interpreted);
- the port's verify step is bit for bit its own sequential one-row
  steps (``decode_step`` and ``flash_decode``, every query row);
- the overflow contract and the K-split limits;
- ``rollback_slots`` / ``paged_rollback_slots``: bit-identical to
  accepted-only appends and to the reference's ops, a sentinel leaves a
  slot untouched, pages go back to the pool, and ``PagePool.truncate``
  matches the reference's on page boundaries.

Float32; outputs at atol = rtol = 1e-5, caches bit for bit.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_dot_product_tpu.models import decode as jdec
from distributed_dot_product_tpu.ops.pallas_decode import (
    flash_decode as jax_flash_decode,
)
from distributed_dot_product_tpu_torch.models import decode as tdec

fd = importlib.import_module(
    'distributed_dot_product_tpu_torch.ops.flash_decode')

TOL = dict(atol=1e-5, rtol=1e-5)
D, T, K, PS = 8, 32, 4, 8
PRE = [5, 9, 0, 12, 7]                 # rows per slot before the step
COUNTS = [4, 1, 2, 0, 3]               # rows each slot appends (full,
MASK = [True, True, True, True, False]  # one, partial, none; frozen)


def _rand(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _prefilled(rng, h_kv, paged):
    """Reference and port caches holding ``PRE`` rows per slot (paged:
    pages reserved for the prefix plus K verify rows)."""
    b = len(PRE)
    rows = max(PRE)
    kn, vn = _rand(rng, b, h_kv, rows, D), _rand(rng, b, h_kv, rows, D)
    counts = np.asarray(PRE)
    if paged:
        pool = tdec.PagePool(24, PS, b, T // PS)
        jpool = jdec.PagePool(24, PS, b, T // PS)
        for s in range(b):
            for p in (pool, jpool):
                assert p.reserve_rows(s, PRE[s] + K)[0]
        jc = jdec.init_paged_cache(b, h_kv, T, D, pages=24, page_size=PS,
                                   dtype=jnp.float32)
        jc = jc._replace(page_table=jnp.asarray(jpool.table))
        tc = tdec.init_paged_cache(b, h_kv, T, D, pages=24, page_size=PS,
                                   dtype=torch.float32, device='cpu')
        tc.page_table.copy_(torch.from_numpy(pool.table))
    else:
        pool = None
        jc = jdec.init_slot_cache(b, h_kv, T, D, dtype=jnp.float32)
        tc = tdec.init_slot_cache(b, h_kv, T, D, dtype=torch.float32,
                                  device='cpu')
    jc = jdec.append_kv_slots(jc, jnp.asarray(kn), jnp.asarray(vn),
                              counts=jnp.asarray(counts, jnp.int32))
    tc = tdec.append_kv_slots(tc, _t(kn), _t(vn), counts=counts)
    return jc, tc, pool


def _bufs(cache):
    return [x for x in (cache[:2] if not hasattr(cache, 'k_pool')
                        else (cache.k_pool, cache.v_pool))]


def _clone(cache):
    return type(cache)(*(x.clone() if isinstance(x, torch.Tensor)
                         else x if x is None else x.copy() for x in cache))


@pytest.mark.parametrize('window', [None, 6])
@pytest.mark.parametrize('h,h_kv', [(2, 2), (4, 2)])
@pytest.mark.parametrize('layout', ['slab', 'paged'])
def test_verify_step_matches_jax(layout, h, h_kv, window):
    """One verify step: the real rows (``j < counts``) and every row of
    the frozen slot against the reference on both impls; caches bit for
    bit; lengths advanced by the counts."""
    rng = np.random.default_rng(10 * h + h_kv + (window or 0))
    paged = layout == 'paged'
    jc, tc, _ = _prefilled(rng, h_kv, paged)
    b = len(PRE)
    q, kn, vn = (_rand(rng, b, h, K, D), _rand(rng, b, h_kv, K, D),
                 _rand(rng, b, h_kv, K, D))
    counts, mask = np.asarray(COUNTS), np.asarray(MASK)
    jargs = (jnp.asarray(q), jc, jnp.asarray(kn), jnp.asarray(vn))
    jkw = dict(counts=jnp.asarray(counts, jnp.int32),
               slot_mask=jnp.asarray(mask), window=window)
    jx_c, jx_o = jdec.decode_step(*jargs, impl='xla', **jkw)
    jk_c, jk_o = jdec.decode_step(*jargs, impl='kernel', interpret=True,
                                  **jkw)
    for impl in ('kernel', 'plain'):
        c, out = tdec.decode_step(_t(q), _clone(tc), _t(kn), _t(vn),
                                  counts=counts, slot_mask=mask,
                                  window=window, impl=impl)
        out = out.numpy()
        for i in range(b):
            real = K if not mask[i] else counts[i]
            for ref in (jx_o, jk_o):
                np.testing.assert_allclose(
                    out[i, :, :real], np.asarray(ref)[i, :, :real],
                    err_msg=f'{impl} slot {i}', **TOL)
        np.testing.assert_array_equal(c.length, np.asarray(jx_c.length))
        want = _bufs(jx_c)
        for got, ref in zip(_bufs(c), want):
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize('layout', ['slab', 'paged'])
@pytest.mark.parametrize('h,h_kv', [(2, 2), (4, 2)])
def test_verify_step_is_the_sequential_steps(layout, h, h_kv):
    """The port's verify step against its own ``counts[i]`` sequential
    one-row steps: the real rows and the caches bit for bit (the serving
    contract that spec streams equal plain streams rests on this)."""
    rng = np.random.default_rng(3 * h + h_kv)
    _, tc, _ = _prefilled(rng, h_kv, layout == 'paged')
    b = len(PRE)
    q, kn, vn = (_rand(rng, b, h, K, D), _rand(rng, b, h_kv, K, D),
                 _rand(rng, b, h_kv, K, D))
    counts = np.asarray(COUNTS)
    cv, ov = tdec.decode_step(_t(q), _clone(tc), _t(kn), _t(vn),
                              counts=counts, impl='kernel', window=5)
    cs = _clone(tc)
    for j in range(K):
        cs, o = tdec.decode_step(
            _t(q[:, :, j:j + 1]), cs, _t(kn[:, :, j:j + 1]),
            _t(vn[:, :, j:j + 1]), slot_mask=j < counts, impl='kernel',
            window=5)
        for i in np.nonzero(j < counts)[0]:
            assert torch.equal(ov[i, :, j], o[i, :, 0]), (i, j)
    np.testing.assert_array_equal(cv.length, cs.length)
    for got, ref in zip(_bufs(cv), _bufs(cs)):
        assert torch.equal(got, ref)


@pytest.mark.parametrize('paged', [False, True])
def test_flash_decode_verify_matches_jax_and_sequential(paged):
    """The K5/K5p wrapper with ``n_new``: against the reference kernel
    (interpreted) on every real row, and bit for bit — every row,
    don't-care rows included — against k sequential one-row calls; the
    rows straddle a split (slab) or a page (paged)."""
    rng = np.random.default_rng(5)
    b, h, h_kv, k = 4, 4, 2, 5
    vt = np.array([5, 14, 20, 9], np.int32)     # slot 1 crosses column 16
    ap = np.array([5, 14, 20, -1], np.int32)
    nn = np.array([5, 4, 1, 0], np.int32)
    q, kn, vn = (_rand(rng, b, h, k, D), _rand(rng, b, h_kv, k, D),
                 _rand(rng, b, h_kv, k, D))
    if paged:
        table = np.full((b, T // PS), -1, np.int32)
        perm = rng.permutation(16)
        for i in range(b):
            table[i, :4] = perm[4 * i:4 * i + 4]
        ck, cv = _rand(rng, 17, h_kv, PS, D), _rand(rng, 17, h_kv, PS, D)
        kw_t = dict(page_table=_t(table))
        kw_j = dict(page_table=jnp.asarray(table))
    else:
        ck, cv = _rand(rng, b, h_kv, T, D), _rand(rng, b, h_kv, T, D)
        kw_t, kw_j = {}, {}
    want, wk, wv, _, _ = jax_flash_decode(
        *(jnp.asarray(x) for x in (q, kn, vn, ck, cv, vt, ap)),
        n_new=jnp.asarray(nn), interpret=True, **kw_j)
    tk, tv = _t(ck.copy()), _t(cv.copy())
    got, _, _ = fd.flash_decode(_t(q), _t(kn), _t(vn), tk, tv, _t(vt),
                                _t(ap), n_new=_t(nn), **kw_t)
    body = slice(None, -1) if paged else slice(None)    # the sink apart
    np.testing.assert_array_equal(tk.numpy()[body], np.asarray(wk)[body])
    np.testing.assert_array_equal(tv.numpy()[body], np.asarray(wv)[body])
    for i in range(b):
        real = k if ap[i] < 0 else nn[i]
        np.testing.assert_allclose(got.numpy()[i, :, :real],
                                   np.asarray(want)[i, :, :real], **TOL)
    sk, sv = _t(ck.copy()), _t(cv.copy())
    rows = []
    for j in range(k):
        apj = np.where((ap >= 0) & (j < nn), ap + j, -1).astype(np.int32)
        o, _, _ = fd.flash_decode(_t(q[:, :, j:j + 1]),
                                  _t(kn[:, :, j:j + 1]),
                                  _t(vn[:, :, j:j + 1]), sk, sv,
                                  _t(vt + j), _t(apj), **kw_t)
        rows.append(o)
    assert torch.equal(got, torch.cat(rows, dim=2))
    assert torch.equal(tk, sk) and torch.equal(tv, sv)


def test_verify_overflow_and_split_limits():
    """A verify step past ``t_max`` raises naming the slot and writes
    nothing; the verify width is capped by the K split — the page size,
    and on a slab the port's 128 columns (below the reference's split,
    which is the whole slab up to 1024 columns) — and int8 verify-k
    raises the reference's single-token error."""
    cache = tdec.init_slot_cache(2, 2, 8, D, dtype=torch.float32,
                                 device='cpu')
    cache = cache._replace(length=np.array([7, 1]))
    one = torch.ones((2, 2, 3, D))
    for impl in ('kernel', 'plain'):
        with pytest.raises(ValueError, match=r'slot 0.*3 new'):
            tdec.decode_step(one, cache, one, one, impl=impl)
    assert not cache.k.any()
    paged = tdec.init_paged_cache(2, 2, 16, D, pages=4, page_size=4,
                                  dtype=torch.float32, device='cpu')
    x = torch.ones((2, 2, 5, D))
    with pytest.raises(ValueError, match='exceeds the page size 4'):
        tdec.decode_step(x, paged, x, x, impl='kernel')
    with pytest.raises(ValueError, match='page size'):
        fd.flash_decode(x, x, x, paged.k_pool, paged.v_pool,
                        torch.zeros(2), torch.zeros(2),
                        page_table=paged.page_table)
    slab = tdec.init_cache(1, 1, 256, D, dtype=torch.float32, device='cpu')
    y = torch.ones((1, 1, 129, D))
    with pytest.raises(ValueError, match='exceeds the K split 128'):
        fd.flash_decode(y, y, y, slab.k, slab.v, [0], [0])
    with pytest.raises(ValueError, match='K split 128'):
        tdec.decode_step(y, slab, y, y, impl='kernel')
    # impl=None falls back to the plain step past the split.
    _, out = tdec.decode_step(y, slab, y, y)
    assert out.shape == (1, 1, 129, D)
    z = torch.ones((1, 1, 2, D))
    with pytest.raises(ValueError, match='single-token'):
        fd.flash_decode(z, z, z, slab.k, slab.v, [0], [0], qk_quant='int8',
                        k_q=torch.zeros(1, 1, 256, D, dtype=torch.int8),
                        k_scale=torch.zeros(1, 1, 256, 1))


@pytest.mark.parametrize('case', ['past_split', 'past_page', 'int8_verify',
                                  'no_mirror', 'sharded_verify'])
def test_auto_impl_raises_on_the_card_where_the_kernel_does_not_cover(case):
    """Where the fused kernel does not cover a call, the default impl
    takes the plain step on CPU tensors (the reference's fallback) but
    raises the reason on CUDA tensors: nothing on the card gives way to
    the plain version unasked. ``impl='plain'`` stays the caller's
    explicit choice on both."""
    slab = tdec.init_cache(1, 1, 256, D, dtype=torch.float32, device='cpu')
    paged = tdec.init_paged_cache(1, 1, 16, D, pages=4, page_size=4,
                                  dtype=torch.float32, device='cpu')
    args = {'past_split': (slab, 129, None, 1, 'K split 128'),
            'past_page': (paged, 5, None, 1, 'page size 4'),
            'int8_verify': (slab, 2, 'int8', 1, 'single-token'),
            'no_mirror': (paged, 1, 'int8', 1, 'no int8 K mirror'),
            'sharded_verify': (slab, 2, None, 2, 'sharded')}[case]
    cache, n, quant, shards, reason = args
    cpu, cuda = torch.device('cpu'), torch.device('cuda')
    for impl in (None, 'auto'):
        assert tdec._resolve_decode_impl(impl, cache, n, None, quant,
                                         shards, cpu) == 'plain'
        with pytest.raises(ValueError, match=reason):
            tdec._resolve_decode_impl(impl, cache, n, None, quant, shards,
                                      cuda)
    for dev in (cpu, cuda):
        assert tdec._resolve_decode_impl('plain', cache, n, None, quant,
                                         shards, dev) == 'plain'
        with pytest.raises(ValueError, match=reason):
            tdec._resolve_decode_impl('kernel', cache, n, None, quant,
                                      shards, dev)
    assert tdec._resolve_decode_impl(None, cache, 1, None, None, 1,
                                     cuda) == 'kernel'


# -- acceptance-prefix rollback -------------------------------------------

def test_rollback_bit_identical_to_accepted_only_and_jax():
    """Append K proposals per slot, roll back to the accepted prefix: the
    cache equals having appended only the accepted rows, bit for bit, and
    equals the reference's rollback (span and full-mask forms); a
    sentinel leaves a slot untouched."""
    rng = np.random.default_rng(7)
    jc, tc, _ = _prefilled(rng, 2, False)
    b = len(PRE)
    kn, vn = _rand(rng, b, 2, K, D), _rand(rng, b, 2, K, D)
    accepted = np.array([1, 0, 3, 2, 4])
    big = np.iinfo(np.int32).max
    target = np.asarray(PRE) + accepted
    target[4] = big                                  # untouched
    full = tdec.append_kv_slots(_clone(tc), _t(kn), _t(vn))
    jfull = jdec.append_kv_slots(jc, jnp.asarray(kn), jnp.asarray(vn))
    only = np.where(target == big, K, accepted)
    ref = tdec.append_kv_slots(_clone(tc), _t(kn), _t(vn), counts=only)
    for span in (None, K):
        got = tdec.rollback_slots(_clone(full), target, span=span)
        jgot = jdec.rollback_slots(jfull, jnp.asarray(
            np.minimum(target, big), jnp.int32), span=span)
        np.testing.assert_array_equal(got.length, ref.length)
        np.testing.assert_array_equal(got.length, np.asarray(jgot.length))
        for a, r, j in zip(_bufs(got), _bufs(ref), _bufs(jgot)):
            assert torch.equal(a, r)
            np.testing.assert_array_equal(a.numpy(), np.asarray(j))
    # Scalar-clock cache: the full-mask form; span is refused.
    sc = tdec.init_cache(1, 2, T, D, dtype=torch.float32, device='cpu')
    sc = tdec.append_kv(sc, _t(kn[:1]), _t(vn[:1]))
    got = tdec.rollback_slots(sc, 1)
    assert got.length == 1 and not got.k[:, :, 1:].any()
    with pytest.raises(ValueError, match='span'):
        tdec.rollback_slots(sc, 0, span=2)
    with pytest.raises(ValueError, match='paged_rollback_slots'):
        tdec.rollback_slots(tdec.init_paged_cache(
            1, 2, T, D, pages=4, page_size=PS, device='cpu'), [0])


def test_paged_rollback_matches_jax_and_returns_pages():
    """Paged rollback after a verify step: the pools equal having
    appended only the accepted rows and equal the reference's
    ``paged_rollback_slots``; ``PagePool.truncate`` releases exactly the
    now-empty tail pages, as the reference's does."""
    rng = np.random.default_rng(8)
    jc, tc, pool = _prefilled(rng, 2, True)
    b = len(PRE)
    kn, vn = _rand(rng, b, 2, K, D), _rand(rng, b, 2, K, D)
    full = tdec.paged_append_kv_slots(_clone(tc), _t(kn), _t(vn))
    jfull = jdec.paged_append_kv_slots(jc, jnp.asarray(kn), jnp.asarray(vn))
    accepted = np.array([0, 2, 4, 1, 3])
    target = np.asarray(PRE) + accepted
    got = tdec.paged_rollback_slots(_clone(full), target, K)
    jgot = jdec.paged_rollback_slots(jfull, jnp.asarray(target, jnp.int32),
                                     K)
    ref = tdec.paged_append_kv_slots(_clone(tc), _t(kn), _t(vn),
                                     counts=accepted)
    np.testing.assert_array_equal(got.length, ref.length)
    for a, r, j in zip(_bufs(got), _bufs(ref), _bufs(jgot)):
        assert torch.equal(a, r)
        np.testing.assert_array_equal(a.numpy(), np.asarray(j))
    # Host side: the same walk on both allocators frees the same pages.
    jpool = jdec.PagePool(24, PS, b, T // PS)
    for s in range(b):
        assert jpool.reserve_rows(s, PRE[s] + K)[0]
    for p in (pool, jpool):
        p.lengths[:] = np.asarray(PRE) + K
    for s in range(b):
        used = pool.slot_pages(s)
        freed = pool.truncate(s, int(target[s]))
        assert freed == jpool.truncate(s, int(target[s]))
        assert len(freed) == used - pool.pages_for_rows(int(target[s]))
    np.testing.assert_array_equal(pool.table, jpool.table)
    np.testing.assert_array_equal(pool.refcount, jpool.refcount)
    assert pool.free_pages == jpool.free_pages
    assert pool.truncate(0, T) == []            # at or past the fill


@pytest.mark.parametrize('start,cut', [(8, 8), (8, 5), (11, 8), (3, 0)])
def test_truncate_matches_jax_on_boundaries(start, cut):
    """``PagePool.truncate`` across and on page boundaries (a reservation
    opening a new page, then a rollback to the boundary, mid-page or to
    zero) frees exactly the reference's pages and leaves the same
    table."""
    pools = (tdec.PagePool(6, 4, 1, T // 4), jdec.PagePool(6, 4, 1, T // 4))
    outs = []
    for p in pools:
        assert p.reserve_rows(0, start)[0]
        p.lengths[0] = start
        assert p.reserve_rows(0, 3)[0]               # the verify rows
        p.lengths[0] = start + 3
        outs.append((p.truncate(0, cut), p.table.copy(), p.free_pages,
                     int(p.counts[0]), int(p.lengths[0])))
    (fa, ta, fra, ca, la), (fb, tb, frb, cb, lb) = outs
    assert fa == fb and (fra, ca, la) == (frb, cb, lb)
    np.testing.assert_array_equal(ta, tb)
