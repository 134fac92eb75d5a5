# -*- coding: utf-8 -*-
"""
The int8 K mirror of the port's decode caches (``qk_quant='int8'``)
against the reference package, on the same seeded float32 inputs:

- mirror allocation and every mirror-keeping write (``append_kv``,
  ``append_kv_slots``, ``paged_append_kv_slots``, ``paged_append_rows``)
  bit for bit against the reference's, slab and paged; the paged mirror
  gathered through the table equals the slab mirror;
- the int8 ``decode_step``: the plain path (with the mirror and
  quantizing on the fly) against the reference's XLA int8 step, the
  kernel path (K5 / K5p's plain version) against the reference kernel
  (interpreted) and XLA, slab and paged, GQA, with a window;
- a non-int8 step on a mirror-carrying cache keeps the mirror exact;
  rollback and reset zero the mirror rows; the page checksum covers the
  mirror and equals the reference's digest;
- the module: an int8 GQA module's ``make_decode_cache``, ``prefill``
  and ``decode`` steps (both ``decode_impl``s) against the reference
  module's, and its sequence-sharded ``decode_seq_parallel`` on a gloo
  group of 2 against the reference module's local decode.

Outputs at atol = rtol = 1e-5; mirrors bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_dist import GlooGroup

from distributed_dot_product_tpu import DistributedDotProductAttn as JaxAttn
from distributed_dot_product_tpu.models import decode as jdec
from distributed_dot_product_tpu_torch import (
    DistributedDotProductAttn, attn_state_from_jax,
)
from distributed_dot_product_tpu_torch.models import decode as tdec

TOL = dict(atol=1e-5, rtol=1e-5)
D, T, PS = 8, 32, 8
PRE = [5, 9, 0, 12]


def _rand(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _mirror(cache):
    if hasattr(cache, 'k_q_pool'):
        return cache.k_q_pool, cache.k_scale_pool
    return cache.k_q, cache.k_scale


def _same_mirror(tc, jc, body=slice(None)):
    for got, want in zip(_mirror(tc), _mirror(jc)):
        np.testing.assert_array_equal(got.numpy()[body],
                                      np.asarray(want)[body])


def _caches(rng, h_kv, paged, qk_quant='int8'):
    """Reference and port per-slot caches (with the mirror) holding
    ``PRE`` rows per slot; paged: pages for the prefix plus 4 rows."""
    b, rows = len(PRE), max(PRE)
    kn, vn = _rand(rng, b, h_kv, rows, D), _rand(rng, b, h_kv, rows, D)
    counts = np.asarray(PRE)
    if paged:
        pool = tdec.PagePool(24, PS, b, T // PS)
        for s in range(b):
            assert pool.reserve_rows(s, PRE[s] + 4)[0]
        jc = jdec.init_paged_cache(b, h_kv, T, D, pages=24, page_size=PS,
                                   dtype=jnp.float32, qk_quant=qk_quant)
        jc = jc._replace(page_table=jnp.asarray(pool.table))
        tc = tdec.init_paged_cache(b, h_kv, T, D, pages=24, page_size=PS,
                                   dtype=torch.float32, qk_quant=qk_quant,
                                   device='cpu')
        tc.page_table.copy_(torch.from_numpy(pool.table))
    else:
        jc = jdec.init_cache(b, h_kv, T, D, dtype=jnp.float32,
                             qk_quant=qk_quant)
        jc = jc._replace(length=jnp.zeros((b,), jnp.int32))
        tc = tdec.init_cache(b, h_kv, T, D, dtype=torch.float32,
                             qk_quant=qk_quant, device='cpu')
        tc = tc._replace(length=np.zeros(b, np.int64))
    jc = jdec.append_kv_slots(jc, jnp.asarray(kn), jnp.asarray(vn),
                              counts=jnp.asarray(counts, jnp.int32))
    tc = tdec.append_kv_slots(tc, _t(kn), _t(vn), counts=counts)
    return jc, tc


@pytest.mark.parametrize('paged', [False, True])
def test_mirror_allocation_and_appends_match_jax(paged):
    """The zero mirror's shapes and dtypes, then appends, bit for bit."""
    rng = np.random.default_rng(1)
    jc, tc = _caches(rng, 2, paged)
    _same_mirror(tc, jc)
    if paged:
        # The registry fill keeps the mirror too.
        k, v = _rand(rng, 2, 6, D), _rand(rng, 2, 6, D)
        row = np.full(T // PS, -1, np.int32)
        row[:2] = [20, 21]
        jc = jdec.paged_append_rows(jc, jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(row), 2, 5)
        tc = tdec.paged_append_rows(tc, _t(k), _t(v), row, 2, 5)
        _same_mirror(tc, jc)
    else:
        # The scalar-clock append.
        jc1 = jdec.init_cache(1, 2, T, D, dtype=jnp.float32,
                              qk_quant='int8')
        tc1 = tdec.init_cache(1, 2, T, D, dtype=torch.float32,
                              qk_quant='int8', device='cpu')
        for n in (3, 1, 4):
            k, v = _rand(rng, 1, 2, n, D), _rand(rng, 1, 2, n, D)
            jc1 = jdec.append_kv(jc1, jnp.asarray(k), jnp.asarray(v))
            tc1 = tdec.append_kv(tc1, _t(k), _t(v))
        _same_mirror(tc1, jc1)
    assert tdec.init_cache(1, 1, 4, D, device='cpu').k_q is None
    with pytest.raises(ValueError, match='qk_quant'):
        tdec.init_cache(1, 1, 4, D, qk_quant='int4', device='cpu')


def test_paged_mirror_equals_slab_mirror():
    rng = np.random.default_rng(2)
    _, slab = _caches(rng, 2, False)
    _, paged = _caches(np.random.default_rng(2), 2, True)
    kq, ks = tdec.paged_gather_mirror(paged)
    assert torch.equal(kq, slab.k_q) and torch.equal(ks, slab.k_scale)
    with pytest.raises(ValueError, match='no int8 K mirror'):
        tdec.paged_gather_mirror(tdec.init_paged_cache(
            1, 1, 8, D, pages=2, page_size=4, device='cpu'))


@pytest.mark.parametrize('window', [None, 4])
@pytest.mark.parametrize('h,h_kv', [(2, 2), (4, 2)])
@pytest.mark.parametrize('paged', [False, True])
def test_int8_decode_step_matches_jax(paged, h, h_kv, window):
    """Three int8 steps, a frozen slot among them: the port's kernel path
    (K5/K5p's plain version) and plain path against the reference's
    XLA int8 step and its kernel; the mirror bit for bit."""
    rng = np.random.default_rng(3 + h + h_kv + (window or 0))
    jc, tc = _caches(rng, h_kv, paged)
    tcs = {'kernel': tc, 'plain': type(tc)(*(
        x.clone() if isinstance(x, torch.Tensor) else x if x is None
        else x.copy() for x in tc))}
    jcs = {'xla': jc, 'kernel': jc}
    b = len(PRE)
    mask = np.array([True, True, True, False])
    for _ in range(3):
        q, kn, vn = (_rand(rng, b, h, 1, D), _rand(rng, b, h_kv, 1, D),
                     _rand(rng, b, h_kv, 1, D))
        want = {}
        for impl in jcs:
            kw = dict(interpret=True) if impl == 'kernel' else {}
            jcs[impl], out = jdec.decode_step(
                jnp.asarray(q), jcs[impl], jnp.asarray(kn), jnp.asarray(vn),
                slot_mask=jnp.asarray(mask), qk_quant='int8', window=window,
                impl=impl, **kw)
            want[impl] = np.asarray(out)
        for impl in tcs:
            tcs[impl], got = tdec.decode_step(
                _t(q), tcs[impl], _t(kn), _t(vn), slot_mask=mask,
                qk_quant='int8', window=window, impl=impl)
            for ref in want.values():
                np.testing.assert_allclose(got.numpy(), ref,
                                           err_msg=impl, **TOL)
            body = slice(None, -1) if paged else slice(None)
            _same_mirror(tcs[impl], jcs['xla'], body)


@pytest.mark.parametrize('paged', [False, True])
def test_int8_on_the_fly_and_verify_k_take_the_plain_path(paged):
    """Without the mirror, int8 decoding quantizes the cached keys on the
    fly on the plain path (impl=None falls back; impl='kernel' raises the
    reference's reason); int8 verify-k (n > 1) is plain-only too. Both
    against the reference's XLA int8 step."""
    rng = np.random.default_rng(4)
    jc, tc = _caches(rng, 2, paged, qk_quant=None)
    b = len(PRE)
    q, kn, vn = (_rand(rng, b, 4, 2, D), _rand(rng, b, 2, 2, D),
                 _rand(rng, b, 2, 2, D))
    with pytest.raises(ValueError, match='no int8 K mirror'):
        tdec.decode_step(_t(q[:, :, :1]), tc, _t(kn[:, :, :1]),
                         _t(vn[:, :, :1]), qk_quant='int8', impl='kernel')
    for n in (1, 2):
        jc2, want = jdec.decode_step(
            jnp.asarray(q[:, :, :n]), jc, jnp.asarray(kn[:, :, :n]),
            jnp.asarray(vn[:, :, :n]), qk_quant='int8', impl='xla')
        tc2, got = tdec.decode_step(
            _t(q[:, :, :n]), type(tc)(*(
                x.clone() if isinstance(x, torch.Tensor) else x if x is None
                else x.copy() for x in tc)),
            _t(kn[:, :, :n]), _t(vn[:, :, :n]), qk_quant='int8')
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_array_equal(tc2.length, np.asarray(jc2.length))


@pytest.mark.parametrize('paged', [False, True])
def test_non_int8_step_keeps_the_mirror(paged):
    """A float step (kernel path: the kernel leaves the mirror to the
    host fix-up) on a mirror-carrying cache: the mirror equals the
    reference's after the same step, and the cache's own rows
    re-quantized."""
    rng = np.random.default_rng(5)
    jc, tc = _caches(rng, 2, paged)
    b = len(PRE)
    q, kn, vn = (_rand(rng, b, 4, 1, D), _rand(rng, b, 2, 1, D),
                 _rand(rng, b, 2, 1, D))
    jc, _ = jdec.decode_step(jnp.asarray(q), jc, jnp.asarray(kn),
                             jnp.asarray(vn), impl='xla')
    tc, _ = tdec.decode_step(_t(q), tc, _t(kn), _t(vn), impl='kernel')
    body = slice(None, -1) if paged else slice(None)
    _same_mirror(tc, jc, body)
    if not paged:
        ki, sk = tdec.quantize_rows(tc.k)
        for i, n in enumerate(tc.length):
            assert torch.equal(tc.k_q[i, :, :n], ki[i, :, :n])
            assert torch.equal(tc.k_scale[i, :, :n], sk[i, :, :n])


def test_rollback_and_reset_zero_the_mirror():
    """Rolling back an int8 verify step, and evicting a slot, zero the
    mirror rows with the bf16 rows: equal to the reference's."""
    rng = np.random.default_rng(6)
    jc, tc = _caches(rng, 2, False)
    b = len(PRE)
    kn, vn = _rand(rng, b, 2, 3, D), _rand(rng, b, 2, 3, D)
    jc = jdec.append_kv_slots(jc, jnp.asarray(kn), jnp.asarray(vn))
    tc = tdec.append_kv_slots(tc, _t(kn), _t(vn))
    target = np.asarray(PRE) + np.array([1, 0, 3, 2])
    jc = jdec.rollback_slots(jc, jnp.asarray(target, jnp.int32), span=3)
    tc = tdec.rollback_slots(tc, target, span=3)
    _same_mirror(tc, jc)
    jc = jdec.reset_slot(jc, 1)
    tc = tdec.reset_slot(tc, 1)
    _same_mirror(tc, jc)
    assert not tc.k_q[1].any() and not tc.k_scale[1].any()
    # Paged: the rolled-back rows and the freed pages.
    jp, tp = _caches(np.random.default_rng(6), 2, True)
    jp = jdec.paged_append_kv_slots(jp, jnp.asarray(kn), jnp.asarray(vn))
    tp = tdec.paged_append_kv_slots(tp, _t(kn), _t(vn))
    jp = jdec.paged_rollback_slots(jp, jnp.asarray(target, jnp.int32), 3)
    tp = tdec.paged_rollback_slots(tp, target, 3)
    _same_mirror(tp, jp)
    freed = np.array([int(tp.page_table[3, 0]), -1, -1, -1], np.int32)
    jp = jdec.paged_reset_slot(jp, jnp.int32(3), jnp.asarray(freed))
    tp = tdec.paged_reset_slot(tp, 3, freed)
    _same_mirror(tp, jp)
    assert not tp.k_q_pool[freed[0]].any()


def test_checksum_covers_the_mirror():
    """``PageChecksums.digest`` is the reference's ``(kv_crc,
    mirror_crc)`` pair on the same pools, and a flipped mirror byte
    shows."""
    rng = np.random.default_rng(7)
    jc, tc = _caches(rng, 2, True)
    pages = [int(p) for p in tc.page_table[tc.page_table >= 0].tolist()]
    for page in pages[:4]:
        assert tdec.PageChecksums.digest(tc, page) == \
            jdec.PageChecksums.digest(jc, page)
    sums = tdec.PageChecksums()
    sums.record(tc, pages)
    assert sums.verify(tc) == []
    tc.k_q_pool[pages[1], 0, 0, 0] ^= 1
    assert sums.verify(tc) == [pages[1]]
    assert tdec.PageChecksums.digest(tc, pages[0])[1] != 0
    _, plain = _caches(rng, 2, True, qk_quant=None)
    assert tdec.PageChecksums.digest(plain, pages[0])[1] == 0


# -- the int8 module -------------------------------------------------------

MODULE = dict(key_dim=32, num_heads=4, num_kv_heads=2, causal=True,
              use_rope=True, qk_quant='int8', distributed=False,
              softmax_impl='flash')


def _jax_module(seed=0, t=9):
    x = np.random.default_rng(seed).standard_normal(
        (2, t, MODULE['key_dim'])).astype(np.float32)
    jm = JaxAttn(**MODULE)
    jx = jnp.asarray(x[:, :1])
    params = jm.init(jax.random.key(seed), jx, jx, jx)
    state = attn_state_from_jax(jax.tree.map(np.asarray, params))
    return jm, params, state, x


def test_int8_module_decode_matches_jax():
    """The int8 GQA + RoPE module: cache, prefill and decode steps on
    both ``decode_impl``s against the reference module."""
    jm, params, state, x = _jax_module()
    jc = jm.make_decode_cache(2, T)
    jx = jnp.asarray(x[:, :4])
    jc, want_p = jm.apply(params, jx, jx, jx, jc, method='prefill')
    want = []
    for t in range(4, x.shape[1]):
        jx = jnp.asarray(x[:, t:t + 1])
        jc, out = jm.apply(params, jx, jx, jx, jc, method='decode')
        want.append(np.asarray(out))
    for impl in ('kernel', 'plain'):
        port = DistributedDotProductAttn(device='cpu', decode_impl=impl,
                                         **MODULE)
        port.load_state_dict(state)
        tc = port.make_decode_cache(2, T)
        assert tc.k_q.shape == tuple(jc.k_q.shape)
        tx = _t(x[:, :4])
        with torch.no_grad():
            tc, got = port.prefill(tx, tx, tx, tc)
            np.testing.assert_allclose(got.numpy(), np.asarray(want_p),
                                       **TOL)
            for t, ref in zip(range(4, x.shape[1]), want):
                tx = _t(x[:, t:t + 1])
                tc, got = port.decode(tx, tx, tx, tc)
                np.testing.assert_allclose(got.numpy(), ref,
                                           err_msg=f'{impl} t={t}', **TOL)
        assert tc.length == int(jc.length)


@pytest.fixture(scope='module')
def gloo2(tmp_path_factory):
    group = GlooGroup(2, str(tmp_path_factory.mktemp('gloo2') / 'store'))
    yield group
    group.close()


@pytest.mark.parametrize('impl', ['kernel', 'plain'])
def test_int8_module_decode_sharded_matches_jax_local(gloo2, impl):
    """The int8 module's sequence-sharded decode on 2 ranks (the mirror
    sharded with the slab; the kernel path's partials scored on it)
    against the reference module's local int8 decode."""
    jm, params, state, x = _jax_module(seed=1)
    jc = jm.make_decode_cache(2, T)
    jx = jnp.asarray(x[:, :5])
    jc, _ = jm.apply(params, jx, jx, jx, jc, method='prefill')
    want = []
    for t in range(5, x.shape[1]):
        jx = jnp.asarray(x[:, t:t + 1])
        jc, out = jm.apply(params, jx, jx, jx, jc, method='decode')
        want.append(np.asarray(out))
    kw = {k: v for k, v in MODULE.items() if k != 'distributed'}
    res = gloo2.run('decode_sharded_module', dict(kw, decode_impl=impl),
                    {k: v.numpy() for k, v in state.items()}, x[:, :5],
                    x[:, 5:], T, False)
    for outs, length, _, _ in res:
        assert length == x.shape[1]
        for t, (got, ref) in enumerate(zip(outs, want)):
            np.testing.assert_allclose(got, ref, err_msg=f't={t}', **TOL)
