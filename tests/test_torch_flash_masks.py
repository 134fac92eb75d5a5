# -*- coding: utf-8 -*-
"""
The port's flash-attention masks and terms — ``segment_ids``, ``window``,
the coordinate-hash dropout and ``qk_quant='int8'``, alone and all
together under GQA — against the reference package's ``_flash_fwd_impl``
/ ``_flash_bwd_impl`` / ``flash_attention`` (Pallas in interpret mode) on
the same float32 inputs, made by numpy from a seed. On the CPU the
port's wrappers run their plain versions, the arithmetic the CUDA
kernels implement and are held against on the card.

Tolerance: max |got − want| ≤ 1e-5 · max |want| per tensor (float32
rounding of blockwise vs full-row reductions). Exact: the dropout keep
pattern (with ``v = eye``, the output is the dropped weight matrix, 0
exactly where dropped), the int8 operands, a wholly cross-segment fold
(out 0, lse ``ln2·_NEG_BIG``, zero gradients) and the bounded mode's
resolution to the exact kernel under dropout or int8.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_dot_product_tpu.ops.pallas_attention import (
    _flash_bwd_impl, _flash_fwd_impl, _quantize_rows,
    flash_attention as jax_flash_attention,
)
from distributed_dot_product_tpu_torch.ops.flash_attention import (
    _NEG_BIG, dropout_keep, flash_attention, flash_attention_backward,
    flash_attention_dkv, flash_attention_dq, flash_attention_with_lse,
    quant_operands, quantize_rows,
)

REL = 1e-5
LN2 = math.log(2.0)


def _close(got, want, rel=REL, what=''):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (what, err)


def _inputs(seed, b, hq, hkv, tq, tk, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, tq, d), dtype=np.float32),
            rng.standard_normal((b, hkv, tk, d), dtype=np.float32),
            rng.standard_normal((b, hkv, tk, d), dtype=np.float32),
            rng.standard_normal((b, hq, tq, d), dtype=np.float32))


def _segments(seed, b, t):
    """Packed-document ids ``(b, 1, t)``: sorted, a few documents a row."""
    rng = np.random.default_rng(seed)
    return np.sort(rng.integers(0, 3, (b, 1, t)), axis=-1).astype(np.int32)


# (b, hq, hkv, tq, tk, d, causal, causal_offset, kv_offset, features);
# features name segments as 'pair' (q and kv ids) or 'single' (one array).
CASES = {
    'segments': (2, 2, 2, 32, 48, 16, False, 0, 0, dict(seg='pair')),
    'segments_single': (2, 4, 2, 32, 32, 16, False, 0, 0,
                        dict(seg='single')),
    'window': (1, 2, 2, 32, 48, 16, True, 40, 10, dict(window=7)),
    'dropout': (2, 2, 2, 32, 32, 16, True, 0, 0,
                dict(dropout_rate=0.2, dropout_seed=-99)),
    'int8': (2, 2, 2, 32, 40, 32, False, 0, 0, dict(qk_quant='int8')),
    'all_gqa': (2, 4, 2, 32, 48, 16, True, 40, 10,
                dict(seg='pair', window=20, dropout_rate=0.1, dropout_seed=7,
                     qk_quant='int8')),
}


def _case(name, seed):
    b, hq, hkv, tq, tk, d, causal, co, ko, feat = CASES[name]
    q, k, v, g = _inputs(seed, b, hq, hkv, tq, tk, d)
    feat = dict(feat)
    kind = feat.pop('seg', None)
    if kind == 'pair':
        feat['segment_ids'] = (_segments(seed, b, tq), _segments(seed + 1, b,
                                                                 tk))
    elif kind == 'single':
        feat['segment_ids'] = _segments(seed, b, tq)
    return q, k, v, g, dict(causal=causal, causal_offset=co, kv_offset=ko), \
        feat


def _jax_feat(feat):
    seg = feat.get('segment_ids')
    if seg is None:
        return dict(feat)
    seg = (tuple(jnp.asarray(s) for s in seg) if isinstance(seg, tuple)
           else jnp.asarray(seg))
    return {**feat, 'segment_ids': seg}


def _torch_feat(feat):
    seg = feat.get('segment_ids')
    if seg is None:
        return dict(feat)
    seg = (tuple(torch.from_numpy(s) for s in seg) if isinstance(seg, tuple)
           else torch.from_numpy(seg))
    return {**feat, 'segment_ids': seg}


def _jax_pair(feat, tq, tk):
    """The reference's private impls take segments as a pair only."""
    jf = _jax_feat(feat)
    seg = jf.get('segment_ids')
    if seg is not None and not isinstance(seg, tuple):
        jf['segment_ids'] = (seg, seg)
    return jf


def _t(*arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


@pytest.mark.parametrize('name', sorted(CASES))
def test_forward_and_lse_match_jax(name):
    q, k, v, _, kw, feat = _case(name, len(name))
    scale = 1.0 / math.sqrt(q.shape[-1])
    want_out, want_lse = _flash_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
        kw['causal_offset'], scale, kw['causal'], True, save_lse=True,
        kv_offset=kw['kv_offset'], **_jax_pair(feat, q.shape[-2],
                                               k.shape[-2]))
    out, lse = flash_attention_with_lse(*_t(q, k, v), scale=scale, **kw,
                                        **_torch_feat(feat))
    _close(out, want_out, what='out')
    _close(lse, want_lse, what='lse')


@pytest.mark.parametrize('name', sorted(CASES))
def test_float32_grads_match_jax(name):
    q, k, v, g, kw, feat = _case(name, 50 + len(name))
    scale = 1.0 / math.sqrt(q.shape[-1])
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    jf = _jax_pair(feat, q.shape[-2], k.shape[-2])
    out, lse = _flash_fwd_impl(jq, jk, jv, None, kw['causal_offset'], scale,
                               kw['causal'], True, save_lse=True,
                               kv_offset=kw['kv_offset'], **jf)
    want = _flash_bwd_impl(jq, jk, jv, None, kw['causal_offset'], out, lse,
                           jg, scale, kw['causal'], True,
                           grad_dtype=jnp.float32,
                           kv_offset=kw['kv_offset'], **jf)
    tq_, tk_, tv_, tg = _t(q, k, v, g)
    got = flash_attention_backward(
        tq_, tk_, tv_, torch.from_numpy(np.array(out)),
        torch.from_numpy(np.array(lse)), tg, kw['causal'],
        kw['causal_offset'], scale, kv_offset=kw['kv_offset'],
        grad_dtype=torch.float32, **_torch_feat(feat))
    for n, a, w in zip(('dq', 'dk', 'dv'), got, want):
        assert a.dtype == torch.float32, n
        _close(a, w, what=n)


@pytest.mark.parametrize('name', sorted(CASES))
def test_autograd_matches_jax_vjp(name):
    q, k, v, g, kw, feat = _case(name, 80 + len(name))
    jf = _jax_feat(feat)
    want_out, vjp = jax.vjp(
        lambda a, b, c: jax_flash_attention(a, b, c, **kw, **jf),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    tq_, tk_, tv_ = _t(q, k, v, grad=True)
    out = flash_attention(tq_, tk_, tv_, **kw, **_torch_feat(feat))
    got = torch.autograd.grad(out, (tq_, tk_, tv_), torch.from_numpy(g))
    _close(out, want_out, what='out')
    for n, a, w in zip(('dq', 'dk', 'dv'), got, want):
        _close(a, w, what=n)


@pytest.mark.parametrize('offsets', [(0, 0), (2 ** 20 + 7, 2 ** 20 - 100)],
                         ids=['origin', 'near_2^20'])
def test_dropout_keep_pattern_is_the_references_bit_for_bit(offsets):
    """With ``v = eye(Tk)`` the output is the dropped weight matrix: 0
    exactly where an element was dropped. Near 2^20 the coordinates wrap
    in the hash's multiplies."""
    co, ko = offsets
    rng = np.random.default_rng(5)
    b, h, t = 2, 3, 64
    q = rng.standard_normal((b, h, t, 16), dtype=np.float32)
    k = rng.standard_normal((b, h, t, 16), dtype=np.float32)
    eye = np.broadcast_to(np.eye(t, dtype=np.float32), (b, h, t, t)).copy()
    kw = dict(causal_offset=co, kv_offset=ko, dropout_rate=0.3,
              dropout_seed=-123456)
    want = np.asarray(jax_flash_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(eye), **kw))
    got = flash_attention(*_t(q, k, eye), **kw).numpy()
    keep, inv = dropout_keep((b, h), t, t, co, ko, 0.3, -123456)
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_array_equal(got != 0, keep.numpy())
    assert inv == 1.0 / 0.7 and 0.6 < keep.float().mean() < 0.8
    _close(got, want, what='dropped weights')


def test_int8_operands_equal_the_references():
    q, k, _, _ = _inputs(3, 2, 4, 2, 24, 40, 32)
    q[0, 1, 3] = 0.0                       # an all-zero row stays finite
    for x, nb in ((q, 8), (k, 4)):
        want_i8, want_s = _quantize_rows(jnp.asarray(x), nb, x.shape[-2],
                                         x.shape[-1])
        got_i8, got_s = quantize_rows(torch.from_numpy(x))
        assert got_i8.dtype == torch.int8 and got_s.dtype == torch.float32
        np.testing.assert_array_equal(got_i8.reshape(want_i8.shape).numpy(),
                                      np.asarray(want_i8))
        np.testing.assert_array_equal(got_s.reshape(want_s.shape).numpy(),
                                      np.asarray(want_s))
    q8, sq, k8, sk = quant_operands(torch.from_numpy(q), torch.from_numpy(k))
    assert q8.shape == q.shape and sk.shape == (*k.shape[:-1], 1)


@pytest.mark.parametrize('knob', [dict(dropout_rate=0.2, dropout_seed=3),
                                  dict(qk_quant='int8')],
                         ids=['dropout', 'int8'])
def test_bounded_mode_takes_the_exact_kernel(knob):
    """'bounded' with dropout or int8 resolves to the exact kernel (K1),
    as the reference's does: the same numbers bit for bit, and the
    reference's own bounded call."""
    q, k, v, g = _inputs(9, 2, 2, 2, 32, 32, 16)
    kw = dict(causal=True, **knob)
    exact, lse_e = flash_attention_with_lse(*_t(q, k, v), **kw)
    bounded, lse_b = flash_attention_with_lse(*_t(q, k, v),
                                              softmax_mode='bounded', **kw)
    assert torch.equal(exact, bounded) and torch.equal(lse_e, lse_b)
    want = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        softmax_mode='bounded', **kw))
    _close(bounded, want, what='bounded')
    for fn in (flash_attention, flash_attention_dq, flash_attention_dkv):
        fn.launches = 0
    tq_, tk_, tv_ = _t(q, k, v, grad=True)
    out = flash_attention(tq_, tk_, tv_, softmax_mode='bounded', **kw)
    out.backward(torch.from_numpy(g))
    assert (flash_attention.launches, flash_attention_dq.launches,
            flash_attention_dkv.launches) == (0, 0, 0)


def test_a_wholly_cross_segment_fold_is_exactly_empty():
    """Rank 1's causal fold of owner 0 under two packed documents: no row
    has an attendable key — out 0, lse ln2·_NEG_BIG and zero gradients,
    exactly, with dropout and int8 on (the ring merge needs weight 0)."""
    q, k, v, g = _inputs(4, 1, 4, 2, 32, 32, 16)
    seg = (np.ones((1, 1, 32), np.int32), np.zeros((1, 1, 32), np.int32))
    kw = dict(causal=True, causal_offset=32, kv_offset=0,
              segment_ids=tuple(torch.from_numpy(s) for s in seg),
              dropout_rate=0.1, dropout_seed=2, qk_quant='int8')
    out, lse = flash_attention_with_lse(*_t(q, k, v), **kw)
    assert not out.any()
    assert torch.all(lse == torch.tensor(LN2 * _NEG_BIG, dtype=torch.float32))
    grads = flash_attention_backward(*_t(q, k, v), out, lse,
                                     torch.from_numpy(g), kw.pop('causal'),
                                     kw.pop('causal_offset'),
                                     grad_dtype=torch.float32, **kw)
    assert not any(t.any() for t in grads)


@pytest.mark.parametrize('kw,exc', [
    (dict(window=4), ValueError),                       # needs causal
    (dict(window=0, causal=True), ValueError),
    (dict(window=2.5, causal=True), ValueError),
    (dict(qk_quant='int4'), ValueError),
    (dict(dropout_rate=0.1), ValueError),               # needs a seed
    (dict(dropout_rate=1.0, dropout_seed=1), ValueError),
    (dict(segment_ids=np.zeros((1, 2, 2, 8), np.int32)), ValueError),
    (dict(alibi_slopes=[0.5, 0.25], causal=True), NotImplementedError),
    (dict(positions=np.arange(8)), NotImplementedError),
], ids=['window_no_causal', 'window_zero', 'window_float', 'qk_quant',
        'dropout_no_seed', 'dropout_rate_one', 'segments_extra_dim', 'alibi',
        'positions'])
def test_validation_follows_the_reference(kw, exc):
    x = torch.zeros((1, 2, 8, 16))
    kw = {**kw}
    if 'segment_ids' in kw:
        kw['segment_ids'] = torch.from_numpy(kw['segment_ids'])
        with pytest.raises(ValueError):     # the reference refuses it too
            jax_flash_attention(*(jnp.zeros((1, 2, 8, 16)),) * 3,
                                segment_ids=jnp.zeros((1, 2, 2, 8),
                                                      jnp.int32))
    with pytest.raises(exc):
        flash_attention(x, x, x, **kw)


def test_single_segment_array_needs_equal_lengths():
    q, k = torch.zeros((1, 2, 8, 16)), torch.zeros((1, 2, 6, 16))
    with pytest.raises(ValueError, match='Tq == Tk'):
        flash_attention(q, k, k, segment_ids=torch.zeros((1, 8),
                                                         dtype=torch.int32))


def test_bounded_mode_takes_segments_and_window():
    """K2 takes segments and a window (its Ext instantiation): the
    reference's bounded kernel on the same call, the guard picking it."""
    q, k, v, _ = _inputs(12, 2, 4, 2, 32, 48, 16)
    q, k = 0.3 * q, 0.3 * k
    seg = (_segments(12, 2, 32), _segments(13, 2, 48))
    kw = dict(causal=True, causal_offset=40, kv_offset=10, window=20)
    scale = 1.0 / math.sqrt(16)
    want_out, want_lse = _flash_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, 40, scale,
        True, True, mode='bounded', save_lse=True, kv_offset=10, window=20,
        segment_ids=tuple(jnp.asarray(s) for s in seg))
    out, lse = flash_attention_with_lse(
        *_t(q, k, v), scale=scale, softmax_mode='bounded',
        segment_ids=tuple(torch.from_numpy(s) for s in seg), **kw)
    _close(out, want_out, what='out')
    _close(lse, want_lse, what='lse')
