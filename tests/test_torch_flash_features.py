# -*- coding: utf-8 -*-
"""
The port's flash-attention features that the sequence-parallel paths
need — a dense ``mask``, ``kv_offset``, float32 ``grad_dtype`` and
``softmax_mode='bounded'`` (K2) — against the reference package's
``_flash_fwd_impl`` / ``_flash_bwd_impl`` / ``flash_attention`` (Pallas
in interpret mode) on the same float32 inputs, made by numpy from a
seed. On the CPU the port's wrappers run their plain versions, the
arithmetic the CUDA kernels implement and are held against on the card.

Tolerance: max |got − want| ≤ 1e-5 · max |want| per tensor (float32
rounding of blockwise vs full-row reductions). Fully masked rows are
checked exactly: out 0, lse ``ln2·_NEG_BIG`` (exact mode) or
``ln2·bound`` (bounded mode), zero gradients.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_dot_product_tpu.ops.pallas_attention import (
    _flash_bwd_impl, _flash_fwd_impl, flash_attention as jax_flash_attention,
)
from distributed_dot_product_tpu_torch.ops.flash_attention import (
    _NEG_BIG, _bounded_ok, _fold_q, bounded_shift, flash_attention,
    flash_attention_backward, flash_attention_bounded, flash_attention_dkv,
    flash_attention_dq, flash_attention_with_lse,
)

REL = 1e-5
LN2 = math.log(2.0)


def _close(got, want, rel=REL, what=''):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (what, err)


def _inputs(seed, b, hq, hkv, tq, tk, d, scale=1.0):
    rng = np.random.default_rng(seed)
    q = scale * rng.standard_normal((b, hq, tq, d), dtype=np.float32)
    k = scale * rng.standard_normal((b, hkv, tk, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, tk, d), dtype=np.float32)
    g = rng.standard_normal((b, hq, tq, d), dtype=np.float32)
    return q, k, v, g


def _mask(seed, shape, empty_rows=(1,)):
    """A random boolean mask with some rows fully masked."""
    m = np.random.default_rng(seed).random(shape) < 0.4
    for r in empty_rows:
        m[..., r, :] = True
    return m


# (b, hq, hkv, tq, tk, d, causal, causal_offset, kv_offset, mask shape)
# mask shape: 'head' = (b, 1, tq, tk), 'plain' = (tq, tk), None.
CASES = {
    'mask_head': (2, 2, 2, 32, 32, 32, False, 0, 0, 'head'),
    'mask_plain_gqa': (1, 4, 2, 32, 24, 16, False, 0, 0, 'plain'),
    'mask_causal': (2, 2, 2, 32, 32, 32, True, 0, 0, 'head'),
    'fold_past': (1, 2, 2, 32, 32, 32, True, 64, 32, None),
    'fold_diagonal': (1, 2, 2, 32, 32, 32, True, 32, 32, 'head'),
    'fold_future': (1, 2, 2, 32, 32, 32, True, 0, 32, None),
    'fold_gqa_mask': (2, 4, 1, 32, 32, 16, True, 32, 16, 'head'),
}


def _case(name, seed):
    b, hq, hkv, tq, tk, d, causal, co, ko, mshape = CASES[name]
    q, k, v, g = _inputs(seed, b, hq, hkv, tq, tk, d)
    mask = None
    if mshape == 'head':
        mask = _mask(seed, (b, 1, tq, tk))
    elif mshape == 'plain':
        mask = _mask(seed, (tq, tk), empty_rows=(3,))
    return q, k, v, g, mask, dict(causal=causal, causal_offset=co,
                                  kv_offset=ko)


def _t(*arrays, grad=False):
    return [None if a is None else torch.from_numpy(a).requires_grad_(grad)
            for a in arrays]


@pytest.mark.parametrize('name', sorted(CASES))
def test_forward_and_lse_match_jax(name):
    q, k, v, _, mask, kw = _case(name, len(name))
    scale = 1.0 / math.sqrt(q.shape[-1])
    want_out, want_lse = _flash_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask), kw['causal_offset'],
        scale, kw['causal'], True, save_lse=True, kv_offset=kw['kv_offset'])
    tq_, tk_, tv_, tm = _t(q, k, v, mask)
    out, lse = flash_attention_with_lse(tq_, tk_, tv_, tm, scale=scale, **kw)
    _close(out, want_out, what='out')
    _close(lse, want_lse, what='lse')
    if name == 'fold_future':
        # A fold whose block lies wholly in the causal future: out 0 and
        # lse ln2·_NEG_BIG, exactly (the ring merge relies on it).
        assert not out.any()
        assert torch.all(lse == torch.tensor(LN2 * _NEG_BIG,
                                             dtype=torch.float32))
    if mask is not None and mask.ndim == 4:
        assert not out[:, :, 1].any()


@pytest.mark.parametrize('name', sorted(CASES))
def test_float32_partial_grads_match_jax(name):
    q, k, v, g, mask, kw = _case(name, 50 + len(name))
    scale = 1.0 / math.sqrt(q.shape[-1])
    jm = None if mask is None else jnp.asarray(mask)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    out, lse = _flash_fwd_impl(jq, jk, jv, jm, kw['causal_offset'], scale,
                               kw['causal'], True, save_lse=True,
                               kv_offset=kw['kv_offset'])
    want = _flash_bwd_impl(jq, jk, jv, jm, kw['causal_offset'], out, lse,
                           jg, scale, kw['causal'], True,
                           grad_dtype=jnp.float32,
                           kv_offset=kw['kv_offset'])
    tq_, tk_, tv_, tg, tm = _t(q, k, v, g, mask)
    got = flash_attention_backward(
        tq_, tk_, tv_, torch.from_numpy(np.array(out)),
        torch.from_numpy(np.array(lse)), tg, kw['causal'],
        kw['causal_offset'], scale, mask=tm, kv_offset=kw['kv_offset'],
        grad_dtype=torch.float32)
    for n, a, w in zip(('dq', 'dk', 'dv'), got, want):
        assert a.dtype == torch.float32, n
        _close(a, w, what=n)
    if mask is not None and mask.ndim == 4:
        assert not got[0][:, :, 1].any()


@pytest.mark.parametrize('name', ['mask_head', 'mask_plain_gqa',
                                  'fold_diagonal', 'fold_gqa_mask'])
def test_masked_grads_match_jax_vjp(name):
    q, k, v, g, mask, kw = _case(name, 80 + len(name))
    jm = jnp.asarray(mask)
    want_out, vjp = jax.vjp(
        lambda a, b, c: jax_flash_attention(a, b, c, jm, **kw),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    tq_, tk_, tv_ = _t(q, k, v, grad=True)
    out = flash_attention(tq_, tk_, tv_, torch.from_numpy(mask), **kw)
    got = torch.autograd.grad(out, (tq_, tk_, tv_), torch.from_numpy(g))
    _close(out, want_out, what='out')
    for n, a, w in zip(('dq', 'dk', 'dv'), got, want):
        _close(a, w, what=n)


# (input scale, guard expected to pick K2)
BOUNDED = {'small_norm': (0.3, True), 'large_norm': (3.0, False)}


@pytest.mark.parametrize('case', sorted(BOUNDED))
def test_bounded_both_sides_of_the_guard_match_jax(case):
    scale_in, bounded = BOUNDED[case]
    q, k, v, g = _inputs(7, 2, 4, 2, 32, 32, 32, scale=scale_in)
    mask = _mask(9, (2, 1, 32, 32))
    scale = 1.0 / math.sqrt(32)
    tq_, tk_, tv_, tm = _t(q, k, v, mask)
    mvec = bounded_shift(_fold_q(tq_, scale), tk_)
    assert _bounded_ok(mvec) is bounded
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
             jnp.asarray(mask), 0, scale, False, True)
    want_out, want_lse = _flash_fwd_impl(*jargs, mode='bounded',
                                         save_lse=True)
    out, lse = flash_attention_with_lse(tq_, tk_, tv_, tm, scale=scale,
                                        softmax_mode='bounded')
    _close(out, want_out, what='out')
    _close(lse, want_lse, what='lse')
    # The fully masked row tells the branches apart: K2 saves ln2·bound,
    # K1 ln2·_NEG_BIG — the port took the reference's branch.
    empty = lse[:, :, 1]
    if bounded:
        torch.testing.assert_close(empty, LN2 * mvec[:, :, 1], rtol=REL,
                                   atol=0)
    else:
        assert torch.all(empty == torch.tensor(LN2 * _NEG_BIG,
                                               dtype=torch.float32))
    # K2 regardless of the guard equals K1 wherever the shift is safe.
    if bounded:
        exact = flash_attention(tq_, tk_, tv_, tm, scale=scale)
        _close(flash_attention_bounded(tq_, tk_, tv_, tm, scale=scale),
               exact.numpy(), what='K2 vs K1')
    # The gradient of the bounded forward is K3/K4 from its lse.
    qg, kg, vg = _t(q, k, v, grad=True)
    want_out, vjp = jax.vjp(
        lambda a, b, c: jax_flash_attention(
            a, b, c, jnp.asarray(mask), scale=scale,
            softmax_mode='bounded'), *jargs[:3])
    want = vjp(jnp.asarray(g))
    out = flash_attention(qg, kg, vg, tm, scale=scale,
                          softmax_mode='bounded')
    got = torch.autograd.grad(out, (qg, kg, vg), torch.from_numpy(g))
    for n, a, w in zip(('dq', 'dk', 'dv'), got, want):
        _close(a, w, what=n)


def test_cpu_feature_calls_launch_nothing():
    for fn in (flash_attention, flash_attention_bounded, flash_attention_dq,
               flash_attention_dkv):
        fn.launches = 0
    q, k, v, g, mask, kw = _case('fold_gqa_mask', 3)
    tq_, tk_, tv_ = _t(q, k, v, grad=True)
    for mode in ('exact', 'bounded'):
        out = flash_attention(tq_, tk_, tv_, torch.from_numpy(mask),
                              softmax_mode=mode, **kw)
        out.backward(torch.from_numpy(g))
    assert (flash_attention.launches, flash_attention_bounded.launches,
            flash_attention_dq.launches,
            flash_attention_dkv.launches) == (0, 0, 0, 0)


def test_bad_mode_and_mask_shape_raise():
    x = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match='softmax_mode'):
        flash_attention(x, x, x, softmax_mode='fast')
    with pytest.raises(ValueError, match='mask trailing dims'):
        flash_attention(x, x, x, torch.zeros((8, 7), dtype=torch.bool))
