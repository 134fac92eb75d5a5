# -*- coding: utf-8 -*-
"""
The port's flash-attention gradient against the reference package, on the
CPU: the row logsumexp of ``flash_attention_plain_lse`` against the
reference ``_flash_fwd_impl(..., save_lse=True)``, and ``dq, dk, dv``
from ``torch.autograd.grad`` through the port's ``flash_attention``
against ``jax.vjp`` of the reference ``flash_attention`` (Pallas in
interpret mode, its CPU default), on the same float32 inputs and output
cotangent made by numpy from a seed. On the CPU the port's backward runs
the plain versions of K3 and K4 — the arithmetic the CUDA kernels
implement and are held against on the card.

Tolerance: max |got − want| ≤ 1e-5 · max |want| per tensor (relative to
the tensor's scale), float32 rounding of different reduction orders (one
full-row softmax against blockwise passes, and the kernels' in-block GQA
group sum against the reference's summed per-head partials, which agree
within rounding, not bit for bit).
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
    flash_attention, flash_attention_backward,
    flash_attention_backward_plain, flash_attention_dkv,
    flash_attention_dq, flash_attention_plain, flash_attention_plain_lse,
)

REL = 1e-5

# (batch, q heads, kv heads, Tq, Tk, d, causal, causal_offset)
CASES = {
    'causal_ragged': (2, 2, 2, 37, 37, 16, True, 0),
    'causal_offset_tq_ne_tk': (1, 2, 2, 21, 53, 16, True, 20),
    'gqa_4_2': (2, 4, 2, 24, 24, 16, True, 0),
    'gqa_offset': (1, 4, 2, 13, 40, 8, True, 11),
    'non_causal': (2, 2, 2, 19, 30, 16, False, 0),
    'empty_rows': (1, 2, 2, 12, 16, 16, True, -3),
    # The card kernels' edges: the LM's head dim, lengths crossing their
    # 64- and 128-row tiles, a GQA group of 4 (dk/dv sum it in the block)
    # with float32 gradients (the ring's partials), and an offset that
    # leaves a whole 64-row tile and more without a key.
    'head_dim_96': (1, 2, 2, 40, 40, 96, True, 0),
    'tiles_129': (1, 2, 2, 129, 129, 16, True, 0),
    'tiles_191': (1, 2, 2, 191, 191, 16, True, 0),
    'gqa_4_f32': (1, 8, 2, 48, 48, 16, True, 0),
    'offset_no_key': (1, 2, 2, 70, 30, 16, True, -66),
}
# Cases whose gradients are also taken in float32 (``grad_dtype``) through
# the public backward, against the reference's ``_flash_bwd_impl``.
F32_GRADS = ('gqa_4_f32',)


def _inputs(seed, b, hq, hkv, tq, tk, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, tq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, tk, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, tk, d), dtype=np.float32)
    g = rng.standard_normal((b, hq, tq, d), dtype=np.float32)
    return q, k, v, g


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= REL * max(np.abs(want).max(), 1e-30), (err,
                                                         np.abs(want).max())


def _torch(*arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


@pytest.mark.parametrize('case', sorted(CASES))
def test_lse_matches_jax(case):
    b, hq, hkv, tq, tk, d, causal, off = CASES[case]
    q, k, v, _ = _inputs(len(case), b, hq, hkv, tq, tk, d)
    scale = 1.0 / math.sqrt(d)
    want_out, want_lse = _flash_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, off, scale,
        causal, True, save_lse=True)
    out, lse = flash_attention_plain_lse(*_torch(q, k, v), causal=causal,
                                         causal_offset=off, scale=scale)
    assert lse.dtype == torch.float32 and lse.shape == (b, hq, tq)
    _close(out.numpy(), want_out)
    _close(lse.numpy(), want_lse)


@pytest.mark.parametrize('case', sorted(CASES))
def test_grads_match_jax_vjp(case):
    b, hq, hkv, tq, tk, d, causal, off = CASES[case]
    q, k, v, g = _inputs(100 + len(case), b, hq, hkv, tq, tk, d)
    want_out, vjp = jax.vjp(
        lambda q_, k_, v_: jax_flash_attention(q_, k_, v_, causal=causal,
                                               causal_offset=off),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))

    tq_, tk_, tv_ = _torch(q, k, v, grad=True)
    out = flash_attention(tq_, tk_, tv_, causal=causal, causal_offset=off)
    got = torch.autograd.grad(out, (tq_, tk_, tv_), torch.from_numpy(g))
    _close(out.detach().numpy(), want_out)
    for name, a, w in zip(('dq', 'dk', 'dv'), got, want):
        assert a.shape == tuple(w.shape), name
        _close(a.numpy(), w)
    if case in ('empty_rows', 'offset_no_key'):
        # Query rows at global positions < 0 attend nothing: exactly zero
        # output and exactly zero dq.
        n = -off
        assert not out[..., :n, :].detach().any()
        assert not got[0][..., :n, :].any() and got[0][..., n:, :].any()
    if case in F32_GRADS:
        scale = 1.0 / math.sqrt(d)
        jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
        o, lse = _flash_fwd_impl(jq, jk, jv, None, off, scale, causal, True,
                                 save_lse=True)
        want32 = _flash_bwd_impl(jq, jk, jv, None, off, o, lse,
                                 jnp.asarray(g), scale, causal, True,
                                 grad_dtype=jnp.float32)
        got32 = flash_attention_backward(
            *_torch(q, k, v, np.array(o), np.array(lse), g), causal, off,
            scale, grad_dtype=torch.float32)
        for name, a, w in zip(('dq', 'dk', 'dv'), got32, want32):
            assert a.dtype == torch.float32, name
            _close(a.numpy(), w)


def test_backward_entry_points_agree():
    """The autograd backward, the public backward (K3 and K4 wrappers on
    CPU tensors) and the one-shot plain backward are the same numbers."""
    b, hq, hkv, tq, tk, d, causal, off = CASES['gqa_offset']
    q, k, v, g = _inputs(7, b, hq, hkv, tq, tk, d)
    tq_, tk_, tv_ = _torch(q, k, v, grad=True)
    out = flash_attention(tq_, tk_, tv_, causal=causal, causal_offset=off)
    auto = torch.autograd.grad(out, (tq_, tk_, tv_), torch.from_numpy(g))
    qt, kt, vt, gt = _torch(q, k, v, g)
    o, lse = flash_attention_plain_lse(qt, kt, vt, causal=causal,
                                       causal_offset=off)
    plain = flash_attention_backward_plain(qt, kt, vt, o, lse, gt, causal,
                                           off)
    public = flash_attention_backward(qt, kt, vt, o, lse, gt, causal, off)
    for a, p_, u in zip(auto, plain, public):
        assert torch.equal(a, p_) and torch.equal(a, u)


def test_no_grad_and_cpu_paths_launch_nothing():
    for fn in (flash_attention, flash_attention_dq, flash_attention_dkv):
        fn.launches = 0
    q, k, v, g = _inputs(3, 1, 2, 2, 9, 9, 16)
    tq_, tk_, tv_ = _torch(q, k, v, grad=True)
    with torch.no_grad():
        plain = flash_attention(tq_, tk_, tv_, causal=True)
    assert not plain.requires_grad
    assert torch.equal(plain, flash_attention_plain(tq_.detach(),
                                                    tk_.detach(),
                                                    tv_.detach(),
                                                    causal=True))
    out = flash_attention(tq_, tk_, tv_, causal=True)
    out.backward(torch.from_numpy(g))
    assert tq_.grad is not None and tk_.grad is not None
    assert (flash_attention.launches, flash_attention_dq.launches,
            flash_attention_dkv.launches) == (0, 0, 0)
