# -*- coding: utf-8 -*-
"""
Head dims off the old (32, 64, 96, 128) list and value widths ``d_v ≠ d``
through the port, on the CPU, against the reference package on the same
float32 inputs made by numpy from a seed:

- ``flash_attention`` forward and its gradient (dq, dk, dv) at
  ``(d, d_v)`` in {(16, 24), (24, 12), (40, 40), (64, 32)}, causal GQA,
  against the reference ``flash_attention`` (Pallas in interpret mode,
  its CPU default) and ``jax.vjp`` of it;
- ``DistributedDotProductAttn`` at the reference tests' ``KEY_DIM 16``,
  ``VALUE_DIM 8`` with ``softmax_impl='flash'`` (forward and input
  gradients), and its decode cache (``prefill`` then ``decode`` steps on
  both decode impls) against the reference module's;
- ``flash_decode`` slab and paged at ``d_v ≠ d``, pages 48 and 12
  (sizes that neither divide 128 nor are multiples of it), against the
  reference kernel in interpret mode, caches appended alike;
- ``block_k``: the accepted values give the reference's answer, the
  refused ones raise the reference's ``ValueError`` on both;
- the K1–K4 wrappers' pad-and-slice algebra: the launch replaced, by this
  test alone, with the plain version run on the padded operands the
  wrapper hands it; the sliced results equal the plain version on the
  unpadded operands, forward (out, lse) and gradients (dq, dk, dv).

Tolerances: against the reference, max |got − want| ≤ 1e-5 · max |want|
(forward, decode) and per tensor for the gradients — float32 rounding of
two reduction orders, as in tests/test_torch_flash_backward.py; the
module's output and gradients and the decode cache's steps atol = rtol =
1e-5 (float32 GEMMs of two libraries). Pad-and-slice: bf16 operands,
float32 arithmetic in both versions; the padded columns add exact zeros
to each dot but may change the float32 summation's blocking, and the
scale reaches the launch as ``scale·log2(e)``, so atol = rtol = 1e-6 on
outputs of magnitude ~1 (lse ~10: 1e-5 absolute).
"""

import importlib
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_dot_product_tpu import DistributedDotProductAttn as JaxAttn
from distributed_dot_product_tpu.ops.pallas_attention import (
    flash_attention as jax_flash_attention,
)
from distributed_dot_product_tpu.ops.pallas_decode import (
    flash_decode as jax_flash_decode,
)
from distributed_dot_product_tpu_torch import (
    DistributedDotProductAttn, attn_state_from_jax,
)
from distributed_dot_product_tpu_torch.ops import flash_attention as _fa_fn
from distributed_dot_product_tpu_torch.ops import flash_decode as _fd_fn

fa = importlib.import_module(
    'distributed_dot_product_tpu_torch.ops.flash_attention')

REL = 1e-5
TOL = dict(atol=1e-5, rtol=1e-5)
WIDTHS = [(16, 24), (24, 12), (40, 40), (64, 32)]


def _rand(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _close(got, want, what=''):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(np.asarray(got) - want).max()) <= REL * scale, what


@pytest.mark.parametrize('d,dv', WIDTHS)
def test_flash_forward_matches_jax(d, dv):
    rng = np.random.default_rng(d * 100 + dv)
    q, k, v = (_rand(rng, 1, 4, 40, d), _rand(rng, 1, 2, 40, d),
               _rand(rng, 1, 2, 40, dv))
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True)
    got = _fa_fn(torch.from_numpy(q), torch.from_numpy(k),
                 torch.from_numpy(v), causal=True)
    assert tuple(got.shape) == (1, 4, 40, dv)
    _close(got.numpy(), want)


@pytest.mark.parametrize('d,dv', WIDTHS)
def test_flash_gradients_match_jax(d, dv):
    rng = np.random.default_rng(d * 10 + dv)
    q, k, v = (_rand(rng, 1, 4, 37, d), _rand(rng, 1, 2, 37, d),
               _rand(rng, 1, 2, 37, dv))
    g = _rand(rng, 1, 4, 37, dv)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash_attention(a, b, c,
                                                         causal=True),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = _fa_fn(tq, tk, tv, causal=True)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for name, x, y in zip(('dq', 'dk', 'dv'), got, want):
        assert tuple(x.shape) == y.shape
        _close(x.numpy(), y, name)


MOD = dict(key_dim=16, value_dim=8, num_heads=2, causal=True,
           distributed=False, softmax_impl='flash')


def _module_pair(seed=0, t=10):
    rng = np.random.default_rng(seed)
    k, q = _rand(rng, 2, t, 16), _rand(rng, 2, t, 16)
    v = _rand(rng, 2, t, 8)
    jm = JaxAttn(**MOD)
    params = jm.init(jax.random.key(seed), *(jnp.asarray(x)
                                              for x in (k, q, v)))
    port = DistributedDotProductAttn(device='cpu', **MOD)
    port.load_state_dict(attn_state_from_jax(jax.tree.map(np.asarray,
                                                          params)))
    return jm, params, port, (k, q, v)


def test_module_value_dim_matches_jax():
    """Forward and the inputs' gradients of the flash module at KEY_DIM
    16, VALUE_DIM 8 (head dim 8, value head dim 4)."""
    jm, params, port, xs = _module_pair()
    g = np.random.default_rng(9).standard_normal((2, 10, 8)).astype(
        np.float32)
    want, vjp = jax.vjp(lambda *a: jm.apply(params, *a),
                        *(jnp.asarray(x) for x in xs))
    want_g = vjp(jnp.asarray(g))
    ins = [torch.from_numpy(x).requires_grad_() for x in xs]
    got = port(*ins, deterministic=True)
    got_g = torch.autograd.grad(got, ins, torch.from_numpy(g))
    assert tuple(got.shape) == (2, 10, 8)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for x, y in zip(got_g, want_g):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **TOL)


@pytest.mark.parametrize('impl', ['kernel', 'plain'])
def test_module_value_dim_decode_cache_matches_jax(impl):
    """The decode cache of the same module (v_head_dim 4 ≠ head_dim 8):
    prefill 4 rows, then 5 decode steps, each step's output against the
    reference module's."""
    jm, params, port, (k, q, v) = _module_pair(seed=1, t=9)
    port.decode_impl = impl
    jc, tc = jm.make_decode_cache(2, 12), port.make_decode_cache(2, 12)
    with torch.no_grad():
        for lo, hi in ((0, 4),) + tuple((t, t + 1) for t in range(4, 9)):
            jx = [jnp.asarray(x[:, lo:hi]) for x in (k, q, v)]
            tx = [torch.from_numpy(x[:, lo:hi]) for x in (k, q, v)]
            method = 'prefill' if lo == 0 else 'decode'
            jc, want = jm.apply(params, *jx, jc, method=method)
            tc, got = getattr(port, method)(*tx, tc)
            assert tuple(got.shape) == (2, hi - lo, 8)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       err_msg=f'{method} {lo}', **TOL)
    assert tc.v.shape[-1] == 4 and tc.k.shape[-1] == 8


def _decode_inputs(rng, b, h, h_kv, n, d, dv, t):
    return (_rand(rng, b, h, n, d), _rand(rng, b, h_kv, n, d),
            _rand(rng, b, h_kv, n, dv), _rand(rng, b, h_kv, t, d),
            _rand(rng, b, h_kv, t, dv))


def _t(x):
    return torch.from_numpy(np.array(x))


def _both_decode(q, kn, vn, ck, cv, vt, ap, **kw):
    """``(reference (out, k, v), port (out, k, v))`` of one decode call on
    the same inputs (the port's caches appended in place)."""
    jkw = {n: jnp.asarray(x) if isinstance(x, np.ndarray) else x
           for n, x in kw.items()}
    want = jax_flash_decode(*(jnp.asarray(x) for x in (q, kn, vn, ck, cv,
                                                       vt, ap)),
                            interpret=True, **jkw)[:3]
    tkw = {n: _t(x) if isinstance(x, np.ndarray) else x
           for n, x in kw.items()}
    tk, tv = _t(ck), _t(cv)
    got = _fd_fn(_t(q), _t(kn), _t(vn), tk, tv, _t(vt), _t(ap), **tkw)
    assert got[1] is tk and got[2] is tv
    return want, got


@pytest.mark.parametrize('paged,ps', [(False, None), (True, 48),
                                      (True, 12)],
                         ids=['slab', 'paged_48', 'paged_12'])
def test_flash_decode_value_width_matches_jax(paged, ps):
    """k rows of 16, v rows of 24, GQA 4:2, mixed fill (an append on a
    page boundary, an inactive slot, an empty one)."""
    rng = np.random.default_rng(7 if ps is None else ps)
    d, dv, h, h_kv = 16, 24, 4, 2
    if paged:
        pps, b = 4, 4
        t_max, pages = pps * ps, 13
        table = np.full((b, pps), -1, np.int32)
        perm = rng.permutation(pages)
        fills = [ps - 1, ps, 2 * ps + 5, 0]
        nxt = 0
        for i, f in enumerate(fills):
            need = f // ps + 1
            table[i, :need] = perm[nxt:nxt + need]
            nxt += need
        q, kn, vn, _, _ = _decode_inputs(rng, b, h, h_kv, 1, d, dv, 1)
        ck = _rand(rng, pages + 1, h_kv, ps, d)
        cv = _rand(rng, pages + 1, h_kv, ps, dv)
        vt = np.array([f for f in fills[:3]] + [-1], np.int32)
        ap = np.array(fills[:3] + [-1], np.int32)
        want, got = _both_decode(q, kn, vn, ck, cv, vt, ap,
                                 page_table=table)
        rows = slice(None, -1)           # the sink page is the reference's
    else:
        b, t_max = 4, 40
        q, kn, vn, ck, cv = _decode_inputs(rng, b, h, h_kv, 1, d, dv, t_max)
        vt = np.array([5, t_max - 1, 0, -1], np.int32)
        ap = np.array([5, t_max - 1, -1, -1], np.int32)
        want, got = _both_decode(q, kn, vn, ck, cv, vt, ap)
        rows = slice(None)
    assert tuple(got[0].shape) == (b, h, 1, dv)
    _close(got[0].numpy(), want[0], 'out')
    np.testing.assert_array_equal(got[1].numpy()[rows],
                                  np.asarray(want[1])[rows])
    np.testing.assert_array_equal(got[2].numpy()[rows],
                                  np.asarray(want[2])[rows])
    assert not got[0][-1].any()                       # empty slot: exact 0


@pytest.mark.parametrize('block_k,n,t_max', [(32, 1, 96), (48, 3, 96),
                                              (96, 5, 96), (None, 5, 200),
                                              (np.int64(32), 3, 96),
                                              (0, 1, 200)])
def test_block_k_accepted_matches_jax(block_k, n, t_max):
    """Slab splits that divide t_max (96), one new row and verify-k, a
    numpy integer split, and no block_k (None or 0) on a t_max that is no
    multiple of the port's 128-column split: the reference's answer,
    caches appended alike."""
    rng = np.random.default_rng(t_max + n)
    q, kn, vn, ck, cv = _decode_inputs(rng, 3, 4, 2, n, 16, 8, t_max)
    vt = np.array([10, t_max - 1 - n, 40], np.int32)
    ap = np.array([10, t_max - 1 - n, -1], np.int32)
    want, got = _both_decode(q, kn, vn, ck, cv, vt, ap, block_k=block_k)
    _close(got[0].numpy(), want[0], 'out')
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize('case', ['no_divisor', 'verify_wider',
                                  'paged_not_page', 'paged_zero'])
def test_block_k_refused_like_jax(case):
    """block_k 40 of t_max 96, verify rows past the split, and a paged
    block_k other than the page size (24, and 0): the reference's
    ValueError on both packages, the same message."""
    rng = np.random.default_rng(1)
    n = 5 if case == 'verify_wider' else 1
    q, kn, vn, ck, cv = _decode_inputs(rng, 1, 2, 2, n, 16, 16, 96)
    vt = ap = np.array([10], np.int32)
    kw = dict(block_k=40)
    if case == 'verify_wider':
        kw = dict(block_k=4)
    elif case in ('paged_not_page', 'paged_zero'):
        ck, cv = _rand(rng, 9, 2, 12, 16), _rand(rng, 9, 2, 12, 16)
        kw = dict(block_k=24 if case == 'paged_not_page' else 0,
                  page_table=np.arange(8, dtype=np.int32)[None])
    messages = []
    for call in ('jax', 'port'):
        with pytest.raises(ValueError) as info:
            if call == 'jax':
                jkw = {n_: jnp.asarray(x) if isinstance(x, np.ndarray) else x
                       for n_, x in kw.items()}
                jax_flash_decode(*(jnp.asarray(x) for x in (
                    q, kn, vn, ck, cv, vt, ap)), interpret=True, **jkw)
            else:
                tkw = {n_: _t(x) if isinstance(x, np.ndarray) else x
                       for n_, x in kw.items()}
                _fd_fn(_t(q), _t(kn), _t(vn), _t(ck), _t(cv), _t(vt),
                       _t(ap), **tkw)
        messages.append(str(info.value).split(';')[0].split(' (')[0])
    assert messages[0] == messages[1]


# ---------------------------------------------------------------------------
# The wrappers' pad-and-slice algebra with the launch replaced by the plain
# version (this test only): the wrapper pads on the CPU as it does on the
# card and hands the fake launch its padded operands.

def _fake_kernels(monkeypatch):
    """Patches the K1–K4 launch path to run on CPU tensors: every tensor
    the wrapper passes (``_ptrs``) or allocates (``torch.empty``) is
    remembered by address, and ``_cfn`` returns a fake launch that runs
    the plain version on those tensors and writes the kernel's outputs.
    Returns the list of ``(d, d_v)`` widths the launches were given."""
    seen, widths = {}, []
    real_empty, real_ptrs = torch.empty, fa._ptrs

    def empty(*a, **kw):
        t = real_empty(*a, **kw)
        seen[t.data_ptr()] = t
        return t

    def ptrs(*tensors):
        for t in tensors:
            seen[t.data_ptr()] = t
        return real_ptrs(*tensors)

    def launch_fwd(q, k, v, out, lse, mvec, mask, inner, so, si, sr, nb,
                   group, tq, tk, d, dv, causal, co, ko, qscale, ext, s):
        widths.append((d, dv))
        q, k, v, out = (seen[p] for p in (q, k, v, out))
        o, l = fa.flash_attention_plain_lse(
            q, k, v, causal=bool(causal), causal_offset=co, kv_offset=ko,
            scale=qscale / fa._LOG2E)
        out.copy_(o)
        if lse is not None:
            seen[lse].copy_(l)
        return 0

    def launch_dq(q2, k, v, g, lse2, delta, dq, mask, inner, so, si, sr,
                  nb, group, tq, tk, d, dv, causal, co, ko, scale, f32,
                  ext, s):
        widths.append((d, dv))
        q2, k, v, g, lse2, delta, dq = (seen[p] for p in (
            q2, k, v, g, lse2, delta, dq))
        dq.copy_(fa.flash_attention_dq_plain(
            q2, k, v, g, lse2, delta, causal=bool(causal), causal_offset=co,
            kv_offset=ko, scale=scale))
        return 0

    def launch_dkv(q2, k, v, g, lse2, delta, dk, dv_out, mask, inner, so,
                   si, sr, nb, group, tq, tk, d, dv, causal, co, ko, scale,
                   f32, ext, s):
        widths.append((d, dv))
        q2, k, v, g, lse2, delta, dk, dv_out = (seen[p] for p in (
            q2, k, v, g, lse2, delta, dk, dv_out))
        got = fa.flash_attention_dkv_plain(
            q2, k, v, g, lse2, delta, causal=bool(causal), causal_offset=co,
            kv_offset=ko)
        dk.copy_(got[0])
        dv_out.copy_(got[1])
        return 0

    fakes = {'flash_fwd_bf16': launch_fwd, 'flash_bwd_dq_bf16': launch_dq,
             'flash_bwd_dkv_bf16': launch_dkv}
    monkeypatch.setattr(torch, 'empty', empty)
    monkeypatch.setattr(fa, '_ptrs', ptrs)
    monkeypatch.setattr(fa, '_cfn', lambda name, symbol, argtypes:
                        fakes[symbol])
    monkeypatch.setattr(torch.cuda, 'device', lambda dev: _Null())
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    return widths


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize('d,dv', [(8, 8), (24, 12), (16, 24), (100, 60),
                                  (160, 160)])
def test_pad_and_slice_equals_unpadded(monkeypatch, d, dv):
    widths = _fake_kernels(monkeypatch)
    rng = np.random.default_rng(d + dv)

    def bf(*shape):
        return torch.from_numpy(_rand(rng, *shape)).to(torch.bfloat16)
    q, k, v, g = bf(1, 4, 70, d), bf(1, 2, 70, d), bf(1, 2, 70, dv), \
        bf(1, 4, 70, dv)
    scale = 1.0 / math.sqrt(d)
    out, lse = fa._launch(q, k, v, None, True, 3, 0, scale, save_lse=True)
    want_out, want_lse = fa.flash_attention_plain_lse(
        q, k, v, causal=True, causal_offset=3, scale=scale)
    assert tuple(out.shape) == (1, 4, 70, dv) and out.is_contiguous()
    np.testing.assert_allclose(out.float().numpy(),
                               want_out.float().numpy(), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=1e-5,
                               rtol=1e-6)
    q2, lse2, delta = fa.flash_attention_bwd_operands(q, out, lse, g, scale)
    dq = fa._launch_dq(q2, k, v, g, lse2, delta, None, True, 3, 0, scale,
                       None, fa._NO_FEAT, None)
    dk, dv_ = fa._launch_dkv(q2, k, v, g, lse2, delta, None, True, 3, 0,
                             scale, None, fa._NO_FEAT, None)
    want_dq = fa.flash_attention_dq_plain(q2, k, v, g, lse2, delta,
                                          causal=True, causal_offset=3,
                                          scale=scale)
    want_dk, want_dv = fa.flash_attention_dkv_plain(
        q2, k, v, g, lse2, delta, causal=True, causal_offset=3)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv_, want_dv)):
        assert got.shape == want.shape and got.is_contiguous()
        np.testing.assert_allclose(got.float().numpy(),
                                   want.float().numpy(), atol=1e-6,
                                   rtol=1e-6)
    grid = fa._grid_dims(d, dv)
    assert widths == [grid] * 3 and grid in fa._KERNEL_GRID


def test_grid_covers_every_width_up_to_256():
    """Every (d, d_v) in 1..256 maps to the first grid pair covering it
    (the smallest d + d_v that does); past 256 the kernels raise
    NotImplementedError naming the limit, and int8 operands pad with
    zero columns."""
    for d in range(1, 257, 5):
        for dv in range(1, 257, 7):
            D, DV = fa._grid_dims(d, dv)
            assert D >= d and DV >= dv
            assert all(p[0] < d or p[1] < dv or sum(p) >= D + DV
                       for p in fa._KERNEL_GRID)
    with pytest.raises(NotImplementedError, match='256'):
        fa._grid_dims(257, 8)
    q8 = torch.ones((1, 2, 3, 24), dtype=torch.int8)
    padded = fa._pad_quant((q8, None, q8, None), 32)
    assert padded[0].shape[-1] == 32 and not padded[0][..., 24:].any()
