# -*- coding: utf-8 -*-
"""
The operands the port's int8-scored kernels take, against the reference
package on the CPU, and the (batch, head) row counts the wrappers pass.

- K4 (dk/dv) with ``qk_quant='int8'`` streams the dequantized q
  (:func:`dequantize_rows`, made once a call by the wrapper) where the bf16
  kernel streams the folded q, and K3 (dq) the dequantized k where the bf16
  kernel streams k: each must equal the reference's in-block
  dequantization ``(x_i8.astype(f32) · s).astype(bf16)`` of
  ``_quantize_rows``' operands bit for bit (bf16 inputs made by numpy from
  a seed, both rounded to bf16 the same way). K3's is kv-head shaped: the
  bytes the wrapper hands the kernel are read back at the launch under
  GQA.
- ``flash_attention_dq(..., quant=...)`` and ``flash_attention_dkv(...,
  quant=...)`` on CPU tensors (their plain versions, the arithmetic the
  kernels are held against on the card) against the reference's int8
  ``_flash_bwd_impl`` (Pallas in interpret mode), float32 inputs: max
  |got − want| ≤ 1e-5 · max |want| per tensor, the tolerance of
  ``tests/test_torch_flash_masks.py``.
- The kernels put the (batch, head) rows on the grid's x dimension, so the
  wrappers take more than 65535 of them: with the library call replaced by
  a recorder, K1, K3 and K4 (bf16 and int8) reach their launch with all
  65600 rows.
"""

import contextlib
import ctypes
import importlib
import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_dot_product_tpu.ops.pallas_attention import (
    _flash_bwd_impl, _flash_fwd_impl, _quantize_rows,
)

fa = importlib.import_module(
    'distributed_dot_product_tpu_torch.ops.flash_attention')

REL = 1e-5


@pytest.mark.parametrize('d', [32, 64, 96, 128])
def test_dequantized_q_is_the_references_in_block_dequantization(d):
    rng = np.random.default_rng(d)
    x = (3.0 * rng.standard_normal((2, 3, 70, d))).astype(np.float32)
    x[0, 1, 5] = 0.0                       # an all-zero row: scale 1e-20
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    want_i8, want_s = _quantize_rows(jx, 6, 70, d)
    want = (want_i8.astype(jnp.float32) * want_s).astype(jnp.bfloat16)
    got_i8, got_s = fa.quantize_rows(
        torch.from_numpy(x).to(torch.bfloat16))
    got = fa.dequantize_rows(got_i8, got_s, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    np.testing.assert_array_equal(got_i8.reshape(6, 70, d).numpy(),
                                  np.asarray(want_i8))
    np.testing.assert_array_equal(got_s.reshape(6, 70, 1).numpy(),
                                  np.asarray(want_s))
    np.testing.assert_array_equal(
        got.view(torch.int16).reshape(6, 70, d).numpy(),
        np.asarray(want).view(np.int16))


# (b, hq, hkv, tq, tk, d, causal, causal_offset, kv_offset, features)
DKV_CASES = {
    'gqa_causal_offsets': (2, 4, 2, 40, 72, 32, True, 40, 10, {}),
    'window_segments_dropout': (1, 2, 2, 48, 48, 64, True, 0, 0,
                                dict(window=9, dropout_rate=0.2,
                                     dropout_seed=11, segments=True)),
}


# Each case for both passes; the dk/dv cases keep their earlier ids.
INT8_BWD_CASES = ([pytest.param('dkv', n, id=n) for n in sorted(DKV_CASES)]
                  + [pytest.param('dq', n, id=f'dq-{n}')
                     for n in sorted(DKV_CASES)])


@pytest.mark.parametrize('grad, name', INT8_BWD_CASES)
def test_int8_dkv_matches_jax(grad, name):
    """int8 dq (``grad='dq'``) or dk, dv (``'dkv'``) against the
    reference's int8 backward."""
    b, hq, hkv, tq, tk, d, causal, co, ko, feat = DKV_CASES[name]
    rng = np.random.default_rng(len(name))
    q, g = (rng.standard_normal((b, hq, tq, d), dtype=np.float32)
            for _ in range(2))
    k, v = (rng.standard_normal((b, hkv, tk, d), dtype=np.float32)
            for _ in range(2))
    feat = dict(feat, qk_quant='int8')
    jfeat, tfeat = dict(feat), dict(feat)
    if jfeat.pop('segments', False):
        seg = np.sort(rng.integers(0, 3, (b, 1, tq)), axis=-1).astype(
            np.int32)
        jfeat['segment_ids'] = (jnp.asarray(seg), jnp.asarray(seg))
        tfeat['segment_ids'] = (torch.from_numpy(seg),) * 2
    tfeat.pop('segments', None)
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    out, lse = _flash_fwd_impl(jq, jk, jv, None, co, scale, causal, True,
                               save_lse=True, kv_offset=ko, **jfeat)
    want_dq, want_dk, want_dv = _flash_bwd_impl(
        jq, jk, jv, None, co, out, lse, jg, scale, causal, True,
        grad_dtype=jnp.float32, kv_offset=ko, **jfeat)
    tq_, tk_, tv_, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    q2, lse2, delta = fa.flash_attention_bwd_operands(
        tq_, torch.from_numpy(np.array(out)),
        torch.from_numpy(np.array(lse)), tg, scale)
    tfeat.pop('qk_quant')
    kw = dict(causal=causal, causal_offset=co, kv_offset=ko, scale=scale,
              grad_dtype=torch.float32, quant=fa.quant_operands(tq_, tk_),
              **tfeat)
    if grad == 'dq':
        pairs = (('dq', fa.flash_attention_dq(q2, tk_, tv_, tg, lse2, delta,
                                              **kw), want_dq),)
    else:
        got_dk, got_dv = fa.flash_attention_dkv(q2, tk_, tv_, tg, lse2,
                                                delta, **kw)
        pairs = (('dk', got_dk, want_dk), ('dv', got_dv, want_dv))
    for n, got, want in pairs:
        want = np.asarray(want)
        assert got.dtype == torch.float32 and got.shape == want.shape, n
        err = np.abs(got.numpy() - want).max()
        assert err <= REL * np.abs(want).max(), (n, err)


ROWS_B, ROWS_H = 8200, 8          # 65600 (batch, head) rows


@pytest.fixture
def recorded_launches(monkeypatch):
    """The kernel libraries replaced by a recorder of each call's
    arguments (the wrappers' CUDA device and stream calls by stand-ins);
    the launch counters restored afterwards."""
    calls = []

    def cfn(lib, symbol, argtypes):
        def call(*args):
            calls.append((lib, args))
            return 0
        return call
    monkeypatch.setattr(fa, '_cfn', cfn)
    monkeypatch.setattr(torch.cuda, 'device',
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda: types.SimpleNamespace(cuda_stream=None))
    counted = (fa.flash_attention, fa.flash_attention_dq,
               fa.flash_attention_dkv)
    saved = [(fn.launches, fn.alibi_launches, fn.positions_launches)
             for fn in counted]
    yield calls
    for fn, (n, a, p) in zip(counted, saved):
        fn.launches, fn.alibi_launches, fn.positions_launches = n, a, p


@pytest.mark.parametrize('quant', [None, 'int8'], ids=['bf16', 'int8'])
@pytest.mark.parametrize('kernel', ['k1', 'k3', 'k4'])
def test_wrappers_launch_more_rows_than_a_grid_column(recorded_launches,
                                                      kernel, quant):
    gen = torch.Generator().manual_seed(3)
    q, k, v, g = (torch.randn((ROWS_B, ROWS_H, 1, 32), generator=gen)
                  .to(torch.bfloat16) for _ in range(4))
    scale = 1.0 / math.sqrt(32)
    rows = torch.zeros((ROWS_B, ROWS_H, 1))
    ops = fa.quant_operands(q, k) if quant else None
    q2 = fa._fold_q(q, scale)
    if kernel == 'k1':
        feat = fa._features(q, k, True, qk_quant=quant)
        fa._launch(q, k, v, None, True, 0, 0, scale, save_lse=True,
                   feat=feat, quant=ops)
        at = 11        # pointers q, k, v, out, lse, mvec; the mask's 5
    else:
        feat = fa._bwd_feat(q2, k, True, None, None, 0.0, None, ops, None,
                            None)
        launch = fa._launch_dq if kernel == 'k3' else fa._launch_dkv
        launch(q2, k, v, g, rows, rows, None, True, 0, 0, scale, None, feat,
               ops)
        at = 12 if kernel == 'k3' else 13   # 7 or 8 pointers; the mask's 5
    lib, args = recorded_launches[-1]
    assert lib.endswith('_ext') == (quant is not None)
    assert args[at] == ROWS_B * ROWS_H
    if kernel == 'k3':
        # int8: the dq operand is the dequantized k, not k.
        assert (args[1] == k.data_ptr()) == (quant is None)
    if kernel == 'k4':
        # int8: the dk operand is the dequantized q, not the folded q2.
        assert (args[0] == q2.data_ptr()) == (quant is None)


def test_k3_int8_takes_the_kv_head_dequantized_k(monkeypatch):
    """Under GQA 8:2 the k operand K3 int8 receives is b x 2 x T x d bf16
    (kv-head shaped, not expanded to the query heads), equal bit for bit to
    :func:`dequantize_rows` of the int8 k and to the reference's in-block
    dequantization: the bytes are read at the launch, while the wrapper
    still holds them."""
    b, hq, hkv, t, d = 2, 8, 2, 40, 64
    rng = np.random.default_rng(13)
    q, k, v, g = (torch.from_numpy(
        (2.0 * rng.standard_normal((b, h, t, d))).astype(np.float32))
        .to(torch.bfloat16) for h in (hq, hkv, hkv, hq))
    seen = []

    def cfn(lib, symbol, argtypes):
        def call(*args):
            n = b * hkv * t * d
            raw = (ctypes.c_uint16 * n).from_address(args[1])
            seen.append((lib, args, np.frombuffer(raw, np.uint16).copy()))
            return 0
        return call
    monkeypatch.setattr(fa, '_cfn', cfn)
    monkeypatch.setattr(torch.cuda, 'device',
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda: types.SimpleNamespace(cuda_stream=None))
    monkeypatch.setattr(fa.flash_attention_dq, 'launches',
                        fa.flash_attention_dq.launches)
    scale = 1.0 / math.sqrt(d)
    ops = fa.quant_operands(q, k)
    q2 = fa._fold_q(q, scale)
    rows = torch.zeros((b, hq, t))
    feat = fa._bwd_feat(q2, k, True, None, None, 0.0, None, ops, None, None)
    fa._launch_dq(q2, k, v, g, rows, rows, None, True, 0, 0, scale, None,
                  feat, ops)
    (lib, args, got), = seen
    assert lib == 'flash_bwd_dq_ext'
    assert args[13] == hq // hkv          # the GQA group
    want = fa.dequantize_rows(ops[2], ops[3], torch.bfloat16)
    assert want.shape == k.shape
    np.testing.assert_array_equal(got, want.view(torch.int16).numpy()
                                  .view(np.uint16).ravel())
    jk = jnp.asarray(k.float().numpy()).astype(jnp.bfloat16)
    k8, sk = _quantize_rows(jk, b * hkv, t, d)
    ref = (k8.astype(jnp.float32) * sk).astype(jnp.bfloat16)
    np.testing.assert_array_equal(got, np.asarray(ref).view(np.uint16)
                                  .ravel())
