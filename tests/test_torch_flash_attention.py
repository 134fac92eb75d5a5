# -*- coding: utf-8 -*-
"""
The port's flash-attention forward (K1) against the reference package's
``flash_attention`` (Pallas in interpret mode, its CPU default) on the
same float32 inputs, made by numpy from a seed. On the CPU the port's
wrapper runs its plain version — the arithmetic the CUDA kernel
implements and is held against on the card.

The knobs not ported yet (ALiBi, explicit positions) raise; those
ported since (``kv_offset``, bounded softmax, a dense mask, the window,
int8 scoring, dropout, segments) are held against the reference on the
same calls.

Tolerance: atol = rtol = 1e-5, float32 rounding of two different
reduction orders (blockwise online softmax vs one full-row softmax).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from distributed_dot_product_tpu.ops.pallas_attention import (
    flash_attention as jax_flash_attention,
)
from distributed_dot_product_tpu_torch.ops.flash_attention import (
    flash_attention,
)

TOL = dict(atol=1e-5, rtol=1e-5)

# (batch, q heads, kv heads, Tq, Tk, d, causal, causal_offset, filled Tk
#  rows — the rest zero, as in a cache buffer the prefill passes whole)
CASES = {
    'full': (2, 2, 2, 24, 24, 16, False, 0, None),
    'causal': (2, 2, 2, 40, 40, 16, True, 0, None),
    'causal_offset': (1, 2, 2, 9, 40, 16, True, 20, 29),
    'prefill_zero_tail': (1, 2, 2, 12, 40, 16, True, 0, 12),
    'gqa_causal': (2, 4, 2, 20, 20, 16, True, 0, None),
    'gqa_offset_tail': (1, 4, 1, 7, 32, 8, True, 5, 12),
    'empty_rows': (1, 2, 2, 8, 16, 16, True, -3, None),
}


def _inputs(seed, b, hq, hkv, tq, tk, d, filled):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, tq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, tk, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, tk, d), dtype=np.float32)
    if filled is not None:
        k[..., filled:, :] = 0.0
        v[..., filled:, :] = 0.0
    return q, k, v


@pytest.mark.parametrize('case', sorted(CASES))
def test_plain_matches_jax(case):
    b, hq, hkv, tq, tk, d, causal, off, filled = CASES[case]
    q, k, v = _inputs(len(case), b, hq, hkv, tq, tk, d, filled)
    want = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        causal_offset=off))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal,
                          causal_offset=off).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if case == 'empty_rows':
        # Rows at global positions < 0 attend nothing: exactly 0.
        assert not got[..., :3, :].any()
        assert got[..., 3:, :].any()


PORTED_KNOBS = ('kv_offset', 'softmax_mode', 'window', 'qk_quant',
                'dropout_rate', 'segment_ids')


@pytest.mark.parametrize('kw', [
    dict(kv_offset=3), dict(softmax_mode='bounded'), dict(window=4),
    dict(qk_quant='int8'), dict(dropout_rate=0.1, dropout_seed=1),
    dict(alibi_slopes=[0.5, 0.25]),
    dict(segment_ids=np.zeros((1, 8), np.int32)),
    dict(positions=np.arange(8)),
])
def test_unported_knobs_raise(kw):
    """Knobs still unported (ALiBi, positions) raise; ``kv_offset``,
    bounded softmax, the window, int8 scoring, dropout and segments are
    ported now and match the reference on the same call."""
    x = torch.zeros((1, 2, 8, 16))
    if set(kw) & set(PORTED_KNOBS):
        q, k, v = _inputs(11, 1, 2, 2, 8, 8, 16, None)
        want = np.asarray(jax_flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
            **kw))
        got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True, **kw)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        return
    with pytest.raises(NotImplementedError):
        flash_attention(x, x, x, causal='window' in kw, **kw)


def test_mask_and_bad_shapes_raise():
    """A dense mask is ported now (it matches the reference); bad shapes
    still raise."""
    x = torch.zeros((1, 2, 8, 16))
    q, k, v = _inputs(12, 1, 2, 2, 8, 8, 16, None)
    mask = np.tril(np.ones((8, 8), bool))
    want = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask)))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not got[..., -1, :].any()       # the last row is fully masked
    with pytest.raises(ValueError):
        flash_attention(x, x, torch.zeros((1, 2, 7, 16)))
    with pytest.raises(ValueError):
        flash_attention(x, torch.zeros((1, 3, 8, 16)),
                        torch.zeros((1, 3, 8, 16)))
    with pytest.raises(ValueError):
        flash_attention(x, x, x, interpret=False)
