# -*- coding: utf-8 -*-
"""
The port's decode path against the reference package on the same
float32 inputs (numpy, seeded): ``decode_step`` — both port impls, the
K5 port (``'kernel'``, its plain version on the CPU) and the append +
masked-softmax step (``'plain'``) — against the reference
``decode_step`` with ``impl='xla'`` and ``impl='kernel'`` (Pallas,
``interpret=True``), and the K5 wrapper ``flash_decode`` against the
reference ``flash_decode`` with mixed per-row fill.

Caches must match bit for bit (an append copies rows); outputs within
atol = rtol = 1e-5 (float32, exp vs exp2 and different reduction
orders).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from distributed_dot_product_tpu.models import decode as jdec
from distributed_dot_product_tpu.ops.pallas_decode import (
    flash_decode as jax_flash_decode,
)
from distributed_dot_product_tpu_torch.models import decode as tdec
from distributed_dot_product_tpu_torch.ops.flash_decode import flash_decode

TOL = dict(atol=1e-5, rtol=1e-5)
T_MAX, D = 16, 8


def _rand(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _caches(rng, b, h_kv, length):
    k = _rand(rng, b, h_kv, length, D)
    v = _rand(rng, b, h_kv, length, D)
    jc = jdec.init_cache(b, h_kv, T_MAX, D, dtype=jnp.float32)
    tc = tdec.init_cache(b, h_kv, T_MAX, D, dtype=torch.float32,
                         device='cpu')
    if length:
        jc = jdec.append_kv(jc, jnp.asarray(k), jnp.asarray(v))
        tc = tdec.append_kv(tc, torch.from_numpy(k), torch.from_numpy(v))
    return jc, tc


@pytest.mark.parametrize('h,h_kv', [(4, 4), (4, 2)])
@pytest.mark.parametrize('length', [0, 5, T_MAX - 3])
def test_decode_step_matches_jax(h, h_kv, length):
    """Three consecutive steps from a cache holding ``length`` rows (0 =
    first token on an empty cache; the last case ends on the final
    row)."""
    rng = np.random.default_rng(100 * h_kv + length)
    b = 2
    jc, tc = _caches(rng, b, h_kv, length)
    tcs = {'kernel': tc, 'plain': tdec.DecodeCache(
        tc.k.clone(), tc.v.clone(), tc.length)}
    jcs = {'xla': jc, 'kernel': jc}
    for _ in range(3):
        q, kn, vn = (_rand(rng, b, h, 1, D), _rand(rng, b, h_kv, 1, D),
                     _rand(rng, b, h_kv, 1, D))
        want = {}
        for impl in jcs:
            kw = dict(interpret=True) if impl == 'kernel' else {}
            jcs[impl], out = jdec.decode_step(
                jnp.asarray(q), jcs[impl], jnp.asarray(kn), jnp.asarray(vn),
                impl=impl, **kw)
            want[impl] = np.asarray(out)
        for impl in tcs:
            tcs[impl], got = tdec.decode_step(
                torch.from_numpy(q), tcs[impl], torch.from_numpy(kn),
                torch.from_numpy(vn), impl=impl)
            for ref in want.values():
                np.testing.assert_allclose(got.numpy(), ref, **TOL)
            assert tcs[impl].length == int(jcs['xla'].length)
            for ref in jcs.values():
                np.testing.assert_array_equal(tcs[impl].k.numpy(),
                                              np.asarray(ref.k))
                np.testing.assert_array_equal(tcs[impl].v.numpy(),
                                              np.asarray(ref.v))


@pytest.mark.parametrize('impl', ['kernel', 'plain'])
def test_overflow_raises_and_writes_nothing(impl):
    rng = np.random.default_rng(7)
    _, tc = _caches(rng, 1, 2, T_MAX)
    before = tc.k.clone()
    x = torch.ones((1, 2, 1, D))
    with pytest.raises(ValueError, match='overflow'):
        tdec.decode_step(x, tc, x, x, impl=impl)
    assert torch.equal(tc.k, before)


def test_flash_decode_mixed_fill_matches_jax():
    """Per-row fill: mid-cache, the last row, a first token, a frozen
    row that appends nothing, and an empty row (output exactly 0)."""
    rng = np.random.default_rng(3)
    b, h, h_kv = 5, 4, 2
    valid_to = np.array([6, T_MAX - 1, 0, 9, -1], np.int32)
    append_at = np.array([6, T_MAX - 1, 0, -1, -1], np.int32)
    q, kn, vn = (_rand(rng, b, h, 1, D), _rand(rng, b, h_kv, 1, D),
                 _rand(rng, b, h_kv, 1, D))
    ck, cv = _rand(rng, b, h_kv, T_MAX, D), _rand(rng, b, h_kv, T_MAX, D)
    want, wk, wv, _, _ = jax_flash_decode(
        *(jnp.asarray(x) for x in (q, kn, vn, ck, cv, valid_to, append_at)),
        interpret=True)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got, gk, gv = flash_decode(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), tk,
        tv, torch.from_numpy(valid_to), torch.from_numpy(append_at))
    assert gk is tk and gv is tv                     # appended in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(wv))
    assert not got[4].any()
    # Only the appended rows changed.
    changed = np.nonzero((tk.numpy() != ck).any(axis=(1, 3)))
    assert sorted(zip(*changed)) == [(0, 6), (1, T_MAX - 1), (2, 0)]


@pytest.mark.parametrize('kw', [
    dict(window=4), dict(alibi_slopes=[0.5] * 4), dict(qk_quant='int8'),
    dict(axis_name='seq'), dict(segment_ids=np.zeros((1, T_MAX))),
])
def test_unported_decode_knobs_raise(kw):
    _, tc = _caches(np.random.default_rng(0), 1, 4, 2)
    x = torch.zeros((1, 4, 1, D))
    with pytest.raises(NotImplementedError):
        tdec.decode_step(x, tc, x, x, **kw)
