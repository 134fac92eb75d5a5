# -*- coding: utf-8 -*-
"""
Cached inference follows the module's training-time knobs (the port's
fault of ``ROADMAP.md`` §3.1, repaired), and the stack refuses what the
reference refuses (§3.2):

- ``prefill`` with ``window=2`` and with ``qk_quant='int8'`` against the
  reference module's ``prefill`` at the shapes the fault was measured at
  (a local causal flash module, key_dim 32, 2 heads, x (1, 6, 32), a
  cache of 8), and against the port's own forward;
- windowed ``decode``, both ``decode_impl``s and a GQA module, against
  the reference module's ``decode`` step by step;
- ``make_decode_cache``, ``prefill`` and ``decode`` of an int8 module
  (the int8 K mirror) against the reference module's;
- ``TransformerStack(remat=True, scan_layers=False)`` and an unknown
  ``remat_policy`` raise the reference's ``ValueError``; a known policy
  name builds.

Float32, atol = rtol = 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_dot_product_tpu import DistributedDotProductAttn as JaxAttn
from distributed_dot_product_tpu_torch import (
    DistributedDotProductAttn, TransformerLM, TransformerStack,
    attn_state_from_jax,
)
from distributed_dot_product_tpu_torch.models import decode as tdec
from distributed_dot_product_tpu_torch.ops.flash_attention import (
    quantize_rows,
)

TOL = dict(atol=1e-5, rtol=1e-5)
PROBE = dict(key_dim=32, num_heads=2, causal=True, distributed=False,
             softmax_impl='flash')


def _pair(kw, seed=0, t=6):
    """The reference module with its parameters, the port's with the same
    parameters, and a seeded input (1, t, key_dim)."""
    x = np.random.default_rng(seed).standard_normal(
        (1, t, kw['key_dim'])).astype(np.float32)
    jm = JaxAttn(**kw)
    jx = jnp.asarray(x)
    params = jm.init(jax.random.key(seed), jx, jx, jx)
    port = DistributedDotProductAttn(device='cpu', **kw)
    port.load_state_dict(attn_state_from_jax(jax.tree.map(np.asarray,
                                                          params)))
    return jm, params, port, x


@pytest.mark.parametrize('knob', [dict(window=2), dict(qk_quant='int8')],
                         ids=['window', 'int8'])
def test_prefill_follows_the_module_knobs(knob):
    kw = dict(PROBE, **knob)
    jm, params, port, x = _pair(kw)
    jx = jnp.asarray(x)
    _, want = jm.apply(params, jx, jx, jx, jm.make_decode_cache(1, 8),
                       method='prefill')
    # Prefill scores in int8 over a plain cache too (the mirror only
    # serves the decode step).
    cache = tdec.init_cache(1, 2, 8, 16, dtype=torch.float32, device='cpu')
    tx = torch.from_numpy(x)
    with torch.no_grad():
        cache, got = port.prefill(tx, tx, tx, cache)
        own = port(tx, tx, tx, deterministic=True)
    assert cache.length == 6
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), own.numpy(), **TOL)


@pytest.mark.parametrize('impl', ['kernel', 'plain'])
@pytest.mark.parametrize('kv', [2, 1])
def test_windowed_decode_matches_jax(impl, kv):
    kw = dict(key_dim=32, num_heads=2, num_kv_heads=kv, causal=True,
              distributed=False, window=3)
    jm, params, port, x = _pair(kw, seed=kv, t=9)
    port.decode_impl = impl
    jc = jm.make_decode_cache(1, 12)
    tc = port.make_decode_cache(1, 12)
    jx = jnp.asarray(x[:, :2])
    jc, _ = jm.apply(params, jx, jx, jx, jc, method='prefill')
    with torch.no_grad():
        tx = torch.from_numpy(x[:, :2])
        tc, _ = port.prefill(tx, tx, tx, tc)
        for t in range(2, 9):
            jx = jnp.asarray(x[:, t:t + 1])
            jc, want = jm.apply(params, jx, jx, jx, jc, method='decode')
            tx = torch.from_numpy(x[:, t:t + 1])
            tc, got = port.decode(tx, tx, tx, tc)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       err_msg=f't={t}', **TOL)
    # The cache holds projections of two libraries' GEMMs: float32 close.
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=1e-6,
                               rtol=0)


def test_int8_decode_and_cache_raise():
    """Both raised until the int8 K mirror was ported. Now an int8
    module's ``make_decode_cache`` allocates the mirror, and ``prefill``
    then ``decode`` steps on both ``decode_impl``s match the reference
    module's: outputs within the tolerance, the mirror equal to the
    cache re-quantized."""
    kw = dict(PROBE, qk_quant='int8')
    jm, params, port, x = _pair(kw, t=7)
    for impl in ('kernel', 'plain'):
        port.decode_impl = impl
        jc = jm.make_decode_cache(1, 8)
        tc = port.make_decode_cache(1, 8)
        for name in ('k', 'v', 'k_q', 'k_scale'):
            want = np.asarray(getattr(jc, name))
            got = getattr(tc, name)
            assert got.shape == want.shape and not got.any()
            assert str(got.dtype).endswith(str(want.dtype))
        jx, tx = jnp.asarray(x[:, :4]), torch.from_numpy(x[:, :4])
        jc, want = jm.apply(params, jx, jx, jx, jc, method='prefill')
        with torch.no_grad():
            tc, got = port.prefill(tx, tx, tx, tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for t in range(4, 7):
            jx, tx = jnp.asarray(x[:, t:t + 1]), torch.from_numpy(x[:, t:t + 1])
            jc, want = jm.apply(params, jx, jx, jx, jc, method='decode')
            with torch.no_grad():
                tc, got = port.decode(tx, tx, tx, tc)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       err_msg=f'{impl} t={t}', **TOL)
        assert tc.length == int(jc.length) == 7
        # The filled mirror rows are the port's own cache rows quantized,
        # bit for bit; against the reference's it differs only as the two
        # libraries' float32 projections do.
        ki, sk = quantize_rows(tc.k[:, :, :7])
        assert torch.equal(tc.k_q[:, :, :7], ki)
        assert torch.equal(tc.k_scale[:, :, :7], sk)
        np.testing.assert_allclose(tc.k_scale.numpy(),
                                   np.asarray(jc.k_scale), rtol=1e-6,
                                   atol=0)
        assert np.abs(tc.k_q.numpy().astype(int)
                      - np.asarray(jc.k_q).astype(int)).max() <= 1


def test_stack_remat_and_policy_refusals():
    with pytest.raises(ValueError, match='scan_layers=True'):
        TransformerStack(16, 2, remat=True, scan_layers=False, device='cpu')
    with pytest.raises(ValueError, match='checkpoint_policies'):
        TransformerStack(16, 2, remat=True, scan_layers=True,
                         remat_policy='no_such_policy', device='cpu')
    stack = TransformerStack(16, 2, remat=True, scan_layers=True,
                             remat_policy='dots_saveable', device='cpu')
    assert stack.remat_policy == 'dots_saveable'
    # The language model scans its layers by default: remat builds.
    assert TransformerLM(32, 16, 2, n_layers=1, remat=True,
                         device='cpu').stack.remat
