# -*- coding: utf-8 -*-
"""
The port's TransformerLM serving path against the reference package:
``convert.py`` turns the reference's params (scanned and unrolled
layouts) into the port's state; at vocab 64, dim 32, 4 heads, 2 layers
and t_max 32 the prefill logits match the reference within 1e-4 and
``greedy_generate`` emits identical tokens. The layer pieces (RoPE,
OwnedDense, LayerNorm, the tanh gelu) are held against their reference
counterparts too. Float32 throughout, inputs made by numpy from a seed.
"""

import numpy as np
import flax.linen as fnn
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from distributed_dot_product_tpu.models.dense import (
    OwnedDense as JaxOwnedDense,
)
from distributed_dot_product_tpu.models.lm import (
    TransformerLM as JaxLM, greedy_generate as jax_greedy_generate,
)
from distributed_dot_product_tpu.ops.rope import rope as jax_rope
from distributed_dot_product_tpu_torch import (
    LayerNorm, OwnedDense, TransformerLM, greedy_generate, lm_state_from_jax,
    rope,
)

VOCAB, DIM, HEADS, LAYERS, T_MAX = 64, 32, 4, 2, 32


def test_rope_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 24, 16), dtype=np.float32)
    pos = 1000 + np.arange(24)
    want = np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(pos)))
    got = rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        rope(torch.from_numpy(x), offset=7).numpy(),
        np.asarray(jax_rope(jnp.asarray(x), offset=7)), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize('use_bias', [True, False])
def test_owned_dense_matches_jax(use_bias):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 16), dtype=np.float32)
    mod = JaxOwnedDense(24, use_bias=use_bias)
    params = mod.init(jax.random.key(0), jnp.asarray(x))
    if use_bias:   # a nonzero bias, so the check covers it
        params = {'params': {**params['params'],
                             'bias': jnp.asarray(rng.standard_normal(24),
                                                 jnp.float32)}}
    want = np.asarray(mod.apply(params, jnp.asarray(x)))
    dense = OwnedDense(16, 24, use_bias=use_bias, device='cpu')
    dense.weight.data = torch.from_numpy(
        np.asarray(params['params']['kernel']).T.copy())
    if use_bias:
        dense.bias.data = torch.from_numpy(
            np.array(params['params']['bias']))
    got = dense(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_layernorm_and_gelu_match_flax():
    rng = np.random.default_rng(2)
    x = 3.0 + rng.standard_normal((4, 7, 32), dtype=np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    bias = rng.standard_normal(32).astype(np.float32)
    want = np.asarray(fnn.LayerNorm().apply(
        {'params': {'scale': jnp.asarray(scale), 'bias': jnp.asarray(bias)}},
        jnp.asarray(x)))
    ln = LayerNorm(32, device='cpu')
    ln.scale.data, ln.bias.data = torch.from_numpy(scale), \
        torch.from_numpy(bias)
    np.testing.assert_allclose(ln(torch.from_numpy(x)).detach().numpy(),
                               want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        F.gelu(torch.from_numpy(x), approximate='tanh').numpy(),
        np.asarray(fnn.gelu(jnp.asarray(x))), atol=1e-5, rtol=1e-5)


def _port_from(params):
    model = TransformerLM(VOCAB, DIM, HEADS, n_layers=LAYERS, device='cpu')
    model.load_state_dict(lm_state_from_jax(params))
    return model


@pytest.mark.parametrize('scan_layers', [True, False])
def test_prefill_and_greedy_match_jax(scan_layers):
    # Prompt shape unique to each case: the reference's compiled
    # generation programs are cached process-wide by shape.
    b, n, steps = 2, 9 if scan_layers else 10, 6
    jm = JaxLM(vocab_size=VOCAB, dim=DIM, num_heads=HEADS, n_layers=LAYERS,
               scan_layers=scan_layers)
    prompt = np.random.default_rng(4).integers(0, VOCAB, (b, n),
                                               dtype=np.int32)
    params = jm.init(jax.random.key(5), jnp.asarray(prompt))
    _, want_logits = jm.apply(params, jnp.asarray(prompt),
                              jm.make_decode_caches(b, T_MAX),
                              method='prefill')
    want_tokens = jax_greedy_generate(jm, params, jnp.asarray(prompt),
                                      steps, T_MAX)

    model = _port_from(jax.tree.map(np.asarray, params))
    with torch.inference_mode():
        _, logits = model.prefill(torch.from_numpy(prompt),
                                  model.make_decode_caches(b, T_MAX))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=1e-4, rtol=1e-4)
    tokens = greedy_generate(model, torch.from_numpy(prompt), steps, T_MAX)
    assert tokens.dtype == torch.int32 and tokens.shape == (b, steps)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_tokens))


def test_scanned_and_unrolled_convert_to_the_same_state():
    jm = JaxLM(vocab_size=VOCAB, dim=DIM, num_heads=HEADS, n_layers=LAYERS,
               scan_layers=True)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.key(6), jnp.zeros((1, 4), jnp.int32)))['params']
    layers = params['stack']['layers']['block']
    unrolled = {**params, 'stack': {
        f'block_{i}': jax.tree.map(lambda a, i=i: a[i], layers)
        for i in range(LAYERS)}}
    a, b = lm_state_from_jax(params), lm_state_from_jax(unrolled)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    # Strict load: every port parameter is covered, nothing extra.
    _port_from({'params': params})


def test_greedy_generate_validates_steps_and_capacity():
    model = TransformerLM(VOCAB, DIM, HEADS, n_layers=1, device='cpu')
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match='steps'):
        greedy_generate(model, toks, 0, 8)
    with pytest.raises(ValueError, match='t_max'):
        greedy_generate(model, toks, 6, 8)
    assert greedy_generate(model, toks, 5, 8).shape == (1, 5)   # 4+5-1 = 8
