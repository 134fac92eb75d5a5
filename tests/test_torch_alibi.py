# -*- coding: utf-8 -*-
"""
ALiBi on the port against the reference package, on the same seeded
float32 inputs (numpy): the CPU runs each kernel's plain version, the
arithmetic the CUDA kernels K1/K3/K4 are held to on the card.

- ``flash_attention(alibi_slopes=...)`` against the reference's (Pallas
  in interpret mode), alone and composed with shard offsets, a window,
  GQA, dropout, int8 scoring and per-(batch, head) slopes, forward and
  VJP;
- ``ulysses_attention`` and the module (``flash``, ``ulysses``) with
  ALiBi on a gloo group of 4 against the reference module under
  ``apply_seq_parallel`` with converted parameters;
- a 2-layer ALiBi ``TransformerLM`` (``use_rope=False``): two Adam
  steps of ``make_lm_train_step`` against ``optax.adam``, and its greedy
  tokens against the reference's;
- the refusals the reference makes: ALiBi on ``'full'`` or without
  causal semantics, the zigzag layout off the ring.

Tolerances (float32, two reduction orders): forward ≤ 2e-5 absolute,
gradients ≤ 5e-5 absolute; module outputs and gradients ≤ 1e-5 of the
largest value; LM losses rtol 1e-5, parameters norm-wise 1e-5, tokens
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from torch_dist import GlooGroup

from distributed_dot_product_tpu.models.attention import (
    DistributedDotProductAttn as JaxAttn, apply_seq_parallel,
)
from distributed_dot_product_tpu.models.decode import (
    decode_attention as jax_decode_attention, init_cache as jax_init_cache,
)
from distributed_dot_product_tpu.models.lm import (
    TransformerLM as JaxLM, greedy_generate as jax_greedy_generate,
    lm_targets as jax_lm_targets,
)
from distributed_dot_product_tpu.models.ulysses_attention import (
    ulysses_attention as jax_ulysses_attention,
)
from distributed_dot_product_tpu.ops.pallas_attention import (
    flash_attention as jax_flash_attention,
)
from distributed_dot_product_tpu.parallel.mesh import seq_mesh
from distributed_dot_product_tpu_torch import (
    DistributedDotProductAttn, TransformerLM, attn_state_from_jax,
    greedy_generate, lm_state_from_jax, make_lm_train_step,
)
from distributed_dot_product_tpu_torch.models import decode as tdec
from distributed_dot_product_tpu_torch.ops.flash_attention import (
    flash_attention,
)

FWD_ATOL, GRAD_ATOL = 2e-5, 5e-5
WORLD, B, T, DIM, HEADS = 4, 2, 32, 32, 4


def slopes(h):
    """The classic geometric ALiBi slopes ``2^(-8i/h)``, i = 1..h."""
    return tuple(float(2.0 ** (-8.0 * i / h)) for i in range(1, h + 1))


@pytest.fixture(scope='module')
def group(tmp_path_factory):
    g = GlooGroup(WORLD, str(tmp_path_factory.mktemp('gloo') / 'store'))
    yield g
    g.close()


def _rand(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


# name: (q heads, kv heads, Tq, Tk, causal_offset, kv_offset, window,
#        dropout rate, int8, per-(batch, head) slopes)
FLASH = {
    'causal': (4, 4, 40, 40, 0, 0, None, 0.0, False, False),
    'shard_offsets': (4, 4, 24, 32, 40, 16, None, 0.0, False, False),
    'window': (4, 4, 40, 40, 8, 0, 12, 0.0, False, False),
    'gqa': (4, 2, 40, 40, 0, 0, None, 0.0, False, False),
    'dropout': (4, 4, 40, 40, 0, 0, None, 0.2, False, False),
    'int8': (4, 4, 40, 40, 0, 0, None, 0.0, True, False),
    'all_composed': (4, 2, 24, 48, 30, 8, 16, 0.2, True, False),
    'batch_head_slopes': (4, 4, 40, 40, 0, 0, None, 0.0, False, True),
}


@pytest.mark.parametrize('case', sorted(FLASH))
def test_flash_alibi_matches_jax(case):
    """Forward (≤ 2e-5) and VJP (≤ 5e-5) against the reference kernel."""
    hq, hkv, tq, tk, co, ko, window, rate, int8, per_bh = FLASH[case]
    rng = np.random.default_rng(sorted(FLASH).index(case))
    q, g = _rand(rng, B, hq, tq, 16), _rand(rng, B, hq, tq, 16)
    k, v = _rand(rng, B, hkv, tk, 16), _rand(rng, B, hkv, tk, 16)
    sl = np.asarray(slopes(hq), np.float32)
    if per_bh:
        sl = np.stack([sl, sl[::-1] * 0.5])
    kw = dict(causal=True, causal_offset=co, kv_offset=ko, window=window,
              qk_quant='int8' if int8 else None, dropout_rate=rate,
              dropout_seed=11 if rate else None)

    def jfn(q_, k_, v_):
        return jax_flash_attention(q_, k_, v_, alibi_slopes=jnp.asarray(sl),
                                   **kw)
    want, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (q, k, v)))
    want_g = vjp(jnp.asarray(g))
    xs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = flash_attention(*xs, alibi_slopes=torch.from_numpy(sl), **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=FWD_ATOL, rtol=0)
    (got * torch.from_numpy(g)).sum().backward()
    for name, x, w in zip(('dq', 'dk', 'dv'), xs, want_g):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w),
                                   atol=GRAD_ATOL, rtol=0, err_msg=name)


def test_ulysses_alibi_matches_jax(group):
    """``ulysses_attention`` with ALiBi (each rank's head chunk of the
    slopes) on 4 ranks against the reference's under ``shard_map``."""
    rng = np.random.default_rng(3)
    q, k, v, g = (_rand(rng, B, HEADS, T, 8) for _ in range(4))
    sl = slopes(HEADS)
    spec = P(None, None, 'seq', None)

    def jfn(q_, k_, v_):
        return jax.shard_map(
            lambda a, b_, c: jax_ulysses_attention(
                a, b_, c, axis_name='seq', causal=True,
                alibi_slopes=jnp.asarray(sl)),
            mesh=seq_mesh(WORLD), in_specs=(spec,) * 3, out_specs=spec,
            check_vma=False)(q_, k_, v_)
    want, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (q, k, v)))
    want_g = vjp(jnp.asarray(g))
    for res in group.run('attn_op', 'ulysses', q, k, v, None, None, g,
                         dict(causal=True, alibi_slopes=sl)):
        np.testing.assert_allclose(res[0], np.asarray(want), atol=FWD_ATOL,
                                   rtol=0)
        for name, a, w in zip(('dq', 'dk', 'dv'), res[1:], want_g):
            np.testing.assert_allclose(a, np.asarray(w), atol=GRAD_ATOL,
                                       rtol=0, err_msg=name)


def _close(got, want, what=''):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= 1e-5 * max(np.abs(want).max(), 1e-30), (what, err)


def _state(params):
    return {k: v.numpy() for k, v in attn_state_from_jax(
        jax.tree.map(np.asarray, params)).items()}


MODULES = {
    'flash_gqa_window': dict(softmax_impl='flash', num_kv_heads=2,
                             window=9),
    'ulysses': dict(softmax_impl='ulysses'),
}


@pytest.mark.parametrize('case', sorted(MODULES))
def test_module_alibi_matches_jax(group, case):
    """The module with ALiBi across 4 ranks: output, parameter gradients
    (summed over the ranks) and input gradients against the reference
    module under ``apply_seq_parallel``; ``'full'`` refuses ALiBi (see
    :func:`test_reference_refusals`)."""
    kw = dict(MODULES[case], causal=True, alibi_slopes=slopes(HEADS))
    rng = np.random.default_rng(sorted(MODULES).index(case) + 20)
    keys, queries, values, g = (_rand(rng, B, T, DIM) for _ in range(4))
    jm = JaxAttn(key_dim=DIM, num_heads=HEADS, **kw)
    xs = [jnp.asarray(a) for a in (keys, queries, values)]
    params = jm.init(jax.random.key(7), *xs, None)
    mesh = seq_mesh(WORLD)

    def loss(p, k_, q_, v_):
        out = apply_seq_parallel(jm, p, mesh, k_, q_, v_)
        return jnp.sum(out * g), out
    # The output and the gradients from one trace of the sharded module.
    (_, want), grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True)(params, *xs)
    want = np.asarray(want)
    want_pg, *want_xg = grads
    want_pg = _state(want_pg)
    res = group.run('module_fwd_grad',
                    dict(key_dim=DIM, num_heads=HEADS, **kw),
                    _state(params), keys, queries, values, None, g)
    for out, pgrads, xgrads, _ in res:
        _close(out, want, 'out')
        for name in want_pg:
            _close(pgrads[name], want_pg[name], name)
        for name, a, w in zip(('d_keys', 'd_queries', 'd_values'), xgrads,
                              want_xg):
            _close(a, w, name)


# -- the 2-layer ALiBi language model --------------------------------------

VOCAB, LAYERS, LM_HEADS = 64, 2, 4
LM_ATTN = dict(use_rope=False, alibi_slopes=slopes(LM_HEADS))


def _lm_pair(seed, t=40):
    jm = JaxLM(vocab_size=VOCAB, dim=DIM, num_heads=LM_HEADS,
               n_layers=LAYERS, attn_kwargs=dict(distributed=False,
                                                 **LM_ATTN))
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, VOCAB, (2, t), dtype=np.int32)
    targets = np.array(jax_lm_targets(jnp.asarray(tokens)))
    params = jm.init(jax.random.key(seed), jnp.asarray(tokens))
    port = TransformerLM(VOCAB, DIM, LM_HEADS, n_layers=LAYERS,
                         attn_kwargs=LM_ATTN, remat=True, device='cpu')
    port.load_state_dict(lm_state_from_jax(jax.tree.map(np.asarray,
                                                        params)))
    return jm, params, port, tokens, targets


def test_alibi_lm_two_adam_steps_match_jax():
    lr, chunk = 3e-4, 16
    jm, params, port, tokens, targets = _lm_pair(8)
    opt = optax.adam(lr)
    opt_state = opt.init(params)

    def loss(p):
        s, c = jm.apply(p, jnp.asarray(tokens), jnp.asarray(targets),
                        chunk=chunk, method='nll_sum')
        return s / jnp.maximum(c, 1.0)
    want = []
    for _ in range(2):
        value, grads = jax.value_and_grad(loss)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        want.append(float(value))
    optimizer = torch.optim.Adam(port.parameters(), lr=lr,
                                 betas=(0.9, 0.999), eps=1e-8)
    step = make_lm_train_step(port, optimizer, loss_chunk=chunk)
    batch = (torch.from_numpy(tokens), torch.from_numpy(targets))
    got = [float(step(batch)) for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    ref = lm_state_from_jax(jax.tree.map(np.asarray, params))
    for name, p in port.state_dict().items():
        a, w = p.numpy(), ref[name].numpy()
        assert np.linalg.norm(a - w) <= 1e-5 * np.linalg.norm(w), name


def test_alibi_lm_greedy_tokens_match_jax():
    b, n, steps, t_max = 2, 11, 6, 24
    jm, params, port, _, _ = _lm_pair(9)
    prompt = np.random.default_rng(9).integers(0, VOCAB, (b, n),
                                               dtype=np.int32)
    want = jax_greedy_generate(jm, params, jnp.asarray(prompt), steps,
                               t_max)
    got = greedy_generate(port, torch.from_numpy(prompt), steps, t_max)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- refusals ---------------------------------------------------------------

def _refusal(case):
    """``(reference call, port call)`` of a refused configuration."""
    x = np.zeros((1, 2, 8, 16), np.float32)
    mods = {
        'full_alibi': dict(softmax_impl='full', causal=True,
                           alibi_slopes=(0.5, 0.25)),
        'zigzag_flash': dict(softmax_impl='flash', causal=True,
                             ring_layout='zigzag'),
        'alibi_no_causal_module': dict(softmax_impl='flash',
                                       alibi_slopes=(0.5, 0.25)),
    }
    if case in mods:
        kw = dict(key_dim=16, num_heads=2, **mods[case])
        return (lambda: JaxAttn(**kw).init(
                    jax.random.key(0), *(jnp.zeros((1, 8, 16)),) * 3),
                lambda: DistributedDotProductAttn(device='cpu', **kw))
    if case == 'alibi_no_causal':
        kw = dict(alibi_slopes=[0.5, 0.25])
        return (lambda: jax_flash_attention(*(jnp.asarray(x),) * 3, **kw),
                lambda: flash_attention(*(torch.from_numpy(x),) * 3, **kw))
    if case == 'positions_with_causal':
        kw = dict(causal=True)
        return (lambda: jax_flash_attention(*(jnp.asarray(x),) * 3,
                                            positions=jnp.arange(8), **kw),
                lambda: flash_attention(*(torch.from_numpy(x),) * 3,
                                        positions=torch.arange(8), **kw))
    assert case == 'segments_without_seg_q'
    q = np.zeros((1, 2, 1, 16), np.float32)
    seg = np.zeros((1, 8), np.int32)
    jc = jax_init_cache(1, 2, 8, 16, dtype=jnp.float32)
    tc = tdec.init_cache(1, 2, 8, 16, dtype=torch.float32, device='cpu')
    return (lambda: jax_decode_attention(jnp.asarray(q), jc,
                                         segment_ids=jnp.asarray(seg)),
            lambda: tdec.decode_attention(torch.from_numpy(q), tc,
                                          segment_ids=torch.from_numpy(seg)))


@pytest.mark.parametrize('case', [
    'full_alibi', 'zigzag_flash', 'alibi_no_causal_module',
    'alibi_no_causal', 'positions_with_causal', 'segments_without_seg_q'])
def test_reference_refusals(case):
    """What the reference refuses with a ValueError, the port refuses
    alike: ALiBi on the 'full' path or without causal semantics, the
    zigzag layout off the ring, positions beside causal=True, segment ids
    without the query rows' ids."""
    jax_call, port_call = _refusal(case)
    with pytest.raises(ValueError):
        jax_call()
    with pytest.raises(ValueError):
        port_call()
