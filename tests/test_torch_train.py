# -*- coding: utf-8 -*-
"""
The port's training path against the reference package, on the CPU, in
float32 at a small size (vocab 64, dim 32, 4 heads, 2 layers, T ≤ 48),
inputs made by numpy from a seed and weights converted from the
reference's params (``attn_state_from_jax`` / ``lm_state_from_jax``, which
also map the reference's gradient trees):

- ``DistributedDotProductAttn.forward`` (flash, causal, RoPE, GQA on and
  off): output and parameter gradients against the reference module with
  ``distributed=False``; the 'full' path and a masked flash forward;
  the flash module on a 2-rank gloo group against the local module;
- ``lm_targets`` with segments and ``pad_id``;
- ``TransformerLM.forward`` logits and ``nll_sum`` (a chunk that does not
  divide T, and unchunked): values and parameter gradients;
- ``remat=True`` and ``remat=False`` give the same gradients;
- two steps of ``make_lm_train_step`` with ``torch.optim.Adam`` against
  two steps of ``jax.value_and_grad`` + ``optax.adam``;
- ``guard=True`` skips the update on a non-finite loss.

Tolerance: max |got − want| ≤ REL · max |want| per tensor, REL = 1e-5
(float32 rounding of different reduction orders; a few layers deep the
chunked float32 loss and the softmax backward reorder sums, nothing
more). After two Adam steps the parameters are held norm-wise,
‖got − want‖ ≤ REL · ‖want‖ per tensor: the second update divides the
averaged gradient by its root mean square, and where two consecutive
gradients nearly cancel that ratio magnifies their float32 rounding in
single elements (the zero-initialised final LayerNorm bias misses the
max-norm bound by a few per cent at a learning rate of 1e-2). That
magnified error scales with the learning rate; the test runs the
README's 3e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_dot_product_tpu.models.attention import (
    DistributedDotProductAttn as JaxAttn,
)
from distributed_dot_product_tpu.models.lm import (
    TransformerLM as JaxLM, lm_targets as jax_lm_targets,
)
from distributed_dot_product_tpu_torch import (
    DistributedDotProductAttn, TransformerLM, attn_state_from_jax,
    flash_attention, flash_attention_dkv, flash_attention_dq,
    lm_state_from_jax, lm_targets, make_lm_train_step,
)

REL = 1e-5
VOCAB, DIM, HEADS, LAYERS = 64, 32, 4, 2


def _close(got, want, rel=REL, what=''):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (
        what, err, np.abs(want).max())


def _close_state(got, want, rel=REL, normwise=False):
    assert got.keys() == want.keys()
    for name in want:
        if not normwise:
            _close(got[name], want[name], rel, name)
            continue
        a, w = got[name].detach().numpy(), np.asarray(want[name])
        assert a.shape == w.shape, name
        assert np.linalg.norm(a - w) <= rel * np.linalg.norm(w), name


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# (num_kv_heads, causal, use_rope)
ATTN_CASES = {'mha_causal_rope': (None, True, True),
              'gqa_causal_rope': (2, True, True),
              'mha_full': (None, False, False)}


@pytest.mark.parametrize('case', sorted(ATTN_CASES))
def test_attention_forward_and_grads_match_jax(case):
    kv_heads, causal, use_rope = ATTN_CASES[case]
    rng = np.random.default_rng(len(case))
    b, t = 2, 37
    keys, queries, values, g = (
        rng.standard_normal((b, t, DIM), dtype=np.float32)
        for _ in range(4))
    kw = dict(key_dim=DIM, num_heads=HEADS, num_kv_heads=kv_heads,
              causal=causal, use_rope=use_rope, softmax_impl='flash')
    jm = JaxAttn(distributed=False, **kw)
    xs = [jnp.asarray(a) for a in (keys, queries, values)]
    params = jm.init(jax.random.key(2), *xs)

    def loss(p):
        return jnp.sum(jm.apply(p, *xs) * g)
    want_out = jm.apply(params, *xs)
    want_grads = jax.grad(loss)(params)

    port = DistributedDotProductAttn(device='cpu', **kw)
    port.load_state_dict(attn_state_from_jax(_np(params)))
    out = port(*(torch.from_numpy(a) for a in (keys, queries, values)))
    _close(out, want_out, what='out')
    (out * torch.from_numpy(g)).sum().backward()
    _close_state({n: p.grad for n, p in port.named_parameters()},
                 attn_state_from_jax(_np(want_grads)))


def test_attention_forward_refuses_unported_knobs():
    """Dropout is ported now: with a seed the module matches the
    reference module (``distributed=False``, path ``()``: no salt) on the
    same seed, and without one it refuses (the port has no flax rng);
    the 'full' path and a masked flash forward match the reference too."""
    x = torch.zeros((1, 8, DIM))
    mod = DistributedDotProductAttn(DIM, num_heads=HEADS, device='cpu',
                                    softmax_impl='flash', dropout_rate=0.1)
    with pytest.raises(ValueError, match='dropout_seed'):
        mod(x, x, x)
    rng = np.random.default_rng(21)
    xs = [rng.standard_normal((1, 8, DIM)).astype(np.float32)
          for _ in range(3)]
    mask = np.tril(np.ones((1, 8, 8), bool), k=-1)
    for kw, m, seed in ((dict(softmax_impl='full'), None, None),
                        (dict(softmax_impl='flash'), mask, None),
                        (dict(softmax_impl='flash', dropout_rate=0.3), None,
                         11)):
        jm = JaxAttn(DIM, num_heads=HEADS, distributed=False, **kw)
        jx = [jnp.asarray(a) for a in xs]
        params = jm.init(jax.random.key(4), *jx)
        want = jm.apply(params, *jx, None if m is None else jnp.asarray(m),
                        dropout_seed=seed)
        port = DistributedDotProductAttn(DIM, num_heads=HEADS, device='cpu',
                                         distributed=False, **kw)
        port.load_state_dict(attn_state_from_jax(_np(params)))
        got = port(*(torch.from_numpy(a) for a in xs),
                   None if m is None else torch.from_numpy(m),
                   dropout_seed=seed)
        _close(got, want, what=kw['softmax_impl'])


def test_attention_forward_refuses_a_multi_rank_group(tmp_path):
    """The flash module now runs on a multi-rank group: on a 2-rank gloo
    group its gathered output and rank-summed gradients equal the local
    module's on the global tensors."""
    from torch_dist import GlooGroup
    rng = np.random.default_rng(22)
    keys, queries, values, g = (
        rng.standard_normal((2, 16, DIM)).astype(np.float32)
        for _ in range(4))
    kw = dict(key_dim=DIM, num_heads=HEADS, softmax_impl='flash',
              causal=True, use_rope=True)
    local = DistributedDotProductAttn(device='cpu', distributed=False, **kw)
    state = {k: v.detach().numpy() for k, v in local.state_dict().items()}
    out = local(*(torch.from_numpy(a) for a in (keys, queries, values)))
    (out * torch.from_numpy(g)).sum().backward()
    group = GlooGroup(2, str(tmp_path / 'store'))
    try:
        res = group.run('module_fwd_grad', kw, state, keys, queries, values,
                        None, g)
    finally:
        group.close()
    for got_out, grads, _, _ in res:
        _close(got_out, out.detach().numpy(), what='out')
        for name, p in local.named_parameters():
            _close(grads[name], p.grad.numpy(), what=name)


def test_lm_targets_match_jax():
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 6, (3, 20), dtype=np.int32)
    seg = np.sort(rng.integers(0, 3, (3, 20)), axis=-1).astype(np.int32)
    for kw in (dict(), dict(segment_ids=seg), dict(pad_id=0),
               dict(segment_ids=seg, pad_id=0)):
        want = np.asarray(jax_lm_targets(
            jnp.asarray(tokens), **{k: (jnp.asarray(v) if k == 'segment_ids'
                                        else v) for k, v in kw.items()}))
        got = lm_targets(torch.from_numpy(tokens),
                         **{k: (torch.from_numpy(v) if k == 'segment_ids'
                                else v) for k, v in kw.items()})
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def _lm_pair(seed, t=40, remat=False):
    jm = JaxLM(vocab_size=VOCAB, dim=DIM, num_heads=HEADS, n_layers=LAYERS,
               attn_kwargs=dict(distributed=False))
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, VOCAB, (2, t), dtype=np.int32)
    targets = np.array(jax_lm_targets(jnp.asarray(tokens)))
    params = jm.init(jax.random.key(seed), jnp.asarray(tokens))
    port = TransformerLM(VOCAB, DIM, HEADS, n_layers=LAYERS, remat=remat,
                         device='cpu')
    port.load_state_dict(lm_state_from_jax(_np(params)))
    return jm, params, port, tokens, targets


def test_lm_forward_logits_match_jax():
    jm, params, port, tokens, _ = _lm_pair(4)
    want = jm.apply(params, jnp.asarray(tokens))
    _close(port(torch.from_numpy(tokens)), want, what='logits')


@pytest.mark.parametrize('chunk', [16, None])
def test_lm_nll_sum_value_and_grads_match_jax(chunk):
    jm, params, port, tokens, targets = _lm_pair(5)

    def loss(p):
        s, c = jm.apply(p, jnp.asarray(tokens), jnp.asarray(targets),
                        chunk=chunk, method='nll_sum')
        return s / c, (s, c)
    (_, (want_s, want_c)), want_g = jax.value_and_grad(
        loss, has_aux=True)(params)

    s, c = port.nll_sum(torch.from_numpy(tokens), torch.from_numpy(targets),
                        chunk=chunk)
    assert s.dtype == c.dtype == torch.float32
    assert float(c) == float(want_c) == 2 * 39
    _close(s, want_s, what='nll sum')
    (s / c).backward()
    _close_state({n: p.grad for n, p in port.named_parameters()},
                 lm_state_from_jax(_np(want_g)))


def test_remat_gives_the_same_gradients():
    grads = []
    for remat in (False, True):
        _, _, port, tokens, targets = _lm_pair(6, remat=remat)
        s, c = port.nll_sum(torch.from_numpy(tokens),
                            torch.from_numpy(targets), chunk=16)
        (s / c).backward()
        grads.append({n: p.grad for n, p in port.named_parameters()})
    for name in grads[0]:
        torch.testing.assert_close(grads[1][name], grads[0][name],
                                   rtol=0, atol=0)


def test_two_adam_steps_match_jax():
    lr, chunk = 3e-4, 16            # the README's Adam learning rate
    jm, params, port, tokens, targets = _lm_pair(7, remat=True)
    opt = optax.adam(lr)
    opt_state = opt.init(params)

    def loss(p):
        s, c = jm.apply(p, jnp.asarray(tokens), jnp.asarray(targets),
                        chunk=chunk, method='nll_sum')
        return s / jnp.maximum(c, 1.0)
    want_losses = []
    for _ in range(2):
        value, grads = jax.value_and_grad(loss)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        want_losses.append(float(value))

    optimizer = torch.optim.Adam(port.parameters(), lr=lr,
                                 betas=(0.9, 0.999), eps=1e-8)
    step = make_lm_train_step(port, optimizer, loss_chunk=chunk)
    batch = (torch.from_numpy(tokens), torch.from_numpy(targets))
    losses = [float(step(batch)) for _ in range(2)]
    np.testing.assert_allclose(losses, want_losses, rtol=REL)
    assert losses[1] < losses[0]
    _close_state(port.state_dict(), lm_state_from_jax(_np(params)),
                 normwise=True)


def test_guarded_step_skips_non_finite_update():
    _, _, port, tokens, targets = _lm_pair(8)
    optimizer = torch.optim.Adam(port.parameters(), lr=1e-2)
    step = make_lm_train_step(port, optimizer, loss_chunk=None, guard=True)
    batch = (torch.from_numpy(tokens), torch.from_numpy(targets))
    rec = step(batch)
    assert set(rec) == {'loss', 'bad_step', 'grad_norm'}
    assert not bool(rec['bad_step']) and torch.isfinite(rec['grad_norm'])

    with torch.no_grad():
        port.stack.blocks[0].mlp_in.weight[0, 0] = float('nan')
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    rec = step(batch)
    assert bool(rec['bad_step']) and not torch.isfinite(rec['loss'])
    for name, p in port.named_parameters():
        assert torch.allclose(p.detach(), before[name], rtol=0, atol=0,
                              equal_nan=True), name


def test_cpu_train_step_launches_no_kernel():
    for fn in (flash_attention, flash_attention_dq, flash_attention_dkv):
        fn.launches = 0
    _, _, port, tokens, targets = _lm_pair(9, t=24, remat=True)
    step = make_lm_train_step(port, torch.optim.Adam(port.parameters()),
                              loss_chunk=8)
    step((torch.from_numpy(tokens), torch.from_numpy(targets)))
    assert (flash_attention.launches, flash_attention_dq.launches,
            flash_attention_dkv.launches) == (0, 0, 0)
