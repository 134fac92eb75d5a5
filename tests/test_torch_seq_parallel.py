# -*- coding: utf-8 -*-
"""
The port's sequence-parallel layer on a 4-rank gloo group
(``tests/torch_dist.py``) against the reference package on a 4-device
``seq_mesh`` of the CPU devices (Pallas in interpret mode), float32,
inputs and weights made by numpy / converted from the reference's params
(``attn_state_from_jax``), B 2 × T 32, key_dim 32, 4 heads:

- ``DistributedDotProductAttn`` for ``softmax_impl`` 'full', 'flash',
  'online' and 'ulysses' (with a dense mask, with causal + RoPE + GQA,
  bounded flash, the ring matmul impl): the output and the parameter
  and input gradients of ``sum(out · g)`` against the reference's
  ``apply_seq_parallel``, and the distributed output against the port's
  own ``distributed=False`` module on the global tensors;
- ``ring_attention`` with flash folds and plain folds against the local
  oracle;
- one ``make_train_step`` step on a 2 × 2 data × seq group against the
  reference's ``make_train_step`` on ``data_seq_mesh(2, 2)``: the loss
  and every parameter after the step, with SGD (which shows the
  gradient's scale) and with Adam.

Tolerance: max |got − want| ≤ 1e-5 · max |want| per tensor (float32
rounding of different reduction orders); a train step's parameter update
``after − before`` the same on its own scale plus the float32 rounding of
the two parameters it is taken from (2 ulp of the largest).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_dist import GlooGroup

from distributed_dot_product_tpu.models.attention import (
    DistributedDotProductAttn as JaxAttn, apply_seq_parallel,
)
from distributed_dot_product_tpu.models.ring_attention import (
    zigzag_indices as jax_zigzag_indices,
)
from distributed_dot_product_tpu.ops.pallas_attention import (
    flash_attention as jax_flash_attention,
)
from distributed_dot_product_tpu.parallel.mesh import (
    data_seq_mesh, seq_mesh,
)
from distributed_dot_product_tpu.train import make_train_step
from distributed_dot_product_tpu_torch import (
    DistributedDotProductAttn, attn_state_from_jax,
)
from distributed_dot_product_tpu_torch.models.ring_attention import (
    local_attention_reference, ring_attention, zigzag_indices,
)

WORLD, B, T, DIM, HEADS = 4, 2, 32, 32, 4
MOD = dict(key_dim=DIM, num_heads=HEADS)
REL = 1e-5


@pytest.fixture(scope='module')
def group(tmp_path_factory):
    g = GlooGroup(WORLD, str(tmp_path_factory.mktemp('gloo') / 'store'))
    yield g
    g.close()


def _close(got, want, rel=REL, what=''):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (what, err)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _state(params):
    return {k: v.numpy() for k, v in attn_state_from_jax(_np(params)).items()}


def _mask(seed, empty_rows):
    m = np.random.default_rng(seed).random((B, T, T)) < 0.3
    if empty_rows:
        m[:, 5] = True                 # one fully masked row
    return m


# name: (module kwargs, mask kind: None | 'rows' (random) | 'empty' (with
# a fully masked row, which 'full' turns to NaN as the reference does))
CASES = {
    'full_mask': (dict(softmax_impl='full', offset=3), 'rows'),
    'full_causal_gqa_rope': (dict(softmax_impl='full', num_kv_heads=2,
                                  causal=True, use_rope=True, offset=5),
                             None),
    'full_ring_impl': (dict(softmax_impl='full', impl='ring'), 'rows'),
    'flash_mask': (dict(softmax_impl='flash'), 'empty'),
    'flash_causal_gqa_rope': (dict(softmax_impl='flash', num_kv_heads=2,
                                   causal=True, use_rope=True), None),
    'flash_bounded': (dict(softmax_impl='flash',
                           flash_softmax_mode='bounded'), 'rows'),
    'online_mask': (dict(softmax_impl='online'), 'empty'),
    'online_causal_gqa_rope': (dict(softmax_impl='online', num_kv_heads=2,
                                    causal=True, use_rope=True), 'rows'),
    'ulysses_mask': (dict(softmax_impl='ulysses'), 'empty'),
    'ulysses_causal_rope': (dict(softmax_impl='ulysses', causal=True,
                                 use_rope=True,
                                 flash_softmax_mode='bounded'), None),
}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, DIM)).astype(np.float32)
            for _ in range(4)]


@pytest.mark.parametrize('case', sorted(CASES))
def test_module_matches_jax_and_local(group, case):
    kw, mask_kind = CASES[case]
    keys, queries, values, g = _inputs(len(case))
    mask = None if mask_kind is None else _mask(len(case),
                                                mask_kind == 'empty')
    jm = JaxAttn(key_dim=DIM, num_heads=HEADS, **kw)
    xs = [jnp.asarray(a) for a in (keys, queries, values)]
    jmask = None if mask is None else jnp.asarray(mask)
    params = jm.init(jax.random.key(len(case)), *xs, jmask)
    mesh = seq_mesh(WORLD)

    def loss(p, k, q, v):
        return jnp.sum(apply_seq_parallel(jm, p, mesh, k, q, v, jmask) * g)
    want_out = np.asarray(apply_seq_parallel(jm, params, mesh, *xs, jmask))
    want_pg, *want_xg = jax.grad(loss, argnums=(0, 1, 2, 3))(params, *xs)
    want_pg = _state(want_pg)

    state = _state(params)
    res = group.run('module_fwd_grad', {**MOD, **kw}, state, keys, queries, values,
                    mask, g)
    for out, pgrads, xgrads, applied in res:
        _close(out, want_out, what='out')
        np.testing.assert_array_equal(applied, out)
        for name in want_pg:
            _close(pgrads[name], want_pg[name], what=name)
        for name, a, w in zip(('d_keys', 'd_queries', 'd_values'), xgrads,
                              want_xg):
            _close(a, w, what=name)

    # Distributed equals local: the port's distributed=False module on the
    # global tensors.
    local = DistributedDotProductAttn(key_dim=DIM, num_heads=HEADS,
                                      distributed=False, device='cpu', **kw)
    local.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    with torch.no_grad():
        ref = local(*(torch.from_numpy(a) for a in (keys, queries, values)),
                    None if mask is None else torch.from_numpy(mask))
    _close(res[0][0], ref.numpy(), what='distributed vs local')
    if mask_kind == 'empty':
        assert not res[0][0][:, 5].any() or kw['softmax_impl'] == 'full'


def test_full_path_gives_nan_on_a_fully_masked_row(group):
    """The 'full' path keeps the reference's NaN on a row with no key."""
    kw = dict(softmax_impl='full')
    keys, queries, values, g = _inputs(3)
    mask = _mask(3, True)
    jm = JaxAttn(key_dim=DIM, num_heads=HEADS, **kw)
    params = jm.init(jax.random.key(3), keys, queries, values, mask)
    out = group.run('module_fwd_grad', {**MOD, **kw}, _state(params), keys,
                    queries,
                    values, mask, g)[0][0]
    assert np.isnan(out[:, 5]).all() and np.isfinite(np.delete(out, 5, 1)
                                                     ).all()


@pytest.mark.parametrize('causal', [False, True])
def test_ring_folds_match_the_local_oracle(group, causal):
    rng = np.random.default_rng(11 + causal)
    q, k, v = (rng.standard_normal((B, 2, T, 8)).astype(np.float32)
               for _ in range(3))
    mask = rng.random((B, 1, T, T)) < 0.3
    mask[:, :, 7] = True
    ref = local_attention_reference(*(torch.from_numpy(a) for a in (
        q, k, v)), torch.from_numpy(mask), causal=causal)
    tq_, tk_, tv_ = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    want_g = torch.autograd.grad(local_attention_reference(
        tq_, tk_, tv_, torch.from_numpy(mask), causal=causal).sum(),
        (tq_, tk_, tv_))
    for res in group.run('ring_impls', q, k, v, mask, causal):
        for impl in ('flash', 'xla'):
            out, *grads = res[impl]
            _close(out, ref.numpy(), what=f'{impl} out')
            for n, a, w in zip(('dq', 'dk', 'dv'), grads, want_g):
                _close(a, w.numpy(), what=f'{impl} {n}')


def test_unported_ring_layouts_and_knobs_raise():
    """The zigzag layout and ALiBi still raise; the window, dropout and
    int8 scoring are ported (on one rank the ring is one diagonal fold:
    the reference's flash kernel on the same call), and the plain fold
    refuses the kernel-only knobs as the reference's does."""
    x = torch.zeros((1, 2, 8, 8))
    for kw in (dict(layout='zigzag', causal=True),
               dict(alibi_slopes=[0.5, 0.25], causal=True)):
        with pytest.raises(NotImplementedError, match='ROADMAP'):
            ring_attention(x, x, x, **kw)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        DistributedDotProductAttn(DIM, num_heads=HEADS, causal=True,
                                  softmax_impl='online',
                                  ring_layout='zigzag', device='cpu')
    for kw in (dict(window=4), dict(dropout_rate=0.1, dropout_seed=1),
               dict(qk_quant='int8')):
        with pytest.raises(ValueError, match="block_impl='flash'|mask=None"):
            ring_attention(x, x, x, torch.zeros((1, 2, 8, 8), dtype=bool),
                           causal=True, block_impl='xla', **kw)
    rng = np.random.default_rng(13)
    q, k, v = (rng.standard_normal((1, 2, 16, 8)).astype(np.float32)
               for _ in range(3))
    for kw in (dict(window=4, causal=True),
               dict(dropout_rate=0.1, dropout_seed=1),
               dict(qk_quant='int8', causal=True)):
        want = np.asarray(jax_flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
        got = ring_attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
        _close(got.numpy(), want, what=str(kw))
    np.testing.assert_array_equal(zigzag_indices(32, 4).numpy(),
                                  np.asarray(jax_zigzag_indices(32, 4)))


# (softmax_impl, optimizer, learning rate)
TRAIN = {'full_sgd': ('full', 'sgd', 0.05), 'flash_sgd': ('flash', 'sgd',
                                                          0.05),
         'online_adam': ('online', 'adam', 1e-3),
         'ulysses_adam': ('ulysses', 'adam', 1e-3)}


@pytest.mark.parametrize('case', sorted(TRAIN))
def test_train_step_matches_jax_on_2x2(group, case):
    impl, opt, lr = TRAIN[case]
    kw = dict(softmax_impl=impl, offset=3, causal=impl == 'online')
    rng = np.random.default_rng(len(case))
    x = rng.standard_normal((B * 2, T, DIM)).astype(np.float32)
    target = 0.1 * rng.standard_normal((B * 2, T, DIM)).astype(np.float32)
    mask = rng.random((B * 2, T, T)) < 0.2
    jm = JaxAttn(key_dim=DIM, num_heads=HEADS, **kw)
    params = jm.init(jax.random.key(5), x, x, x, mask)
    optimizer = optax.sgd(lr) if opt == 'sgd' else optax.adam(lr)
    step = make_train_step(jm, optimizer, data_seq_mesh(2, 2),
                           data_axis='data', donate=False)
    new_params, _, want_loss = step(params, optimizer.init(params),
                                    (x, x, x, mask, target))
    want = _state(new_params)
    before = _state(params)

    res = group.run('train_step', {**MOD, **kw}, before, (x, x, x, mask, target), opt,
                    lr)
    for loss, state in res:
        np.testing.assert_allclose(loss, float(want_loss), rtol=REL)
        for name in want:
            # The update itself, after - before, on its own scale: REL of
            # its largest entry, plus the float32 rounding of the two
            # parameters it is the difference of (2 ulp of the largest).
            got_u, want_u = state[name] - before[name], want[name] - \
                before[name]
            err = np.abs(got_u - want_u).max()
            limit = (REL * np.abs(want_u).max()
                     + 2 * np.finfo(np.float32).eps
                     * np.abs(want[name]).max())
            assert err <= limit, (name, err, limit)


def test_guarded_train_step_skips_a_non_finite_update(group):
    kw = dict(softmax_impl='flash')
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B * 2, T, DIM)).astype(np.float32)
    jm = JaxAttn(key_dim=DIM, num_heads=HEADS, **kw)
    state = _state(jm.init(jax.random.key(1), x, x, x, None))
    bad = dict(state)
    bad['keys_proj.weight'] = bad['keys_proj.weight'].copy()
    bad['keys_proj.weight'][0, 0] = np.nan
    for good_or_bad, st in (('good', state), ('bad', bad)):
        for rec, after in group.run('train_step', {**MOD, **kw}, st,
                                    (x, x, x, None, np.zeros_like(x)), 'sgd',
                                    0.1, True):
            assert set(rec) == {'loss', 'bad_step', 'grad_norm'}
            assert bool(rec['bad_step']) == (good_or_bad == 'bad')
            same = all(np.array_equal(after[n], st[n], equal_nan=True)
                       for n in st)
            assert same == (good_or_bad == 'bad')
