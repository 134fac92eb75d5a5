# -*- coding: utf-8 -*-
"""
``dryrun_multichip``'s four stages beyond the paper's strategies — the
causal sliding-window flash module (``window``), GQA + RoPE over the ring
with packed segments, in-kernel dropout and int8 scoring (``gqa_ring``),
a 2-block ``TransformerStack`` (``stack``) and the ``TransformerLM``'s
train step on a ``(tokens, targets, segment_ids)`` batch then greedy
generation (``lm``) — on the port's 4-rank gloo harness
(``tests/torch_dist.py``) as a 2 × 2 data × seq group, against the
reference package's steps from the same recipe (``__graft_entry__.py``)
on a 2 × 2 virtual CPU mesh (Pallas in interpret mode). Widths follow
the recipe (dim 64, 4 heads); B 4 × T 16.

Both sides take one step with an optimizer that leaves the parameters
alone: the reference's captures the psum'd gradient as its state, the
port's is SGD at lr 0, so every parameter's ``.grad`` is the summed
gradient. Tolerance: the loss within 1e-5 relative, each gradient max
|got − want| ≤ 1e-5 · max |want| (float32 rounding of different
reduction orders). Greedy tokens are compared equal.

Also pinned: the per-layer dropout salt — each port attention module's
``path`` equals the path the same module has in the reference's flax
tree (read from the reference's own modules), and a stack with dropout,
scanned and unrolled, gives the reference's output for the same seed —
and ``rope_seq_parallel`` on the group against the reference's ``rope``.
"""

import jax
import jax.numpy as jnp
import flax.linen as nn
import numpy as np
import optax
import pytest
import torch

from torch_dist import GlooGroup

from distributed_dot_product_tpu import (
    DistributedDotProductAttn as JaxAttn, TransformerLM as JaxLM,
    TransformerStack as JaxStack, greedy_generate as jax_greedy_generate,
    lm_targets as jax_lm_targets,
)
from distributed_dot_product_tpu.ops.rope import rope as jax_rope
from distributed_dot_product_tpu.parallel.mesh import data_seq_mesh
from distributed_dot_product_tpu.train import (
    make_lm_train_step as jax_make_lm_train_step,
    make_train_step as jax_make_train_step,
)
from distributed_dot_product_tpu_torch import (
    DistributedDotProductAttn, TransformerLM, TransformerStack,
    attn_state_from_jax, lm_state_from_jax, stack_state_from_jax,
)

WORLD, DIM, HEADS, B, T, VOCAB = 4, 64, 4, 4, 16, 32
REL = 1e-5


@pytest.fixture(scope='module')
def group(tmp_path_factory):
    g = GlooGroup(WORLD, str(tmp_path_factory.mktemp('gloo') / 'store'))
    yield g
    g.close()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rel=REL, what=''):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (what, err)


def _capture():
    """An optax transformation that updates nothing and keeps the
    gradient it was given as its state: the step's psum'd gradient."""
    def init(params):
        return jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree.map(jnp.zeros_like, grads), grads
    return optax.GradientTransformation(init, update)


def _segments():
    """The recipe's two packed documents per row."""
    return np.broadcast_to((np.arange(T, dtype=np.int32) * 2 // T),
                           (B, T)).copy()


# stage: (reference module constructor, port module kwargs, converter, batch
# has segments, dropout seed) — dryrun_multichip's configurations.
STAGES = {
    'window': (lambda: JaxAttn(key_dim=DIM, num_heads=HEADS,
                               softmax_impl='flash', causal=True, window=3),
               dict(key_dim=DIM, num_heads=HEADS, softmax_impl='flash',
                    causal=True, window=3),
               attn_state_from_jax, False, 0),
    'gqa_ring': (lambda: JaxAttn(key_dim=DIM, num_heads=HEADS,
                                 num_kv_heads=HEADS // 2, use_rope=True,
                                 causal=True, softmax_impl='online',
                                 qk_quant='int8', dropout_rate=0.1),
                 dict(key_dim=DIM, num_heads=HEADS, num_kv_heads=HEADS // 2,
                      use_rope=True, causal=True, softmax_impl='online',
                      qk_quant='int8', dropout_rate=0.1),
                 attn_state_from_jax, True, 1),
    'stack': (lambda: JaxStack(dim=DIM, num_heads=HEADS, n_layers=2,
                               attn_kwargs=dict(causal=True,
                                                softmax_impl='flash',
                                                use_rope=True)),
              dict(dim=DIM, num_heads=HEADS, n_layers=2,
                   attn_kwargs=dict(causal=True, softmax_impl='flash',
                                    use_rope=True)),
              stack_state_from_jax, False, 0),
}


@pytest.mark.parametrize('stage', sorted(STAGES))
def test_module_stage_matches_jax_on_2x2(group, stage):
    """One DP x SP step of the stage: the loss and every parameter's
    gradient against the reference's step. The stack stage is the port's
    fault repaired: its blocks now take the step's sequence group."""
    build, kw, convert, with_seg, seed = STAGES[stage]
    rng = np.random.default_rng(len(stage))
    x = rng.standard_normal((B, T, DIM)).astype(np.float32)
    target = np.zeros_like(x)
    batch = (x, x, x, None, target) + ((_segments(),) if with_seg else ())
    jm = build()
    params = jm.init(jax.random.key(3), x, x, x, None)
    optimizer = _capture()
    step = jax_make_train_step(jm, optimizer, data_seq_mesh(2, 2),
                               data_axis='data', donate=False)
    _, grads, want_loss = step(params, optimizer.init(params),
                               tuple(None if a is None else jnp.asarray(a)
                                     for a in batch), dropout_seed=seed)
    want = {k: v.numpy() for k, v in convert(_np(grads)).items()}
    state = {k: v.numpy() for k, v in convert(_np(params)).items()}
    for loss, got in group.run('flagship_step', stage, kw, state, batch,
                               seed):
        np.testing.assert_allclose(loss, float(want_loss), rtol=REL)
        assert set(got) == set(want)
        for name in want:
            _close(got[name], want[name], what=name)


def test_lm_stage_matches_jax_on_2x2(group):
    """The language model's DP x SP step on packed segments (targets built
    before sharding), then greedy generation with the same weights."""
    rng = np.random.default_rng(7)
    toks = rng.integers(0, VOCAB, (B, T)).astype(np.int32)
    seg = _segments()
    tgts = np.asarray(jax_lm_targets(jnp.asarray(toks), jnp.asarray(seg)))
    lm = JaxLM(vocab_size=VOCAB, dim=DIM, num_heads=HEADS, n_layers=2,
               scan_layers=True, remat=True)
    params = lm.init(jax.random.key(6), jnp.asarray(toks[:, :4]))
    optimizer = _capture()
    step = jax_make_lm_train_step(lm, optimizer, data_seq_mesh(2, 2),
                                  data_axis='data', donate=False,
                                  loss_chunk=8)
    _, grads, want_loss = step(params, optimizer.init(params),
                               tuple(jnp.asarray(a) for a in
                                     (toks, tgts, seg)))
    want = {k: v.numpy() for k, v in lm_state_from_jax(_np(grads)).items()}
    state = {k: v.numpy() for k, v in lm_state_from_jax(_np(params)).items()}
    want_gen = np.asarray(jax_greedy_generate(lm, params,
                                              jnp.asarray(toks[:, :4]),
                                              steps=3, t_max=T))
    kw = dict(vocab_size=VOCAB, dim=DIM, num_heads=HEADS, n_layers=2,
              remat=True)
    res = group.run('flagship_lm', kw, state, (toks, tgts, seg), toks[:, :4],
                    T)
    for loss, got, _ in res:
        np.testing.assert_allclose(loss, float(want_loss), rtol=REL)
        for name in want:
            _close(got[name], want[name], what=name)
    assert res[0][2].shape == (B, 3)
    np.testing.assert_array_equal(res[0][2], want_gen)


def _attn_paths(module, params, *args, method=None):
    """The flax path of every reference attention module ``__call__``
    while ``module`` runs."""
    paths = []

    def intercept(next_fun, a, kw, context):
        if (isinstance(context.module, JaxAttn)
                and context.method_name == '__call__'):
            paths.append(tuple(context.module.path))
        return next_fun(*a, **kw)
    with nn.intercept_methods(intercept):
        module.apply(params, *args, method=method)
    return paths


def test_dropout_salt_paths_are_the_references():
    """Each port attention module carries the path its reference twin
    has in the flax tree: ``()`` alone, ``block_i/attn`` unrolled,
    ``layers/block/attn`` scanned (every layer), under ``stack`` in the
    language model."""
    x = jnp.ones((1, 8, 16))
    kw = dict(distributed=False)
    a = JaxAttn(key_dim=16, num_heads=2, **kw)
    assert _attn_paths(a, a.init(jax.random.key(0), x, x, x), x, x, x) == \
        [DistributedDotProductAttn(16, num_heads=2, device='cpu').path]
    for scan in (False, True):
        s = JaxStack(dim=16, num_heads=2, n_layers=2, scan_layers=scan,
                     attn_kwargs=kw)
        want = _attn_paths(s, s.init(jax.random.key(0), x, x, x), x, x, x)
        port = TransformerStack(16, 2, n_layers=2, scan_layers=scan,
                                device='cpu')
        assert [blk.attn.path for blk in port.blocks] == want
    t = jnp.zeros((1, 8), jnp.int32)
    lm = JaxLM(vocab_size=32, dim=16, num_heads=2, n_layers=2,
               attn_kwargs=kw)
    want = _attn_paths(lm, lm.init(jax.random.key(0), t), t)
    port = TransformerLM(32, 16, 2, n_layers=2, device='cpu')
    assert [blk.attn.path for blk in port.stack.blocks] == want


@pytest.mark.parametrize('scan', [False, True], ids=['unrolled', 'scanned'])
def test_stack_dropout_matches_jax_for_one_seed(scan):
    """A stack with dropout on one seed gives the reference's output: the
    layers' masks (the path salt, and the scanned layout's layer salt)
    are the reference's."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    attn_kw = dict(distributed=False, softmax_impl='flash', causal=True,
                   dropout_rate=0.3)
    js = JaxStack(dim=32, num_heads=4, n_layers=3, scan_layers=scan,
                  attn_kwargs=attn_kw)
    jx = jnp.asarray(x)
    params = js.init(jax.random.key(2), jx, jx, jx, deterministic=True)
    want = js.apply(params, jx, jx, jx, dropout_seed=-77)
    same = js.apply(params, jx, jx, jx, dropout_seed=-76)
    port = TransformerStack(32, 4, n_layers=3, scan_layers=scan,
                            attn_kwargs=attn_kw, device='cpu')
    port.load_state_dict(stack_state_from_jax(_np(params)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), dropout_seed=-77)
    _close(got.numpy(), want, what='stack')
    assert np.abs(np.asarray(want) - np.asarray(same)).max() > 1e-3


def test_rope_seq_parallel_matches_jax_on_the_group(group):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, T, 16)).astype(np.float32)
    want = np.asarray(jax_rope(jnp.asarray(x), jnp.arange(T)))
    for got in group.run('rope_shards', x):
        _close(got, want, what='rope_seq_parallel')


def test_weights_carry_across_both_stack_layouts_and_gqa():
    """``stack_state_from_jax`` (scanned and unrolled) and
    ``attn_state_from_jax`` under GQA: every converted tensor is the
    reference's leaf (Dense kernels transposed back exactly), and the
    port's module gives the reference's output on the same input."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 32)).astype(np.float32)
    jx = jnp.asarray(x)
    kw = dict(distributed=False, softmax_impl='flash', causal=True,
              num_kv_heads=2)
    ja = JaxAttn(key_dim=32, num_heads=4, **kw)
    pa = ja.init(jax.random.key(1), jx, jx, jx)
    sa = attn_state_from_jax(_np(pa))
    assert sa['queries_proj.weight'].shape == (16, 32)
    for flax_name, port_name in (('queries', 'queries_proj'),
                                 ('values', 'values_proj')):
        np.testing.assert_array_equal(
            sa[f'{port_name}.weight'].numpy().T,
            np.asarray(pa['params'][flax_name]['kernel']))
    port = DistributedDotProductAttn(32, num_heads=4, device='cpu', **kw)
    port.load_state_dict(sa)
    with torch.no_grad():
        _close(port(*(torch.from_numpy(x),) * 3).numpy(),
               ja.apply(pa, jx, jx, jx), what='gqa attn')
    for scan in (False, True):
        js = JaxStack(dim=32, num_heads=4, n_layers=2, scan_layers=scan,
                      attn_kwargs=kw)
        ps = js.init(jax.random.key(2), jx, jx, jx)
        ss = stack_state_from_jax(_np(ps))
        tree = ps['params']
        blk1 = (jax.tree.map(lambda a: a[1], tree['layers']['block'])
                if scan else tree['block_1'])
        np.testing.assert_array_equal(
            ss['blocks.1.mlp_in.weight'].numpy().T,
            np.asarray(blk1['mlp_in']['kernel']))
        np.testing.assert_array_equal(ss['blocks.1.ln2.scale'].numpy(),
                                      np.asarray(blk1['ln2']['scale']))
        port = TransformerStack(32, 4, n_layers=2, scan_layers=scan,
                                attn_kwargs=kw, device='cpu')
        port.load_state_dict(ss)
        with torch.no_grad():
            _close(port(torch.from_numpy(x)).numpy(),
                   js.apply(ps, jx, jx, jx), what=f'stack scan={scan}')
