# -*- coding: utf-8 -*-
"""
Explicit positions and the zigzag ring on the port against the reference
package, on the same seeded float32 inputs (numpy). The CPU runs each
kernel's plain version, the arithmetic K1–K4 are held to on the card.

- ``flash_attention(positions=...)`` with a zigzag fold's row and column
  positions, alone and with a window, ALiBi, dropout, int8 scoring and
  the bounded mode, against the reference kernel (Pallas in interpret
  mode), forward and VJP;
- ``ring_attention(layout='zigzag')`` on gloo groups of 2 and 4 ranks,
  inputs permuted by ``zigzag_indices`` and the output permuted back,
  against the reference kernel on the global tensors and against the
  port's contiguous ring, forward and gradients: causal, ALiBi, a dense
  mask (rows permuted, columns global) with a fully masked row that must
  give exactly 0, dropout (whose mask keys on global positions, so the
  zigzag run draws the contiguous run's mask), packed segments; and the
  ALiBi case on 4 ranks against the reference's own zigzag ring under
  ``shard_map``;
- the module (``softmax_impl='online'``, ``ring_layout='zigzag'``,
  causal, RoPE at the zigzag positions, ALiBi, GQA) on 4 ranks against
  the reference module under ``apply_seq_parallel`` on the permuted
  inputs, and against its own contiguous twin after the permutation.

Tolerances (float32, different reduction orders): forward ≤ 2e-5
absolute, gradients ≤ 5e-5 absolute; module outputs and gradients ≤
1e-5 of the largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from torch_dist import GlooGroup

from distributed_dot_product_tpu.models.attention import (
    DistributedDotProductAttn as JaxAttn, apply_seq_parallel,
)
from distributed_dot_product_tpu.models.ring_attention import (
    ring_attention as jax_ring_attention,
)
from distributed_dot_product_tpu.ops.pallas_attention import (
    flash_attention as jax_flash_attention,
)
from distributed_dot_product_tpu.parallel.mesh import seq_mesh
from distributed_dot_product_tpu_torch import attn_state_from_jax
from distributed_dot_product_tpu_torch.models.ring_attention import (
    _layout_positions, zigzag_indices,
)
from distributed_dot_product_tpu_torch.ops.flash_attention import (
    flash_attention,
)

FWD_ATOL, GRAD_ATOL = 2e-5, 5e-5
B, H, D = 2, 2, 16
SLOPES = (0.5, 0.0625)


@pytest.fixture(scope='module')
def groups(tmp_path_factory):
    made = {}

    def get(world):
        if world not in made:
            made[world] = GlooGroup(
                world, str(tmp_path_factory.mktemp(f'gloo{world}') / 'store'))
        return made[world]
    yield get
    for g in made.values():
        g.close()


def _rand(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _fold_positions(world, tn, shard, owner):
    """A zigzag fold's ``(pos_q, pos_k)``: this shard's rows against the
    owner's columns."""
    return tuple(_layout_positions('zigzag', i, world, tn).numpy()
                 for i in (shard, owner))


# name: (world, shard, owner, window, ALiBi, dropout rate, int8, mode)
POSITIONS = {
    'past_and_future_halves': (4, 1, 2, None, False, 0.0, False, 'exact'),
    'diagonal': (2, 1, 1, None, False, 0.0, False, 'exact'),
    'window_alibi': (4, 2, 0, 12, True, 0.0, False, 'exact'),
    'dropout_int8_alibi': (4, 0, 3, None, True, 0.2, True, 'exact'),
    'bounded': (4, 3, 1, 20, False, 0.0, False, 'bounded'),
}


@pytest.mark.parametrize('case', sorted(POSITIONS))
def test_flash_positions_match_jax(case):
    """Forward (≤ 2e-5) and VJP (≤ 5e-5) with a zigzag fold's positions
    (causal off: the positions are the causal mask) against the reference
    kernel."""
    world, shard, owner, window, alibi, rate, int8, mode = POSITIONS[case]
    tn = 16
    pq, pk = _fold_positions(world, tn, shard, owner)
    rng = np.random.default_rng(sorted(POSITIONS).index(case))
    q, k, v, g = (_rand(rng, B, H, tn, D) for _ in range(4))
    kw = dict(window=window, softmax_mode=mode,
              alibi_slopes=SLOPES if alibi else None,
              qk_quant='int8' if int8 else None, dropout_rate=rate,
              dropout_seed=5 if rate else None)

    def jfn(q_, k_, v_):
        return jax_flash_attention(q_, k_, v_, positions=(
            jnp.asarray(pq), jnp.asarray(pk)), **kw)
    want, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (q, k, v)))
    want_g = vjp(jnp.asarray(g))
    xs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = flash_attention(*xs, positions=(torch.from_numpy(pq),
                                          torch.from_numpy(pk)), **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=FWD_ATOL, rtol=0)
    (got * torch.from_numpy(g)).sum().backward()
    for name, x, w in zip(('dq', 'dk', 'dv'), xs, want_g):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w),
                                   atol=GRAD_ATOL, rtol=0, err_msg=name)


def _segments(rng, t):
    """``(B, 1, t)`` packed-document ids, 3 documents a row."""
    seg = np.zeros((B, 1, t), np.int32)
    for i in range(B):
        seg[i, 0, np.sort(rng.choice(np.arange(1, t), 2, replace=False))] = 1
    return np.cumsum(seg, axis=-1, dtype=np.int32)


# name: (ring kwargs, dense mask with a fully masked row, segments,
#        against the reference's zigzag ring too)
RING = {
    'causal': (dict(), False, False, False),
    'alibi': (dict(alibi_slopes=SLOPES), False, False, True),
    'dense_mask': (dict(), True, False, False),
    'dropout': (dict(dropout_rate=0.2, dropout_seed=9), False, False, False),
    'segments_alibi_window': (dict(alibi_slopes=SLOPES, window=11), False,
                              True, False),
}


@pytest.mark.parametrize('world', [2, 4])
@pytest.mark.parametrize('case', sorted(RING))
def test_zigzag_ring_matches_jax_and_contiguous(groups, case, world):
    kw, dense, segs, jax_ring = RING[case]
    kw = dict(kw, causal=True)
    t = 8 * world
    rng = np.random.default_rng(10 * world + sorted(RING).index(case))
    q, k, v, g = (_rand(rng, B, H, t, D) for _ in range(4))
    mask = seg = None
    if dense:
        mask = rng.random((B, 1, t, t)) < 0.3
        mask[:, :, 5] = True                  # one fully masked row
    if segs:
        seg = _segments(rng, t)
    idx = zigzag_indices(t, world).numpy()
    inv = np.argsort(idx)

    jkw = dict(kw, alibi_slopes=None if 'alibi_slopes' not in kw
               else jnp.asarray(kw['alibi_slopes']))

    def jfn(q_, k_, v_):
        return jax_flash_attention(
            q_, k_, v_, None if mask is None else jnp.asarray(mask),
            segment_ids=None if seg is None else jnp.asarray(seg), **jkw)
    want, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (q, k, v)))
    want_g = vjp(jnp.asarray(g))

    def perm(a, axis=-2):
        return None if a is None else np.take(a, idx, axis=axis)
    zig = groups(world).run('attn_op', 'ring', *(perm(a) for a in (q, k, v)),
                            perm(mask), perm(seg, -1), perm(g),
                            dict(kw, layout='zigzag'))
    contiguous = groups(world).run('attn_op', 'ring', q, k, v, mask, seg, g,
                                   kw)[0]
    for res in zig:
        res = [np.take(a, inv, axis=-2) for a in res]
        for name, a, w, c in zip(('out', 'dq', 'dk', 'dv'), res,
                                 (want, *want_g), contiguous):
            tol = FWD_ATOL if name == 'out' else GRAD_ATOL
            np.testing.assert_allclose(a, np.asarray(w), atol=tol, rtol=0,
                                       err_msg=name)
            np.testing.assert_allclose(a, c, atol=tol, rtol=0,
                                       err_msg=f'{name} vs contiguous')
        if dense:
            assert not res[0][:, :, 5].any()     # exactly 0
    if jax_ring and world == 4:
        spec = P(None, None, 'seq', None)
        ring = jax.shard_map(
            lambda a, b_, c: jax_ring_attention(a, b_, c, layout='zigzag',
                                                **jkw),
            mesh=seq_mesh(world), in_specs=(spec,) * 3, out_specs=spec,
            check_vma=False)
        ref = np.asarray(ring(*(jnp.asarray(perm(a)) for a in (q, k, v))))
        np.testing.assert_allclose(zig[0][0], ref, atol=FWD_ATOL, rtol=0)


def _close(got, want, what=''):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= 1e-5 * max(np.abs(want).max(), 1e-30), (what, err)


def _state(params):
    return {k: v.numpy() for k, v in attn_state_from_jax(
        jax.tree.map(np.asarray, params)).items()}


def test_module_zigzag_alibi_matches_jax(groups):
    """The online module on the zigzag ring (RoPE at the zigzag
    positions, ALiBi, GQA) on 4 ranks: the reference module on the same
    permuted inputs, and the contiguous twin after the permutation."""
    world, t, dim, heads = 4, 32, 32, 4
    kw = dict(key_dim=dim, num_heads=heads, num_kv_heads=2, causal=True,
              use_rope=True, softmax_impl='online',
              alibi_slopes=(0.5, 0.25, 0.125, 0.0625))
    rng = np.random.default_rng(31)
    keys, queries, values, g = (_rand(rng, B, t, dim) for _ in range(4))
    idx = zigzag_indices(t, world).numpy()
    inv = np.argsort(idx)
    zk, zq, zv, zg = (np.take(a, idx, axis=1) for a in (keys, queries,
                                                         values, g))
    jm = JaxAttn(ring_layout='zigzag', **kw)
    xs = [jnp.asarray(a) for a in (zk, zq, zv)]
    params = jm.init(jax.random.key(3), *xs, None)
    mesh = seq_mesh(world)

    def loss(p, k_, q_, v_):
        out = apply_seq_parallel(jm, p, mesh, k_, q_, v_)
        return jnp.sum(out * zg), out
    # The output and the gradients from one trace of the sharded module.
    (_, want), grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True)(params, *xs)
    want = np.asarray(want)
    want_pg, *want_xg = grads
    want_pg = _state(want_pg)
    state = _state(params)
    zig = groups(world).run('module_fwd_grad', dict(kw, ring_layout='zigzag'),
                            state, zk, zq, zv, None, zg)
    twin = groups(world).run('module_fwd_grad', kw, state, keys, queries,
                             values, None, g)[0]
    for out, pgrads, xgrads, _ in zig:
        _close(out, want, 'out')
        _close(np.take(out, inv, axis=1), twin[0], 'out vs contiguous')
        for name in want_pg:
            _close(pgrads[name], want_pg[name], name)
            _close(pgrads[name], twin[1][name], f'{name} vs contiguous')
        for name, a, w, c in zip(('d_keys', 'd_queries', 'd_values'),
                                 xgrads, want_xg, twin[2]):
            _close(a, w, name)
            _close(np.take(a, inv, axis=1), c, f'{name} vs contiguous')
