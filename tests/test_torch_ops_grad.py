# -*- coding: utf-8 -*-
"""
The port's differentiable distributed matmuls (``ops/ops.py``: the three
``torch.autograd.Function``s) on a 4-rank gloo group against the
reference package's ``custom_vjp`` operators through ``shard_map`` on a
4-device ``seq_mesh`` of the CPU devices: for a seeded cotangent weight
``S``, the output and ``∇ sum(op(L, R) · S)`` for both operands, every
op × offset × impl of ``tests/test_ops_grad.py``, the corrected
LeftTranspose left-gradient ``dA = nt(B, dOut)`` against its analytic
value, and multi-head 4-D operands. Inputs are float32 from numpy.

Tolerance: atol = rtol = 1e-5 (the reference's own).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from torch_dist import GlooGroup

from distributed_dot_product_tpu.ops.ops import (
    matmul_all, matmul_nt, matmul_tn,
)
from distributed_dot_product_tpu.parallel.mesh import seq_mesh

WORLD, LENGTH, DIM = 4, 5, 7
T = WORLD * LENGTH
TOL = dict(rtol=1e-5, atol=1e-5)

DIST = {'nt': matmul_nt, 'all': matmul_all, 'tn': matmul_tn}
SHAPES = {'nt': ((T, DIM), (T, DIM)), 'all': ((T, T), (T, DIM)),
          'tn': ((T, T), (T, DIM))}
OUT = {'nt': lambda l, r: (*l.shape[:-1], r.shape[-2]),
       'all': lambda l, r: (*l.shape[:-1], r.shape[-1]),
       'tn': lambda l, r: (*l.shape[:-2], l.shape[-1], r.shape[-1])}


@pytest.fixture(scope='module')
def group(tmp_path_factory):
    g = GlooGroup(WORLD, str(tmp_path_factory.mktemp('gloo') / 'store'))
    yield g
    g.close()


@pytest.fixture(scope='module')
def mesh():
    return seq_mesh(WORLD)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jax_grads(mesh, op, left, right, cot, offset, impl):
    spec = P(*([None] * (left.ndim - 2) + ['seq', None]))
    dist = jax.shard_map(partial(DIST[op], offset=offset, impl=impl),
                         mesh=mesh, in_specs=(spec, spec), out_specs=spec,
                         check_vma=False)
    out = dist(left, right)
    grads = jax.grad(lambda l, r: jnp.sum(dist(l, r) * cot),
                     argnums=(0, 1))(left, right)
    return [np.asarray(t) for t in (out, *grads)]


def _check(group, mesh, op, left, right, offset, impl, seed):
    cot = _rand(seed, *OUT[op](left, right))
    want = _jax_grads(mesh, op, left, right, cot, offset, impl)
    for got in group.run('ops_grad', op, left, right, cot, offset, impl):
        for name, a, w in zip(('out', 'd_left', 'd_right'), got, want):
            np.testing.assert_allclose(a, w, err_msg=name, **TOL)
    return want


@pytest.mark.parametrize('op', ['nt', 'all', 'tn'])
@pytest.mark.parametrize('offset', [2, 3, None])
@pytest.mark.parametrize('impl', ['allgather', 'ring'])
def test_vjp_matches_jax_custom_vjp(group, mesh, op, offset, impl):
    lshape, rshape = SHAPES[op]
    _check(group, mesh, op, _rand(0, *lshape), _rand(1, *rshape), offset,
           impl, 2)


def test_left_transpose_grad_is_the_corrected_one(group, mesh):
    """For ``out = AᵀB`` the left cotangent is ``B·dOutᵀ`` (the reference
    package's fix of the original ``nt(dOut, B)``)."""
    left, right = _rand(3, T, T), _rand(4, T, DIM)
    cot = _rand(5, T, DIM)
    for got in group.run('ops_grad', 'tn', left, right, cot, 2,
                         'allgather'):
        np.testing.assert_allclose(got[1], right @ cot.T, **TOL)


@pytest.mark.parametrize('op', ['nt', 'all', 'tn'])
def test_4d_grads(group, mesh, op):
    """Multi-head ``(B, H, T/N, ·)`` operands, the attention path's."""
    lshape, rshape = SHAPES[op]
    _check(group, mesh, op, _rand(6, 2, 3, *lshape),
           _rand(7, 2, 3, *rshape), 2, 'allgather', 8)
