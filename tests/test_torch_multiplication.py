# -*- coding: utf-8 -*-
"""
The port's distributed matmuls (``ops/functions.py``) on a 4-rank gloo
group against the reference package's ``distributed_matmul_*_global`` on
a 4-device ``seq_mesh`` of the CPU devices, the six-mode oracle of
``tests/test_multiplication.py``: integer-valued float32 operands, so
every partial sum is exact and the results must be BITWISE equal — to
each other and to the local numpy product — for both impls
(``'allgather'`` and ``'ring'``), with offsets that divide T/N, that do
not (3), that exceed the shard (1000) and ``None`` (one full gather).
"""

import numpy as np
import pytest

from torch_dist import GlooGroup

from distributed_dot_product_tpu.ops.functions import (
    distributed_matmul_all_global, distributed_matmul_nt_global,
    distributed_matmul_tn_global,
)
from distributed_dot_product_tpu.parallel.mesh import seq_mesh

WORLD, LENGTH, DIM = 4, 4, 6
T = WORLD * LENGTH


@pytest.fixture(scope='module')
def group(tmp_path_factory):
    g = GlooGroup(WORLD, str(tmp_path_factory.mktemp('gloo') / 'store'))
    yield g
    g.close()


@pytest.fixture(scope='module')
def mesh():
    return seq_mesh(WORLD)


def create_tensor(*shape):
    n = int(np.prod(shape))
    return ((np.arange(n) % 50) - 17).astype(np.float32).reshape(shape)


def gt(kind, left, right):
    if kind == 'nt':
        return left @ right.swapaxes(-1, -2)
    if kind == 'tn':
        return left.swapaxes(-1, -2) @ right
    return left @ right


JAX = {'nt': distributed_matmul_nt_global, 'tn': distributed_matmul_tn_global,
       'all': distributed_matmul_all_global}
# mode: (kind, left global shape, right global shape)
MODES = {
    'nt': ('nt', (T, DIM), (T, DIM)),
    'nt-3d': ('nt', (2, T, DIM), (2, T, DIM)),
    'nt-4d': ('nt', (2, 3, T, DIM), (2, 3, T, DIM)),
    'tn': ('tn', (T, T), (T, DIM)),
    'tn-4d': ('tn', (2, 3, T, T), (2, 3, T, DIM)),
    'all': ('all', (T, T), (T, DIM)),
    'all-4d': ('all', (2, 3, T, T), (2, 3, T, DIM)),
}
OFFSETS = [2, 3, 1000, None]
CASES = ([(m, o) for m in sorted(MODES) if MODES[m][0] != 'tn'
          for o in OFFSETS]
         + [(m, 'n/a') for m in sorted(MODES) if MODES[m][0] == 'tn'])


def _run(group, mesh, mode, **kw):
    kind, lshape, rshape = MODES[mode]
    left, right = create_tensor(*lshape), create_tensor(*rshape)
    got = group.run('matmul_global', kind, left, right, kw)
    want = np.asarray(JAX[kind](left, right, mesh=mesh, **kw))
    return got, want, gt(kind, left, right)


@pytest.mark.parametrize('mode,offset', CASES)
def test_parity_bitwise(group, mesh, mode, offset):
    kw = {} if offset == 'n/a' else {'offset': offset}
    got, want, expected = _run(group, mesh, mode, **kw)
    assert (want == expected).all()
    for res in got:                      # every rank holds the global result
        assert res.shape == expected.shape
        assert (res == want).all()


@pytest.mark.parametrize('mode', ['nt', 'nt-3d', 'nt-4d', 'all', 'all-4d'])
def test_ring_impl_parity(group, mesh, mode):
    got, want, expected = _run(group, mesh, mode, impl='ring')
    assert (want == expected).all()
    for res in got:
        assert (res == want).all()


def test_reference_errors(group):
    """``offset < 1`` and a tn width the group does not divide raise the
    reference's ValueErrors on every rank."""
    left, right = create_tensor(T, T - 1), create_tensor(T, DIM)
    for raised in group.run('matmul_errors', left, right):
        assert all(msg is not None for msg in raised), raised
        assert 'offset must be a positive chunk size' in raised[0]
        assert 'divisible' in raised[2]


def test_single_rank_degenerates_to_local():
    """One rank (no process group): the products are the local ones."""
    import torch

    from distributed_dot_product_tpu_torch.ops.functions import (
        distributed_matmul_nt_global,
    )
    from distributed_dot_product_tpu_torch.parallel.mesh import (
        seq_mesh as port_seq_mesh,
    )
    left, right = create_tensor(T, DIM), create_tensor(T, DIM)
    out = distributed_matmul_nt_global(torch.from_numpy(left),
                                       torch.from_numpy(right), offset=5,
                                       mesh=port_seq_mesh(1))
    assert (out.numpy() == gt('nt', left, right)).all()
