# -*- coding: utf-8 -*-
"""
The port's process layer (``utils/comm.py``) and meshes
(``parallel/mesh.py``) on a 4-rank gloo group (``tests/torch_dist.py``),
against numpy oracles of what each collective must return — the
contract of ``tests/test_comm.py`` carried from a device mesh to process
groups: rank / world / main-process introspection, the mesh shapes of
``seq_mesh`` and ``data_seq_mesh`` (rank ``d·seq + s`` at data index
``d``, seq index ``s``), shard / unshard round trips, and every
collective the sequence-parallel layers call.
"""

import numpy as np
import pytest
import torch

from torch_dist import GlooGroup

from distributed_dot_product_tpu_torch.parallel import mesh as pm
from distributed_dot_product_tpu_torch.utils import comm

WORLD = 4


@pytest.fixture(scope='module')
def group(tmp_path_factory):
    g = GlooGroup(WORLD, str(tmp_path_factory.mktemp('gloo') / 'store'))
    yield g
    g.close()


@pytest.fixture(scope='module')
def contract(group):
    return group.run('comm_contract')


def _x(rank):
    return np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * rank


def test_rank_world_and_transport(contract):
    for r, res in enumerate(contract):
        assert (res['rank'], res['world'], res['axis_size']) == (r, WORLD,
                                                                 WORLD)
        assert res['main'] == (r == 0)
        assert res['transport'] == 'gloo'


def test_all_gather_and_reduce(contract):
    xs = [_x(r) for r in range(WORLD)]
    for res in contract:
        np.testing.assert_array_equal(res['gather'], np.concatenate(xs, 0))
        np.testing.assert_array_equal(res['gather_last'],
                                      np.concatenate(xs, -1))
        np.testing.assert_array_equal(res['stacked'], np.stack(xs))
        np.testing.assert_array_equal(res['sum'], sum(xs))


def test_reduce_scatter_keeps_this_ranks_block(contract):
    for r, res in enumerate(contract):
        # Every rank sent blocks x_src * (blk + 1); rank r keeps block r.
        want = sum(_x(src) * (r + 1) for src in range(WORLD))
        np.testing.assert_array_equal(res['scatter'], want)


def test_ring_shift_both_directions(contract):
    for r, res in enumerate(contract):
        # direction -1 (the reference's (i, i-1) permutation): rank r
        # receives rank r+1's tensor.
        np.testing.assert_array_equal(res['left'], _x((r + 1) % WORLD))
        np.testing.assert_array_equal(res['right'], _x((r - 1) % WORLD))


def test_all_to_all_is_tiled(contract):
    base = np.arange(WORLD * 2 * 3, dtype=np.float32).reshape(WORLD * 2, 3,
                                                              1)
    for r, res in enumerate(contract):
        want = np.concatenate([(base + 100 * src)[2 * r:2 * r + 2]
                               for src in range(WORLD)], axis=1)
        np.testing.assert_array_equal(res['a2a'], want)


def test_meshes_and_sharding(contract):
    g = np.arange(4 * 2 * WORLD * 2, dtype=np.float32).reshape(
        4, 2 * WORLD, 2)
    seq = WORLD // 2
    for r, res in enumerate(contract):
        assert res['seq_mesh'] == ({'seq': WORLD}, r, WORLD)
        d, s = divmod(r, seq)
        assert res['data_seq'] == ({'data': 2, 'seq': seq}, d, s, seq, 2)
        tn, bn = 2 * WORLD // seq, 2
        np.testing.assert_array_equal(
            res['shard'], g[d * bn:(d + 1) * bn, s * tn:(s + 1) * tn])
        np.testing.assert_array_equal(res['unshard'], g)
        # The data group of rank r holds ranks s, s + seq.
        np.testing.assert_array_equal(res['data_sum'],
                                      _x(s) + _x(s + seq))
        assert res['sub_member'] == (r < 2)


def test_one_rank_without_a_process_group():
    """A process with no process group is one rank alone: every
    collective is the identity, as on a 1-wide mesh axis."""
    assert (comm.get_rank(), comm.get_world_size()) == (0, 1)
    assert comm.is_main_process() and comm.axis_size() == 1
    comm.synchronize()
    x = torch.arange(6.).reshape(2, 3)
    assert torch.equal(comm.all_gather(x), x)
    assert torch.equal(comm.all_reduce(x), x)
    assert torch.equal(comm.reduce_scatter(x[None]), x)
    assert torch.equal(comm.ring_shift((x,))[0], x)
    assert torch.equal(comm.all_to_all(x[None]), x[None])
    mesh = pm.seq_mesh()
    assert mesh.shape == {'seq': 1}
    assert torch.equal(pm.unshard_seq(pm.shard_seq(x, mesh), mesh), x)
    with pytest.raises(ValueError):
        pm.seq_mesh(2)
    with pytest.raises(ValueError):
        pm.data_seq_mesh(2, 2)
    assert comm.transport() == 'local'


def test_init_is_explicit_about_its_backend():
    """``init`` needs the backend named; it joins nothing by default."""
    with pytest.raises(TypeError):
        comm.init()                          # pylint: disable=E1120
