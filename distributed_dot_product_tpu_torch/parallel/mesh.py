# -*- coding: utf-8 -*-
"""
Process-group meshes and sequence sharding (counterpart of
``distributed_dot_product_tpu/parallel/mesh.py``).

The reference's mesh is a ``jax.sharding.Mesh`` of devices with named
axes, and its sharding is a ``PartitionSpec`` placing the time axis on
``'seq'``. Here each rank is a process, a mesh axis is a process group,
and a :class:`Mesh` is what one rank needs of it: its seq group and, on
a 2-D mesh, its data group, with its index along each. ``seq_mesh`` and
``data_seq_mesh`` create every group with ``new_group`` on every rank in
the same order (``torch.distributed`` requires each rank to take part in
creating every group, its own or not). The layout follows the
reference's ``devices.reshape(data, seq)``: global rank
``r = d·seq + s`` sits at data index ``d`` and seq index ``s``.

``shard_seq`` takes this rank's time slice of a global tensor (the
``(*, T/N, d)`` convention, the reference's per-device shard), and
``unshard_seq`` gathers the shards of a seq group back into the global
tensor. ``shard_decode_cache`` takes this rank's slab of a global KV cache
for the sequence-sharded decode step. The reference's ``_compat.py`` holds only JAX version shims and
has no counterpart.
"""

import numbers
from dataclasses import dataclass
from typing import Any, Optional

from distributed_dot_product_tpu_torch.utils.comm import (
    SEQ_AXIS, all_gather, get_rank, get_world_size,
)

__all__ = ['Mesh', 'seq_mesh', 'data_seq_mesh', 'shard_seq', 'unshard_seq',
           'shard_decode_cache']


# Callables ``fn(mesh)`` told of every Mesh made (analysis/torch_rules.py
# maps a collective's group to the axes of the meshes a spec built).
_OBSERVERS = []


@dataclass(frozen=True)
class Mesh:
    """One rank's view of a (data ×) seq mesh: the process group of its
    seq axis and its index there, and on a 2-D mesh the same for the data
    axis (``data_group`` None and ``data_size`` 1 on a 1-D mesh).
    ``member`` is False on a rank outside the mesh (``seq_mesh(n)`` with
    fewer ranks than the world)."""
    seq_group: Any
    seq_rank: int
    seq_size: int
    data_group: Optional[Any] = None
    data_rank: int = 0
    data_size: int = 1
    member: bool = True
    axis_names: tuple = (SEQ_AXIS,)

    def __post_init__(self):
        for fn in _OBSERVERS:
            fn(self)

    def axis_groups(self):
        """``{axis name: process group}`` — the group a collective over
        each axis runs on (None: the default group, or one rank
        alone)."""
        groups = ((self.data_group, self.seq_group)
                  if len(self.axis_names) == 2 else (self.seq_group,))
        return dict(zip(self.axis_names, groups))

    @property
    def shape(self):
        """``{axis name: width}``, as ``jax.sharding.Mesh.shape``."""
        sizes = ((self.data_size, self.seq_size) if len(self.axis_names) == 2
                 else (self.seq_size,))
        return dict(zip(self.axis_names, sizes))


def _new_group(ranks):
    import torch.distributed as dist
    return dist.new_group(ranks=list(ranks))


def seq_mesh(num_ranks=None, axis_name=SEQ_AXIS):
    """1-D mesh over the sequence axis: ranks ``0 .. num_ranks-1`` of the
    default group (all of them when None). Every rank of the world must
    call it. Without a process group this is the one-rank mesh."""
    world = get_world_size()
    n = world if num_ranks is None else num_ranks
    if n > world:
        raise ValueError(f'requested {n} ranks, only {world} in the '
                         f'process group')
    if world == 1:
        return Mesh(None, 0, 1, axis_names=(axis_name,))
    rank = get_rank()
    group = None if n == world else _new_group(range(n))
    member = rank < n
    return Mesh(group, rank if member else -1, n, member=member,
                axis_names=(axis_name,))


def data_seq_mesh(data, seq, axis_names=('data', SEQ_AXIS)):
    """2-D ``(data, seq)`` mesh for batch (DP) × sequence (SP)
    parallelism over the first ``data·seq`` ranks: rank ``d·seq + s``
    holds data index ``d`` and seq index ``s``; its seq group is the
    ``seq`` ranks of its data row, its data group the ``data`` ranks of
    its seq column. Every rank of the world must call it."""
    world = get_world_size()
    if data * seq > world:
        raise ValueError(f'mesh {data}x{seq} needs {data * seq} ranks, '
                         f'only {world} in the process group')
    rank = get_rank()
    seq_groups = [_new_group(range(d * seq, (d + 1) * seq))
                  for d in range(data)] if world > 1 else [None]
    data_groups = [_new_group(range(s, data * seq, seq))
                   for s in range(seq)] if world > 1 else [None]
    if rank >= data * seq:
        return Mesh(None, -1, seq, None, -1, data, member=False,
                    axis_names=tuple(axis_names))
    d, s = divmod(rank, seq)
    return Mesh(seq_groups[d], s, seq, data_groups[s], d, data,
                axis_names=tuple(axis_names))


def shard_seq(x, mesh, seq_axis=-2, batch_axis=None):
    """This rank's shard of the global ``x``: its ``1/seq`` slice of the
    time axis ``seq_axis`` and, with ``batch_axis`` on a 2-D mesh, its
    ``1/data`` slice of the batch axis (a view, no copy)."""
    def take(t, axis, index, parts):
        size = t.shape[axis]
        if size % parts:
            raise ValueError(f'axis {axis} of size {size} does not split '
                             f'into {parts} shards')
        step = size // parts
        return t.narrow(axis, index * step, step)
    x = take(x, seq_axis, mesh.seq_rank, mesh.seq_size)
    if batch_axis is not None:
        x = take(x, batch_axis, mesh.data_rank, mesh.data_size)
    return x


def unshard_seq(x, mesh, seq_axis=-2, batch_axis=None):
    """The global tensor from every rank's shard: the seq group's shards
    concatenated along ``seq_axis`` and, with ``batch_axis``, the data
    group's along ``batch_axis`` (not differentiable)."""
    x = all_gather(x.detach(), mesh.seq_group, dim=seq_axis)
    if batch_axis is not None and mesh.data_size > 1:
        x = all_gather(x, mesh.data_group, dim=batch_axis)
    return x


def shard_decode_cache(cache, mesh):
    """This rank's slab of a global slab KV cache (a ``DecodeCache`` from
    ``module.make_decode_cache(batch, t_max_global)``), sharded on its
    ``t_max`` axis over the seq group: ``k``/``v`` (and an int8 cache's
    ``k_q``/``k_scale`` mirror) become this rank's ``(B, H_kv, t_max/W,
    ·)`` columns, copied into buffers of its own (the decode step appends
    in place), and ``length`` stays global. The
    global buffers can be dropped afterwards; a zero cache's slab is
    ``module.make_decode_cache(batch, t_max_global // W)``."""
    if not isinstance(cache.length, numbers.Integral):
        raise ValueError('a sharded decode cache has one global length; '
                         'per-slot and paged caches do not shard on t_max')
    return cache._replace(**{
        name: shard_seq(buf, mesh).clone()
        for name, buf in zip(cache._fields, cache)
        if name in ('k', 'v', 'k_q', 'k_scale') and buf is not None})
