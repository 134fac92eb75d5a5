# -*- coding: utf-8 -*-
"""
Distributed sequence matmuls (functional layer, no custom gradients) —
the port of ``distributed_dot_product_tpu/ops/functions.py``.

Three products over a time axis ``T`` sharded ``T/N`` per rank of a
process group (the reference's ``axis_name`` becomes ``group``; None is
the default group):

- ``distributed_matmul_nt``:  ``A·Bᵀ``, ``(*, T/N, D) × (*, T/N, D) →
  (*, T/N, T)``;
- ``distributed_matmul_tn``:  ``Aᵀ·B``, ``(*, T/N, C) × (*, T/N, D) →
  (*, C/W, D)``;
- ``distributed_matmul_all``: ``A·B``,  ``(*, T/N, T) × (*, T/N, D) →
  (*, T/N, D)``.

Communication, as in the reference: nt and all gather ``offset``-sized
slabs of the right operand one at a time (rows for nt, feature columns
for all), each slab feeding one large product — gathered memory
O(W·offset·d) instead of O(T·d); a slab size that does not divide the
axis is zero-padded to a multiple and the pad sliced off. ``offset=None``
gathers everything at once. tn is one reduce-scatter. ``impl='ring'``
rotates whole right shards around the ring instead (the ``(i, i-1)``
permutation: W-1 neighbour hops, gathered memory one shard).

Global column order of nt: column ``w·(T/N) + j`` is row ``j`` of rank
``w``'s shard, plain global order. These are large plain products, which
the reference leaves to XLA outside any Pallas kernel; here they are
``torch.matmul`` (cuBLAS on the card).
"""

import torch

from distributed_dot_product_tpu_torch.parallel.mesh import (
    shard_seq, unshard_seq,
)
from distributed_dot_product_tpu_torch.utils.comm import (
    all_gather, all_gather_stacked, get_rank, get_world_size,
    reduce_scatter, ring_shift,
)

__all__ = [
    'distributed_matmul_nt', 'distributed_matmul_tn',
    'distributed_matmul_all',
    'distributed_matmul_nt_global', 'distributed_matmul_tn_global',
    'distributed_matmul_all_global',
]


def _check_offset(offset):
    if offset is not None and int(offset) < 1:
        raise ValueError(
            f'offset must be a positive chunk size or None (full gather), '
            f'got {offset}')


def _pad_to_multiple(x, multiple, dim):
    """Zero-pad ``x`` along ``dim`` up to the next multiple; returns
    ``(padded, padded size)``."""
    size = x.shape[dim]
    target = -(-size // multiple) * multiple
    if target == size:
        return x, size
    shape = list(x.shape)
    shape[dim] = target - size
    return torch.cat([x, x.new_zeros(shape)], dim=dim), target


def distributed_matmul_nt(left, right, offset=32, group=None,
                          impl='allgather'):
    """``A·Bᵀ`` over sequence shards: ``left``/``right`` ``(*, T/N, D)``
    → ``(*, T/N, T)``, columns in global order. ``offset``: rows of
    ``right`` gathered per step (None: all at once); ``impl='ring'``
    ignores it."""
    if impl == 'ring':
        return _matmul_nt_ring(left, right, group)
    _check_offset(offset)
    w = get_world_size(group)
    tn = right.shape[-2]
    offset = tn if offset is None else min(int(offset), tn)
    if offset >= tn:
        gathered = all_gather(right, group, dim=-2)          # (*, T, D)
        return torch.matmul(left, gathered.transpose(-1, -2))
    r, tp = _pad_to_multiple(right, offset, dim=-2)
    out = left.new_empty((*left.shape[:-1], w, tp))
    for c in range(tp // offset):
        chunk = r[..., c * offset:(c + 1) * offset, :]
        g = all_gather_stacked(chunk, group)                 # (W, *, o, D)
        # (*, T/N, W, offset): one product per step.
        out[..., c * offset:(c + 1) * offset] = torch.einsum(
            '...td,w...od->...two', left, g)
    if tp != tn:
        out = out[..., :tn]          # drop pad columns in each rank's block
    return out.reshape(*left.shape[:-1], w * tn)


def _matmul_nt_ring(left, right, group):
    """Ring ``A·Bᵀ``: at step ``s`` the resident shard is rank
    ``(rank+s) mod W``'s, giving that owner's column block."""
    w, idx = get_world_size(group), get_rank(group)
    tn = right.shape[-2]
    out = left.new_empty((*left.shape[:-1], w * tn))
    buf = right
    for s in range(w):
        owner = (idx + s) % w
        out[..., owner * tn:(owner + 1) * tn] = torch.matmul(
            left, buf.transpose(-1, -2))
        if s < w - 1:                # the last block needs no rotation
            buf, = ring_shift((buf,), group)
    return out


def distributed_matmul_tn(left, right, group=None):
    """``Aᵀ·B`` over sequence shards: ``left (*, T/N, C)`` with
    ``C = W·(C/W)``, ``right (*, T/N, D)`` → ``(*, C/W, D)``: rank ``w``
    keeps rows ``[w·C/W, (w+1)·C/W)`` of the global product. One
    reduce-scatter of every rank's partial blocks."""
    w = get_world_size(group)
    c = left.shape[-1]
    if c % w:
        raise ValueError(
            f'distributed_matmul_tn: left last dim {c} must be divisible by '
            f'the mesh axis size {w}')
    blocks = left.reshape(*left.shape[:-1], w, c // w)      # (*, T/N, W, C/W)
    contrib = torch.einsum('...twc,...td->w...cd', blocks, right)
    return reduce_scatter(contrib, group)


def distributed_matmul_all(left, right, offset=32, group=None,
                           impl='allgather'):
    """``A·B`` over sequence shards: ``left (*, T/N, T)``, ``right
    (*, T/N, D)`` → ``(*, T/N, D)``. ``offset``: feature columns of
    ``right`` gathered per step (None: all at once); ``impl='ring'``
    rotates whole shards instead."""
    if impl == 'ring':
        return _matmul_all_ring(left, right, group)
    _check_offset(offset)
    d = right.shape[-1]
    offset = d if offset is None else min(int(offset), d)
    if offset >= d:
        return torch.matmul(left, all_gather(right, group, dim=-2))
    r, dp = _pad_to_multiple(right, offset, dim=-1)
    out = left.new_empty((*left.shape[:-1], dp))
    for c in range(dp // offset):
        g = all_gather(r[..., c * offset:(c + 1) * offset], group, dim=-2)
        out[..., c * offset:(c + 1) * offset] = torch.matmul(left, g)
    return out[..., :d] if dp != d else out


def _matmul_all_ring(left, right, group):
    """Ring ``A·B``: at step ``s`` multiply the resident shard (owner
    ``(rank+s) mod W``) by the matching column block of ``left``."""
    w, idx = get_world_size(group), get_rank(group)
    tn = right.shape[-2]
    acc = None
    buf = right
    for s in range(w):
        owner = (idx + s) % w
        part = torch.matmul(left[..., owner * tn:(owner + 1) * tn], buf)
        acc = part if acc is None else acc + part
        if s < w - 1:
            buf, = ring_shift((buf,), group)
    return acc


def _global(fn, mesh, left, right, **kw):
    """Apply a shard-local product to global tensors: every rank passes
    the same global operands and gets the global result back."""
    out = fn(shard_seq(left, mesh), shard_seq(right, mesh),
             group=mesh.seq_group, **kw)
    return unshard_seq(out, mesh)


def distributed_matmul_nt_global(left, right, offset=32, mesh=None, **kw):
    """``A·Bᵀ`` on global tensors ``(*, T, D)`` sharded over ``mesh``."""
    return _global(distributed_matmul_nt, mesh, left, right, offset=offset,
                   **kw)


def distributed_matmul_tn_global(left, right, mesh=None, **kw):
    """``Aᵀ·B`` on global tensors sharded over ``mesh``."""
    return _global(distributed_matmul_tn, mesh, left, right, **kw)


def distributed_matmul_all_global(left, right, offset=32, mesh=None, **kw):
    """``A·B`` on global tensors sharded over ``mesh``."""
    return _global(distributed_matmul_all, mesh, left, right, offset=offset,
                   **kw)
