# -*- coding: utf-8 -*-
"""
Process / device layer of the PyTorch port (counterpart of
``distributed_dot_product_tpu/utils/comm.py``).

The reference runs one SPMD program over a device mesh: a rank is
``lax.axis_index(axis_name)`` inside a ``shard_map`` and the collectives
are ``lax`` primitives over a named axis. Here every rank is an OS
process in a ``torch.distributed`` process group, and a mesh axis is a
process group (see :mod:`..parallel.mesh`). Every collective below runs
on the group it is given; ``group=None`` means the default group, and a
process with no initialised default group is one rank alone (every
collective is then the identity), as a 1-wide ``seq`` axis is in the
reference.

Transports. ``init`` takes the backend from the caller; nothing picks
one quietly. On NCCL (one card per rank) the collectives run on the
tensors where they lie. On gloo, the CPU backend, a collective over CUDA
tensors is *host-staged*: the tensor is copied to the host, the gloo
collective runs there, and the result is copied back to the card. That
is the declared transport for running several ranks on one card, where
NCCL refuses two ranks of one communicator on the same device
(:func:`transport` names it: ``'gloo, host-staged'``). The kernels still
run on the card in every rank; only the bytes a collective moves take
the detour. gloo's reduce-scatter is an all-reduce followed by taking
this rank's block (older gloo builds have no reduce-scatter).

The collectives here are not autograd-aware; the modules wrap the ones a
gradient crosses in ``torch.autograd.Function``s with the transposed
collective as backward.

Every call of a collective counts under its kind, by the reference's HLO
names (``all-gather``, ``all-reduce``, ``reduce-scatter``,
``collective-permute``, ``all-to-all``), one-rank calls included:
:func:`collective_counts` is what ``obs/perf.py`` reads, the port's
counterpart of the reference's collectives in the compiled program.
"""

import collections

import torch
import torch.distributed as dist

__all__ = ['SEQ_AXIS', 'resolve_device', 'init', 'init_from_env',
           'get_rank', 'get_world_size', 'is_main_process', 'synchronize',
           'axis_size',
           'transport', 'world_group', 'all_gather', 'all_gather_stacked',
           'all_reduce', 'all_reduce_max', 'reduce_scatter', 'ring_shift',
           'all_to_all', 'collective_counts']

# Canonical name of the sequence (time) axis, kept so modules carry the
# same ``axis_name`` field as the reference package.
SEQ_AXIS = 'seq'


_CALLS = collections.Counter()


# Callables ``fn(kind, group)`` told of every collective call, with the
# group it runs on (analysis/torch_rules.py's collective-axis rule).
_OBSERVERS = []


def _note(kind, group):
    _CALLS[kind] += 1
    for fn in _OBSERVERS:
        fn(kind, group)


def collective_counts():
    """``{kind: calls}`` of every collective this process has called."""
    return dict(_CALLS)


def resolve_device(device='cuda'):
    """The ``torch.device`` an entry point runs on. The port's entry
    points default to the card (``'cuda'``); without one this raises —
    nothing quietly carries on on the CPU. Pass ``device='cpu'`` to run
    the plain PyTorch versions of the kernels (the tests do)."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f'device {device!r} requested but torch.cuda.is_available() '
            f'is False; pass device="cpu" to run the plain PyTorch '
            f'versions on the CPU')
    return dev


def _initialized():
    return dist.is_available() and dist.is_initialized()


def init(backend, init_method, world_size, rank):
    """Join the default process group (the reference's ``init`` wraps
    ``jax.distributed.initialize`` and is a no-op on one host; here every
    rank is a process and must join). ``backend`` is ``'nccl'`` (one card
    per rank) or ``'gloo'`` (CPU tensors, or several ranks on one card
    through host-staged collectives); ``init_method`` is a rendezvous URL
    such as ``'tcp://localhost:29500'`` or ``'file:///path/store'``. A
    second call in an initialised process does nothing."""
    if _initialized():
        return
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def init_from_env(device):
    """Join the process group ``torchrun`` describes (``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK`` and its rendezvous address), as the
    reference's harnesses take their ranks from the mesh; a process
    started alone is one rank and joins nothing. Each rank of a CUDA run
    takes card ``LOCAL_RANK`` (mod the cards present) and NCCL when every
    rank has a card of its own, else gloo (host-staged on a shared card).
    Returns the world size."""
    import os
    world = int(os.environ.get('WORLD_SIZE', '1'))
    if world < 2:
        return 1
    rank = int(os.environ['RANK'])
    dev = resolve_device(device)
    backend = 'gloo'
    if dev.type == 'cuda':
        count = torch.cuda.device_count()
        torch.cuda.set_device(int(os.environ.get('LOCAL_RANK', rank))
                              % count)
        backend = 'nccl' if count >= world else 'gloo'
    init(backend, 'env://', world, rank)
    return world


def get_world_size(group=None):
    """Ranks in ``group`` (the default group when None); 1 when no
    process group is initialised."""
    if not _initialized():
        return 1
    return dist.get_world_size(group)


def get_rank(group=None):
    """This process's rank in ``group`` (the default group when None);
    0 when no process group is initialised."""
    if not _initialized():
        return 0
    return dist.get_rank(group)


def is_main_process(group=None):
    """True on rank 0 of ``group``."""
    return get_rank(group) == 0


def synchronize(group=None):
    """Barrier across the ranks of ``group`` (the reference's host-level
    barrier); nothing to wait for without a process group."""
    if _initialized() and get_world_size(group) > 1:
        dist.barrier(group)


def world_group():
    """The default process group as a group handle, or None when no
    process group is initialised (a one-rank world)."""
    return dist.group.WORLD if _initialized() else None


def axis_size(group=None):
    """Width of a mesh axis, that is of its process group."""
    return get_world_size(group)


def transport(group=None, device=None):
    """How collectives on ``group`` move tensors on ``device``:
    ``'local'`` (one rank), ``'nccl'``, ``'gloo'`` (CPU tensors) or
    ``'gloo, host-staged'`` (CUDA tensors over gloo)."""
    if get_world_size(group) == 1:
        return 'local'
    backend = dist.get_backend(group)
    if backend == 'gloo' and device is not None and \
            torch.device(device).type == 'cuda':
        return 'gloo, host-staged'
    return str(backend)


def _staged(group, tensor):
    return (tensor.is_cuda and dist.get_backend(group) == 'gloo')


def _to_host(x):
    return x.detach().to('cpu').contiguous()


def all_gather_stacked(x, group=None):
    """``(W, *x.shape)``: every rank's ``x`` in rank order (the
    reference's untiled ``lax.all_gather``)."""
    _note('all-gather', group)
    return _all_gather_stacked(x, group)


def _all_gather_stacked(x, group):
    w = get_world_size(group)
    if w == 1:
        return x.unsqueeze(0)
    src = _to_host(x) if _staged(group, x) else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(w)]
    dist.all_gather(parts, src, group=group)
    return torch.stack(parts).to(x.device)


def all_gather(x, group=None, dim=-2):
    """Tiled all-gather: every rank's ``x`` concatenated along ``dim`` in
    rank order (``lax.all_gather(..., tiled=True)``)."""
    _note('all-gather', group)
    if get_world_size(group) == 1:
        return x
    parts = _all_gather_stacked(x, group)
    return torch.cat(list(parts.unbind(0)), dim=dim)


def _all_reduce(x, group, op):
    _note('all-reduce', group)
    if get_world_size(group) == 1:
        return x.clone()
    buf = _to_host(x) if _staged(group, x) else x.detach().clone()
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(x.device)


def all_reduce(x, group=None):
    """Sum of ``x`` over the ranks of ``group``, returned as a new tensor
    (``lax.psum``)."""
    return _all_reduce(x, group, dist.ReduceOp.SUM)


def all_reduce_max(x, group=None):
    """Elementwise maximum of ``x`` over the ranks of ``group``, returned
    as a new tensor (``lax.pmax``)."""
    return _all_reduce(x, group, dist.ReduceOp.MAX)


def reduce_scatter(x, group=None):
    """``x`` is ``(W, *block)``: returns this rank's block of the sum over
    ranks, ``(*block)`` (``lax.psum_scatter(..., scatter_dimension=0,
    tiled=False)``)."""
    _note('reduce-scatter', group)
    w = get_world_size(group)
    if x.shape[0] != w:
        raise ValueError(f'reduce_scatter needs a leading axis of the group '
                         f'width {w}, got shape {tuple(x.shape)}')
    if w == 1:
        return x[0]
    if dist.get_backend(group) == 'gloo':
        buf = _to_host(x) if x.is_cuda else x.detach().clone()
        dist.all_reduce(buf, group=group)
        return buf[dist.get_rank(group)].to(x.device)
    out = torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
    return out


def ring_shift(tensors, group=None, direction=-1):
    """One hop of the ring: rank ``i`` sends each tensor to rank
    ``i + direction`` and receives the one of rank ``i - direction``
    (mod W). ``direction=-1`` is the reference's ``lax.ppermute`` with the
    permutation ``(i, i-1)``: afterwards rank ``r`` holds what rank
    ``r+1`` held. One ``batch_isend_irecv`` exchange carries them all."""
    _note('collective-permute', group)
    tensors = tuple(tensors)
    w = get_world_size(group)
    if w == 1:
        return tensors
    g = dist.group.WORLD if group is None else group
    r = dist.get_rank(g)
    send_to = dist.get_global_rank(g, (r + direction) % w)
    recv_from = dist.get_global_rank(g, (r - direction) % w)
    staged = any(_staged(group, t) for t in tensors)
    srcs = [(_to_host(t) if staged else t.contiguous()) for t in tensors]
    bufs = [torch.empty_like(s) for s in srcs]
    ops = []
    for s, b in zip(srcs, bufs):
        ops.append(dist.P2POp(dist.isend, s, send_to, group))
        ops.append(dist.P2POp(dist.irecv, b, recv_from, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return tuple(b.to(t.device) for b, t in zip(bufs, tensors))


def all_to_all(x, group=None, split_dim=-3, concat_dim=-2):
    """Tiled all-to-all (``lax.all_to_all(..., tiled=True)``): ``x`` is
    split into W chunks along ``split_dim``, chunk ``j`` goes to rank
    ``j``, and the chunks received are concatenated along ``concat_dim``
    in rank order."""
    _note('all-to-all', group)
    w = get_world_size(group)
    if w == 1:
        return x
    split_dim %= x.dim()
    concat_dim %= x.dim()
    if x.shape[split_dim] % w:
        raise ValueError(f'all_to_all: dim {split_dim} of size '
                         f'{x.shape[split_dim]} does not split over {w} '
                         f'ranks')
    send = torch.stack(x.chunk(w, dim=split_dim))        # (W, ...chunk)
    staged = _staged(group, x)
    src = _to_host(send) if staged else send.contiguous()
    recv = torch.empty_like(src)
    dist.all_to_all_single(recv, src, group=group)
    recv = recv.to(x.device)
    return torch.cat(list(recv.unbind(0)), dim=concat_dim)
