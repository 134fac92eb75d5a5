# -*- coding: utf-8 -*-
"""
Process / device layer of the PyTorch port (counterpart of
``distributed_dot_product_tpu/utils/comm.py``).

The ported paths serve and train one model on one card, so this carries
the mesh-axis name the modules keep as a field, the device rule every
entry point follows, and the process-group width those paths check
(they refuse a group of more than one rank until sequence parallelism is
ported). The collectives (process groups over NCCL on the card, gloo on
the CPU) come with the sequence-parallel slice.
"""

import torch

__all__ = ['SEQ_AXIS', 'get_world_size', 'resolve_device']

# Canonical name of the sequence (time) axis, kept so modules carry the
# same ``axis_name`` field as the reference package.
SEQ_AXIS = 'seq'


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


def get_world_size():
    """Ranks in the default ``torch.distributed`` process group, 1 when
    none is initialised (the reference's process count outside a
    ``shard_map``)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1
