# -*- coding: utf-8 -*-
"""
Rotary position embeddings (counterpart of
``distributed_dot_product_tpu/ops/rope.py``).

Same convention as the reference package: the NeoX/LLaMA "half" layout —
the feature dim splits into two halves ``(x1, x2)`` rotated as
``(x1·cos − x2·sin, x1·sin + x2·cos)`` with frequencies
``base^(−2i/d)`` — computed in float32 and cast back to ``x.dtype``.
Plain PyTorch: O(T·d) elementwise work that needs no kernel.
"""

import torch

from distributed_dot_product_tpu_torch.utils.comm import get_rank

__all__ = ['rope', 'rope_seq_parallel']


def rope(x, positions=None, *, base=10000.0, offset=0, dtype=torch.float32):
    """Apply rotary embedding to ``x (..., T, d)`` (``d`` even).

    ``positions``: per-token GLOBAL positions ``(..., T)`` broadcastable
    against x's leading dims; default ``offset + arange(T)``. The
    rotation is computed in ``dtype`` (float32 by default — low-precision
    angles lose relative-position precision beyond ~10K tokens)."""
    d = x.shape[-1]
    if d % 2:
        raise ValueError(f'rope needs an even feature dim, got {d}')
    t = x.shape[-2]
    if positions is None:
        positions = offset + torch.arange(t, device=x.device)
    positions = torch.as_tensor(positions, device=x.device).to(dtype)
    inv_freq = base ** (-torch.arange(0, d, 2, device=x.device,
                                      dtype=dtype) / d)          # (d/2,)
    angles = positions[..., None] * inv_freq                 # (..., T, d/2)
    cos = torch.cos(angles)
    sin = torch.sin(angles)
    x1 = x[..., : d // 2].to(dtype)
    x2 = x[..., d // 2:].to(dtype)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope_seq_parallel(x, *, group=None, positions=None, base=10000.0,
                      dtype=torch.float32):
    """``rope`` for this rank's ``(..., T/N, d)`` time shard: the global
    positions default to ``rank·T/N + arange(T/N)`` with ``rank`` this
    process's rank in ``group`` (contiguous sharding); pass the shard's
    ``positions`` vector for other layouts."""
    if positions is None:
        tn = x.shape[-2]
        positions = get_rank(group) * tn + torch.arange(tn, device=x.device)
    return rope(x, positions, base=base, dtype=dtype)
