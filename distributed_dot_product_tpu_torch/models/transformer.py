# -*- coding: utf-8 -*-
"""
Transformer stack over the attention module — the port of
``TransformerBlock``/``TransformerStack`` in
``distributed_dot_product_tpu/models/transformer.py``: the training
forward and the cached inference (``make_decode_caches``/``prefill``/
``decode``).

Pre-LN blocks, ``x + Attn(LN(x))`` then ``x + MLP(LN(x))``, with flax's
defaults carried over exactly: LayerNorm with ``epsilon=1e-6`` and
float32 statistics (``E[x²] − E[x]²`` clipped at 0), float32 scale/bias
parameters and the output at the module dtype; the MLP activation is
flax's ``nn.gelu``, the tanh approximation. The reference's
``scan_layers`` stacks are a parameter layout; here the stack is a plain
list of layers (``convert.py`` reads either layout), and ``scan_layers``
decides only the dropout salt, as the reference's layouts do: unrolled,
block ``i``'s attention sits at path ``block_i/attn``; scanned, every
layer's at ``layers/block/attn``, with the seed also XORed with
``i·0x61C88647`` (int32) so the layers draw distinct masks.
``remat=True`` (the reference's ``nn.remat`` around the scanned block)
runs each block under ``torch.utils.checkpoint``, so the backward keeps
only the block inputs and recomputes one block at a time (the dropout
hash redraws the same mask).

Every forward takes the reference's ``(…, attn_mask, segment_ids,
deterministic, dropout_seed)`` and ``group=``, the sequence group passed
to every block's attention.
"""

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from distributed_dot_product_tpu_torch.models.attention import (
    DistributedDotProductAttn,
)
from distributed_dot_product_tpu_torch.models.dense import (
    OwnedDense, default_generator,
)
from distributed_dot_product_tpu_torch.ops.flash_attention import _i32
from distributed_dot_product_tpu_torch.utils.comm import (
    SEQ_AXIS, resolve_device,
)

__all__ = ['LayerNorm', 'TransformerBlock', 'TransformerStack']


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (defaults): statistics in float32,
    ``epsilon=1e-6``, float32 ``scale``/``bias``, output at ``dtype``
    (float32 when None)."""

    def __init__(self, dim, dtype=None, device='cuda'):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype or torch.float32
        self.scale = nn.Parameter(torch.ones(dim, device=dev))
        self.bias = nn.Parameter(torch.zeros(dim, device=dev))

    def forward(self, x):
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = ((x32 * x32).mean(dim=-1, keepdim=True)
               - mean * mean).clamp_min(0.0)
        y = (x32 - mean) * (torch.rsqrt(var + 1e-6) * self.scale) + self.bias
        return y.to(self.dtype)


class TransformerBlock(nn.Module):
    """Pre-LN block; ``attn_kwargs`` pass through to
    :class:`DistributedDotProductAttn` (self-attention: the same tensor
    feeds keys, queries and values). Parameters are stored at
    ``param_dtype`` and computed at ``dtype``."""

    def __init__(self, dim, num_heads, mlp_ratio=4, axis_name=SEQ_AXIS,
                 dtype=None, attn_kwargs=None, param_dtype=torch.float32,
                 device='cuda', generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = default_generator(generator)
        kw = dict(attn_kwargs or {})
        kw.setdefault('dtype', dtype)
        kw.setdefault('param_dtype', param_dtype)
        kw.setdefault('axis_name', axis_name)
        self.attn = DistributedDotProductAttn(
            key_dim=dim, num_heads=num_heads, device=dev, generator=gen,
            **kw)
        self.ln1 = LayerNorm(dim, dtype=dtype, device=dev)
        self.ln2 = LayerNorm(dim, dtype=dtype, device=dev)
        self.mlp_in = OwnedDense(dim, mlp_ratio * dim, dtype=dtype,
                                 param_dtype=param_dtype, device=dev,
                                 generator=gen)
        self.mlp_out = OwnedDense(mlp_ratio * dim, dim, dtype=dtype,
                                  param_dtype=param_dtype, device=dev,
                                  generator=gen)

    def _mlp(self, h):
        return self.mlp_out(F.gelu(self.mlp_in(h), approximate='tanh'))

    def forward(self, x, attn_mask=None, segment_ids=None,
                deterministic=False, dropout_seed=None, *, group=None):
        h = self.ln1(x)
        x = x + self.attn(h, h, h, attn_mask, segment_ids=segment_ids,
                          deterministic=deterministic,
                          dropout_seed=dropout_seed, group=group)
        return x + self._mlp(self.ln2(x))

    def prefill(self, x, cache):
        h = self.ln1(x)
        cache, a = self.attn.prefill(h, h, h, cache)
        x = x + a
        return cache, x + self._mlp(self.ln2(x))

    def decode(self, x, cache):
        h = self.ln1(x)
        cache, a = self.attn.decode(h, h, h, cache)
        x = x + a
        return cache, x + self._mlp(self.ln2(x))


# The scanned stack's per-layer seed salt (the reference's scan body).
_LAYER_SALT = 0x61C88647


class TransformerStack(nn.Module):
    """``n_layers`` blocks with one KV cache each. The forward mirrors
    the train-step contract ``(keys, queries, values, attn_mask,
    segment_ids, deterministic, dropout_seed)`` with the first tensor as
    the block input, and ``group=`` for every block's attention.

    ``scan_layers``: the reference layout whose dropout salt the layers
    take (see the module docstring); ``path``: the stack's own path in
    the reference tree (``('stack',)`` inside the language model).
    ``remat=True`` checkpoints each block. ``remat_policy`` (partial
    rematerialisation) is not ported."""

    def __init__(self, dim, num_heads, n_layers=2, mlp_ratio=4,
                 axis_name=SEQ_AXIS, dtype=None, attn_kwargs=None,
                 remat=False, remat_policy=None, scan_layers=False,
                 path=(), param_dtype=torch.float32, device='cuda',
                 generator=None):
        super().__init__()
        if remat_policy is not None:
            raise NotImplementedError(
                'remat_policy is not ported yet (ROADMAP.md §1 item 8); '
                'remat=True recomputes each whole block')
        dev = resolve_device(device)
        gen = default_generator(generator)
        self.remat, self.scan_layers = remat, scan_layers
        self.blocks = nn.ModuleList(
            TransformerBlock(dim, num_heads, mlp_ratio=mlp_ratio,
                             axis_name=axis_name, dtype=dtype,
                             attn_kwargs=attn_kwargs,
                             param_dtype=param_dtype, device=dev,
                             generator=gen)
            for _ in range(n_layers))
        for i, block in enumerate(self.blocks):
            block.attn.path = (*path, 'layers', 'block', 'attn') \
                if scan_layers else (*path, f'block_{i}', 'attn')

    def forward(self, keys, queries=None, values=None, attn_mask=None,
                segment_ids=None, deterministic=False, dropout_seed=None,
                *, group=None):
        # queries/values are accepted for train-step signature parity; a
        # transformer block is self-attention on one stream.
        x = keys
        for i, block in enumerate(self.blocks):
            seed = dropout_seed
            if self.scan_layers and seed is not None:
                seed = _i32(seed) ^ _i32(i * _LAYER_SALT)
            args = (x, attn_mask, segment_ids, deterministic, seed)
            x = (checkpoint(block, *args, group=group, use_reentrant=False)
                 if self.remat and torch.is_grad_enabled()
                 else block(*args, group=group))
        return x

    def make_decode_caches(self, batch, t_max, dtype=None, device=None):
        """One KV cache per layer, a list."""
        return [block.attn.make_decode_cache(batch, t_max, dtype=dtype,
                                             device=device)
                for block in self.blocks]

    def prefill(self, x, caches):
        out = []
        for block, cache in zip(self.blocks, caches):
            cache, x = block.prefill(x, cache)
            out.append(cache)
        return out, x

    def decode(self, x, caches):
        out = []
        for block, cache in zip(self.blocks, caches):
            cache, x = block.decode(x, cache)
            out.append(cache)
        return out, x
