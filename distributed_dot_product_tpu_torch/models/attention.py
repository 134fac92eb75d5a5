# -*- coding: utf-8 -*-
"""
Multi-head dot-product attention module — the port of
``DistributedDotProductAttn`` in
``distributed_dot_product_tpu/models/attention.py``.

Ported: the constructor validation, the cached inference surface
(``make_decode_cache``, ``prefill``, ``decode``) and ``forward`` (the
reference's ``__call__``) for ``softmax_impl='flash'`` on one card — the
reference's semantics on a 1-wide ``seq`` axis, where the flash branch
gathers nothing and its causal offset is 0. The other softmax paths, a
mask, dropout and sequence parallelism across ranks raise
``NotImplementedError`` naming their ``ROADMAP.md`` item; segment ids
and the dropout seed are not parameters yet.

The module keeps the reference's K-FIRST convention (scores = K·Qᵀ
softmaxed over the queries axis): in standard-attention terms its
*keys* projection supplies the query rows and its *queries*/*values*
projections are the attended table — so the KV cache stores the
projected queries and values, ``num_kv_heads`` (GQA) shrinks those two
projections, and the flash kernel's query rows are the projected keys.
"""

import math

import torch
from torch import nn

from distributed_dot_product_tpu_torch.models import features
from distributed_dot_product_tpu_torch.models.decode import (
    append_kv, decode_step, init_cache,
)
from distributed_dot_product_tpu_torch.models.dense import (
    OwnedDense, default_generator,
)
from distributed_dot_product_tpu_torch.ops.flash_attention import (
    flash_attention,
)
from distributed_dot_product_tpu_torch.ops.rope import rope
from distributed_dot_product_tpu_torch.utils.comm import (
    SEQ_AXIS, get_world_size, resolve_device,
)

__all__ = ['DistributedDotProductAttn']


class DistributedDotProductAttn(nn.Module):
    """Multi-head dot-product attention (K-first convention).

    Constructor fields mirror the reference module's and are validated
    the same way (same errors for the same bad values). Knobs whose
    inference path is not ported yet (``window``, ``alibi_slopes``,
    ``qk_quant``, ``weight_quant``) raise ``NotImplementedError``.
    Parameters are created on ``device`` at ``param_dtype`` (float32 by
    default, as in the reference) and computed at ``dtype``, drawn from
    ``generator`` (see :func:`~..models.dense.default_generator`).

    ``decode_impl``: ``None``/``'auto'``/``'kernel'`` run the fused
    decode kernel port (CUDA kernel on the card, its plain version on the
    CPU); ``'plain'`` runs the append + masked-softmax formulation (the
    reference's ``'xla'``).
    """

    def __init__(self, key_dim, value_dim=None, query_dim=None, num_heads=1,
                 num_kv_heads=None, add_bias=False, offset=32, causal=False,
                 window=None, distributed=True, axis_name=SEQ_AXIS,
                 impl='allgather', softmax_impl='full',
                 ring_layout='contiguous', flash_softmax_mode='exact',
                 dropout_rate=0.0, alibi_slopes=None, qk_quant=None,
                 use_rope=False, rope_base=10000.0, decode_impl=None,
                 weight_quant=None, dtype=None, param_dtype=torch.float32,
                 device='cuda', generator=None):
        super().__init__()
        if key_dim % num_heads:
            raise ValueError(
                f'key_dim {key_dim} must be divisible by num_heads '
                f'{num_heads} (reference module.py:29)')
        if softmax_impl not in ('full', 'online', 'flash', 'ulysses'):
            raise ValueError(
                f"softmax_impl must be 'full', 'online', 'flash' or "
                f"'ulysses', got {softmax_impl!r}")
        if impl not in ('allgather', 'ring'):
            raise ValueError(
                f"impl must be 'allgather' or 'ring', got {impl!r}")
        if window is not None:
            if not isinstance(window, int) or window < 1:
                raise ValueError(
                    f'window must be a positive int, got {window!r}')
            if not causal:
                raise ValueError('window is a lookback cap and requires '
                                 'causal=True')
            features.check('window', softmax_impl)
        if dropout_rate:
            features.check('dropout_rate', softmax_impl)
        if alibi_slopes is not None:
            features.check('alibi_slopes', softmax_impl)
            if not causal:
                raise ValueError('alibi_slopes bias by relative global '
                                 'position and require causal=True')
        if qk_quant is not None:
            features.check('qk_quant', softmax_impl)
        if weight_quant not in (None, 'int8'):
            raise ValueError(f"weight_quant must be None or 'int8', "
                             f'got {weight_quant!r}')
        if decode_impl not in (None, 'auto', 'kernel', 'plain'):
            raise ValueError(f"decode_impl must be None, 'auto', "
                             f"'kernel' or 'plain', got {decode_impl!r}")
        if ring_layout == 'zigzag':
            features.check('ring_layout=zigzag', softmax_impl)
        if flash_softmax_mode == 'bounded':
            features.check('flash_softmax_mode=bounded', softmax_impl)
        value_dim = value_dim if value_dim is not None else key_dim
        if value_dim % num_heads:
            raise ValueError(
                f'value_dim {value_dim} must be divisible by num_heads '
                f'{num_heads}')
        kv_heads = num_kv_heads if num_kv_heads is not None else num_heads
        if not 1 <= kv_heads <= num_heads or num_heads % kv_heads:
            raise ValueError(
                f'num_kv_heads {kv_heads} must divide num_heads '
                f'{num_heads} (and lie in [1, num_heads])')
        if kv_heads != num_heads:
            features.check('num_kv_heads', softmax_impl)
        head_dim = key_dim // num_heads
        if use_rope:
            features.check('use_rope', softmax_impl)
            if head_dim % 2:
                raise ValueError(
                    f'use_rope needs an even head dim, got {head_dim}')
        for name, value in (('window', window),
                            ('alibi_slopes', alibi_slopes),
                            ('qk_quant', qk_quant),
                            ('weight_quant', weight_quant)):
            if value is not None:
                raise NotImplementedError(
                    f'DistributedDotProductAttn({name}=...) is not ported '
                    f'yet')

        self.num_heads = num_heads
        self.causal = causal
        self.distributed = distributed
        self.softmax_impl = softmax_impl
        self.dropout_rate = dropout_rate
        self.use_rope, self.rope_base = use_rope, rope_base
        self.decode_impl = decode_impl
        self.dtype = dtype or torch.float32
        self.head_dim = head_dim
        self._value_dim = value_dim
        self._kv_heads = kv_heads
        dev = resolve_device(device)
        gen = default_generator(generator)

        def dense(d_in, d_out):
            return OwnedDense(d_in, d_out, use_bias=add_bias, dtype=dtype,
                              param_dtype=param_dtype, device=dev,
                              generator=gen)
        # Same four projections as the reference; under GQA the queries/
        # values projections (the attended side, K-first) emit only
        # kv_heads heads.
        self.keys_proj = dense(key_dim, key_dim)
        self.queries_proj = dense(query_dim or key_dim, kv_heads * head_dim)
        self.values_proj = dense(value_dim,
                                 kv_heads * (value_dim // num_heads))
        self.composition = dense(value_dim, value_dim)

    def forward(self, keys, queries, values, attn_mask=None):
        """Attention over ``keys/queries/values (B, T, d·)``, the
        reference ``__call__`` on one card: the four projections, the
        head split, RoPE at positions ``arange(T)`` on keys and queries,
        then :func:`~..ops.flash_attention.flash_attention` with the
        K-first convention (its query rows are the projected keys, its
        key/value table the projected queries/values), causal offset 0;
        the head merge and ``composition``. Returns ``(B, T, value_dim)``.
        Differentiable: the backward runs the flash gradient kernels."""
        if self.softmax_impl != 'flash':
            raise NotImplementedError(
                f'forward with softmax_impl={self.softmax_impl!r} is not '
                f"ported yet (ROADMAP.md §1 items 5 and 7); 'flash' is")
        if attn_mask is not None:
            raise NotImplementedError(
                'attn_mask in the flash kernels is not ported yet '
                '(ROADMAP.md §2 item 1)')
        if self.dropout_rate:
            raise NotImplementedError(
                'attention dropout in the flash kernels is not ported yet '
                '(ROADMAP.md §2 item 1)')
        if self.distributed and get_world_size() > 1:
            raise NotImplementedError(
                'sequence parallelism across ranks is not ported yet '
                '(ROADMAP.md §1 items 1-3 and 6); this forward is the '
                'one-card semantics')
        keys, queries, values = self._project(keys, queries, values, 0)
        out = flash_attention(keys, queries, values, causal=self.causal,
                              causal_offset=0,
                              scale=1.0 / math.sqrt(self.head_dim))
        return self._merge_heads(out)

    def make_decode_cache(self, batch, t_max, dtype=None, device=None):
        """A KV cache sized for this module's projections (GQA-aware),
        on the module's device unless ``device`` is given."""
        return init_cache(
            batch, self._kv_heads, t_max, self.head_dim,
            v_head_dim=self._value_dim // self.num_heads,
            dtype=dtype or self.dtype,
            device=device or self.keys_proj.weight.device)

    def _project(self, keys, queries, values, start):
        """Shared front half of every call: the four projections, head
        split, and RoPE at the global positions ``start + arange(n)``."""
        keys = self.keys_proj(keys)
        queries = self.queries_proj(queries)
        values = self.values_proj(values)
        n = keys.shape[-2]

        def split(x, heads, dh):
            return x.reshape(*x.shape[:-1], heads, dh).transpose(-2, -3)
        keys = split(keys, self.num_heads, self.head_dim)
        queries = split(queries, self._kv_heads, self.head_dim)
        values = split(values, self._kv_heads,
                       self._value_dim // self.num_heads)
        if self.use_rope:
            pos = start + torch.arange(n, device=keys.device)
            keys = rope(keys, pos, base=self.rope_base)
            queries = rope(queries, pos, base=self.rope_base)
        return keys, queries, values

    def _project_for_decode(self, keys, queries, values, cache):
        if not self.causal:
            raise ValueError('cached decoding is autoregressive and '
                             'requires causal=True')
        return self._project(keys, queries, values, cache.length)

    def _merge_heads(self, out):
        out = out.transpose(-3, -2)
        out = out.reshape(*out.shape[:-2], self._value_dim)
        return self.composition(out)

    def prefill(self, keys, queries, values, cache):
        """Prompt ingestion: project the ``n`` new positions, append the
        projected queries/values to the cache (in place), and compute the
        rows' outputs with the flash kernel over the whole cache buffer —
        causal from global position ``cache.length`` excludes both the
        future prompt rows and the unfilled tail. Returns
        ``(cache, out (B, n, value_dim))``."""
        keys, queries, values = self._project_for_decode(
            keys, queries, values, cache)
        start = cache.length
        cache = append_kv(cache, queries, values)
        out = flash_attention(keys, cache.k, cache.v, causal=True,
                              causal_offset=start,
                              scale=1.0 / math.sqrt(self.head_dim))
        return cache, self._merge_heads(out)

    def decode(self, keys, queries, values, cache):
        """One cached step for the NEW positions ``(B, 1, d·)``: the fused
        append + attend (``decode_impl`` selects the implementation).
        Returns ``(cache, out (B, 1, value_dim))``."""
        keys, queries, values = self._project_for_decode(
            keys, queries, values, cache)
        cache, out = decode_step(keys, cache, queries, values,
                                 scale=1.0 / math.sqrt(self.head_dim),
                                 impl=self.decode_impl)
        return cache, self._merge_heads(out)
