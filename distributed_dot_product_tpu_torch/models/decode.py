# -*- coding: utf-8 -*-
"""
Incremental decoding with a KV cache — the slab half of
``distributed_dot_product_tpu/models/decode.py`` for a scalar length.

The cache is a static-shape ``(B, H_kv, t_max, d)`` buffer pair plus the
number of filled positions, a host int: the port runs eagerly, so the
length is always concrete and an append past ``t_max`` always raises
(the reference's concrete-overflow contract). Appends write the buffers
IN PLACE — the returned cache holds the same tensors as the one passed
in, with the length advanced — where the reference's functional arrays
returned new buffers (or aliased them under donation).

:func:`decode_step` is the fused append + attend step: by default (and
``impl='kernel'``) it runs the K5 port :func:`~..ops.flash_decode.flash_decode`
(the CUDA kernel on the card, its plain version on the CPU);
``impl='plain'`` runs :func:`append_kv` + :func:`decode_attention`, the
reference's portable formulation (``impl='xla'`` there).

Not ported yet: per-slot caches, paged caches, the int8 K mirror,
sequence-sharded steps, verify-k, windows, ALiBi and packed segments —
they raise ``NotImplementedError``.
"""

import math
from typing import NamedTuple

import torch

from distributed_dot_product_tpu_torch.ops.flash_decode import flash_decode
from distributed_dot_product_tpu_torch.utils.comm import resolve_device

__all__ = ['DecodeCache', 'init_cache', 'append_kv', 'decode_attention',
           'decode_step']


class DecodeCache(NamedTuple):
    """Static-shape KV cache: ``k``/``v`` are ``(B, H_kv, t_max, d·)``
    buffers, ``length`` the number of filled positions (host int)."""
    k: torch.Tensor
    v: torch.Tensor
    length: int

    @property
    def t_max(self):
        return self.k.shape[-2]


def _unported(fn, **kw):
    for name, value in kw.items():
        if value is not None:
            raise NotImplementedError(f'{fn}({name}=...) is not ported yet')


def init_cache(batch, kv_heads, t_max, head_dim, v_head_dim=None,
               dtype=torch.bfloat16, qk_quant=None, device='cuda'):
    """Zero cache for ``t_max`` positions on ``device``."""
    if qk_quant not in (None, 'int8'):
        raise ValueError(f"qk_quant must be None or 'int8', "
                         f'got {qk_quant!r}')
    _unported('init_cache', qk_quant=qk_quant)
    dev = resolve_device(device)
    v_head_dim = v_head_dim or head_dim
    return DecodeCache(
        k=torch.zeros((batch, kv_heads, t_max, head_dim), dtype=dtype,
                      device=dev),
        v=torch.zeros((batch, kv_heads, t_max, v_head_dim), dtype=dtype,
                      device=dev),
        length=0)


def _check_room(cache, n):
    if n > cache.t_max:
        raise ValueError(f'appending {n} positions to a t_max='
                         f'{cache.t_max} cache')
    if cache.length + n > cache.t_max:
        raise ValueError(
            f'KV-cache overflow: length {cache.length} + {n} new positions '
            f'exceeds t_max {cache.t_max} — grow the cache or stop the '
            f'generation loop')


def append_kv(cache: DecodeCache, k_new, v_new) -> DecodeCache:
    """Append ``k_new``/``v_new`` ``(B, H_kv, n, d·)`` at the cache head,
    writing the buffers in place; returns the cache with the length
    advanced. Appending past ``t_max`` raises and writes nothing."""
    n = k_new.shape[-2]
    _check_room(cache, n)
    end = cache.length + n
    cache.k[:, :, cache.length:end] = k_new.to(cache.k.dtype)
    cache.v[:, :, cache.length:end] = v_new.to(cache.v.dtype)
    return cache._replace(length=end)


def decode_attention(q, cache: DecodeCache, *, scale=None, window=None,
                     alibi_slopes=None, segment_ids=None, seg_q=None,
                     qk_quant=None, axis_name=None, col_valid=None,
                     col_offset=None):
    """Masked-softmax attention of ``q (B, H, n, d)`` — the LAST ``n``
    appended positions — against the cache prefix; returns
    ``(B, H, n, d_v)`` in the cache dtype. Float32 scores and weights;
    a row with no attendable column returns 0."""
    _unported('decode_attention', window=window, alibi_slopes=alibi_slopes,
              segment_ids=segment_ids, seg_q=seg_q, qk_quant=qk_quant,
              axis_name=axis_name, col_valid=col_valid,
              col_offset=col_offset)
    b, h, n, d = q.shape
    h_kv = cache.k.shape[1]
    if h % h_kv:
        raise ValueError(f'query heads {h} must be a multiple of cache '
                         f'kv heads {h_kv}')
    group = h // h_kv
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    t_max = cache.t_max
    qg = q.reshape(b, h_kv, group * n, d).float()
    s = torch.matmul(qg, cache.k.float().transpose(-1, -2)) * scale
    s = s.reshape(b, h_kv, group, n, t_max)
    # Query row i sits at position length - n + i and attends positions
    # at or before its own.
    pos_q = cache.length - n + torch.arange(n, device=q.device)
    pos_k = torch.arange(t_max, device=q.device)
    allowed = pos_k[None, :] <= pos_q[:, None]                 # (n, t_max)
    s = s.masked_fill(~allowed, float('-inf'))
    m = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)          # empty rows
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(denom == 0.0, 1.0, denom)
    out = torch.matmul(p, cache.v.float()[:, :, None])
    return out.to(cache.v.dtype).reshape(b, h, n, cache.v.shape[-1])


def decode_step(q, cache: DecodeCache, k_new, v_new, *, slot_mask=None,
                counts=None, scale=None, window=None, alibi_slopes=None,
                segment_ids=None, seg_q=None, qk_quant=None, axis_name=None,
                impl=None, interpret=None):
    """One fused decode step: append ``k_new``/``v_new`` ``(B, H_kv, 1,
    d)`` to the cache (in place) AND attend ``q (B, H, 1, d)`` against
    the result. ``impl``: ``None``/``'auto'``/``'kernel'`` run the K5
    port (CUDA kernel for CUDA tensors, its plain version for CPU
    tensors); ``'plain'`` runs :func:`append_kv` + :func:`decode_attention`
    (any ``n``). Returns ``(cache, out (B, H, n, d_v))``."""
    _unported('decode_step', slot_mask=slot_mask, counts=counts,
              window=window, alibi_slopes=alibi_slopes,
              segment_ids=segment_ids, seg_q=seg_q, qk_quant=qk_quant,
              axis_name=axis_name)
    if impl not in (None, 'auto', 'kernel', 'plain'):
        raise ValueError(f"decode impl must be None/'auto'/'kernel'/"
                         f"'plain', got {impl!r}")
    if impl == 'plain':
        cache = append_kv(cache, k_new, v_new)
        return cache, decode_attention(q, cache, scale=scale)
    n = q.shape[-2]
    if n != 1:
        raise NotImplementedError(
            f'the fused decode kernel takes one new row per step (verify-k '
            f'is not ported yet), got n={n}; use impl="plain"')
    _check_room(cache, n)
    rows = torch.full((q.shape[0],), cache.length, dtype=torch.int32,
                      device=cache.k.device)
    out, _, _ = flash_decode(q, k_new, v_new, cache.k, cache.v, rows, rows,
                             scale=scale, interpret=interpret)
    return cache._replace(length=cache.length + n), out
