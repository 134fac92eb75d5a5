# -*- coding: utf-8 -*-
"""
Fused KV-cache decode step — the port of kernels K5 and K5p,
``_make_decode_kernel`` (slab body ``kernel_body`` and paged body
``kernel_paged``) in ``distributed_dot_product_tpu/ops/pallas_decode.py``.

One call appends each slot's new k/v row to the cache IN PLACE at
``append_at`` and attends the slot's query heads against the cache
prefix ``0..valid_to`` (the appended row included), GQA native. Layouts
follow the reference: ``q (B, H, 1, d)``, ``k_new/v_new (B, H_kv, 1,
d)``, ``cache_k/cache_v (B, H_kv, t_max, d)``, ``valid_to/append_at
(B,)`` int (``append_at = -1`` appends nothing; otherwise it must equal
``valid_to``, the standard causal decode order; ``valid_to < 0`` gives a
zero output row).

PAGED mode (``page_table (B, pages_per_slot) int32``, K5p):
``cache_k/cache_v`` are global ``(pages + 1, H_kv, page_size, d)``
pools whose last row is the reserved sink page. Column ``c`` of slot
``i`` lives at row ``c % page_size`` of pool page
``page_table[i, c // page_size]``; a ``-1`` entry is never scored and
never written, and the append lands only through the table. The port
writes nothing to the sink (the TPU kernel parks Pallas's mandatory
block write-backs there; CUDA has no such flush).

On CUDA tensors it launches ``csrc/flash_decode.cu`` (split-K
flash-decoding plus a merge pass; bf16, head dims 32/64/96/128; paged,
page sizes dividing 128) or raises; on CPU tensors it runs
:func:`flash_decode_plain`. The reference's verify-k rows, per-slot
counts, int8 mirror, window, ALiBi, ``block_k`` and ``partials`` raise
``NotImplementedError`` until a later slice ports them.
"""

import ctypes
import math

import torch

from distributed_dot_product_tpu_torch.ops import _build
from distributed_dot_product_tpu_torch.ops.flash_attention import (
    _LOG2E, _NEG_BIG,
)

__all__ = ['flash_decode', 'flash_decode_paged', 'flash_decode_plain',
           'gather_pages']

_KERNEL_HEAD_DIMS = (32, 64, 96, 128)
_UNPORTED = ('n_new', 'k_q', 'k_scale', 'window',
             'alibi_slopes', 'qk_quant', 'block_k')


def _slot_vector(x, b, device):
    x = torch.as_tensor(x, device=device).to(torch.int32).reshape(-1)
    if x.numel() != b:
        raise ValueError(f'per-slot vector has {x.numel()} entries for '
                         f'batch {b}')
    return x.contiguous()


def gather_pages(pool, page_table):
    """Slab view ``(B, H_kv, pages_per_slot * page_size, d)`` of a page
    pool through ``page_table``; ``-1`` entries read zeros."""
    pt = page_table.long()
    b, npg = pt.shape
    h_kv, ps, d = pool.shape[1:]
    x = pool[pt.clamp_min(0).reshape(-1)].reshape(b, npg, h_kv, ps, d)
    x = torch.where((pt >= 0)[:, :, None, None, None], x, 0)
    return x.transpose(1, 2).reshape(b, h_kv, npg * ps, d)


def _attend_plain(q, cache_k, cache_v, vt, scale, col_ok=None):
    """Masked attention of ``q (B, H, 1, d)`` over slab-layout caches,
    columns ``0..vt[b]`` (and ``col_ok``, when given): the kernel's
    numerics (q pre-scaled by ``scale*log2(e)`` and rounded to the cache
    dtype, float32 scores, exp2 softmax, empty rows 0)."""
    b, h, _, d = q.shape
    h_kv, t_max = cache_k.shape[1], cache_k.shape[2]
    group = h // h_kv
    qg = (q.float() * (scale * _LOG2E)).to(cache_k.dtype).float()
    qg = qg.reshape(b, h_kv, group, d)
    s = torch.matmul(qg, cache_k.float().transpose(-1, -2))  # (b,hkv,g,t)
    cols = torch.arange(t_max, device=cache_k.device)
    masked = cols[None, :] > vt[:, None]                       # (b, t)
    if col_ok is not None:
        masked = masked | ~col_ok
    s = s.masked_fill(masked[:, None, None, :], float('-inf'))
    m = s.amax(dim=-1, keepdim=True).clamp_min(_NEG_BIG)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, cache_v.float()) / torch.where(l == 0.0, 1.0, l)
    return out.reshape(b, h, 1, cache_v.shape[-1]).to(cache_v.dtype)


def flash_decode_plain(q, k_new, v_new, cache_k, cache_v, valid_to,
                       append_at, *, scale=None, page_table=None):
    """The kernel's arithmetic in plain PyTorch (float32 scores); appends
    in place like the kernel. With ``page_table``: the append scatters
    through the table (nothing where ``append_at < 0`` or the entry is
    ``-1``), then the slab arithmetic runs on the gathered view with
    ``-1`` columns masked. Returns ``(out, cache_k, cache_v)``."""
    b, _, _, d = q.shape
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    dev = cache_k.device
    vt = _slot_vector(valid_to, b, dev).long()
    ap = _slot_vector(append_at, b, dev).long()
    if page_table is None:
        t_max = cache_k.shape[2]
        rows = torch.nonzero((ap >= 0) & (ap < t_max)).reshape(-1)
        cache_k[rows, :, ap[rows]] = k_new[rows, :, 0].to(cache_k.dtype)
        cache_v[rows, :, ap[rows]] = v_new[rows, :, 0].to(cache_v.dtype)
        return (_attend_plain(q, cache_k, cache_v, vt, scale), cache_k,
                cache_v)
    pt = page_table.to(dev).long()
    ps = cache_k.shape[2]
    t_max = pt.shape[1] * ps
    rows = torch.nonzero((ap >= 0) & (ap < t_max)).reshape(-1)
    pg = pt[rows, ap[rows] // ps]
    rows, pg = rows[pg >= 0], pg[pg >= 0]
    rw = ap[rows] % ps
    cache_k[pg, :, rw] = k_new[rows, :, 0].to(cache_k.dtype)
    cache_v[pg, :, rw] = v_new[rows, :, 0].to(cache_v.dtype)
    col_ok = (pt >= 0).repeat_interleave(ps, dim=1)
    out = _attend_plain(q, gather_pages(cache_k, pt),
                        gather_pages(cache_v, pt), vt, scale, col_ok)
    return out, cache_k, cache_v


def _kernel_lib():
    lib = _build.load('flash_decode')
    if lib.flash_decode_bf16.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_decode_bf16.argtypes = (
            [vp] * 10 + [i, i, i, i, i, ctypes.c_float, vp])
        lib.flash_decode_paged_bf16.argtypes = (
            [vp] * 11 + [i, i, i, i, i, i, ctypes.c_float, vp])
        for fn in (lib.flash_decode_bf16, lib.flash_decode_paged_bf16):
            fn.restype = ctypes.c_int
        lib.flash_decode_chunk.argtypes = []
        lib.flash_decode_chunk.restype = ctypes.c_int
    return lib


def _launch(q, k_new, v_new, cache_k, cache_v, valid_to, append_at, scale,
            page_table=None):
    b, h, _, d = q.shape
    h_kv = cache_k.shape[1]
    dev = cache_k.device
    for name, t in (('q', q), ('k_new', k_new), ('v_new', v_new),
                    ('cache_k', cache_k), ('cache_v', cache_v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f'the CUDA decode kernel takes bf16; {name} is '
                            f'{t.dtype}')
        if t.device != dev:
            raise ValueError(f'{name} is on {t.device}, the cache on {dev}')
    if d not in _KERNEL_HEAD_DIMS or cache_v.shape[-1] != d:
        raise NotImplementedError(
            f'the CUDA decode kernel covers head dims {_KERNEL_HEAD_DIMS} '
            f'with d_v == d; got q {tuple(q.shape)}, cache_v '
            f'{tuple(cache_v.shape)}')
    if not (cache_k.is_contiguous() and cache_v.is_contiguous()):
        raise ValueError('the cache is appended in place and must be '
                         'contiguous')
    q, k_new, v_new = q.contiguous(), k_new.contiguous(), v_new.contiguous()
    vt = _slot_vector(valid_to, b, dev)
    ap = _slot_vector(append_at, b, dev)
    lib = _kernel_lib()
    chunk = lib.flash_decode_chunk()
    if page_table is None:
        t_max = cache_k.shape[2]
    else:
        ps = cache_k.shape[2]
        if chunk % ps:
            raise NotImplementedError(
                f'the paged CUDA decode kernel takes page sizes dividing '
                f'{chunk}; got {ps}')
        if page_table.dtype != torch.int32 or page_table.device != dev \
                or not page_table.is_contiguous() \
                or page_table.shape[0] != b:
            raise ValueError(
                f'page_table must be a contiguous ({b}, pages_per_slot) '
                f'int32 tensor on {dev}; got {page_table.dtype} '
                f'{tuple(page_table.shape)} on {page_table.device}')
        t_max = page_table.shape[1] * ps
    n_splits = -(-t_max // chunk)
    part_acc = torch.empty((b * h, n_splits, d), dtype=torch.float32,
                           device=dev)
    part_ml = torch.empty((b * h, n_splits, 2), dtype=torch.float32,
                          device=dev)
    out = torch.empty((b, h, 1, d), dtype=cache_v.dtype, device=dev)
    for t in (q, k_new, v_new, cache_k, cache_v, out):
        if t.data_ptr() % 16:
            raise ValueError('the CUDA decode kernel needs 16-byte aligned '
                             'tensors')
    ptrs = (q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            cache_k.data_ptr(), cache_v.data_ptr(), vt.data_ptr(),
            ap.data_ptr())
    scratch = (part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if page_table is None:
            err = lib.flash_decode_bf16(*ptrs, *scratch, b, h, h_kv, t_max,
                                        d, scale * _LOG2E, stream)
        else:
            err = lib.flash_decode_paged_bf16(
                *ptrs, page_table.data_ptr(), *scratch, b, h, h_kv,
                page_table.shape[1], ps, d, scale * _LOG2E, stream)
    if err:
        raise RuntimeError(f'flash_decode kernel launch failed: CUDA error '
                           f'{err}')
    if page_table is None:
        flash_decode.launches += 1
    else:
        flash_decode_paged.launches += 1
    return out, cache_k, cache_v


def flash_decode(q, k_new, v_new, cache_k, cache_v, valid_to, append_at, *,
                 page_table=None, scale=None, interpret=None, partials=False,
                 **unported):
    """One fused decode step (see the module docstring). Returns
    ``(out (B, H, 1, d) in cache_v.dtype, cache_k, cache_v)``; the cache
    tensors (slabs, or pools with ``page_table``) are the ones passed in,
    appended in place.

    ``interpret`` mirrors the reference knob: the plain version runs only
    for CPU tensors, so ``interpret=True`` with CUDA tensors raises."""
    for name, value in unported.items():
        if name not in _UNPORTED:
            raise TypeError(f'flash_decode got an unexpected keyword '
                            f'argument {name!r}')
        if value is not None:
            raise NotImplementedError(f'flash_decode({name}=...) is not '
                                      f'ported yet')
    if partials:
        raise NotImplementedError('flash_decode(partials=True) is not '
                                  'ported yet')
    b, h, n, d = q.shape
    if n != 1:
        raise NotImplementedError(f'flash_decode takes one new row per slot '
                                  f'(verify-k is not ported yet), got {n}')
    h_kv = cache_k.shape[1]
    if h % h_kv:
        raise ValueError(f'query heads {h} must be a multiple of cache kv '
                         f'heads {h_kv}')
    if tuple(k_new.shape) != (b, h_kv, 1, d) or tuple(v_new.shape) != (
            b, h_kv, 1, cache_v.shape[-1]):
        raise ValueError(f'k_new/v_new must be (B, H_kv, 1, d); got '
                         f'{tuple(k_new.shape)}, {tuple(v_new.shape)}')
    scale = float(1.0 / math.sqrt(d) if scale is None else scale)
    if page_table is not None and page_table.shape[0] != b:
        raise ValueError(f'page_table has {page_table.shape[0]} rows for '
                         f'batch {b}')
    if cache_k.is_cuda:
        if interpret:
            raise ValueError('interpret=True runs the plain version, which '
                             'the port keeps for CPU tensors only')
        return _launch(q, k_new, v_new, cache_k, cache_v, valid_to,
                       append_at, scale, page_table=page_table)
    if interpret is False:
        raise ValueError('interpret=False needs CUDA tensors: the kernel '
                         'runs only on the card')
    return flash_decode_plain(q, k_new, v_new, cache_k, cache_v, valid_to,
                              append_at, scale=scale, page_table=page_table)


def flash_decode_paged(q, k_new, v_new, k_pool, v_pool, valid_to, append_at,
                       page_table, **kw):
    """The paged step (K5p): ``flash_decode(..., page_table=page_table)``,
    named so its launch counter sits beside K5's."""
    return flash_decode(q, k_new, v_new, k_pool, v_pool, valid_to,
                        append_at, page_table=page_table, **kw)


# Launches of the CUDA kernel pairs, slab (K5) and paged (K5p), each
# counted where it is launched and nowhere else.
flash_decode.launches = 0
flash_decode_paged.launches = 0
