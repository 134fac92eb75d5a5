# -*- coding: utf-8 -*-
"""
Fused flash-attention forward — the port of kernel K1,
``_make_fwd_kernel`` in ``distributed_dot_product_tpu/ops/pallas_attention.py``
(exact softmax mode).

:func:`flash_attention` keeps the reference signature and layouts:
``q (..., Tq, d)``, ``k/v (..., Tk, d)``, heads on axis -3, and GQA by
fewer k/v heads (each group of ``Hq/Hkv`` consecutive query heads
attends one k/v head). Causal masking is over global positions: query
row ``i`` sits at ``causal_offset + i`` and attends key columns
``j <= causal_offset + i`` — so a prefill can pass a whole cache buffer
as k/v (``Tq != Tk``) and its unfilled tail is never attended.

On a CUDA tensor it launches the hand-written kernel
(``csrc/flash_fwd.cu``: bf16, head dims 32/64/96/128, ``d_v == d``) or
raises; on a CPU tensor it runs :func:`flash_attention_plain`, the same
arithmetic in plain PyTorch. Every other knob of the reference signature
(dense mask, ``kv_offset``, bounded softmax, segments, positions,
window, ALiBi, int8 scoring, dropout) raises ``NotImplementedError``
until a later slice ports it.

Numerics (both versions): ``scale·log2(e)`` is folded into q and
rounded back to q's dtype (the exp2 trick), the softmax runs in exp2
units against a running max clamped at ``_NEG_BIG``, and a row with no
attendable key outputs exactly 0.
"""

import ctypes
import math
import operator

import torch

from distributed_dot_product_tpu_torch.ops import _build

__all__ = ['flash_attention', 'flash_attention_plain']

_LOG2E = math.log2(math.e)
_NEG_BIG = -0.7 * 3.4e38   # large-finite fp32 running-max floor
_KERNEL_HEAD_DIMS = (32, 64, 96, 128)

_UNPORTED_DEFAULTS = dict(kv_offset=0, softmax_mode='exact',
                          segment_ids=None, positions=None, window=None,
                          alibi_slopes=None, qk_quant=None,
                          dropout_rate=0.0, dropout_seed=None)


def _kv_group(q, k):
    """How many consecutive query heads share one k/v head (1 = standard
    multi-head); lead dims must match except the head axis (-3)."""
    if tuple(k.shape[:-2]) == tuple(q.shape[:-2]):
        return 1
    if (q.dim() < 3 or k.dim() != q.dim()
            or k.shape[:-3] != q.shape[:-3]
            or q.shape[-3] % k.shape[-3]):
        raise ValueError(
            f'k/v lead dims {tuple(k.shape[:-2])} must equal q lead dims '
            f'{tuple(q.shape[:-2])} or differ only on the head axis (-3) '
            f'with q heads divisible by kv heads (GQA)')
    return q.shape[-3] // k.shape[-3]


def flash_attention_plain(q, k, v, *, causal=False, causal_offset=0,
                          scale=None):
    """The kernel's arithmetic in plain PyTorch (float32 scores): the
    reference the CPU tests and the card comparison use."""
    group = _kv_group(q, k)
    if group > 1:
        k = k.repeat_interleave(group, dim=-3)
        v = v.repeat_interleave(group, dim=-3)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    tq, tk = q.shape[-2], k.shape[-2]
    q2 = (q.float() * (scale * _LOG2E)).to(q.dtype)
    s = torch.matmul(q2.float(), k.float().transpose(-1, -2))
    if causal:
        rows = causal_offset + torch.arange(tq, device=q.device)
        cols = torch.arange(tk, device=q.device)
        s = s.masked_fill(cols[None, :] > rows[:, None], float('-inf'))
    m = s.amax(dim=-1, keepdim=True).clamp_min(_NEG_BIG)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, v.float()) / torch.where(l == 0.0, 1.0, l)
    return out.to(v.dtype)


def _kernel_fn():
    lib = _build.load('flash_fwd')
    fn = lib.flash_fwd_bf16
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, i,
                       ctypes.c_float, vp]
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, causal, causal_offset, scale):
    for name, t in (('q', q), ('k', k), ('v', v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f'the CUDA flash kernel takes bf16; {name} is '
                            f'{t.dtype}')
        if t.device != q.device:
            raise ValueError(f'{name} is on {t.device}, q on {q.device}')
    d = q.shape[-1]
    if d not in _KERNEL_HEAD_DIMS or v.shape[-1] != d or k.shape[-1] != d:
        raise NotImplementedError(
            f'the CUDA flash kernel covers head dims {_KERNEL_HEAD_DIMS} '
            f'with d_v == d; got q {tuple(q.shape)}, v {tuple(v.shape)}')
    group = _kv_group(q, k)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    *lead, tq, _ = q.shape
    tk = k.shape[-2]
    nb = math.prod(lead)
    if nb > 65535:
        raise NotImplementedError(f'{nb} (batch, head) rows exceed the '
                                  f'grid limit 65535')
    out = torch.empty(q.shape, dtype=v.dtype, device=q.device)
    for t in (q, k, v, out):
        if t.data_ptr() % 16:
            raise ValueError('the CUDA flash kernel needs 16-byte aligned '
                             'tensors')
    with torch.cuda.device(q.device):
        err = _kernel_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            nb, group, tq, tk, d, int(causal), causal_offset,
            scale * _LOG2E, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f'flash_fwd kernel launch failed: CUDA error '
                           f'{err}')
    flash_attention.launches += 1
    return out


def flash_attention(q, k, v, mask=None, *, causal=False, causal_offset=0,
                    scale=None, interpret=None, **unported):
    """Fused attention ``softmax(q·kᵀ·scale)·v`` (see the module
    docstring for layouts and numerics).

    ``causal_offset`` is the global position of query row 0, a host int.
    ``interpret`` mirrors the reference knob: the plain version runs
    only for CPU tensors, so ``interpret=True`` with a CUDA tensor
    raises. The other keyword arguments of the reference signature raise
    ``NotImplementedError`` unless left at their defaults."""
    for name, value in unported.items():
        if name not in _UNPORTED_DEFAULTS:
            raise TypeError(f'flash_attention got an unexpected keyword '
                            f'argument {name!r}')
        if value is not None and not (
                isinstance(value, (int, float, str))
                and value == _UNPORTED_DEFAULTS[name]):
            raise NotImplementedError(f'flash_attention({name}=...) is not '
                                      f'ported yet')
    if mask is not None:
        raise NotImplementedError('flash_attention(mask=...) is not ported '
                                  'yet')
    if v.shape[:-2] != k.shape[:-2] or v.shape[-2] != k.shape[-2]:
        raise ValueError(
            f'k and v must agree on lead dims and Tk; got k '
            f'{tuple(k.shape)}, v {tuple(v.shape)}')
    _kv_group(q, k)
    causal_offset = operator.index(causal_offset)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scale = float(scale)
    if q.is_cuda:
        if interpret:
            raise ValueError('interpret=True runs the plain version, which '
                             'the port keeps for CPU tensors only')
        return _launch(q, k, v, bool(causal), causal_offset, scale)
    if interpret is False:
        raise ValueError('interpret=False needs CUDA tensors: the kernel '
                         'runs only on the card')
    return flash_attention_plain(q, k, v, causal=causal,
                                 causal_offset=causal_offset, scale=scale)


# Launches of the CUDA kernel (counted where it is launched, nowhere else).
flash_attention.launches = 0
