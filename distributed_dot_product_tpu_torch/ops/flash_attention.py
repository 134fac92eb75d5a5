# -*- coding: utf-8 -*-
"""
Fused flash attention and its gradient — the port of kernel K1,
``_make_fwd_kernel``, and of the backward pair K3 ``_make_dq_kernel`` and
K4 ``_make_dkv_kernel`` in
``distributed_dot_product_tpu/ops/pallas_attention.py`` (exact softmax
mode).

:func:`flash_attention` keeps the reference signature and layouts:
``q (..., Tq, d)``, ``k/v (..., Tk, d)``, heads on axis -3, and GQA by
fewer k/v heads (each group of ``Hq/Hkv`` consecutive query heads
attends one k/v head). Causal masking is over global positions: query
row ``i`` sits at ``causal_offset + i`` and attends key columns
``j <= causal_offset + i`` — so a prefill can pass a whole cache buffer
as k/v (``Tq != Tk``) and its unfilled tail is never attended.

It differentiates like the reference's ``custom_vjp``: when a gradient
is wanted, the forward saves ``(q, k, v, out, lse)`` with the row
logsumexp, and the backward recomputes the softmax weights from ``lse``
(``Δ = rowsum(dO⊙O)``, ``p = exp2(s₂ − lse₂)``, ``ds = p⊙(dO·vᵀ − Δ)``,
``dq = scale·ds·k``, ``dk = dsᵀ·q₂/log2e``, ``dv = pᵀ·dO``; GQA dk/dv
summed over the group).

On CUDA tensors each pass launches its hand-written kernel or raises
(``csrc/flash_fwd.cu`` for the forward with its optional LSE output,
``csrc/flash_bwd.cu`` for dq and dk/dv: bf16, head dims 32/64/96/128,
``d_v == d``); on CPU tensors each runs its plain PyTorch version. Every
other knob of the reference signature (dense mask, ``kv_offset``,
bounded softmax, segments, positions, window, ALiBi, int8 scoring,
dropout) raises ``NotImplementedError`` until a later slice ports it.

Numerics (both versions): ``scale·log2(e)`` is folded into q and
rounded back to q's dtype (the exp2 trick), the softmax runs in exp2
units against a running max clamped at ``_NEG_BIG``, and a row with no
attendable key outputs exactly 0 with zero gradients.
"""

import ctypes
import math
import operator

import torch

from distributed_dot_product_tpu_torch.ops import _build

__all__ = ['flash_attention', 'flash_attention_plain',
           'flash_attention_with_lse', 'flash_attention_plain_lse',
           'flash_attention_bwd_operands', 'flash_attention_dq',
           'flash_attention_dq_plain', 'flash_attention_dkv',
           'flash_attention_dkv_plain', 'flash_attention_backward',
           'flash_attention_backward_plain']

_LOG2E = math.log2(math.e)
_LN2 = math.log(2.0)
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


def _expand_group(x, group):
    return x if group == 1 else x.repeat_interleave(group, dim=-3)


def _fold_q(q, scale):
    """q·(scale·log2e), rounded back to q's dtype (the exp2 trick)."""
    return (q.float() * (scale * _LOG2E)).to(q.dtype)


def _scores2(q2, k, causal, causal_offset):
    """Float32 scores in log2 units, the causal future at -inf."""
    s = torch.matmul(q2.float(), k.float().transpose(-1, -2))
    if causal:
        rows = causal_offset + torch.arange(q2.shape[-2], device=q2.device)
        cols = torch.arange(k.shape[-2], device=q2.device)
        s = s.masked_fill(cols[None, :] > rows[:, None], float('-inf'))
    return s


def flash_attention_plain_lse(q, k, v, *, causal=False, causal_offset=0,
                              scale=None):
    """The forward kernel's arithmetic in plain PyTorch (float32 scores):
    ``(out, lse)`` with the row logsumexp ``lse (..., Tq)`` float32 in
    natural-log units, ``ln2·(m₂ + log2 l)`` as the reference kernel
    saves it (a row with no attendable key gives ``ln2·_NEG_BIG``)."""
    group = _kv_group(q, k)
    k, v = _expand_group(k, group), _expand_group(v, group)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = _scores2(_fold_q(q, scale), k, causal, causal_offset)
    m = s.amax(dim=-1, keepdim=True).clamp_min(_NEG_BIG)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, 1.0, l)
    out = torch.matmul(p, v.float()) / safe_l
    lse = _LN2 * (m + torch.log2(safe_l))
    return out.to(v.dtype), lse[..., 0]


def flash_attention_plain(q, k, v, *, causal=False, causal_offset=0,
                          scale=None):
    """The forward kernel's arithmetic in plain PyTorch: the reference
    the CPU tests and the card comparison use."""
    return flash_attention_plain_lse(q, k, v, causal=causal,
                                     causal_offset=causal_offset,
                                     scale=scale)[0]


def flash_attention_bwd_operands(q, out, lse, g, scale):
    """``(q₂, lse₂, Δ)``, what the reference computes with ``jnp``
    outside its backward kernels: the folded ``q₂``,
    ``lse₂ = max(lse·log2e, _NEG_BIG)`` (a fully masked row's lse would
    overflow to -inf and make the recompute NaN) and
    ``Δ = rowsum(dO⊙O)``, both ``(..., Tq)`` float32."""
    delta = (g.float() * out.float()).sum(dim=-1)
    lse2 = (lse.float() * _LOG2E).clamp_min(_NEG_BIG)
    return _fold_q(q, scale), lse2, delta


def _bwd_plain(q2, k, v, g, lse2, delta, causal, causal_offset, scale,
               want_dq=True, want_dkv=True):
    """The backward kernels' arithmetic in plain PyTorch, with the
    reference's casts to the operand dtype before each product and its
    per-q-head dk/dv partials summed over the GQA group in float32."""
    group = _kv_group(q2, k)
    ke, ve = _expand_group(k, group), _expand_group(v, group)
    p = torch.exp2(_scores2(q2, ke, causal, causal_offset)
                   - lse2[..., None])
    dp = torch.matmul(g.float(), ve.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    dq = dk = dv = None
    if want_dq:
        dq = (scale * torch.matmul(ds.to(k.dtype).float(), ke.float())
              ).to(q2.dtype)
    if want_dkv:
        dk = torch.matmul(ds.to(q2.dtype).float().transpose(-1, -2),
                          q2.float()) / _LOG2E
        dv = torch.matmul(p.to(g.dtype).float().transpose(-1, -2),
                          g.float())
        dk, dv = dk.to(k.dtype), dv.to(v.dtype)
        if group > 1:
            def group_sum(x, like):
                x = x.reshape(*like.shape[:-2], group, *x.shape[-2:])
                return x.float().sum(dim=-3).to(like.dtype)
            dk, dv = group_sum(dk, k), group_sum(dv, v)
    return dq, dk, dv


def flash_attention_dq_plain(q2, k, v, g, lse2, delta, *, causal=False,
                             causal_offset=0, scale=1.0):
    """The dq kernel's (K3) arithmetic in plain PyTorch."""
    return _bwd_plain(q2, k, v, g, lse2, delta, causal, causal_offset,
                      scale, want_dkv=False)[0]


def flash_attention_dkv_plain(q2, k, v, g, lse2, delta, *, causal=False,
                              causal_offset=0):
    """The dk/dv kernel's (K4) arithmetic in plain PyTorch."""
    return _bwd_plain(q2, k, v, g, lse2, delta, causal, causal_offset, 1.0,
                      want_dq=False)[1:]


def flash_attention_backward_plain(q, k, v, out, lse, g, causal=False,
                                   causal_offset=0, scale=None):
    """``(dq, dk, dv)`` of :func:`flash_attention` from its saved
    ``(out, lse)`` and the output cotangent ``g``, in plain PyTorch: the
    arithmetic of the reference's ``_flash_bwd_impl``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    q2, lse2, delta = flash_attention_bwd_operands(q, out, lse, g, scale)
    return _bwd_plain(q2, k, v, g, lse2, delta, causal, causal_offset,
                      scale)


def _cfn(name, symbol, argtypes):
    fn = getattr(_build.load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _check_kernel_operands(named, d):
    """Raise on what the CUDA kernels do not take: they read contiguous
    bf16 rows of head dim 32/64/96/128 on one device, 16-byte aligned."""
    dev = named[0][1].device
    for name, t in named:
        if t.dtype != torch.bfloat16:
            raise TypeError(f'the CUDA flash kernels take bf16; {name} is '
                            f'{t.dtype}')
        if t.device != dev:
            raise ValueError(f'{name} is on {t.device}, not {dev}')
        if t.shape[-1] != d:
            raise NotImplementedError(
                f'the CUDA flash kernels need d_v == d; {name} is '
                f'{tuple(t.shape)}')
    if d not in _KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f'the CUDA flash kernels cover head dims {_KERNEL_HEAD_DIMS}, '
            f'got {d}')


def _rows(q):
    nb = math.prod(q.shape[:-2])
    if nb > 65535:
        raise NotImplementedError(f'{nb} (batch, head) rows exceed the '
                                  f'grid limit 65535')
    return nb


def _ptrs(*tensors):
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError('the CUDA flash kernels need 16-byte aligned '
                             'tensors')
    return [t.data_ptr() for t in tensors]


def _raise_on(err, what):
    if err:
        raise RuntimeError(f'{what} kernel launch failed: CUDA error {err}')


def _launch(q, k, v, causal, causal_offset, scale, save_lse=False):
    """K1 on the card: ``out``, or ``(out, lse)`` with ``save_lse``."""
    _check_kernel_operands((('q', q), ('k', k), ('v', v)), q.shape[-1])
    group = _kv_group(q, k)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    nb, tq, tk, d = _rows(q), q.shape[-2], k.shape[-2], q.shape[-1]
    out = torch.empty(q.shape, dtype=v.dtype, device=q.device)
    lse = (torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
           if save_lse else None)
    fn = _cfn('flash_fwd', 'flash_fwd_bf16',
              [_VP] * 5 + [_I] * 7 + [_F, _VP])
    with torch.cuda.device(q.device):
        err = fn(*_ptrs(q, k, v, out), None if lse is None else lse.data_ptr(),
                 nb, group, tq, tk, d, int(causal), causal_offset,
                 scale * _LOG2E, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, 'flash_fwd')
    flash_attention.launches += 1
    return out if lse is None else (out, lse)


def flash_attention_dq(q2, k, v, g, lse2, delta, *, causal=False,
                       causal_offset=0, scale=1.0):
    """dq from the folded operands (K3): ``q2`` is q·(scale·log2e),
    ``lse2`` and ``delta`` are ``(..., Tq)`` float32 (see
    :func:`flash_attention_backward`). The CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if not q2.is_cuda:
        return flash_attention_dq_plain(q2, k, v, g, lse2, delta,
                                        causal=causal,
                                        causal_offset=causal_offset,
                                        scale=scale)
    _check_kernel_operands((('q', q2), ('k', k), ('v', v), ('g', g)),
                           q2.shape[-1])
    group = _kv_group(q2, k)
    q2, k, v, g = (t.contiguous() for t in (q2, k, v, g))
    lse2, delta = lse2.float().contiguous(), delta.float().contiguous()
    nb, tq, tk, d = _rows(q2), q2.shape[-2], k.shape[-2], q2.shape[-1]
    dq = torch.empty(q2.shape, dtype=q2.dtype, device=q2.device)
    fn = _cfn('flash_bwd', 'flash_bwd_dq_bf16',
              [_VP] * 7 + [_I] * 7 + [_F, _VP])
    with torch.cuda.device(q2.device):
        err = fn(*_ptrs(q2, k, v, g, lse2, delta, dq), nb, group, tq, tk,
                 d, int(causal), causal_offset, scale,
                 torch.cuda.current_stream().cuda_stream)
    _raise_on(err, 'flash_bwd_dq')
    flash_attention_dq.launches += 1
    return dq


def flash_attention_dkv(q2, k, v, g, lse2, delta, *, causal=False,
                        causal_offset=0):
    """``(dk, dv)`` from the folded operands (K4), kv-head shaped: each
    GQA group's query heads are summed in float32. The CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if not q2.is_cuda:
        return flash_attention_dkv_plain(q2, k, v, g, lse2, delta,
                                         causal=causal,
                                         causal_offset=causal_offset)
    _check_kernel_operands((('q', q2), ('k', k), ('v', v), ('g', g)),
                           q2.shape[-1])
    group = _kv_group(q2, k)
    q2, k, v, g = (t.contiguous() for t in (q2, k, v, g))
    lse2, delta = lse2.float().contiguous(), delta.float().contiguous()
    nb, tq, tk, d = _rows(q2), q2.shape[-2], k.shape[-2], q2.shape[-1]
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    fn = _cfn('flash_bwd', 'flash_bwd_dkv_bf16',
              [_VP] * 8 + [_I] * 7 + [_VP])
    with torch.cuda.device(q2.device):
        err = fn(*_ptrs(q2, k, v, g, lse2, delta, dk, dv), nb, group, tq,
                 tk, d, int(causal), causal_offset,
                 torch.cuda.current_stream().cuda_stream)
    _raise_on(err, 'flash_bwd_dkv')
    flash_attention_dkv.launches += 1
    return dk, dv


def flash_attention_backward(q, k, v, out, lse, g, causal=False,
                             causal_offset=0, scale=None):
    """``(dq, dk, dv)`` of :func:`flash_attention`: ``Δ``, ``q₂`` and
    ``lse₂`` in plain PyTorch (the reference computes them with ``jnp``
    outside its kernels), then K3 and K4 (their plain versions for CPU
    tensors)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    q2, lse2, delta = flash_attention_bwd_operands(q, out, lse, g, scale)
    kw = dict(causal=causal, causal_offset=causal_offset)
    dq = flash_attention_dq(q2, k, v, g, lse2, delta, scale=scale, **kw)
    dk, dv = flash_attention_dkv(q2, k, v, g, lse2, delta, **kw)
    return dq, dk, dv


def flash_attention_with_lse(q, k, v, *, causal=False, causal_offset=0,
                             scale=None):
    """``(out, lse)``: the forward with the row logsumexp ``(..., Tq)``
    float32 the backward recomputes from — K1 with its LSE output for
    CUDA tensors, :func:`flash_attention_plain_lse` for CPU tensors."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        return _launch(q, k, v, bool(causal), causal_offset, float(scale),
                       save_lse=True)
    return flash_attention_plain_lse(q, k, v, causal=causal,
                                     causal_offset=causal_offset,
                                     scale=scale)


class _FlashAttention(torch.autograd.Function):
    """The reference's ``custom_vjp`` pair (``_flash_fwd``/
    ``_flash_bwd``): the forward saves ``(q, k, v, out, lse)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, causal_offset, scale):
        out, lse = flash_attention_with_lse(q, k, v, causal=causal,
                                            causal_offset=causal_offset,
                                            scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, causal_offset, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, g,
                                              *ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, mask=None, *, causal=False, causal_offset=0,
                    scale=None, interpret=None, **unported):
    """Fused attention ``softmax(q·kᵀ·scale)·v`` (see the module
    docstring for layouts and numerics), differentiable in q, k and v.

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
    scale, causal = float(scale), bool(causal)
    if q.is_cuda and interpret:
        raise ValueError('interpret=True runs the plain version, which '
                         'the port keeps for CPU tensors only')
    if not q.is_cuda and interpret is False:
        raise ValueError('interpret=False needs CUDA tensors: the kernel '
                         'runs only on the card')
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, causal_offset, scale)
    if q.is_cuda:
        return _launch(q, k, v, causal, causal_offset, scale)
    return flash_attention_plain(q, k, v, causal=causal,
                                 causal_offset=causal_offset, scale=scale)


# Launches of each CUDA kernel (counted where it is launched, nowhere
# else): K1 forward, K3 dq, K4 dk/dv.
flash_attention.launches = 0
flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0
