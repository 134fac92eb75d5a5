# -*- coding: utf-8 -*-
"""
Fused flash attention and its gradient — the port of kernel K1,
``_make_fwd_kernel``, its bounded-softmax variant K2,
``_make_fwd_kernel_bounded``, and the backward pair K3 ``_make_dq_kernel``
and K4 ``_make_dkv_kernel`` in
``distributed_dot_product_tpu/ops/pallas_attention.py``.

:func:`flash_attention` keeps the reference signature and layouts:
``q (..., Tq, d)``, ``k/v (..., Tk, d)``, heads on axis -3, and GQA by
fewer k/v heads (each group of ``Hq/Hkv`` consecutive query heads
attends one k/v head).

Masking, as in the reference:

- ``mask``: boolean ``(..., Tq, Tk)``, True = masked out, broadcast over
  q's lead dims (a head-broadcast ``(B, 1, Tq, Tk)`` mask, or a column
  slice of a wider one, reaches the kernels through strides, uncopied);
- causal over global positions: query row ``i`` sits at
  ``causal_offset + i``, key column ``j`` at ``kv_offset + j``, and row
  ``i`` attends column ``j`` when ``causal_offset + i >= kv_offset + j``
  — so a prefill can pass a whole cache buffer as k/v and its unfilled
  tail is never attended, and a ring fold passes its rotating block's
  global column offset as ``kv_offset``.

A row with no attendable key outputs exactly 0, saves the row
logsumexp ``ln2·_NEG_BIG`` and gets zero gradients; the ring merge and
its backward rely on exactly that.

``softmax_mode='bounded'`` runs K2: the running max is replaced by the
per-row Cauchy-Schwarz bound ``‖q₂ᵢ‖·maxⱼ‖kⱼ‖ + 1`` (log2 units, computed
here as the reference computes it). The reference's guard stays: when
``2·max(bound) > _BOUNDED_SAFE_GAP`` some row could underflow, and K1
runs instead. The guard is a host decision, one ``.item()`` sync per
call; it picks K2 exactly when the reference's ``lax.cond`` does.

It differentiates like the reference's ``custom_vjp``: when a gradient
is wanted, the forward saves ``(q, k, v, out, lse)`` with the row
logsumexp, and the backward recomputes the softmax weights from ``lse``
(``Δ = rowsum(dO⊙O)``, ``p = exp2(s₂ − lse₂)``, ``ds = p⊙(dO·vᵀ − Δ)``,
``dq = scale·ds·k``, ``dk = dsᵀ·q₂/log2e``, ``dv = pᵀ·dO``; GQA dk/dv
summed over the group) — the same K3/K4 whichever forward ran, as in the
reference. ``grad_dtype=torch.float32`` writes the gradients in float32
(the ring sums W fold partials without W roundings).

On CUDA tensors each pass launches its hand-written kernel or raises
(``csrc/flash_fwd.cu`` for K1 and K2, ``csrc/flash_bwd.cu`` for K3 and
K4: bf16, head dims 32/64/96/128, ``d_v == d``); on CPU tensors each
runs its plain PyTorch version. The other knobs of the reference
signature (segments, positions, window, ALiBi, int8 scoring, dropout)
raise ``NotImplementedError`` until a later slice ports them.

Numerics (both versions): ``scale·log2(e)`` is folded into q and
rounded back to q's dtype (the exp2 trick), and the softmax runs in exp2
units against a running max clamped at ``_NEG_BIG`` (K1) or the row's
bound (K2).
"""

import ctypes
import math
import operator

import torch

from distributed_dot_product_tpu_torch.ops import _build

__all__ = ['flash_attention', 'flash_attention_plain',
           'flash_attention_with_lse', 'flash_attention_plain_lse',
           'flash_attention_bounded', 'flash_attention_bounded_plain_lse',
           'bounded_shift', 'flash_attention_bwd_operands',
           'flash_attention_dq', 'flash_attention_dq_plain',
           'flash_attention_dkv', 'flash_attention_dkv_plain',
           'flash_attention_backward', 'flash_attention_backward_plain']

_LOG2E = math.log2(math.e)
_LN2 = math.log(2.0)
_NEG_BIG = -0.7 * 3.4e38   # large-finite fp32 running-max floor
# softmax_mode='bounded' guard (the reference's value): K2 runs only while
# the worst-case gap 2·max(bound) between a row's shift and its true max
# stays within 100 log2 units of float32's exponent range.
_BOUNDED_SAFE_GAP = 100.0
_KERNEL_HEAD_DIMS = (32, 64, 96, 128)

_UNPORTED_DEFAULTS = dict(segment_ids=None, positions=None, window=None,
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


def _bool_mask(mask):
    if mask is None or mask.dtype == torch.bool:
        return mask
    return mask != 0


def _fold_q(q, scale):
    """q·(scale·log2e), rounded back to q's dtype (the exp2 trick)."""
    return (q.float() * (scale * _LOG2E)).to(q.dtype)


def _scores2(q2, k, mask, causal, rel):
    """Float32 scores in log2 units; masked entries and the causal future
    (column ``j`` of row ``i`` when ``rel + i < j``, with
    ``rel = causal_offset − kv_offset``) at -inf."""
    s = torch.matmul(q2.float(), k.float().transpose(-1, -2))
    if mask is not None:
        s = s.masked_fill(_bool_mask(mask), float('-inf'))
    if causal:
        rows = rel + torch.arange(q2.shape[-2], device=q2.device)
        cols = torch.arange(k.shape[-2], device=q2.device)
        s = s.masked_fill(cols[None, :] > rows[:, None], float('-inf'))
    return s


def _softmax_out(s, m, v):
    """``(out, lse)`` from log2-unit scores ``s`` and the row shift
    ``m`` (..., Tq, 1): a row whose weights are all 0 outputs 0."""
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, 1.0, l)
    out = torch.matmul(p, v.float()) / safe_l
    lse = _LN2 * (m + torch.log2(safe_l))
    return out.to(v.dtype), lse[..., 0]


def flash_attention_plain_lse(q, k, v, mask=None, *, causal=False,
                              causal_offset=0, kv_offset=0, scale=None):
    """The forward kernel's (K1) arithmetic in plain PyTorch (float32
    scores): ``(out, lse)`` with the row logsumexp ``lse (..., Tq)``
    float32 in natural-log units, ``ln2·(m₂ + log2 l)`` as the reference
    kernel saves it (a row with no attendable key gives ``ln2·_NEG_BIG``)."""
    group = _kv_group(q, k)
    k, v = _expand_group(k, group), _expand_group(v, group)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = _scores2(_fold_q(q, scale), k, mask, causal,
                 causal_offset - kv_offset)
    return _softmax_out(s, s.amax(dim=-1, keepdim=True).clamp_min(_NEG_BIG),
                        v)


def flash_attention_plain(q, k, v, mask=None, *, causal=False,
                          causal_offset=0, kv_offset=0, scale=None):
    """The forward kernel's arithmetic in plain PyTorch: the reference
    the CPU tests and the card comparison use."""
    return flash_attention_plain_lse(q, k, v, mask, causal=causal,
                                     causal_offset=causal_offset,
                                     kv_offset=kv_offset, scale=scale)[0]


def bounded_shift(q2, k):
    """K2's per-row shift ``(..., Tq)`` float32: the Cauchy-Schwarz bound
    ``‖q₂ᵢ‖·maxⱼ‖kⱼ‖ + 1`` on the log2-unit scores of the folded ``q2``
    (each kv head's max norm serves its GQA group; the +1 covers float32
    rounding of the kernel's dot), as the reference wrapper computes it."""
    group = _kv_group(q2, k)
    qn = q2.float().square().sum(dim=-1).sqrt()
    kn = k.float().square().sum(dim=-1).amax(dim=-1).sqrt()
    if group > 1:
        kn = kn.repeat_interleave(group, dim=-1)
    return qn * kn[..., None] + 1.0


def _bounded_ok(mvec):
    """The reference's guard: K2 only while ``2·max(mvec)`` stays within
    ``_BOUNDED_SAFE_GAP`` (one host sync)."""
    return mvec.numel() == 0 or bool(2.0 * mvec.max() <= _BOUNDED_SAFE_GAP)


def flash_attention_bounded_plain_lse(q, k, v, mask=None, *, causal=False,
                                      causal_offset=0, kv_offset=0,
                                      scale=None):
    """K2's arithmetic in plain PyTorch: ``(out, lse)`` with each row
    shifted by its bound (:func:`bounded_shift`) instead of its max; a row
    with no attendable key outputs 0 and saves ``ln2·bound``."""
    group = _kv_group(q, k)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    q2 = _fold_q(q, scale)
    m = bounded_shift(q2, k)[..., None]
    k, v = _expand_group(k, group), _expand_group(v, group)
    s = _scores2(q2, k, mask, causal, causal_offset - kv_offset)
    return _softmax_out(s, m, v)


def flash_attention_bwd_operands(q, out, lse, g, scale):
    """``(q₂, lse₂, Δ)``, what the reference computes with ``jnp``
    outside its backward kernels: the folded ``q₂``,
    ``lse₂ = max(lse·log2e, _NEG_BIG)`` (a fully masked row's lse would
    overflow to -inf and make the recompute NaN) and
    ``Δ = rowsum(dO⊙O)``, both ``(..., Tq)`` float32."""
    delta = (g.float() * out.float()).sum(dim=-1)
    lse2 = (lse.float() * _LOG2E).clamp_min(_NEG_BIG)
    return _fold_q(q, scale), lse2, delta


def _bwd_plain(q2, k, v, g, lse2, delta, mask, causal, rel, scale,
               grad_dtype, want_dq=True, want_dkv=True):
    """The backward kernels' arithmetic in plain PyTorch, with the
    reference's casts to the operand dtype before each product and its
    per-q-head dk/dv partials summed over the GQA group in float32;
    gradients in ``grad_dtype`` (None: the operands' dtypes)."""
    group = _kv_group(q2, k)
    ke, ve = _expand_group(k, group), _expand_group(v, group)
    p = torch.exp2(_scores2(q2, ke, mask, causal, rel) - lse2[..., None])
    dp = torch.matmul(g.float(), ve.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    dq = dk = dv = None
    if want_dq:
        dq = (scale * torch.matmul(ds.to(k.dtype).float(), ke.float())
              ).to(grad_dtype or q2.dtype)
    if want_dkv:
        dk = torch.matmul(ds.to(q2.dtype).float().transpose(-1, -2),
                          q2.float()) / _LOG2E
        dv = torch.matmul(p.to(g.dtype).float().transpose(-1, -2),
                          g.float())
        dk, dv = dk.to(grad_dtype or k.dtype), dv.to(grad_dtype or v.dtype)
        if group > 1:
            def group_sum(x, like):
                x = x.reshape(*like.shape[:-2], group, *x.shape[-2:])
                return x.float().sum(dim=-3).to(grad_dtype or like.dtype)
            dk, dv = group_sum(dk, k), group_sum(dv, v)
    return dq, dk, dv


def flash_attention_dq_plain(q2, k, v, g, lse2, delta, *, mask=None,
                             causal=False, causal_offset=0, kv_offset=0,
                             scale=1.0, grad_dtype=None):
    """The dq kernel's (K3) arithmetic in plain PyTorch."""
    return _bwd_plain(q2, k, v, g, lse2, delta, mask, causal,
                      causal_offset - kv_offset, scale, grad_dtype,
                      want_dkv=False)[0]


def flash_attention_dkv_plain(q2, k, v, g, lse2, delta, *, mask=None,
                              causal=False, causal_offset=0, kv_offset=0,
                              grad_dtype=None):
    """The dk/dv kernel's (K4) arithmetic in plain PyTorch."""
    return _bwd_plain(q2, k, v, g, lse2, delta, mask, causal,
                      causal_offset - kv_offset, 1.0, grad_dtype,
                      want_dq=False)[1:]


def flash_attention_backward_plain(q, k, v, out, lse, g, causal=False,
                                   causal_offset=0, scale=None, *,
                                   mask=None, kv_offset=0, grad_dtype=None):
    """``(dq, dk, dv)`` of :func:`flash_attention` from its saved
    ``(out, lse)`` and the output cotangent ``g``, in plain PyTorch: the
    arithmetic of the reference's ``_flash_bwd_impl``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    q2, lse2, delta = flash_attention_bwd_operands(q, out, lse, g, scale)
    return _bwd_plain(q2, k, v, g, lse2, delta, mask, causal,
                      causal_offset - kv_offset, scale, grad_dtype)


def _cfn(name, symbol, argtypes):
    fn = getattr(_build.load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_VP, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_float)
# mask pointer, its heads, batch / head / row strides (bytes)
_MASK_ARGTYPES = [_VP, _I, _LL, _LL, _LL]


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


def _check_grad_dtype(grad_dtype, like):
    if grad_dtype not in (None, like.dtype, torch.float32):
        raise NotImplementedError(
            f'the CUDA flash backward writes bf16 or float32 gradients, '
            f'not {grad_dtype}')
    return grad_dtype == torch.float32


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


def _mask_operand(mask, q, tk):
    """``(tensor, [pointer, heads, batch stride, head stride, row
    stride])`` of a boolean mask for the kernels, in bytes: broadcast over
    q's lead dims by stride 0 and addressed per flat (batch, head) row as
    ``(bh // heads, bh % heads)``; columns must be contiguous. A
    head-broadcast mask, or a column slice of a wider one, is passed
    uncopied; lead dims beyond two are merged (a copy where they cannot
    be viewed so). ``(None, [None, 1, 0, 0, 0])`` without a mask."""
    if mask is None:
        return None, [None, 1, 0, 0, 0]
    if mask.device != q.device:
        raise ValueError(f'mask is on {mask.device}, not {q.device}')
    lead, tq = tuple(q.shape[:-2]), q.shape[-2]
    m = _bool_mask(mask).expand(*lead, tq, tk)
    if m.stride(-1) != 1:
        m = m.contiguous()
    if len(lead) > 2:
        m = m.reshape(-1, lead[-1], tq, tk)
    while m.dim() < 4:
        m = m.unsqueeze(0)
    return m, [m.data_ptr(), m.shape[1], m.stride(0), m.stride(1),
               m.stride(2)]


def _launch(q, k, v, mask, causal, causal_offset, kv_offset, scale,
            save_lse=False, mvec=None):
    """K1 on the card, or K2 when ``mvec`` (the row bounds) is given:
    ``out``, or ``(out, lse)`` with ``save_lse``."""
    _check_kernel_operands((('q', q), ('k', k), ('v', v)), q.shape[-1])
    group = _kv_group(q, k)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    nb, tq, tk, d = _rows(q), q.shape[-2], k.shape[-2], q.shape[-1]
    out = torch.empty(q.shape, dtype=v.dtype, device=q.device)
    lse = (torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
           if save_lse else None)
    if mvec is not None:
        mvec = mvec.float().expand(q.shape[:-1]).contiguous()
    m, margs = _mask_operand(mask, q, tk)
    fn = _cfn('flash_fwd', 'flash_fwd_bf16',
              [_VP] * 6 + _MASK_ARGTYPES + [_I] * 8 + [_F, _VP])
    with torch.cuda.device(q.device):
        err = fn(*_ptrs(q, k, v, out), None if lse is None else lse.data_ptr(),
                 None if mvec is None else mvec.data_ptr(), *margs, nb,
                 group, tq, tk, d, int(causal), causal_offset, kv_offset,
                 scale * _LOG2E, torch.cuda.current_stream().cuda_stream)
    if mvec is None:
        _raise_on(err, 'flash_fwd')
        flash_attention.launches += 1
    else:
        _raise_on(err, 'flash_fwd bounded')
        flash_attention_bounded.launches += 1
    return out if lse is None else (out, lse)


def _raise_on(err, what):
    if err:
        raise RuntimeError(f'{what} kernel launch failed: CUDA error {err}')


def flash_attention_bounded(q, k, v, mask=None, *, causal=False,
                            causal_offset=0, kv_offset=0, scale=None,
                            save_lse=False, mvec=None):
    """K2, the bounded-softmax forward, whatever the guard would say
    (:func:`flash_attention` with ``softmax_mode='bounded'`` applies the
    guard): ``out``, or ``(out, lse)`` with ``save_lse``. ``mvec`` is the
    row bound (:func:`bounded_shift`; computed when None). The CUDA kernel
    for CUDA tensors, :func:`flash_attention_bounded_plain_lse` for CPU
    tensors."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not q.is_cuda:
        res = flash_attention_bounded_plain_lse(
            q, k, v, mask, causal=causal, causal_offset=causal_offset,
            kv_offset=kv_offset, scale=scale)
        return res if save_lse else res[0]
    if mvec is None:
        mvec = bounded_shift(_fold_q(q, scale), k)
    return _launch(q, k, v, mask, bool(causal), int(causal_offset),
                   int(kv_offset), float(scale), save_lse, mvec=mvec)


def _forward(q, k, v, mask, causal, causal_offset, kv_offset, scale, mode,
             save_lse):
    """The forward of either mode, K2 behind the reference's guard."""
    if mode == 'bounded':
        mvec = bounded_shift(_fold_q(q, scale), k)
        if _bounded_ok(mvec):
            return flash_attention_bounded(
                q, k, v, mask, causal=causal, causal_offset=causal_offset,
                kv_offset=kv_offset, scale=scale, save_lse=save_lse,
                mvec=mvec)
    if q.is_cuda:
        return _launch(q, k, v, mask, causal, causal_offset, kv_offset,
                       scale, save_lse)
    res = flash_attention_plain_lse(q, k, v, mask, causal=causal,
                                    causal_offset=causal_offset,
                                    kv_offset=kv_offset, scale=scale)
    return res if save_lse else res[0]


def flash_attention_dq(q2, k, v, g, lse2, delta, *, mask=None, causal=False,
                       causal_offset=0, kv_offset=0, scale=1.0,
                       grad_dtype=None):
    """dq from the folded operands (K3): ``q2`` is q·(scale·log2e),
    ``lse2`` and ``delta`` are ``(..., Tq)`` float32 (see
    :func:`flash_attention_backward`). The CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    kw = dict(mask=mask, causal=causal, causal_offset=causal_offset,
              kv_offset=kv_offset, grad_dtype=grad_dtype)
    if not q2.is_cuda:
        return flash_attention_dq_plain(q2, k, v, g, lse2, delta,
                                        scale=scale, **kw)
    _check_kernel_operands((('q', q2), ('k', k), ('v', v), ('g', g)),
                           q2.shape[-1])
    out_f32 = _check_grad_dtype(grad_dtype, q2)
    group = _kv_group(q2, k)
    q2, k, v, g = (t.contiguous() for t in (q2, k, v, g))
    lse2, delta = lse2.float().contiguous(), delta.float().contiguous()
    nb, tq, tk, d = _rows(q2), q2.shape[-2], k.shape[-2], q2.shape[-1]
    dq = torch.empty(q2.shape, device=q2.device,
                     dtype=torch.float32 if out_f32 else q2.dtype)
    m, margs = _mask_operand(mask, q2, tk)
    fn = _cfn('flash_bwd', 'flash_bwd_dq_bf16',
              [_VP] * 7 + _MASK_ARGTYPES + [_I] * 8 + [_F, _I, _VP])
    with torch.cuda.device(q2.device):
        err = fn(*_ptrs(q2, k, v, g, lse2, delta, dq), *margs, nb, group,
                 tq, tk, d, int(causal), int(causal_offset), int(kv_offset),
                 float(scale), int(out_f32),
                 torch.cuda.current_stream().cuda_stream)
    _raise_on(err, 'flash_bwd_dq')
    flash_attention_dq.launches += 1
    return dq


def flash_attention_dkv(q2, k, v, g, lse2, delta, *, mask=None,
                        causal=False, causal_offset=0, kv_offset=0,
                        grad_dtype=None):
    """``(dk, dv)`` from the folded operands (K4), kv-head shaped: each
    GQA group's query heads are summed in float32. The CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    kw = dict(mask=mask, causal=causal, causal_offset=causal_offset,
              kv_offset=kv_offset, grad_dtype=grad_dtype)
    if not q2.is_cuda:
        return flash_attention_dkv_plain(q2, k, v, g, lse2, delta, **kw)
    _check_kernel_operands((('q', q2), ('k', k), ('v', v), ('g', g)),
                           q2.shape[-1])
    out_f32 = _check_grad_dtype(grad_dtype, k)
    group = _kv_group(q2, k)
    q2, k, v, g = (t.contiguous() for t in (q2, k, v, g))
    lse2, delta = lse2.float().contiguous(), delta.float().contiguous()
    nb, tq, tk, d = _rows(q2), q2.shape[-2], k.shape[-2], q2.shape[-1]
    gdt = torch.float32 if out_f32 else k.dtype
    dk = torch.empty(k.shape, dtype=gdt, device=k.device)
    dv = torch.empty(v.shape, dtype=gdt, device=v.device)
    m, margs = _mask_operand(mask, q2, tk)
    fn = _cfn('flash_bwd', 'flash_bwd_dkv_bf16',
              [_VP] * 8 + _MASK_ARGTYPES + [_I] * 8 + [_I, _VP])
    with torch.cuda.device(q2.device):
        err = fn(*_ptrs(q2, k, v, g, lse2, delta, dk, dv), *margs, nb,
                 group, tq, tk, d, int(causal), int(causal_offset),
                 int(kv_offset), int(out_f32),
                 torch.cuda.current_stream().cuda_stream)
    _raise_on(err, 'flash_bwd_dkv')
    flash_attention_dkv.launches += 1
    return dk, dv


def flash_attention_backward(q, k, v, out, lse, g, causal=False,
                             causal_offset=0, scale=None, *, mask=None,
                             kv_offset=0, grad_dtype=None):
    """``(dq, dk, dv)`` of :func:`flash_attention`: ``Δ``, ``q₂`` and
    ``lse₂`` in plain PyTorch (the reference computes them with ``jnp``
    outside its kernels), then K3 and K4 (their plain versions for CPU
    tensors)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    q2, lse2, delta = flash_attention_bwd_operands(q, out, lse, g, scale)
    kw = dict(mask=mask, causal=causal, causal_offset=causal_offset,
              kv_offset=kv_offset, grad_dtype=grad_dtype)
    dq = flash_attention_dq(q2, k, v, g, lse2, delta, scale=scale, **kw)
    dk, dv = flash_attention_dkv(q2, k, v, g, lse2, delta, **kw)
    return dq, dk, dv


def flash_attention_with_lse(q, k, v, mask=None, *, causal=False,
                             causal_offset=0, kv_offset=0, scale=None,
                             softmax_mode='exact'):
    """``(out, lse)``: the forward with the row logsumexp ``(..., Tq)``
    float32 the backward recomputes from — K1 (or K2 behind the guard)
    with its LSE output for CUDA tensors, the plain versions for CPU
    tensors."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _forward(q, k, v, mask, bool(causal), int(causal_offset),
                    int(kv_offset), float(scale), softmax_mode, True)


class _FlashAttention(torch.autograd.Function):
    """The reference's ``custom_vjp`` pair (``_flash_fwd``/
    ``_flash_bwd``): the forward saves ``(q, k, v, out, lse)``; the
    backward is mode-independent."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, causal_offset, kv_offset, scale,
                mode):
        out, lse = _forward(q, k, v, mask, causal, causal_offset, kv_offset,
                            scale, mode, True)
        ctx.save_for_backward(q, k, v, out, lse, mask)
        ctx.args = (causal, causal_offset, scale, kv_offset)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, mask = ctx.saved_tensors
        causal, causal_offset, scale, kv_offset = ctx.args
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, g, causal, causal_offset, scale, mask=mask,
            kv_offset=kv_offset)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, mask=None, *, causal=False, causal_offset=0,
                    kv_offset=0, scale=None, interpret=None,
                    softmax_mode='exact', **unported):
    """Fused attention ``softmax(q·kᵀ·scale)·v`` (see the module
    docstring for layouts, masks and numerics), differentiable in q, k
    and v.

    ``causal_offset`` / ``kv_offset``: the global positions of query row
    0 and key column 0, host ints. ``softmax_mode``: ``'exact'`` (K1) or
    ``'bounded'`` (K2 behind the reference's guard, one host sync).
    ``interpret`` mirrors the reference knob: the plain version runs only
    for CPU tensors, so ``interpret=True`` with a CUDA tensor raises. The
    other keyword arguments of the reference signature raise
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
    if softmax_mode not in ('exact', 'bounded'):
        raise ValueError(f"softmax_mode must be 'exact' or 'bounded', "
                         f'got {softmax_mode!r}')
    if v.shape[:-2] != k.shape[:-2] or v.shape[-2] != k.shape[-2]:
        raise ValueError(
            f'k and v must agree on lead dims and Tk; got k '
            f'{tuple(k.shape)}, v {tuple(v.shape)}')
    _kv_group(q, k)
    if mask is not None and tuple(mask.shape[-2:]) != (q.shape[-2],
                                                       k.shape[-2]):
        raise ValueError(
            f'mask trailing dims {tuple(mask.shape[-2:])} must equal '
            f'(Tq, Tk) = {(q.shape[-2], k.shape[-2])}')
    mask = _bool_mask(mask)
    causal_offset = operator.index(causal_offset)
    kv_offset = operator.index(kv_offset)
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
        return _FlashAttention.apply(q, k, v, mask, causal, causal_offset,
                                     kv_offset, scale, softmax_mode)
    return _forward(q, k, v, mask, causal, causal_offset, kv_offset, scale,
                    softmax_mode, False)


# Launches of each CUDA kernel (counted where it is launched, nowhere
# else): K1 forward, K2 bounded forward, K3 dq, K4 dk/dv.
flash_attention.launches = 0
flash_attention_bounded.launches = 0
flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0
