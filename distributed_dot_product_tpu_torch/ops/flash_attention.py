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

Masking, as in the reference (a union of everything given):

- ``mask``: boolean ``(..., Tq, Tk)``, True = masked out, broadcast over
  q's lead dims (a head-broadcast ``(B, 1, Tq, Tk)`` mask, or a column
  slice of a wider one, reaches the kernels through strides, uncopied);
- causal over global positions: query row ``i`` sits at
  ``causal_offset + i``, key column ``j`` at ``kv_offset + j``, and row
  ``i`` attends column ``j`` when ``causal_offset + i >= kv_offset + j``
  — so a prefill can pass a whole cache buffer as k/v and its unfilled
  tail is never attended, and a ring fold passes its rotating block's
  global column offset as ``kv_offset``;
- ``window`` (needs causal): row ``i`` also drops every column with
  ``(causal_offset + i) − (kv_offset + j) >= window``; key tiles wholly
  past the window are never loaded;
- ``segment_ids``: a ``(seg_q, seg_k)`` pair of int vectors ``(..., Tq)``
  / ``(..., Tk)`` (lead dims broadcast like the mask's), or one array
  when ``Tq == Tk``; a pair with different ids does not attend.

A row with no attendable key outputs exactly 0, saves the row
logsumexp ``ln2·_NEG_BIG`` and gets zero gradients; the ring merge and
its backward rely on exactly that.

``dropout_rate``/``dropout_seed``: attention-weight dropout with the keep
mask a pure hash of (seed, flat query-batch index, global row, global
column) — :func:`dropout_keep`, the reference's ``_dropout_keep`` bit for
bit — applied to the numerator only: the denominator and the saved
``lse`` stay undropped, the backward masks and scales ``dp`` (and, for
``dv``, ``p``) with the same bits. Because the hash keys on global
coordinates, a ring fold or a sequence shard draws the mask the
single-device kernel draws for the same elements.

``qk_quant='int8'``: the scores come from per-row symmetric int8 q and k
(:func:`quantize_rows`) as ``f32(int32 dot)·sqf·skr`` with ``sqf = sq ·
scale·log2e`` — an exact integer dot, so the kernel's scores equal the
plain version's bit for bit; the backward is the straight-through
gradient: ``dq = scale·ds·k̃``, ``dk = scale·dsᵀ·q̃`` with ``k̃``, ``q̃``
the dequantized operands rounded to v's dtype.

``softmax_mode='bounded'`` runs K2: the running max is replaced by the
per-row Cauchy-Schwarz bound ``‖q₂ᵢ‖·maxⱼ‖kⱼ‖ + 1`` (log2 units, computed
here as the reference computes it). The reference's guard stays: when
``2·max(bound) > _BOUNDED_SAFE_GAP`` some row could underflow, and K1
runs instead. The guard is a host decision, one ``.item()`` sync per
call; it picks K2 exactly when the reference's ``lax.cond`` does. With
dropout or int8 scoring 'bounded' resolves to the exact kernel, as in
the reference.

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
runs its plain PyTorch version. ``positions`` and ``alibi_slopes`` raise
``NotImplementedError`` until a later slice ports them.

Numerics (both versions): ``scale·log2(e)`` is folded into q and
rounded back to q's dtype (the exp2 trick), and the softmax runs in exp2
units against a running max clamped at ``_NEG_BIG`` (K1) or the row's
bound (K2).
"""

import ctypes
import math
import operator
from typing import NamedTuple, Optional, Tuple

import torch

from distributed_dot_product_tpu_torch.ops import _build

__all__ = ['flash_attention', 'flash_attention_plain',
           'flash_attention_with_lse', 'flash_attention_plain_lse',
           'flash_attention_bounded', 'flash_attention_bounded_plain_lse',
           'bounded_shift', 'flash_attention_bwd_operands',
           'flash_attention_dq', 'flash_attention_dq_plain',
           'flash_attention_dkv', 'flash_attention_dkv_plain',
           'flash_attention_backward', 'flash_attention_backward_plain',
           'quantize_rows', 'quant_operands', 'dropout_keep']

_LOG2E = math.log2(math.e)
_LN2 = math.log(2.0)
_NEG_BIG = -0.7 * 3.4e38   # large-finite fp32 running-max floor
# softmax_mode='bounded' guard (the reference's value): K2 runs only while
# the worst-case gap 2·max(bound) between a row's shift and its true max
# stays within 100 log2 units of float32's exponent range.
_BOUNDED_SAFE_GAP = 100.0
_KERNEL_HEAD_DIMS = (32, 64, 96, 128)

_UNPORTED_DEFAULTS = dict(positions=None, alibi_slopes=None)


class _Feat(NamedTuple):
    """The per-element features beyond mask and causal, validated:
    ``seg`` a ``(seg_q, seg_k)`` pair of int tensors or None, ``window``
    an int or None, ``rate``/``seed`` the dropout (rate 0: none; seed a
    Python int32), ``quant`` int8 scoring."""
    seg: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    window: Optional[int] = None
    rate: float = 0.0
    seed: int = 0
    quant: bool = False

    @property
    def active(self):
        return (self.seg is not None or self.window is not None
                or bool(self.rate) or self.quant)


_NO_FEAT = _Feat()


def _i32(x):
    """``x`` wrapped to int32 (two's complement), as a Python int."""
    return (int(x) + 2 ** 31) % 2 ** 32 - 2 ** 31


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


def quantize_rows(x):
    """Per-row symmetric int8 quantization (the reference's
    ``_quantize_rows``): ``x ≈ x_i8 · s`` with ``s = max|row|/127``
    clamped at 1e-20, rounded half to even. Returns ``(x_i8 (..., T, d)
    int8, s (..., T, 1) float32)``."""
    x32 = x.float()
    s = torch.clamp_min(x32.abs().amax(dim=-1, keepdim=True) / 127.0, 1e-20)
    return torch.round(x32 / s).to(torch.int8), s


def quant_operands(q, k):
    """``(q_i8, sq, k_i8, sk)``: the int8 operands and raw row scales of
    ``qk_quant='int8'`` scoring, for the backward passes."""
    return (*quantize_rows(q), *quantize_rows(k))


_M32 = 0xFFFFFFFF


def _mul32(x, c):
    """``x·c mod 2³²`` for int64 ``x`` in [0, 2³²) without int64
    overflow (16-bit halves)."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def dropout_keep(lead, tq, tk, causal_offset, kv_offset, rate, seed,
                 device=None):
    """The reference's ``_dropout_keep`` over a whole ``(*lead, Tq, Tk)``
    block: a murmur3-finalizer hash of (seed, flat batch index over
    ``lead``, global row ``causal_offset + i``, global column
    ``kv_offset + j``) in uint32 arithmetic (computed in int64 masked to
    32 bits; a negative int32 seed is its two's complement); an element
    is kept when the hash is ``>= min(int(rate·2³²), 2³²−1)``. Returns
    ``(keep bool, 1/(1−rate))``."""
    nb = math.prod(lead)
    kw = dict(dtype=torch.int64, device=device)
    rows = (causal_offset + torch.arange(tq, **kw)) & _M32
    cols = (kv_offset + torch.arange(tk, **kw)) & _M32
    b = torch.arange(nb, **kw)
    x = (_mul32(rows, 2654435761)[None, :, None]
         ^ _mul32(cols, 2246822519)[None, None, :]
         ^ (((seed & _M32) + _mul32(b, 668265263)) & _M32)[:, None, None])
    x = x ^ (x >> 16)
    x = _mul32(x, 2246822507)
    x = x ^ (x >> 13)
    x = _mul32(x, 3266489909)
    x = x ^ (x >> 16)
    threshold = min(int(rate * 2.0 ** 32), 2 ** 32 - 1)
    return (x >= threshold).reshape(*lead, tq, tk), 1.0 / (1.0 - rate)


def _plain_scores(q, k, mask, causal, co, ko, feat, scale, quant=None):
    """Float32 scores in log2 units of ``q`` (folded q₂, or raw q with
    ``quant``) against ``k`` (already expanded to q's heads); masked
    entries, the causal future, columns past the window and cross-segment
    pairs at -inf. ``quant``: ``(q_i8, sq, k_i8, sk)`` with k's operands
    expanded; scores ``(f32(q_i8·k_i8ᵀ)·sqf)·skr``, exact integer dot."""
    if quant is not None:
        q8, sq, k8, sk = quant
        s = torch.matmul(q8.float(), k8.float().transpose(-1, -2))
        s = s * (sq * (scale * _LOG2E)) * sk.transpose(-1, -2)
    else:
        s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if mask is not None:
        s = s.masked_fill(_bool_mask(mask), float('-inf'))
    if causal:
        rel = co - ko
        rows = rel + torch.arange(q.shape[-2], device=q.device)
        cols = torch.arange(k.shape[-2], device=q.device)
        s = s.masked_fill(cols[None, :] > rows[:, None], float('-inf'))
        if feat.window is not None:
            s = s.masked_fill(rows[:, None] - cols[None, :] >= feat.window,
                              float('-inf'))
    if feat.seg is not None:
        sq_, sk_ = feat.seg
        s = s.masked_fill(sq_[..., :, None] != sk_[..., None, :],
                          float('-inf'))
    return s


def _keep(feat, q, tk, co, ko):
    if not feat.rate:
        return None, 1.0
    return dropout_keep(tuple(q.shape[:-2]), q.shape[-2], tk, co, ko,
                        feat.rate, feat.seed, q.device)


def _softmax_out(s, m, v, keep=None, inv=1.0):
    """``(out, lse)`` from log2-unit scores ``s`` and the row shift
    ``m`` (..., Tq, 1): a row whose weights are all 0 outputs 0. With a
    dropout ``keep`` mask only the numerator is dropped (and scaled)."""
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, 1.0, l)
    if keep is not None:
        p = torch.where(keep, p, 0.0) * inv
    out = torch.matmul(p, v.float()) / safe_l
    lse = _LN2 * (m + torch.log2(safe_l))
    return out.to(v.dtype), lse[..., 0]


def _plain_fwd(q, k, v, mask, causal, co, ko, scale, feat, bounded=False):
    group = _kv_group(q, k)
    q2 = _fold_q(q, scale)
    quant = None
    if feat.quant:
        q8, sq, k8, sk = quant_operands(q, k)
        quant = (q8, sq, _expand_group(k8, group), _expand_group(sk, group))
    m = bounded_shift(q2, k)[..., None] if bounded else None
    ke, ve = _expand_group(k, group), _expand_group(v, group)
    s = _plain_scores(q2, ke, mask, causal, co, ko, feat, scale, quant)
    if m is None:
        m = s.amax(dim=-1, keepdim=True).clamp_min(_NEG_BIG)
    keep, inv = _keep(feat, q, k.shape[-2], co, ko)
    return _softmax_out(s, m, ve, keep, inv)


def flash_attention_plain_lse(q, k, v, mask=None, *, causal=False,
                              causal_offset=0, kv_offset=0, scale=None,
                              segment_ids=None, window=None,
                              dropout_rate=0.0, dropout_seed=None,
                              qk_quant=None):
    """The forward kernel's (K1) arithmetic in plain PyTorch (float32
    scores): ``(out, lse)`` with the row logsumexp ``lse (..., Tq)``
    float32 in natural-log units, ``ln2·(m₂ + log2 l)`` as the reference
    kernel saves it (a row with no attendable key gives ``ln2·_NEG_BIG``).
    Takes the reference's segments, window, dropout and int8 knobs."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    feat = _features(q, k, causal, segment_ids, window, dropout_rate,
                     dropout_seed, qk_quant)
    return _plain_fwd(q, k, v, mask, causal, causal_offset, kv_offset,
                      scale, feat)


def flash_attention_plain(q, k, v, mask=None, *, causal=False,
                          causal_offset=0, kv_offset=0, scale=None, **feat):
    """The forward kernel's arithmetic in plain PyTorch: the reference
    the CPU tests and the card comparison use."""
    return flash_attention_plain_lse(q, k, v, mask, causal=causal,
                                     causal_offset=causal_offset,
                                     kv_offset=kv_offset, scale=scale,
                                     **feat)[0]


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
                                      scale=None, segment_ids=None,
                                      window=None):
    """K2's arithmetic in plain PyTorch: ``(out, lse)`` with each row
    shifted by its bound (:func:`bounded_shift`) instead of its max; a row
    with no attendable key outputs 0 and saves ``ln2·bound``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    feat = _features(q, k, causal, segment_ids, window)
    return _plain_fwd(q, k, v, mask, causal, causal_offset, kv_offset,
                      scale, feat, bounded=True)


def flash_attention_bwd_operands(q, out, lse, g, scale):
    """``(q₂, lse₂, Δ)``, what the reference computes with ``jnp``
    outside its backward kernels: the folded ``q₂``,
    ``lse₂ = max(lse·log2e, _NEG_BIG)`` (a fully masked row's lse would
    overflow to -inf and make the recompute NaN) and
    ``Δ = rowsum(dO⊙O)``, both ``(..., Tq)`` float32. The int8 backward
    takes :func:`quant_operands` of the raw q and k besides."""
    delta = (g.float() * out.float()).sum(dim=-1)
    lse2 = (lse.float() * _LOG2E).clamp_min(_NEG_BIG)
    return _fold_q(q, scale), lse2, delta


def _bwd_plain(q2, k, v, g, lse2, delta, mask, causal, co, ko, scale,
               grad_dtype, feat, quant, want_dq=True, want_dkv=True):
    """The backward kernels' arithmetic in plain PyTorch, with the
    reference's casts to the operand dtype before each product and its
    per-q-head dk/dv partials summed over the GQA group in float32;
    gradients in ``grad_dtype`` (None: the operands' dtypes)."""
    group = _kv_group(q2, k)
    ke, ve = _expand_group(k, group), _expand_group(v, group)
    equant = None
    if quant is not None:
        q8, sq, k8, sk = quant
        equant = (q8, sq, _expand_group(k8, group),
                  _expand_group(sk, group))
    p = torch.exp2(_plain_scores(q2, ke, mask, causal, co, ko, feat, scale,
                                 equant) - lse2[..., None])
    dp = torch.matmul(g.float(), ve.float().transpose(-1, -2))
    keep, inv = _keep(feat, q2, k.shape[-2], co, ko)
    p_num = p
    if keep is not None:
        dp = torch.where(keep, dp, 0.0) * inv
        p_num = torch.where(keep, p, 0.0) * inv
    ds = p * (dp - delta[..., None])
    dq = dk = dv = None
    if want_dq:
        if equant is not None:
            k_op = (equant[2].float() * equant[3]).to(v.dtype)
            dq = scale * torch.matmul(ds.to(v.dtype).float(), k_op.float())
        else:
            dq = scale * torch.matmul(ds.to(k.dtype).float(), ke.float())
        dq = dq.to(grad_dtype or q2.dtype)
    if want_dkv:
        if equant is not None:
            q_op = (equant[0].float() * equant[1]).to(v.dtype)
            dk = scale * torch.matmul(
                ds.to(v.dtype).float().transpose(-1, -2), q_op.float())
        else:
            dk = torch.matmul(ds.to(q2.dtype).float().transpose(-1, -2),
                              q2.float()) / _LOG2E
        dv = torch.matmul(p_num.to(g.dtype).float().transpose(-1, -2),
                          g.float())
        dk, dv = dk.to(grad_dtype or k.dtype), dv.to(grad_dtype or v.dtype)
        if group > 1:
            def group_sum(x, like):
                x = x.reshape(*like.shape[:-2], group, *x.shape[-2:])
                return x.float().sum(dim=-3).to(grad_dtype or like.dtype)
            dk, dv = group_sum(dk, k), group_sum(dv, v)
    return dq, dk, dv


def _bwd_feat(q2, k, causal, segment_ids, window, dropout_rate,
              dropout_seed, quant):
    feat = _features(q2, k, causal, segment_ids, window, dropout_rate,
                     dropout_seed, None)
    return feat._replace(quant=quant is not None)


def flash_attention_dq_plain(q2, k, v, g, lse2, delta, *, mask=None,
                             causal=False, causal_offset=0, kv_offset=0,
                             scale=1.0, grad_dtype=None, segment_ids=None,
                             window=None, dropout_rate=0.0,
                             dropout_seed=None, quant=None):
    """The dq kernel's (K3) arithmetic in plain PyTorch."""
    feat = _bwd_feat(q2, k, causal, segment_ids, window, dropout_rate,
                     dropout_seed, quant)
    return _bwd_plain(q2, k, v, g, lse2, delta, mask, causal, causal_offset,
                      kv_offset, scale, grad_dtype, feat, quant,
                      want_dkv=False)[0]


def flash_attention_dkv_plain(q2, k, v, g, lse2, delta, *, mask=None,
                              causal=False, causal_offset=0, kv_offset=0,
                              grad_dtype=None, scale=None, segment_ids=None,
                              window=None, dropout_rate=0.0,
                              dropout_seed=None, quant=None):
    """The dk/dv kernel's (K4) arithmetic in plain PyTorch (``scale`` is
    needed only with ``quant``, whose dk carries it)."""
    feat = _bwd_feat(q2, k, causal, segment_ids, window, dropout_rate,
                     dropout_seed, quant)
    if scale is None:
        scale = 1.0 / math.sqrt(q2.shape[-1])
    return _bwd_plain(q2, k, v, g, lse2, delta, mask, causal, causal_offset,
                      kv_offset, scale, grad_dtype, feat, quant,
                      want_dq=False)[1:]


def flash_attention_backward_plain(q, k, v, out, lse, g, causal=False,
                                   causal_offset=0, scale=None, *,
                                   mask=None, kv_offset=0, grad_dtype=None,
                                   segment_ids=None, window=None,
                                   dropout_rate=0.0, dropout_seed=None,
                                   qk_quant=None):
    """``(dq, dk, dv)`` of :func:`flash_attention` from its saved
    ``(out, lse)`` and the output cotangent ``g``, in plain PyTorch: the
    arithmetic of the reference's ``_flash_bwd_impl``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    feat = _features(q, k, causal, segment_ids, window, dropout_rate,
                     dropout_seed, qk_quant)
    q2, lse2, delta = flash_attention_bwd_operands(q, out, lse, g, scale)
    quant = quant_operands(q, k) if feat.quant else None
    return _bwd_plain(q2, k, v, g, lse2, delta, mask, causal, causal_offset,
                      kv_offset, scale, grad_dtype, feat, quant)


# ---------------------------------------------------------------------------
# Feature validation (the reference wrapper's, pallas_attention.py:1893-1950)
# ---------------------------------------------------------------------------

def _seg_side(vec, lead, t, side):
    vec = torch.as_tensor(vec)
    if vec.shape[-1] != t:
        raise ValueError(f'segment_ids[{side}] trailing dim {vec.shape[-1]} '
                         f'must equal {"Tq" if side == 0 else "Tk"} = {t}')
    vlead = tuple(vec.shape[:-1])
    if len(vlead) > len(lead):
        raise ValueError(
            f'segment_ids[{side}] has {len(vlead)} leading dims but q/k/v '
            f'have {len(lead)}; segment_ids[{side}] may not add batch dims')
    padded = (1,) * (len(lead) - len(vlead)) + vlead
    for db, dm in zip(lead, padded):
        if dm not in (1, db):
            raise ValueError(
                f'segment_ids[{side}] leading dims {vlead} do not broadcast '
                f'against q/k/v leading dims {lead}')
    if vec.dtype.is_floating_point or vec.dtype == torch.bool:
        raise TypeError(f'segment_ids must be integers, got {vec.dtype}')
    return vec


def _features(q, k, causal, segment_ids=None, window=None, dropout_rate=0.0,
              dropout_seed=None, qk_quant=None):
    """Validate the reference's feature knobs as its wrapper does and
    bundle them (:class:`_Feat`)."""
    seg = None
    if segment_ids is not None:
        if isinstance(segment_ids, (tuple, list)):
            seg_q, seg_k = segment_ids
        else:
            if q.shape[-2] != k.shape[-2]:
                raise ValueError(
                    'a single segment_ids array needs Tq == Tk; pass a '
                    '(q-side, kv-side) pair for cross-length attention')
            seg_q = seg_k = segment_ids
        lead = tuple(q.shape[:-2])
        seg = (_seg_side(seg_q, lead, q.shape[-2], 0),
               _seg_side(seg_k, lead, k.shape[-2], 1))
    if window is not None:
        if (isinstance(window, bool) or not isinstance(window, int)
                or window < 1):
            raise ValueError(f'window must be a positive int, got {window!r}')
        if not causal:
            raise ValueError(
                'window is a lookback cap and needs causal semantics: pass '
                'causal=True (explicit positions are not ported)')
    if qk_quant not in (None, 'int8'):
        raise ValueError(f"qk_quant must be None or 'int8', "
                         f'got {qk_quant!r}')
    dropout_rate = float(dropout_rate)
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f'dropout_rate must be in [0, 1), '
                         f'got {dropout_rate}')
    seed = 0
    if dropout_rate:
        if dropout_seed is None:
            raise ValueError(
                'dropout needs an explicit dropout_seed (an int, e.g. the '
                'step counter) — the kernel holds no hidden RNG state')
        seed = _i32(operator.index(dropout_seed)
                    if not isinstance(dropout_seed, torch.Tensor)
                    else int(dropout_seed))
    return _Feat(seg, window, dropout_rate, seed, qk_quant == 'int8')


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

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


class _VecArgs(ctypes.Structure):
    """``VecArgs`` of ``csrc/flash_*.cu``: an int32 vector per flat
    (batch, head) row, element ``(bh / inner)·so + (bh % inner)·si + i``."""
    _fields_ = [('ptr', ctypes.c_void_p), ('inner', ctypes.c_int),
                ('so', ctypes.c_longlong), ('si', ctypes.c_longlong)]


class _ExtArgs(ctypes.Structure):
    """``ExtArgs`` of ``csrc/flash_*.cu``: segments, window, dropout and
    the int8 operands with their row scales (null = unused)."""
    _fields_ = [('segq', _VecArgs), ('segk', _VecArgs),
                ('window', ctypes.c_int), ('dropout', ctypes.c_int),
                ('drop_threshold', ctypes.c_uint),
                ('drop_inv', ctypes.c_float), ('seed', ctypes.c_uint),
                ('q8', ctypes.c_void_p), ('k8', ctypes.c_void_p),
                ('sqf', ctypes.c_void_p), ('skr', ctypes.c_void_p),
                ('sqc', ctypes.c_void_p), ('skc', ctypes.c_void_p)]


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


def _vec_operand(vec, q, t):
    """``(tensor, _VecArgs)`` of a segment-id vector for the kernels, in
    int32 elements: broadcast over q's lead dims by stride 0 and
    addressed per flat (batch, head) row of q, as a mask is."""
    if vec.device != q.device:
        raise ValueError(f'segment_ids are on {vec.device}, not {q.device}')
    lead = tuple(q.shape[:-2])
    v = vec.to(torch.int32).expand(*lead, t)
    if v.stride(-1) != 1:
        v = v.contiguous()
    if len(lead) > 2:
        v = v.reshape(-1, lead[-1], t)
    while v.dim() < 3:
        v = v.unsqueeze(0)
    return v, _VecArgs(v.data_ptr(), v.shape[1], v.stride(0), v.stride(1))


def _ext_operand(feat, q, k, scale, quant=None, bwd=False):
    """``(keep-alive tensors, _ExtArgs pointer)`` for the kernels' Ext
    instantiation, or ``((), None)`` when no feature is on (the base
    instantiation runs). ``quant``: ``(q_i8, sq, k_i8, sk)`` (computed
    here when None and the feature is on)."""
    if not feat.active:
        return (), None
    ext, keep = _ExtArgs(), []
    if feat.seg is not None:
        vq, ext.segq = _vec_operand(feat.seg[0], q, q.shape[-2])
        vk, ext.segk = _vec_operand(feat.seg[1], q, k.shape[-2])
        keep += [vq, vk]
    ext.window = feat.window or 0
    if feat.rate:
        ext.dropout = 1
        ext.drop_threshold = min(int(feat.rate * 2.0 ** 32), 2 ** 32 - 1)
        ext.drop_inv = 1.0 / (1.0 - feat.rate)
        ext.seed = feat.seed & _M32
    if feat.quant:
        if quant is None:
            quant = quant_operands(q, k)
        q8, sq, k8, sk = (t.contiguous() for t in quant)
        for t in (q8, k8):
            if t.device != q.device or t.dtype != torch.int8:
                raise TypeError('int8 operands must be int8 on the card')
        sqf = (sq * (scale * _LOG2E)).contiguous()
        ext.q8, ext.k8 = _ptrs(q8, k8)
        ext.sqf, ext.skr = sqf.data_ptr(), sk.data_ptr()
        keep += [q8, k8, sqf, sk]
        if bwd:
            ext.sqc, ext.skc = sq.data_ptr(), sk.data_ptr()
            keep.append(sq)
    keep.append(ext)
    return keep, ctypes.pointer(ext)


def _launch(q, k, v, mask, causal, causal_offset, kv_offset, scale,
            save_lse=False, mvec=None, feat=_NO_FEAT):
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
    alive, ext = _ext_operand(feat, q, k, scale)
    fn = _cfn('flash_fwd' if ext is None else 'flash_fwd_ext',
              'flash_fwd_bf16',
              [_VP] * 6 + _MASK_ARGTYPES + [_I] * 8 + [_F, _VP, _VP])
    with torch.cuda.device(q.device):
        err = fn(*_ptrs(q, k, v, out), None if lse is None else lse.data_ptr(),
                 None if mvec is None else mvec.data_ptr(), *margs, nb,
                 group, tq, tk, d, int(causal), causal_offset, kv_offset,
                 scale * _LOG2E, ext, torch.cuda.current_stream().cuda_stream)
    del alive
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
    guard, and passes segments and a window on to K2): ``out``, or
    ``(out, lse)`` with ``save_lse``. ``mvec`` is the row bound
    (:func:`bounded_shift`; computed when None). The CUDA kernel for CUDA
    tensors, :func:`flash_attention_bounded_plain_lse` for CPU tensors."""
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
             save_lse, feat=_NO_FEAT):
    """The forward of either mode, K2 behind the reference's guard (with
    dropout or int8 scoring 'bounded' resolves to the exact kernel)."""
    if mode == 'bounded' and not (feat.rate or feat.quant):
        mvec = bounded_shift(_fold_q(q, scale), k)
        if _bounded_ok(mvec):
            if not q.is_cuda:
                res = _plain_fwd(q, k, v, mask, causal, causal_offset,
                                 kv_offset, scale, feat, bounded=True)
                return res if save_lse else res[0]
            return _launch(q, k, v, mask, causal, causal_offset, kv_offset,
                           scale, save_lse, mvec=mvec, feat=feat)
    if q.is_cuda:
        return _launch(q, k, v, mask, causal, causal_offset, kv_offset,
                       scale, save_lse, feat=feat)
    res = _plain_fwd(q, k, v, mask, causal, causal_offset, kv_offset, scale,
                     feat)
    return res if save_lse else res[0]


def flash_attention_dq(q2, k, v, g, lse2, delta, *, mask=None, causal=False,
                       causal_offset=0, kv_offset=0, scale=1.0,
                       grad_dtype=None, segment_ids=None, window=None,
                       dropout_rate=0.0, dropout_seed=None, quant=None):
    """dq from the folded operands (K3): ``q2`` is q·(scale·log2e),
    ``lse2`` and ``delta`` are ``(..., Tq)`` float32 (see
    :func:`flash_attention_backward`); ``quant`` the
    :func:`quant_operands` of the raw q and k for int8 scoring. The CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    kw = dict(mask=mask, causal=causal, causal_offset=causal_offset,
              kv_offset=kv_offset, grad_dtype=grad_dtype,
              segment_ids=segment_ids, window=window,
              dropout_rate=dropout_rate, dropout_seed=dropout_seed,
              quant=quant)
    if not q2.is_cuda:
        return flash_attention_dq_plain(q2, k, v, g, lse2, delta,
                                        scale=scale, **kw)
    _check_kernel_operands((('q', q2), ('k', k), ('v', v), ('g', g)),
                           q2.shape[-1])
    feat = _bwd_feat(q2, k, causal, segment_ids, window, dropout_rate,
                     dropout_seed, quant)
    out_f32 = _check_grad_dtype(grad_dtype, q2)
    group = _kv_group(q2, k)
    q2, k, v, g = (t.contiguous() for t in (q2, k, v, g))
    lse2, delta = lse2.float().contiguous(), delta.float().contiguous()
    nb, tq, tk, d = _rows(q2), q2.shape[-2], k.shape[-2], q2.shape[-1]
    dq = torch.empty(q2.shape, device=q2.device,
                     dtype=torch.float32 if out_f32 else q2.dtype)
    m, margs = _mask_operand(mask, q2, tk)
    alive, ext = _ext_operand(feat, q2, k, scale, quant, bwd=True)
    fn = _cfn('flash_bwd' if ext is None else 'flash_bwd_dq_ext',
              'flash_bwd_dq_bf16',
              [_VP] * 7 + _MASK_ARGTYPES + [_I] * 8 + [_F, _I, _VP, _VP])
    with torch.cuda.device(q2.device):
        err = fn(*_ptrs(q2, k, v, g, lse2, delta, dq), *margs, nb, group,
                 tq, tk, d, int(causal), int(causal_offset), int(kv_offset),
                 float(scale), int(out_f32), ext,
                 torch.cuda.current_stream().cuda_stream)
    del alive
    _raise_on(err, 'flash_bwd_dq')
    flash_attention_dq.launches += 1
    return dq


def flash_attention_dkv(q2, k, v, g, lse2, delta, *, mask=None,
                        causal=False, causal_offset=0, kv_offset=0,
                        grad_dtype=None, scale=None, segment_ids=None,
                        window=None, dropout_rate=0.0, dropout_seed=None,
                        quant=None):
    """``(dk, dv)`` from the folded operands (K4), kv-head shaped: each
    GQA group's query heads are summed in float32. ``scale`` matters only
    with ``quant`` (int8 scoring's dk carries the softmax scale). The CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    kw = dict(mask=mask, causal=causal, causal_offset=causal_offset,
              kv_offset=kv_offset, grad_dtype=grad_dtype, scale=scale,
              segment_ids=segment_ids, window=window,
              dropout_rate=dropout_rate, dropout_seed=dropout_seed,
              quant=quant)
    if not q2.is_cuda:
        return flash_attention_dkv_plain(q2, k, v, g, lse2, delta, **kw)
    _check_kernel_operands((('q', q2), ('k', k), ('v', v), ('g', g)),
                           q2.shape[-1])
    if scale is None:
        scale = 1.0 / math.sqrt(q2.shape[-1])
    feat = _bwd_feat(q2, k, causal, segment_ids, window, dropout_rate,
                     dropout_seed, quant)
    out_f32 = _check_grad_dtype(grad_dtype, k)
    group = _kv_group(q2, k)
    q2, k, v, g = (t.contiguous() for t in (q2, k, v, g))
    lse2, delta = lse2.float().contiguous(), delta.float().contiguous()
    nb, tq, tk, d = _rows(q2), q2.shape[-2], k.shape[-2], q2.shape[-1]
    gdt = torch.float32 if out_f32 else k.dtype
    dk = torch.empty(k.shape, dtype=gdt, device=k.device)
    dv = torch.empty(v.shape, dtype=gdt, device=v.device)
    m, margs = _mask_operand(mask, q2, tk)
    alive, ext = _ext_operand(feat, q2, k, scale, quant, bwd=True)
    fn = _cfn('flash_bwd' if ext is None else 'flash_bwd_dkv_ext',
              'flash_bwd_dkv_bf16',
              [_VP] * 8 + _MASK_ARGTYPES + [_I] * 8 + [_F, _I, _VP, _VP])
    with torch.cuda.device(q2.device):
        err = fn(*_ptrs(q2, k, v, g, lse2, delta, dk, dv), *margs, nb,
                 group, tq, tk, d, int(causal), int(causal_offset),
                 int(kv_offset), float(scale), int(out_f32), ext,
                 torch.cuda.current_stream().cuda_stream)
    del alive
    _raise_on(err, 'flash_bwd_dkv')
    flash_attention_dkv.launches += 1
    return dk, dv


def flash_attention_backward(q, k, v, out, lse, g, causal=False,
                             causal_offset=0, scale=None, *, mask=None,
                             kv_offset=0, grad_dtype=None, segment_ids=None,
                             window=None, dropout_rate=0.0,
                             dropout_seed=None, qk_quant=None):
    """``(dq, dk, dv)`` of :func:`flash_attention`: ``Δ``, ``q₂`` and
    ``lse₂`` (and with int8 scoring the quantized raw q and k) in plain
    PyTorch (the reference computes them with ``jnp`` outside its
    kernels), then K3 and K4 (their plain versions for CPU tensors)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    q2, lse2, delta = flash_attention_bwd_operands(q, out, lse, g, scale)
    quant = quant_operands(q, k) if qk_quant == 'int8' else None
    kw = dict(mask=mask, causal=causal, causal_offset=causal_offset,
              kv_offset=kv_offset, grad_dtype=grad_dtype,
              segment_ids=segment_ids, window=window,
              dropout_rate=dropout_rate, dropout_seed=dropout_seed,
              quant=quant)
    dq = flash_attention_dq(q2, k, v, g, lse2, delta, scale=scale, **kw)
    dk, dv = flash_attention_dkv(q2, k, v, g, lse2, delta, scale=scale, **kw)
    return dq, dk, dv


def flash_attention_with_lse(q, k, v, mask=None, *, causal=False,
                             causal_offset=0, kv_offset=0, scale=None,
                             softmax_mode='exact', segment_ids=None,
                             window=None, dropout_rate=0.0,
                             dropout_seed=None, qk_quant=None):
    """``(out, lse)``: the forward with the row logsumexp ``(..., Tq)``
    float32 the backward recomputes from — K1 (or K2 behind the guard)
    with its LSE output for CUDA tensors, the plain versions for CPU
    tensors."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    feat = _features(q, k, causal, segment_ids, window, dropout_rate,
                     dropout_seed, qk_quant)
    return _forward(q, k, v, mask, bool(causal), int(causal_offset),
                    int(kv_offset), float(scale), softmax_mode, True, feat)


class _FlashAttention(torch.autograd.Function):
    """The reference's ``custom_vjp`` pair (``_flash_fwd``/
    ``_flash_bwd``): the forward saves ``(q, k, v, out, lse)``; the
    backward is mode-independent."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, causal_offset, kv_offset, scale,
                mode, feat):
        out, lse = _forward(q, k, v, mask, causal, causal_offset, kv_offset,
                            scale, mode, True, feat)
        ctx.save_for_backward(q, k, v, out, lse, mask)
        ctx.args = (causal, causal_offset, scale, kv_offset, feat)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, mask = ctx.saved_tensors
        causal, causal_offset, scale, kv_offset, feat = ctx.args
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, g, causal, causal_offset, scale, mask=mask,
            kv_offset=kv_offset, segment_ids=feat.seg, window=feat.window,
            dropout_rate=feat.rate, dropout_seed=feat.seed,
            qk_quant='int8' if feat.quant else None)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention(q, k, v, mask=None, *, causal=False, causal_offset=0,
                    kv_offset=0, scale=None, interpret=None,
                    softmax_mode='exact', segment_ids=None, window=None,
                    qk_quant=None, dropout_rate=0.0, dropout_seed=None,
                    **unported):
    """Fused attention ``softmax(q·kᵀ·scale)·v`` (see the module
    docstring for layouts, masks, dropout, int8 scoring and numerics),
    differentiable in q, k and v.

    ``causal_offset`` / ``kv_offset``: the global positions of query row
    0 and key column 0, host ints. ``softmax_mode``: ``'exact'`` (K1) or
    ``'bounded'`` (K2 behind the reference's guard, one host sync).
    ``interpret`` mirrors the reference knob: the plain version runs only
    for CPU tensors, so ``interpret=True`` with a CUDA tensor raises.
    ``positions`` and ``alibi_slopes`` raise ``NotImplementedError``
    unless left at None."""
    for name, value in unported.items():
        if name not in _UNPORTED_DEFAULTS:
            raise TypeError(f'flash_attention got an unexpected keyword '
                            f'argument {name!r}')
        if value is not None:
            raise NotImplementedError(f'flash_attention({name}=...) is not '
                                      f'ported yet (ROADMAP.md §2 item 1)')
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
    feat = _features(q, k, causal, segment_ids, window, dropout_rate,
                     dropout_seed, qk_quant)
    if q.is_cuda and interpret:
        raise ValueError('interpret=True runs the plain version, which '
                         'the port keeps for CPU tensors only')
    if not q.is_cuda and interpret is False:
        raise ValueError('interpret=False needs CUDA tensors: the kernel '
                         'runs only on the card')
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, mask, causal, causal_offset,
                                     kv_offset, scale, softmax_mode, feat)
    return _forward(q, k, v, mask, causal, causal_offset, kv_offset, scale,
                    softmax_mode, False, feat)


# Launches of each CUDA kernel (counted where it is launched, nowhere
# else): K1 forward, K2 bounded forward, K3 dq, K4 dk/dv.
flash_attention.launches = 0
flash_attention_bounded.launches = 0
flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0
