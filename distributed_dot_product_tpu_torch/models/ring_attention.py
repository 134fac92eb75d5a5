# -*- coding: utf-8 -*-
"""
Ring attention with online softmax — the port of
``distributed_dot_product_tpu/models/ring_attention.py``.

Every rank of the process group ``group`` holds its ``(..., T/N, d)``
time shard of q, k and v. The k/v shards rotate around the ring
(:func:`~..utils.comm.ring_shift`, the reference's ``lax.ppermute`` with
the ``(i, i-1)`` permutation: at step ``s`` rank ``r`` holds the block
of owner ``(r + s) mod W``) while each rank folds the resident block
into its rows — score memory O((T/N)²) per fold, never a ``(T/N, T)``
row.

- ``block_impl='flash'`` (default): each fold is the flash kernel K1
  with its row logsumexp, at ``causal_offset = rank·T/N`` and
  ``kv_offset = owner·T/N`` (the owner's column block of a dense mask
  is passed as a strided view); the folds merge by their logsumexps
  (``num += e^{lse_b − m}·out_b``, ``den += e^{lse_b − m}``). The
  backward is a second ring pass: each rank folds its dq contribution
  (K3) locally and adds its float32 (dk, dv) partial (K4,
  ``grad_dtype=torch.float32``) into the accumulators that travel with
  the resident block; after the cycle each sits one hop from home, and
  one last hop delivers it. Under ``causal`` a fold whose block lies
  wholly in this rank's future — or, with a ``window``, wholly at or past
  the window in its past — is skipped on the host (the reference's
  ``_fold_skip``): the rank is a host int, so a skipped fold launches
  nothing. ``segment_ids`` (this shard's ``(..., T/N)`` ids, lead dims
  broadcastable against q's) rotate with their K/V block in both passes,
  on every rank and every fold, skipped folds included; a wholly
  cross-segment fold is skipped inside the kernel (it launches, and gives
  out 0 and lse ``ln2·_NEG_BIG``, weight 0 in the merge). Dropout keys on
  global coordinates (each fold passes its global offsets), so the ring
  draws the single-device kernel's mask; ``qk_quant='int8'`` quantizes
  each fold's rows as the single-device kernel would (row-local scales),
  and the backward carries the int8 operands of q and of each resident
  block. ``alibi_slopes`` (needs causal) ride every fold in both passes:
  each fold's kernels compute the bias from global positions, so the
  ring sees the single-device kernel's distances.
- ``block_impl='xla'``: the plain einsum + online-softmax fold in
  PyTorch (the reference's portable oracle path), differentiable through
  autograd with an autograd-aware ring hop; it computes every fold. It
  takes a window with ``mask=None`` and raises for segments, dropout and
  int8, as the reference's does.

``layout='zigzag'`` (causal, ``block_impl='flash'``, an even per-shard
length): shard ``i`` holds the half-stripes ``i`` and ``2W−1−i`` of the
sequence (permute global arrays with :func:`zigzag_indices`, and the
output back with its ``argsort``), so every rank folds W + 1 causal
half-blocks and the causal critical path evens out. Each fold passes the
kernels explicit global positions — ``positions=(my_pos, pos_k)`` with
``causal=False`` — for its causal mask, window, ALiBi distances, dropout
hash and tile skip; there is no whole-fold skip (every pair of shards
shares some past half-block). A dense mask's rows follow this shard's
zigzag rows (permute the global mask's row axis like q) while its
columns stay global: each fold gathers the owner's columns by its
position vector. Fully masked rows give 0 with zero gradients, as in
the reference.
"""

import math

import numpy as np
import torch

from distributed_dot_product_tpu_torch.ops.flash_attention import (
    flash_attention_bwd_operands, flash_attention_dkv, flash_attention_dq,
    flash_attention_with_lse, quantize_rows,
)
from distributed_dot_product_tpu_torch.utils.comm import (
    get_rank, get_world_size, ring_shift,
)

__all__ = ['ring_attention', 'local_attention_reference', 'zigzag_indices']


def _mask_bias(mask, dtype):
    """Large-finite rather than -inf: keeps the plain online recurrence
    and its gradient NaN-free even for fully masked rows."""
    big_neg = torch.finfo(dtype).min / 2
    return torch.where(mask, torch.tensor(big_neg, dtype=dtype,
                                          device=mask.device),
                       torch.tensor(0.0, dtype=dtype, device=mask.device))


def _row_has_valid(mask, causal, tq, tk, row_offset=0, window=None):
    """``(..., Tq, 1)``: does row i have any attendable key, counting the
    causal (and sliding-window) restriction (rows at global
    ``row_offset + i``)?"""
    valid = ~mask
    if causal:
        rows = row_offset + torch.arange(tq, device=mask.device)
        cols = torch.arange(tk, device=mask.device)
        allowed = rows[:, None] >= cols[None, :]
        if window is not None:
            allowed = allowed & (rows[:, None] - cols[None, :] < window)
        valid = valid & allowed
    return valid.any(dim=-1, keepdim=True)


def _blk_mask(mask, owner, tn):
    """This rank's rows × the owner's column block of the global-column
    mask (a view)."""
    if mask is None:
        return None
    return mask[..., owner * tn:(owner + 1) * tn]


def _blk_mask_positions(mask, pos_k):
    """Zigzag analog of :func:`_blk_mask`: the owner's columns are the
    two half-stripes of its position vector — gathered from the
    global-column mask (a copy; the rows already follow this shard's
    layout, the caller's contract)."""
    if mask is None:
        return None
    return mask.index_select(-1, pos_k)


def _layout_positions(layout, shard, world, tn, device=None):
    """Shard→global position vector ``(tn,)`` int64 for a
    non-contiguous layout, None for ``'contiguous'``. zigzag: the
    half-stripes ``shard`` and ``2W−1−shard``."""
    if layout == 'contiguous':
        return None
    h = tn // 2
    ar = torch.arange(h, device=device)
    return torch.cat([shard * h + ar, (2 * world - 1 - shard) * h + ar])


def zigzag_indices(t, world):
    """Global→zigzag gather indices, as the reference returns them
    (``x_zig = x[..., idx, :]`` gives contiguous shard ``i`` the
    half-stripes {i, 2W−1−i} that ``ring_attention(layout='zigzag')``
    expects; the inverse is ``argsort(idx)``)."""
    if t % (2 * world):
        raise ValueError(f'T={t} must divide into 2·world={2 * world} '
                         'half-stripes')
    h = t // (2 * world)
    return torch.from_numpy(np.concatenate([
        np.concatenate([i * h + np.arange(h),
                        (2 * world - 1 - i) * h + np.arange(h)])
        for i in range(world)]))


def ring_attention(q, k, v, mask=None, *, group=None, causal=False,
                   scale=None, block_impl='flash', layout='contiguous',
                   window=None, segment_ids=None, alibi_slopes=None,
                   qk_quant=None, dropout_rate=0.0, dropout_seed=None):
    """Sequence-parallel attention over the ring of ``group``
    (the default group when None): ``q, k, v`` are this rank's
    ``(..., T/N, d)`` shards (k/v may carry fewer heads: GQA, flash
    folds only), ``mask`` an optional boolean ``(..., T/N, T)`` with
    global columns (True = masked), ``causal`` over global positions,
    ``window`` (needs causal) a lookback cap over global positions,
    ``segment_ids`` this shard's ids ``(..., T/N)``, ``alibi_slopes``
    (needs causal), ``dropout_rate`` / ``dropout_seed`` and ``qk_quant``
    as in :func:`~..ops.flash_attention.flash_attention`; ``layout``
    ``'contiguous'`` or ``'zigzag'`` (see the module docstring). Returns
    ``(..., T/N, d_v)``, differentiable in q, k and v."""
    if block_impl not in ('flash', 'xla'):
        raise ValueError(
            f"block_impl must be 'flash' or 'xla', got {block_impl!r}")
    if (block_impl == 'xla'
            and tuple(k.shape[:-2]) != tuple(q.shape[:-2])):
        raise ValueError(
            "grouped-query (GQA) k/v heads require block_impl='flash' "
            '(the xla fold contracts q and k head axes directly)')
    if layout not in ('contiguous', 'zigzag'):
        raise ValueError(
            f"layout must be 'contiguous' or 'zigzag', got {layout!r}")
    if layout == 'zigzag':
        if not causal or block_impl != 'flash':
            raise ValueError(
                "layout='zigzag' balances the CAUSAL critical path and "
                "needs block_impl='flash'")
        if q.shape[-2] % 2:
            raise ValueError('zigzag needs an even per-shard length '
                             f'(got T/N = {q.shape[-2]})')
    if window is not None:
        if (isinstance(window, bool) or not isinstance(window, int)
                or window < 1):
            raise ValueError(f'window must be a positive int, got {window!r}')
        if not causal:
            raise ValueError('window is a lookback cap and requires '
                             'causal=True')
        if block_impl == 'xla' and mask is not None:
            raise ValueError(
                "block_impl='xla' supports window only with mask=None (its "
                'empty-row zeroing is not window-aware); use the flash '
                'backend for mask+window')
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    dropout_rate = float(dropout_rate)
    if qk_quant not in (None, 'int8'):
        raise ValueError(f"qk_quant must be None or 'int8', "
                         f'got {qk_quant!r}')
    if block_impl == 'xla' and (segment_ids is not None
                                or alibi_slopes is not None
                                or dropout_rate or qk_quant is not None):
        raise ValueError(
            "segment_ids/alibi_slopes/dropout/qk_quant need "
            "block_impl='flash' (they live in the fused per-fold kernels; "
            'the xla fold is the plain-einsum oracle path)')
    if alibi_slopes is not None and not causal:
        raise ValueError('alibi_slopes bias by relative global position '
                         'and require causal=True')
    if dropout_rate and dropout_seed is None:
        raise ValueError(
            'dropout needs an explicit dropout_seed (an int) — the kernels '
            'hold no hidden RNG state')
    if mask is not None and mask.dtype != torch.bool:
        mask = mask != 0
    if block_impl == 'flash':
        seg = (None if segment_ids is None
               else torch.as_tensor(segment_ids).to(torch.int32))
        feat = dict(window=window, dropout_rate=dropout_rate,
                    dropout_seed=dropout_seed if dropout_rate else None,
                    qk_quant=qk_quant, alibi_slopes=alibi_slopes)
        return _RingFlash.apply(q, k, v, mask, seg, group, bool(causal),
                                scale, layout, feat)
    return _ring_xla(q, k, v, mask, group, bool(causal), scale, window)


def _fold_skipped(causal, idx, owner, tn, window=None):
    """The reference's ``_fold_skip``: the owner's column block lies
    wholly in this rank's future — or, with a window, wholly at or past
    the window in its past (the closest pair is query row 0 at
    ``idx·tn`` against the block's last column ``owner·tn + tn − 1``)."""
    if not causal:
        return False
    return owner > idx or (window is not None
                           and (idx - owner) * tn - tn + 1 >= window)


def _fold_kw(mask, causal, idx, owner, w, tn, my_pos, device):
    """The per-fold kernel arguments: the owner's mask columns and
    either the contiguous offsets or, zigzag, the explicit positions with
    causal off."""
    if my_pos is None:
        return dict(mask=_blk_mask(mask, owner, tn), causal=causal,
                    causal_offset=idx * tn, kv_offset=owner * tn)
    pos_k = _layout_positions('zigzag', owner, w, tn, device)
    return dict(mask=_blk_mask_positions(mask, pos_k), causal=False,
                positions=(my_pos, pos_k))


def _ring_flash_fwd(q, k, v, mask, seg, group, causal, scale, layout, feat):
    """Forward ring: per fold K1's block-local ``(out_b, lse_b)``, merged
    by the shift-invariant identity; returns ``(out, lse)`` with the
    global row logsumexp, the only residual the backward needs. With
    dropout the folds drop the numerator only, so the merge rebuilds
    ``dropout(softmax(s))·v`` over the global row. Zigzag folds are never
    skipped whole (their kernels skip the future half-blocks' tiles)."""
    w, idx = get_world_size(group), get_rank(group)
    tn = q.shape[-2]
    my_pos = _layout_positions(layout, idx, w, tn, q.device)
    m = torch.full(q.shape[:-1], float('-inf'), dtype=torch.float32,
                   device=q.device)
    den = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
    num = torch.zeros((*q.shape[:-1], v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    rot = (k, v) if seg is None else (k, v, seg)
    for s in range(w):
        owner = (idx + s) % w
        k_buf, v_buf = rot[:2]
        if my_pos is not None or not _fold_skipped(causal, idx, owner, tn,
                                                   feat['window']):
            out_b, lse_b = flash_attention_with_lse(
                q, k_buf, v_buf, scale=scale,
                segment_ids=None if seg is None else (seg, rot[2]),
                **_fold_kw(mask, causal, idx, owner, w, tn, my_pos,
                           q.device), **feat)
            # A block-empty row has lse_b = ln2·_NEG_BIG: weight 0.
            m_new = torch.maximum(m, lse_b)
            c_prev = torch.exp(m - m_new)
            c_blk = torch.exp(lse_b - m_new)
            den = den * c_prev + c_blk
            num = num * c_prev[..., None] + c_blk[..., None] * out_b.float()
            m = m_new
        if s < w - 1:              # the last block needs no rotation
            rot = ring_shift(rot, group)
    # den > 0: the own diagonal block (s = 0) is never skipped. A row with
    # no attendable key has out_b = 0 in every fold, so num stays 0.
    return (num / den[..., None]).to(v.dtype), m + torch.log(den)


def _ring_flash_bwd(q, k, v, mask, seg, out, lse, g, group, causal, scale,
                    layout, feat):
    """Backward ring: ``(k, v, dk, dv[, seg])`` rotate together; each fold
    adds its K3 dq locally and its K4 float32 (dk, dv) partial to the
    accumulators of the resident block; one last hop sends each home.
    With int8 scoring the folds take q's int8 operands (quantized once)
    and the resident block's. Zigzag folds as in the forward."""
    w, idx = get_world_size(group), get_rank(group)
    tn = q.shape[-2]
    my_pos = _layout_positions(layout, idx, w, tn, q.device)
    q2, lse2, delta = flash_attention_bwd_operands(q, out, lse, g, scale)
    q_quant = quantize_rows(q) if feat['qk_quant'] == 'int8' else None
    bw = dict(window=feat['window'], dropout_rate=feat['dropout_rate'],
              dropout_seed=feat['dropout_seed'],
              alibi_slopes=feat['alibi_slopes'])
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    rot = (k, v, torch.zeros(k.shape, dtype=torch.float32, device=k.device),
           torch.zeros(v.shape, dtype=torch.float32, device=v.device))
    if seg is not None:
        rot += (seg,)
    for s in range(w):
        owner = (idx + s) % w
        k_buf, v_buf, dk_buf, dv_buf = rot[:4]
        if my_pos is not None or not _fold_skipped(causal, idx, owner, tn,
                                                   feat['window']):
            kw = dict(**_fold_kw(mask, causal, idx, owner, w, tn, my_pos,
                                 q.device),
                      grad_dtype=torch.float32, scale=scale,
                      segment_ids=None if seg is None else (seg, rot[4]),
                      quant=(None if q_quant is None
                             else (*q_quant, *quantize_rows(k_buf))),
                      **bw)
            dq += flash_attention_dq(q2, k_buf, v_buf, g, lse2, delta, **kw)
            dk_b, dv_b = flash_attention_dkv(q2, k_buf, v_buf, g, lse2,
                                             delta, **kw)
            rot = (k_buf, v_buf, dk_buf + dk_b, dv_buf + dv_b, *rot[4:])
        if s < w - 1:
            rot = ring_shift(rot, group)
    # Rank r now holds the complete (dk, dv) of block (r - 1) mod W.
    dk_buf, dv_buf = ring_shift(rot[2:4], group)
    return dq.to(q.dtype), dk_buf.to(k.dtype), dv_buf.to(v.dtype)


class _RingFlash(torch.autograd.Function):
    """The reference's ``_ring_flash`` ``custom_vjp``: the forward saves
    the inputs, ``out`` and the global ``lse``."""

    @staticmethod
    def forward(ctx, q, k, v, mask, seg, group, causal, scale, layout,
                feat):
        out, lse = _ring_flash_fwd(q, k, v, mask, seg, group, causal, scale,
                                   layout, feat)
        ctx.save_for_backward(q, k, v, mask, seg, out, lse)
        ctx.cfg = (group, causal, scale, layout, feat)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, seg, out, lse = ctx.saved_tensors
        group, causal, scale, layout, feat = ctx.cfg
        dq, dk, dv = _ring_flash_bwd(q, k, v, mask, seg, out, lse,
                                     g.contiguous(), group, causal, scale,
                                     layout, feat)
        return dq, dk, dv, None, None, None, None, None, None, None


class _RingShift(torch.autograd.Function):
    """One ring hop (rank r receives rank r+1's tensors); its gradient is
    the hop the other way."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return ring_shift(tensors, group, direction=-1)

    @staticmethod
    def backward(ctx, *grads):
        grads = tuple(g.contiguous() for g in grads)
        return (None, *ring_shift(grads, ctx.group, direction=1))


def _ring_xla(q, k, v, mask, group, causal, scale, window=None):
    """The plain block fold (the reference's portable path): float32
    einsums with an online softmax; masked logits are large-finite and
    rows with no attendable key are zeroed at the end."""
    w, idx = get_world_size(group), get_rank(group)
    tn = q.shape[-2]
    dtype = torch.promote_types(q.dtype, torch.float32)
    m = torch.full(q.shape[:-1], float('-inf'), dtype=dtype, device=q.device)
    l = torch.zeros(q.shape[:-1], dtype=dtype, device=q.device)
    o = torch.zeros((*q.shape[:-1], v.shape[-1]), dtype=dtype,
                    device=q.device)
    bias = None if mask is None else _mask_bias(mask, dtype)
    q_scaled = q.to(dtype) * scale
    row_pos = idx * tn + torch.arange(tn, device=q.device)
    big_neg = torch.finfo(dtype).min / 2
    k_buf, v_buf = k, v
    for s in range(w):
        # Every fold is computed, a wholly future one too (its weights
        # are exactly 0 after the diagonal fold s = 0): autograd runs a
        # hop's backward only where its outputs were used, and every rank
        # must run the same hops.
        owner = (idx + s) % w
        scores = torch.einsum('...td,...od->...to', q_scaled,
                              k_buf.to(dtype))
        if bias is not None:
            scores = scores + bias[..., owner * tn:(owner + 1) * tn]
        if causal:
            col_pos = owner * tn + torch.arange(tn, device=q.device)
            future = row_pos[:, None] < col_pos[None, :]
            if window is not None:
                future = future | (row_pos[:, None] - col_pos[None, :]
                                   >= window)
            scores = scores.masked_fill(future, big_neg)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum(
            '...to,...od->...td', p, v_buf.to(dtype))
        m = m_new
        if s < w - 1:
            k_buf, v_buf = _RingShift.apply(group, k_buf, v_buf)
    out = o / torch.where(l == 0, torch.ones_like(l), l)[..., None]
    if mask is not None:
        any_valid = _row_has_valid(mask, causal, tn, mask.shape[-1],
                                   row_offset=idx * tn)
        out = torch.where(any_valid, out, torch.zeros((), dtype=out.dtype,
                                                      device=out.device))
    return out.to(v.dtype)


def local_attention_reference(q, k, v, mask=None, causal=False, scale=None,
                              window=None):
    """Unsharded oracle: the same math on full tensors (float32 at
    least; large-finite masked logits; rows with no attendable key give
    0); ``window`` caps the causal lookback."""
    dtype = torch.promote_types(q.dtype, torch.float32)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    scores = torch.einsum('...td,...od->...to', q.to(dtype) * scale,
                          k.to(dtype))
    if mask is not None:
        scores = scores + _mask_bias(mask, dtype)
    if causal:
        rows = torch.arange(q.shape[-2], device=q.device)[:, None]
        cols = torch.arange(k.shape[-2], device=q.device)[None, :]
        future = rows < cols
        if window is not None:
            future = future | (rows - cols >= window)
        scores = scores.masked_fill(future, torch.finfo(dtype).min / 2)
    attn = torch.softmax(scores, dim=-1)
    out = torch.einsum('...to,...od->...td', attn, v.to(dtype))
    if mask is not None:
        out = torch.where(
            _row_has_valid(mask, causal, q.shape[-2], k.shape[-2],
                           window=window), out,
            torch.zeros((), dtype=out.dtype, device=out.device))
    return out.to(v.dtype)
