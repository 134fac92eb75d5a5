# -*- coding: utf-8 -*-
"""
Ring attention with online softmax — the port of
``distributed_dot_product_tpu/models/ring_attention.py`` (contiguous
layout).

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
  wholly in this rank's future is skipped on the host: the rank is a
  host int, so a skipped fold launches nothing.
- ``block_impl='xla'``: the plain einsum + online-softmax fold in
  PyTorch (the reference's portable oracle path), differentiable through
  autograd with an autograd-aware ring hop; it computes every fold.

The reference's ``layout='zigzag'``, ``window``, ``segment_ids``,
``alibi_slopes``, ``qk_quant`` and dropout raise ``NotImplementedError``
(``ROADMAP.md`` §1 item 7 and §2 item 1: the kernels do not take
positions, windows, segments, ALiBi, int8 scoring or the dropout hash
yet). Fully masked rows give 0 with zero gradients, as in the reference.
"""

import math

import numpy as np
import torch

from distributed_dot_product_tpu_torch.ops.flash_attention import (
    flash_attention_bwd_operands, flash_attention_dkv, flash_attention_dq,
    flash_attention_with_lse,
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


def _row_has_valid(mask, causal, tq, tk, row_offset=0):
    """``(..., Tq, 1)``: does row i have any attendable key, counting the
    causal restriction (rows at global ``row_offset + i``)?"""
    valid = ~mask
    if causal:
        rows = row_offset + torch.arange(tq, device=mask.device)
        cols = torch.arange(tk, device=mask.device)
        valid = valid & (rows[:, None] >= cols[None, :])
    return valid.any(dim=-1, keepdim=True)


def _blk_mask(mask, owner, tn):
    """This rank's rows × the owner's column block of the global-column
    mask (a view)."""
    if mask is None:
        return None
    return mask[..., owner * tn:(owner + 1) * tn]


def zigzag_indices(t, world):
    """Global→zigzag gather indices, as the reference returns them
    (``x_zig = x[..., idx, :]``; the inverse is ``argsort(idx)``). The
    zigzag ring layout itself is not ported (``ROADMAP.md`` §1 item 7)."""
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
    global columns (True = masked), ``causal`` over global positions.
    Returns ``(..., T/N, d_v)``, differentiable in q, k and v."""
    if block_impl not in ('flash', 'xla'):
        raise ValueError(
            f"block_impl must be 'flash' or 'xla', got {block_impl!r}")
    if layout not in ('contiguous', 'zigzag'):
        raise ValueError(
            f"layout must be 'contiguous' or 'zigzag', got {layout!r}")
    unported = dict(window=window, segment_ids=segment_ids,
                    alibi_slopes=alibi_slopes, qk_quant=qk_quant,
                    dropout_seed=dropout_seed,
                    layout=None if layout == 'contiguous' else layout,
                    dropout_rate=float(dropout_rate) or None)
    for name, value in unported.items():
        if value is not None:
            raise NotImplementedError(
                f'ring_attention({name}=...) is not ported yet (ROADMAP.md '
                f'§1 item 7, §2 item 1)')
    if (block_impl == 'xla'
            and tuple(k.shape[:-2]) != tuple(q.shape[:-2])):
        raise ValueError(
            "grouped-query (GQA) k/v heads require block_impl='flash' "
            '(the xla fold contracts q and k head axes directly)')
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    if mask is not None and mask.dtype != torch.bool:
        mask = mask != 0
    if block_impl == 'flash':
        return _RingFlash.apply(q, k, v, mask, group, bool(causal), scale)
    return _ring_xla(q, k, v, mask, group, bool(causal), scale)


def _fold_skipped(causal, idx, owner):
    """The owner's column block lies wholly in this rank's future."""
    return causal and owner > idx


def _ring_flash_fwd(q, k, v, mask, group, causal, scale):
    """Forward ring: per fold K1's block-local ``(out_b, lse_b)``, merged
    by the shift-invariant identity; returns ``(out, lse)`` with the
    global row logsumexp, the only residual the backward needs."""
    w, idx = get_world_size(group), get_rank(group)
    tn = q.shape[-2]
    m = torch.full(q.shape[:-1], float('-inf'), dtype=torch.float32,
                   device=q.device)
    den = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
    num = torch.zeros((*q.shape[:-1], v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    k_buf, v_buf = k, v
    for s in range(w):
        owner = (idx + s) % w
        if not _fold_skipped(causal, idx, owner):
            out_b, lse_b = flash_attention_with_lse(
                q, k_buf, v_buf, _blk_mask(mask, owner, tn), causal=causal,
                causal_offset=idx * tn, kv_offset=owner * tn, scale=scale)
            # A block-empty row has lse_b = ln2·_NEG_BIG: weight 0.
            m_new = torch.maximum(m, lse_b)
            c_prev = torch.exp(m - m_new)
            c_blk = torch.exp(lse_b - m_new)
            den = den * c_prev + c_blk
            num = num * c_prev[..., None] + c_blk[..., None] * out_b.float()
            m = m_new
        if s < w - 1:              # the last block needs no rotation
            k_buf, v_buf = ring_shift((k_buf, v_buf), group)
    # den > 0: the own diagonal block (s = 0) is never skipped. A row with
    # no attendable key has out_b = 0 in every fold, so num stays 0.
    return (num / den[..., None]).to(v.dtype), m + torch.log(den)


def _ring_flash_bwd(q, k, v, mask, out, lse, g, group, causal, scale):
    """Backward ring: ``(k, v, dk, dv)`` rotate together; each fold adds
    its K3 dq locally and its K4 float32 (dk, dv) partial to the
    accumulators of the resident block; one last hop sends each home."""
    w, idx = get_world_size(group), get_rank(group)
    tn = q.shape[-2]
    q2, lse2, delta = flash_attention_bwd_operands(q, out, lse, g, scale)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    k_buf, v_buf = k, v
    dk_buf = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv_buf = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for s in range(w):
        owner = (idx + s) % w
        if not _fold_skipped(causal, idx, owner):
            kw = dict(mask=_blk_mask(mask, owner, tn), causal=causal,
                      causal_offset=idx * tn, kv_offset=owner * tn,
                      grad_dtype=torch.float32)
            dq += flash_attention_dq(q2, k_buf, v_buf, g, lse2, delta,
                                     scale=scale, **kw)
            dk_b, dv_b = flash_attention_dkv(q2, k_buf, v_buf, g, lse2,
                                             delta, **kw)
            dk_buf += dk_b
            dv_buf += dv_b
        if s < w - 1:
            k_buf, v_buf, dk_buf, dv_buf = ring_shift(
                (k_buf, v_buf, dk_buf, dv_buf), group)
    # Rank r now holds the complete (dk, dv) of block (r - 1) mod W.
    dk_buf, dv_buf = ring_shift((dk_buf, dv_buf), group)
    return dq.to(q.dtype), dk_buf.to(k.dtype), dv_buf.to(v.dtype)


class _RingFlash(torch.autograd.Function):
    """The reference's ``_ring_flash`` ``custom_vjp``: the forward saves
    the inputs, ``out`` and the global ``lse``."""

    @staticmethod
    def forward(ctx, q, k, v, mask, group, causal, scale):
        out, lse = _ring_flash_fwd(q, k, v, mask, group, causal, scale)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.cfg = (group, causal, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, out, lse = ctx.saved_tensors
        group, causal, scale = ctx.cfg
        dq, dk, dv = _ring_flash_bwd(q, k, v, mask, out, lse,
                                     g.contiguous(), group, causal, scale)
        return dq, dk, dv, None, None, None, None


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


def _ring_xla(q, k, v, mask, group, causal, scale):
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
            scores = scores.masked_fill(
                row_pos[:, None] < col_pos[None, :], big_neg)
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


def local_attention_reference(q, k, v, mask=None, causal=False, scale=None):
    """Unsharded oracle: the same math on full tensors (float32 at
    least; large-finite masked logits; rows with no attendable key give
    0). The reference's ``window`` is not ported (``ROADMAP.md`` §2 item
    1)."""
    dtype = torch.promote_types(q.dtype, torch.float32)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    scores = torch.einsum('...td,...od->...to', q.to(dtype) * scale,
                          k.to(dtype))
    if mask is not None:
        scores = scores + _mask_bias(mask, dtype)
    if causal:
        rows = torch.arange(q.shape[-2], device=q.device)[:, None]
        cols = torch.arange(k.shape[-2], device=q.device)[None, :]
        scores = scores.masked_fill(rows < cols, torch.finfo(dtype).min / 2)
    attn = torch.softmax(scores, dim=-1)
    out = torch.einsum('...to,...od->...td', attn, v.to(dtype))
    if mask is not None:
        out = torch.where(
            _row_has_valid(mask, causal, q.shape[-2], k.shape[-2]), out,
            torch.zeros((), dtype=out.dtype, device=out.device))
    return out.to(v.dtype)
