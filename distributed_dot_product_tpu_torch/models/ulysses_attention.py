# -*- coding: utf-8 -*-
"""
Ulysses (head all-to-all) sequence parallelism — the port of
``distributed_dot_product_tpu/models/ulysses_attention.py``.

Inputs arrive sequence-sharded ``(..., H, T/N, d)``; one all-to-all per
operand re-shards heads↔time so each rank holds the FULL sequence for
``H/N`` heads ``(..., H/N, T, d)``; the flash kernel (K1, or K2 with
``softmax_mode='bounded'``) runs locally over it; a mirror all-to-all
restores ``(..., H, T/N, d_v)``. The all-to-all is its own transpose, so
the backward is the mirrored exchange (an autograd Function). A dense
mask ``(..., 1, T/N, T)`` is all-gathered to ``(..., 1, T, T)`` on every
rank — every rank owns whole attention rows after the scatter.

Segment ids ``(..., T/N)`` are gathered once to ``(..., 1, T)`` (both
sides of every row the rank owns span the full sequence); the window and
int8 scoring pass straight through (the kernel sees whole rows, so its
per-row quantization is the single-device one); dropout runs at the seed
``dropout_seed + rank·40503`` (int32): after the head scatter every rank
holds batch × H/N rows whose flat indices repeat across ranks, so a
shared seed would repeat masks head group to head group. ALiBi raises
``NotImplementedError`` (``ROADMAP.md`` §2 item 1).
"""

import math

import torch

from distributed_dot_product_tpu_torch.ops.flash_attention import (
    _i32, flash_attention,
)
from distributed_dot_product_tpu_torch.utils.comm import (
    all_gather, all_to_all, get_rank, get_world_size,
)

__all__ = ['ulysses_attention']


class _AllToAll(torch.autograd.Function):
    """Tiled all-to-all (split ``split_dim``, concatenate ``concat_dim``);
    the gradient is the inverse exchange."""

    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.cfg = (group, split_dim, concat_dim)
        return all_to_all(x, group, split_dim=split_dim,
                          concat_dim=concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.cfg
        return (all_to_all(g.contiguous(), group, split_dim=concat_dim,
                           concat_dim=split_dim), None, None, None)


def ulysses_attention(q, k, v, mask=None, *, group=None, causal=False,
                      scale=None, softmax_mode='exact', segment_ids=None,
                      window=None, alibi_slopes=None, qk_quant=None,
                      dropout_rate=0.0, dropout_seed=None):
    """Sequence-parallel attention by head↔time all-to-all over
    ``group`` (the default group when None). ``q, k, v``: this rank's
    shards ``(..., H, T/N, d)``; ``H`` (and, under GQA, the kv heads) must
    divide by the group width. ``mask``: optional boolean
    ``(..., 1, T/N, T)`` (a size-1 head axis, as in the reference);
    ``segment_ids``: optional int ``(..., T/N)`` (no head axis).
    Returns ``(..., H, T/N, d_v)``, differentiable in q, k and v."""
    if alibi_slopes is not None:
        raise NotImplementedError(
            'ulysses_attention(alibi_slopes=...) is not ported yet '
            '(ROADMAP.md §2 item 1)')
    world = get_world_size(group)
    if q.dim() < 3:
        raise ValueError(
            f'ulysses_attention needs (..., H, T/N, d) inputs with an '
            f'explicit head axis; got {q.dim()}-D')
    heads = q.shape[-3]
    if heads % world:
        raise ValueError(
            f'ulysses_attention requires heads ({heads}) divisible by the '
            f'mesh width ({world}); use softmax_impl="online" (ring) when '
            f'N > H')
    if k.shape[-3] != heads and k.shape[-3] % world:
        raise ValueError(
            f'ulysses_attention GQA requires kv heads ({k.shape[-3]}) '
            f'divisible by the mesh width ({world})')
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    h_ax, t_ax = q.dim() - 3, q.dim() - 2

    def scatter_heads(x):
        # (..., H, T/N, d) -> (..., H/N, T, d)
        return _AllToAll.apply(x, group, h_ax, t_ax)

    full_mask = None
    if mask is not None:
        if mask.dim() != q.dim():
            raise ValueError(
                f'mask must have the same rank as q with a size-1 head '
                f'axis at position -3 (insert one with mask[..., None, :, :]'
                f'); got mask.dim()={mask.dim()}, q.dim()={q.dim()}')
        if mask.shape[-3] != 1:
            raise ValueError(
                f'ulysses_attention supports head-broadcast masks only '
                f'(head axis of size 1, got {mask.shape[-3]}); per-head '
                f'masks would need their own head scatter')
        full_mask = all_gather(mask, group, dim=-2)
    seg_pair = None
    if segment_ids is not None:
        seg_full = all_gather(torch.as_tensor(segment_ids).to(torch.int32),
                              group, dim=-1)[..., None, :]
        seg_pair = (seg_full, seg_full)
    seed_local = dropout_seed
    if dropout_rate and dropout_seed is not None:
        seed_local = _i32(int(dropout_seed) + get_rank(group) * 40503)
    out = flash_attention(scatter_heads(q), scatter_heads(k),
                          scatter_heads(v), full_mask, causal=causal,
                          scale=scale, softmax_mode=softmax_mode,
                          segment_ids=seg_pair, window=window,
                          qk_quant=qk_quant, dropout_rate=dropout_rate,
                          dropout_seed=seed_local)
    # (..., H/N, T, d_v) -> (..., H, T/N, d_v): the exact inverse.
    return _AllToAll.apply(out, group, t_ax, h_ax)
