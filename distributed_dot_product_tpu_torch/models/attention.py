# -*- coding: utf-8 -*-
"""
Multi-head dot-product attention module — the port of
``DistributedDotProductAttn`` in
``distributed_dot_product_tpu/models/attention.py``.

Ported: the constructor validation, the cached inference surface
(``make_decode_cache``, ``prefill``, ``decode``, with the module's
``window``), the sequence-sharded decode (``decode_sharded``,
:func:`make_decode_step`, :func:`decode_seq_parallel`), ``forward`` (the
reference's ``__call__``) on this rank's time shard ``(B, T/N, d)`` for
all four softmax strategies across a ``torch.distributed`` process group
(the reference's ``seq`` mesh axis), and :func:`apply_seq_parallel`:

- ``'full'``: the paper's path — K-first ``matmul_nt(keys, queries,
  offset)``, the ``1/√dh`` scale, the ``-inf`` mask fill, softmax over
  the global axis, ``matmul_all``; GQA by repeating heads; causal
  densified into the mask from this rank's global rows. A fully masked
  row gives NaN, as in the reference;
- ``'flash'``: queries and values all-gathered (the gather's gradient is
  a reduce-scatter), then the flash kernel at ``causal_offset =
  rank·T/N`` (0 on one rank);
- ``'online'``: ring attention (:mod:`.ring_attention`);
- ``'ulysses'``: head all-to-all (:mod:`.ulysses_attention`), the flash
  path on one rank or one head.

RoPE rotates at the global positions ``rank·T/N + arange(T/N)`` (what
:func:`~..ops.rope.rope_seq_parallel` computes), or under
``ring_layout='zigzag'`` at the shard's zigzag positions. ``distributed=False``
is the local oracle on any group. ``window``, ``segment_ids``, dropout,
``alibi_slopes`` and ``qk_quant='int8'`` follow the reference: the 'full'
path densifies segments and the window into the mask (and refuses ALiBi,
dropout and int8); the kernel paths take them in the kernels (flash:
segments as a (local, gathered) pair in the K-first layout; online: the
ids ride the ring; ulysses: gathered once, and each rank keeps its head
chunk's slopes).

``ring_layout='zigzag'`` (``softmax_impl='online'``, causal): the ring's
balanced layout — shard ``i`` holds the half-stripes ``i`` and
``2W−1−i``; feed inputs permuted by
:func:`~.ring_attention.zigzag_indices` and invert the output's
permutation (a dense mask's row axis is permuted like the inputs).

Dropout: with ``dropout_rate > 0`` and not ``deterministic`` the forward
needs an explicit ``dropout_seed`` (an int; the port has no flax rng).
Each module salts it with its ``path`` — the tuple of names the same
module has in the reference's flax tree (``()`` for a module applied on
its own; a transformer stack sets its blocks' paths) — as the reference
does: ``seed ^ (crc32('/'.join(path)) & 0x7fffffff)`` in int32, so
stacked layers sharing one step seed draw distinct masks.

The module keeps the reference's K-FIRST convention (scores = K·Qᵀ
softmaxed over the queries axis): in standard-attention terms its
*keys* projection supplies the query rows and its *queries*/*values*
projections are the attended table — so the KV cache stores the
projected queries and values, ``num_kv_heads`` (GQA) shrinks those two
projections, and the flash kernel's query rows are the projected keys.
"""

import math
import zlib

import torch
from torch import nn

from distributed_dot_product_tpu_torch.models import features
from distributed_dot_product_tpu_torch.models.decode import (
    append_kv, decode_step, init_cache,
)
from distributed_dot_product_tpu_torch.models.dense import (
    OwnedDense, default_generator,
)
from distributed_dot_product_tpu_torch.models.ring_attention import (
    _layout_positions, local_attention_reference, ring_attention,
)
from distributed_dot_product_tpu_torch.models.ulysses_attention import (
    ulysses_attention,
)
from distributed_dot_product_tpu_torch.ops.flash_attention import (
    _i32, flash_attention,
)
from distributed_dot_product_tpu_torch.ops.ops import matmul_all, matmul_nt
from distributed_dot_product_tpu_torch.ops.rope import rope
from distributed_dot_product_tpu_torch.parallel.mesh import (
    shard_seq, unshard_seq,
)
from distributed_dot_product_tpu_torch.utils.comm import (
    SEQ_AXIS, all_gather, get_rank, get_world_size, reduce_scatter,
    resolve_device, world_group,
)

__all__ = ['DistributedDotProductAttn', 'apply_seq_parallel',
           'make_decode_step', 'decode_seq_parallel']


class _GatherSeq(torch.autograd.Function):
    """Tiled all-gather of this rank's shard along the time axis (-2);
    the gradient is the reduce-scatter of the cotangent back to the
    shards."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x, group, dim=-2)

    @staticmethod
    def backward(ctx, g):
        w = get_world_size(ctx.group)
        blocks = torch.stack(g.chunk(w, dim=-2))          # (W, ..., T/N, d)
        return reduce_scatter(blocks, ctx.group), None


class DistributedDotProductAttn(nn.Module):
    """Multi-head dot-product attention (K-first convention).

    Constructor fields mirror the reference module's and are validated
    the same way (same errors for the same bad values). ``weight_quant=
    'int8'`` stores the four projections' weights int8 with float32
    per-output-channel scales (:class:`~..models.dense.OwnedDense`; load
    them with :func:`~..models.dense.quantize_dense_params`): every
    forward, prefill and decode step then runs the s8 × s8 → s32 product
    with the activation rows quantized on the fly — an inference path,
    whose int8 buffers are not trained. ``alibi_slopes (num_heads,)`` are
    kept as a float32 tensor on the module's device.
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
        if qk_quant not in (None, 'int8'):
            raise ValueError(f"qk_quant must be None or 'int8', "
                             f'got {qk_quant!r}')

        self.num_heads = num_heads
        self.causal, self.window, self.qk_quant = causal, window, qk_quant
        # The module's path in the reference's flax tree (salts dropout).
        self.path = ()
        self.distributed = distributed
        self.softmax_impl = softmax_impl
        self.offset, self.impl = offset, impl
        self.flash_softmax_mode = flash_softmax_mode
        self.ring_layout = ring_layout
        self.dropout_rate = dropout_rate
        self.use_rope, self.rope_base = use_rope, rope_base
        self.decode_impl = decode_impl
        self.weight_quant = weight_quant
        self.dtype = dtype or torch.float32
        self.head_dim = head_dim
        self._value_dim = value_dim
        self._kv_heads = kv_heads
        dev = resolve_device(device)
        gen = default_generator(generator)
        # Configuration, not a parameter or buffer: a dtype cast of the
        # module leaves the slopes float32, and the state dict stays the
        # reference tree's.
        self.alibi_slopes = (None if alibi_slopes is None
                             else torch.as_tensor(alibi_slopes,
                                                  dtype=torch.float32,
                                                  device=dev).reshape(-1))

        def dense(d_in, d_out):
            return OwnedDense(d_in, d_out, use_bias=add_bias, dtype=dtype,
                              param_dtype=param_dtype,
                              weight_quant=weight_quant, device=dev,
                              generator=gen)
        # Same four projections as the reference; under GQA the queries/
        # values projections (the attended side, K-first) emit only
        # kv_heads heads.
        self.keys_proj = dense(key_dim, key_dim)
        self.queries_proj = dense(query_dim or key_dim, kv_heads * head_dim)
        self.values_proj = dense(value_dim,
                                 kv_heads * (value_dim // num_heads))
        self.composition = dense(value_dim, value_dim)

    def forward(self, keys, queries, values, attn_mask=None,
                segment_ids=None, deterministic=False, dropout_seed=None,
                *, group=None):
        """The reference ``__call__`` on this rank's time shards
        ``keys/queries/values (B, T/N, d·)``, boolean ``attn_mask
        (B, T/N, T)`` (True = masked out; None = no masking) and int
        ``segment_ids (B, T/N)`` (packed documents; pairs in different
        segments do not attend) over the sequence group ``group`` (the
        default process group when None; a process without one is a
        one-rank group). ``deterministic`` turns dropout off;
        ``dropout_seed`` (an int, e.g. the step counter) seeds it.
        Returns ``(B, T/N, value_dim)``, differentiable (the kernel paths
        backpropagate through K3/K4; the collectives a gradient crosses
        carry their transposes)."""
        distributed = self.distributed
        world = get_world_size(group) if distributed else 1
        idx = get_rank(group) if distributed else 0
        tn = keys.shape[-2]
        impl = self.softmax_impl
        if impl == 'ulysses' and not (distributed and self.num_heads > 1):
            impl = 'flash'     # no head axis to scatter, or the local oracle
        start = idx * tn
        if impl == 'online' and self.ring_layout == 'zigzag' and world > 1:
            start = _layout_positions('zigzag', idx, world, tn, keys.device)
        keys, queries, values = self._project(keys, queries, values, start)
        if attn_mask is not None:
            attn_mask = attn_mask[..., None, :, :]    # broadcast over heads
        scale = 1.0 / math.sqrt(self.head_dim)
        kv_group = self.num_heads // self._kv_heads
        seg = (None if segment_ids is None
               else torch.as_tensor(segment_ids).to(torch.int32))
        drop_rate, drop_seed = self._dropout(deterministic, dropout_seed)
        feat = dict(window=self.window if self.causal else None,
                    qk_quant=self.qk_quant, dropout_rate=drop_rate,
                    dropout_seed=drop_seed, alibi_slopes=self.alibi_slopes)
        if impl == 'flash':
            q_full, v_full = queries, values
            seg_pair = None
            if distributed:
                q_full = _GatherSeq.apply(queries, group)
                v_full = _GatherSeq.apply(values, group)
            if seg is not None:
                # K-first: the kernel's query rows are this shard's keys
                # (local ids), its key columns the gathered queries.
                seg_kv = all_gather(seg, group, dim=-1) if distributed \
                    else seg
                seg_pair = (seg[..., None, :], seg_kv[..., None, :])
            out = flash_attention(
                keys, q_full, v_full, attn_mask, causal=self.causal,
                causal_offset=idx * tn if world > 1 else 0, scale=scale,
                softmax_mode=self.flash_softmax_mode, segment_ids=seg_pair,
                **feat)
        elif impl == 'ulysses':
            out = ulysses_attention(keys, queries, values, attn_mask,
                                    group=group, causal=self.causal,
                                    scale=scale,
                                    softmax_mode=self.flash_softmax_mode,
                                    segment_ids=seg, **feat)
        elif impl == 'online':
            seg_ring = None if seg is None else seg[..., None, :]
            if distributed:
                out = ring_attention(keys, queries, values, attn_mask,
                                     group=group, causal=self.causal,
                                     scale=scale, layout=self.ring_layout,
                                     segment_ids=seg_ring, **feat)
            elif (seg_ring is not None or self.qk_quant or drop_rate
                    or self.alibi_slopes is not None):
                # The fused kernel is the local math for segments,
                # ALiBi, dropout and int8 scoring (the plain oracle has
                # none).
                out = flash_attention(
                    keys, queries, values, attn_mask, causal=self.causal,
                    scale=scale, segment_ids=(
                        None if seg_ring is None else (seg_ring, seg_ring)),
                    **feat)
            else:
                out = local_attention_reference(
                    keys, queries.repeat_interleave(kv_group, dim=-3),
                    values.repeat_interleave(kv_group, dim=-3), attn_mask,
                    causal=self.causal, scale=scale, window=feat['window'])
        else:
            if seg is not None:
                # The parity path builds (T/N, T) rows anyway: segments
                # densify into the mask (rows local, columns global).
                seg_full = all_gather(seg, group, dim=-1) if distributed \
                    else seg
                dense = (seg[..., :, None] != seg_full[..., None, :])[
                    ..., None, :, :]
                attn_mask = dense if attn_mask is None else attn_mask | dense
            out = self._full(keys, queries, values, attn_mask, group,
                             distributed, world, idx, kv_group)
        return self._merge_heads(out)

    def _dropout(self, deterministic, dropout_seed):
        """``(rate, seed)`` of this call: the reference's per-layer salt
        ``seed ^ (crc32(path) & 0x7fffffff)`` (int32) over the explicit
        seed; ``(0.0, None)`` without dropout or when deterministic."""
        if not self.dropout_rate or deterministic:
            return 0.0, None
        if dropout_seed is None:
            raise ValueError(
                'this module has dropout_rate > 0: pass dropout_seed=<an '
                'int, e.g. the step counter> (the port has no flax rng), '
                'or deterministic=True')
        salt = zlib.crc32('/'.join(self.path).encode()) & 0x7fffffff
        return self.dropout_rate, _i32(dropout_seed) ^ salt

    def _full(self, keys, queries, values, attn_mask, group, distributed,
              world, idx, kv_group):
        """The paper's path: ``(B, H, T/N, T)`` score rows from the
        distributed ``matmul_nt``, the softmax over the global axis, the
        distributed ``matmul_all``."""
        if kv_group > 1:
            queries = queries.repeat_interleave(kv_group, dim=-3)
            values = values.repeat_interleave(kv_group, dim=-3)
        if self.causal:
            tn = keys.shape[-2]
            t_global = (attn_mask.shape[-1] if attn_mask is not None
                        else tn * world)
            rows = idx * tn + torch.arange(tn, device=keys.device)
            cols = torch.arange(t_global, device=keys.device)
            future = rows[:, None] < cols[None, :]
            if self.window is not None:
                future = future | (rows[:, None] - cols[None, :]
                                   >= self.window)
            attn_mask = future if attn_mask is None else attn_mask | future
        if distributed:
            scores = matmul_nt(keys, queries, self.offset, group, self.impl)
        else:
            scores = torch.matmul(keys, queries.transpose(-1, -2))
        scores = scores / math.sqrt(self.head_dim)
        if attn_mask is not None:
            scores = scores.masked_fill(attn_mask, float('-inf'))
        attn = torch.softmax(scores, dim=-1)
        if distributed:
            return matmul_all(attn, values, self.offset, group, self.impl)
        return torch.matmul(attn, values)

    def make_decode_cache(self, batch, t_max, dtype=None, device=None):
        """A KV cache sized for this module's projections (GQA-aware),
        on the module's device unless ``device`` is given; an int8 module
        (``qk_quant='int8'``) gets the int8 K mirror its decode steps
        score against."""
        return init_cache(
            batch, self._kv_heads, t_max, self.head_dim,
            v_head_dim=self._value_dim // self.num_heads,
            dtype=dtype or self.dtype, qk_quant=self.qk_quant,
            device=device or self.keys_proj.device)

    def _project(self, keys, queries, values, start):
        """Shared front half of every call: the four projections, head
        split, and RoPE at the global positions ``start + arange(n)``
        (this rank's shard: ``rank·T/N``, the cached paths: the cache
        length), or at ``start`` itself when it is a position vector (a
        zigzag shard's)."""
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
            pos = (start if isinstance(start, torch.Tensor)
                   else start + torch.arange(n, device=keys.device))
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

    def prefill(self, keys, queries, values, cache, segment_ids=None,
                seg_cache=None):
        """Prompt ingestion: project the ``n`` new positions, append the
        projected queries/values to the cache (in place), and compute the
        rows' outputs with the flash kernel over the whole cache buffer —
        causal from global position ``cache.length`` excludes both the
        future prompt rows and the unfilled tail — with the module's
        ``window``, ``alibi_slopes`` and ``qk_quant``, as its forward.
        Packed multi-turn prompts: ``segment_ids (B, n)`` holds the prompt
        rows' ids, ``seg_cache (B, t_max)`` the cached positions' (already
        carrying the ids of the positions being appended). Returns
        ``(cache, out (B, n, value_dim))``."""
        keys, queries, values = self._project_for_decode(
            keys, queries, values, cache)
        start = cache.length
        cache = append_kv(cache, queries, values)
        seg_pair = None
        if segment_ids is not None:
            if seg_cache is None:
                raise ValueError('segment_ids needs seg_cache (the cached '
                                 "positions' ids, shape (B, t_max))")
            seg_pair = tuple(torch.as_tensor(x, device=keys.device)
                             .to(torch.int32)[..., None, :]
                             for x in (segment_ids, seg_cache))
        out = flash_attention(keys, cache.k, cache.v, causal=True,
                              causal_offset=start,
                              scale=1.0 / math.sqrt(self.head_dim),
                              window=self.window,
                              alibi_slopes=self.alibi_slopes,
                              qk_quant=self.qk_quant, segment_ids=seg_pair)
        return cache, self._merge_heads(out)

    def decode(self, keys, queries, values, cache, segment_ids=None,
               seg_cache=None):
        """One cached step for the NEW positions ``(B, 1, d·)``: the fused
        append + attend (``decode_impl`` selects the implementation) with
        the module's ``window``, ``alibi_slopes`` and ``qk_quant`` (int8:
        scored against the cache's int8 K mirror, appended in place by the
        kernel; a mirror-less cache needs the plain step, quantizing on the
        fly — ``decode_impl='plain'`` on the card, the default on the
        CPU). Packed segments: this step's ``segment_ids (B, n)`` with the
        cached positions' ``seg_cache (B, t_max)``; the kernel does not
        mask them, so on the card they need ``decode_impl='plain'`` (the
        reference's own formulation). Returns ``(cache, out (B, 1,
        value_dim))``."""
        keys, queries, values = self._project_for_decode(
            keys, queries, values, cache)
        cache, out = decode_step(keys, cache, queries, values,
                                 scale=1.0 / math.sqrt(self.head_dim),
                                 window=self.window,
                                 alibi_slopes=self.alibi_slopes,
                                 segment_ids=seg_cache, seg_q=segment_ids,
                                 qk_quant=self.qk_quant,
                                 impl=self.decode_impl)
        return cache, self._merge_heads(out)

    def decode_sharded(self, keys, queries, values, cache, segment_ids=None,
                       seg_cache=None, *, group=None):
        """Sequence-sharded :meth:`decode` over the process group
        ``group`` (the default group when None): ``cache`` is this rank's
        ``(B, H_kv, t_max/W, d·)`` slab of a global cache sharded on its
        ``t_max`` axis (:func:`~..parallel.mesh.shard_decode_cache`), with
        the GLOBAL length; the new positions ``(B, 1, d·)`` and the output
        are the same on every rank. RoPE rotates at the global positions;
        the owning rank appends in place, and the ranks' softmax partials
        merge by the flash-decoding rule (the kernel path: K5 with
        ``partials=True`` on every slab). ``seg_cache``, when used, is the
        slab's own ``(B, t_max/W)`` shard (segments take the plain step).
        Returns ``(cache, out (B, 1, value_dim))``."""
        keys, queries, values = self._project_for_decode(
            keys, queries, values, cache)
        cache, out = decode_step(
            keys, cache, queries, values,
            scale=1.0 / math.sqrt(self.head_dim), window=self.window,
            alibi_slopes=self.alibi_slopes, segment_ids=seg_cache,
            seg_q=segment_ids, qk_quant=self.qk_quant,
            group=world_group() if group is None else group,
            impl=self.decode_impl)
        return cache, self._merge_heads(out)


def make_decode_step(module, mesh, mesh_axis=None):
    """The sequence-sharded decode step of ``module`` on ``mesh``'s seq
    group: ``step(keys, queries, values, cache) -> (cache, out)``, with
    ``cache`` this rank's slab (:func:`~..parallel.mesh.shard_decode_cache`)
    and the global length. The reference compiles and caches a
    ``shard_map``ped step (and donates the cache to it); nothing is traced
    here, so the step is the module's :meth:`decode_sharded` bound to the
    group, and the slab is appended in place. ``mesh_axis``, when given,
    must name the mesh's seq axis."""
    seq_axis = mesh.axis_names[-1]
    if mesh_axis not in (None, seq_axis):
        raise ValueError(f'mesh_axis {mesh_axis!r} is not the mesh\'s seq '
                         f'axis {seq_axis!r}')

    def step(keys, queries, values, cache):
        return module.decode_sharded(keys, queries, values, cache,
                                     group=mesh.seq_group)
    return step


def decode_seq_parallel(module, mesh, keys, queries, values, cache,
                        mesh_axis=None):
    """One sequence-sharded decode step: ``keys/queries/values (B, 1, d·)``
    and the output are the same on every rank of ``mesh``'s seq group,
    ``cache`` is this rank's slab of the global cache (build the global
    one with ``module.make_decode_cache(batch, t_max_global)`` and take
    the slab with :func:`~..parallel.mesh.shard_decode_cache`). Returns
    ``(cache, out)``; feed the cache back in for the next token. The
    reference's wrapper keeps an LRU of compiled steps; the port traces
    nothing, so there is nothing to cache (:func:`make_decode_step`
    gives the same step bound once). The module holds its parameters:
    there is no params argument."""
    return make_decode_step(module, mesh, mesh_axis)(keys, queries, values,
                                                     cache)


def apply_seq_parallel(module, mesh, keys, queries, values, attn_mask=None):
    """Run ``module`` sequence-parallel over ``mesh``'s seq group on
    GLOBAL tensors ``(B, T, d·)`` (and a boolean ``(B, T, T)`` mask) that
    every rank of the group holds alike: each rank takes its time shard
    (:func:`~..parallel.mesh.shard_seq`; the mask by rows), runs the
    module on it, and the shards of the output are gathered back into
    the global ``(B, T, value_dim)`` (:func:`~..parallel.mesh.unshard_seq`,
    not differentiable — train through
    :func:`~..train.make_train_step`, or call the module on the shards).
    The reference's ``apply_seq_parallel`` without the params argument:
    the module holds its parameters."""
    shards = [shard_seq(x, mesh) for x in (keys, queries, values)]
    mask = None if attn_mask is None else shard_seq(attn_mask, mesh)
    out = module(*shards, mask, group=mesh.seq_group)
    return unshard_seq(out, mesh)
