# -*- coding: utf-8 -*-
"""
Fused KV-cache decode step — the port of kernels K5 and K5p,
``_make_decode_kernel`` (slab body ``kernel_body`` and paged body
``kernel_paged``) in ``distributed_dot_product_tpu/ops/pallas_decode.py``.

One call appends each slot's new k/v rows to the cache IN PLACE at
``append_at`` and attends the slot's query heads against the cache
prefix ``0..valid_to`` (the appended rows included), GQA native. Layouts
follow the reference: ``q (B, H, k, d)``, ``k_new/v_new (B, H_kv, k,
d)``, ``cache_k/cache_v (B, H_kv, t_max, d)``, ``valid_to/append_at
(B,)`` int (``append_at = -1`` appends nothing; otherwise it must equal
``valid_to``, the standard causal decode order; ``valid_to < 0`` gives a
zero output row).

VERIFY-k (``k = q.shape[-2] > 1``, the fused verify step of draft-verify
speculative decoding): the rows append at consecutive columns
``append_at .. append_at + k - 1`` and query row ``j`` attends columns
``<= valid_to + j`` — the shared prefix plus the intra-step causal
triangle. ``n_new (B,)`` is the per-slot count of rows actually appended
(default ``k`` wherever ``append_at >= 0``); rows ``m >= n_new`` are
neither appended nor substituted into the scores, and their query rows
give outputs the caller discards. ``k`` must not exceed the K split:
``block_k`` when given, else ``min(128, t_max)`` columns on a slab (the
port's split, below the reference's), the page size when paged. Row
``j`` gives the bits of the ``j``-th of ``k`` sequential one-row steps,
on the card and on the CPU.

``block_k``: the reference's K split, validated as the reference
validates it — on a slab it must divide ``t_max`` (and ``k`` must not
exceed it), paged it must equal the page size; anything else raises the
reference's ``ValueError``. On the card the slab kernel then splits at
it (a cluster rank owns ``block_k`` columns at a time); paged, and with
no ``block_k``, the kernel keeps its 128-column split. The plain version
computes the same softmax whatever the split (the answer differs from
the kernel's only by rounding).

PAGED mode (``page_table (B, pages_per_slot) int32``, K5p):
``cache_k/cache_v`` are global ``(pages + 1, H_kv, page_size, d)``
pools whose last row is the reserved sink page. Column ``c`` of slot
``i`` lives at row ``c % page_size`` of pool page
``page_table[i, c // page_size]``, for any page size; a ``-1`` entry is
never scored and never written, and the appends land only through the
table. The port writes nothing to the sink (the TPU kernel parks
Pallas's mandatory block write-backs there; CUDA has no such flush).

``qk_quant='int8'`` scores against the cache's int8 K mirror ``k_q
(…, d) int8`` / ``k_scale (…, 1) float32`` (slab buffers, or pools
paged through the same table): q and ``k_new`` are quantized per row as
:func:`~.flash_attention.quantize_rows` does (inside the CUDA kernel,
bit for bit; by that function in the plain version), the scores
are ``float(int32 Σ q_i8·k_i8) · sq·scale·log2(e) · k_scale`` in that
order, and the mirror rows are appended in place beside the bf16 rows.
The reference keeps it single-token (``k == 1``).

``window=W`` is the sliding-window lookback of the training kernels: a
row attends only the columns ``c`` with ``c - valid_to > -W``. A row's
``valid_to`` may lie outside the cache: a shard of a sequence-sharded
slab passes the query's global position localised to its slab, which is
``>= t_max`` when the slab lies wholly in the query's past (every column
attended) and negative when it lies wholly in its future (none).

``alibi_slopes (H,)``: ALiBi, the training kernels' bias — query head
``h``'s score at column ``c`` of new row ``j`` gains ``slope_h · (c −
(valid_to + j))`` (≤ 0 on attended columns), slopes pre-folded by log2e
(the scores are in log2 units), after the appended rows' scores have
replaced the buffer's. Under ``partials`` a sharded slab's localised
``valid_to`` gives the same distances.

``partials=True`` returns, in place of the output, the flash-decoding
partials of every query row for the cross-shard merge: ``num (B, H, k,
d_v)`` float32, the un-normalised context, and ``m``/``l (B, H, k, 1)``
float32, the base-2 running max and denominator (a row with no attended
column gives ``num = 0``, ``m = _NEG_BIG``, ``l = 0``, as the reference
kernel initialises its running max).

On CUDA tensors it launches ``csrc/flash_decode.cu`` (one kernel a
call: split-K flash-decoding across a thread-block cluster per slot and
kv head, merged in the same launch; bf16, or float32 through the same
source built as a library of its own (``-DDECODE_F32``: exact float32
FFMA products over the real query rows, never a cast to bf16) — q, the
new rows and the caches all of one of the two dtypes, else
``TypeError``; any head
dim ``d`` and value width ``d_v`` from 1 to 256, read and appended in
place at their true widths; paged, any page size) or raises; on CPU
tensors it runs :func:`flash_decode_plain`.
"""

import ctypes
import functools
import math
import numbers

import torch

from distributed_dot_product_tpu_torch.obs import perf as _perf
from distributed_dot_product_tpu_torch.ops import _build
from distributed_dot_product_tpu_torch.ops.flash_attention import (
    _LOG2E, _MAX_HEAD_DIM, _NEG_BIG, _alibi_log2, quantize_rows,
)

__all__ = ['flash_decode', 'flash_decode_paged', 'flash_decode_plain',
           'gather_pages']

# Cache columns a cluster rank of the CUDA kernel owns at a time (kChunk
# in csrc/flash_decode.cu) unless a slab call gives block_k: the slab's
# default K split, which bounds verify-k.
_SPLIT = 128
# Blocks a (slot, kv head) cluster may hold: the portable cluster size.
_MAX_CLUSTER = 8
# Shared memory one block of the CUDA kernel may use (H100).
_SMEM_LIMIT = 232448


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


def _scores_plain(q, cache_k, scale, mirror=None):
    """Log2-unit scores ``(B, H_kv, group, t)`` of ``q (B, H, 1, d)``:
    the kernel's numerics. Float: q pre-scaled by ``scale*log2(e)`` and
    rounded to the cache dtype, float32 products. ``mirror = (k_q,
    k_scale)``: q quantized per row, the int8 products summed exactly
    (float32 sums of integers below 2^24), then ``(s · sq·scale·log2(e))
    · k_scale``."""
    b, h, _, d = q.shape
    h_kv = cache_k.shape[1]
    if mirror is None:
        qg = (q.float() * (scale * _LOG2E)).to(cache_k.dtype).float()
        return torch.matmul(qg.reshape(b, h_kv, h // h_kv, d),
                            cache_k.float().transpose(-1, -2))
    k_q, k_scale = mirror
    qi, sq = quantize_rows(q)
    qi = qi.float().reshape(b, h_kv, h // h_kv, d)
    sqf = (sq * (scale * _LOG2E)).reshape(b, h_kv, h // h_kv, 1)
    s = torch.matmul(qi, k_q.float().transpose(-1, -2))
    return s * sqf * k_scale.transpose(-1, -2)


def _head_slopes(alibi_slopes, h, device):
    """``(H,)`` float32 slopes, validated (the CUDA kernel folds them by
    log2e itself, the plain version with :func:`_alibi_log2`: the scores
    are in log2 units)."""
    slopes = torch.as_tensor(alibi_slopes, dtype=torch.float32,
                             device=device)
    if tuple(slopes.shape) != (h,):
        raise ValueError(f'alibi_slopes must be (H,) = ({h},), got '
                         f'{tuple(slopes.shape)}')
    return slopes.contiguous()


def _attend_plain(q, cache_k, cache_v, vt, scale, col_ok=None,
                  window=None, partials=False, mirror=None, alibi=None):
    """Masked attention of ``q (B, H, 1, d)`` over slab-layout caches,
    columns ``c <= vt[b]`` (within the window and ``col_ok``, when
    given): the kernel's numerics (:func:`_scores_plain`, ALiBi's
    ``slope₂·(c − vt)`` with ``alibi`` the ``(H,)`` folded slopes, exp2
    softmax, empty rows 0). ``partials``: ``(num, m, l)`` in float32
    instead of the output."""
    b, h, _, d = q.shape
    t_max = cache_k.shape[2]
    dv = cache_v.shape[-1]
    s = _scores_plain(q, cache_k, scale, mirror)                # (b,hkv,g,t)
    rel = (torch.arange(t_max, device=cache_k.device)[None, :]
           - vt[:, None])                                       # (b, t)
    if alibi is not None:
        s = s + (alibi.reshape(1, *s.shape[1:3], 1)
                 * rel[:, None, None, :].float())
    masked = rel > 0
    if window is not None:
        masked = masked | (rel <= -window)
    if col_ok is not None:
        masked = masked | ~col_ok
    s = s.masked_fill(masked[:, None, None, :], float('-inf'))
    m = s.amax(dim=-1, keepdim=True).clamp_min(_NEG_BIG)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    num = torch.matmul(p, cache_v.float())
    if partials:
        return (num.reshape(b, h, 1, dv), m.reshape(b, h, 1, 1),
                l.reshape(b, h, 1, 1))
    out = num / torch.where(l == 0.0, 1.0, l)
    return out.reshape(b, h, 1, dv).to(cache_v.dtype)


def _check_window(window):
    if window is not None and (isinstance(window, bool)
                               or not isinstance(window, int) or window < 1):
        raise ValueError(f'window must be a positive int, got {window!r}')


def _step_plain(q, k_new, v_new, cache_k, cache_v, vt, ap, scale,
                page_table, window, partials, mirror, alibi):
    """One new row per slot (``q (B, H, 1, d)``): the append at ``ap``
    (int64 ``(B,)``, ``-1`` none) in place, then the attention at
    ``vt``."""
    kni = kns = None
    if mirror is not None:
        kni, kns = quantize_rows(k_new.to(cache_k.dtype))
    if page_table is None:
        t_max = cache_k.shape[2]
        rows = torch.nonzero((ap >= 0) & (ap < t_max)).reshape(-1)
        cols = ap[rows]
        cache_k[rows, :, cols] = k_new[rows, :, 0].to(cache_k.dtype)
        cache_v[rows, :, cols] = v_new[rows, :, 0].to(cache_v.dtype)
        if mirror is not None:
            mirror[0][rows, :, cols] = kni[rows, :, 0]
            mirror[1][rows, :, cols] = kns[rows, :, 0]
        return _attend_plain(q, cache_k, cache_v, vt, scale, window=window,
                             partials=partials, mirror=mirror, alibi=alibi)
    ps = cache_k.shape[2]
    t_max = page_table.shape[1] * ps
    rows = torch.nonzero((ap >= 0) & (ap < t_max)).reshape(-1)
    pg = page_table[rows, ap[rows] // ps]
    rows, pg = rows[pg >= 0], pg[pg >= 0]
    rw = ap[rows] % ps
    cache_k[pg, :, rw] = k_new[rows, :, 0].to(cache_k.dtype)
    cache_v[pg, :, rw] = v_new[rows, :, 0].to(cache_v.dtype)
    gathered = None
    if mirror is not None:
        mirror[0][pg, :, rw] = kni[rows, :, 0]
        mirror[1][pg, :, rw] = kns[rows, :, 0]
        gathered = tuple(gather_pages(x, page_table) for x in mirror)
    col_ok = (page_table >= 0).repeat_interleave(ps, dim=1)
    return _attend_plain(q, gather_pages(cache_k, page_table),
                         gather_pages(cache_v, page_table), vt, scale,
                         col_ok, window=window, partials=partials,
                         mirror=gathered, alibi=alibi)


def _row_counts(n_new, ap, n, b, dev):
    """Rows each slot appends: ``n_new`` clipped to ``[0, n]`` (default
    ``n``), 0 where ``append_at < 0``."""
    nn = (torch.full((b,), n, dtype=torch.int32, device=dev)
          if n_new is None else _slot_vector(n_new, b, dev).clamp(0, n))
    return torch.where(ap >= 0, nn, 0).to(torch.int32).contiguous()


def _k_split(block_k, cache_k, page_table, n):
    """The K split of a call, checked with the reference's tests and
    messages: paged, the page size (``block_k`` may only repeat it); on a
    slab ``block_k`` (which must divide ``t_max``), or with none (or 0)
    the port's ``min(_SPLIT, t_max)``; ``n`` new rows must not exceed it.
    A negative divisor, which passes the reference's test and then fails
    in its grid, and a split that is no integer are refused with the same
    message. Returns ``(split, slab_block_k)``: ``slab_block_k`` is the
    slab's ``block_k`` as an int for the kernel, None where the kernel
    keeps its own split."""
    paged = page_table is not None
    given = None
    if paged:
        bk = cache_k.shape[2]
        if block_k not in (None, bk):
            raise ValueError(f'paged decode splits K at the page size '
                             f'{bk}; block_k={block_k} cannot differ')
    else:
        t_max = cache_k.shape[2]
        bk = block_k or min(_SPLIT, t_max)
        if block_k and (t_max % bk or not isinstance(bk, numbers.Integral)
                        or bk < 1):
            raise ValueError(
                f'no usable K split for t_max={t_max} (block_k must '
                f'divide it); use the plain decode path for this cache '
                f'shape')
        if block_k:
            bk = given = int(bk)
    if n > bk:
        raise ValueError(
            f'verify-k width {n} exceeds the K split {bk} '
            f'({"page size" if paged else "block"}) — k rows must span '
            f'at most two blocks; use the plain decode path for wider '
            f'verify steps')
    return bk, given


def flash_decode_plain(q, k_new, v_new, cache_k, cache_v, valid_to,
                       append_at, *, n_new=None, scale=None,
                       page_table=None, window=None, partials=False,
                       k_q=None, k_scale=None, qk_quant=None,
                       alibi_slopes=None, block_k=None):
    """The kernel's arithmetic in plain PyTorch (float32 scores); appends
    in place like the kernel. Verify-k runs as ``k`` sequential one-row
    steps — row ``j`` appends (when ``j < n_new``) at ``append_at + j``
    and attends at ``valid_to + j`` — so on the CPU a verify step is bit
    for bit the sequential steps. With ``page_table``: each append
    scatters through the table (nothing where ``append_at < 0`` or the
    entry is ``-1``), then the slab arithmetic runs on the gathered view
    with ``-1`` columns masked. ``qk_quant='int8'``: scores from the
    ``k_q``/``k_scale`` mirror, which is appended in place too.
    ``alibi_slopes (H,)``: ALiBi at ``valid_to + j``. ``block_k``: the
    K split, validated as :func:`flash_decode` does (when given); the
    arithmetic does not depend on it. Returns ``(out, cache_k,
    cache_v)``, or with ``partials`` ``((num, m, l), cache_k,
    cache_v)``."""
    _check_window(window)
    b, _, n, d = q.shape
    if block_k is not None:
        _k_split(block_k, cache_k, page_table, n)
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    dev = cache_k.device
    vt = _slot_vector(valid_to, b, dev).long()
    ap = _slot_vector(append_at, b, dev).long()
    nn = _row_counts(n_new, ap, n, b, dev).long()
    mirror = (k_q, k_scale) if qk_quant == 'int8' else None
    alibi = (None if alibi_slopes is None
             else _alibi_log2(_head_slopes(alibi_slopes, q.shape[1], dev)))
    pt = None if page_table is None else page_table.to(dev).long()
    rows = []
    for j in range(n):
        apj = torch.where(j < nn, ap + j, -1)
        rows.append(_step_plain(
            q[:, :, j:j + 1], k_new[:, :, j:j + 1], v_new[:, :, j:j + 1],
            cache_k, cache_v, vt + j, apj, scale, pt, window, partials,
            mirror, alibi))
    if partials:
        res = tuple(torch.cat(part, dim=2) for part in zip(*rows))
    else:
        res = torch.cat(rows, dim=2)
    return res, cache_k, cache_v


def _kernel_lib(f32):
    """``(library, slab step, paged step)``: the float32 kernels'
    (``flash_decode_f32``) or the bf16 ones'."""
    lib = _build.load('flash_decode_f32' if f32 else 'flash_decode')
    suffix = 'f32' if f32 else 'bf16'
    slab = getattr(lib, f'flash_decode_{suffix}')
    paged = getattr(lib, f'flash_decode_paged_{suffix}')
    if slab.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        slab.argtypes = [vp] * 15 + [i] * 10 + [ctypes.c_float, vp]
        paged.argtypes = [vp] * 16 + [i] * 10 + [ctypes.c_float, vp]
        for fn in (slab, paged):
            fn.restype = ctypes.c_int
        lib.flash_decode_chunk.argtypes = []
        lib.flash_decode_chunk.restype = ctypes.c_int
        lib.flash_decode_smem.argtypes = [i] * 8
        lib.flash_decode_smem.restype = ctypes.c_int
    return lib, slab, paged


def _launch_geometry(batch, h_kv, t_max, sm_count):
    """``(cluster, grid)`` of a launch: a cluster of ``cluster`` blocks
    per (slot, kv head), ``grid = (cluster, batch * h_kv)``. Rank ``r``
    of a cluster owns the ``_SPLIT``-column chunks ``c`` with ``c %
    cluster == r`` (``csrc/flash_decode.cu``, ``owned_from``). The
    cluster is a power of two: as large as keeps the launch within about
    two blocks an SM (one wave), at most 8 blocks (the portable cluster
    size), and no larger than the first power of two that covers the
    chunks. It depends on these arguments alone: never on the
    query rows, ``valid_to``, ``append_at`` or the page table, so every
    column of a slot is reduced by the same rank in the same order
    whatever the launch attends."""
    chunks = max(-(-t_max // _SPLIT), 1)
    fit = min(_MAX_CLUSTER, max(2 * sm_count // max(batch * h_kv, 1), 1))
    cluster = 1
    while 2 * cluster <= fit and cluster < chunks:
        cluster *= 2
    return cluster, (cluster, batch * h_kv)


def _chunk_cluster(cluster, t_max, chunk):
    """The cluster of a slab launch split at ``chunk`` columns (block_k):
    :func:`_launch_geometry`'s, halved while half of it still covers the
    chunks (a rank past the last chunk would walk nothing)."""
    chunks = max(-(-t_max // chunk), 1)
    while cluster > 1 and cluster // 2 >= chunks:
        cluster //= 2
    return cluster


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(q, k_new, v_new, cache_k, cache_v, valid_to, append_at, n_new,
            scale, page_table=None, window=None, partials=False,
            mirror=None, alibi_slopes=None, block_k=None):
    """One launch of the CUDA kernel. Nothing is read back to the host and
    no other kernel runs: int8 quantizes q and ``k_new`` in the kernel,
    and ALiBi folds its slopes there. ``block_k``: the slab's K split
    (None: the kernel's own)."""
    b, h, n, d = q.shape
    dv = cache_v.shape[-1]
    h_kv = cache_k.shape[1]
    dev = cache_k.device
    for name, t in (('q', q), ('k_new', k_new), ('v_new', v_new),
                    ('cache_k', cache_k), ('cache_v', cache_v)):
        if t.dtype not in (torch.bfloat16, torch.float32) \
                or t.dtype != cache_k.dtype:
            raise TypeError(
                f'the CUDA decode kernel takes bf16 or float32 operands, all '
                f'of one dtype; {name} is {t.dtype}, cache_k '
                f'{cache_k.dtype}')
        if t.device != dev:
            raise ValueError(f'{name} is on {t.device}, the cache on {dev}')
    if not (1 <= d <= _MAX_HEAD_DIM and 1 <= dv <= _MAX_HEAD_DIM):
        raise NotImplementedError(
            f'the CUDA decode kernel takes head dims and value widths up '
            f'to {_MAX_HEAD_DIM}; got q {tuple(q.shape)}, cache_v '
            f'{tuple(cache_v.shape)}')
    if not (cache_k.is_contiguous() and cache_v.is_contiguous()):
        raise ValueError('the cache is appended in place and must be '
                         'contiguous')
    q, k_new, v_new = q.contiguous(), k_new.contiguous(), v_new.contiguous()
    vt = _slot_vector(valid_to, b, dev)
    ap = _slot_vector(append_at, b, dev)
    f32 = cache_k.dtype == torch.float32
    lib, slab_fn, paged_fn = _kernel_lib(f32)
    chunk = lib.flash_decode_chunk()
    if chunk != _SPLIT:
        raise RuntimeError(f'csrc/flash_decode.cu splits at {chunk} '
                           f'columns, ops/flash_decode.py at {_SPLIT}')
    ps = 0
    if page_table is None:
        t_max = cache_k.shape[2]
    else:
        ps = cache_k.shape[2]
        if page_table.dtype != torch.int32 or page_table.device != dev \
                or not page_table.is_contiguous() \
                or page_table.shape[0] != b:
            raise ValueError(
                f'page_table must be a contiguous ({b}, pages_per_slot) '
                f'int32 tensor on {dev}; got {page_table.dtype} '
                f'{tuple(page_table.shape)} on {page_table.device}')
        t_max = page_table.shape[1] * ps
    if b * h_kv > 65535:
        raise ValueError(f'{b} slots x {h_kv} kv heads exceed the grid\'s '
                         f'65535 rows')
    if cache_k.numel() // d >= 2 ** 31:
        raise ValueError(f'the cache holds {cache_k.numel() // d} rows; the '
                         f'kernel indexes fewer than 2^31')
    quant = (None, None)
    if mirror is not None:
        k_q, k_scale = mirror
        want = cache_k.shape[:-1]
        if k_q.dtype != torch.int8 or k_scale.dtype != torch.float32 \
                or k_q.shape != cache_k.shape \
                or tuple(k_scale.shape) != (*want, 1) \
                or not (k_q.is_contiguous() and k_scale.is_contiguous()) \
                or k_q.device != dev or k_scale.device != dev:
            raise ValueError(
                f'the int8 mirror must be contiguous int8 {tuple(want)} '
                f'x {d} and float32 x 1 tensors on {dev}; got {k_q.dtype} '
                f'{tuple(k_q.shape)}, {k_scale.dtype} '
                f'{tuple(k_scale.shape)}')
        quant = (k_q.data_ptr(), k_scale.data_ptr())
    alibi = (None if alibi_slopes is None
             else _head_slopes(alibi_slopes, h, dev))
    if partials:
        res = (torch.empty((b, h, n, dv), dtype=torch.float32, device=dev),
               torch.empty((b, h, n, 1), dtype=torch.float32, device=dev),
               torch.empty((b, h, n, 1), dtype=torch.float32, device=dev))
        outs = (None, *(t.data_ptr() for t in res))
    else:
        res = torch.empty((b, h, n, dv), dtype=cache_v.dtype, device=dev)
        outs = (res.data_ptr(), None, None, None)
    for t in (q, k_new, v_new, cache_k, cache_v, *(mirror or ())):
        if t.data_ptr() % 16:
            raise ValueError('the CUDA decode kernel needs 16-byte aligned '
                             'tensors')
    sms = _sm_count(dev.index)
    cluster, _ = _launch_geometry(b, h_kv, t_max, sms)
    split = block_k or 0
    if split:
        cluster = _chunk_cluster(cluster, t_max, split)

    smem = lib.flash_decode_smem(n * (h // h_kv), n, d, dv,
                                 mirror is not None, t_max, ps, cluster)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f'{n} new rows x {h // h_kv} query heads per kv head need '
            f'{smem} bytes of shared memory per block, over the card\'s '
            f'{_SMEM_LIMIT}')
    # n_new is clipped in the kernel (null: n rows wherever append_at >=
    # 0), so a launch adds no kernel of its own around it.
    nn = None if n_new is None else _slot_vector(n_new, b, dev)
    ptrs = (q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            cache_k.data_ptr(), cache_v.data_ptr(), vt.data_ptr(),
            ap.data_ptr(), None if nn is None else nn.data_ptr())
    rest = (*quant, None if alibi is None else alibi.data_ptr(), *outs)
    stream = torch.cuda.current_stream(dev).cuda_stream
    win = 0 if window is None else window
    with torch.cuda.device(dev):
        if page_table is None:
            err = slab_fn(*ptrs, *rest, b, h, h_kv, n, t_max, d, dv, win,
                          cluster, split, scale * _LOG2E, stream)
        else:
            err = paged_fn(*ptrs, page_table.data_ptr(), *rest, b, h, h_kv,
                           n, page_table.shape[1], ps, d, dv, win, cluster,
                           scale * _LOG2E, stream)
    if err:
        raise RuntimeError(f'flash_decode kernel launch failed: CUDA error '
                           f'{err}')
    counter = flash_decode if page_table is None else flash_decode_paged
    counter.launches += 1
    counter.f32_launches += f32
    counter.verify_launches += n > 1
    counter.int8_launches += mirror is not None
    counter.alibi_launches += alibi is not None
    return res, cache_k, cache_v


def _decode_work(q, cache_k, valid_to, append_at, n_new, page_table,
                 window, partials, quantized):
    """The keyword arguments of ``obs/perf.py``'s decode cost formula for
    one K5 / K5p call (read only while a cost count runs): per slot, the
    columns each query row attends, the cached rows read (distinct pool
    rows when paged: a shared prefix once) and the rows appended."""
    b, h, n, d = q.shape
    h_kv = cache_k.shape[1]
    vt = [int(x) for x in valid_to.tolist()]
    ap = [int(x) for x in append_at.tolist()]
    nn = ([int(x) for x in n_new.tolist()] if n_new is not None
          else [n if a >= 0 else 0 for a in ap])
    if page_table is not None:
        table = page_table.tolist()
        ps = cache_k.shape[2]
        t = len(table[0]) * ps
    else:
        t = cache_k.shape[2]
    cols, read = 0, set()
    for i in range(b):
        if vt[i] < 0:
            continue
        for j in range(n):
            hi = min(vt[i] + j + 1, t)
            lo = max(0, vt[i] + j - window + 1) if window else 0
            cols += max(0, hi - lo)
        lo = max(0, vt[i] - window + 1) if window else 0
        for c in range(lo, min(vt[i], t)):
            if page_table is None:
                read.add((i, c))
            elif table[i][c // ps] >= 0:
                read.add((table[i][c // ps], c % ps))
    appended = sum(c for c, a in zip(nn, ap) if a >= 0)
    return dict(d=d, q_rows=b * h * n, new_rows=b * h_kv * n,
                rows_read=len(read) * h_kv, rows_appended=appended * h_kv,
                cols=cols * h, k_row_bytes=d + 4 if quantized else None,
                out_row_bytes=(d + 2) * 4 if partials else None,
                table_entries=(0 if page_table is None
                               else page_table.numel()))


def flash_decode(q, k_new, v_new, cache_k, cache_v, valid_to, append_at, *,
                 n_new=None, page_table=None, k_q=None, k_scale=None,
                 scale=None, window=None, alibi_slopes=None, qk_quant=None,
                 interpret=None, partials=False, block_k=None):
    """One fused decode step (see the module docstring). Returns
    ``(out (B, H, k, d_v) in cache_v.dtype, cache_k, cache_v)`` — with
    ``partials`` ``((num, m, l), cache_k, cache_v)``; the cache tensors
    (slabs, or pools with ``page_table``) are the ones passed in,
    appended in place, as is the int8 mirror (``k_q``/``k_scale``).

    ``interpret`` mirrors the reference knob: the plain version runs only
    for CPU tensors, so ``interpret=True`` with CUDA tensors raises."""
    _check_window(window)
    b, h, n, d = q.shape
    h_kv = cache_k.shape[1]
    paged = page_table is not None
    if n < 1:
        raise ValueError(f'flash_decode needs at least one query row, '
                         f'got {n}')
    if h % h_kv:
        raise ValueError(f'query heads {h} must be a multiple of cache kv '
                         f'heads {h_kv}')
    quantized = qk_quant == 'int8'
    if qk_quant not in (None, 'int8'):
        raise ValueError(f"qk_quant must be None or 'int8', "
                         f'got {qk_quant!r}')
    if quantized and n != 1:
        raise ValueError(
            f"qk_quant='int8' is single-token in the fused kernel "
            f'(got {n} rows) — the plain decode path covers quantized '
            f'verify-k')
    if quantized and (k_q is None or k_scale is None):
        raise ValueError(
            "qk_quant='int8' needs the cache's k_q/k_scale mirror — "
            "init_cache(qk_quant='int8') for the slab buffers, "
            "init_paged_cache(qk_quant='int8') for the mirror pools")
    if tuple(k_new.shape) != (b, h_kv, n, d) or tuple(v_new.shape) != (
            b, h_kv, n, cache_v.shape[-1]):
        raise ValueError(f'k_new/v_new must be (B, H_kv, {n}, d); got '
                         f'{tuple(k_new.shape)}, {tuple(v_new.shape)}')
    if paged and page_table.shape[0] != b:
        raise ValueError(f'page_table has {page_table.shape[0]} rows for '
                         f'batch {b}')
    if paged and cache_k.shape[2] < 1:
        raise ValueError(f'a page holds at least one row; the pool is '
                         f'{tuple(cache_k.shape)}')
    _, block_k = _k_split(block_k, cache_k, page_table, n)
    scale = float(1.0 / math.sqrt(d) if scale is None else scale)
    mirror = (k_q, k_scale) if quantized else None
    if cache_k.is_cuda and interpret:
        raise ValueError('interpret=True runs the plain version, which '
                         'the port keeps for CPU tensors only')
    if not cache_k.is_cuda and interpret is False:
        raise ValueError('interpret=False needs CUDA tensors: the kernel '
                         'runs only on the card')
    with _perf.kernel_work(
            'flash_decode' if page_table is None else 'flash_decode_paged',
            lambda: _decode_work(q, cache_k, valid_to, append_at, n_new,
                                 page_table, window, partials, quantized)):
        if cache_k.is_cuda:
            return _launch(q, k_new, v_new, cache_k, cache_v, valid_to,
                           append_at, n_new, scale, page_table=page_table,
                           window=window, partials=partials, mirror=mirror,
                           alibi_slopes=alibi_slopes, block_k=block_k)
        return flash_decode_plain(
            q, k_new, v_new, cache_k, cache_v, valid_to, append_at,
            n_new=n_new, scale=scale, page_table=page_table, window=window,
            partials=partials, k_q=k_q, k_scale=k_scale, qk_quant=qk_quant,
            alibi_slopes=alibi_slopes)


def flash_decode_paged(q, k_new, v_new, k_pool, v_pool, valid_to, append_at,
                       page_table, **kw):
    """The paged step (K5p): ``flash_decode(..., page_table=page_table)``,
    named so its launch counter sits beside K5's."""
    return flash_decode(q, k_new, v_new, k_pool, v_pool, valid_to,
                        append_at, page_table=page_table, **kw)


# Launches of the CUDA kernel pairs, slab (K5) and paged (K5p), each
# counted where it is launched and nowhere else: all of them, and among
# them the float32 kernel's, the verify-k (n > 1), the int8-mirror and the
# ALiBi launches.
for _fn in (flash_decode, flash_decode_paged):
    _fn.launches = _fn.verify_launches = _fn.int8_launches = 0
    _fn.alibi_launches = _fn.f32_launches = 0
del _fn
