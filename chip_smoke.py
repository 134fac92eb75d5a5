#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""
Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, one JSON line each (some several):

1. device: the card, torch and CUDA versions;
2. build: compiles every kernel source in ``csrc/``, one ``nvcc`` each,
   all started together;
3. flash_attention: K1 (flash-attention forward) against its plain
   PyTorch version at the prefill shape, at ragged shapes with a causal
   offset (one with GQA) and at a ragged shape without causal masking,
   in bf16;
4. flash_decode: K5 (fused decode step) against its plain version at the
   decode shape with mixed per-row fill: the appended cache must equal
   the plain append bit for bit, the output must agree within tolerance;
5. flash_decode_paged: K5p (the paged decode step) against its plain
   version at the serving shape (8 slots, 8 heads, head dim 96, page
   16, t_max 4096, 2048 pages) with a scrambled table and mixed fill:
   the pool must equal the plain append bit for bit on every page but
   the sink, the output must agree within tolerance and equal K5's on
   the same rows gathered into a slab, bit for bit;
6. serve_path: a seeded burst of 24 requests (prompts of 1..2048 tokens)
   through the continuous-batching Scheduler over the paged KernelEngine
   (slots 8, t_max 4096, the TransformerLM's widths, bf16, prefill chunk
   64; ServeConfig(queue_limit 64, max_new_tokens 256)): terminal states,
   tokens/s, TTFT and step latency, K5p launches against decode steps;
   the same burst over the slab engine (K5) must give the same streams;
   then requests 0 and 1 on a float32 CPU engine with the same weights;
7. main_path (serving): greedy generation of the full-width TransformerLM
   (vocab 32768, dim 768, 8 heads, 16 layers, bf16 parameters and
   compute, seeded random weights) for 4 prompts of 1000 tokens, 64
   steps, t_max 2048, with the kernel launch counts of that run, then
   prompt 0 against the same weights run on the CPU in float32 (plain
   versions);
8. flash_backward: K1's LSE output, K3 (dq) and K4 (dk, dv) against
   their plain versions in bf16 at the training shape (4 x 8 heads,
   T 4096, head dim 96, causal), a ragged causal GQA 8:2 self-attention
   at T 333, Tq 77 over Tk 1077 at causal offset 1000, and a non-causal
   50 x 300; timings at the training shape;
9. train_path: five Adam steps (lr 3e-4) of the same model with float32
   parameters, bf16 compute and remat, on one batch of 4 x 4096 seeded
   random tokens (loss_chunk 4096): losses, ms per step, tokens/s, peak
   memory and each step's K1 / K3 / K4 launches;
10. train_cpu_reference: one step's loss and every parameter's gradient
   of a 2-layer model at full width (B 1 x T 512), the card (bf16 compute
   through the kernels) against the same float32 weights on the CPU
   (float32, plain versions).

Then the card's ``nvidia-smi`` name and power limit, the kernels line
(``{"kernels": [...]}``: K1, K3, K4, K5 and K5p with their launches on
their path, max error, kernel / plain / library / bound times) and, only if
every phase passed, the last line ``{"ok": true, "device": {...}}``.
Exits non-zero on any failure, and without a card.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core rate
PEAK_HBM_BYTES = 3.35e12      # H100 SXM HBM3 bandwidth

VOCAB, DIM, HEADS, LAYERS = 32768, 768, 8, 16
BATCH, PROMPT, STEPS, T_MAX = 4, 1000, 64, 2048
HEAD_DIM = DIM // HEADS
# The training configuration: the README's model and Adam learning rate.
TRAIN_B, TRAIN_T, TRAIN_STEPS, LOSS_CHUNK, LR = 4, 4096, 5, 4096, 3e-4
REF_LAYERS, REF_T = 2, 512
# The serving configuration (README "Resilient serving"): KernelEngine(slots
# 8, t_max 4096) at the TransformerLM's widths, paged, page size 16, the
# default pool of slots * t_max / page_size pages, prefill chunk 64, and
# ServeConfig(queue_limit 64, max_new_tokens 256); a seeded burst of 24
# requests with prompt lengths uniform in 1..2048.
SERVE_SLOTS, SERVE_T_MAX, SERVE_PAGE, SERVE_CHUNK = 8, 4096, 16, 64
SERVE_PAGES = SERVE_SLOTS * SERVE_T_MAX // SERVE_PAGE
SERVE_REQUESTS, SERVE_PROMPT, SERVE_QUEUE, SERVE_NEW = 24, 2048, 64, 256
SERVE_SEED = 0

# K5 vs its plain version, absolute: both round the output to bf16, a
# relative 2^-8 at most; with unit-normal values (|v| < ~5) that stays
# under 2e-2.
TOL_BF16 = 2e-2
# Greedy logits of the bf16 model vs the same weights in float32 on the
# CPU, max |Δ| over max |logit| at prompt 0's last position.
TOL_LM_REL = 0.1
# K1's row logsumexp vs its plain version, absolute (natural-log units):
# both sum the same float32 exp2 terms of float32 scores that differ only
# by accumulation order, so |Δ| stays at float32 rounding of lse values
# of magnitude ~10 (~1e-6); 1e-3 leaves room for the card's exp2f/log2f
# (2 ulp) and a different summation order over thousands of terms.
TOL_LSE = 1e-3
# K1's output and K3 / K4's gradients vs their plain versions, held on
# each row's own scale: a row (a query row of out and dq, a key row of dk
# and dv) is compared as ||kernel_r - plain_r|| / ||plain_r||, so a row
# that attends 4000 keys, whose values are ~100x smaller than a first
# row's, is held as tightly as that first row. Two readings per tensor:
# the largest such row error (catches a fault confined to a few rows,
# such as a dropped tile) and ||kernel - plain|| / ||plain|| over the
# whole tensor (catches a small error in every row, such as lost
# accumulator precision). Both versions round p and ds to bf16 before
# the same products and round the result to bf16 (2^-9 relative), so a
# sound kernel differs by float32 accumulation order, single bf16 flips
# and, under GQA, the plain version's per-head bf16 partials; K1's out
# also by its bf16 softmax weights against the plain version's float32
# ones. Each limit sits between the sound kernels' readings and those of
# the same kernels with a planted fault (scripts/torch_planted_faults.py:
# one diagonal tile dropped past tile 32, or an accumulator rounded to
# bf16 after every tile). On an H100 the sound kernels read at most
# ~5.5e-3 on a row and ~2.8e-3 whole (dk under GQA 4:1); every planted
# fault reads above 1.5e-2 on a row or 4.2e-3 whole in some case.
# PERF.md lists the readings.
TOL_ROW_REL = 1e-2
TOL_NORM_REL = 4e-3
# One training step of the 2-layer model, bf16 compute on the card vs
# float32 on the CPU from the same float32 weights. Loss: a mean of 512
# per-token losses of magnitude ~10 whose bf16 rounding errors (2^-9
# relative per rounded activation) are independent and average out, so
# the mean moves by ~1e-4 at most: bound 1e-3. Gradients, per tensor
# ||g_card - g_cpu|| / ||g_cpu||: each bf16 rounding of an activation on
# the forward and backward chains adds ~2^-9 relative error, some twenty
# in series through a block; the attention projections' gradients go
# through ds = p * (dp - delta), a difference of nearly equal terms at
# near-uniform attention, which magnifies that error several-fold (to
# ~2e-2); bound 5e-2.
TOL_REF_LOSS_REL = 1e-3
TOL_REF_GRAD_REL = 5e-2
TRAIN_KERNELS = ('flash_attention', 'flash_attention_dq',
                 'flash_attention_dkv')


def emit(obj):
    print(json.dumps(obj), flush=True)


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def time_ms(torch, fn, flush, reps=30):
    """Median device time of ``fn`` over ``reps`` launches, CUDA events
    around each, L2 flushed before each (the main path finds the cache
    cold: 15 other layers' K/V pass through L2 between two calls). A
    ~1 ms device-side spin after the flush keeps the card busy while the
    host runs the wrapper's Python, so the events time the kernels and
    not the host's enqueue."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_errs(torch, got, want):
    """``(largest row error, whole-tensor error)`` of ``got`` against
    ``want`` (rows along the last axis), in float32: the row error is
    ``||got_r - want_r|| / max(||want_r||, floor)``, the whole-tensor
    error the same over every element. ``floor`` is a hundredth of the
    root-mean-square row norm: a row that is zero in exact arithmetic
    (causal query row 0's dq, where the one weight is 1 and
    ``ds = dO.v - rowsum(dO*O)`` cancels; keys no query sees) holds only
    the kernel's float32 rounding, which must stay small on the tensor's
    own scale."""
    diff = (got.float() - want.float()).flatten(0, -2)
    ref = want.float().flatten(0, -2)
    vnorm = torch.linalg.vector_norm
    ref_rows = vnorm(ref, dim=-1)
    floor = 1e-2 * ref_rows.square().mean().sqrt().clamp_min(1e-30)
    rows = vnorm(diff, dim=-1) / torch.maximum(ref_rows, floor)
    whole = vnorm(diff) / vnorm(ref).clamp_min(1e-30)
    return rows.max().item(), whole.item()


def check_rel(errs, what):
    """Failure messages for ``errs = {tensor: (row, whole)}`` (NaN
    fails)."""
    out = []
    for n, (row, whole) in errs.items():
        if not row <= TOL_ROW_REL:
            out.append(f'{what} {n}: row rel err {row} > {TOL_ROW_REL}')
        if not whole <= TOL_NORM_REL:
            out.append(f'{what} {n}: rel err {whole} > {TOL_NORM_REL}')
    return out


def bound_ms(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ('operations' if t_ops > t_bytes
                                       else 'bytes')


def randn(torch, shape, gen, dev, dtype):
    return torch.randn(shape, generator=gen).to(device=dev, dtype=dtype)


def phase_flash(torch, ddp, flush, gen):
    from distributed_dot_product_tpu_torch.ops.flash_attention import (
        flash_attention_plain,
    )
    F = torch.nn.functional
    dev, bf16 = torch.device('cuda'), torch.bfloat16
    scale = 1.0 / math.sqrt(HEAD_DIM)
    results, worst, worst_rel = {}, 0.0, 0.0
    # (name, q heads, kv heads, Tq, Tk, filled rows, causal offset or
    # None for no causal mask)
    cases = [('prefill', HEADS, HEADS, PROMPT, T_MAX, PROMPT, 0),
             ('ragged_offset', HEADS, HEADS, 77, T_MAX, 1077, 1000),
             ('gqa_ragged', HEADS, 2, 333, T_MAX, 700, 367),
             ('full_ragged', HEADS, HEADS, 50, 300, 300, None)]
    for name, hq, hkv, tq, tk, filled, off in cases:
        causal = off is not None
        off = off or 0
        q = randn(torch, (BATCH, hq, tq, HEAD_DIM), gen, dev, bf16)
        k = torch.zeros((BATCH, hkv, tk, HEAD_DIM), dtype=bf16, device=dev)
        v = torch.zeros_like(k)
        k[:, :, :filled] = randn(torch, (BATCH, hkv, filled, HEAD_DIM), gen,
                                 dev, bf16)
        v[:, :, :filled] = randn(torch, (BATCH, hkv, filled, HEAD_DIM), gen,
                                 dev, bf16)
        out = ddp.flash_attention(q, k, v, causal=causal,
                                  causal_offset=off, scale=scale)
        ref = flash_attention_plain(q, k, v, causal=causal,
                                    causal_offset=off, scale=scale)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        row_rel, rel = rel_errs(torch, out, ref)
        row = {'phase': 'flash_attention', 'case': name,
               'q': list(q.shape), 'kv': list(k.shape), 'causal': causal,
               'causal_offset': off, 'max_abs_err': err,
               'max_row_rel_err': row_rel, 'rel_err': rel,
               'tol': {'row_rel': TOL_ROW_REL, 'rel': TOL_NORM_REL}}
        check(torch.isfinite(out).all().item(), f'K1 {name}: non-finite')
        fails = check_rel({'out': (row_rel, rel)}, f'K1 {name}')
        check(not fails, '; '.join(fails))
        # Bound and library call over the key columns this run needs.
        nb = BATCH * hq
        if causal:
            pairs = sum(min(tk, off + i + 1) for i in range(tq))
            kv_rows = min(tk, off + tq)
        else:
            pairs, kv_rows = tq * tk, tk
        flops = 4 * HEAD_DIM * pairs * nb
        nbytes = 2 * HEAD_DIM * (2 * nb * tq + 2 * BATCH * hkv * kv_rows)
        bms, by = bound_ms(flops, nbytes)
        kf, vf = k[:, :, :kv_rows], v[:, :, :kv_rows]
        lib_kw = {'scale': scale, 'enable_gqa': hq != hkv}
        if causal and (off or tq != kv_rows):
            rows = off + torch.arange(tq, device=dev)
            lib_kw['attn_mask'] = (torch.arange(kv_rows, device=dev)[None, :]
                                   <= rows[:, None])
        else:
            lib_kw['is_causal'] = causal
        row.update(
            ms=time_ms(torch, lambda: ddp.flash_attention(
                q, k, v, causal=causal, causal_offset=off, scale=scale),
                flush),
            plain_ms=time_ms(torch, lambda: flash_attention_plain(
                q, k, v, causal=causal, causal_offset=off, scale=scale),
                flush, reps=10),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, kf, vf, **lib_kw), flush),
            bound_ms=bms, bound_by=by, flops=flops, bytes=nbytes)
        if name == 'prefill':
            results = row
        worst = max(worst, err)
        worst_rel = max(worst_rel, row_rel)
        emit(row)
    results.update(max_abs_err=worst, max_row_rel_err=worst_rel)
    return results


def phase_decode(torch, ddp, flush, gen):
    from distributed_dot_product_tpu_torch.ops.flash_decode import (
        flash_decode_plain,
    )
    F = torch.nn.functional
    dev, bf16 = torch.device('cuda'), torch.bfloat16
    scale = 1.0 / math.sqrt(HEAD_DIM)
    shape_q = (BATCH, HEADS, 1, HEAD_DIM)

    def make(valid_to, append_at):
        q = randn(torch, shape_q, gen, dev, bf16)
        kn = randn(torch, shape_q, gen, dev, bf16)
        vn = randn(torch, shape_q, gen, dev, bf16)
        # Filled rows unit-normal; past the fill, large garbage the mask
        # must keep out of every score.
        ck = 30.0 * randn(torch, (BATCH, HEADS, T_MAX, HEAD_DIM), gen, dev,
                          bf16)
        cv = 30.0 * randn(torch, (BATCH, HEADS, T_MAX, HEAD_DIM), gen, dev,
                          bf16)
        for b, (vt, ap) in enumerate(zip(valid_to, append_at)):
            n = max(vt if ap == vt else vt + 1, 0)   # the append fills vt
            ck[b, :, :n] = randn(torch, (HEADS, n, HEAD_DIM), gen, dev, bf16)
            cv[b, :, :n] = randn(torch, (HEADS, n, HEAD_DIM), gen, dev, bf16)
        vt = torch.tensor(valid_to, dtype=torch.int32, device=dev)
        ap = torch.tensor(append_at, dtype=torch.int32, device=dev)
        return q, kn, vn, ck, cv, vt, ap

    # Mixed fill: two mid-generation rows, a first token on an empty
    # cache, and a frozen row that appends nothing.
    q, kn, vn, ck, cv, vt, ap = make([999, 1062, 0, 516], [999, 1062, 0, -1])
    ck2, cv2 = ck.clone(), cv.clone()
    out, _, _ = ddp.flash_decode(q, kn, vn, ck, cv, vt, ap, scale=scale)
    ref, _, _ = flash_decode_plain(q, kn, vn, ck2, cv2, vt, ap, scale=scale)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    same = bool(torch.equal(ck, ck2) and torch.equal(cv, cv2))
    row = {'phase': 'flash_decode', 'case': 'mixed_fill',
           'valid_to': vt.tolist(), 'append_at': ap.tolist(),
           'max_abs_err': err, 'tol': TOL_BF16,
           'cache_bit_identical': same}
    emit(row)
    check(torch.isfinite(out).all().item(), 'K5: non-finite output')
    check(err <= TOL_BF16, f'K5: max abs err {err} > {TOL_BF16}')
    check(same, 'K5: appended cache differs from the plain append')

    # Timing at the main path's shape: every row mid-generation.
    fill = PROMPT + STEPS // 2
    q, kn, vn, ck, cv, vt, ap = make([fill] * BATCH, [fill] * BATCH)
    cols = fill + 1
    flops = 4 * HEAD_DIM * cols * BATCH * HEADS
    nbytes = 2 * HEAD_DIM * BATCH * HEADS * (
        2 * (cols - 1)      # cached K and V rows read
        + 2 + 2 + 2)        # q and out; k_new/v_new read; row written
    bms, by = bound_ms(flops, nbytes)
    mask = (torch.arange(T_MAX, device=dev)[None, :] <= vt[:, None].long())
    mask = mask[:, None, None, :]
    ck2, cv2 = ck.clone(), cv.clone()
    out, _, _ = ddp.flash_decode(q, kn, vn, ck, cv, vt, ap, scale=scale)
    ref, _, _ = flash_decode_plain(q, kn, vn, ck2, cv2, vt, ap, scale=scale)
    torch.cuda.synchronize()
    err2 = (out.float() - ref.float()).abs().max().item()
    check(err2 <= TOL_BF16, f'K5 uniform fill: max abs err {err2}')
    check(torch.equal(ck, ck2) and torch.equal(cv, cv2),
          'K5 uniform fill: appended cache differs from the plain append')
    row = {'phase': 'flash_decode', 'case': 'main_shape', 'fill': fill,
           'max_abs_err': max(err, err2), 'tol': TOL_BF16,
           'ms': time_ms(torch, lambda: ddp.flash_decode(
               q, kn, vn, ck, cv, vt, ap, scale=scale), flush),
           'plain_ms': time_ms(torch, lambda: flash_decode_plain(
               q, kn, vn, ck2, cv2, vt, ap, scale=scale), flush),
           'library_ms': time_ms(torch, lambda: F.scaled_dot_product_attention(
               q, ck, cv, attn_mask=mask, scale=scale), flush),
           'bound_ms': bms, 'bound_by': by, 'flops': flops, 'bytes': nbytes}
    emit(row)
    return row


def paged_case(torch, gen, dev):
    """The serving shape's paged cache with mixed fill and a scrambled
    table: (q, k_new, v_new, k_pool, v_pool, valid_to, append_at, table,
    the sets of distinct pool rows each slot reads). Slots: mid-generation,
    empty (table row all -1, valid_to -1), frozen (append_at -1), appending
    on a page boundary, two sharing a 640-row prefix (40 pages), a long
    and a short one. Unallocated pages and the sink hold large garbage."""
    bf16, ps, pps = torch.bfloat16, SERVE_PAGE, SERVE_T_MAX // SERVE_PAGE
    fills = [1500, 0, 778, 2048, 700, 1000, 4000, 5]   # rows before the step
    active = [True, False, False, True, True, True, True, True]
    valid_to = [f if a else f - 1 for f, a in zip(fills, active)]
    append_at = [f if a else -1 for f, a in zip(fills, active)]
    perm = torch.randperm(SERVE_PAGES, generator=gen).tolist()
    table = torch.full((SERVE_SLOTS, pps), -1, dtype=torch.int32)
    shared = perm[:40]
    nxt = 40
    for b, (f, a) in enumerate(zip(fills, active)):
        n = -(-(f + (1 if a else 0)) // ps)
        own = shared[:n] if b in (4, 5) else []
        need = n - len(own)
        table[b, :n] = torch.tensor(own + perm[nxt:nxt + need],
                                    dtype=torch.int32)
        nxt += need
    shape = (SERVE_PAGES + 1, HEADS, ps, HEAD_DIM)
    k_pool = 30.0 * randn(torch, shape, gen, dev, bf16)
    v_pool = 30.0 * randn(torch, shape, gen, dev, bf16)
    rows = [{(int(table[b, c // ps]), c % ps) for c in range(f)}
            for b, f in enumerate(fills)]
    filled = sorted(set().union(*rows))
    pg, r = (torch.tensor(x, device=dev) for x in zip(*filled))
    unit = (len(filled), HEADS, HEAD_DIM)
    k_pool[pg, :, r] = randn(torch, unit, gen, dev, bf16)
    v_pool[pg, :, r] = randn(torch, unit, gen, dev, bf16)
    shape_q = (SERVE_SLOTS, HEADS, 1, HEAD_DIM)
    q, kn, vn = (randn(torch, shape_q, gen, dev, bf16) for _ in range(3))
    vt = torch.tensor(valid_to, dtype=torch.int32, device=dev)
    ap = torch.tensor(append_at, dtype=torch.int32, device=dev)
    return q, kn, vn, k_pool, v_pool, vt, ap, table.to(dev), rows


def phase_decode_paged(torch, ddp, flush, gen):
    import importlib
    fd = importlib.import_module(
        'distributed_dot_product_tpu_torch.ops.flash_decode')
    F = torch.nn.functional
    dev = torch.device('cuda')
    scale = 1.0 / math.sqrt(HEAD_DIM)
    q, kn, vn, kp, vp, vt, ap, table, rows = paged_case(torch, gen, dev)
    k0, v0 = kp.clone(), vp.clone()           # before the step
    kp2, vp2 = kp.clone(), vp.clone()
    out, _, _ = fd.flash_decode(q, kn, vn, kp, vp, vt, ap, page_table=table,
                                scale=scale)
    ref, _, _ = fd.flash_decode_plain(q, kn, vn, kp2, vp2, vt, ap,
                                      page_table=table, scale=scale)
    # K5 on the same rows gathered into a slab.
    ks, vs = fd.gather_pages(k0, table), fd.gather_pages(v0, table)
    out5, _, _ = fd.flash_decode(q, kn, vn, ks, vs, vt, ap, scale=scale)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    row_rel, rel = rel_errs(torch, out, ref)
    pools_same = bool(torch.equal(kp[:-1], kp2[:-1])
                      and torch.equal(vp[:-1], vp2[:-1]))
    written = int(((kp != k0).any(dim=(1, 2, 3))).sum().item())
    k5_same = bool(torch.equal(out, out5))
    row = {'phase': 'flash_decode_paged', 'case': 'mixed_fill',
           'valid_to': vt.tolist(), 'append_at': ap.tolist(),
           'page_size': SERVE_PAGE, 'pages': SERVE_PAGES,
           'max_abs_err': err, 'max_row_rel_err': row_rel, 'rel_err': rel,
           'tol': {'abs': TOL_BF16, 'row_rel': TOL_ROW_REL},
           'pools_bit_identical_but_sink': pools_same,
           'pages_written': written, 'equals_k5_on_gathered_slab': k5_same}
    emit(row)
    check(torch.isfinite(out).all().item(), 'K5p: non-finite output')
    check(not out[1].any().item(), 'K5p: the empty slot is not exactly 0')
    check(err <= TOL_BF16, f'K5p: max abs err {err} > {TOL_BF16}')
    check(row_rel <= TOL_ROW_REL,
          f'K5p: row rel err {row_rel} > {TOL_ROW_REL}')
    check(pools_same, 'K5p: pool differs from the plain append')
    check(k5_same, 'K5p: output differs from K5 on the gathered slab')

    # Bound over this run's inputs: the distinct filled K and V rows read
    # once (shared prefix rows once), q read, out written, k_new/v_new
    # read, the appended rows written, the table read.
    n_rows = len(set().union(*rows))
    cols = sum(v + 1 for v in vt.tolist() if v >= 0)
    n_app = sum(a >= 0 for a in ap.tolist())
    row_b = 2 * HEAD_DIM * HEADS               # one bf16 row of all heads
    nbytes = (2 * row_b * n_rows + 2 * row_b * SERVE_SLOTS
              + 2 * row_b * SERVE_SLOTS + 2 * row_b * n_app
              + 4 * table.numel())
    flops = 4 * HEAD_DIM * HEADS * cols
    bms, by = bound_ms(flops, nbytes)
    mask = (torch.arange(SERVE_T_MAX, device=dev)[None, :]
            <= vt[:, None].long())[:, None, None, :]
    row = {'phase': 'flash_decode_paged', 'case': 'serve_shape',
           'max_abs_err': err,
           'ms': time_ms(torch, lambda: fd.flash_decode(
               q, kn, vn, kp, vp, vt, ap, page_table=table, scale=scale),
               flush),
           'plain_ms': time_ms(torch, lambda: fd.flash_decode_plain(
               q, kn, vn, kp2, vp2, vt, ap, page_table=table, scale=scale),
               flush, reps=10),
           'library_ms': time_ms(torch, lambda: F.scaled_dot_product_attention(
               q, ks, vs, attn_mask=mask, scale=scale), flush),
           'gather_ms': time_ms(torch, lambda: (
               fd.gather_pages(kp, table), fd.gather_pages(vp, table)),
               flush),
           'library': 'sdpa over the slab gathered beforehand (gather_ms '
                      'apart): no single PyTorch call attends a paged cache',
           'bound_ms': bms, 'bound_by': by, 'flops': flops, 'bytes': nbytes,
           'bound_formula': '2*2*d*H_kv*(distinct filled rows) + q, out, '
                            'k_new, v_new, appended rows (2*d*H each, bf16) '
                            '+ 4*table entries'}
    emit(row)
    return row


def serve_burst():
    """The seeded burst, built as ``examples/serve_lm.py``'s
    ``build_requests`` does: (id, prompt) with prompt lengths uniform in
    1..SERVE_PROMPT."""
    import numpy as np
    rng = np.random.default_rng(SERVE_SEED)
    reqs = []
    for i in range(SERVE_REQUESTS):
        plen = int(rng.integers(1, SERVE_PROMPT + 1))
        reqs.append((f'req-{i:03d}',
                     rng.integers(0, VOCAB, size=plen).astype(np.int32)))
    return reqs


def serve_engine(torch, mode, dtype=None, device='cuda', slots=SERVE_SLOTS):
    from distributed_dot_product_tpu_torch.serve import KernelEngine
    paged = (dict(cache_mode='paged', page_size=SERVE_PAGE)
             if mode == 'paged' else {})
    return KernelEngine(slots=slots, t_max=SERVE_T_MAX, vocab=VOCAB,
                        heads=HEADS, head_dim=HEAD_DIM,
                        prefill_chunk=SERVE_CHUNK, seed=SERVE_SEED,
                        dtype=dtype or torch.bfloat16, device=device,
                        **paged)


def first_step_logits(torch, engine, prompts):
    """Logits of each prompt's first decode step: prefill the prompts into
    slots 0.. and apply the engine's own projection, fused step and head
    to its caches (what ``step`` computes before its argmax)."""
    import numpy as np
    from distributed_dot_product_tpu_torch.models.decode import decode_step
    active = np.zeros(engine.slots, bool)
    tokens = np.zeros(engine.slots, np.int64)
    for i, p in enumerate(prompts):
        for start in range(0, len(p) - 1, engine.prefill_chunk):
            engine.prefill(i, p[start:min(start + engine.prefill_chunk,
                                          len(p) - 1)])
        active[i], tokens[i] = True, p[-1]
    if engine.cache_mode == 'paged':
        engine.prepare_step(active)
    with torch.inference_mode():
        q, k, v = engine._project(torch.as_tensor(tokens,
                                                  device=engine.device))
        engine.cache, out = decode_step(q, engine.cache, k, v,
                                        slot_mask=active,
                                        impl=engine.decode_impl)
        logits = out.reshape(engine.slots, -1) @ engine._wo
    return logits[:len(prompts)].float().cpu()


def phase_serve_path(torch, ddp):
    """The burst through the Scheduler over the paged engine (K5p), then
    over the slab engine (K5) with the same seed, then requests 0 and 1
    on a float32 CPU engine with the same weights."""
    import numpy as np
    from distributed_dot_product_tpu_torch.serve import (
        RejectedError, Scheduler, ServeConfig,
    )
    from distributed_dot_product_tpu_torch.utils.tracing import (
        MetricsRegistry,
    )
    burst = serve_burst()
    runs = {}
    for mode in ('paged', 'slab'):
        t0 = time.perf_counter()
        engine = serve_engine(torch, mode)
        # Warm every engine operation, and so build the kernels, before
        # the watchdog arms: first use would otherwise count as a stall.
        engine.step(np.zeros(SERVE_SLOTS, np.int32),
                    np.ones(SERVE_SLOTS, bool))
        engine.prefill(0, np.zeros(SERVE_CHUNK, np.int32))
        for i in range(SERVE_SLOTS):
            engine.reset(i)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        registry = MetricsRegistry()
        sched = Scheduler(engine, ServeConfig(queue_limit=SERVE_QUEUE,
                                              max_new_tokens=SERVE_NEW),
                          registry=registry, fault_injector=False)
        ddp.flash_decode.launches = 0
        ddp.flash_decode_paged.launches = 0
        rejected = {}
        t0 = time.perf_counter()
        try:
            for i, (rid, prompt) in enumerate(burst):
                try:
                    sched.submit(prompt, request_id=rid)
                except RejectedError as e:
                    rejected[rid] = e.reason.value
                if i % 4 == 3:
                    sched.step()
            results = sched.run_until_idle()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            sched.close()
        launches = {'flash_decode': ddp.flash_decode.launches,
                    'flash_decode_paged': ddp.flash_decode_paged.launches}
        snap = registry.snapshot()
        counters, hist = snap['counters'], snap['histograms']
        by_status = {}
        for r in results.values():
            by_status[r.status] = by_status.get(r.status, 0) + 1
        tokens = counters.get('serve.tokens_generated', 0)
        steps = counters.get('serve.decode_steps', 0)
        row = {'phase': 'serve_path', 'cache_mode': mode,
               'engine': {'slots': SERVE_SLOTS, 't_max': SERVE_T_MAX,
                          'vocab': VOCAB, 'heads': HEADS,
                          'head_dim': HEAD_DIM, 'prefill_chunk': SERVE_CHUNK,
                          'page_size': engine.page_size,
                          'pages': engine.pool.pages if engine.pool else None,
                          'dtype': 'bfloat16'},
               'engine_build_and_warm_s': build_s,
               'requests': len(burst), 'rejected_at_submit': rejected,
               'terminal': by_status, 'tokens_generated': tokens,
               'decode_steps': steps, 'wall_s': wall,
               'tokens_per_s': tokens / wall,
               'program_seconds': engine.program_seconds,
               'ttft_s': {k: hist['serve.ttft_seconds'][k]
                          for k in ('p50', 'p99')},
               'step_s': {k: hist['serve.step_seconds'][k]
                          for k in ('p50', 'p99')},
               'watchdog_stalls': sched.health.stall_events,
               'launches': launches}
        emit(row)
        for rid, _ in burst:
            r = results.get(rid)
            check(rid in rejected or (r is not None and r.status in (
                'completed', 'deadline_expired', 'evicted', 'abandoned',
                'failed_nan', 'rejected') and (r.status != 'rejected'
                                               or r.reason is not None)),
                  f'{mode}: {rid} has no typed terminal state')
        check(all(np.all((0 <= np.asarray(r.tokens))
                         & (np.asarray(r.tokens) < VOCAB))
                  for r in results.values()), f'{mode}: token out of range')
        own, other = (('flash_decode_paged', 'flash_decode')
                      if mode == 'paged' else
                      ('flash_decode', 'flash_decode_paged'))
        check(launches[own] == steps,
              f'{mode}: {own} launched {launches[own]} times for {steps} '
              f'decode steps')
        check(launches[other] == 0,
              f'{mode}: {other} launched {launches[other]} times')
        runs[mode] = (engine, results, row)
        if mode == 'slab':
            del engine
    paged_res, slab_res = runs['paged'][1], runs['slab'][1]
    same = [rid for rid, r in paged_res.items()
            if r.status == 'completed' and rid in slab_res
            and slab_res[rid].status == 'completed']
    diverged = [rid for rid in same
                if paged_res[rid].tokens != slab_res[rid].tokens]
    emit({'phase': 'serve_path', 'case': 'paged_vs_slab',
          'completed_in_both': len(same), 'diverged': diverged})
    check(len(same) == len(paged_res) == len(slab_res),
          'paged and slab runs completed different requests')
    check(not diverged, f'paged and slab streams differ: {diverged}')

    # Requests 0 and 1 on the CPU in float32 with the same weights.
    t0 = time.perf_counter()
    card = runs['paged'][0]
    cpu = serve_engine(torch, 'slab', dtype=torch.float32, device='cpu',
                       slots=2)
    cpu.load_weights({name: getattr(card, f'_{name}').float().cpu()
                      for name in ('embed', 'wq', 'wk', 'wv', 'wo')})
    prompts = [p for _, p in burst[:2]]
    card_logits = first_step_logits(torch, card, prompts)
    cpu_logits = first_step_logits(torch, cpu, prompts)
    rel = [((c - g).abs().max() / g.abs().max()).item()
           for c, g in zip(card_logits, cpu_logits)]
    cpu = serve_engine(torch, 'slab', dtype=torch.float32, device='cpu',
                       slots=2)
    cpu.load_weights({name: getattr(card, f'_{name}').float().cpu()
                      for name in ('embed', 'wq', 'wk', 'wv', 'wo')})
    with Scheduler(cpu, ServeConfig(queue_limit=SERVE_QUEUE,
                                    max_new_tokens=SERVE_NEW,
                                    watchdog=False),
                   registry=MetricsRegistry(), fault_injector=False) as ref:
        for rid, prompt in burst[:2]:
            ref.submit(prompt, request_id=rid)
        ref_res = ref.run_until_idle()
    match = {}
    for rid, _ in burst[:2]:
        a, b = ref_res[rid].tokens, paged_res[rid].tokens
        n = 0
        while n < min(len(a), len(b)) and a[n] == b[n]:
            n += 1
        match[rid] = n
    row = {'phase': 'serve_cpu_reference', 'requests': [r for r, _ in
                                                        burst[:2]],
           'first_step_logits_max_rel_err': rel, 'tol': TOL_LM_REL,
           'argmax_card': card_logits.argmax(-1).tolist(),
           'argmax_cpu': cpu_logits.argmax(-1).tolist(),
           'greedy_prefix_match': match, 'tokens': SERVE_NEW,
           'seconds': time.perf_counter() - t0}
    emit(row)
    for r in rel:
        check(r <= TOL_LM_REL, f'serve logits rel err {r} > {TOL_LM_REL}')
    launches_by_path = {mode: runs[mode][2]['launches'] for mode in runs}
    del runs
    torch.cuda.empty_cache()
    return launches_by_path


def phase_main_path(torch, ddp):
    from distributed_dot_product_tpu_torch.models.lm import greedy_generate
    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(0)
    t0 = time.perf_counter()
    model = ddp.TransformerLM(VOCAB, DIM, HEADS, n_layers=LAYERS,
                              dtype=torch.bfloat16,
                              param_dtype=torch.bfloat16, device=dev,
                              generator=gen)
    prompts = torch.randint(0, VOCAB, (BATCH, PROMPT), generator=gen
                            ).to(dev)
    n_params = sum(p.numel() for p in model.parameters())
    build_s = time.perf_counter() - t0

    greedy_generate(model, prompts, 2, T_MAX)          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    greedy_generate(model, prompts, 1, T_MAX)          # prefill only
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)

    ddp.flash_attention.launches = 0
    ddp.flash_decode.launches = 0
    t0 = time.perf_counter()
    tokens = greedy_generate(model, prompts, STEPS, T_MAX)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {'flash_attention': ddp.flash_attention.launches,
                'flash_decode': ddp.flash_decode.launches}

    with torch.inference_mode():
        caches = model.make_decode_caches(BATCH, T_MAX)
        caches, logits = model.prefill(prompts, caches)
        _, step_logits = model.decode(tokens[:, :1], caches)
        finite = bool(torch.isfinite(logits).all().item()
                      and torch.isfinite(step_logits).all().item())
        gpu_last = logits[0, -1].float().cpu()

    row = {'phase': 'main_path', 'params': n_params,
           'model_build_s': build_s, 'tokens_shape': list(tokens.shape),
           'launches': launches, 'expected_launches': {
               'flash_attention': LAYERS,
               'flash_decode': LAYERS * (STEPS - 1)},
           'prefill_ms': prefill_ms,
           'ms_per_decode_step': (1e3 * total_s - prefill_ms) / (STEPS - 1),
           'generate_s': total_s,
           'tokens_per_s': BATCH * STEPS / total_s,
           'logits_finite': finite}
    emit(row)
    check(tuple(tokens.shape) == (BATCH, STEPS), 'wrong token shape')
    check(bool(((tokens >= 0) & (tokens < VOCAB)).all()), 'token out of range')
    check(finite, 'non-finite logits')
    check(launches['flash_attention'] == LAYERS,
          f'K1 launched {launches["flash_attention"]} times, want {LAYERS}')
    check(launches['flash_decode'] == LAYERS * (STEPS - 1),
          f'K5 launched {launches["flash_decode"]} times, '
          f'want {LAYERS * (STEPS - 1)}')

    # The same weights in float32 on the CPU, plain versions throughout.
    t0 = time.perf_counter()
    cpu = ddp.TransformerLM(VOCAB, DIM, HEADS, n_layers=LAYERS,
                            dtype=torch.float32, device='cpu')
    cpu.load_state_dict(model.state_dict())
    p0 = prompts[:1].cpu()
    with torch.inference_mode():
        _, cpu_logits = cpu.prefill(p0, cpu.make_decode_caches(1, T_MAX))
    cpu_last = cpu_logits[0, -1]
    rel = ((gpu_last - cpu_last).abs().max()
           / cpu_last.abs().max()).item()
    cpu_tokens = greedy_generate(cpu, p0, STEPS, T_MAX)[0]
    gpu_tokens = tokens[0].cpu()
    match = int((cpu_tokens == gpu_tokens).int().cumprod(0).sum().item())
    row = {'phase': 'cpu_reference', 'prompt': 0,
           'last_logits_max_rel_err': rel, 'tol': TOL_LM_REL,
           'argmax_gpu': int(gpu_last.argmax()),
           'argmax_cpu': int(cpu_last.argmax()),
           'greedy_prefix_match': match, 'steps': STEPS,
           'seconds': time.perf_counter() - t0}
    emit(row)
    check(rel <= TOL_LM_REL, f'LM logits rel err {rel} > {TOL_LM_REL}')
    return launches


def causal_pairs(tq, tk, off):
    """Attended (row, column) pairs of one causal (batch, head) row."""
    return sum(max(0, min(tk, off + i + 1)) for i in range(tq))


def phase_flash_backward(torch, ddp, flush, gen):
    import importlib
    fa = importlib.import_module(
        'distributed_dot_product_tpu_torch.ops.flash_attention')
    F = torch.nn.functional
    dev, bf16 = torch.device('cuda'), torch.bfloat16
    # (name, batch, q heads, kv heads, Tq, Tk, causal offset or None for
    # no causal mask, head dim): the main path's shapes, then one small
    # case for each other head dim the kernels are built for.
    cases = [('train', TRAIN_B, HEADS, HEADS, TRAIN_T, TRAIN_T, 0, HEAD_DIM),
             ('gqa_ragged', BATCH, HEADS, 2, 333, 333, 0, HEAD_DIM),
             ('ragged_offset', BATCH, HEADS, HEADS, 77, 1077, 1000,
              HEAD_DIM),
             ('full_ragged', BATCH, HEADS, HEADS, 50, 300, None, HEAD_DIM),
             ('d32_gqa', 2, 4, 1, 130, 130, 0, 32),
             ('d64_full', 2, 2, 2, 70, 90, None, 64),
             ('d128_offset', 2, 2, 2, 100, 140, 5, 128)]
    worst, failures = {}, []
    # Every case is held and printed before the phase fails, so one run
    # reads all of them.
    for name, b, hq, hkv, tq, tk, off, hd in cases:
        causal = off is not None
        off = off or 0
        kw = dict(causal=causal, causal_offset=off)
        scale = 1.0 / math.sqrt(hd)
        q = randn(torch, (b, hq, tq, hd), gen, dev, bf16)
        k = randn(torch, (b, hkv, tk, hd), gen, dev, bf16)
        v = randn(torch, (b, hkv, tk, hd), gen, dev, bf16)
        g = randn(torch, (b, hq, tq, hd), gen, dev, bf16)
        out, lse = fa.flash_attention_with_lse(q, k, v, scale=scale, **kw)
        out_p, lse_p = fa.flash_attention_plain_lse(q, k, v, scale=scale,
                                                    **kw)
        # Both backward versions from the kernel's own (out, lse).
        grads = fa.flash_attention_backward(q, k, v, out, lse, g,
                                            scale=scale, **kw)
        plain = fa.flash_attention_backward_plain(q, k, v, out, lse, g,
                                                  scale=scale, **kw)
        torch.cuda.synchronize()
        got = dict(zip(('out', 'dq', 'dk', 'dv'), (out, *grads)))
        want = dict(zip(('out', 'dq', 'dk', 'dv'), (out_p, *plain)))
        err = {n: (got[n].float() - want[n].float()).abs().max().item()
               for n in got}
        err['lse'] = (lse - lse_p).abs().max().item()
        rel = {n: rel_errs(torch, got[n], want[n]) for n in got}
        emit({'phase': 'flash_backward', 'case': name,
              'q': list(q.shape), 'kv': list(k.shape), 'causal': causal,
              'causal_offset': off, 'max_abs_err': err,
              'max_row_rel_err': {n: e[0] for n, e in rel.items()},
              'rel_err': {n: e[1] for n, e in rel.items()},
              'tol': {'lse': TOL_LSE, 'row_rel': TOL_ROW_REL,
                      'rel': TOL_NORM_REL}})
        for n, t in (*got.items(), ('lse', lse)):
            if not torch.isfinite(t).all().item():
                failures.append(f'{n} {name}: non-finite')
        if err['lse'] > TOL_LSE:
            failures.append(f'lse {name}: abs err {err["lse"]} > {TOL_LSE}')
        failures += check_rel(rel, name)
        for n, e in err.items():
            worst[n] = max(worst.get(n, 0.0), e)
        for n, e in rel.items():
            worst[n + '_row_rel'] = max(worst.get(n + '_row_rel', 0.0), e[0])
        if name == 'train':
            train = (b, hq, hkv, tq, tk, off, kw, scale, q, k, v, g, out, lse)
    check(not failures, '; '.join(failures))

    # Times at the training shape, with the bound each kernel could
    # reach: operations on this run's causal pairs, bytes of each
    # operand read once and each result written once.
    b, hq, hkv, tq, tk, off, kw, scale, q, k, v, g, out, lse = train
    nb, d = b * hq, HEAD_DIM
    pairs = causal_pairs(tq, tk, off) * nb
    q_bytes, kv_bytes, row_bytes = 2 * nb * tq * d, 2 * b * hkv * tk * d, \
        4 * nb * tq
    q2, lse2, delta = fa.flash_attention_bwd_operands(q, out, lse, g, scale)
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True,
                                           scale=scale)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        o_lib, (qr, kr, vr), g, retain_graph=True), flush)
    timing = {}
    for kname, flops, nbytes, fn, plain_fn, lib in (
            ('flash_attention', 4 * d * pairs,
             2 * q_bytes + 2 * kv_bytes + row_bytes,
             lambda: fa.flash_attention_with_lse(q, k, v, scale=scale, **kw),
             lambda: fa.flash_attention_plain_lse(q, k, v, scale=scale,
                                                  **kw),
             lambda: F.scaled_dot_product_attention(
                 q, k, v, is_causal=True, scale=scale)),
            ('flash_attention_dq', 6 * d * pairs,
             3 * q_bytes + 2 * kv_bytes + 2 * row_bytes,
             lambda: fa.flash_attention_dq(
                 q2, k, v, g, lse2, delta, scale=scale, **kw),
             lambda: fa.flash_attention_dq_plain(
                 q2, k, v, g, lse2, delta, scale=scale, **kw),
             None),
            ('flash_attention_dkv', 8 * d * pairs,
             2 * q_bytes + 4 * kv_bytes + 2 * row_bytes,
             lambda: fa.flash_attention_dkv(q2, k, v, g, lse2, delta, **kw),
             lambda: fa.flash_attention_dkv_plain(
                 q2, k, v, g, lse2, delta, **kw),
             None)):
        bms, by = bound_ms(flops, nbytes)
        timing[kname] = {
            'ms': time_ms(torch, fn, flush),
            'plain_ms': time_ms(torch, plain_fn, flush, reps=5),
            'library_ms': time_ms(torch, lib, flush) if lib else lib_bwd,
            'bound_ms': bms, 'bound_by': by, 'flops': flops,
            'bytes': nbytes}
    emit({'phase': 'flash_backward', 'case': 'train_timing',
          'library': {'flash_attention': 'sdpa forward, is_causal',
                      'flash_attention_dq': 'sdpa backward (dq, dk, dv '
                      'together)',
                      'flash_attention_dkv': 'sdpa backward (dq, dk, dv '
                      'together)'},
          **timing})
    return worst, timing


def phase_train_path(torch, ddp):
    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(3)
    t0 = time.perf_counter()
    model = ddp.TransformerLM(VOCAB, DIM, HEADS, n_layers=LAYERS,
                              dtype=torch.bfloat16, remat=True, device=dev,
                              generator=gen)
    optimizer = torch.optim.Adam(model.parameters(), lr=LR,
                                 betas=(0.9, 0.999), eps=1e-8)
    step = ddp.make_lm_train_step(model, optimizer, loss_chunk=LOSS_CHUNK)
    tokens = torch.randint(0, VOCAB, (TRAIN_B, TRAIN_T), generator=gen
                           ).to(dev)
    batch = (tokens, ddp.lm_targets(tokens))
    build_s = time.perf_counter() - t0

    counters = {name: getattr(ddp, name) for name in TRAIN_KERNELS}
    expected = {'flash_attention': 2 * LAYERS,      # forward + remat
                'flash_attention_dq': LAYERS, 'flash_attention_dkv': LAYERS}
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, per_step = [], [], []
    for _ in range(TRAIN_STEPS):
        before = {n: fn.launches for n, fn in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(batch)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss.item())
        per_step.append({n: fn.launches - before[n]
                         for n, fn in counters.items()})
    launches = {n: fn.launches for n, fn in counters.items()}
    median_ms = statistics.median(step_ms[1:])
    row = {'phase': 'train_path',
           'params': sum(p.numel() for p in model.parameters()),
           'model_build_s': build_s, 'batch': [TRAIN_B, TRAIN_T],
           'losses': losses, 'step_ms': step_ms,
           'ms_per_step_median_2_5': median_ms,
           'tokens_per_s': TRAIN_B * TRAIN_T / (median_ms / 1e3),
           'max_memory_allocated': torch.cuda.max_memory_allocated(),
           'launches_per_step': per_step,
           'expected_launches_per_step': expected, 'launches': launches}
    emit(row)
    check(all(math.isfinite(x) for x in losses), 'non-finite loss')
    check(losses[-1] < losses[0],
          f'loss did not fall: {losses[0]} -> {losses[-1]}')
    for i, counts in enumerate(per_step):
        check(counts == expected,
              f'step {i + 1} launched {counts}, want {expected}')
    del model, optimizer, step, batch
    torch.cuda.empty_cache()
    return launches


def phase_train_cpu_reference(torch, ddp):
    gen = torch.Generator().manual_seed(4)
    t0 = time.perf_counter()
    cpu = ddp.TransformerLM(VOCAB, DIM, HEADS, n_layers=REF_LAYERS,
                            remat=True, device='cpu', generator=gen)
    card = ddp.TransformerLM(VOCAB, DIM, HEADS, n_layers=REF_LAYERS,
                             dtype=torch.bfloat16, remat=True,
                             device='cuda')
    card.load_state_dict(cpu.state_dict())
    tokens = torch.randint(0, VOCAB, (1, REF_T), generator=gen)
    targets = ddp.lm_targets(tokens)
    loss, grads = {}, {}
    for side, m in (('card', card), ('cpu', cpu)):
        s, c = m.nll_sum(tokens.to(m.device), targets.to(m.device),
                         chunk=LOSS_CHUNK)
        value = s / c.clamp_min(1.0)
        value.backward()
        loss[side] = value.item()
        grads[side] = {n: p.grad.float().cpu()
                       for n, p in m.named_parameters()}
    loss_rel = abs(loss['card'] - loss['cpu']) / abs(loss['cpu'])
    grad_rel = {n: (torch.linalg.vector_norm(grads['card'][n] - g)
                    / torch.linalg.vector_norm(g)).item()
                for n, g in grads['cpu'].items()}
    worst = max(grad_rel, key=grad_rel.get)
    row = {'phase': 'train_cpu_reference', 'layers': REF_LAYERS,
           'batch': [1, REF_T], 'loss': loss, 'loss_rel_err': loss_rel,
           'tol_loss_rel': TOL_REF_LOSS_REL,
           'worst_grad': worst, 'worst_grad_rel_err': grad_rel[worst],
           'tol_grad_rel': TOL_REF_GRAD_REL, 'grad_rel_err': grad_rel,
           'seconds': time.perf_counter() - t0}
    emit(row)
    check(math.isfinite(loss['card']), 'non-finite card loss')
    check(loss_rel <= TOL_REF_LOSS_REL,
          f'loss rel err {loss_rel} > {TOL_REF_LOSS_REL}')
    check(grad_rel[worst] <= TOL_REF_GRAD_REL,
          f'{worst}: grad rel err {grad_rel[worst]} > {TOL_REF_GRAD_REL}')


def main():
    try:
        import torch
    except ImportError as exc:
        print(f'chip_smoke: torch is not importable: {exc}', file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this script '
              'runs only on a CUDA card', file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import distributed_dot_product_tpu_torch as ddp
        from distributed_dot_product_tpu_torch.ops import _build
    except ImportError as exc:
        print(f'chip_smoke: the port package is not importable: {exc}',
              file=sys.stderr)
        return 2

    phase = 'device'
    try:
        smi = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        emit({'phase': 'device', 'name': kind, 'count': count,
              'nvidia_smi': smi, 'torch': torch.__version__,
              'cuda': torch.version.cuda})

        phase = 'build'
        t0 = time.perf_counter()
        _build.build_all()
        emit({'phase': 'build', 'sources': list(_build.SOURCES),
              'seconds': time.perf_counter() - t0})

        flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32,
                            device='cuda')            # 256 MB > 50 MB L2
        gen = torch.Generator().manual_seed(1)
        phase = 'flash_attention'
        k1 = phase_flash(torch, ddp, flush, gen)
        phase = 'flash_decode'
        k5 = phase_decode(torch, ddp, flush, gen)
        phase = 'flash_decode_paged'
        k5p = phase_decode_paged(torch, ddp, flush, gen)
        phase = 'serve_path'
        serve_path_launches = phase_serve_path(torch, ddp)
        phase = 'flash_backward'
        bwd_err, bwd_time = phase_flash_backward(torch, ddp, flush, gen)
        del flush
        phase = 'main_path'
        serve_launches = phase_main_path(torch, ddp)
        phase = 'train_path'
        train_launches = phase_train_path(torch, ddp)
        phase = 'train_cpu_reference'
        phase_train_cpu_reference(torch, ddp)
    except Exception as exc:   # report the failed phase, then fail
        emit({'phase': phase, 'ok': False,
              'error': f'{type(exc).__name__}: {exc}'})
        raise

    # K1, K3, K4: launches on the training path (K1's serving launches
    # beside them), times at the training shape. K5: launches and times of
    # the greedy serving path (its launches on the slab twin of the
    # scheduler's run beside them). K5p: launches on the scheduler's paged
    # run, times at the serving shape.
    csrc = 'distributed_dot_product_tpu_torch/csrc/'
    tpu = 'distributed_dot_product_tpu/ops/'
    k1_err = max(k1['max_abs_err'], bwd_err['out'])
    kernels = [
        dict(name='flash_attention', source=csrc + 'flash_fwd.cu',
             replaces=tpu + 'pallas_attention.py:630',
             launches=train_launches['flash_attention'],
             launches_by_path={
                 'serve': serve_launches['flash_attention'],
                 'train': train_launches['flash_attention']},
             max_abs_err=k1_err, lse_max_abs_err=bwd_err['lse'],
             max_row_rel_err=max(k1['max_row_rel_err'],
                                 bwd_err['out_row_rel']),
             **bwd_time['flash_attention']),
        dict(name='flash_attention_dq', source=csrc + 'flash_bwd.cu',
             replaces=tpu + 'pallas_attention.py:1228',
             launches=train_launches['flash_attention_dq'],
             max_abs_err=bwd_err['dq'],
             max_row_rel_err=bwd_err['dq_row_rel'],
             **bwd_time['flash_attention_dq']),
        dict(name='flash_attention_dkv', source=csrc + 'flash_bwd.cu',
             replaces=tpu + 'pallas_attention.py:1319',
             launches=train_launches['flash_attention_dkv'],
             max_abs_err=max(bwd_err['dk'], bwd_err['dv']),
             max_row_rel_err=max(bwd_err['dk_row_rel'],
                                 bwd_err['dv_row_rel']),
             **bwd_time['flash_attention_dkv']),
        dict(name='flash_decode', source=csrc + 'flash_decode.cu',
             replaces=tpu + 'pallas_decode.py:107',
             launches=serve_launches['flash_decode'],
             launches_by_path={
                 'main_path': serve_launches['flash_decode'],
                 'serve_path_slab':
                     serve_path_launches['slab']['flash_decode']},
             max_abs_err=k5['max_abs_err'],
             **{key: k5[key] for key in ('ms', 'plain_ms', 'library_ms',
                                         'bound_ms', 'bound_by')}),
        dict(name='flash_decode_paged', source=csrc + 'flash_decode.cu',
             replaces=tpu + 'pallas_decode.py:310',
             launches=serve_path_launches['paged']['flash_decode_paged'],
             max_abs_err=k5p['max_abs_err'],
             **{key: k5p[key] for key in ('ms', 'plain_ms', 'library_ms',
                                          'gather_ms', 'library',
                                          'bound_ms', 'bound_by')})]
    for entry in kernels:
        entry['route'] = 'cuda'
        for key in ('flops', 'bytes'):
            entry.pop(key, None)
    print(smi, flush=True)
    emit({'kernels': kernels})
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                 'count': count}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
