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
   (float32, plain versions);
11. flash_features (run after flash_backward): K1/K3/K4 at the flagship
   module's fold shape (2 x 8 heads, 4096 rows, head dim 64) with a dense
   mask that has fully masked rows (passed as a column slice of a
   (B, 1, 4096, 8192) mask, uncopied), with ring-fold kv_offsets (past,
   diagonal, future) and float32 gradients, against their plain
   versions; K2 against its plain version and K1, and a large-norm case
   in which the guard must launch K1; times against bound, plain and
   SDPA with a boolean mask;
12. seq_parallel: 4 ranks spawned on the card (gloo with host-staged
   collectives; NCCL when there is a card per rank) running the
   flagship DistributedDotProductAttn(key_dim=512, num_heads=8,
   offset=64): entry() at W = 1 and 4, nt / all / tn times, each
   strategy's output and gradients at W = 4 against the local module,
   and three DP x SP train steps (2 x 2, B 4 x T 8192, Adam 1e-3) of
   'full', 'flash', 'online', bounded 'flash', 'ulysses' and causal
   'online' with ms per step and each kernel's launches per step;
13. flash_masks (run after flash_features): K1/K3/K4 with ragged packed
   segments, a causal window of 2048 at kv_offset 2048, dropout 0.1,
   int8 scoring, and all four at once under GQA 8:4 at head dim 96,
   against their plain versions (K1's out and lse, K3/K4 in bf16 and
   float32) at the fold shape 2 x 8 x 4096; the dropout keep pattern
   bit for bit (v = eye(128), at the origin and near 2^20), int8 scores
   bit for bit, a wholly cross-segment fold exactly empty; times against
   bound, plain and SDPA with a boolean mask where one call computes the
   same function;
14. flagship: dryrun_multichip's window, gqa_ring (GQA, RoPE, the ring
   with packed segments, dropout 0.1 and int8 scoring), stack (a 2-layer
   TransformerStack at dim 768) and lm (the 16-layer TransformerLM on
   packed segments) stages, 4 ranks on one card as seq_parallel, a 2 x 2
   data x seq group, global B 4 x T 8192, three Adam steps each (1e-3,
   the stack 3e-4): ms per step, losses, launches per step against the
   fold counts, the gradient all-reduce's ms, peak memory; window and gqa_ring at W = 4 against the local module; then
   greedy generation from the trained LM on rank 0.

Then the card's ``nvidia-smi`` name and power limit, the kernels line
(``{"kernels": [...]}``: K1, K2, K3, K4, K5 and K5p with their launches on
their path, max error, kernel / plain / library / bound times; K1, K3 and
K4 also per mask variant) and, only if
every phase passed, the last line ``{"ok": true, "device": {...}}``.
Exits non-zero on any failure, and without a card. ``--phases a,b`` runs
only the named phases (after device and build) and prints no result
line.
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


# The sequence-parallel configuration: the flagship module
# DistributedDotProductAttn(key_dim=512, num_heads=8, offset=64) (head dim
# 64), trained DP x SP on a 2 x 2 group: global batch 4 x T 8192, so each
# rank holds 2 x 4096 rows of 8 heads.
SP_DIM, SP_HEADS, SP_OFFSET = 512, 8, 64
SP_HEAD_DIM = SP_DIM // SP_HEADS
SP_DATA, SP_SEQ, SP_B, SP_T = 2, 2, 4, 8192
SP_TN = SP_T // SP_SEQ
# K2 vs its plain version and vs K1: the same shift-invariant softmax, the
# bound's shift only moves where float32 rounds, so the row limits above
# hold it (its p is rounded to bf16 as K1's is).


def _fold_inputs(torch, gen, b, h, tq, tk, d, mask_cols=None, scale=1.0):
    dev, bf16 = torch.device('cuda'), torch.bfloat16
    q = scale * randn(torch, (b, h, tq, d), gen, dev, torch.float32)
    k = scale * randn(torch, (b, h, tk, d), gen, dev, torch.float32)
    v = randn(torch, (b, h, tk, d), gen, dev, bf16)
    g = randn(torch, (b, h, tq, d), gen, dev, bf16)
    mask = None
    if mask_cols is not None:
        # A rank's (B, 1, T/N, T) rows with 30% of entries masked and
        # every 97th row fully masked.
        mask = torch.rand((b, 1, tq, mask_cols), generator=gen) < 0.3
        mask[:, :, ::97] = True
        mask = mask.to(dev)
    return q.to(bf16), k.to(bf16), v, g, mask


def phase_flash_features(torch, ddp, flush, gen):
    """K1/K3/K4 with a dense mask (fully masked rows), ring-fold
    kv_offsets and float32 gradients; K2 against its plain version and
    K1, and a large-norm case where the guard must launch K1."""
    import importlib
    fa = importlib.import_module(
        'distributed_dot_product_tpu_torch.ops.flash_attention')
    F = torch.nn.functional
    b, h, tn, d = SP_B // SP_DATA, SP_HEADS, SP_TN, SP_HEAD_DIM
    scale = 1.0 / math.sqrt(d)
    worst, failures, rows_out = {}, [], {}
    q, k, v, g, mask = _fold_inputs(torch, gen, b, h, tn, tn, d,
                                    mask_cols=SP_T)
    # (name, causal, causal_offset, kv_offset, mask column block or None,
    # grad dtype): rank 1's ring folds of the causal 2-rank ring (owner 0
    # in the past, owner 1 the diagonal, owner 0 seen from rank 0's future
    # side would be skipped), a masked non-causal fold, and the masked
    # self-attention of one rank's block.
    cases = [('fold_past_f32', True, tn, 0, None, torch.float32),
             ('fold_diag_f32', True, tn, tn, None, torch.float32),
             ('fold_future', True, 0, tn, None, torch.float32),
             ('fold_mask_f32', False, tn, 0, 0, torch.float32),
             ('fold_mask_causal_f32', True, tn, tn, 1, torch.float32),
             ('mask_bf16', False, 0, 0, 1, None)]
    neg = fa._LN2 * fa._NEG_BIG
    for name, causal, co, ko, blk, gdt in cases:
        m = None if blk is None else mask[..., blk * tn:(blk + 1) * tn]
        kw = dict(causal=causal, causal_offset=co, kv_offset=ko)
        out, lse = fa.flash_attention_with_lse(q, k, v, m, scale=scale, **kw)
        out_p, lse_p = fa.flash_attention_plain_lse(q, k, v, m, scale=scale,
                                                    **kw)
        grads = fa.flash_attention_backward(q, k, v, out, lse, g, scale=scale,
                                            mask=m, grad_dtype=gdt, **kw)
        plain = fa.flash_attention_backward_plain(
            q, k, v, out, lse, g, scale=scale, mask=m, grad_dtype=gdt, **kw)
        torch.cuda.synchronize()
        got = dict(zip(('out', 'dq', 'dk', 'dv'), (out, *grads)))
        want = dict(zip(('out', 'dq', 'dk', 'dv'), (out_p, *plain)))
        err = {n: (got[n].float() - want[n].float()).abs().max().item()
               for n in got}
        finite_lse = lse_p > 0.5 * neg
        err['lse'] = (lse - lse_p)[finite_lse].abs().max().item() \
            if finite_lse.any() else 0.0
        rel = {n: rel_errs(torch, got[n], want[n]) for n in got
               if want[n].abs().max().item() > 0}
        empty = (~finite_lse)
        exact_empty = bool((lse[empty] == neg).all().item()
                           and not out[empty].any().item()
                           and not grads[0][empty].any().item())
        dtypes = sorted({str(t.dtype) for t in grads})
        emit({'phase': 'flash_features', 'case': name, 'q': list(q.shape),
              'kv': list(k.shape), 'causal': causal, 'causal_offset': co,
              'kv_offset': ko, 'mask': None if m is None else
              {'shape': list(m.shape), 'strides': list(m.stride()),
               'masked_share': m.float().mean().item()},
              'grad_dtypes': dtypes, 'max_abs_err': err,
              'max_row_rel_err': {n: e[0] for n, e in rel.items()},
              'rel_err': {n: e[1] for n, e in rel.items()},
              'empty_rows': int(empty.sum().item()),
              'empty_rows_exact': exact_empty,
              'tol': {'lse': TOL_LSE, 'row_rel': TOL_ROW_REL,
                      'rel': TOL_NORM_REL}})
        for n, t in (*got.items(), ('lse', lse)):
            if not torch.isfinite(t).all().item():
                failures.append(f'{n} {name}: non-finite')
        if err['lse'] > TOL_LSE:
            failures.append(f'lse {name}: abs err {err["lse"]} > {TOL_LSE}')
        if not exact_empty:
            failures.append(f'{name}: rows with no attendable key are not '
                            f'exactly out 0 / lse ln2*NEG_BIG / dq 0')
        if gdt is not None and dtypes != ['torch.float32']:
            failures.append(f'{name}: gradients in {dtypes}, want float32')
        failures += check_rel(rel, name)
        for n, e in err.items():
            worst[n] = max(worst.get(n, 0.0), e)
        if name == 'fold_future' and out.any().item():
            failures.append('fold_future: output not 0')
        rows_out[name] = (kw, m, gdt, out, lse)

    # K2: against its plain version and against K1 on unit-normal inputs
    # (the guard picks K2), then at a large norm (the guard must pick K1).
    for name, norm, want_k2 in (('bounded', 1.0, True),
                                ('bounded_large_norm', 4.0, False)):
        qb, kb, vb, _, _ = _fold_inputs(torch, gen, b, h, tn, tn, d,
                                        scale=norm)
        m = mask[..., tn:2 * tn]
        launches = (ddp.flash_attention.launches,
                    fa.flash_attention_bounded.launches)
        out = ddp.flash_attention(qb, kb, vb, m, scale=scale,
                                  softmax_mode='bounded')
        torch.cuda.synchronize()
        took = (ddp.flash_attention.launches - launches[0],
                fa.flash_attention_bounded.launches - launches[1])
        mvec = fa.bounded_shift(fa._fold_q(qb, scale), kb)
        ref = (fa.flash_attention_bounded_plain_lse(qb, kb, vb, m,
                                                    scale=scale)[0]
               if want_k2 else fa.flash_attention_plain(qb, kb, vb, m,
                                                        scale=scale))
        k1 = fa.flash_attention(qb, kb, vb, m, scale=scale)
        row, whole = rel_errs(torch, out, ref)
        row1, whole1 = rel_errs(torch, out, k1)
        err = (out.float() - ref.float()).abs().max().item()
        emit({'phase': 'flash_features', 'case': name, 'q': list(qb.shape),
              'max_bound': mvec.max().item(),
              'guard': '2*max(bound) <= 100',
              'launched': {'flash_attention': took[0],
                           'flash_attention_bounded': took[1]},
              'max_abs_err': err, 'max_row_rel_err': row, 'rel_err': whole,
              'vs_k1': {'max_row_rel_err': row1, 'rel_err': whole1},
              'tol': {'row_rel': TOL_ROW_REL, 'rel': TOL_NORM_REL}})
        want_took = (0, 1) if want_k2 else (1, 0)
        if took != want_took:
            failures.append(f'{name}: launched (K1, K2) = {took}, want '
                            f'{want_took}')
        failures += check_rel({'out': (row, whole)}, name)
        failures += check_rel({'out_vs_k1': (row1, whole1)}, name)
        worst['bounded' if want_k2 else 'bounded_large'] = err
        if want_k2:
            bounded = (qb, kb, vb, m, mvec)
    check(not failures, '; '.join(failures))

    # Times at the flagship's fold shape: K1 on rank 1's masked causal
    # diagonal fold, K2 on the same inputs unmasked non-causal (the flash
    # branch's shape), K3 / K4 with float32 gradients.
    timing = {}
    kw, m, gdt, out, lse = rows_out['fold_mask_causal_f32']
    q2, lse2, delta = fa.flash_attention_bwd_operands(q, out, lse, g, scale)
    nb = b * h
    # Operations count the pairs this run's data needs: the causal
    # diagonal's unmasked pairs (K2: every unmasked pair).
    pairs = int((~m).expand(b, h, tn, tn).tril().sum().item())
    mask_bytes = m.numel()                                # read once
    qb, kb, vb, mb, mvec = bounded
    pairs_k2 = int((~mb).expand(b, h, tn, tn).sum().item())
    lib_mask = ~(m | torch.ones(tn, tn, dtype=torch.bool,
                                device=m.device).triu(1))
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qr, kr, vr, attn_mask=lib_mask,
                                           scale=scale)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        o_lib, (qr, kr, vr), g, retain_graph=True), flush)
    qkv = 2 * nb * tn * d
    for kname, flops, nbytes, fn, plain_fn, lib in (
            ('flash_attention', 4 * d * pairs,
             4 * qkv + mask_bytes + 4 * nb * tn,
             lambda: fa.flash_attention_with_lse(q, k, v, m, scale=scale,
                                                 **kw),
             lambda: fa.flash_attention_plain_lse(q, k, v, m, scale=scale,
                                                  **kw),
             lambda: F.scaled_dot_product_attention(q, k, v,
                                                    attn_mask=lib_mask,
                                                    scale=scale)),
            ('flash_attention_bounded', 4 * d * pairs_k2,
             4 * qkv + mask_bytes + 4 * nb * tn,
             lambda: fa.flash_attention_bounded(qb, kb, vb, mb, scale=scale,
                                                mvec=mvec),
             lambda: fa.flash_attention_bounded_plain_lse(qb, kb, vb, mb,
                                                          scale=scale),
             lambda: F.scaled_dot_product_attention(qb, kb, vb,
                                                    attn_mask=~mb,
                                                    scale=scale)),
            ('flash_attention_dq', 6 * d * pairs,
             4 * qkv + mask_bytes + 8 * nb * tn + 2 * qkv,
             lambda: fa.flash_attention_dq(q2, k, v, g, lse2, delta, mask=m,
                                           scale=scale, grad_dtype=gdt, **kw),
             lambda: fa.flash_attention_dq_plain(q2, k, v, g, lse2, delta,
                                                 mask=m, scale=scale,
                                                 grad_dtype=gdt, **kw),
             None),
            ('flash_attention_dkv', 8 * d * pairs,
             4 * qkv + mask_bytes + 8 * nb * tn + 4 * qkv,
             lambda: fa.flash_attention_dkv(q2, k, v, g, lse2, delta, mask=m,
                                            grad_dtype=gdt, **kw),
             lambda: fa.flash_attention_dkv_plain(q2, k, v, g, lse2, delta,
                                                  mask=m, grad_dtype=gdt,
                                                  **kw),
             None)):
        bms, by = bound_ms(flops, nbytes)
        timing[kname] = {
            'ms': time_ms(torch, fn, flush),
            'plain_ms': time_ms(torch, plain_fn, flush, reps=5),
            'library_ms': time_ms(torch, lib, flush) if lib else lib_bwd,
            'bound_ms': bms, 'bound_by': by, 'flops': flops,
            'bytes': nbytes}
    # K1 on K2's inputs: the two forwards on the same work, one call.
    k1_same = time_ms(torch, lambda: fa.flash_attention(qb, kb, vb, mb,
                                                        scale=scale), flush)
    emit({'phase': 'flash_features', 'case': 'fold_timing',
          'shape': [b, h, tn, d], 'pairs': pairs, 'pairs_k2': pairs_k2,
          'k1_on_k2_inputs_ms': k1_same,
          'library': {'flash_attention': 'sdpa forward, boolean mask',
                      'flash_attention_bounded': 'sdpa forward, boolean '
                      'mask', 'flash_attention_dq': 'sdpa backward (dq, dk, '
                      'dv together), boolean mask',
                      'flash_attention_dkv': 'sdpa backward (dq, dk, dv '
                      'together), boolean mask'},
          'bound_formula': 'bytes: q, k, v, dO/out read once (bf16), mask '
                           'bytes, lse/delta; operations: 4/6/8*d per '
                           'unmasked causal pair (K2: per unmasked pair)',
          **timing})
    return worst, timing


PEAK_INT8_OPS = 1979e12      # H100 SXM dense int8 tensor-core rate
# The masks and terms of K1/K3/K4 at the flagship's fold shape (2 x 8
# heads x 4096 rows, head dim 64) and, all four at once under GQA 8:4, at
# the LM's head dim 96: (name, q heads, kv heads, head dim, causal,
# causal offset, kv offset, segments, window, dropout rate, int8).
MASK_CASES = (
    ('segments', 8, 8, 64, False, 0, 0, True, None, 0.0, False),
    ('window', 8, 8, 64, True, 4096, 2048, False, 2048, 0.0, False),
    ('dropout', 8, 8, 64, True, 0, 0, False, None, 0.1, False),
    ('int8', 8, 8, 64, False, 0, 0, False, None, 0.0, True),
    ('all_gqa', 8, 4, 96, True, 0, 0, True, 2048, 0.1, True),
    # rank 1's causal fold of owner 0 in the recipe's packed layout: its
    # rows are document 1, the owner's keys document 0 — every row has no
    # attendable key.
    ('cross_segment', 8, 8, 64, True, 4096, 0, 'cross', None, 0.1, True))
MASK_SEED = 12345


def ragged_segments(torch, gen, b, t, docs=6):
    """``(b, 1, t)`` int32 packed-document ids: ``docs`` documents a row,
    boundaries at random positions, different in every row."""
    seg = torch.zeros((b, 1, t), dtype=torch.int32)
    for i in range(b):
        cuts = torch.randperm(t - 1, generator=gen)[:docs - 1] + 1
        seg[i, 0, cuts] = 1
    return seg.cumsum(-1).to(torch.int32)


def valid_pairs(torch, tq, tk, causal, co, ko, window, seg):
    """Attended (row, column) pairs over the batch of one head (the pairs
    this run's data needs)."""
    dev = torch.device('cuda')
    rows = co + torch.arange(tq, device=dev)[:, None]
    cols = ko + torch.arange(tk, device=dev)[None, :]
    ok = torch.ones((tq, tk), dtype=torch.bool, device=dev)
    if causal:
        ok &= rows >= cols
        if window is not None:
            ok &= rows - cols < window
    if seg is None:
        return int(ok.sum().item())
    sq, sk = seg
    same = sq[:, 0, :, None] == sk[:, 0, None, :]
    return int((same & ok).sum().item())


def bound_mixed(ops_bf16, ops_int8, nbytes):
    """``bound_ms`` for work split between bf16 and int8 tensor-core
    products: their times at each peak add up."""
    t_ops = ops_bf16 / PEAK_BF16_FLOPS + ops_int8 / PEAK_INT8_OPS
    t_bytes = nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ('operations' if t_ops > t_bytes
                                       else 'bytes')


def phase_flash_masks(torch, ddp, flush, gen):
    """K1/K3/K4 with segments, a window, dropout and int8 scoring against
    their plain versions (K1's out and lse, K3/K4 in bf16 and float32),
    the dropout keep pattern bit for bit, int8 scores bit for bit, a
    wholly cross-segment fold exactly empty; times against bound, plain
    and, where one PyTorch call computes the same function, SDPA."""
    import importlib
    fa = importlib.import_module(
        'distributed_dot_product_tpu_torch.ops.flash_attention')
    F = torch.nn.functional
    dev, bf16 = torch.device('cuda'), torch.bfloat16
    b, t = SP_B // SP_DATA, SP_TN
    neg = fa._LN2 * fa._NEG_BIG
    worst, failures, timing = {}, [], {}
    for (name, hq, hkv, d, causal, co, ko, segs, window, rate,
         int8) in MASK_CASES:
        scale = 1.0 / math.sqrt(d)
        q = randn(torch, (b, hq, t, d), gen, dev, bf16)
        k = randn(torch, (b, hkv, t, d), gen, dev, bf16)
        v = randn(torch, (b, hkv, t, d), gen, dev, bf16)
        g = randn(torch, (b, hq, t, d), gen, dev, bf16)
        seg = None
        if segs == 'cross':
            seg = (torch.ones((b, 1, t), dtype=torch.int32, device=dev),
                   torch.zeros((b, 1, t), dtype=torch.int32, device=dev))
        elif segs:
            one = ragged_segments(torch, gen, b, t).to(dev)
            seg = (one, one)
        feat = dict(segment_ids=seg, window=window, dropout_rate=rate,
                    dropout_seed=MASK_SEED if rate else None,
                    qk_quant='int8' if int8 else None)
        kw = dict(causal=causal, causal_offset=co, kv_offset=ko, scale=scale)
        out, lse = fa.flash_attention_with_lse(q, k, v, **kw, **feat)
        out_p, lse_p = fa.flash_attention_plain_lse(q, k, v, **kw, **feat)
        got, want = {'out': out}, {'out': out_p}
        for gdt, tag in ((None, ''), (torch.float32, '_f32')):
            gk = fa.flash_attention_backward(
                q, k, v, out, lse, g, causal, co, scale, kv_offset=ko,
                grad_dtype=gdt, **feat)
            gp = fa.flash_attention_backward_plain(
                q, k, v, out, lse, g, causal, co, scale, kv_offset=ko,
                grad_dtype=gdt, **feat)
            for n, a, w in zip(('dq', 'dk', 'dv'), gk, gp):
                got[n + tag], want[n + tag] = a, w
                if gdt is not None and a.dtype != torch.float32:
                    failures.append(f'{name}: {n} in {a.dtype}, want '
                                    f'float32')
        torch.cuda.synchronize()
        finite_lse = lse_p > 0.5 * neg
        err = {n: (got[n].float() - want[n].float()).abs().max().item()
               for n in got}
        err['lse'] = ((lse - lse_p)[finite_lse].abs().max().item()
                      if finite_lse.any() else 0.0)
        rel = {n: rel_errs(torch, got[n], want[n]) for n in got
               if want[n].abs().max().item() > 0}
        empty = ~finite_lse
        exact_empty = bool((lse[empty] == neg).all().item()
                           and not out[empty].any().item()
                           and not got['dq'][empty].any().item()
                           and not got['dq_f32'][empty].any().item())
        emit({'phase': 'flash_masks', 'case': name, 'q': list(q.shape),
              'kv': list(k.shape), 'causal': causal, 'causal_offset': co,
              'kv_offset': ko, 'segments': None if seg is None else
              ('cross' if segs == 'cross' else
               int(seg[0].max().item()) + 1), 'window': window,
              'dropout_rate': rate, 'qk_quant': feat['qk_quant'],
              'max_abs_err': err,
              'max_row_rel_err': {n: e[0] for n, e in rel.items()},
              'rel_err': {n: e[1] for n, e in rel.items()},
              'empty_rows': int(empty.sum().item()),
              'empty_rows_exact': exact_empty,
              'tol': {'lse': TOL_LSE, 'row_rel': TOL_ROW_REL,
                      'rel': TOL_NORM_REL}})
        for n, x in (*got.items(), ('lse', lse)):
            if not torch.isfinite(x).all().item():
                failures.append(f'{n} {name}: non-finite')
        if err['lse'] > TOL_LSE:
            failures.append(f'lse {name}: abs err {err["lse"]} > {TOL_LSE}')
        if not exact_empty:
            failures.append(f'{name}: rows with no attendable key are not '
                            f'exactly out 0 / lse ln2*NEG_BIG / dq 0')
        if segs == 'cross':
            if empty.sum().item() != empty.numel() or any(
                    x.any().item() for x in got.values()):
                failures.append(f'{name}: a wholly cross-segment fold is '
                                f'not exactly empty with zero gradients')
            continue
        failures += check_rel(rel, name)
        for n, e in err.items():
            worst[n] = max(worst.get(n, 0.0), e)

        # Times: K1 with its lse, K3 and K4 in bf16, at this case's shape.
        nb = b * hq
        pairs = hq * valid_pairs(torch, t, t, causal, co, ko, window, seg)
        q2, lse2, delta = fa.flash_attention_bwd_operands(q, out, lse, g,
                                                          scale)
        quant = fa.quant_operands(q, k) if int8 else None
        bw = dict(causal=causal, causal_offset=co, kv_offset=ko,
                  segment_ids=seg, window=window, dropout_rate=rate,
                  dropout_seed=feat['dropout_seed'], quant=quant)
        el = 1 if int8 else 2              # bytes of a q / k element read
        q_b, kv_b = nb * t * d, b * hkv * t * d
        rows_b = 4 * nb * t
        vec_b = (8 * b * t if seg is not None else 0) + \
            (4 * (nb + b * hkv) * t if int8 else 0)
        lib = None
        if not rate and not int8:
            allowed = torch.ones((t, t), dtype=torch.bool, device=dev)
            if causal:
                r_ = co + torch.arange(t, device=dev)[:, None]
                c_ = ko + torch.arange(t, device=dev)[None, :]
                allowed = r_ >= c_
                if window is not None:
                    allowed = allowed & (r_ - c_ < window)
            if seg is not None:
                allowed = allowed & (seg[0][:, :, :, None]
                                     == seg[1][:, :, None, :])
            lib = (lambda al=allowed: F.scaled_dot_product_attention(
                q, k, v, attn_mask=al, scale=scale))
        s_ops = 2 * d * pairs              # one product's multiply-adds
        for kname, ops, nbytes, fn, plain_fn in (
                ('flash_attention', (s_ops * (1 - int8) + s_ops,
                                     s_ops * int8),
                 el * (q_b + kv_b) + 2 * kv_b + 2 * q_b + rows_b + vec_b,
                 lambda: fa.flash_attention_with_lse(q, k, v, **kw, **feat),
                 lambda: fa.flash_attention_plain_lse(q, k, v, **kw,
                                                      **feat)),
                ('flash_attention_dq', (s_ops * (1 - int8) + 2 * s_ops,
                                        s_ops * int8),
                 el * (q_b + kv_b) + 2 * kv_b + 4 * q_b + 2 * rows_b
                 + vec_b,
                 lambda: fa.flash_attention_dq(q2, k, v, g, lse2, delta,
                                               scale=scale, **bw),
                 lambda: fa.flash_attention_dq_plain(
                     q2, k, v, g, lse2, delta, scale=scale, **bw)),
                ('flash_attention_dkv', (s_ops * (1 - int8) + 3 * s_ops,
                                         s_ops * int8),
                 el * (q_b + kv_b) + 2 * kv_b + 2 * q_b + 4 * kv_b
                 + 2 * rows_b + vec_b,
                 lambda: fa.flash_attention_dkv(q2, k, v, g, lse2, delta,
                                                scale=scale, **bw),
                 lambda: fa.flash_attention_dkv_plain(
                     q2, k, v, g, lse2, delta, scale=scale, **bw))):
            bms, by = bound_mixed(*ops, nbytes)
            timing.setdefault(kname, {})[name] = {
                'ms': time_ms(torch, fn, flush),
                'plain_ms': time_ms(torch, plain_fn, flush, reps=3),
                'library_ms': (time_ms(torch, lib, flush)
                               if lib is not None and kname ==
                               'flash_attention' else None),
                'bound_ms': bms, 'bound_by': by}
        emit({'phase': 'flash_masks', 'case': name + '_timing',
              'pairs': pairs,
              'library': ('sdpa forward, boolean mask' if lib is not None
                          else 'none: no PyTorch call computes the '
                          'hash dropout or int8 scoring'),
              **{kn: timing[kn][name] for kn in timing}})
        del q, k, v, g, out, lse, out_p, lse_p, got, want, q2, lse2, delta
        torch.cuda.empty_cache()

    # The dropout keep pattern, bit for bit: with v = eye(Tk) the output
    # row is the row's dropped weights, exactly 0 where an element was
    # dropped; at Tk = d = 128, once at the origin and once with the
    # coordinates near 2^20 (they wrap in the hash's multiplies).
    for co, ko in ((0, 0), (2 ** 20 + 7, 2 ** 20 - 100)):
        n = 128
        q = randn(torch, (b, 8, n, n), gen, dev, bf16)
        k = randn(torch, (b, 8, n, n), gen, dev, bf16)
        eye = torch.eye(n, dtype=bf16, device=dev).expand(b, 8, n, n)
        kw = dict(causal_offset=co, kv_offset=ko, dropout_rate=0.1,
                  dropout_seed=-MASK_SEED)
        out = fa.flash_attention(q, k, eye, **kw)
        out_p = fa.flash_attention_plain(q, k, eye, **kw)
        keep, _ = fa.dropout_keep((b, 8), n, n, co, ko, 0.1, -MASK_SEED,
                                  dev)
        same = bool(torch.equal(out != 0, keep)
                    and torch.equal(out_p != 0, keep))
        emit({'phase': 'flash_masks', 'case': 'keep_pattern',
              'offsets': [co, ko], 'shape': list(out.shape),
              'kept_share': keep.float().mean().item(),
              'exactly_equal': same})
        if not same:
            failures.append(f'keep pattern at offsets {co, ko} differs from '
                            f'the plain version')
    # K2 with segments and a window (its Ext instantiation) against its
    # plain version, the guard picking K2 on unit-normal inputs.
    q = randn(torch, (b, 8, t, 64), gen, dev, bf16)
    k = randn(torch, (b, 8, t, 64), gen, dev, bf16)
    v = randn(torch, (b, 8, t, 64), gen, dev, bf16)
    one = ragged_segments(torch, gen, b, t).to(dev)
    kw = dict(causal=True, causal_offset=t, kv_offset=t // 2,
              window=MASK_CASES[1][8], segment_ids=(one, one))
    before = fa.flash_attention_bounded.launches
    out = fa.flash_attention(q, k, v, softmax_mode='bounded', **kw)
    torch.cuda.synchronize()
    took = fa.flash_attention_bounded.launches - before
    ref = fa.flash_attention_bounded_plain_lse(q, k, v, **kw)[0]
    row, whole = rel_errs(torch, out, ref)
    emit({'phase': 'flash_masks', 'case': 'bounded_segments_window',
          'q': list(q.shape), 'k2_launched': took, 'max_row_rel_err': row,
          'rel_err': whole, 'tol': {'row_rel': TOL_ROW_REL,
                                    'rel': TOL_NORM_REL}})
    failures += check_rel({'out': (row, whole)}, 'bounded_segments_window')
    if took != 1:
        failures.append(f'bounded_segments_window: K2 launched {took} times')
    # int8 scores bit for bit: with one key the softmax weight is 1 and
    # lse = ln2 * score, in float32 on both sides.
    q = randn(torch, (b, 8, 64, 64), gen, dev, bf16)
    k = randn(torch, (b, 8, 1, 64), gen, dev, bf16)
    lse = fa.flash_attention_with_lse(q, k, k, qk_quant='int8')[1]
    lse_p = fa.flash_attention_plain_lse(q, k, k, qk_quant='int8')[1]
    same = bool(torch.equal(lse, lse_p))
    emit({'phase': 'flash_masks', 'case': 'int8_scores_exact',
          'exactly_equal': same,
          'max_abs_err': (lse - lse_p).abs().max().item()})
    if not same:
        failures.append('int8 scores differ from the plain version')
    check(not failures, '; '.join(failures))
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


# W = 4 ranks of the sequence-parallel phase, all on card 0 over gloo
# (host-staged collectives) unless there is a card per rank (NCCL).
SP_RANKS = 4
SP_LABEL = f'{SP_RANKS} ranks on one card, gloo'
SP_STEPS = 3
SP_CHECK_B, SP_CHECK_T = 2, 2048    # distributed vs local, W = 4
# Distributed vs the local module, W = 4, per tensor (rows as above;
# weight gradients whole-tensor). The float32 'full' path differs only by
# float32 summation order over 2048..8192 terms (~1e-6): 1e-4. The bf16
# kernel paths round the same values to bf16 at different points on the
# two sides: the ring's per-fold softmax weights and its float32 merge,
# the bf16 sum of four ranks' cotangents in the gathers' reduce-scatter,
# the bf16 output of each rank's weight-gradient GEMM before the float32
# sum over ranks. One such rounding moves a tensor by up to 2^-9 relative
# (the composition weight's gradient, rounded once more on one side,
# reads 2.3e-3 whole); a gradient chain holds at most four of them in
# series: whole 4 * 2^-9 ~ 8e-3, a row 2.5x that (the kernels' own
# row-to-whole ratio above).
SP_TOL_F32 = 1e-4
SP_TOL_BF16_ROW, SP_TOL_BF16 = 2e-2, 8e-3
# (name, softmax_impl, flash_softmax_mode, causal): the configurations of
# dryrun_multichip's strategies, the bounded flash mode and a causal ring.
SP_CONFIGS = (('full', 'full', 'exact', False),
              ('flash', 'flash', 'exact', False),
              ('online', 'online', 'exact', False),
              ('flash_bounded', 'flash', 'bounded', False),
              ('ulysses', 'ulysses', 'exact', False),
              ('online_causal', 'online', 'exact', True))
SP_KERNELS = ('flash_attention', 'flash_attention_bounded',
              'flash_attention_dq', 'flash_attention_dkv')


def sp_expected(name, seq_rank, seq):
    """Launches per train step of (K1, K2, K3, K4) on a rank: one forward
    and one backward per step; the ring folds W blocks (rank + 1 under
    causal masking: the rest lie in its future)."""
    if name == 'full':
        return (0, 0, 0, 0)
    if name.startswith('online'):
        folds = seq_rank + 1 if name.endswith('causal') else seq
        return (folds, 0, folds, folds)
    if name == 'flash_bounded':
        return (0, 1, 1, 1)
    return (1, 0, 1, 1)


def _sp_module(torch, ddp, impl, mode, causal, dev, seed=0):
    kernel_path = impl != 'full'
    return ddp.DistributedDotProductAttn(
        key_dim=SP_DIM, num_heads=SP_HEADS, offset=SP_OFFSET,
        softmax_impl=impl, flash_softmax_mode=mode, causal=causal,
        dtype=torch.bfloat16 if kernel_path else torch.float32, device=dev,
        generator=torch.Generator().manual_seed(seed))


def _sp_wall_ms(torch, ddp, fn, group=None, reps=3):
    """Median wall time of ``fn`` over ``reps`` calls on every rank at
    once (a barrier before each; the card synchronised around it): the
    collectives are host-staged, so the host's clock is the honest one."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        ddp.synchronize(group)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _sp_run(torch, ddp, rank, dev):
    """One rank's part of the seq_parallel phase; returns its numbers."""
    import importlib
    comm = importlib.import_module(
        'distributed_dot_product_tpu_torch.utils.comm')
    res = {'rank': rank, 'transport': comm.transport(None, dev)}
    world = comm.get_world_size()

    # entry(): the flagship module, B 1 x T 1024, all-False mask, 'full',
    # forward at W = 1 (rank 0 alone) and W = 4.
    model = _sp_module(torch, ddp, 'full', 'exact', False, dev)
    x = torch.ones((1, 1024, SP_DIM), device=dev)
    mask = torch.zeros((1, 1024, 1024), dtype=torch.bool, device=dev)
    mesh1, mesh4 = ddp.seq_mesh(1), ddp.seq_mesh(world)
    with torch.no_grad():
        if rank == 0:
            out1 = ddp.apply_seq_parallel(model, mesh1, x, x, x, mask)
        out4 = ddp.apply_seq_parallel(model, mesh4, x, x, x, mask)
        res['entry'] = {
            'shape': list(out4.shape),
            'finite': bool(torch.isfinite(out4).all().item()),
            'ms_w4': _sp_wall_ms(torch, ddp, lambda: ddp.apply_seq_parallel(
                model, mesh4, x, x, x, mask))}
        if rank == 0:
            res['entry']['w4_vs_w1_max_rel'] = (
                (out4 - out1).abs().max() / out1.abs().max()).item()
            res['entry']['ms_w1'] = _sp_wall_ms(
                torch, ddp, lambda: ddp.apply_seq_parallel(
                    model, mesh1, x, x, x, mask), group=mesh1.seq_group)
    del model, out4

    # nt / all / tn at the flagship's widths: (B 2, 8 heads, T 8192) over
    # the W = 4 sequence shards, float32 as on the 'full' path.
    gen = torch.Generator().manual_seed(100 + rank)
    tn_local = SP_T // world
    a = randn(torch, (2, SP_HEADS, tn_local, SP_HEAD_DIM), gen, dev,
              torch.float32)
    b = randn(torch, (2, SP_HEADS, tn_local, SP_HEAD_DIM), gen, dev,
              torch.float32)
    with torch.no_grad():
        scores = ddp.distributed_matmul_nt(a, b, SP_OFFSET)
        res['matmuls'] = {
            'nt_ms': _sp_wall_ms(torch, ddp, lambda: ddp.distributed_matmul_nt(
                a, b, SP_OFFSET)),
            'all_ms': _sp_wall_ms(torch, ddp, lambda: ddp.distributed_matmul_all(
                scores, b, SP_OFFSET)),
            'tn_ms': _sp_wall_ms(torch, ddp, lambda: ddp.distributed_matmul_tn(
                scores, b)),
            'scores_shape': list(scores.shape)}
    del a, b, scores
    torch.cuda.empty_cache()

    # Distributed (W = 4) vs the local module on the gathered tensors.
    from distributed_dot_product_tpu_torch.utils.comm import all_reduce
    gen = torch.Generator().manual_seed(7)      # the same on every rank
    xs = [randn(torch, (SP_CHECK_B, SP_CHECK_T, SP_DIM), gen, dev,
                torch.float32) for _ in range(4)]
    cmask = (torch.rand((SP_CHECK_B, SP_CHECK_T, SP_CHECK_T), generator=gen)
             < 0.3).to(dev)
    res['vs_local'] = {}
    for name, impl, mode, causal in SP_CONFIGS:
        mod = _sp_module(torch, ddp, impl, mode, causal, dev)
        shards = [ddp.shard_seq(t, mesh4).clone().requires_grad_()
                  for t in xs[:3]]
        out = mod(*shards, ddp.shard_seq(cmask, mesh4), group=None)
        (out.float() * ddp.shard_seq(xs[3], mesh4)).sum().backward()
        got = {'out': ddp.unshard_seq(out, mesh4)}
        for n, t in zip(('d_keys', 'd_queries', 'd_values'), shards):
            got[n] = ddp.unshard_seq(t.grad, mesh4)
        pgrads = {n: all_reduce(p.grad) for n, p in mod.named_parameters()}
        if rank == 0:
            local = _sp_module(torch, ddp, impl, mode, causal, dev)
            local.distributed = False
            gx = [t.clone().requires_grad_() for t in xs[:3]]
            ref = local(*gx, cmask)
            (ref.float() * xs[3]).sum().backward()
            want = {'out': ref, 'd_keys': gx[0].grad, 'd_queries': gx[1].grad,
                    'd_values': gx[2].grad}
            errs = {n: rel_errs(torch, got[n], want[n]) for n in want}
            for n, p in local.named_parameters():
                whole = (torch.linalg.vector_norm(pgrads[n].float()
                                                  - p.grad.float())
                         / torch.linalg.vector_norm(p.grad.float())).item()
                errs[n] = (whole, whole)
            res['vs_local'][name] = errs
            del local, ref, gx
        del mod, out, shards, got, pgrads
        torch.cuda.empty_cache()
    del xs, cmask

    # The DP x SP train step on a 2 x 2 group: global B 4 x T 8192,
    # all-False mask, MSE against zeros, Adam 1e-3, SP_STEPS steps.
    mesh = ddp.data_seq_mesh(SP_DATA, SP_SEQ)
    res['seq_rank'], res['data_rank'] = mesh.seq_rank, mesh.data_rank
    res['seq_transport'] = comm.transport(mesh.seq_group, dev)
    gen = torch.Generator().manual_seed(3)
    x = randn(torch, (SP_B, SP_T, SP_DIM), gen, dev, torch.float32)
    batch = (x, x, x, torch.zeros((SP_B, SP_T, SP_T), dtype=torch.bool,
                                  device=dev), torch.zeros_like(x))
    counters = [getattr(ddp, n) for n in SP_KERNELS]
    res['train'] = {}
    for name, impl, mode, causal in SP_CONFIGS:
        mod = _sp_module(torch, ddp, impl, mode, causal, dev, seed=1)
        opt = torch.optim.Adam(mod.parameters(), lr=1e-3)
        step = ddp.make_train_step(mod, opt, mesh, data_axis='data')
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for fn in counters:
            fn.launches = 0
        losses, ms, per_step = [], [], []
        for _ in range(SP_STEPS):
            before = [fn.launches for fn in counters]
            torch.cuda.synchronize()
            ddp.synchronize()
            t0 = time.perf_counter()
            loss = step(batch).item()
            ms.append(1e3 * (time.perf_counter() - t0))
            losses.append(loss)
            per_step.append([fn.launches - b for fn, b in
                             zip(counters, before)])
        res['train'][name] = {
            'losses': losses, 'step_ms': ms,
            'launches_per_step': per_step,
            'launches': [fn.launches for fn in counters],
            'expected_per_step': list(sp_expected(name, mesh.seq_rank,
                                                  SP_SEQ)),
            'max_memory_allocated': torch.cuda.max_memory_allocated(dev)}
        del mod, opt, step
        torch.cuda.empty_cache()
    return res


def _sp_worker(rank, world, init_method, backend, results, run='_sp_run'):
    """A rank of a multi-rank phase: joins the group, runs ``run`` (the
    name of :func:`_sp_run` or :func:`_flagship_run`), and reports its
    numbers or its traceback."""
    import traceback
    try:
        import torch
        import distributed_dot_product_tpu_torch as ddp
        torch.set_num_threads(2)
        dev = torch.device('cuda', rank if backend == 'nccl' else 0)
        torch.cuda.set_device(dev)
        ddp.init(backend, init_method, world, rank)
        results.put((rank, True, globals()[run](torch, ddp, rank, dev)))
    except Exception:
        # Reported to the parent, which fails the phase; the rank dies.
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def _spawn_ranks(torch, phase, run, timeout):
    """SP_RANKS processes running ``run``, on card 0 over gloo (host-staged
    collectives) unless there is a card per rank (NCCL): ``(results by
    rank, seconds, backend)``. A rank that fails, or the phase timing
    out, fails the phase; every process is stopped either way."""
    import multiprocessing as mp
    import queue
    import socket
    torch.cuda.empty_cache()
    backend = 'nccl' if torch.cuda.device_count() >= SP_RANKS else 'gloo'
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context('spawn')
    results = ctx.Queue()
    procs = [ctx.Process(target=_sp_worker, daemon=True,
                         args=(r, SP_RANKS, f'tcp://localhost:{port}',
                               backend, results, run))
             for r in range(SP_RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    ranks = {}
    try:
        while len(ranks) < SP_RANKS:
            left = timeout - (time.perf_counter() - t0)
            try:
                rank, ok, value = results.get(timeout=max(left, 1))
            except queue.Empty:
                raise PhaseError(f'{phase}: ranks '
                                 f'{sorted(set(range(SP_RANKS)) - set(ranks))}'
                                 f' did not finish within {timeout} s')
            check(ok, f'{phase} rank {rank} failed:\n{value}')
            ranks[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return ranks, time.perf_counter() - t0, backend


def phase_seq_parallel(torch, ddp, timeout=600):
    """W = 4 ranks of the sequence-parallel layer, spawned after the
    kernels are built: entry() at W = 1 and 4, nt / all / tn, each
    strategy against the local module, and SP_STEPS DP x SP train steps
    per strategy with launch counts. A rank that fails or the phase
    timing out fails the phase."""
    ranks, seconds, backend = _spawn_ranks(torch, 'seq_parallel', '_sp_run',
                                           timeout)
    r0 = ranks[0]
    label = (SP_LABEL if backend == 'gloo'
             else f'{SP_RANKS} ranks on {SP_RANKS} cards, nccl')
    base = {'phase': 'seq_parallel', 'ranks': SP_RANKS, 'label': label,
            'transport': r0['transport']}
    failures = []
    entry = r0['entry']
    emit({**base, 'case': 'entry', 'module': {
        'key_dim': SP_DIM, 'num_heads': SP_HEADS, 'offset': SP_OFFSET,
        'softmax_impl': 'full'}, 'batch': [1, 1024], **entry,
        'ms_w4_by_rank': [ranks[r]['entry']['ms_w4'] for r in sorted(ranks)],
        'tol': SP_TOL_F32})
    if not all(ranks[r]['entry']['finite'] for r in ranks):
        failures.append('entry: non-finite output')
    if not entry['w4_vs_w1_max_rel'] <= SP_TOL_F32:
        failures.append(f'entry: W=4 vs W=1 rel err '
                        f'{entry["w4_vs_w1_max_rel"]} > {SP_TOL_F32}')
    emit({**base, 'case': 'matmuls', 'offset': SP_OFFSET,
          'shard': [2, SP_HEADS, SP_T // SP_RANKS, SP_HEAD_DIM],
          'dtype': 'float32', **r0['matmuls'],
          'by_rank': {k: [ranks[r]['matmuls'][k] for r in sorted(ranks)]
                      for k in ('nt_ms', 'all_ms', 'tn_ms')}})
    for name, impl, mode, causal in SP_CONFIGS:
        errs = r0['vs_local'][name]
        emit({**base, 'case': 'vs_local', 'strategy': name,
              'batch': [SP_CHECK_B, SP_CHECK_T], 'mask': 'random 30%',
              'max_row_rel_err': {n: e[0] for n, e in errs.items()},
              'rel_err': {n: e[1] for n, e in errs.items()},
              'tol': ({'row_rel': SP_TOL_F32, 'rel': SP_TOL_F32}
                      if impl == 'full' else
                      {'row_rel': SP_TOL_BF16_ROW, 'rel': SP_TOL_BF16})})
        for n, (row, whole) in errs.items():
            lim_row, lim = ((SP_TOL_F32, SP_TOL_F32) if impl == 'full'
                            else (SP_TOL_BF16_ROW, SP_TOL_BF16))
            if not (row <= lim_row and whole <= lim):
                failures.append(f'{name} vs local {n}: row {row}, whole '
                                f'{whole} > ({lim_row}, {lim})')
    launches = {}
    for name, impl, mode, causal in SP_CONFIGS:
        runs = {r: ranks[r]['train'][name] for r in sorted(ranks)}
        t0r = runs[0]
        emit({**base, 'case': 'train', 'strategy': name,
              'mesh': {'data': SP_DATA, 'seq': SP_SEQ},
              'seq_transport': r0['seq_transport'],
              'batch': [SP_B, SP_T], 'module': {
                  'key_dim': SP_DIM, 'num_heads': SP_HEADS,
                  'offset': SP_OFFSET, 'softmax_impl': impl,
                  'flash_softmax_mode': mode, 'causal': causal,
                  'compute': 'float32' if impl == 'full' else 'bfloat16'},
              'optimizer': 'adam 1e-3', 'losses': t0r['losses'],
              'step_ms_rank0': t0r['step_ms'],
              'ms_per_step_median': statistics.median(
                  max(runs[r]['step_ms'][i] for r in runs)
                  for i in range(SP_STEPS)),
              'kernels': list(SP_KERNELS),
              'launches_per_step': {r: runs[r]['launches_per_step']
                                    for r in runs},
              'expected_per_step': {r: runs[r]['expected_per_step']
                                    for r in runs},
              'max_memory_allocated': {r: runs[r]['max_memory_allocated']
                                       for r in runs}})
        for r, run in runs.items():
            if not all(math.isfinite(v) for v in run['losses']):
                failures.append(f'{name} rank {r}: non-finite loss')
            want = run['expected_per_step']
            for i, got in enumerate(run['launches_per_step']):
                if got != want:
                    failures.append(f'{name} rank {r} step {i + 1}: '
                                    f'launched {got}, want {want}')
        if len({tuple(runs[r]['losses']) for r in runs}) != 1:
            failures.append(f'{name}: ranks report different losses')
        launches[name] = dict(zip(SP_KERNELS, t0r['launches']))
    if launches['flash_bounded']['flash_attention_bounded'] < 1:
        failures.append('flash_bounded: K2 never launched')
    emit({**base, 'case': 'summary', 'seconds': seconds,
          'backend': backend})
    check(not failures, '; '.join(failures))
    return launches


# The flagship recipe's stages beyond the strategies (dryrun_multichip's
# window, gqa_ring, stack and lm) at full width on the 2 x 2 group, global
# B 4 x T 8192, 3 steps each, Adam 1e-3 (the stack at the README's 3e-4:
# at width 768 Adam's first 1e-3 step overshoots — its loss rose 1.91 ->
# 3.67 -> 2.38 on the card, and the same on the CPU in float32), MSE
# against zeros for the module stages; then greedy generation from the
# trained LM on rank 0.
FS_STEPS, FS_WINDOW, FS_RATE = 3, 2048, 0.1
FS_LR = {'window': 1e-3, 'gqa_ring': 1e-3, 'stack': LR, 'lm': 1e-3}
FS_GEN_PROMPT, FS_GEN_STEPS, FS_GEN_T_MAX = 4, 3, 128
FS_STAGES = ('window', 'gqa_ring', 'stack', 'lm')
FS_KERNELS = ('flash_attention', 'flash_attention_dq', 'flash_attention_dkv')


def fs_expected(stage, seq_rank):
    """Launches per train step of (K1, K3, K4) on a rank: the flash
    stages one per attention layer (the LM's remat recomputes each
    forward once more); the causal ring folds seq rank + 1 blocks — the
    wholly cross-segment fold of rank 1 included: it is skipped inside
    the kernel, not on the host."""
    if stage == 'gqa_ring':
        return (seq_rank + 1,) * 3
    if stage == 'stack':
        return (2, 2, 2)
    if stage == 'lm':
        return (2 * LAYERS, LAYERS, LAYERS)
    return (1, 1, 1)


def _fs_segments(torch, b, t, dev):
    """The recipe's packed layout: two documents a row, positions
    ``arange(T)·2 // T``."""
    return (torch.arange(t, device=dev) * 2 // t).to(torch.int32).expand(
        b, t).contiguous()


def _fs_module(torch, ddp, stage, dev, **over):
    gen = torch.Generator().manual_seed(5)
    bf16 = torch.bfloat16
    if stage == 'stack':
        return ddp.TransformerStack(
            DIM, HEADS, n_layers=2, dtype=bf16, device=dev, generator=gen,
            attn_kwargs=dict(causal=True, softmax_impl='flash',
                             use_rope=True))
    if stage == 'lm':
        return ddp.TransformerLM(VOCAB, DIM, HEADS, n_layers=LAYERS,
                                 dtype=bf16, remat=True, device=dev,
                                 generator=gen)
    kw = dict(key_dim=SP_DIM, num_heads=SP_HEADS, causal=True, dtype=bf16,
              device=dev, generator=gen)
    if stage == 'window':
        kw.update(softmax_impl='flash', window=FS_WINDOW)
    else:
        kw.update(num_kv_heads=SP_HEADS // 2, use_rope=True,
                  softmax_impl='online', qk_quant='int8',
                  dropout_rate=FS_RATE)
    kw.update(over)
    return ddp.DistributedDotProductAttn(**kw)


def _flagship_run(torch, ddp, rank, dev):
    """One rank's part of the flagship phase; returns its numbers."""
    import importlib
    comm = importlib.import_module(
        'distributed_dot_product_tpu_torch.utils.comm')
    train = importlib.import_module('distributed_dot_product_tpu_torch.train')
    res = {'rank': rank, 'transport': comm.transport(None, dev)}
    world = comm.get_world_size()

    # window and gqa_ring at W = 4 against the local module, with the
    # segments and the dropout of the stage (the same global-coordinate
    # mask on both sides).
    mesh4 = ddp.seq_mesh(world)
    gen = torch.Generator().manual_seed(7)      # the same on every rank
    xs = [randn(torch, (SP_CHECK_B, SP_CHECK_T, SP_DIM), gen, dev,
                torch.float32) for _ in range(4)]
    seg = _fs_segments(torch, SP_CHECK_B, SP_CHECK_T, dev)
    res['vs_local'] = {}
    for stage in ('window', 'gqa_ring'):
        mod = _fs_module(torch, ddp, stage, dev)
        local = _fs_module(torch, ddp, stage, dev, distributed=False)
        shards = [ddp.shard_seq(t, mesh4).clone().requires_grad_()
                  for t in xs[:3]]
        kw = dict(dropout_seed=3)
        sseg = ddp.shard_seq(seg, mesh4, seq_axis=-1)
        out = mod(*shards, None, sseg if stage == 'gqa_ring' else None,
                  group=None, **kw)
        (out.float() * ddp.shard_seq(xs[3], mesh4)).sum().backward()
        got = {'out': ddp.unshard_seq(out, mesh4)}
        for n, t in zip(('d_keys', 'd_queries', 'd_values'), shards):
            got[n] = ddp.unshard_seq(t.grad, mesh4)
        pgrads = {n: comm.all_reduce(p.grad) for n, p in
                  mod.named_parameters()}
        if rank == 0:
            gx = [t.clone().requires_grad_() for t in xs[:3]]
            ref = local(*gx, None, seg if stage == 'gqa_ring' else None, **kw)
            (ref.float() * xs[3]).sum().backward()
            want = {'out': ref, 'd_keys': gx[0].grad,
                    'd_queries': gx[1].grad, 'd_values': gx[2].grad}
            errs = {n: rel_errs(torch, got[n], want[n]) for n in want}
            for n, p in local.named_parameters():
                whole = (torch.linalg.vector_norm(pgrads[n].float()
                                                  - p.grad.float())
                         / torch.linalg.vector_norm(p.grad.float())).item()
                errs[n] = (whole, whole)
            res['vs_local'][stage] = errs
        del mod, local, out, shards, got, pgrads
        torch.cuda.empty_cache()
    del xs

    # The stages' DP x SP train steps on the 2 x 2 group.
    mesh = ddp.data_seq_mesh(SP_DATA, SP_SEQ)
    res['seq_rank'], res['data_rank'] = mesh.seq_rank, mesh.data_rank
    gen = torch.Generator().manual_seed(3)
    seg = _fs_segments(torch, SP_B, SP_T, dev)
    counters = [getattr(ddp, n) for n in FS_KERNELS]
    res['train'] = {}
    for stage in FS_STAGES:
        model = _fs_module(torch, ddp, stage, dev)
        opt = torch.optim.Adam(model.parameters(), lr=FS_LR[stage])
        if stage == 'lm':
            tokens = torch.randint(0, VOCAB, (SP_B, SP_T),
                                   generator=gen).to(dev)
            batch = (tokens, ddp.lm_targets(tokens, seg), seg)
            step = ddp.make_lm_train_step(model, opt, mesh, data_axis='data',
                                          loss_chunk=LOSS_CHUNK)
        else:
            width = DIM if stage == 'stack' else SP_DIM
            x = randn(torch, (SP_B, SP_T, width), gen, dev, torch.float32)
            batch = (x, x, x, None, torch.zeros_like(x))
            if stage == 'gqa_ring':
                batch += (seg,)
            step = ddp.make_train_step(model, opt, mesh, data_axis='data')
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        losses, ms, per_step = [], [], []
        for i in range(FS_STEPS):
            for fn in counters:
                fn.launches = 0
            torch.cuda.synchronize()
            ddp.synchronize()
            t0 = time.perf_counter()
            loss = step(batch, dropout_seed=i).item()
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            per_step.append([fn.launches for fn in counters])
            losses.append(loss)
        # The step's host-staged gradient all-reduce over both groups,
        # timed alone on the last step's gradients.
        params = [p for p in model.parameters() if p.grad is not None]
        torch.cuda.synchronize()
        ddp.synchronize()
        t0 = time.perf_counter()
        train._sum_grads(params, [mesh.seq_group, mesh.data_group])
        torch.cuda.synchronize()
        reduce_ms = 1e3 * (time.perf_counter() - t0)
        run = {'losses': losses, 'step_ms': ms, 'launches_per_step': per_step,
               'expected_per_step': list(fs_expected(stage, mesh.seq_rank)),
               'grad_reduce_ms': reduce_ms,
               'max_memory_allocated': torch.cuda.max_memory_allocated(dev),
               'params': sum(p.numel() for p in model.parameters())}
        if stage == 'lm' and rank == 0:
            ddp.flash_attention.launches = ddp.flash_decode.launches = 0
            prompt = batch[0][:, :FS_GEN_PROMPT]
            t0 = time.perf_counter()
            out = ddp.greedy_generate(model, prompt, FS_GEN_STEPS,
                                      FS_GEN_T_MAX)
            torch.cuda.synchronize()
            run['generate'] = {
                'shape': list(out.shape), 'tokens': out.tolist(),
                'in_vocab': bool(((out >= 0) & (out < VOCAB)).all().item()),
                'ms': 1e3 * (time.perf_counter() - t0),
                'launches': {'flash_attention': ddp.flash_attention.launches,
                             'flash_decode': ddp.flash_decode.launches}}
        res['train'][stage] = run
        del model, opt, step, batch
        torch.cuda.empty_cache()
    return res


def phase_flagship(torch, ddp, timeout=900):
    """dryrun_multichip's window, gqa_ring, stack and lm stages on a 2 x 2
    data x seq group of 4 ranks (on one card over gloo, host-staged, as
    seq_parallel), at full width: ms per step, losses (finite, equal on
    every rank, falling for the module stages), launches per step against
    the fold counts, peak memory; window and gqa_ring at W = 4 against
    the local module; greedy generation from the trained LM."""
    ranks, seconds, backend = _spawn_ranks(torch, 'flagship',
                                           '_flagship_run', timeout)
    r0 = ranks[0]
    label = (SP_LABEL if backend == 'gloo'
             else f'{SP_RANKS} ranks on {SP_RANKS} cards, nccl')
    base = {'phase': 'flagship', 'ranks': SP_RANKS, 'label': label,
            'transport': r0['transport']}
    failures = []
    for stage, errs in r0['vs_local'].items():
        emit({**base, 'case': 'vs_local', 'stage': stage,
              'batch': [SP_CHECK_B, SP_CHECK_T],
              'max_row_rel_err': {n: e[0] for n, e in errs.items()},
              'rel_err': {n: e[1] for n, e in errs.items()},
              'tol': {'row_rel': SP_TOL_BF16_ROW, 'rel': SP_TOL_BF16}})
        for n, (row, whole) in errs.items():
            if not (row <= SP_TOL_BF16_ROW and whole <= SP_TOL_BF16):
                failures.append(f'{stage} vs local {n}: row {row}, whole '
                                f'{whole} > ({SP_TOL_BF16_ROW}, '
                                f'{SP_TOL_BF16})')
    launches = {}
    for stage in FS_STAGES:
        runs = {r: ranks[r]['train'][stage] for r in sorted(ranks)}
        t0r = runs[0]
        emit({**base, 'case': 'train', 'stage': stage,
              'mesh': {'data': SP_DATA, 'seq': SP_SEQ},
              'batch': [SP_B, SP_T], 'params': t0r['params'],
              'optimizer': f'adam {FS_LR[stage]}', 'losses': t0r['losses'],
              'step_ms_rank0': t0r['step_ms'],
              'ms_per_step_median': statistics.median(
                  max(runs[r]['step_ms'][i] for r in runs)
                  for i in range(FS_STEPS)),
              'grad_reduce_ms': {r: runs[r]['grad_reduce_ms'] for r in runs},
              'kernels': list(FS_KERNELS),
              'launches_per_step': {r: runs[r]['launches_per_step']
                                    for r in runs},
              'expected_per_step': {r: runs[r]['expected_per_step']
                                    for r in runs},
              'max_memory_allocated': {r: runs[r]['max_memory_allocated']
                                       for r in runs}})
        for r, run in runs.items():
            if not all(math.isfinite(v) for v in run['losses']):
                failures.append(f'{stage} rank {r}: non-finite loss')
            for i, got in enumerate(run['launches_per_step']):
                if got != run['expected_per_step']:
                    failures.append(f'{stage} rank {r} step {i + 1}: '
                                    f'launched {got}, want '
                                    f'{run["expected_per_step"]}')
        if len({tuple(runs[r]['losses']) for r in runs}) != 1:
            failures.append(f'{stage}: ranks report different losses')
        if stage != 'lm' and not t0r['losses'][-1] < t0r['losses'][0]:
            failures.append(f'{stage}: loss did not fall '
                            f'({t0r["losses"]})')
        launches[stage] = {n: sum(s[i] for s in t0r['launches_per_step'])
                           for i, n in enumerate(FS_KERNELS)}
    gen = r0['train']['lm']['generate']
    emit({**base, 'case': 'greedy_generate', 'prompt': FS_GEN_PROMPT,
          'steps': FS_GEN_STEPS, 't_max': FS_GEN_T_MAX, **gen})
    if gen['shape'] != [SP_B, FS_GEN_STEPS] or not gen['in_vocab']:
        failures.append(f'greedy_generate returned {gen["shape"]} '
                        f'(in vocab: {gen["in_vocab"]})')
    emit({**base, 'case': 'summary', 'seconds': seconds, 'backend': backend})
    check(not failures, '; '.join(failures))
    return launches


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

    only = None
    if '--phases' in sys.argv:
        only = set(sys.argv[sys.argv.index('--phases') + 1].split(','))

    def want(name):
        return only is None or name in only

    phase = 'device'
    res = {}
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
        phases = (
            ('flash_attention', lambda: phase_flash(torch, ddp, flush, gen)),
            ('flash_decode', lambda: phase_decode(torch, ddp, flush, gen)),
            ('flash_decode_paged',
             lambda: phase_decode_paged(torch, ddp, flush, gen)),
            ('serve_path', lambda: phase_serve_path(torch, ddp)),
            ('flash_backward',
             lambda: phase_flash_backward(torch, ddp, flush, gen)),
            ('flash_features',
             lambda: phase_flash_features(torch, ddp, flush, gen)),
            ('flash_masks',
             lambda: phase_flash_masks(torch, ddp, flush, gen)),
            ('main_path', lambda: phase_main_path(torch, ddp)),
            ('train_path', lambda: phase_train_path(torch, ddp)),
            ('train_cpu_reference',
             lambda: phase_train_cpu_reference(torch, ddp)),
            ('seq_parallel', lambda: phase_seq_parallel(torch, ddp)),
            ('flagship', lambda: phase_flagship(torch, ddp)))
        for phase, run in phases:
            if want(phase):
                res[phase] = run()
            if phase == 'flash_masks':
                del flush
                torch.cuda.empty_cache()
    except Exception as exc:   # report the failed phase, then fail
        emit({'phase': phase, 'ok': False,
              'error': f'{type(exc).__name__}: {exc}'})
        raise
    if only is not None:       # a partial run prints no result line
        print(smi, flush=True)
        emit({'phases_run': sorted(res)})
        return 0
    k1, k5, k5p = (res['flash_attention'], res['flash_decode'],
                   res['flash_decode_paged'])
    serve_path_launches = res['serve_path']
    bwd_err, bwd_time = res['flash_backward']
    feat_err, feat_time = res['flash_features']
    mask_err, mask_time = res['flash_masks']
    serve_launches = res['main_path']
    train_launches = res['train_path']
    sp = res['seq_parallel']
    fs = res['flagship']

    # K1, K3, K4: launches on the training path (beside them the serving
    # path's and each sequence-parallel strategy's, rank 0 over its
    # SP_STEPS train steps), times at the training shape. K2: launches on
    # the bounded flash train steps, times at the flagship's fold shape
    # (flash_features). K5: launches and times of the greedy serving path
    # (its launches on the slab twin of the scheduler's run beside them).
    # K5p: launches on the scheduler's paged run, times at the serving
    # shape. K1/K3/K4 also carry their segment / window / dropout / int8
    # variants' times (flash_masks, `masks`) and their launches on the
    # flagship stages (rank 0 over FS_STEPS train steps).
    csrc = 'distributed_dot_product_tpu_torch/csrc/'
    tpu = 'distributed_dot_product_tpu/ops/'
    k1_err = max(k1['max_abs_err'], bwd_err['out'], feat_err['out'])

    def sp_paths(kernel):
        return {**{f'seq_parallel_{name}': counts[kernel]
                   for name, counts in sp.items() if counts[kernel]},
                **{f'flagship_{stage}': counts[kernel]
                   for stage, counts in fs.items()
                   if counts.get(kernel)}}
    kernels = [
        dict(name='flash_attention', source=csrc + 'flash_fwd.cu',
             replaces=tpu + 'pallas_attention.py:630',
             launches=train_launches['flash_attention'],
             launches_by_path={
                 'serve': serve_launches['flash_attention'],
                 'train': train_launches['flash_attention'],
                 **sp_paths('flash_attention')},
             max_abs_err=k1_err, lse_max_abs_err=max(bwd_err['lse'],
                                                     feat_err['lse']),
             max_row_rel_err=max(k1['max_row_rel_err'],
                                 bwd_err['out_row_rel']),
             masked_fold=feat_time['flash_attention'],
             masks=mask_time['flash_attention'],
             masks_max_abs_err={n: mask_err[n] for n in ('out', 'lse')},
             **bwd_time['flash_attention']),
        dict(name='flash_attention_bounded', source=csrc + 'flash_fwd.cu',
             replaces=tpu + 'pallas_attention.py:1151',
             launches=sp['flash_bounded']['flash_attention_bounded'],
             launches_by_path=sp_paths('flash_attention_bounded'),
             max_abs_err=feat_err['bounded'],
             **feat_time['flash_attention_bounded']),
        dict(name='flash_attention_dq', source=csrc + 'flash_bwd.cu',
             replaces=tpu + 'pallas_attention.py:1228',
             launches=train_launches['flash_attention_dq'],
             launches_by_path={
                 'train': train_launches['flash_attention_dq'],
                 **sp_paths('flash_attention_dq')},
             max_abs_err=max(bwd_err['dq'], feat_err['dq']),
             max_row_rel_err=bwd_err['dq_row_rel'],
             masked_fold_f32=feat_time['flash_attention_dq'],
             masks=mask_time['flash_attention_dq'],
             masks_max_abs_err={n: mask_err[n] for n in ('dq', 'dq_f32')},
             **bwd_time['flash_attention_dq']),
        dict(name='flash_attention_dkv', source=csrc + 'flash_bwd.cu',
             replaces=tpu + 'pallas_attention.py:1319',
             launches=train_launches['flash_attention_dkv'],
             launches_by_path={
                 'train': train_launches['flash_attention_dkv'],
                 **sp_paths('flash_attention_dkv')},
             max_abs_err=max(bwd_err['dk'], bwd_err['dv'], feat_err['dk'],
                             feat_err['dv']),
             max_row_rel_err=max(bwd_err['dk_row_rel'],
                                 bwd_err['dv_row_rel']),
             masked_fold_f32=feat_time['flash_attention_dkv'],
             masks=mask_time['flash_attention_dkv'],
             masks_max_abs_err={n: mask_err[n] for n in
                                ('dk', 'dv', 'dk_f32', 'dv_f32')},
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
        for extra in ('masked_fold', 'masked_fold_f32'):
            if extra in entry:
                entry[extra] = {k: v for k, v in entry[extra].items()
                                if k not in ('flops', 'bytes')}
    print(smi, flush=True)
    emit({'kernels': kernels})
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                 'count': count}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
