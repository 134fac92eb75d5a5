#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""
Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, one JSON line each:

1. device: the card, torch and CUDA versions;
2. build: compiles every kernel of the serving path from ``csrc/``;
3. K1 (flash-attention forward) against its plain PyTorch version at the
   prefill shape, at ragged shapes with a causal offset (one with GQA)
   and at a ragged shape without causal masking, in bf16;
4. K5 (fused decode step) against its plain version at the decode shape
   with mixed per-row fill: the appended cache must equal the plain
   append bit for bit, the output must agree within tolerance;
5. the main path: greedy generation of the full-width TransformerLM
   (vocab 32768, dim 768, 8 heads, 16 layers, bf16, seeded random
   weights) for 4 prompts of 1000 tokens, 64 steps, t_max 2048, with the
   kernel launch counts of that run, then prompt 0 against the same
   weights run on the CPU in float32 (plain versions).

Then the card's ``nvidia-smi`` name and power limit, the kernels line
(``{"kernels": [...]}``: launches on the main path, max error, kernel /
plain / library / bound times) and, only if every phase passed, the last
line ``{"ok": true, "device": {...}}``. Exits non-zero on any failure,
and without a card.
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

# bf16 kernel vs float32-weight plain version: the kernel rounds the
# softmax weights to bf16 for the tensor-core product (K1) and both round
# the output to bf16, each a relative 2^-8 at most; with unit-normal
# values (|v| < ~5) that stays under 2e-2 absolute.
TOL_BF16 = 2e-2
# Greedy logits of the bf16 model vs the same weights in float32 on the
# CPU, max |Δ| over max |logit| at prompt 0's last position.
TOL_LM_REL = 0.1


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
    results, worst = {}, 0.0
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
        row = {'phase': 'flash_attention', 'case': name,
               'q': list(q.shape), 'kv': list(k.shape), 'causal': causal,
               'causal_offset': off,
               'max_abs_err': err, 'tol': TOL_BF16}
        check(torch.isfinite(out).all().item(), f'K1 {name}: non-finite')
        check(err <= TOL_BF16, f'K1 {name}: max abs err {err} > {TOL_BF16}')
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
        emit(row)
    results['max_abs_err'] = worst
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


def phase_main_path(torch, ddp):
    from distributed_dot_product_tpu_torch.models.lm import greedy_generate
    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(0)
    t0 = time.perf_counter()
    model = ddp.TransformerLM(VOCAB, DIM, HEADS, n_layers=LAYERS,
                              dtype=torch.bfloat16, device=dev,
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
        del flush
        phase = 'main_path'
        launches = phase_main_path(torch, ddp)
    except Exception as exc:   # report the failed phase, then fail
        emit({'phase': phase, 'ok': False,
              'error': f'{type(exc).__name__}: {exc}'})
        raise

    kernels = []
    for name, row, src, replaces in (
            ('flash_attention', k1,
             'distributed_dot_product_tpu_torch/csrc/flash_fwd.cu',
             'distributed_dot_product_tpu/ops/pallas_attention.py:630'),
            ('flash_decode', k5,
             'distributed_dot_product_tpu_torch/csrc/flash_decode.cu',
             'distributed_dot_product_tpu/ops/pallas_decode.py:107')):
        kernels.append({
            'name': name, 'route': 'cuda', 'source': src,
            'replaces': replaces, 'launches': launches[name],
            'max_abs_err': row['max_abs_err'], 'ms': row['ms'],
            'plain_ms': row['plain_ms'], 'bound_ms': row['bound_ms'],
            'bound_by': row['bound_by'], 'library_ms': row['library_ms']})
    print(smi, flush=True)
    emit({'kernels': kernels})
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                 'count': count}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
