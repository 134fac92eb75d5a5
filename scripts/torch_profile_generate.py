#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""
Where the time of the PyTorch port's greedy generation goes, on one
CUDA card: the full-width TransformerLM of ``chip_smoke.py`` (vocab
32768, dim 768, 8 heads, 16 layers, bf16 parameters and compute, seeded
random weights), batch
4, prompt 1000, ``t_max`` 2048.

    python3 scripts/torch_profile_generate.py [--steps 16] [--out DIR]

Prints JSON lines:

- ``decode_step``: per cached decode step, the host time (clock around
  ``model.decode`` ending in a synchronise) and the device span (CUDA
  events around the same call), medians over ``--steps`` steps — a host
  time far above the device span means the step is bound by Python and
  launch overhead, not by the card;
- ``profile``: ``torch.profiler`` over ``--steps`` decode steps and one
  prefill: the summed device time of every kernel (by name, top 12), the
  device-busy share of the profiled window, and the host time of the
  top operators. The Chrome trace goes to ``--out`` (default
  ``build/profile/``).
"""

import argparse
import json
import os
import statistics
import sys
import time

VOCAB, DIM, HEADS, LAYERS = 32768, 768, 8, 16
BATCH, PROMPT, T_MAX = 4, 1000, 2048


def emit(obj):
    print(json.dumps(obj), flush=True)


def _device_us(evt):
    for name in ('self_device_time_total', 'self_cuda_time_total'):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--steps', type=int, default=16)
    ap.add_argument('--out', default=os.path.join('build', 'profile'))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print('needs a CUDA card', file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import distributed_dot_product_tpu_torch as ddp
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator().manual_seed(0)
    model = ddp.TransformerLM(VOCAB, DIM, HEADS, n_layers=LAYERS,
                              dtype=torch.bfloat16,
                              param_dtype=torch.bfloat16, device='cuda',
                              generator=gen)
    prompts = torch.randint(0, VOCAB, (BATCH, PROMPT), generator=gen
                            ).to('cuda')
    ddp.greedy_generate(model, prompts, 4, T_MAX)          # warm-up

    with torch.inference_mode():
        caches = model.make_decode_caches(BATCH, T_MAX)
        caches, logits = model.prefill(prompts, caches)
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        host, dev = [], []
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(args.steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            caches, logits = model.decode(tok, caches)
            end.record()
            torch.cuda.synchronize()
            host.append(1e3 * (time.perf_counter() - t0))
            dev.append(start.elapsed_time(end))
            tok = logits[:, -1:].argmax(-1).to(torch.int32)
        emit({'phase': 'decode_step', 'steps': args.steps,
              'host_ms_median': statistics.median(host),
              'device_span_ms_median': statistics.median(dev),
              'card': torch.cuda.get_device_name(0)})

        caches = model.make_decode_caches(BATCH, T_MAX)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            caches, logits = model.prefill(prompts, caches)
            tok = logits[:, -1:].argmax(-1).to(torch.int32)
            for _ in range(args.steps):
                caches, logits = model.decode(tok, caches)
                tok = logits[:, -1:].argmax(-1).to(torch.int32)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)

    events = prof.key_averages()
    # Device-side activity only (kernels, memcpy, memset): an operator's
    # own row also carries the device time of the kernels it launched,
    # which would count them twice.
    kernels = sorted(((e.key, _device_us(e), e.count) for e in events
                      if str(e.device_type).endswith('CUDA')
                      and _device_us(e) > 0), key=lambda r: -r[1])
    busy_us = sum(r[1] for r in kernels)
    host_ops = sorted(((e.key, e.self_cpu_time_total, e.count)
                       for e in events), key=lambda r: -r[1])
    launches = sum(e.count for e in events
                   if e.key in ('cudaLaunchKernel', 'cuLaunchKernel',
                                'cuLaunchKernelEx'))
    emit({'phase': 'profile', 'window': f'prefill + {args.steps} steps',
          'wall_ms': wall_us / 1e3, 'device_busy_ms': busy_us / 1e3,
          'kernel_launch_calls': launches,
          'device_busy_share': busy_us / wall_us,
          'top_device': [{'name': k[:80], 'ms': us / 1e3, 'calls': c}
                         for k, us, c in kernels[:12]],
          'top_host_self': [{'name': k[:80], 'ms': us / 1e3, 'calls': c}
                            for k, us, c in host_ops[:12]]})
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.out, 'generate_trace.json'))
    return 0


if __name__ == '__main__':
    sys.exit(main())
