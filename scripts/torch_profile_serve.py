#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""
Where the time of the PyTorch port's continuous-batching serving goes, on
one CUDA card: ``chip_smoke.py``'s serving configuration (KernelEngine
slots 8, t_max 4096, vocab 32768, 8 heads of 96, bf16, prefill chunk 64,
paged with page size 16; ServeConfig(queue_limit 64, max_new_tokens 256))
draining its seeded burst of 24 requests.

    python3 scripts/torch_profile_serve.py [--cache-mode paged|slab]
                                           [--out DIR]

The burst runs once to warm up, then once under ``torch.profiler``.
Prints JSON lines:

- ``serve_split``: the unprofiled run's wall time, ticks, and the
  scheduler's per-tick split (``serve.device_seconds``: the engine's
  decode and prefill calls timed through the host read of their results;
  ``serve.dispatch_overhead_seconds``: the rest of the tick);
- ``profile``: the profiled run's device-busy share, the summed device
  time of every kernel by name (top 12, K5p's split and merge kernels
  among them) and the host time of the top operators. The Chrome trace
  goes to ``--out`` (default ``build/profile/``).
"""

import argparse
import json
import os
import sys
import time


def emit(obj):
    print(json.dumps(obj), flush=True)


def _device_us(evt):
    for name in ('self_device_time_total', 'self_cuda_time_total'):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def run_burst(torch, engine, burst, registry):
    from distributed_dot_product_tpu_torch.serve import (
        RejectedError, Scheduler, ServeConfig,
    )
    import chip_smoke as cs
    sched = Scheduler(engine, ServeConfig(queue_limit=cs.SERVE_QUEUE,
                                          max_new_tokens=cs.SERVE_NEW),
                      registry=registry, fault_injector=False)
    t0 = time.perf_counter()
    try:
        for i, (rid, prompt) in enumerate(burst):
            try:
                sched.submit(prompt, request_id=rid)
            except RejectedError:
                pass
            if i % 4 == 3:
                sched.step()
        sched.run_until_idle()
        torch.cuda.synchronize()
    finally:
        sched.close()
    return time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--cache-mode', default='paged', choices=('paged', 'slab'))
    ap.add_argument('--out', default=os.path.join('build', 'profile'))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print('needs a CUDA card', file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke as cs
    from distributed_dot_product_tpu_torch.utils.tracing import (
        MetricsRegistry,
    )
    from torch.profiler import ProfilerActivity, profile

    engine = cs.serve_engine(torch, args.cache_mode)
    burst = cs.serve_burst()
    run_burst(torch, engine, burst, MetricsRegistry())        # warm-up
    registry = MetricsRegistry()
    wall = run_burst(torch, engine, burst, registry)
    snap = registry.snapshot()
    hist, counters = snap['histograms'], snap['counters']
    emit({'phase': 'serve_split', 'cache_mode': args.cache_mode,
          'card': torch.cuda.get_device_name(0), 'wall_s': wall,
          'decode_steps': counters['serve.decode_steps'],
          'tokens': counters['serve.tokens_generated'],
          'tokens_per_s': counters['serve.tokens_generated'] / wall,
          'engine_seconds_total': hist['serve.device_seconds']['total_sum'],
          'overhead_seconds_total':
              hist['serve.dispatch_overhead_seconds']['total_sum'],
          'engine_seconds_p50':
              hist['serve.device_seconds']['p50'],
          'overhead_seconds_p50':
              hist['serve.dispatch_overhead_seconds']['p50']})

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_burst(torch, engine, burst, MetricsRegistry())
        wall_us = 1e6 * (time.perf_counter() - t0)
    events = prof.key_averages()
    # Device-side activity only (kernels, memcpy, memset): an operator's
    # own row also carries the device time of the kernels it launched.
    kernels = sorted(((e.key, _device_us(e), e.count) for e in events
                      if str(e.device_type).endswith('CUDA')
                      and _device_us(e) > 0), key=lambda r: -r[1])
    busy_us = sum(r[1] for r in kernels)
    decode_us = sum(r[1] for r in kernels if 'decode_' in r[0])
    host_ops = sorted(((e.key, e.self_cpu_time_total, e.count)
                       for e in events), key=lambda r: -r[1])
    emit({'phase': 'profile', 'cache_mode': args.cache_mode,
          'window': 'one burst', 'wall_ms': wall_us / 1e3,
          'device_busy_ms': busy_us / 1e3,
          'device_busy_share': busy_us / wall_us,
          'decode_kernels_ms': decode_us / 1e3,
          'top_device': [{'name': k[:80], 'ms': us / 1e3, 'calls': c}
                         for k, us, c in kernels[:12]],
          'top_host_self': [{'name': k[:80], 'ms': us / 1e3, 'calls': c}
                            for k, us, c in host_ops[:12]]})
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        args.out, f'serve_{args.cache_mode}_trace.json'))
    return 0


if __name__ == '__main__':
    sys.exit(main())
