#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""
Where the time of the PyTorch port's training step goes, on one CUDA
card: the configuration of ``chip_smoke.py``'s training path — the
full-width TransformerLM (vocab 32768, dim 768, 8 heads, 16 layers,
float32 parameters, bf16 compute, remat, seeded random weights), Adam
3e-4, one batch of 4 x 4096 tokens, ``loss_chunk`` 4096.

    python3 scripts/torch_profile_train.py [--steps 2] [--out DIR]

After two warm-up steps, prints JSON lines:

- ``step``: host time of ``--steps`` steps, each between two
  synchronises (median), and the device span of the same steps (CUDA
  events);
- ``profile``: ``torch.profiler`` over ``--steps`` steps: the device time
  of each kernel class (the port's K1 / K3 / K4, cuBLAS GEMMs, the Adam
  update, everything else), the top 12 kernels by device time, the
  device-busy share of the profiled window and the kernel-launch calls.
  The Chrome trace goes to ``--out`` (default ``build/profile/``).
"""

import argparse
import json
import os
import statistics
import sys
import time

VOCAB, DIM, HEADS, LAYERS = 32768, 768, 8, 16
BATCH, T, LOSS_CHUNK, LR = 4, 4096, 4096, 3e-4

# Kernel classes by the device kernel's name, first match wins.
CLASSES = (('K1 flash_fwd', ('flash_fwd_kernel',)),
           ('K3 flash_bwd_dq', ('flash_bwd_dq_kernel',)),
           ('K4 flash_bwd_dkv', ('flash_bwd_dkv_kernel',)),
           ('gemm (cuBLAS)', ('gemm', 'xmma', 'nvjet', 'cutlass')),
           ('adam', ('adam', 'Adam')))


def emit(obj):
    print(json.dumps(obj), flush=True)


def _device_us(evt):
    for name in ('self_device_time_total', 'self_cuda_time_total'):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def _class(name):
    for label, keys in CLASSES:
        if any(key in name for key in keys):
            return label
    return 'other (elementwise, reductions, copies)'


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--steps', type=int, default=2)
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

    gen = torch.Generator().manual_seed(3)
    model = ddp.TransformerLM(VOCAB, DIM, HEADS, n_layers=LAYERS,
                              dtype=torch.bfloat16, remat=True,
                              device='cuda', generator=gen)
    optimizer = torch.optim.Adam(model.parameters(), lr=LR,
                                 betas=(0.9, 0.999), eps=1e-8)
    step = ddp.make_lm_train_step(model, optimizer, loss_chunk=LOSS_CHUNK)
    tokens = torch.randint(0, VOCAB, (BATCH, T), generator=gen).to('cuda')
    batch = (tokens, ddp.lm_targets(tokens))
    for _ in range(2):                                   # warm-up
        step(batch)
    torch.cuda.synchronize()

    host, dev = [], []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        step(batch)
        end.record()
        torch.cuda.synchronize()
        host.append(1e3 * (time.perf_counter() - t0))
        dev.append(start.elapsed_time(end))
    emit({'phase': 'step', 'steps': args.steps,
          'host_ms_median': statistics.median(host),
          'device_span_ms_median': statistics.median(dev),
          'card': torch.cuda.get_device_name(0)})

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(batch)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)

    events = prof.key_averages()
    # Device-side activity only: an operator's own row also carries the
    # device time of the kernels it launched, which would count twice.
    kernels = sorted(((e.key, _device_us(e), e.count) for e in events
                      if str(e.device_type).endswith('CUDA')
                      and _device_us(e) > 0), key=lambda r: -r[1])
    busy_us = sum(r[1] for r in kernels)
    by_class = {}
    for name, us, calls in kernels:
        ms, n = by_class.get(_class(name), (0.0, 0))
        by_class[_class(name)] = (ms + us / 1e3, n + calls)
    launches = sum(e.count for e in events
                   if e.key in ('cudaLaunchKernel', 'cuLaunchKernel',
                                'cuLaunchKernelEx'))
    emit({'phase': 'profile', 'window': f'{args.steps} train steps',
          'wall_ms': wall_us / 1e3, 'device_busy_ms': busy_us / 1e3,
          'device_busy_share': busy_us / wall_us,
          'kernel_launch_calls': launches,
          'by_class': {k: {'ms': ms, 'calls': n, 'share': 1e3 * ms / busy_us}
                       for k, (ms, n) in sorted(by_class.items(),
                                                key=lambda kv: -kv[1][0])},
          'top_device': [{'name': k[:80], 'ms': us / 1e3, 'calls': c}
                         for k, us, c in kernels[:12]]})
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.out, 'train_trace.json'))
    return 0


if __name__ == '__main__':
    sys.exit(main())
