# -*- coding: utf-8 -*-
"""
One JSON line with the headline rate of the PyTorch / CUDA port — the
twin of ``bench.py``, with its keys.

Metric: ``A·Bᵀ`` (nt) GFLOP/s per card on the reference workload T =
75000, d = 768, in bf16 (and, in ``detail``, float32 at T = 37500 with
full float32 products, no TF32). ``vs_baseline`` divides by 2,287
GFLOP/s per card: the original PyTorch/Horovod code's best nt
configuration (offset 25000) on 3x Quadro RTX 6000 over NCCL, as
``BASELINE.md`` records it (per-card useful FLOPs ``2·(T/3)·T·768 /
t``).

The distributed product runs over every rank of the process group: one
process is the one-rank mesh (``torchrun`` starts more). Then, as
secondary rates: the flash-attention forward (K1, and K2 with the
bounded softmax) at 8 heads of 64 over T = 16384, and on the card the
paper module's training step (T 16384, flash, no mask) and the 8-layer
LM's (T 16384, remat) through ``torch_benchmark.py``'s
``measure_train_step`` / ``measure_lm_step``.

    python torch_bench.py                  # the card
    python torch_bench.py --device cpu     # plain versions, small sizes

On the CPU every size is cut (T 512, attention T 128, no training steps):
its numbers say only that the code runs.
"""

import argparse
import json

import torch

from distributed_dot_product_tpu_torch.ops.functions import (
    distributed_matmul_nt,
)
from distributed_dot_product_tpu_torch.parallel.mesh import (
    seq_mesh, shard_seq,
)
from distributed_dot_product_tpu_torch.utils import comm
from distributed_dot_product_tpu_torch.utils.tracing import time_fn

BASELINE_GFLOPS_PER_CHIP = 2287.0  # BASELINE.md, nt offset=25000
DIM = 768


def measure(t, dtype, mesh, offset, device, iters=3, inner=5):
    """nt GFLOP/s per card and the best seconds a call: this rank's
    shards through the shard-local product, reduced to a float32 scalar
    inside the timed call (no (T, T) output outlives its call) and
    all-reduced over the seq ranks."""
    world = mesh.seq_size
    gen = torch.Generator(device=device).manual_seed(111)
    left = torch.randn((t, DIM), generator=gen, device=device, dtype=dtype)
    right = torch.randn((t, DIM), generator=gen, device=device, dtype=dtype)
    left, right = shard_seq(left, mesh), shard_seq(right, mesh)

    def fn(l, r):
        out = distributed_matmul_nt(l, r, offset, group=mesh.seq_group)
        return comm.all_reduce(out.sum(dtype=torch.float32), mesh.seq_group)

    best, _ = time_fn(fn, left, right, iters=iters, inner=inner)
    return 2.0 * t * t * DIM / world / best / 1e9, best


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)
    dev = comm.resolve_device(args.device)
    comm.init_from_env(args.device)
    if dev.type == 'cuda':
        dev = torch.device('cuda', torch.cuda.current_device())
    on_card = dev.type == 'cuda'
    mesh = seq_mesh()
    world = mesh.seq_size
    platform = 'gpu' if on_card else 'cpu'

    # The reference workload on the card; the nt output alone is T²
    # elements, so float32 runs at T/2 (as bench.py).
    t_bf16 = 75000 if on_card else 512
    t_f32 = 75000 // 2 if on_card else 512
    t_bf16 -= t_bf16 % world
    t_f32 -= t_f32 % world
    offset = 25000  # the baseline's best configuration

    gflops_bf16, time_bf16 = measure(t_bf16, torch.bfloat16, mesh, offset,
                                     dev)
    # Full float32 products (the baseline is float32 cuBLAS): no TF32.
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision('highest')
    try:
        gflops_f32, time_f32 = measure(t_f32, torch.float32, mesh, offset,
                                       dev)
    finally:
        torch.set_float32_matmul_precision(precision)

    # The flash-attention forward on a long-context shape: K1, and K2
    # (the bounded softmax, no running max).
    from distributed_dot_product_tpu_torch.ops.flash_attention import (
        flash_attention,
    )
    h, d, t_attn = 8, 64, (16384 if on_card else 128)
    gen = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn((1, h, t_attn, d), generator=gen, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))

    def fa(q, k, v):
        return flash_attention(q, k, v).sum(dtype=torch.float32)

    def fb(q, k, v):
        return flash_attention(q, k, v, softmax_mode='bounded').sum(
            dtype=torch.float32)

    with torch.no_grad():
        attn_best, _ = time_fn(fa, q, k, v, iters=6)
        attn_b_best, _ = time_fn(fb, q, k, v, iters=6)
    attn_gflops = 4.0 * h * t_attn * t_attn * d / attn_best / 1e9
    attn_b_gflops = 4.0 * h * t_attn * t_attn * d / attn_b_best / 1e9

    # The whole training step (forward, backward, Adam; flash, no mask)
    # and the LM's, on the card only.
    train_gflops = train_t = None
    lm_tok_s = lm_gflops = None
    if on_card:
        from torch_benchmark import measure_lm_step, measure_train_step
        rec = measure_train_step(seq_len=16384, attn_impl='flash',
                                 dtype='bf16', no_mask=True, iters=3,
                                 device=args.device)
        train_gflops, train_t = rec['step_gflops_per_chip'], rec['T']
        lm_rec = measure_lm_step(seq_len=16384, n_layers=8, dtype='bf16',
                                 remat=True, iters=3, device=args.device)
        lm_tok_s = lm_rec['tokens_per_s']
        lm_gflops = lm_rec['step_gflops_per_chip']

    line = {
        'metric': 'nt_gflops_per_chip',
        'value': round(gflops_bf16, 1),
        'unit': 'GFLOP/s/chip',
        'vs_baseline': round(gflops_bf16 / BASELINE_GFLOPS_PER_CHIP, 2),
        'detail': {
            'T_bf16': t_bf16, 'time_bf16_s': round(time_bf16, 4),
            'f32_gflops_per_chip': round(gflops_f32, 1),
            'T_f32': t_f32, 'time_f32_s': round(time_f32, 4),
            'f32_vs_baseline': round(
                gflops_f32 / BASELINE_GFLOPS_PER_CHIP, 2),
            'flash_attn_gflops': round(attn_gflops, 1),
            'flash_attn_bounded_gflops': round(attn_b_gflops, 1),
            'flash_attn_T': t_attn, 'flash_attn_time_s': round(attn_best, 4),
            'train_step_gflops': (round(train_gflops, 1)
                                  if train_gflops else None),
            'train_step_T': train_t,
            'lm_8l_16k_tokens_per_s': (round(lm_tok_s, 1)
                                       if lm_tok_s else None),
            'lm_8l_16k_gflops': (round(lm_gflops, 1)
                                 if lm_gflops else None),
            'world': world, 'platform': platform,
            'device_kind': (torch.cuda.get_device_name(dev) if on_card
                            else 'cpu'),
            'baseline': 'original nt offset=25000, 3x RTX6000/NCCL, '
                        '2287 GFLOP/s/chip (BASELINE.md)',
        },
    }
    if comm.is_main_process():
        print(json.dumps(line))
    return line


if __name__ == '__main__':
    main()
