# -*- coding: utf-8 -*-
"""
End-to-end example on the PyTorch / H100 port: sequence-parallel
multi-head attention, forward + backward + optimizer step over the
``seq`` ranks — the port's twin of ``example.py``.

One process per rank, started by ``torchrun`` (a process started alone
is the one-rank mesh); each rank holds the global ``(1, T, 768)`` batch
and takes its time shard, as the reference's one SPMD program over a
device mesh does. Runs on the card unless given ``--device cpu``:

    python torch_example.py                        # one H100
    torchrun --nproc-per-node 4 torch_example.py   # four ranks
    python torch_example.py --device cpu --seq-len 256 --dim 64

Matches the reference's workload: T=4096 global, model dim 768, 2 heads,
offset=64, zero boolean mask, MSE loss against a random target, Adam
1e-4, seed 111.
"""

import argparse
import sys
import time

import torch

from distributed_dot_product_tpu_torch import (
    DistributedDotProductAttn, make_train_step, seq_mesh,
)
from distributed_dot_product_tpu_torch.utils import comm


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument('--seq-len', type=int, default=4096,
                   help='global T (the reference workload: 4096)')
    p.add_argument('--dim', type=int, default=768)
    p.add_argument('--heads', type=int, default=2)
    p.add_argument('--offset', type=int, default=64)
    p.add_argument('--steps', type=int, default=4)
    args = p.parse_args(argv)

    dev = comm.resolve_device(args.device)
    comm.init_from_env(dev)
    if dev.type == 'cuda':
        dev = torch.device('cuda', torch.cuda.current_device())
    mesh = seq_mesh()
    print(f'mesh: {mesh.seq_size} x {dev.type} (axis {mesh.axis_names})')

    dim, t_global = args.dim, args.seq_len
    gen = torch.Generator().manual_seed(111)
    model = DistributedDotProductAttn(key_dim=dim, num_heads=args.heads,
                                      offset=args.offset, device=dev,
                                      generator=gen)
    x = torch.randn((1, t_global, dim), generator=gen).to(dev)
    target = torch.randn((1, t_global, dim), generator=gen).to(dev)
    mask = torch.zeros((1, t_global, t_global), dtype=torch.bool,
                       device=dev)
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-4,
                                 betas=(0.9, 0.999), eps=1e-8)
    step = make_train_step(model, optimizer, mesh)
    batch = (x, x, x, mask, target)

    losses = []
    for i in range(args.steps):
        t0 = time.perf_counter()
        loss = float(step(batch))        # the host read waits for the card
        dt = time.perf_counter() - t0
        losses.append(loss)
        what = (f'{dt:.1f}s incl. first call' if i == 0
                else f'{dt * 1000:.1f} ms')
        print(f'step {i}: loss={loss:.6f} ({what})')
    ok = all(l == l and abs(l) != float('inf') for l in losses)
    if not ok:
        print('torch_example: non-finite loss', file=sys.stderr)
    return {'losses': losses, 'ok': ok}


if __name__ == '__main__':
    sys.exit(0 if main()['ok'] else 1)
