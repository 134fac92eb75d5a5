# -*- coding: utf-8 -*-
"""
Train a language model end to end on the PyTorch / H100 port — the twin
of ``examples/train_lm.py``: the packed long-context copy task, the
resilient training loop (checkpoint mid-run, resume), then greedy
generation through the per-layer KV caches.

The task: each packed segment is ``[BOS, a_1 .. a_L, SEP, a_1 .. a_L]``
with the a_i uniform over the data vocabulary. The first half is
incompressible; the second half is exactly predictable, but ONLY through
attention back to the prefix (an induction task). Success is crisp: the
copy-region loss falls towards 0 and greedy generation reproduces the
prefix token for token.

One process per rank, started by ``torchrun`` (a process alone is the
one-rank mesh; four ranks with an even batch make a 2 x 2 data x seq
mesh). Runs on the card unless given ``--device cpu``:

  python examples/torch_train_lm.py --device cpu --steps 300
  python examples/torch_train_lm.py --seq-len 32768 --dim 512 --layers 8 \\
      --steps 50 --batch 1 --softmax-impl flash --generate

With ``--ckpt-dir`` a rerun resumes from the latest finalized checkpoint:
its batches are a function of the step index, so a resumed run trains on
exactly the batches an uninterrupted one would.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from distributed_dot_product_tpu_torch import (  # noqa: E402
    TrainLoopConfig, TrainState, TransformerLM, greedy_generate,
    lm_targets, run_training,
)
from distributed_dot_product_tpu_torch.parallel.mesh import (  # noqa: E402
    data_seq_mesh, seq_mesh,
)
from distributed_dot_product_tpu_torch.train import (  # noqa: E402
    make_lm_train_step,
)
from distributed_dot_product_tpu_torch.utils import comm  # noqa: E402

BOS_OFF, SEP_OFF = 1, 2   # vocab layout: [0..V-3]=data, V-2=SEP, V-1=BOS


def make_copy_batch(seed, batch, t, vocab, seg_len, device):
    """Packed copy-task batch: tokens, targets (copy region only — the
    incompressible prefix is ignore (−1), giving a loss whose floor is
    ~0), and segment ids. ``seg_len`` must be even: each segment is
    [BOS, prefix(L), SEP, copy(L)] with L = seg_len/2 − 1."""
    if seg_len % 2 or seg_len < 4:
        raise ValueError(f'seg_len must be even and >= 4, got {seg_len}')
    if t % seg_len:
        raise ValueError(f'seq len {t} must pack whole segments of '
                         f'{seg_len}')
    half = seg_len // 2
    n_seg = t // seg_len
    bos, sep = vocab - BOS_OFF, vocab - SEP_OFF
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab - 2, size=(batch, n_seg, half - 1))
    seg = np.concatenate([
        np.full((batch, n_seg, 1), bos), prefix,
        np.full((batch, n_seg, 1), sep), prefix], axis=-1)
    tokens = torch.as_tensor(seg.reshape(batch, t), dtype=torch.int64,
                             device=device)
    seg_ids = torch.arange(n_seg, device=device).repeat_interleave(
        seg_len)[None].expand(batch, t).contiguous()
    targets = lm_targets(tokens, seg_ids)
    # Score the copy region only: positions SEP..end-1 predict the copy.
    pos = torch.arange(seg_len, device=device).repeat(n_seg)
    in_copy = (pos >= half) & (pos < seg_len - 1)
    targets = torch.where(in_copy[None], targets, -1)
    return tokens, targets, seg_ids


def build_model(args, device):
    """The LM; it computes in bf16 with ``--bf16`` and always on the card
    (ROADMAP §1 item 9: the reference computes in float32 unless
    ``--bf16``), its parameters float32."""
    bf16 = args.bf16 or torch.device(device).type == 'cuda'
    return TransformerLM(
        vocab_size=args.vocab, dim=args.dim, num_heads=args.heads,
        n_layers=args.layers, scan_layers=not args.no_scan,
        remat=args.remat, dtype=torch.bfloat16 if bf16 else None,
        attn_kwargs=dict(softmax_impl=args.softmax_impl,
                         num_kv_heads=args.kv_heads,
                         dropout_rate=args.dropout),
        device=device, generator=torch.Generator().manual_seed(1))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument('--steps', type=int, default=300)
    p.add_argument('--batch', type=int, default=2)
    p.add_argument('--seq-len', type=int, default=256)
    p.add_argument('--seg-len', type=int, default=64,
                   help='packed segment length (copy span = half - 1)')
    p.add_argument('--vocab', type=int, default=64)
    p.add_argument('--dim', type=int, default=64)
    p.add_argument('--heads', type=int, default=4)
    p.add_argument('--kv-heads', type=int, default=None)
    p.add_argument('--layers', type=int, default=2)
    p.add_argument('--lr', type=float, default=3e-3)
    p.add_argument('--dropout', type=float, default=0.0)
    p.add_argument('--softmax-impl', default='flash',
                   choices=['full', 'online', 'flash', 'ulysses'])
    p.add_argument('--no-scan', action='store_true',
                   help='unrolled layers (the port always runs them '
                        'unrolled; kept for the reference\'s flags)')
    p.add_argument('--remat', action='store_true')
    p.add_argument('--bf16', action='store_true',
                   help='compute in bf16 (always on the card)')
    p.add_argument('--ckpt-dir', default=None)
    p.add_argument('--ckpt-every', type=int, default=100)
    p.add_argument('--keep-last', type=int, default=3,
                   help='checkpoint retention (old step dirs GCed)')
    p.add_argument('--generate', action='store_true',
                   help='after training, greedy-generate a copy and '
                        'report token accuracy')
    p.add_argument('--log-every', type=int, default=25)
    args = p.parse_args(argv)

    dev = comm.resolve_device(args.device)
    n_ranks = comm.init_from_env(dev)
    if dev.type == 'cuda':
        dev = torch.device('cuda', torch.cuda.current_device())
    if n_ranks >= 4 and n_ranks % 2 == 0 and args.batch % 2 == 0:
        mesh, data_axis = data_seq_mesh(2, n_ranks // 2), 'data'
    else:
        mesh, data_axis = seq_mesh(n_ranks), None
    print(f'ranks={n_ranks} mesh={dict(mesh.shape)} device={dev.type}')

    model = build_model(args, dev)
    n_params = sum(x.numel() for x in model.parameters())
    print(f'model: {args.layers}L dim={args.dim} heads={args.heads} '
          f'vocab={args.vocab} — {n_params:,} params')

    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr,
                                 betas=(0.9, 0.999), eps=1e-8)
    # guard=True: NaN/Inf steps skip the update and surface as bad_step
    # records to the loop.
    step_fn = make_lm_train_step(model, optimizer, mesh,
                                 data_axis=data_axis, guard=True)

    def batch_fn(i):
        # The step index seeds the batch: a resumed run consumes exactly
        # the batches an uninterrupted run would.
        return make_copy_batch(2 + 7919 * i, args.batch, args.seq_len,
                               args.vocab, args.seg_len, dev)

    # The resilient loop: auto-resume, periodic async saves with
    # retry/backoff, SIGTERM/SIGINT -> final save + clean exit,
    # NaN-guarded stepping with rollback, keep_last retention.
    cfg = TrainLoopConfig(
        num_steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every if args.ckpt_dir else 0,
        keep_last=args.keep_last, max_bad_steps=3,
        log_every=args.log_every)
    t0 = time.time()
    result = run_training(step_fn, TrainState(0, model.state_dict(),
                                              optimizer.state_dict()),
                          batch_fn, cfg)
    start = result.resumed_from or 0
    loss = result.losses.get(result.state.step - 1, float('nan'))
    dt = time.time() - t0
    executed = result.state.step - start   # != args.steps when preempted
    tok = executed * args.batch * args.seq_len
    print(f'trained {executed} steps in {dt:.1f}s '
          f'({tok / max(dt, 1e-9):,.0f} tok/s incl. data and first call)')
    out = {'loss': loss, 'acc': None, 'losses': dict(result.losses),
           'resumed_from': result.resumed_from, 'seconds': dt,
           'exit_code': result.exit_code}
    if result.preempted:
        print(f'preempted (exit code {result.exit_code}); state saved '
              f'at step {result.state.step}')
        return out

    if args.generate:
        # One fresh segment: prompt = [BOS, prefix, SEP]; the model must
        # reproduce the prefix through its KV caches.
        half = args.seg_len // 2
        tokens, _, _ = make_copy_batch(99, 1, args.seg_len, args.vocab,
                                       args.seg_len, dev)
        prompt, answer = tokens[:, :half + 1], tokens[:, half + 1:]
        steps = answer.shape[1]
        gen = greedy_generate(model, prompt, steps, t_max=args.seg_len)
        acc = float((gen.long() == answer).float().mean())
        print(f'generation: copy accuracy {acc:.1%} over {steps} tokens')
        out['acc'] = acc
    return out


if __name__ == '__main__':
    res = main()
    sys.exit(res['exit_code'] or (0 if res['loss'] == res['loss'] else 1))
