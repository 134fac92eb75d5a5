# -*- coding: utf-8 -*-
"""
Long-context training demo on the PyTorch / H100 port — the twin of
``example_longcontext.py``: the flash path with in-kernel causal masking
and no dense mask (memory linear in T), RoPE and grouped-query K/V, the
resilient training loop with checkpoint and resume, then greedy decoding
through the KV cache (the prefill on K1, each token on K5).

One process per rank, started by ``torchrun`` (a process alone is the
one-rank mesh). Runs on the card unless given ``--device cpu``:

    python torch_example_longcontext.py --device cpu      # T=512, float32
    python torch_example_longcontext.py                   # H100, T=16384

On real hardware, raise --seq-len (e.g. 131072): the card computes in
bf16. A second run with the same --ckpt-dir resumes from the latest
finalized checkpoint and trains --steps more.
"""

import argparse
import sys
import tempfile
import time

import torch

import distributed_dot_product_tpu_torch as ddp
from distributed_dot_product_tpu_torch.utils import comm


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default; raises without a card) or "
                         "'cpu'")
    ap.add_argument('--seq-len', type=int, default=None,
                    help='global T (default: 512 on the CPU, 16384 on '
                         'the card)')
    ap.add_argument('--dim', type=int, default=256)
    ap.add_argument('--heads', type=int, default=8)
    ap.add_argument('--kv-heads', type=int, default=None,
                    help='grouped-query K/V heads (default: --heads)')
    ap.add_argument('--no-rope', action='store_true',
                    help='disable rotary position embeddings')
    ap.add_argument('--dropout', type=float, default=0.0,
                    help='attention-weight dropout rate (in-kernel mask; '
                         'seeded by the step counter)')
    ap.add_argument('--steps', type=int, default=4)
    ap.add_argument('--generate', type=int, default=8,
                    help='after training, decode this many tokens with '
                         'the KV cache (0 to skip)')
    ap.add_argument('--ckpt-dir', default=None,
                    help='checkpoint directory (default: a temp dir)')
    ap.add_argument('--ckpt-every', type=int, default=0,
                    help='checkpoint every N steps (0: only at the end)')
    ap.add_argument('--keep-last', type=int, default=3,
                    help='checkpoint retention (old step dirs GCed)')
    args = ap.parse_args(argv)

    dev = comm.resolve_device(args.device)
    comm.init_from_env(dev)
    on_card = dev.type == 'cuda'
    if on_card:
        dev = torch.device('cuda', torch.cuda.current_device())
    t = args.seq_len or (16384 if on_card else 512)
    dtype = torch.bfloat16 if on_card else torch.float32

    mesh = ddp.seq_mesh()
    world = mesh.seq_size
    t -= t % world
    print(f'{world}-rank mesh, T={t}, dim={args.dim}, '
          f'heads={args.heads}, dtype={str(dtype).split(".")[-1]}')

    # RoPE on by default: rotary embeddings over GLOBAL positions are the
    # standard causal long-context setup, and the sharded rotation equals
    # the full-array one exactly (ops/rope.py).
    model = ddp.DistributedDotProductAttn(
        key_dim=args.dim, num_heads=args.heads, num_kv_heads=args.kv_heads,
        causal=True, use_rope=not args.no_rope, dropout_rate=args.dropout,
        softmax_impl='flash', dtype=dtype, device=dev,
        generator=torch.Generator().manual_seed(0))

    gen = torch.Generator().manual_seed(111)
    x = torch.randn((1, t, args.dim), generator=gen).to(dev, dtype)
    target = torch.roll(x, -1, dims=1)      # next-step prediction target

    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3,
                                 betas=(0.9, 0.999), eps=1e-8)
    # guard=True: the step skips the update on a NaN/Inf step and returns
    # the {loss, bad_step, grad_norm} record the loop consumes.
    step = ddp.make_train_step(model, optimizer, mesh, guard=True)

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix='ddp_torch_ckpt_')
    # Recover crash leftovers BEFORE deriving the resume point, so the
    # step count agrees with what run_training (which recovers again,
    # idempotently) will resume from.
    ddp.recover_interrupted(ckpt_dir)
    start = ddp.latest_step(ckpt_dir) or 0
    batch = (x, x, x, None, target)   # attn_mask=None: no O(T^2) input
    cfg = ddp.TrainLoopConfig(
        num_steps=start + args.steps, ckpt_dir=ckpt_dir,
        ckpt_every=args.ckpt_every, keep_last=args.keep_last,
        log_every=1)
    state = ddp.TrainState(0, model.state_dict(), optimizer.state_dict())
    t0 = time.perf_counter()
    result = ddp.run_training(step, state, lambda i: batch, cfg)
    train_s = time.perf_counter() - t0
    if result.resumed_from is not None:
        print(f'(resumed from step {result.resumed_from})')
    print(f'checkpointed -> {ckpt_dir} (step {result.state.step}; '
          f'{train_s:.2f}s)')
    out = {'losses': dict(result.losses), 'resumed_from':
           result.resumed_from, 'train_seconds': train_s,
           'exit_code': result.exit_code}
    if result.preempted:
        return out

    if args.generate:
        # Inference with the SAME weights: prefill the prompt with the
        # flash kernel, then decode autoregressively (each step feeds the
        # previous output back in — the attention-only analog of LM
        # generation), the cache appended in place.
        prompt = 64
        with torch.no_grad():
            cache = model.make_decode_cache(1, prompt + args.generate + 1)
            xp = x[:, :prompt]
            cache, y = model.prefill(xp, xp, xp, cache)
            tok = y[:, -1:]
            cache, y = model.decode(tok, tok, tok, cache)    # first call
            tok = y[:, -1:]
            if on_card:
                torch.cuda.synchronize()
            tic = time.perf_counter()
            for _ in range(args.generate):
                cache, y = model.decode(tok, tok, tok, cache)
                tok = y[:, -1:]
            if on_card:
                torch.cuda.synchronize()
        dt = (time.perf_counter() - tic) * 1000 / args.generate
        finite = bool(torch.isfinite(tok).all())
        print(f'decoded {args.generate} tokens with the KV cache '
              f'({dt:.2f} ms/token; cache length '
              f'{int(cache.length)}/{cache.k.shape[-2]})')
        out.update(ms_per_token=dt, decode_finite=finite)
    return out


if __name__ == '__main__':
    res = main()
    sys.exit(res['exit_code'] or (0 if res.get('decode_finite', True)
                                  else 1))
