#!/usr/bin/env bash
# Long-context smoke of the PyTorch / CUDA port (the twin of
# scripts/smoke_longctx.sh): one 129,024-token stream decoded against a
# sequence-sharded paged KV pool (kv_shards=8), held token for token
# against the single-pool engine, on the card unless DEVICE=cpu.
#
#   scripts/torch_smoke_longctx.sh           # one CUDA card
#   DEVICE=cpu scripts/torch_smoke_longctx.sh
#
# What it proves (exit 0 = all of it):
#   1. A 129,024-token prompt prefills into a kv_shards=8 paged engine
#      (each shard owns a contiguous page range; the shards' partials
#      merge by the flash-decoding rule) and every decoded token equals
#      the single-pool engine's, on the plain decode path.
#   2. The fused kernel path (K5p partials on every shard) holds the same
#      identity: on the card over the whole 129,024-token prompt.
#   3. capacity_tokens scales linearly in kv_shards on a fixed per-shard
#      pool: the 8-shard engine holds the whole stream while its 1-shard
#      twin caps at one shard's pool (>= 3.5x).
# Cuts and changes against the reference script, each for a reason:
#   - on the CPU the kernel audit (2.) runs the kernel's plain version on
#     an 8,192-column stream (a 7,168-token prompt, 12 steps), as the
#     reference's interpreted kernel did; on the card it runs at 128k;
#   - on the card the heads are 32 wide, not 8 (the kernels' narrowest
#     head), and the engines compute in bf16 (the kernels' type).
set -u -o pipefail
cd "$(dirname "$0")/.."

export DDP_TORCH_DEVICE="${DEVICE:-cuda}"

echo "== torch_smoke_longctx: 128k-token stream, kv_shards=8 vs single pool (plain, $DDP_TORCH_DEVICE) =="
python - <<'PY' || exit 1
import os

import numpy as np
import torch

from distributed_dot_product_tpu_torch.serve import KernelEngine

DEV = os.environ['DDP_TORCH_DEVICE']
ON_CARD = torch.device(DEV).type == 'cuda'
T_MAX, PS, SHARDS = 131072, 1024, 8
PAGES_PER_SHARD = 17
PROMPT_ROWS = 126 * PS          # 129024 tokens > the 128k bar
STEPS = 24


def engine(**kw):
    return KernelEngine(slots=1, t_max=T_MAX, vocab=64, heads=2,
                        head_dim=32 if ON_CARD else 8, prefill_chunk=PS,
                        seed=0, decode_impl='plain', cache_mode='paged',
                        page_size=PS, device=DEV,
                        dtype=torch.bfloat16 if ON_CARD else torch.float32,
                        **kw)


sh = engine(pages=PAGES_PER_SHARD, kv_shards=SHARDS)
ref = engine(pages=SHARDS * PAGES_PER_SHARD)

# The linear-capacity line, on the same fixed per-shard pool.
solo = engine(pages=PAGES_PER_SHARD)
ratio = sh.capacity_tokens / solo.capacity_tokens
assert sh.capacity_tokens >= PROMPT_ROWS + STEPS + 1, sh.capacity_tokens
assert ratio >= 3.5, (
    f'capacity_tokens {solo.capacity_tokens} -> {sh.capacity_tokens} '
    f'({ratio:.2f}x at {SHARDS} shards) — the linear scaling line broke')
print(f'capacity: {solo.capacity_tokens} tokens at 1 shard -> '
      f'{sh.capacity_tokens} at {SHARDS} ({ratio:.1f}x)')

rng = np.random.default_rng(0)
prompt = rng.integers(0, 64, size=PROMPT_ROWS).astype(np.int32)
for eng in (ref, sh):
    for i in range(0, PROMPT_ROWS, PS):
        eng.prefill(0, prompt[i:i + PS])
assert int(sh.pool.lengths[0]) == int(ref.pool.lengths[0]) == PROMPT_ROWS

active = np.ones(1, bool)
tr = ts = np.asarray([int(prompt[-1])], np.int32)
out_ref, out_sh = [], []
for _ in range(STEPS):
    tr, _ = ref.step(tr, active)
    ts, _ = sh.step(ts, active)
    out_ref.append(int(tr[0]))
    out_sh.append(int(ts[0]))
assert out_sh == out_ref, (
    f'sharded 128k stream diverged from the single-pool reference:\n'
    f'  ref {out_ref}\n  sh  {out_sh}')
print(f'plain 128k audit OK: {STEPS} decoded tokens bit-identical at '
      f'fill={PROMPT_ROWS} ({out_sh[:6]}...)')
PY

echo "== torch_smoke_longctx: sharded fused-kernel identity ($DDP_TORCH_DEVICE) =="
python - <<'PY' || exit 1
import os

import numpy as np
import torch

import distributed_dot_product_tpu_torch as ddp
from distributed_dot_product_tpu_torch.serve import KernelEngine

DEV = os.environ['DDP_TORCH_DEVICE']
ON_CARD = torch.device(DEV).type == 'cuda'
if ON_CARD:     # the whole 128k stream through K5p
    T_MAX, PS, SHARDS, PAGES = 131072, 1024, 8, 17
    PROMPT_ROWS, STEPS = 126 * PS, 24
else:           # the kernel's plain version on an 8k stream
    T_MAX, PS, SHARDS, PAGES = 8192, 256, 8, 5
    PROMPT_ROWS, STEPS = 28 * PS, 12


def engine(**kw):
    return KernelEngine(slots=1, t_max=T_MAX, vocab=64, heads=2,
                        head_dim=32 if ON_CARD else 8, prefill_chunk=PS,
                        seed=0, decode_impl='kernel', cache_mode='paged',
                        page_size=PS, device=DEV,
                        dtype=torch.bfloat16 if ON_CARD else torch.float32,
                        **kw)


sh = engine(pages=PAGES, kv_shards=SHARDS)
ref = engine(pages=SHARDS * PAGES)
rng = np.random.default_rng(1)
prompt = rng.integers(0, 64, size=PROMPT_ROWS).astype(np.int32)
for eng in (ref, sh):
    for i in range(0, PROMPT_ROWS, PS):
        eng.prefill(0, prompt[i:i + PS])
active = np.ones(1, bool)
tr = ts = np.asarray([int(prompt[-1])], np.int32)
out_ref, out_sh = [], []
ddp.flash_decode_paged.launches = 0
for _ in range(STEPS):
    tr, _ = ref.step(tr, active)
    ts, _ = sh.step(ts, active)
    out_ref.append(int(tr[0]))
    out_sh.append(int(ts[0]))
assert out_sh == out_ref, (
    f'sharded kernel stream diverged:\n  ref {out_ref}\n  sh  {out_sh}')
launches = ddp.flash_decode_paged.launches
if ON_CARD:
    # One launch a step on the single pool, one per shard on the sharded.
    assert launches == STEPS * (1 + SHARDS), launches
print(f'kernel audit OK: {STEPS} decoded tokens bit-identical at '
      f'fill={PROMPT_ROWS}, K5p launches {launches}')
PY

echo 'torch_smoke_longctx OK'
