#!/usr/bin/env bash
# Kill/resume smoke of the PyTorch / CUDA port (the twin of
# scripts/smoke_resume.sh): a small training job through the resilient
# driver (train_loop.run_training), SIGKILLed mid-run, restarted, and
# its final loss compared with an uninterrupted run's bit for bit — on
# the card unless DEVICE=cpu.
#
#   scripts/torch_smoke_resume.sh [steps] [kill_after_seconds]
#   DEVICE=cpu scripts/torch_smoke_resume.sh
#
# Exercises, against a real process death: auto-resume from the latest
# finalized checkpoint, recover_interrupted cleanup of whatever the kill
# left behind, and the determinism of the batch_fn(step) data stream.
# The reference's job spans an 8-device CPU mesh; this one is one rank
# (the port's ranks are processes).
set -euo pipefail

STEPS=${1:-40}
KILL_AFTER=${2:-18}   # past the start (~10 s on the card), well before the end
DEVICE="${DEVICE:-cuda}"
REPO="$(cd "$(dirname "$0")/.." && pwd)"
WORK="$(mktemp -d "${TMPDIR:-/tmp}/ddp_torch_smoke_resume.XXXXXX")"
trap 'rm -rf "$WORK"' EXIT

export PYTHONUNBUFFERED=1
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
export DDP_TORCH_DEVICE="$DEVICE"
# One cuBLAS workspace configuration for every run: the same products
# reduce in the same order in each process.
export CUBLAS_WORKSPACE_CONFIG=:4096:8

# The job lives in a real file so the interrupted run can background
# `python` directly ($! is then the python process).
cat > "$WORK/job.py" <<'PY'
import copy
import os
import sys
import time

import torch

from distributed_dot_product_tpu_torch import (
    DistributedDotProductAttn, TrainLoopConfig, TrainState, make_train_step,
    run_training, seq_mesh,
)

ckpt_dir, loss_out, steps = sys.argv[1] or None, sys.argv[2], int(sys.argv[3])
dev = torch.device(os.environ['DDP_TORCH_DEVICE'])

dim, heads, t, b = 16, 2, 16, 2
model = DistributedDotProductAttn(key_dim=dim, num_heads=heads, offset=2,
                                  device=dev,
                                  generator=torch.Generator().manual_seed(1))
mask = torch.zeros((b, t, t), dtype=torch.bool, device=dev)
optimizer = torch.optim.Adam(model.parameters(), lr=1e-2)
step = make_train_step(model, optimizer, seq_mesh(), guard=True)


def batch_fn(i):
    gen = torch.Generator().manual_seed(1000 + i)
    x = torch.randn((b, t, dim), generator=gen).to(dev)
    return (x, x, x, mask, torch.zeros_like(x))


# Slow the loop so the SIGKILL lands mid-run.
def slow_batch_fn(i):
    time.sleep(0.5)
    return batch_fn(i)


cfg = TrainLoopConfig(num_steps=steps, ckpt_dir=ckpt_dir, ckpt_every=2,
                      keep_last=3)
state = TrainState(0, copy.deepcopy(model.state_dict()),
                   copy.deepcopy(optimizer.state_dict()))
result = run_training(step, state,
                      slow_batch_fn if ckpt_dir else batch_fn, cfg)
final = result.losses.get(result.state.step - 1)
if final is None:
    print(f'nothing to do: resumed at step {result.state.step}',
          file=sys.stderr)
    sys.exit(2)
with open(loss_out, 'w') as f:
    f.write(repr(final))
print(f'done: step={result.state.step} final_loss={final!r} '
      f'resumed_from={result.resumed_from}')
if ckpt_dir and '--expect-resume' in sys.argv and result.resumed_from is None:
    print('no checkpoint found at start: the kill landed before the first '
          'save (try a larger kill_after)', file=sys.stderr)
    sys.exit(3)
PY

run_job() {  # run_job <ckpt_dir_or_empty> <loss_out> [--expect-resume]
    (cd "$REPO" && python "$WORK/job.py" "$1" "$2" "$STEPS" "${3:-}")
}

echo "== uninterrupted reference run ($STEPS steps on $DEVICE)"
run_job "" "$WORK/loss_ref"

echo "== interrupted run: SIGKILL after ${KILL_AFTER}s"
(cd "$REPO" && exec python "$WORK/job.py" "$WORK/ckpt" \
    "$WORK/loss_killed" "$STEPS") &
PID=$!
sleep "$KILL_AFTER"
if kill -9 "$PID" 2>/dev/null; then
    wait "$PID" 2>/dev/null || true
    echo "== killed pid $PID; restarting"
else
    echo "!! job finished before the kill landed — raise steps or lower" \
         "kill_after for a real mid-run kill" >&2
fi

echo "== resumed run"
if ! run_job "$WORK/ckpt" "$WORK/loss_resumed" --expect-resume; then
    echo "!! no genuine mid-run kill/resume was exercised — tune" \
         "kill_after (killed too late: run finished; too early: no" \
         "checkpoint yet)" >&2
    exit 1
fi

REF="$(cat "$WORK/loss_ref")"
RES="$(cat "$WORK/loss_resumed")"
echo "== reference final loss: $REF"
echo "== resumed   final loss: $RES"
if [ "$REF" = "$RES" ]; then
    echo "== torch_smoke_resume OK: kill/resume run matches uninterrupted run"
else
    echo "== torch_smoke_resume FAILED: losses differ" >&2
    exit 1
fi
