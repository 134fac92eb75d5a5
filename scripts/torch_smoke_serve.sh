#!/usr/bin/env bash
# Serving-layer smoke of the PyTorch / CUDA port (the twin of
# scripts/smoke_serve.sh): examples/torch_serve_lm.py under an injected
# request burst, one stuck decode step and one NaN-poisoned slot, on the
# card unless DEVICE=cpu. Asserts the process exits 0 with the serving
# audit green — every request in a typed terminal state, the watchdog
# stall recorded and recovered, the poisoned slot quarantined, completed
# streams bit-identical to a fault-free rerun, readiness restored — that
# the event log alone reconstructs the fault cocktail, and that
# `obs doctor` classifies the auto-dumped stall bundle.
#
#   scripts/torch_smoke_serve.sh [requests] [queue_limit]
#   DEVICE=cpu scripts/torch_smoke_serve.sh
#
# The engine runs the fused decode step (K5 on the card, its plain
# version on the CPU); DDP_TPU_DECODE_KERNEL=0 reruns the soak on the
# plain step. No length is cut on the CPU.
set -euo pipefail

REQUESTS=${1:-24}
QUEUE_LIMIT=${2:-6}
DEVICE="${DEVICE:-cuda}"
REPO="$(cd "$(dirname "$0")/.." && pwd)"
TMP="${TMPDIR:-/tmp}"

export PYTHONUNBUFFERED=1
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
export DDP_TPU_DECODE_KERNEL="${DDP_TPU_DECODE_KERNEL:-1}"

# The fault cocktail: a burst that overflows the queue, one stuck decode
# step long enough to trip the 0.25 s watchdog, one NaN slot.
export DDP_TPU_FAULT_BURST="$REQUESTS"
export DDP_TPU_FAULT_STUCK_STEP=4
export DDP_TPU_FAULT_STUCK_SECONDS=0.6
export DDP_TPU_FAULT_NAN_DECODE_STEP=7
export DDP_TPU_FAULT_NAN_DECODE_SLOT=1

OUT="$(mktemp "$TMP/ddp_torch_smoke_serve.XXXXXX")"
DOCTOR_OUT="$(mktemp "$TMP/ddp_torch_smoke_doctor.XXXXXX")"
EVENT_LOG="$(mktemp "$TMP/ddp_torch_smoke_events.XXXXXX.jsonl")"
export DDP_TPU_EVENT_LOG="$EVENT_LOG"
FLIGHT_DIR="$(mktemp -d "$TMP/ddp_torch_smoke_flight.XXXXXX")"
export DDP_TPU_FLIGHT_DIR="$FLIGHT_DIR"
trap 'rm -rf "$OUT" "$DOCTOR_OUT" "$EVENT_LOG" "$EVENT_LOG".[0-9]* "$FLIGHT_DIR"' EXIT

echo "== serving soak on $DEVICE: burst=$REQUESTS queue_limit=$QUEUE_LIMIT" \
     "+ stuck step + NaN slot"
if ! (cd "$REPO" && python examples/torch_serve_lm.py --device "$DEVICE" \
        --queue-limit "$QUEUE_LIMIT" --check-identical) | tee "$OUT"; then
    echo "== torch_smoke_serve FAILED: serving audit exited nonzero" >&2
    exit 1
fi

grep -q 'serve.watchdog_stalls' "$OUT" || {
    echo "== torch_smoke_serve FAILED: no watchdog stall recorded" >&2; exit 1; }
grep -q 'serve.nan_quarantined' "$OUT" || {
    echo "== torch_smoke_serve FAILED: no NaN quarantine recorded" >&2; exit 1; }
grep -q 'bit-identity check against clean rerun: ok' "$OUT" || {
    echo "== torch_smoke_serve FAILED: fault isolation not verified" >&2; exit 1; }
grep -q 'readiness restored' "$OUT" || {
    echo "== torch_smoke_serve FAILED: readiness not restored" >&2; exit 1; }
grep -q 'event-log timeline audit: ok' "$OUT" || {
    echo "== torch_smoke_serve FAILED: request timelines not reconstructable" \
         "from the event log" >&2; exit 1; }

if ! python -m distributed_dot_product_tpu_torch.obs validate "$EVENT_LOG" \
        --timelines \
        --require fault.inject,serve.admit,serve.reject,serve.decode,serve.retire,serve.quarantine,health.liveness,health.readiness
then
    echo "== torch_smoke_serve FAILED: event log does not reconstruct the" \
         "fault cocktail" >&2
    exit 1
fi
grep -q 'flight bundle \[stall\]' "$OUT" || {
    echo "== torch_smoke_serve FAILED: stall did not auto-dump a flight" \
         "bundle" >&2; exit 1; }
BUNDLE="$(ls -d "$FLIGHT_DIR"/bundle-*-stall 2>/dev/null | head -n 1)"
if [ -z "$BUNDLE" ]; then
    echo "== torch_smoke_serve FAILED: no stall bundle under $FLIGHT_DIR" >&2
    exit 1
fi
if ! python -m distributed_dot_product_tpu_torch.obs doctor "$BUNDLE" \
        | tee "$DOCTOR_OUT"; then
    echo "== torch_smoke_serve FAILED: obs doctor could not read the" \
         "bundle" >&2
    exit 1
fi
grep -q 'INCIDENT: stuck_step' "$DOCTOR_OUT" || {
    echo "== torch_smoke_serve FAILED: doctor did not classify the injected" \
         "stuck step (wanted INCIDENT: stuck_step)" >&2; exit 1; }
grep -q 'injected fault: stuck_step' "$DOCTOR_OUT" || {
    echo "== torch_smoke_serve FAILED: doctor evidence misses the injected" \
         "fault kind" >&2; exit 1; }
grep -q 'affected requests' "$DOCTOR_OUT" || {
    echo "== torch_smoke_serve FAILED: doctor named no affected requests" >&2
    exit 1; }
echo "== torch_smoke_serve OK: faults injected, recovered, streams intact," \
     "event log reconstructs the cocktail, doctor diagnosed the" \
     "stall bundle"
