#!/usr/bin/env bash
# Data-integrity smoke of the PyTorch / CUDA port (the twin of
# scripts/smoke_corrupt.sh): flip one bit in a live KV page mid-trace
# and prove the serving stack detects, contains and heals it, end to end
# through the port's CLIs, on the card unless DEVICE=cpu.
#
#   scripts/torch_smoke_corrupt.sh          # one CUDA card
#   DEVICE=cpu scripts/torch_smoke_corrupt.sh
#
# What it proves (exit 0 = all of it):
#   1. `torch_benchmark.py --mode serve-load --topology 1x2
#      --chaos-corrupt` replays the seeded trace with one bit flipped in
#      a tracked KV page of r0 at a fixed virtual tick: the per-tick
#      scrub detects it before any poisoned token is delivered, the
#      victim stream heals on the clean replica, and every delivered
#      stream equals the crash-free single-process twin's.
#   2. The same flip against a checksums-off twin delivers at least one
#      silently wrong stream.
#   3. The router log schema-validates and carries the corruption arc
#      (kv.corrupt / fault.inject / request.recovered).
#   4. The corruption auto-dumped a flight bundle, and `obs doctor`
#      classifies it `kv_corruption` naming the dirty replica.
# No length is cut on the CPU.
set -u -o pipefail
cd "$(dirname "$0")/.."

DEVICE="${DEVICE:-cuda}"
OBS="python -m distributed_dot_product_tpu_torch.obs"
dir="$(mktemp -d "${TMPDIR:-/tmp}/ddp_torch_corrupt_smoke.XXXXXX")"
row="$dir/row.json"
trap 'rm -rf "$dir"' EXIT

echo "== torch_smoke_corrupt: serve-load --topology 1x2 --chaos-corrupt on $DEVICE (logs in $dir) =="
# Page index 2 at tick 8 lands the flip on a registered prefix with a
# queued rider (seed-7 trace). Generous SLO: the healed stream keeps its
# original submit anchor.
python torch_benchmark.py --device "$DEVICE" --mode serve-load \
    --topology 1x2 --chaos-victim r0 --chaos-corrupt 2:8 \
    --slo-ttft 2.0 --slo-token 1.0 \
    --event-log "$dir" --file "$row" || exit 1

echo '== torch_smoke_corrupt: router log carries the corruption arc =='
$OBS validate "$dir/router.jsonl" \
    --require kv.corrupt,fault.inject,request.recovered || exit 1

echo '== torch_smoke_corrupt: every flip detected, victims healed, twin delivers wrong tokens =='
python - "$row" <<'PY' || exit 1
import json
import sys

rec = json.load(open(sys.argv[1]))[-1]
assert rec['chaos_corrupt'] == {'victim': 'r0', 'page': 2, 'tick': 8}, \
    rec['chaos_corrupt']
assert rec['corruptions_injected'] >= 1, 'the bit flip never landed'
assert rec['corruptions_detected'] >= rec['corruptions_injected'], (
    f"{rec['corruptions_injected']} flip(s) injected but only "
    f"{rec['corruptions_detected']} kv.corrupt verdict(s) — silent "
    f"corruption")
assert rec['corrupt_healed'] or rec['corrupt_rejects'], (
    'the corruption had no victim stream — the flip tick missed the '
    'busy part of the trace')
assert rec['corrupt_compared'] >= 1 and rec['corrupt_bitident'], (
    f"delivered streams not proven bit-identical to the crash-free "
    f"twin: compared={rec['corrupt_compared']}")
assert sum(rec['counts'].values()) == rec['requests'], (
    f"classification classes {rec['counts']} do not partition the "
    f"{rec['requests']} submitted requests")
assert rec['nointeg_wrong_streams'], (
    'the checksums-off twin delivered no wrong stream — the flip was '
    'semantically invisible and the comparison proves nothing')
assert rec['verify_seconds'] >= 0, rec['verify_seconds']
print(f"corruption integrity OK: {rec['corruptions_injected']} flip(s) "
      f"-> {rec['corruptions_detected']} verdict(s) at "
      f"{rec['corrupt_sites']}, {len(rec['corrupt_healed'])} healed + "
      f"{len(rec['corrupt_rejects'])} typed kv_corrupt, twin delivered "
      f"{len(rec['nointeg_wrong_streams'])} silently wrong stream(s), "
      f"K5p launches {rec['kernel_launches']['flash_decode_paged']}")
PY

echo '== torch_smoke_corrupt: doctor classifies the auto-dumped flight bundle =='
bundle="$(python - "$row" <<'PY'
import json, sys
print(json.load(open(sys.argv[1]))[-1]['flight_bundle'])
PY
)"
test -d "$bundle" || { echo "flight bundle $bundle missing"; exit 1; }
$OBS doctor "$bundle" --json > "$dir/incident.json" || exit 1
python - "$dir/incident.json" <<'PY' || exit 1
import json
import sys

inc = json.load(open(sys.argv[1]))
assert inc['primary'] == 'kv_corruption', inc['primary']
assert inc['replica'] == 'r0', (
    f"doctor named {inc['replica']!r}, not the dirty replica r0")
print(f"doctor OK: primary={inc['primary']} replica={inc['replica']}")
PY

echo 'torch_smoke_corrupt OK'
