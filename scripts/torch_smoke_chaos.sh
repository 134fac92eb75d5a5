#!/usr/bin/env bash
# Replica-failure-domain smoke of the PyTorch / CUDA port (the twin of
# scripts/smoke_chaos.sh): kill one decode replica mid-trace and prove
# the serving stack recovers, end to end through the port's CLIs, on
# the card unless DEVICE=cpu.
#
#   scripts/torch_smoke_chaos.sh            # one CUDA card
#   DEVICE=cpu scripts/torch_smoke_chaos.sh
#
# What it proves (exit 0 = all of it):
#   1. `torch_benchmark.py --mode serve-load --topology 1x2 --chaos`
#      replays the seeded trace with replica r1 killed at a fixed
#      virtual tick: the probes declare the loss, every in-flight stream
#      on the victim is re-dispatched to the survivor, and each
#      recovered stream equals the crash-free single-process twin's.
#   2. The router log schema-validates and carries the recovery arc
#      (replica.lost / replica.probe / request.recovered), and the
#      victim's torn log still validates.
#   3. Goodput with recovery beats the no-recovery twin (same topology,
#      trace and crash, max_recoveries=0), and no request is dropped
#      without a typed reason in either run.
#   4. The loss auto-dumped a flight bundle, and `obs doctor` classifies
#      it `replica_loss` naming the dead replica.
# No length is cut on the CPU.
set -u -o pipefail
cd "$(dirname "$0")/.."

DEVICE="${DEVICE:-cuda}"
OBS="python -m distributed_dot_product_tpu_torch.obs"
dir="$(mktemp -d "${TMPDIR:-/tmp}/ddp_torch_chaos_smoke.XXXXXX")"
row="$dir/row.json"
trap 'rm -rf "$dir"' EXIT

echo "== torch_smoke_chaos: serve-load --topology 1x2 --chaos on $DEVICE (logs in $dir) =="
# Generous SLO: recovered streams keep their original submit anchor, so
# their TTFT includes the crash, detection and replay window.
python torch_benchmark.py --device "$DEVICE" --mode serve-load \
    --topology 1x2 --chaos --slo-ttft 2.0 --slo-token 1.0 \
    --event-log "$dir" --file "$row" || exit 1

echo '== torch_smoke_chaos: router log carries the recovery arc; torn victim log validates =='
$OBS validate "$dir/router.jsonl" \
    --require replica.lost,replica.probe,request.recovered || exit 1
$OBS validate "$dir/r1.jsonl" || exit 1

echo '== torch_smoke_chaos: recovery recovered, bit-identically, and paid for itself =='
python - "$row" <<'PY' || exit 1
import json
import sys

rec = json.load(open(sys.argv[1]))[-1]
assert rec['chaos'] == {'victim': 'r1', 'tick': 40}, rec['chaos']
assert rec['replica_lost'] == ['r1'], rec['replica_lost']
assert rec['recovered'], 'the crash caught no in-flight stream'
assert rec['recovered_compared'] >= 1 and rec['recovered_bitident'], (
    f"recovered streams not proven bit-identical to the crash-free "
    f"twin: compared={rec['recovered_compared']}")
assert sum(rec['counts'].values()) == rec['requests'], (
    f"classification classes {rec['counts']} do not partition the "
    f"{rec['requests']} submitted requests")
assert sum(rec['norec_counts'].values()) == rec['requests'], (
    f"no-recovery twin classes {rec['norec_counts']} do not partition "
    f"the {rec['requests']} submitted requests")
assert rec['norec_replica_lost_rejects'], (
    'the no-recovery twin lost the same replica yet produced no typed '
    'replica_lost terminal')
assert rec['goodput_pct'] > rec['norec_goodput_pct'], (
    f"goodput with recovery {rec['goodput_pct']:.1f}% does not beat "
    f"the no-recovery twin's {rec['norec_goodput_pct']:.1f}% — "
    f"recovery did not pay for itself")
print(f"chaos recovery OK: {len(rec['recovered'])} stream(s) recovered "
      f"({rec['recovered_compared']} bit-identical), goodput "
      f"{rec['goodput_pct']:.1f}% vs no-recovery "
      f"{rec['norec_goodput_pct']:.1f}%, K5p launches "
      f"{rec['kernel_launches']['flash_decode_paged']}")
PY

echo '== torch_smoke_chaos: doctor classifies the auto-dumped flight bundle =='
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
assert inc['primary'] == 'replica_loss', inc['primary']
assert inc['replica'] == 'r1', (
    f"doctor named {inc['replica']!r}, not the dead replica r1")
print(f"doctor OK: primary={inc['primary']} replica={inc['replica']}")
PY

echo 'torch_smoke_chaos OK'
