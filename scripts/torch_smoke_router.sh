#!/usr/bin/env bash
# Disaggregated-serving smoke of the PyTorch / CUDA port (the twin of
# scripts/smoke_router.sh): the 1-router / 2-decode-pool cocktail, end to
# end through the port's CLIs, on the card unless DEVICE=cpu.
#
#   scripts/torch_smoke_router.sh           # one CUDA card
#   DEVICE=cpu scripts/torch_smoke_router.sh
#
# What it proves (exit 0 = all of it):
#   1. `torch_benchmark.py --mode serve-load --topology 1x2` runs the
#      seeded CI trace through the router (a prefill pool + 2 paged
#      decode replicas, KV handoff as pool pages) AND through its
#      single-process twin on the same serialized trace.
#   2. The router/prefill logs schema-validate and carry the
#      disaggregation events (router.route, prefill.handoff).
#   3. Goodput over the MERGED member logs passes the committed
#      SLO_BASELINE.json gate (`obs slo check` with labeled sources).
#   4. Every submitted request is accounted exactly once, and the
#      topology's goodput is at least the twin's on the same trace.
#   5. `obs critpath` partitions every request's e2e latency into its
#      phases (exits non-zero on any partition failure).
#   6. `obs trace export` emits Chrome-trace JSON that revalidates and
#      carries the phase slices.
# No length is cut on the CPU.
set -u -o pipefail
cd "$(dirname "$0")/.."

DEVICE="${DEVICE:-cuda}"
OBS="python -m distributed_dot_product_tpu_torch.obs"
dir="$(mktemp -d "${TMPDIR:-/tmp}/ddp_torch_router_smoke.XXXXXX")"
row="$dir/row.json"
trap 'rm -rf "$dir"' EXIT

echo "== torch_smoke_router: serve-load --topology 1x2 on $DEVICE (logs in $dir) =="
python torch_benchmark.py --device "$DEVICE" --mode serve-load \
    --topology 1x2 --event-log "$dir" --file "$row" || exit 1

echo '== torch_smoke_router: member logs schema-validate + carry the routing events =='
$OBS validate "$dir/router.jsonl" --require router.route || exit 1
$OBS validate "$dir/prefill.jsonl" --require prefill.handoff || exit 1

echo '== torch_smoke_router: goodput gate over the MERGED replica logs =='
$OBS slo check \
    router="$dir/router.jsonl" prefill="$dir/prefill.jsonl" \
    r0="$dir/r0.jsonl" r1="$dir/r1.jsonl" \
    --against SLO_BASELINE.json || exit 1

echo '== torch_smoke_router: exactly-once accounting + twin comparison =='
python - "$row" <<'PY' || exit 1
import json
import sys

rec = json.load(open(sys.argv[1]))[-1]
assert rec['topology'] == '1x2', rec
assert sum(rec['counts'].values()) == rec['requests'], (
    f"classification classes {rec['counts']} do not partition the "
    f"{rec['requests']} submitted requests")
assert rec['goodput_pct'] >= rec['twin_goodput_pct'], (
    f"routed topology goodput {rec['goodput_pct']:.1f}% fell below its "
    f"single-process twin's {rec['twin_goodput_pct']:.1f}% on the same "
    f"trace")
assert set(rec['routed']) == {'r0', 'r1'}, rec['routed']
assert rec['handoffs'] >= 1, 'no prefill->decode KV handoff happened'
print(f"router smoke OK: goodput {rec['goodput_pct']:.1f}% "
      f"(twin {rec['twin_goodput_pct']:.1f}%), routed {rec['routed']}, "
      f"{rec['handoffs']} handoffs / {rec['handoff_pages']} pages, "
      f"{rec['prefix_hits']} prefix hits, K5p launches "
      f"{rec['kernel_launches']['flash_decode_paged']}")
PY

echo '== torch_smoke_router: critpath phase partition over the merged logs =='
$OBS critpath \
    router="$dir/router.jsonl" prefill="$dir/prefill.jsonl" \
    r0="$dir/r0.jsonl" r1="$dir/r1.jsonl" || exit 1
$OBS critpath \
    router="$dir/router.jsonl" prefill="$dir/prefill.jsonl" \
    r0="$dir/r0.jsonl" r1="$dir/r1.jsonl" --json \
    > "$dir/critpath.json" || exit 1
python - "$dir/critpath.json" <<'PY' || exit 1
import json
import sys

prof = json.load(open(sys.argv[1]))
assert prof['requests'] > 0, 'critpath reconstructed zero requests'
assert prof['complete'] > 0, 'no request carried an e2e anchor'
assert not prof['partition_failures'], prof['partition_failures']
assert prof['phases'].get('decode', 0) > 0, (
    'no decode time attributed on a run that committed tokens')
assert prof.get('dispatch', {}).get('total', {}).get('ticks', 0) > 0, (
    'no serve.dispatch records — the dispatch-floor accounting is off')
print(f"critpath OK: {prof['requests']} requests, phases partition "
      f"e2e exactly, {prof['dispatch']['total']['ticks']} dispatch "
      f"ticks accounted")
PY

echo '== torch_smoke_router: Perfetto/Chrome-trace export + schema check =='
$OBS trace export \
    router="$dir/router.jsonl" prefill="$dir/prefill.jsonl" \
    r0="$dir/r0.jsonl" r1="$dir/r1.jsonl" \
    -o "$dir/trace.json" || exit 1
python - "$dir/trace.json" <<'PY' || exit 1
import json
import sys

trace = json.load(open(sys.argv[1]))
events = trace['traceEvents']
assert events, 'empty trace'
last = {}
for ev in events:
    for key in ('name', 'ph', 'ts', 'pid', 'tid'):
        assert key in ev, f'missing {key!r}: {ev}'
    if ev['ph'] == 'M':
        continue
    track = (ev['pid'], ev['tid'])
    assert ev['ts'] >= last.get(track, 0), (
        f"non-monotone ts on track {track}: {ev}")
    last[track] = ev['ts']
slices = [e for e in events if e['ph'] == 'X']
assert slices, 'no phase slices in the exported trace'
assert any(e['ph'] == 'i' for e in events), (
    'no instant markers (handoffs at minimum) in the exported trace')
print(f"trace OK: {len(events)} events, {len(slices)} phase slices, "
      f"{len(last)} tracks, ts monotone per track")
PY

echo 'torch_smoke_router OK'
