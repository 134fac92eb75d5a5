#!/usr/bin/env bash
# CI gate of the PyTorch / H100 port: generic hygiene (ruff) → the
# port's static analysis (graphlint: graph rules, AST rules, servelint,
# flowlint) → the perf gate against PERF_BASELINE_TORCH.json → the port's
# tests. Each stage fails the build on its own; later stages still run so
# one pass reports everything (exit is the OR). Everything here runs on
# the CPU (--device cpu); the card's twin of the analysis is
# `python3 chip_smoke.py --phases analysis_examples`. Then the stages of
# scripts/ci.sh that drive the benchmark CLI, through the port's twins on
# the CPU (torch_benchmark.py --device cpu, the scripts/torch_smoke_*.sh
# with DEVICE=cpu); their card twin is
# `python3 chip_smoke.py --phases benchmark_cli`.
#
#   scripts/torch_ci.sh              # full gate
#   SKIP_TESTS=1 scripts/torch_ci.sh # lint-only (fast pre-push check)
set -u -o pipefail
cd "$(dirname "$0")/.."

rc=0

echo '=== [1/12] ruff (generic hygiene, the port files) ==='
if command -v ruff >/dev/null 2>&1; then
    ruff check distributed_dot_product_tpu_torch torch_example*.py torch_bench*.py \
        examples/torch_*.py scripts/torch_*.py tests/test_torch_*.py \
        tests/torch_*.py chip_smoke.py || rc=1
else
    echo 'ruff not installed in this image — skipping (graphlint still runs)'
fi

echo '=== [2/12] graphlint of the port (graph rules on the CPU, AST, servelint, flowlint) ==='
# Fast pre-commit twin:
#   python -m distributed_dot_product_tpu_torch.analysis --changed-only origin/main --device cpu
JAX_PLATFORMS=cpu python -m distributed_dot_product_tpu_torch.analysis \
    --device cpu || rc=1

echo '=== [3/12] perf gate (the registered entries vs PERF_BASELINE_TORCH.json) ==='
# On an intentional program change, refresh the baseline in the same diff:
#   python -m distributed_dot_product_tpu_torch.obs.perf --device cpu snapshot --baseline -o PERF_BASELINE_TORCH.json
if [ "${SKIP_TESTS:-0}" = "1" ]; then
    echo 'SKIP_TESTS=1 — skipping perf-gate stage'
else
    python -m distributed_dot_product_tpu_torch.obs.perf --device cpu \
        check --against PERF_BASELINE_TORCH.json || rc=1
fi

echo '=== [4/12] the port tests (against the JAX package on the CPU) ==='
if [ "${SKIP_TESTS:-0}" = "1" ]; then
    echo 'SKIP_TESTS=1 — skipping pytest stage'
else
    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_*.py -q \
        -p no:cacheprovider || rc=1
fi

export OMP_NUM_THREADS="${OMP_NUM_THREADS:-1}"   # tiny rows: no thread fan-out
TMP="${TMPDIR:-/tmp}"

echo '=== [5/12] smoke serve + event-log schema validation ==='
if [ "${SKIP_TESTS:-0}" = "1" ]; then
    echo 'SKIP_TESTS=1 — skipping smoke-serve stage'
else
    DEVICE=cpu scripts/torch_smoke_serve.sh 12 4 || rc=1
fi

echo '=== [6/12] serve-load smoke + SLO goodput gate ==='
# The seeded open-loop trace on the virtual clock; the goodput report,
# from the event log alone, gated against the committed SLO_BASELINE.json.
if [ "${SKIP_TESTS:-0}" = "1" ]; then
    echo 'SKIP_TESTS=1 — skipping serve-load stage'
else
    slo_log="$(mktemp -u "$TMP/ddp_torch_slo_smoke.XXXXXX").jsonl"
    slo_row="$(mktemp -u "$TMP/ddp_torch_slo_row.XXXXXX").json"
    { python torch_benchmark.py --device cpu --mode serve-load \
          --event-log "$slo_log" --file "$slo_row" \
      && python -m distributed_dot_product_tpu_torch.obs \
          slo check "$slo_log" --against SLO_BASELINE.json; } || rc=1
    rm -f "$slo_log" "$slo_row"
fi

echo '=== [7/12] disaggregated-serving smoke (router + 2 decode pools) ==='
if [ "${SKIP_TESTS:-0}" = "1" ]; then
    echo 'SKIP_TESTS=1 — skipping router-smoke stage'
else
    DEVICE=cpu scripts/torch_smoke_router.sh || rc=1
fi

echo '=== [8/12] weight-quant decode smoke (kv+weight bytes below the bf16 twin) ==='
# The same decode shape at bf16 and at int8 weights + the int8 K mirror:
# the quantized row moves fewer kv+weight bytes a step, and the int8
# mirror pools stay eligible for the fused paged step.
if [ "${SKIP_TESTS:-0}" = "1" ]; then
    echo 'SKIP_TESTS=1 — skipping weight-quant smoke stage'
else
    wq_rows="$(mktemp -u "$TMP/ddp_torch_wq_rows.XXXXXX").json"
    { python torch_benchmark.py --device cpu --mode decode \
          --seq-len 512 --heads 2 --head-dim 8 --iters 2 --no-ttft \
          --dtype bf16 --file "$wq_rows" \
      && python torch_benchmark.py --device cpu --mode decode \
          --seq-len 512 --heads 2 --head-dim 8 --iters 2 --no-ttft \
          --dtype bf16 --weight-quant int8 --qk-quant int8 \
          --file "$wq_rows" \
      && python - "$wq_rows" <<'PY'; } || rc=1
import json
import sys

rows = json.load(open(sys.argv[1]))
bf16, wq8 = rows[-2], rows[-1]
assert wq8['weight_quant'] == 'int8' and bf16['weight_quant'] is None
assert wq8['step_bytes'] < bf16['step_bytes'], (
    f"quantized row moves {wq8['step_bytes']} kv+weight bytes/step vs "
    f"the bf16 twin's {bf16['step_bytes']} — the byte win is gone")
assert wq8['paged_int8_kernel_eligible'] is True, (
    'paged+int8 lost fused-kernel eligibility')
print(f"weight-quant smoke OK: {wq8['step_bytes']} vs "
      f"{bf16['step_bytes']} bytes/step, paged int8 kernel-eligible")
PY
    rm -f "$wq_rows"
fi

echo '=== [9/12] closed-loop control smoke (static vs controlled under a ramp) ==='
# The same seeded ramp trace through a 1-decode-replica topology twice:
# static must breach the committed per-tenant SLO floors, the controlled
# run (autoscaling decode replicas, actuating admission) must hold them;
# its control history validates from the log alone.
if [ "${SKIP_TESTS:-0}" = "1" ]; then
    echo 'SKIP_TESTS=1 — skipping control-smoke stage'
else
    ctl_rows="$(mktemp -u "$TMP/ddp_torch_ctl_rows.XXXXXX").json"
    ctl_static="$(mktemp -d "$TMP/ddp_torch_ctl_static.XXXXXX")"
    ctl_logs="$(mktemp -d "$TMP/ddp_torch_ctl_logs.XXXXXX")"
    { python torch_benchmark.py --device cpu --mode serve-load \
          --topology 0x1 --arrival ramp --load-rate 300 \
          --ramp-factor 10 --load-requests 64 \
          --event-log "$ctl_static" --file "$ctl_rows" \
      && python torch_benchmark.py --device cpu --mode serve-load \
          --topology 0x1 --arrival ramp --load-rate 300 \
          --ramp-factor 10 --load-requests 64 --control \
          --event-log "$ctl_logs" --file "$ctl_rows" \
      && python -m distributed_dot_product_tpu_torch.obs \
          validate "$ctl_logs/router.jsonl" \
          --require control.adjust,control.scale \
      && python - "$ctl_rows" <<'PY'; } || rc=1
import json
import sys

rows = json.load(open(sys.argv[1]))
static, controlled = rows[-2], rows[-1]
assert not static['control'] and controlled['control']
base = json.load(open('SLO_BASELINE.json'))
tol = base['tolerances']['tenant_goodput_abs']
floors = {t: gp - tol for t, gp in base['per_tenant'].items()}
breached = [t for t, gp in static['per_tenant'].items()
            if gp < floors[t]]
assert breached, (
    f"the ramp trace no longer breaks the static config "
    f"({static['per_tenant']} vs floors {floors})")
held = dict(controlled['per_tenant'])
bad = [t for t, gp in held.items() if gp < floors[t]]
assert not bad, (
    f'controlled run breaches the per-tenant SLO floors for {bad}: '
    f'{held} vs floors {floors}')
ups = [a for a in controlled['control_actions']
       if a['action'] == 'scale' and a['direction'] == 'up']
assert ups, 'controlled run never scaled up — the ramp was not acted on'
print(f"control smoke OK: static {static['per_tenant']} (breached "
      f"{breached}) vs controlled {held} within floors {floors}; "
      f"{len(ups)} scale-up(s), {controlled['replicas_final']} "
      f"replicas final")
PY
    rm -rf "$ctl_rows" "$ctl_static" "$ctl_logs"
fi

echo '=== [10/12] replica-failure-domain smoke (seeded crash + recovery) ==='
if [ "${SKIP_TESTS:-0}" = "1" ]; then
    echo 'SKIP_TESTS=1 — skipping chaos-smoke stage'
else
    DEVICE=cpu scripts/torch_smoke_chaos.sh || rc=1
fi

echo '=== [11/12] data-integrity smoke (seeded bit flip + detect/heal) ==='
if [ "${SKIP_TESTS:-0}" = "1" ]; then
    echo 'SKIP_TESTS=1 — skipping corrupt-smoke stage'
else
    DEVICE=cpu scripts/torch_smoke_corrupt.sh || rc=1
fi

echo '=== [12/12] long-context smoke (128k stream on the sharded KV pool) ==='
if [ "${SKIP_TESTS:-0}" = "1" ]; then
    echo 'SKIP_TESTS=1 — skipping longctx-smoke stage'
else
    DEVICE=cpu scripts/torch_smoke_longctx.sh || rc=1
fi

exit $rc
