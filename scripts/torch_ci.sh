#!/usr/bin/env bash
# CI gate of the PyTorch / H100 port: generic hygiene (ruff) → the
# port's static analysis (graphlint: graph rules, AST rules, servelint,
# flowlint) → the perf gate against PERF_BASELINE_TORCH.json → the port's
# tests. Each stage fails the build on its own; later stages still run so
# one pass reports everything (exit is the OR). Everything here runs on
# the CPU (--device cpu); the card's twin of the analysis is
# `python3 chip_smoke.py --phases analysis_examples`.
#
#   scripts/torch_ci.sh              # full gate
#   SKIP_TESTS=1 scripts/torch_ci.sh # lint-only (fast pre-push check)
set -u -o pipefail
cd "$(dirname "$0")/.."

rc=0

echo '=== [1/4] ruff (generic hygiene, the port files) ==='
if command -v ruff >/dev/null 2>&1; then
    ruff check distributed_dot_product_tpu_torch torch_example*.py \
        examples/torch_*.py scripts/torch_*.py tests/test_torch_*.py \
        tests/torch_*.py chip_smoke.py || rc=1
else
    echo 'ruff not installed in this image — skipping (graphlint still runs)'
fi

echo '=== [2/4] graphlint of the port (graph rules on the CPU, AST, servelint, flowlint) ==='
# Fast pre-commit twin:
#   python -m distributed_dot_product_tpu_torch.analysis --changed-only origin/main --device cpu
JAX_PLATFORMS=cpu python -m distributed_dot_product_tpu_torch.analysis \
    --device cpu || rc=1

echo '=== [3/4] perf gate (the registered entries vs PERF_BASELINE_TORCH.json) ==='
# On an intentional program change, refresh the baseline in the same diff:
#   python -m distributed_dot_product_tpu_torch.obs.perf --device cpu snapshot --baseline -o PERF_BASELINE_TORCH.json
if [ "${SKIP_TESTS:-0}" = "1" ]; then
    echo 'SKIP_TESTS=1 — skipping perf-gate stage'
else
    python -m distributed_dot_product_tpu_torch.obs.perf --device cpu \
        check --against PERF_BASELINE_TORCH.json || rc=1
fi

echo '=== [4/4] the port tests (against the JAX package on the CPU) ==='
if [ "${SKIP_TESTS:-0}" = "1" ]; then
    echo 'SKIP_TESTS=1 — skipping pytest stage'
else
    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_*.py -q \
        -p no:cacheprovider || rc=1
fi

exit $rc
