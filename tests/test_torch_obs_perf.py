# -*- coding: utf-8 -*-
"""
The port's perf observatory (``obs/perf.py`` over
``analysis/registry.py``), on the CPU:

- every registered entrypoint — the reference registry's names, but its
  ``train`` hook — is in the snapshot with nonzero FLOPs and bytes, the
  kernel entries with their kernels' calls; the snapshot's peaks are the
  H100's and its ``retrace_totals`` empty;
- the gate passes against the committed ``PERF_BASELINE_TORCH.json``
  and flags a planted 2x FLOPs (an entry that runs its kernel twice)
  by entry and metric, with a ``perf.regression`` event;
- a kernel's work is its formula whatever implements it, and the
  formulas give ``chip_smoke.py``'s kernel bounds: its headline shapes'
  operations and bytes, written out here the way the script counted them
  before the formulas moved into ``obs/perf.py``;
- the first-call, coverage, error and retrace gates, the report and the
  CLI's exit codes (``snapshot``, ``check``).
"""

import json
import math
import os
import subprocess
import sys

import pytest
import torch

from distributed_dot_product_tpu.analysis import registry as jregistry
from distributed_dot_product_tpu_torch import flash_attention
from distributed_dot_product_tpu_torch.analysis import registry
from distributed_dot_product_tpu_torch.analysis.registry import (
    TraceSpec, example,
)
from distributed_dot_product_tpu_torch.obs import events as obs_events
from distributed_dot_product_tpu_torch.obs import perf
from distributed_dot_product_tpu_torch.obs.events import EventLog, activate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(REPO, 'PERF_BASELINE_TORCH.json')
# Kernel entries and the kernels each runs once.
KERNEL_ENTRIES = {
    'ops.flash_fwd_bf16': {'flash_attention'},
    'ops.flash_fwd_int8': {'flash_attention'},
    'ops.flash_bwd_bf16': {'flash_attention', 'flash_attention_dq',
                           'flash_attention_dkv'},
    'decode.step_kernel_int8': {'flash_decode'},
    'decode.step_verify_slab': {'flash_decode'},
    'decode.step_paged_kernel': {'flash_decode_paged'},
    'decode.step_paged_kernel_int8': {'flash_decode_paged'},
    'decode.step_verify_paged': {'flash_decode_paged'},
    'decode.seq_parallel_step': {'flash_decode'},
}


@pytest.fixture(scope='module')
def full_snapshot():
    """ONE pass over the whole registry, shared by the tests below."""
    return perf.snapshot(device='cpu')


def test_every_entrypoint_in_snapshot_with_nonzero_cost(full_snapshot):
    want = set(jregistry.default_entrypoints())
    entries = full_snapshot['entries']
    assert set(entries) == want
    for name, e in entries.items():
        assert 'error' not in e, (name, e)
        assert e['flops'] > 0 and e['bytes_accessed'] > 0, name
        assert e['model_seconds'] > 0 and e['argument_bytes'] > 0, name
        assert 'peak_bytes' not in e and 'measured_seconds' not in e
    for name, kernels in KERNEL_ENTRIES.items():
        got = entries[name]['kernels']
        assert set(got) == kernels, (name, got)
        assert all(k['calls'] == 1 for k in got.values()), (name, got)


def test_snapshot_schema_peaks_and_retrace_totals(full_snapshot):
    assert full_snapshot['schema'] == perf.PERF_SCHEMA_VERSION
    assert full_snapshot['platform'] == 'cpu'
    assert full_snapshot['peaks']['flops_per_s'] == 989e12
    assert full_snapshot['peaks']['bytes_per_s'] == 3.35e12
    # The retrace sentinel's counts while the snapshot ran: each entry's
    # decode step sees ONE signature, however many times the snapshot
    # runs it — the two sequence-sharded steps, the five engine entries.
    totals = full_snapshot['retrace_totals']
    assert totals['attention.make_decode_step'] == 2
    assert totals['engine.decode'] == 5
    assert all(v >= 0 for v in totals.values())
    # The mesh entries count their collectives by kind.
    colls = full_snapshot['entries']['ops.matmul_grad_allgather'][
        'collectives']
    assert colls and set(colls) <= {'all-gather', 'all-reduce',
                                    'reduce-scatter', 'collective-permute',
                                    'all-to-all'}


def test_committed_baseline_gate_passes(full_snapshot):
    with open(BASELINE) as f:
        baseline = json.load(f)
    assert baseline['platform'] == 'cpu'
    assert all('first_call_seconds' not in e
               for e in baseline['entries'].values())
    violations = perf.check_snapshots(full_snapshot, baseline,
                                      emit_events=False)
    assert violations == [], violations
    assert perf.check_snapshots(perf.baseline_view(full_snapshot),
                                baseline, emit_events=False) == []


def _flash_spec(twice):
    def build(device):
        q = example((1, 2, 64, 32), torch.bfloat16, device)

        def fn(q, k, v):
            out = flash_attention(q, k, v, causal=True)
            if twice:
                out = flash_attention(out, k, v, causal=True)
            return out
        return TraceSpec(name='fixture.flash', fn=fn, args=(q, q, q))
    return build


def test_planted_double_flops_is_flagged(tmp_path):
    clean = perf.snapshot({'fixture.flash': _flash_spec(False)},
                          device='cpu')
    planted = perf.snapshot({'fixture.flash': _flash_spec(True)},
                            device='cpu')
    c, p = (s['entries']['fixture.flash'] for s in (clean, planted))
    assert p['flops'] == 2 * c['flops']
    assert p['kernels']['flash_attention']['calls'] == 2
    assert perf.check_snapshots(clean, clean, emit_events=False) == []
    log_path = tmp_path / 'ev.jsonl'
    with activate(EventLog(log_path)) as log:
        violations = perf.check_snapshots(planted, clean)
        log.flush()
    assert any(v.startswith('fixture.flash: flops:') for v in violations)
    records, errors = obs_events.validate_file(str(log_path))
    assert errors == []
    regs = [r for r in records if r['event'] == 'perf.regression']
    assert {r['entry'] for r in regs} == {'fixture.flash'}
    assert 'flops' in {r['metric'] for r in regs}


def test_kernel_work_is_the_formula_whatever_runs_it():
    """The CPU runs the plain versions, whose own ops are many more: the
    count inside a kernel's call is its formula, and only it."""
    q = example((2, 2, 48, 32), torch.bfloat16, 'cpu')
    with perf.CostCounter() as cost:
        flash_attention(q, q, q, causal=True)
    pairs = 2 * 2 * sum(i + 1 for i in range(48))
    want = perf.attention_fwd_cost(d=32, q_rows=2 * 2 * 48,
                                   kv_rows=2 * 2 * 48, pairs=pairs)
    assert (cost.flops, cost.bytes) == want
    assert cost.kernels == {'flash_attention': {
        'calls': 1, 'flops': want[0], 'bytes': want[1]}}
    assert perf.kernel_work('flash_attention', None) is perf._OFF


def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


def test_kernel_formulas_give_chip_smokes_bounds():
    """chip_smoke's headline bounds, as the script counted them before:
    K1 at the prefill case, K1 / K3 / K4 at the training shape, K2 and
    the f32-gradient K3 / K4 on the masked fold, K5 at the main shape,
    K5p at the serving shape, and the general decode bound."""
    cs = _chip_smoke()
    d, b, h = cs.HEAD_DIM, cs.BATCH, cs.HEADS
    nb, tq, tk = b * h, cs.PROMPT, cs.PROMPT
    pairs = cs.causal_pairs(tq, tk, 0) * nb
    # K1 prefill (no LSE).
    assert perf.attention_fwd_cost(d=d, q_rows=nb * tq, kv_rows=nb * tk,
                                   pairs=pairs) == (
        4 * d * pairs, 2 * d * (2 * nb * tq + 2 * b * h * tk))
    # K1 / K3 / K4 at the training shape.
    q_b, kv_b, row_b = 2 * nb * tq * d, 2 * nb * tk * d, 4 * nb * tq
    work = dict(d=d, q_rows=nb * tq, kv_rows=nb * tk, pairs=pairs)
    assert perf.attention_fwd_cost(**work, lse=True) == (
        4 * d * pairs, 2 * q_b + 2 * kv_b + row_b)
    assert perf.attention_dq_cost(**work) == (
        6 * d * pairs, 3 * q_b + 2 * kv_b + 2 * row_b)
    assert perf.attention_dkv_cost(**work) == (
        8 * d * pairs, 2 * q_b + 4 * kv_b + 2 * row_b)
    # The masked fold: f32 gradients, the mask read once.
    qkv, mask_b = 2 * nb * tq * d, tq * tk
    fold = dict(work, mask_bytes=mask_b)
    assert perf.attention_fwd_cost(**fold, lse=True)[1] == \
        4 * qkv + mask_b + 4 * nb * tq
    assert perf.attention_dq_cost(**fold, grad_bytes=4)[1] == \
        4 * qkv + mask_b + 8 * nb * tq + 2 * qkv
    assert perf.attention_dkv_cost(**fold, grad_bytes=4)[1] == \
        4 * qkv + mask_b + 8 * nb * tq + 4 * qkv
    # K5 at the main shape.
    cols, bh = cs.PROMPT + cs.STEPS // 2 + 1, b * h
    assert perf.decode_cost(d=d, q_rows=bh, new_rows=bh,
                            rows_read=bh * (cols - 1), rows_appended=bh,
                            cols=bh * cols) == (
        4 * d * cols * bh, 2 * d * bh * (2 * (cols - 1) + 2 + 2 + 2))
    # K5p at the serving shape: distinct rows, the table read.
    slots, rows, app, ent, cols = cs.SERVE_SLOTS, 5000, 7, 2048, 9000
    rb = 2 * d * h
    assert perf.decode_cost(d=d, q_rows=slots * h, new_rows=slots * h,
                            rows_read=rows * h, rows_appended=app * h,
                            cols=cols * h, table_entries=ent) == (
        4 * d * h * cols, 2 * rb * rows + 2 * rb * slots + 2 * rb * slots
        + 2 * rb * app + 4 * ent)
    # The general decode bound (int8 K rows, partials out).
    k_row, hkv, k, n_app, rr = d + 4, 4, 5, 3, 777
    out_b = b * h * k * (d + 2) * 4
    assert perf.decode_cost(d=d, q_rows=b * h * k, new_rows=b * hkv * k,
                            rows_read=rr, rows_appended=n_app * hkv,
                            cols=4321, k_row_bytes=k_row,
                            out_row_bytes=(d + 2) * 4)[1] == (
        (k_row + 2 * d) * rr + 2 * d * b * h * k + out_b
        + 2 * 2 * d * b * hkv * k + (k_row + 2 * d) * n_app * hkv)
    # Its bounds read the perf peaks.
    assert cs.bound_ms(989e9, 0) == (1.0, 'operations')
    assert cs.bound_ms(0, 3.35e9) == (1.0, 'bytes')


def test_check_first_call_tolerance():
    def snap(first_s):
        return {'schema': 1, 'entries': {'e': {
            'flops': 100.0, 'bytes_accessed': 100.0,
            'argument_bytes': 100, 'first_call_seconds': first_s}},
            'retrace_totals': {}}
    base, ok, slow = snap(1.0), snap(9.0), snap(40.0)
    tol = perf.Tolerances(first_call_factor=10.0, first_call_slack_s=5.0)
    assert perf.check_snapshots(ok, base, tol=tol, emit_events=False) == []
    v = perf.check_snapshots(slow, base, tol=tol, emit_events=False)
    assert v and 'first_call_seconds' in v[0]
    # A baseline holds no run's times: nothing to gate.
    assert perf.check_snapshots(slow, perf.baseline_view(base), tol=tol,
                                emit_events=False) == []


def test_check_coverage_error_and_retrace_gates():
    entry = {'flops': 1.0, 'bytes_accessed': 1.0, 'argument_bytes': 1}
    base = {'schema': 1, 'entries': {'a': dict(entry)},
            'retrace_totals': {'engine.decode': 1}}
    v = perf.check_snapshots({'schema': 1, 'entries': {},
                              'retrace_totals': {}}, base,
                             emit_events=False)
    assert any(s.startswith('a: coverage') for s in v)
    cur = {'schema': 1, 'entries': {'a': dict(entry), 'b': dict(entry)},
           'retrace_totals': {'engine.decode': 1}}
    v = perf.check_snapshots(cur, base, emit_events=False)
    assert any(s.startswith('b: coverage') for s in v)
    cur = {'schema': 1, 'entries': {'a': {'error': 'boom'}},
           'retrace_totals': {'engine.decode': 1}}
    assert perf.check_snapshots(cur, base, emit_events=False) == [
        'a: error: boom']
    cur = {'schema': 1, 'entries': {'a': dict(entry)},
           'retrace_totals': {'engine.decode': 5, 'new': 2}}
    v = perf.check_snapshots(cur, base, emit_events=False)
    assert sum('retrace_total' in s for s in v) == 2
    v = perf.check_snapshots({'schema': 99}, base, emit_events=False)
    assert v and 'schema' in v[0]


def test_program_model_measured_columns():
    rec = perf.program_model(989e9, 3.35e6, measured_seconds=4e-3)
    assert math.isclose(rec['model_seconds'], 1e-3)
    assert rec['roofline'] == 'compute-bound'
    assert math.isclose(rec['fraction_of_roofline'], 0.25)
    assert math.isclose(rec['measured_gflops_per_s'], 989e9 / 4e-3 / 1e9)
    assert 'measured_seconds' not in perf.program_model(1.0, 1.0)


def test_report_renders_roofline_table(full_snapshot):
    text = perf.render_report(full_snapshot)
    assert 'ops.flash_fwd_bf16' in text and '989 TF/s' in text
    assert 'retrace totals during snapshot: ' in text
    assert 'attention.make_decode_step=2 ' in text
    assert 'engine.decode=5 ' in text


def test_cli_snapshot_and_check(tmp_path):
    env = {**os.environ, 'PYTHONPATH': REPO}
    reg = 'test_torch_obs_perf_registry:ENTRIES'
    (tmp_path / 'test_torch_obs_perf_registry.py').write_text(
        'import sys\n'
        f'sys.path.insert(0, {os.path.join(REPO, "tests")!r})\n'
        'from test_torch_obs_perf import _flash_spec\n'
        "ENTRIES = {'fixture.flash': _flash_spec(False)}\n"
        "PLANTED = {'fixture.flash': _flash_spec(True)}\n")
    env['PYTHONPATH'] = f'{tmp_path}{os.pathsep}{REPO}'

    def run(*args):
        return subprocess.run(
            [sys.executable, '-m', 'distributed_dot_product_tpu_torch.obs'
             '.perf', '--device', 'cpu', '--registry', *args],
            capture_output=True, text=True,
            env=env, cwd=tmp_path, timeout=300)
    base = tmp_path / 'base.json'
    r = run(reg, 'snapshot', '--baseline', '-o', str(base))
    assert r.returncode == 0, r.stderr
    assert run(reg, 'check', '--against', str(base)).returncode == 0
    r = run(reg.replace('ENTRIES', 'PLANTED'), 'check', '--against',
            str(base))
    assert r.returncode == 1
    assert 'PERF REGRESSION: fixture.flash: flops:' in r.stdout


def test_int8_engine_weights_are_row_major():
    """The fault the card's snapshot found (``serve.engine_decode_wq8``:
    cuBLASLt refused the s8 product): the engine quantizes a transposed
    view, and the int8 weight kept its column-major strides. Now every
    quantized weight is row-major (out, in), as ``OwnedDense``'s."""
    from distributed_dot_product_tpu_torch.models.dense import (
        quantize_kernel,
    )
    from distributed_dot_product_tpu_torch.serve import KernelEngine
    w = torch.randn(32, 48)
    for w_q, scale in (quantize_kernel(w.t()), quantize_kernel(w)):
        assert w_q.is_contiguous() and scale.is_contiguous()
    eng = KernelEngine(slots=2, t_max=16, head_dim=32, weight_quant='int8',
                       device='cpu')
    for name in ('_wq', '_wk', '_wv', '_wo'):
        assert getattr(eng, name)[0].is_contiguous(), name


def test_snapshot_runs_on_the_card_unless_asked():
    """The entry points run on the card by default: with no card,
    snapshot() and analyze_spec() without device='cpu' raise at once —
    nothing carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default device runs')
    with pytest.raises(RuntimeError, match="device='cpu'|device=\"cpu\""):
        perf.snapshot({'fixture.flash': _flash_spec(False)})
    spec = _flash_spec(False)('cpu')
    with pytest.raises(RuntimeError):
        perf.analyze_spec(spec)


def test_check_refuses_a_platform_mismatch(tmp_path):
    """check compares snapshots of one platform only: a card snapshot
    against the CPU baseline exits 2 and compares nothing."""
    with open(BASELINE) as f:
        baseline = json.load(f)
    card = dict(baseline, platform='cuda')
    cur = tmp_path / 'card.json'
    cur.write_text(json.dumps(card))
    rc = perf.main(['--device', 'cpu', 'check', '--against', BASELINE,
                    '--current', str(cur)])
    assert rc == 2
    same = tmp_path / 'cpu.json'
    same.write_text(json.dumps(baseline))
    assert perf.main(['--device', 'cpu', 'check', '--against', BASELINE,
                      '--current', str(same)]) == 0
