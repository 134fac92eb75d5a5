# -*- coding: utf-8 -*-
"""
The port's graphlint (distributed_dot_product_tpu_torch/analysis/) held
against the reference's (distributed_dot_product_tpu/analysis/), on the
CPU.

- **Rendering**: the port's ``format_violations`` is byte-equal to the
  reference's on the same records (text, JSON, SARIF — SARIF with the
  same rule texts, since the catalog's texts say what each rule means
  in its own tree).
- **AST rules**: the port's fixtures (tests/torch_graphlint_fixtures/)
  are line-for-line torch translations of the reference's; the port
  flags the same (rule, line) set on them as the JAX astlint on the
  originals. One port-only fixture seeds a clock read inside a
  CUDA-graph capture.
- **Graph rules**: each jaxpr_negatives.py case has a torch twin
  (torch_negatives.py) flagged with the rule id the JAX linter gives the
  original.
- **Clean-tree gate**: the full port analyzer on the CPU reports zero
  active violations, and its waived debt is exactly the pinned set.
- **CLI**: exit 0/1/2, ``--list-rules``, ``--format json``, the card as
  the default device.
"""

import json
import os
import subprocess
import sys

import pytest

from distributed_dot_product_tpu_torch.analysis import (
    active_violations, base as port_base, run_analysis,
)
from distributed_dot_product_tpu_torch.analysis import astlint, torch_rules

pytestmark = pytest.mark.analysis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, 'tests', 'graphlint_fixtures')
TORCH_FIXTURES = os.path.join(REPO, 'tests', 'torch_graphlint_fixtures')


def _fixture_modules():
    """Both negative-fixture modules (``tests`` resolves as a namespace
    package when the repo root is on sys.path)."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from tests.graphlint_fixtures import jaxpr_negatives
    from tests.torch_graphlint_fixtures import torch_negatives
    return jaxpr_negatives, torch_negatives


def _records(base):
    V = base.Violation
    return [
        V(rule='host-pull', message='a host read', file='a/ops/x.py',
          line=3),
        V(rule='f32-accum', message='narrow', entrypoint='lm.head_bf16',
          allowed=True),
        V(rule='typed-escape', message='leak', file='s/engine.py',
          line=9, chain=('s/engine.py:1', 's/engine.py:9')),
        V(rule='cache-alias', message='copy', entrypoint='decode.step',
          file='m/decode.py', line=40),
    ]


@pytest.mark.parametrize('fmt', ['text', 'json', 'sarif'])
def test_format_violations_byte_equal_to_reference(fmt, monkeypatch):
    from distributed_dot_product_tpu.analysis import base as ref_base
    want = ref_base.format_violations(_records(ref_base), fmt=fmt)
    own = port_base.format_violations(_records(port_base), fmt=fmt)
    if fmt == 'sarif':
        # Only the rule catalog's texts differ (each says what the rule
        # means in its tree): with the reference's texts the bytes agree.
        monkeypatch.setattr(port_base, 'RULES', ref_base.RULES)
        same = port_base.format_violations(_records(port_base), fmt=fmt)
        assert same == want
        strip = json.loads(own)
        for rule in strip['runs'][0]['tool']['driver']['rules']:
            rule.pop('shortDescription')
        ref = json.loads(want)
        for rule in ref['runs'][0]['tool']['driver']['rules']:
            rule.pop('shortDescription')
        assert strip == ref
    else:
        assert own == want
    # The summary lines: nothing found, and only waived records.
    for keep in ([], [1]):
        port = [_records(port_base)[i] for i in keep]
        ref = [_records(ref_base)[i] for i in keep]
        assert (port_base.format_violations(port, fmt=fmt)
                == ref_base.format_violations(ref, fmt=fmt)
                or fmt == 'sarif')


def test_rule_ids_are_the_references():
    from distributed_dot_product_tpu.analysis import base as ref_base
    from distributed_dot_product_tpu.analysis.jaxpr_rules import (
        JAXPR_RULES,
    )
    assert set(port_base.RULES) == set(ref_base.RULES)
    assert torch_rules.JAXPR_RULES == JAXPR_RULES
    assert astlint.AST_RULES == ('host-pull', 'traced-bool-branch',
                                 'clock-in-jit', 'silent-except')


# -- AST rules: the translated fixtures -----------------------------------

def _expected_lines(path):
    with open(path, encoding='utf-8') as f:
        return [i for i, line in enumerate(f, 1) if '# VIOLATION' in line]


@pytest.mark.parametrize('fixture, rule', [
    (os.path.join('ops', 'fx_host_pull.py'), 'host-pull'),
    (os.path.join('ops', 'fx_traced_bool.py'), 'traced-bool-branch'),
    ('fx_clock_in_jit.py', 'clock-in-jit'),
    ('fx_span_in_jit.py', 'clock-in-jit'),
    ('fx_silent_except.py', 'silent-except'),
])
def test_ast_rule_matches_reference_on_translation(fixture, rule):
    from distributed_dot_product_tpu.analysis.astlint import (
        lint_file as ref_lint,
    )
    orig = os.path.join(FIXTURES, fixture)
    twin = os.path.join(TORCH_FIXTURES, fixture)
    with open(orig, encoding='utf-8') as a, open(twin,
                                                 encoding='utf-8') as b:
        assert len(a.readlines()) == len(b.readlines())
    want = {(v.rule, v.line) for v in ref_lint(orig, repo_root=REPO)}
    got = {(v.rule, v.line) for v in astlint.lint_file(twin,
                                                       repo_root=REPO)}
    assert got == want, (fixture, sorted(got), sorted(want))
    assert got == {(rule, ln) for ln in _expected_lines(twin)}


def test_clock_in_cuda_graph_capture_is_flagged():
    path = os.path.join(TORCH_FIXTURES, 'fx_graph_capture.py')
    vs = astlint.lint_file(path, repo_root=REPO)
    assert {(v.rule, v.line) for v in vs} == {
        ('clock-in-jit', ln) for ln in _expected_lines(path)}


def test_host_metadata_reads_are_not_pulls(tmp_path):
    """Shape / dtype / device reads of a tensor answer on the host, and
    the torch namespaces that answer on the host are not tensors: none
    of them is a device sync."""
    hot = tmp_path / 'ops'
    hot.mkdir()
    src = hot / 'meta.py'
    src.write_text(
        'import torch\n\n\n'
        'def f(x):\n'
        '    y = torch.relu(x)\n'
        '    n = int(y.shape[0])\n'
        '    m = int(y.size(1))\n'
        '    k = int(torch.cuda.device_count())\n'
        '    b = bool(torch.cuda.is_available())\n'
        '    return n, m, k, b, float(y.sum())\n')
    vs = astlint.lint_file(str(src), repo_root=str(tmp_path))
    assert [(v.rule, v.line) for v in vs] == [('host-pull', 10)]


# -- graph rules: the torch twins of jaxpr_negatives -------------------------

_NEGATIVE_NAMES = ('neg.f32_accum', 'neg.cache_rematerialize',
                   'neg.paged_pool_rematerialize', 'neg.full_shape_dus',
                   'neg.cache_upcast', 'neg.missing_donation',
                   'neg.collective_axis', 'neg.trace_error')


@pytest.mark.parametrize('name', _NEGATIVE_NAMES)
def test_graph_rule_flags_twin_as_reference_flags_original(name, devices):
    from distributed_dot_product_tpu.analysis.jaxpr_rules import lint_spec
    ref_mod, port_mod = _fixture_modules()
    assert set(port_mod.ALL) == set(ref_mod.ALL) == set(_NEGATIVE_NAMES)
    ref_builder, rule = ref_mod.ALL[name]
    ref_fired = {v.rule for v in lint_spec(ref_builder(),
                                           rules=[rule, 'trace-error'])}
    builder, port_rule = port_mod.ALL[name]
    assert port_rule == rule
    vs = torch_rules.lint_entrypoints({name: builder},
                                      rules=[rule, 'trace-error'],
                                      device='cpu')
    fired = {v.rule for v in vs}
    assert rule in ref_fired and rule in fired, (name, ref_fired, fired)
    assert fired == ref_fired
    assert all(v.entrypoint == name for v in vs)


def test_f32_accum_names_the_fixture_line():
    _, port_mod = _fixture_modules()
    builder, rule = port_mod.ALL['neg.f32_accum']
    (v,) = torch_rules.lint_spec(builder('cpu'), rules=[rule])
    assert v.file == os.path.join('tests', 'torch_graphlint_fixtures',
                                  'torch_negatives.py')
    assert v.line and v.line > 0


def test_restricted_rules_run_subset():
    _, port_mod = _fixture_modules()
    builder, _ = port_mod.ALL['neg.cache_upcast']
    assert torch_rules.lint_spec(builder('cpu'),
                                 rules=['collective-axis']) == []


def test_f32_accum_passes_with_reduced_precision_reduction_off(
        monkeypatch):
    import torch
    _, port_mod = _fixture_modules()
    builder, rule = port_mod.ALL['neg.f32_accum']
    monkeypatch.setattr(torch.backends.cuda.matmul,
                        'allow_bf16_reduced_precision_reduction', False)
    assert torch_rules.lint_spec(builder('cpu'), rules=[rule]) == []


# -- the clean-tree gate --------------------------------------------------

# The registered debt (TraceSpec.allow), ROADMAP §3: bf16 GEMMs with
# cuBLAS's reduced-precision reduction allowed, and the plain slab decode
# multiplying the bf16 cache in float32.
ALLOWED_DEBT = {
    ('attention.fwd_flash', 'f32-accum'),
    ('attention.fwd_flash_bf16', 'f32-accum'),
    ('attention.fwd_ring', 'f32-accum'),
    ('attention.fwd_ulysses', 'f32-accum'),
    ('decode.seq_parallel_step', 'f32-accum'),
    ('decode.seq_parallel_step', 'cache-upcast'),
    ('decode.seq_parallel_step_bf16', 'f32-accum'),
    ('decode.seq_parallel_step_bf16', 'cache-upcast'),
    ('decode.step_xla_slots', 'cache-upcast'),
    ('decode.step_kernel_int8', 'cache-upcast'),
    ('decode.step_sharded', 'cache-upcast'),
    ('decode.step_verify_slab', 'cache-upcast'),
    ('lm.head_bf16', 'f32-accum'),
    ('lm.loss_f32', 'f32-accum'),
    ('lm.loss_bf16', 'f32-accum'),
    ('train.lm_step', 'f32-accum'),
}


@pytest.fixture(scope='module')
def full_run():
    stats = {}
    return run_analysis(device='cpu', stats=stats), stats


def test_clean_tree_gate(full_run):
    """THE gate: zero ACTIVE violations across the port's AST scan
    (astlint, the servelint families, flowlint) and every registered
    entrypoint's graph rules, run on the CPU — and the waived records
    are exactly the registered debt: new debt fails here."""
    violations, _ = full_run
    active = active_violations(violations)
    assert active == [], '\n'.join(v.render() for v in active)
    waived = {(v.entrypoint, v.rule) for v in violations if v.allowed}
    assert waived == ALLOWED_DEBT


def test_registry_covers_every_layer(full_run):
    """The port registers every name the reference does, train.lm_step
    included, and the graph pass ran (and counted the aten ops of)
    each."""
    from distributed_dot_product_tpu.analysis.registry import (
        default_entrypoints as ref_entrypoints,
    )
    from distributed_dot_product_tpu_torch.analysis.registry import (
        default_entrypoints,
    )
    _, stats = full_run
    names = set(default_entrypoints())
    assert set(ref_entrypoints()) <= names
    assert len(names) == 32 and 'train.lm_step' in names
    assert set(stats) == names
    assert all(s['ops'] > 0 for s in stats.values())


def test_default_paths_are_the_ports():
    from distributed_dot_product_tpu_torch.analysis import default_paths
    paths = [os.path.relpath(p, REPO) for p in default_paths()]
    assert paths[0] == 'distributed_dot_product_tpu_torch'
    assert 'tests/test_torch_graphlint.py' in paths
    assert not any(p.startswith('distributed_dot_product_tpu' + os.sep)
                   or p in ('tests/test_graphlint.py', 'example.py')
                   for p in paths)


# -- CLI ------------------------------------------------------------------

def _cli(*args):
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    return subprocess.run(
        [sys.executable, '-m', 'distributed_dot_product_tpu_torch.analysis',
         *args], capture_output=True, text=True, cwd=REPO, env=env,
        timeout=300)


def test_cli_exit_0_on_the_tree():
    res = _cli('--device', 'cpu')
    assert res.returncode == 0, res.stdout + res.stderr
    assert 'graphlint: no violations' in res.stdout


def test_cli_exit_1_on_ast_fixture():
    res = _cli('--no-jaxpr',
               os.path.join('tests', 'torch_graphlint_fixtures', 'ops',
                            'fx_host_pull.py'))
    assert res.returncode == 1, res.stdout + res.stderr
    assert 'fx_host_pull.py:' in res.stdout
    assert 'host-pull' in res.stdout


def test_cli_exit_1_on_graph_twins_json():
    res = _cli('--no-ast', '--device', 'cpu', '--format', 'json',
               '--registry',
               'tests.torch_graphlint_fixtures.torch_negatives:REGISTRY')
    assert res.returncode == 1, res.stdout + res.stderr
    records = json.loads(res.stdout)
    assert {r['rule'] for r in records} == {
        'f32-accum', 'cache-alias', 'cache-upcast', 'donation',
        'collective-axis', 'trace-error'}
    assert all(set(r) >= {'rule', 'file', 'line', 'chain', 'allowed'}
               for r in records)


def test_cli_exit_2_without_a_card():
    """The graph pass runs on the card by default: with none it is a
    usage error naming the CPU opt-in, never a quiet CPU run."""
    import torch
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default device runs')
    res = _cli()
    assert res.returncode == 2, res.stdout + res.stderr
    assert "device='cpu'" in res.stderr.replace('"', "'")
    assert res.stdout == ''


def test_cli_exit_2_on_usage_errors():
    assert _cli('--rule', 'no-such-rule').returncode == 2
    res = _cli('--rule', 'retrace-budget', '--no-jaxpr')
    assert res.returncode == 2 and 'RUNTIME' in res.stderr


def test_cli_list_rules():
    res = _cli('--list-rules')
    assert res.returncode == 0
    for rule in ('f32-accum', 'cache-alias', 'retrace-budget',
                 'silent-except', 'typed-escape', 'tick-determinism'):
        assert rule in res.stdout


def test_cli_changed_only_stays_in_the_port():
    from distributed_dot_product_tpu_torch.analysis.__main__ import (
        _in_port_scope, changed_files,
    )
    assert _in_port_scope('distributed_dot_product_tpu_torch/train.py')
    assert _in_port_scope('tests/test_torch_retrace.py')
    assert _in_port_scope('examples/torch_train_lm.py')
    assert not _in_port_scope('distributed_dot_product_tpu/train.py')
    assert not _in_port_scope('tests/test_graphlint.py')
    assert not _in_port_scope('examples/train_lm.py')
    files = changed_files('HEAD')
    assert all(_in_port_scope(os.path.relpath(f, REPO)) for f in files)
    with pytest.raises(RuntimeError):
        changed_files('definitely-not-a-ref')
