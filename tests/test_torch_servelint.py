# -*- coding: utf-8 -*-
"""
The port's servelint families (analysis/protolint.py, conclint.py,
determlint.py) held against the reference's, on the CPU.

- **Fixtures**: tests/torch_graphlint_fixtures/serve/ holds copies of
  tests/graphlint_fixtures/serve/fx_*.py with only the import paths
  renamed (the line numbers kept); each port engine flags the same
  (rule, line) set on a copy as the reference engine on its original,
  and exactly the copy's own ``# VIOLATION: <rule>`` markers.
- **Clean-tree gate**: zero active servelint violations over the port.
- **Tick roots**: the port declares the reference's
  ``GRAPHLINT_TICK_ROOTS``; the REAL_TIME_CONTRACT names functions that
  exist and is load-bearing.
- **CLI**: exit 1 over the fixture set, ``--rule`` filtering.
"""

import os
import subprocess
import sys

import pytest

from distributed_dot_product_tpu_torch.analysis import (
    active_violations, run_analysis,
)
from distributed_dot_product_tpu_torch.analysis import (
    conclint, determlint, protolint,
)
from torch_serving import cyclic_gc_paused  # noqa: E402,F401  autouse

pytestmark = pytest.mark.analysis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, 'tests', 'graphlint_fixtures', 'serve')
TORCH_FIXTURES = os.path.join(REPO, 'tests', 'torch_graphlint_fixtures',
                              'serve')
PKG = os.path.join(REPO, 'distributed_dot_product_tpu_torch')

SERVELINT_RULES = (list(protolint.PROTO_RULES) + list(conclint.CONC_RULES)
                   + list(determlint.DETERM_RULES))


def _expected(path):
    out = set()
    with open(path, encoding='utf-8') as f:
        for i, line in enumerate(f, 1):
            if '# VIOLATION:' in line:
                rule = line.split('# VIOLATION:')[1].strip().split()[0]
                out.add((rule, i))
    return out


def _code(src):
    """``src``'s syntax tree without docstrings (comments are not in
    it): the code a linter judges."""
    import ast
    tree = ast.parse(src)
    for node in ast.walk(tree):
        body = getattr(node, 'body', None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            body[0] = ast.Pass()
    return ast.dump(tree)


def test_fixture_copies_rename_only_imports():
    """The copies keep every line where it was and every statement as
    it was, with the imports renamed (their notes name no history)."""
    for name in sorted(os.listdir(FIXTURES)):
        if not name.endswith('.py'):
            continue
        with open(os.path.join(FIXTURES, name), encoding='utf-8') as f:
            orig = f.read()
        with open(os.path.join(TORCH_FIXTURES, name),
                  encoding='utf-8') as f:
            copy = f.read()
        renamed = orig.replace('distributed_dot_product_tpu.',
                               'distributed_dot_product_tpu_torch.')
        assert copy.count('\n') == orig.count('\n'), name
        assert _code(copy) == _code(renamed), name


@pytest.mark.parametrize('fixture, family', [
    ('fx_proto_events.py', 'protolint'),
    ('fx_conc_guarded.py', 'conclint'),
    ('fx_tick_clock.py', 'determlint'),
])
def test_rule_matches_reference_on_copy(fixture, family):
    import importlib
    ref = importlib.import_module(
        f'distributed_dot_product_tpu.analysis.{family}')
    port = {'protolint': protolint, 'conclint': conclint,
            'determlint': determlint}[family]
    want = {(v.rule, v.line) for v in ref.lint_file(
        os.path.join(FIXTURES, fixture), repo_root=REPO)}
    path = os.path.join(TORCH_FIXTURES, fixture)
    vs = port.lint_file(path, repo_root=REPO)
    got = {(v.rule, v.line) for v in vs}
    assert got == want, (fixture, sorted(got), sorted(want))
    assert got == _expected(path)
    assert all(v.file and v.file.endswith(fixture) for v in vs)
    assert not any(v.allowed for v in vs)


def test_determlint_transitive_closure_reaches_helper():
    path = os.path.join(TORCH_FIXTURES, 'fx_tick_clock.py')
    vs = determlint.lint_file(path, repo_root=REPO)
    assert any('time.sleep' in v.message and '_throttle' in v.message
               for v in vs), '\n'.join(v.render() for v in vs)


def test_servelint_clean_tree_gate():
    violations = run_analysis(rules=SERVELINT_RULES, jaxpr=False)
    active = active_violations(violations)
    assert active == [], '\n'.join(v.render() for v in active)


@pytest.mark.parametrize('module', ['scheduler', 'loadgen', 'policy',
                                    'router', 'control'])
def test_tick_roots_are_the_references(module):
    import importlib
    ref = importlib.import_module(f'distributed_dot_product_tpu.serve.'
                                  f'{module}')
    port = importlib.import_module(f'distributed_dot_product_tpu_torch.'
                                   f'serve.{module}')
    assert port.GRAPHLINT_TICK_ROOTS == ref.GRAPHLINT_TICK_ROOTS


def test_real_time_contract_names_existing_functions():
    """Every qualname the contract waives exists in the port module it
    is keyed by (a renamed function would silently drop its waiver)."""
    import ast
    for suffix, entry in determlint.REAL_TIME_CONTRACT.items():
        path = os.path.join(PKG, *suffix.split('/'))
        assert os.path.isfile(path), suffix
        if entry == '*':
            continue
        with open(path, encoding='utf-8') as f:
            functions = determlint._functions_by_qualname(ast.parse(
                f.read()))
        assert set(entry) <= set(functions), (suffix, entry)


def test_real_time_contract_covers_the_waived_sites():
    """With the scheduler / loadgen entries removed, the closure DOES
    flag their deliberate real-time reads: the contract table (and the
    tick roots the port now declares) is what keeps the tree green."""
    import unittest.mock as mock
    table = dict(determlint.REAL_TIME_CONTRACT)
    table['serve/scheduler.py'] = {}
    table['serve/loadgen.py'] = {}
    with mock.patch.object(determlint, 'REAL_TIME_CONTRACT', table):
        vs = determlint.lint_paths([os.path.join(PKG, 'serve')],
                                   repo_root=REPO)
    assert {v.rule for v in vs} == {'tick-determinism'}
    hit_files = {os.path.basename(v.file) for v in vs}
    assert hit_files == {'scheduler.py', 'loadgen.py'}, hit_files


def test_conclint_locked_suffix_is_exempt():
    path = os.path.join(TORCH_FIXTURES, 'fx_conc_guarded.py')
    vs = conclint.lint_file(path, repo_root=REPO)
    lines = {v.line for v in vs}
    with open(path, encoding='utf-8') as f:
        src = f.readlines()
    locked_line = next(i for i, l in enumerate(src, 1)
                       if '_compact_locked' in l and 'def' in l)
    assert not any(locked_line <= ln <= locked_line + 2 for ln in lines)


def _cli(*args):
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    return subprocess.run(
        [sys.executable, '-m', 'distributed_dot_product_tpu_torch.analysis',
         *args], capture_output=True, text=True, cwd=REPO, env=env,
        timeout=300)


def _fx(name):
    return os.path.join('tests', 'torch_graphlint_fixtures', 'serve', name)


def test_cli_nonzero_on_servelint_fixtures():
    res = _cli('--no-jaxpr', _fx('fx_proto_events.py'),
               _fx('fx_conc_guarded.py'), _fx('fx_tick_clock.py'))
    assert res.returncode == 1, res.stdout + res.stderr
    for rule in SERVELINT_RULES:
        assert rule in res.stdout, f'{rule} missing from CLI output'


def test_cli_rule_filter_runs_single_family():
    res = _cli('--no-jaxpr', '--rule', 'guarded-by',
               _fx('fx_conc_guarded.py'))
    assert res.returncode == 1, res.stdout + res.stderr
    assert 'guarded-by' in res.stdout
    assert 'thread-discipline' not in res.stdout
