# -*- coding: utf-8 -*-
"""
The port's flowlint (analysis/flowlint.py) held against the
reference's, on the CPU.

- **Fixtures**: tests/torch_graphlint_fixtures/serve/fx_flow_*.py are
  the reference's fixtures with only the import paths renamed; the port
  engine gives the same (rule, line) set AND the same propagation chains
  (paths read relative to each fixture tree) as the JAX engine on the
  originals, waived records included.
- **Clean-tree gate**: zero flowlint records over the port, active or
  waived.
- **Tables**: SERVING_ROOTS and TYPE_BINDINGS name qualnames that exist
  in the port's modules; the package universe is the port's.
- **CLI**: JSON chains and SARIF levels.
"""

import json
import os
import subprocess
import sys

import pytest

from distributed_dot_product_tpu_torch.analysis import (
    active_violations, run_analysis,
)
from distributed_dot_product_tpu_torch.analysis import flowlint

pytestmark = pytest.mark.analysis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, 'tests', 'graphlint_fixtures', 'serve')
TORCH_FIXTURES = os.path.join(REPO, 'tests', 'torch_graphlint_fixtures',
                              'serve')
FLOW_FIXTURES = ('fx_flow_escape.py', 'fx_flow_totality.py',
                 'fx_flow_reason.py', 'fx_flow_shard.py')


def _key(v, tree):
    """A record with its fixture-tree prefix dropped from every path
    (the messages name the same roots and classes but the port's own
    history notes, so they are compared by their anchors)."""
    strip = (lambda s: s.replace(tree, '<fx>') if s else s)
    return (v.rule, strip(v.file), v.line, v.allowed,
            tuple(strip(h) for h in v.chain) if v.chain else None,
            tuple(sorted(set(_names(v.message)))))


def _names(message):
    """The qualnames and exception classes a message names."""
    import re
    return re.findall(r'\b[A-Z][a-z][A-Za-z]*(?:\.[a-z_]+)?\b', message)


@pytest.mark.parametrize('fixture', FLOW_FIXTURES)
def test_flowlint_matches_reference_on_copy(fixture):
    from distributed_dot_product_tpu.analysis import flowlint as ref
    want = {_key(v, 'tests/graphlint_fixtures/serve')
            for v in ref.lint_file(os.path.join(FIXTURES, fixture),
                                   repo_root=REPO)}
    got = {_key(v, 'tests/torch_graphlint_fixtures/serve')
           for v in flowlint.lint_file(os.path.join(TORCH_FIXTURES,
                                                    fixture),
                                       repo_root=REPO)}
    assert got == want, (sorted(got), sorted(want))
    assert got, fixture


def test_typed_escape_renders_transitive_chain():
    path = os.path.join(TORCH_FIXTURES, 'fx_flow_escape.py')
    rel = 'tests/torch_graphlint_fixtures/serve/fx_flow_escape.py'
    vs = active_violations(flowlint.lint_file(path, repo_root=REPO))
    (v,) = [v for v in vs if 'KeyError' in v.message]
    assert 'Server.step' in v.message
    assert v.chain is not None and len(v.chain) == 3, v.chain
    assert all(h.startswith(f'{rel}:') for h in v.chain)
    assert v.chain[-1] == f'{v.file}:{v.line}'
    assert ' → '.join(v.chain) in v.message


def test_flowlint_clean_tree_gate_zero_debt():
    violations = run_analysis(rules=list(flowlint.FLOW_RULES),
                              jaxpr=False)
    assert violations == [], '\n'.join(v.render() for v in violations)


def test_tables_name_the_ports_code():
    """The universe is the port package (no analysis/), and every name
    the tables hold exists there: the serving roots' qualnames, the
    typed contract's classes (but the builtin RuntimeError), the type
    bindings' classes."""
    import ast
    assert flowlint._PKG_PREFIX == 'distributed_dot_product_tpu_torch.'
    paths = flowlint._package_universe_paths()
    assert paths and all(
        f'{os.sep}distributed_dot_product_tpu_torch{os.sep}' in p
        and f'{os.sep}analysis{os.sep}' not in p for p in paths)
    classes, quals = set(), {}
    for path in paths:
        rel = os.path.relpath(path, os.path.join(
            REPO, 'distributed_dot_product_tpu_torch')).replace(os.sep, '/')
        with open(path, encoding='utf-8') as f:
            tree = ast.parse(f.read())
        names = quals.setdefault(rel, set())
        for n in tree.body:
            if isinstance(n, ast.FunctionDef):
                names.add(n.name)
            elif isinstance(n, ast.ClassDef):
                classes.add(n.name)
                names |= {f'{n.name}.{m.name}' for m in n.body
                          if isinstance(m, ast.FunctionDef)}
    for suffix, roots in flowlint.SERVING_ROOTS.items():
        assert set(roots) <= quals[suffix], (suffix, roots)
    assert set(flowlint.TYPED_CONTRACT) - {'RuntimeError'} <= classes
    assert set(flowlint.TOTALITY_BASES) <= classes
    for (cls, _attr), targets in flowlint.TYPE_BINDINGS.items():
        assert cls in classes and set(targets) <= classes, cls


def _cli(*args):
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    return subprocess.run(
        [sys.executable, '-m', 'distributed_dot_product_tpu_torch.analysis',
         *args], capture_output=True, text=True, cwd=REPO, env=env,
        timeout=300)


def _fx(name):
    return os.path.join('tests', 'torch_graphlint_fixtures', 'serve', name)


def test_cli_json_chains_and_sarif_levels():
    res = _cli('--no-jaxpr', '--format', 'json', '--rule',
               'typed-escape', _fx('fx_flow_escape.py'))
    assert res.returncode == 1, res.stdout + res.stderr
    records = json.loads(res.stdout)
    assert records and all(r['rule'] == 'typed-escape' for r in records)
    assert any(r['chain'] and len(r['chain']) == 3 for r in records)
    assert any(r['allowed'] for r in records)
    res = _cli('--no-jaxpr', '--format', 'sarif',
               *(_fx(f) for f in FLOW_FIXTURES))
    assert res.returncode == 1, res.stdout + res.stderr
    results = json.loads(res.stdout)['runs'][0]['results']
    assert {r['ruleId'] for r in results} >= set(flowlint.FLOW_RULES)
    assert any(r['level'] == 'note' and r['ruleId'] == 'typed-escape'
               for r in results)
