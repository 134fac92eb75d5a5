# -*- coding: utf-8 -*-
"""
``graphlint`` for the port — static analysis that mechanically enforces
the port's performance and correctness contracts; the counterpart of
``distributed_dot_product_tpu/analysis``, with the same rule ids, so
``# graphlint: allow[<rule>]`` means the same in both trees.

Five engines (see the README's section on the port's static analysis):

- **Graph rules** (:mod:`.torch_rules` over :mod:`.registry`): run every
  registered entrypoint once, on the device it is given, under a
  dispatch mode and judge the aten ops it issues — float32 accumulation
  of low-precision matmuls, in-place (aliased) KV-cache appends and
  donated storages, no cache-shaped upcasts, collectives only on the
  groups of declared mesh axes. The CUDA kernels are invisible to it
  (``chip_smoke.py`` holds them against their plain versions).
- **Retrace sentinel** (:mod:`.retrace`): runtime budgets on the number
  of input signatures the serving and decode steps see; on by default
  under pytest.
- **AST ruleset** (:mod:`.astlint`): pure-``ast`` hazard patterns —
  host reads of torch-derived values and tensor-predicate branching in
  hot paths, clock reads inside compiled functions and CUDA-graph
  captures, silent broad excepts.
- **servelint** (:mod:`.protolint` / :mod:`.conclint` /
  :mod:`.determlint`): the serving/obs layer's contracts — emit call
  sites vs the closed EVENT_SCHEMA vocabulary and the RejectReason
  taxonomy, ``# guarded-by:`` lock discipline plus daemon/named thread
  discipline, and real-time/random/environ reads inside declared
  virtual-clock tick paths (``GRAPHLINT_TICK_ROOTS`` closures, with the
  intentional real-time modules in determlint's REAL_TIME_CONTRACT).
- **flowlint** (:mod:`.flowlint`): interprocedural typed-failure flow
  at the declared serving roots, handler totality on typed serving
  errors, RejectReason taxonomy liveness, and ShardedPageTable
  stride-ownership.

CLI: ``python -m distributed_dot_product_tpu_torch.analysis`` (exit 0 =
no active violations; the graph rules run on the card unless given
``--device cpu``). The clean-tree gate test
(tests/test_torch_graphlint.py) asserts a clean tree on the CPU.

This ``__init__`` stays import-light (no torch): serving code imports
:mod:`.retrace` at build time, and pulling the whole linter (which
imports every layer) along with it would be an import cycle.
"""

from distributed_dot_product_tpu_torch.analysis.base import (  # noqa: F401
    RULES, Violation, active_violations, format_violations,
)
from distributed_dot_product_tpu_torch.analysis.retrace import (  # noqa: F401
    RetraceBudgetExceeded, watch_traces,
)

__all__ = ['RULES', 'Violation', 'active_violations',
           'format_violations', 'watch_traces',
           'RetraceBudgetExceeded', 'run_analysis', 'default_paths']


def default_paths(root=None):
    """The AST pass's default files: the port package, and the port's
    own scripts and tests (``scripts/torch_*.py``, ``tests/test_torch_
    *.py``, ``tests/torch_*.py``). The reference's files stay the
    reference linter's."""
    import glob
    import os
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = root or os.path.dirname(pkg)
    paths = [pkg]
    for pattern in (('scripts', 'torch_*.py'), ('tests', 'test_torch_*.py'),
                    ('tests', 'torch_*.py')):
        paths.extend(sorted(p for p in glob.glob(os.path.join(root,
                                                              *pattern))
                            if os.path.isfile(p)))
    return paths


def run_analysis(paths=None, rules=None, repo_root=None,
                 jaxpr=True, ast_rules=True, entrypoints=None,
                 device='cuda', stats=None):
    """Run the full analyzer; returns a list of
    :class:`~distributed_dot_product_tpu_torch.analysis.base.Violation`.

    ``paths``: files/dirs for the AST pass (default:
    :func:`default_paths`). ``rules``: restrict to these rule ids
    (default: all). ``jaxpr``: run the graph rules (the reference's
    name for its graph pass) over ``entrypoints``, a ``{name: builder}``
    mapping (default: the central registry), each built on ``device`` —
    the card unless the caller asks for the CPU. ``stats``, a dict,
    receives the graph pass's per-entry ops and kernel launches.
    """
    import os
    violations = []
    if ast_rules:
        from distributed_dot_product_tpu_torch.analysis import (
            astlint, conclint, determlint, flowlint, protolint,
        )
        if paths is None:
            paths = default_paths()
            pkg = os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))
            repo_root = repo_root or os.path.dirname(pkg)
        # 'parse-error' is emitted by the AST pass (unconditionally, on
        # unparseable files) — requesting it must run that pass.
        ast_rule_set = None if rules is None else \
            [r for r in rules
             if r in astlint.AST_RULES or r == 'parse-error']
        if ast_rule_set is None or ast_rule_set:
            violations.extend(astlint.lint_paths(
                paths, repo_root=repo_root, rules=ast_rule_set))
        # servelint families ride the same AST pass and path set.
        for mod, fam in ((protolint, protolint.PROTO_RULES),
                         (conclint, conclint.CONC_RULES),
                         (determlint, determlint.DETERM_RULES),
                         (flowlint, flowlint.FLOW_RULES)):
            fam_rules = None if rules is None else \
                [r for r in rules if r in fam]
            if fam_rules is None or fam_rules:
                violations.extend(mod.lint_paths(
                    paths, repo_root=repo_root, rules=fam_rules))
    if jaxpr:
        from distributed_dot_product_tpu_torch.analysis import torch_rules
        from distributed_dot_product_tpu_torch.utils.comm import (
            resolve_device,
        )
        graph_rule_set = None if rules is None else \
            [r for r in rules if r in torch_rules.JAXPR_RULES]
        if graph_rule_set is None or graph_rule_set:
            dev = resolve_device(device)
            if dev.type == 'cuda':
                from distributed_dot_product_tpu_torch.ops import _build
                _build.build_all()
            if entrypoints is None:
                from distributed_dot_product_tpu_torch.analysis.registry \
                    import default_entrypoints
                entrypoints = default_entrypoints()
            violations.extend(torch_rules.lint_entrypoints(
                entrypoints, rules=graph_rule_set, device=str(dev),
                stats=stats))
    return violations
