# -*- coding: utf-8 -*-
"""
``python -m distributed_dot_product_tpu_torch.analysis`` — the port's
graphlint CLI, the reference's flags plus ``--device``.

Exit status: 0 when clean, 1 when any ACTIVE violation (each rendered
as ``file:line: rule [entrypoint]: message``), 2 on usage errors.
Registration-waived records (``TraceSpec.allow`` — known debt of a
registered entry) render with an ``(allowed)`` mark and never fail the
run; ``--format json`` carries them with ``"allowed": true``.

The graph pass (``--no-jaxpr`` skips it; the reference's name) runs
every registered entrypoint on ``--device``: the card by default, and
without one it fails rather than carry on on the CPU — pass ``--device
cpu`` to run the kernels' plain versions there.
"""

import argparse
import os
import sys


def main(argv=None):
    from distributed_dot_product_tpu_torch.analysis.base import (
        RULES, format_violations,
    )
    parser = argparse.ArgumentParser(
        prog='python -m distributed_dot_product_tpu_torch.analysis',
        description='graphlint: graph/AST static analysis enforcing '
                    'the port\'s perf and correctness contracts')
    parser.add_argument('paths', nargs='*',
                        help='files/dirs for the AST pass (default: '
                             'the package + scripts/torch_*.py + '
                             'tests/test_torch_*.py + tests/torch_*.py)')
    parser.add_argument('--changed-only', nargs='?', const='HEAD',
                        metavar='REF', default=None,
                        help='lint only .py files changed vs the git '
                             'ref (default HEAD) plus untracked ones — '
                             'the fast pre-commit mode. The graph/'
                             'registry pass still runs when a changed '
                             'file can affect a registered entrypoint '
                             '(ops/, models/, parallel/, obs/, '
                             'serve/engine.py, train.py, analysis/), '
                             'else it is skipped')
    parser.add_argument('--rule', action='append', dest='rules',
                        metavar='ID', choices=sorted(RULES),
                        help='run only this rule (repeatable)')
    parser.add_argument('--format', choices=('text', 'json', 'sarif'),
                        default='text',
                        help='text (one line each), json (stable '
                             'rule/file/line/chain dicts), or sarif '
                             '(SARIF 2.1.0 for inline CI annotation)')
    parser.add_argument('--no-jaxpr', action='store_true',
                        help='skip the (slower) graph/registry pass')
    parser.add_argument('--no-ast', action='store_true',
                        help='skip the AST pass')
    parser.add_argument('--registry', metavar='MODULE:ATTR',
                        help='lint this {name: builder} mapping instead '
                             'of the central registry (the negative-'
                             'fixture tests drive the CLI through '
                             'seeded regressions this way)')
    parser.add_argument('--list-rules', action='store_true',
                        help='print the rule catalog and exit')
    parser.add_argument('--device', default='cuda',
                        help="where the graph pass runs the registered "
                             "entrypoints: 'cuda' (default; raises "
                             "without a card) or 'cpu' (the kernels' "
                             'plain versions)')
    args = parser.parse_args(argv)

    if args.list_rules:
        for rid in sorted(RULES):
            print(f'{rid}:\n    {RULES[rid]}')
        return 0

    if args.rules:
        from distributed_dot_product_tpu_torch.analysis.astlint import (
            AST_RULES,
        )
        from distributed_dot_product_tpu_torch.analysis.conclint import (
            CONC_RULES,
        )
        from distributed_dot_product_tpu_torch.analysis.determlint import (
            DETERM_RULES,
        )
        from distributed_dot_product_tpu_torch.analysis.flowlint import (
            FLOW_RULES,
        )
        from distributed_dot_product_tpu_torch.analysis.torch_rules import (
            JAXPR_RULES,
        )
        from distributed_dot_product_tpu_torch.analysis.protolint import (
            PROTO_RULES,
        )
        static = (set(AST_RULES) | set(JAXPR_RULES) | set(PROTO_RULES)
                  | set(CONC_RULES) | set(DETERM_RULES)
                  | set(FLOW_RULES) | {'parse-error'})
        runtime_only = [r for r in args.rules if r not in static]
        if runtime_only:
            parser.error(
                f'{", ".join(runtime_only)}: enforced at RUNTIME by the '
                f'retrace sentinel (analysis/retrace.py; on under '
                f'pytest), not statically — there is nothing for this '
                f'command to check')

    if args.changed_only is not None:
        if args.paths:
            parser.error('--changed-only computes its own file set — '
                         'drop the explicit paths')
        try:
            changed = changed_files(args.changed_only)
        except RuntimeError as e:
            parser.error(str(e))
        if not changed:
            # Notices go to stderr: --format json owns stdout.
            print(f'graphlint: no .py files changed vs '
                  f'{args.changed_only} — nothing to lint',
                  file=sys.stderr)
            if args.format != 'text':
                print(format_violations([], fmt=args.format))
            return 0
        args.paths = changed
        if not args.no_jaxpr and not any(
                _affects_registry(p) for p in changed):
            print(f'graphlint: changed files cannot affect registered '
                  f'entrypoints — skipping the graph pass '
                  f'({len(changed)} files, AST rules only)',
                  file=sys.stderr)
            args.no_jaxpr = True

    if not args.no_jaxpr:
        from distributed_dot_product_tpu_torch.utils.comm import (
            resolve_device,
        )
        try:
            resolve_device(args.device)
        except RuntimeError as e:        # no card: never the CPU instead
            parser.error(str(e))

    entrypoints = None
    if args.registry:
        from distributed_dot_product_tpu_torch.analysis.registry import (
            resolve_registry_arg,
        )
        try:
            entrypoints = resolve_registry_arg(args.registry)
        except ValueError as e:
            parser.error(str(e))

    from distributed_dot_product_tpu_torch.analysis import (
        active_violations, run_analysis,
    )
    violations = run_analysis(
        paths=args.paths or None, rules=args.rules,
        # Explicit (absolute) changed-file paths still render
        # repo-relative in violations.
        repo_root=_repo_root() if args.changed_only is not None
        else None,
        jaxpr=not args.no_jaxpr, ast_rules=not args.no_ast,
        entrypoints=entrypoints, device=args.device)
    print(format_violations(violations, fmt=args.format))
    # `allowed` records (registration-level debt, TraceSpec.allow) are
    # rendered but never fail the run.
    return 1 if active_violations(violations) else 0


def _repo_root():
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _affects_registry(path):
    """Can a change to ``path`` alter a registered entrypoint's graph?
    Conservative path heuristic over the LAYER_HOOKS modules plus the
    analysis subsystem itself."""
    norm = os.path.abspath(path).replace(os.sep, '/')
    return any(frag in norm for frag in (
        '/ops/', '/models/', '/parallel/', '/analysis/',
        '/serve/engine.py', '/train.py', '/obs/', '/utils/comm.py',
        '/csrc/'))


def _in_port_scope(name):
    """Is the repo-relative ``name`` one of the port's files (the
    package, its scripts, tests and harness twins)? The reference's
    files stay the reference linter's."""
    import fnmatch
    name = name.replace(os.sep, '/')
    return (name.startswith('distributed_dot_product_tpu_torch/')
            or any(fnmatch.fnmatch(name, pat) for pat in (
                'scripts/torch_*.py', 'tests/test_torch_*.py',
                'tests/torch_*.py', 'torch_example*.py',
                'examples/torch_*.py', 'chip_smoke.py')))


def changed_files(ref='HEAD'):
    """The port's .py files changed vs ``ref`` (tracked diff +
    untracked), as absolute paths of files that still exist.
    RuntimeError when git cannot resolve the ref — the CLI maps it to a
    usage error."""
    import subprocess
    root = _repo_root()

    def _git(*argv):
        res = subprocess.run(['git', *argv], cwd=root,
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f'--changed-only: git {" ".join(argv)} failed: '
                f'{res.stderr.strip() or res.stdout.strip()}')
        return res.stdout.splitlines()

    names = _git('diff', '--name-only', '--diff-filter=d', ref,
                 '--', '*.py')
    names += _git('ls-files', '--others', '--exclude-standard',
                  '--', '*.py')
    out = []
    for name in dict.fromkeys(n.strip() for n in names if n.strip()):
        # The deliberate-violation fixture tree is excluded from the
        # full walk (iter_python_files); explicitly-named files bypass
        # that exclusion, so a changed-files sweep must apply it here
        # or any PR touching a fixture fails its own pre-commit lint.
        if 'graphlint_fixtures' in name or '__pycache__' in name \
                or not _in_port_scope(name):
            continue
        path = os.path.join(root, name)
        if os.path.isfile(path):
            out.append(path)
    return out


if __name__ == '__main__':
    try:
        sys.exit(main())
    except BrokenPipeError:     # `... | head` closed the pipe: not an error
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
