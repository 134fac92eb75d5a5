# -*- coding: utf-8 -*-
"""
Shared vocabulary of the analysis subsystem: the :class:`Violation`
record every engine emits, the rule catalog (id → what the rule guards
in the port), and the suppression pragma.

A violation is always anchored: ``file:line`` for AST rules, the
registered entrypoint name (plus the source line that issued the
offending aten op, where one is found on the stack) for graph rules.
The CLI and the clean-tree gate test both render these records, so an
analyzer finding is actionable from its one-line form.

Suppression: a trailing ``# graphlint: allow[<rule-id>]`` comment on
the offending line (or the line directly above) waives that rule for
that site — deliberate exceptions stay visible and greppable in the
source instead of accumulating in a config file. The flowlint family
spells the same pragma ``# flowlint: allow[<rule-id>]``; both prefixes
parse identically.
"""

import dataclasses
import re
from typing import Optional

__all__ = ['Violation', 'RULES', 'allowed_by_pragma',
           'active_violations', 'format_violations']

# Rule catalog: the reference's rule ids, each text saying what the
# rule means in the port. Graph rules run every registered entrypoint
# once under a dispatch mode (analysis/torch_rules.py) and judge the
# aten ops it issues; AST rules parse source; retrace-budget is
# enforced at runtime by the retrace sentinel (analysis/retrace.py).
RULES = {
    'f32-accum': (
        'every matmul-family aten op (mm/bmm/addmm/baddbmm/_int_mm/'
        'linear) on low-precision (bf16/f16/int8) operands must give a '
        'float32 (int32 for int8) result or run with cuBLAS\'s reduced-'
        'precision reduction off (torch.backends.cuda.matmul.allow_'
        'bf16/fp16_reduced_precision_reduction) — the fp32-accumulation '
        'contract of the matmul-heavy paths; the CUDA kernels carry it '
        'throughout and chip_smoke.py holds them to it'),
    'donation': (
        'entrypoints declared as donating (KV-cache serving steps) '
        'must hand back at least min_donated of their input storages '
        '— a step that returns fresh buffers copies the full cache '
        'every token'),
    'cache-alias': (
        'each declared cache buffer must come back as the SAME storage '
        '(appended in place) and no op may build a cache-shaped tensor '
        'out of place from a cache input (cat, clone, out-of-place '
        'index_put/scatter, arithmetic) — a re-materialized cache turns '
        'the in-place append into a per-token cache copy'),
    'cache-upcast': (
        'no _to_copy may widen a cache-shaped tensor: upcasting the KV '
        'buffer (e.g. bf16→f32 before a matmul) materializes a '
        'full-size copy every step — keep the buffer narrow and '
        'accumulate wide in the product instead'),
    'collective-axis': (
        'every collective issued through utils/comm.py must run on the '
        "process group of an axis on the entrypoint's declared mesh "
        '(TraceSpec.mesh_axes) — a collective on another group means '
        'the program is being built against the wrong topology'),
    'trace-error': (
        'a registered entrypoint failed to build or run at its declared '
        'example shapes — the registration or the entrypoint itself '
        'regressed'),
    'host-pull': (
        'float()/int()/bool()/np.asarray()/.item()/.tolist()/.cpu() on '
        'a torch-derived value in ops/, models/, serve/ or obs/ reads '
        'the tensor back to the host — on the card a device sync on '
        'every call'),
    'traced-bool-branch': (
        'python `if`/`while` on a tensor predicate (torch.any/all/'
        'isfinite/isnan/allclose/equal/isin) in ops/, models/, serve/ '
        'or obs/ syncs the card to branch on the host (and breaks a '
        'CUDA-graph capture) — use torch.where / masks'),
    'clock-in-jit': (
        'time.time()/perf_counter()/monotonic() (or an obs span) inside '
        'a torch.compile / torch.jit.script / @triton.jit function or a '
        'CUDA-graph capture reads the clock once, at compile or capture '
        'time, and replays that constant — time outside the compiled '
        'region'),
    'parse-error': (
        'a scanned file does not parse as python — reported regardless '
        'of any --rule filter (a broken file can hide any violation)'),
    'silent-except': (
        'a broad except (bare / Exception / BaseException) that '
        'neither re-raises nor logs swallows real failures — log '
        'through utils.tracing.log_exception or narrow the type'),
    'retrace-budget': (
        'runtime rule (analysis/retrace.py): a watched decode/serve '
        'program may not see more new input signatures (tensor shapes, '
        'dtypes, devices and static arguments) than its declared '
        'budget — a fixed-shape step keeps its shapes, which a CUDA '
        'graph needs'),
    # -- servelint: protocol / concurrency / determinism ----------------
    'event-vocab': (
        'protolint (analysis/protolint.py): a literal event kind at an '
        'emit() call site must exist in the closed obs/events.py '
        'EVENT_SCHEMA vocabulary — an unknown kind raises mid-incident '
        'at runtime; here it fails at PR time'),
    'event-fields': (
        'protolint: a literal emit() payload must carry every field '
        'EVENT_SCHEMA requires for its kind (calls forwarding **kwargs '
        'are skipped — only statically-complete payloads are judged)'),
    'reject-reason': (
        'protolint: a serve.reject `reason` must be a RejectReason '
        'member — a literal string must be one of the enum values, and '
        'a RejectReason attribute must name a member and emit its '
        '.value (the enum object would serialize as its repr)'),
    'guarded-by': (
        'conclint (analysis/conclint.py): a field annotated '
        '`# guarded-by: self._lock` may only be read or written inside '
        'a `with self._lock:` block (exempt: __init__, methods named '
        '*_locked — the caller holds the lock by convention)'),
    'thread-discipline': (
        'conclint: every threading.Thread(...) must be daemon=True and '
        'carry a name= — a non-daemon thread blocks interpreter '
        'shutdown on a wedged step, and an unnamed one is anonymous in '
        'the flight recorder\'s stack dumps'),
    'tick-determinism': (
        'determlint (analysis/determlint.py): no real-time reads '
        '(time.time/monotonic/sleep/perf_counter), `random` module '
        'calls, np.random, or os.environ reads inside a declared '
        'virtual-clock tick path (GRAPHLINT_TICK_ROOTS and their '
        'intra-module call closure) — the seeded bit-reproducible '
        'replay contract; intentional real-time sites live in '
        'determlint\'s REAL_TIME_CONTRACT table'),
    # -- flowlint: interprocedural typed-failure flow -------------------
    'typed-escape': (
        'flowlint (analysis/flowlint.py): every exception class that '
        'can escape a declared serving root (SERVING_ROOTS — '
        'Scheduler.step/submit, Router.step/submit, KernelEngine.step/'
        'prefill/verify_step, run_trace) must be in the typed failure '
        'contract (TYPED_CONTRACT: RejectedError, PageCorruptionError, '
        'shard-exhaustion RuntimeError, ServeContractError, '
        'UnknownReplicaError) — a raw KeyError/IndexError/ValueError '
        'escape flags with its propagation chain file:line → file:line'),
    'handler-totality': (
        'flowlint: an `except` of a typed serving error (RejectedError/'
        'PageCorruptionError or a subclass) must re-raise, route the '
        'failure into the event/metric ladder (emit/log_exception/'
        'count_reject/reject — directly or transitively), or consume '
        'the typed payload (.reason/.pages/.site) — silently dropping '
        'a typed failure un-types it'),
    'reason-coverage': (
        'flowlint: every RejectReason member needs ≥ 1 raise/convert '
        'reference site plus serve.reject emit and per-reason counter '
        'coverage — a dead enum member is taxonomy the operator '
        'dashboards promise but no code path can produce'),
    'shard-ownership': (
        'flowlint: host code outside models/decode.py must reach '
        'ShardedPageTable geometry through its helpers (gpage/gsplit/'
        'page_shard/owner/owned_range/tracked_pages), never raw '
        '`pages_per_shard + 1` stride arithmetic — the contiguous-'
        'ownership layout has exactly one home'),
}

_PRAGMA = re.compile(
    r'#\s*(?:graphlint|flowlint):\s*allow\[([a-z0-9_,\s-]+)\]')


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str                       # id from RULES
    message: str
    file: Optional[str] = None      # repo-relative where possible
    line: Optional[int] = None
    entrypoint: Optional[str] = None  # registry name (graph rules)
    # Waived-but-visible: a registration-level allowance (TraceSpec
    # .allow — known debt of a registered entry) keeps the record in
    # `--format json` output without failing the CLI or the gate, so
    # known debt stays enumerable instead of disappearing into a
    # pragma. flowlint pragma waivers ride the same flag — a waived
    # failure-flow site is debt, not absence.
    allowed: bool = False
    # typed-escape only: the propagation chain root → origin raise as
    # ('file:line', ...) hops — the `--format json` shape README
    # documents (rule/file/line/chain are the stable keys).
    chain: Optional[tuple] = None

    def render(self):
        where = f'{self.file}:{self.line}' if self.file else '<registry>'
        entry = f' [{self.entrypoint}]' if self.entrypoint else ''
        mark = ' (allowed)' if self.allowed else ''
        return f'{where}: {self.rule}{entry}{mark}: {self.message}'


def allowed_by_pragma(source_lines, lineno, rule):
    """True when the 1-based ``lineno`` (or the line above) carries a
    ``# graphlint: allow[rule]`` pragma naming ``rule``."""
    for ln in (lineno, lineno - 1):
        if 1 <= ln <= len(source_lines):
            m = _PRAGMA.search(source_lines[ln - 1])
            if m and rule in {r.strip() for r in m.group(1).split(',')}:
                return True
    return False


def active_violations(violations):
    """The violations that FAIL a run (``allowed=False``) — the CLI
    exit code and the tier-1 gate both judge this subset; allowed
    records stay visible in the rendered output."""
    return [v for v in violations if not v.allowed]


def format_violations(violations, fmt='text'):
    """Render a violation list for the CLI: ``text`` (one line each),
    ``json`` (a list of plain dicts, ``allowed`` records included), or
    ``sarif`` (a minimal SARIF 2.1.0 log — one run, ruleId/level/
    message/location per result — so CI can annotate findings inline;
    ``allowed`` records carry level ``note``, active ones ``error``)."""
    if fmt == 'json':
        import json
        return json.dumps([dataclasses.asdict(v) for v in violations],
                          indent=2)
    if fmt == 'sarif':
        import json
        results = []
        for v in violations:
            entry = f' [{v.entrypoint}]' if v.entrypoint else ''
            res = {
                'ruleId': v.rule,
                'level': 'note' if v.allowed else 'error',
                'message': {'text': f'{v.message}{entry}'},
            }
            if v.file:
                res['locations'] = [{'physicalLocation': {
                    'artifactLocation': {
                        'uri': v.file.replace('\\', '/')},
                    'region': {'startLine': int(v.line or 1)},
                }}]
            results.append(res)
        used = sorted({v.rule for v in violations})
        log = {
            '$schema': 'https://json.schemastore.org/sarif-2.1.0.json',
            'version': '2.1.0',
            'runs': [{
                'tool': {'driver': {
                    'name': 'graphlint',
                    'rules': [{'id': r,
                               'shortDescription':
                                   {'text': RULES.get(r, r)}}
                              for r in used],
                }},
                'results': results,
            }],
        }
        return json.dumps(log, indent=2)
    act = active_violations(violations)
    n_allowed = len(violations) - len(act)
    lines = [v.render() for v in violations]
    if not act:
        lines.append('graphlint: no violations'
                     + (f' ({n_allowed} allowed by registration)'
                        if n_allowed else ''))
    else:
        lines.append(f'graphlint: {len(act)} violation'
                     f'{"s" if len(act) != 1 else ""}'
                     + (f' (+{n_allowed} allowed)' if n_allowed else ''))
    return '\n'.join(lines)
