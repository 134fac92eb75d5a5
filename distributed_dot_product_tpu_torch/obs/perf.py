# -*- coding: utf-8 -*-
"""
Program cost and roofline accounting of every registered entrypoint —
the static half of the perf observatory (``obs/devmon.py`` is the live
half). The port of ``distributed_dot_product_tpu/obs/perf.py``.

The reference lowers each entrypoint registered in
``analysis/registry.py`` and reads XLA's cost and memory analysis. Here
each entrypoint runs once under a counting mode, on the CPU or on the
card, and records:

- FLOPs, counted by ``torch.utils.flop_counter.FlopCounterMode``, and
  bytes accessed (every tensor each non-view aten op reads and writes,
  XLA's "bytes accessed" before fusion). FlopCounterMode does not see
  the port's CUDA kernels (ctypes launches, K1–K5p), so each kernel
  wrapper reports its call through :func:`kernel_work`, and the count
  inside it is replaced by the kernel's own formula
  (:data:`KERNEL_COSTS`): operations and the bytes of each operand read
  once and each result written once, from the shapes and the data the
  call attends. The same formulas give ``chip_smoke.py``'s kernel
  bounds, and a kernel's roofline reads the same work whatever
  implements it (the kernel on the card, its plain version on the CPU).
- argument and output bytes, and on the card the peak memory of the
  call (``torch.cuda.max_memory_allocated``; absent from a CPU
  snapshot).
- first-call seconds (the reference's compile seconds), the kernel
  libraries already built (``ops/_build.py``).
- collectives by kind, counted at ``utils/comm.py``'s entry points, and
  the kernel calls by name.
- ``retrace_totals``: the retrace sentinel's counts
  (``analysis/retrace.py``) incurred while the snapshot ran, by name.

From FLOPs and bytes it derives the arithmetic intensity and a roofline
model time against :data:`DEFAULT_PEAKS`, the H100 SXM's published
dense bf16 rate and HBM3 bandwidth (the one place those constants live).
A snapshot taken on the card also times each entry with CUDA events
(``measured_seconds``) and gives the model's share of it
(``fraction_of_roofline``).

CLI::

    python -m distributed_dot_product_tpu_torch.obs.perf --device cpu snapshot --baseline -o PERF_BASELINE_TORCH.json
    python -m distributed_dot_product_tpu_torch.obs.perf --device cpu check --against PERF_BASELINE_TORCH.json
    python -m distributed_dot_product_tpu_torch.obs.perf report
    python -m distributed_dot_product_tpu_torch.obs.perf --device cpu report

Every entry point runs on the card unless given ``--device cpu`` /
``device='cpu'``; without a card it raises rather than carry on on the
CPU. ``snapshot`` writes a schema-versioned JSON snapshot (the committed
baseline holds a CPU snapshot's deterministic fields); ``check`` exits 1
on per-entry tolerance violations, naming the entry and metric, and
emits ``perf.regression`` events when an event log is active — and
exits 2, comparing nothing, when the two snapshots were taken on
different platforms (card times never meet the CPU baseline);
``report`` renders the roofline table.
"""

import contextlib
import dataclasses
import json
import statistics
import sys
import time
from typing import Optional

__all__ = ['PERF_SCHEMA_VERSION', 'HardwarePeaks', 'DEFAULT_PEAKS',
           'Tolerances', 'KERNEL_COSTS', 'attention_fwd_cost',
           'attention_dq_cost', 'attention_dkv_cost', 'decode_cost',
           'kernel_work', 'CostCounter', 'program_model', 'analyze_spec',
           'snapshot', 'baseline_view', 'check_snapshots', 'render_report',
           'main']

PERF_SCHEMA_VERSION = 1

# Fields compared with a symmetric relative tolerance by `check`, where
# both snapshots carry them (peak_bytes only a card snapshot does).
# argument_bytes is fully determined by the registered example shapes
# and dtypes — a widened cache dtype shows up here as an exact 2x.
_REL_FIELDS = ('flops', 'bytes_accessed', 'argument_bytes',
               'peak_bytes')


@dataclasses.dataclass(frozen=True)
class HardwarePeaks:
    """Roofline ceilings: one NVIDIA H100 SXM's published dense rates at
    its full 700 W limit — 989 TFLOP/s bf16 on the tensor cores, 1,979
    TOP/s int8, 3.35 TB/s of HBM3."""
    flops_per_s: float = 989e12
    bytes_per_s: float = 3.35e12
    int8_ops_per_s: float = 1979e12

    @property
    def ridge_flops_per_byte(self) -> float:
        """Arithmetic intensity at which the roofline knee sits: above
        it a program can saturate the tensor cores, below it HBM is the
        wall."""
        return self.flops_per_s / self.bytes_per_s

    def as_dict(self):
        return {'flops_per_s': self.flops_per_s,
                'bytes_per_s': self.bytes_per_s,
                'int8_ops_per_s': self.int8_ops_per_s,
                'ridge_flops_per_byte': self.ridge_flops_per_byte}


DEFAULT_PEAKS = HardwarePeaks()


@dataclasses.dataclass(frozen=True)
class Tolerances:
    """Per-entry gate widths for :func:`check_snapshots`. ``rel`` bounds
    flops / bytes / memory drift symmetrically; first-call time passes
    while ``current <= baseline * first_call_factor +
    first_call_slack_s`` (machines differ — only an order-of-magnitude
    blowup is a finding); retrace totals allow ``retrace_slack`` extra
    traces. ``abs_floor`` exempts absolute drifts below it (units of the
    compared field): the smallest registered entries are a few KiB."""
    rel: float = 0.25
    first_call_factor: float = 10.0
    first_call_slack_s: float = 5.0
    retrace_slack: int = 0
    abs_floor: float = 64 * 1024.0


# -- the kernels' own work ----------------------------------------------
#
# Each returns ``(operations, bytes)``: operations on the attended
# (query row, key column) pairs, bytes of each operand read once and each
# result written once. Rows count over every (batch, head): ``q_rows`` is
# batch x query heads x query rows, ``kv_rows`` batch x kv heads x key
# rows read.

def attention_fwd_cost(*, d, q_rows, kv_rows, pairs, mask_bytes=0,
                       lse=False):
    """K1 / K2: QKᵀ and PV on ``pairs`` pairs (4·d each); q, k, v read
    and out written in bf16, the boolean mask read, the float32 row
    logsumexp written with ``lse``."""
    return (4 * d * pairs,
            2 * d * (2 * q_rows + 2 * kv_rows) + mask_bytes
            + (4 * q_rows if lse else 0))


def attention_dq_cost(*, d, q_rows, kv_rows, pairs, mask_bytes=0,
                      grad_bytes=2):
    """K3: scores, dp and dq (6·d a pair); the folded q and dO, k and v
    read in bf16, lse and delta (float32) read, dq written at
    ``grad_bytes`` an element."""
    return (6 * d * pairs,
            2 * d * (2 * q_rows + 2 * kv_rows) + grad_bytes * d * q_rows
            + mask_bytes + 8 * q_rows)


def attention_dkv_cost(*, d, q_rows, kv_rows, pairs, mask_bytes=0,
                       grad_bytes=2):
    """K4: scores, dp, dk and dv (8·d a pair); q, dO, k and v read in
    bf16, lse and delta read, dk and dv written at ``grad_bytes``."""
    return (8 * d * pairs,
            2 * d * (2 * q_rows + 2 * kv_rows)
            + 2 * grad_bytes * d * kv_rows + mask_bytes + 8 * q_rows)


def decode_cost(*, d, q_rows, new_rows, rows_read, rows_appended, cols,
                k_row_bytes=None, out_row_bytes=None, table_entries=0):
    """K5 / K5p, one fused step: 4·d operations per attended (query
    head row, column) pair (``cols``); the cached K and V rows read
    (``rows_read``, K at ``k_row_bytes`` a row, default bf16; V bf16),
    q read (``q_rows`` head rows) and the output written
    (``out_row_bytes`` a row, default bf16), k_new and v_new read
    (``new_rows`` kv-head rows each), the appended rows written, the
    page table read (``table_entries`` int32)."""
    k_row = 2 * d if k_row_bytes is None else k_row_bytes
    out_row = 2 * d if out_row_bytes is None else out_row_bytes
    return (4 * d * cols,
            (k_row + 2 * d) * rows_read + 2 * d * q_rows + out_row * q_rows
            + 2 * 2 * d * new_rows + (k_row + 2 * d) * rows_appended
            + 4 * table_entries)


KERNEL_COSTS = {
    'flash_attention': attention_fwd_cost,           # K1
    'flash_attention_bounded': attention_fwd_cost,   # K2
    'flash_attention_dq': attention_dq_cost,         # K3
    'flash_attention_dkv': attention_dkv_cost,       # K4
    'flash_decode': decode_cost,                     # K5
    'flash_decode_paged': decode_cost,               # K5p
}


# -- accounting ---------------------------------------------------------

_ACTIVE = None          # the running CostCounter; None: accounting off
_OFF = contextlib.nullcontext()


def kernel_work(name, shape):
    """The kernel wrappers' hook: ``with kernel_work(name, shape):``
    around the call that runs kernel ``name`` (or its plain version).
    ``shape`` is a callable giving the keyword arguments of
    ``KERNEL_COSTS[name]`` for this call; it runs only while a
    :class:`CostCounter` is active — otherwise this is one global read
    and a shared null context."""
    counter = _ACTIVE
    if counter is None:
        return _OFF
    return counter.kernel(name, shape)


def _nbytes(obj, seen=None):
    """Bytes of every distinct tensor in ``obj`` (tensors, modules'
    parameters and buffers, and containers of them)."""
    import torch
    seen = set() if seen is None else seen
    if isinstance(obj, torch.Tensor):
        key = (obj.data_ptr(), obj.numel(), obj.dtype)
        if key in seen:
            return 0
        seen.add(key)
        return obj.numel() * obj.element_size()
    if isinstance(obj, torch.nn.Module):
        return sum(_nbytes(t, seen) for t in
                   list(obj.parameters()) + list(obj.buffers()))
    if isinstance(obj, dict):
        return sum(_nbytes(v, seen) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_nbytes(v, seen) for v in obj)
    return 0


def _byte_mode(observe=None):
    """A dispatch mode summing the bytes each non-view aten op reads and
    writes (allocations without a read are not traffic). ``observe``,
    when given, is called as ``observe(func, args, kwargs, out)`` after
    every aten op: ``analysis/torch_rules.py`` judges the ops it sees
    through it."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    import torch
    skip = {torch.ops.aten.empty.memory_format,
            torch.ops.aten.empty_strided.default,
            torch.ops.aten.empty_like.default}

    class _Bytes(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not getattr(func, 'is_view', False) and func not in skip:
                self.total += sum(
                    t.numel() * t.element_size() for t in
                    tree_leaves((args, kwargs, out))
                    if isinstance(t, torch.Tensor))
            if observe is not None:
                observe(func, args, kwargs or {}, out)
            return out

    return _Bytes()


class CostCounter:
    """Counts one run's FLOPs (``FlopCounterMode``) and bytes, with each
    kernel call's count replaced by its formula (:func:`kernel_work`).
    ``kernels`` maps a kernel name to ``{'calls', 'flops', 'bytes'}``,
    its calls and their formula's work."""

    def __init__(self):
        from torch.utils.flop_counter import FlopCounterMode
        self._flops = FlopCounterMode(display=False)
        self._bytes = _byte_mode()
        self._depth = 0
        self._adjust_flops = 0
        self._adjust_bytes = 0
        self.kernels = {}

    def __enter__(self):
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError('a CostCounter is already active')
        self._flops.__enter__()
        self._bytes.__enter__()
        _ACTIVE = self
        return self

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = None
        self._bytes.__exit__(*exc)
        self._flops.__exit__(*exc)
        return False

    @property
    def flops(self):
        return self._flops.get_total_flops() + self._adjust_flops

    @property
    def bytes(self):
        return self._bytes.total + self._adjust_bytes

    @contextlib.contextmanager
    def kernel(self, name, shape):
        if self._depth:              # a kernel inside a kernel's region
            yield
            return
        f0, b0 = self._flops.get_total_flops(), self._bytes.total
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1
        flops, nbytes = KERNEL_COSTS[name](**shape())
        self._adjust_flops += flops - (self._flops.get_total_flops() - f0)
        self._adjust_bytes += nbytes - (self._bytes.total - b0)
        rec = self.kernels.setdefault(name, {'calls': 0, 'flops': 0,
                                             'bytes': 0})
        rec['calls'] += 1
        rec['flops'] += flops
        rec['bytes'] += nbytes


# -- program-level model ------------------------------------------------

def program_model(flops, nbytes, *, measured_seconds=None, peaks=None):
    """Roofline model of one program from its counted FLOPs and bytes,
    as a plain JSON-serializable dict. With ``measured_seconds``, also
    the model-vs-measured columns: achieved GFLOP/s and GB/s over the
    counted work and the model's share of the measured time (1.0 = the
    program runs at its roofline)."""
    peaks = peaks or DEFAULT_PEAKS
    flops, nbytes = float(flops), float(nbytes)
    ai = (flops / nbytes) if nbytes else float('inf')
    model_s = max(flops / peaks.flops_per_s, nbytes / peaks.bytes_per_s)
    out = {
        'flops': flops,
        'bytes_accessed': nbytes,
        'arithmetic_intensity': ai,
        'roofline': ('compute-bound' if ai >= peaks.ridge_flops_per_byte
                     else 'bandwidth-bound'),
        'model_seconds': model_s,
    }
    if measured_seconds and measured_seconds > 0:
        out['measured_seconds'] = measured_seconds
        out['measured_gflops_per_s'] = flops / measured_seconds / 1e9
        out['measured_gb_per_s'] = nbytes / measured_seconds / 1e9
        out['fraction_of_roofline'] = model_s / measured_seconds
    return out


# -- entrypoint-level analysis ------------------------------------------

def _sync(device):
    import torch
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def _event_seconds(fn, args, reps):
    """Median seconds of ``fn(*args)`` over ``reps`` calls, CUDA events
    around each (two warm calls first)."""
    import torch
    for _ in range(2):
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return statistics.median(times)


def analyze_spec(spec, device='cuda', *, peaks=None, reps=20):
    """Run one registered entrypoint on ``device`` (the card unless the
    caller asks for the CPU; without a card this raises) and return its
    cost record: a first call (timed), a counted call, and on the card
    the timed calls. Never raises for a broken entry: the record then
    carries an ``error`` field (check treats that as a violation)."""
    import torch

    from distributed_dot_product_tpu_torch.utils import comm
    peaks = peaks or DEFAULT_PEAKS
    cuda = comm.resolve_device(device).type == 'cuda'
    try:
        t0 = time.perf_counter()
        spec.fn(*spec.args)
        _sync(device)
        first = time.perf_counter() - t0
        coll0 = comm.collective_counts()
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
        with CostCounter() as cost:
            out = spec.fn(*spec.args)
        _sync(device)
        coll1 = comm.collective_counts()
        rec = program_model(cost.flops, cost.bytes, peaks=peaks)
        rec.update(argument_bytes=_nbytes(spec.args),
                   output_bytes=_nbytes(out))
        if cuda:
            rec['peak_bytes'] = (torch.cuda.max_memory_allocated(device)
                                 - base + rec['argument_bytes'])
            rec.update(program_model(
                cost.flops, cost.bytes, peaks=peaks,
                measured_seconds=_event_seconds(spec.fn, spec.args, reps)))
    except Exception as e:  # graphlint: allow[silent-except]
        msg = str(e).splitlines()[0] if str(e) else repr(e)
        return {'error': f'{type(e).__name__}: {msg}'}  # reported, not lost
    coll = {k: coll1[k] - coll0.get(k, 0) for k in coll1
            if coll1[k] - coll0.get(k, 0)}
    rec.update(first_call_seconds=first, collectives=coll,
               n_collectives=sum(coll.values()), kernels=cost.kernels)
    return rec


def _build_entry(name, build, device):
    """Builder → spec with the registry-name override the linter also
    applies."""
    spec = build(device)
    if spec.name != name:
        spec = spec.replace(name=name)
    return spec


def snapshot(entrypoints=None, *, device='cuda', peaks=None):
    """Run every registered entrypoint on ``device`` — the card unless
    the caller asks for the CPU; without a card this raises — and return
    the schema-versioned snapshot dict ``check``/``report`` consume. On
    the card the kernel libraries are built first, so no first call pays
    the build. ``retrace_totals`` are the retrace sentinel's counts
    (analysis/retrace.py) incurred while building this snapshot, so the
    number is deterministic whatever the process ran before."""
    import torch

    from distributed_dot_product_tpu_torch.analysis import retrace
    from distributed_dot_product_tpu_torch.analysis.registry import (
        default_entrypoints,
    )
    from distributed_dot_product_tpu_torch.utils.comm import resolve_device
    peaks = peaks or DEFAULT_PEAKS
    dev = resolve_device(device)
    if dev.type == 'cuda':
        from distributed_dot_product_tpu_torch.ops import _build
        _build.build_all()
    if entrypoints is None:
        entrypoints = default_entrypoints()
    # retrace.totals() spans live AND retired counters, so the
    # before/after diff is immune to GC timing and to whatever the
    # process ran (and discarded) before this snapshot began.
    before = retrace.totals()
    entries = {}
    for name, build in entrypoints.items():
        try:
            spec = _build_entry(name, build, device)
        except Exception as e:  # graphlint: allow[silent-except]
            msg = str(e).splitlines()[0] if str(e) else repr(e)
            entries[name] = {'error': f'builder failed: {msg}'}  # reported
            continue
        entries[name] = analyze_spec(spec, device, peaks=peaks)
    after = retrace.totals()
    return {
        'schema': PERF_SCHEMA_VERSION,
        'created_unix': time.time(),
        'torch_version': torch.__version__,
        'cuda_version': torch.version.cuda,
        'platform': dev.type,
        'device_kind': (torch.cuda.get_device_name(dev)
                        if dev.type == 'cuda' else 'cpu'),
        'n_devices': (torch.cuda.device_count() if dev.type == 'cuda'
                      else 1),
        'peaks': peaks.as_dict(),
        'entries': entries,
        'retrace_totals': {name: after[name] - before.get(name, 0)
                           for name in sorted(after)},
    }


# Fields of one run, not of the programs: left out of a baseline.
_RUN_FIELDS = ('first_call_seconds', 'measured_seconds',
               'measured_gflops_per_s', 'measured_gb_per_s',
               'fraction_of_roofline')


def baseline_view(snap):
    """``snap`` without what varies from run to run (the time it was
    taken, first-call and measured times): the deterministic fields a
    committed baseline holds."""
    out = {k: v for k, v in snap.items() if k != 'created_unix'}
    out['entries'] = {
        name: {k: v for k, v in e.items() if k not in _RUN_FIELDS}
        for name, e in snap['entries'].items()}
    return out


# -- the regression gate ------------------------------------------------

def check_snapshots(current, baseline, *, tol: Optional[Tolerances] = None,
                    emit_events=True):
    """Compare a current snapshot against a baseline; returns a list of
    human-readable violation strings (empty = gate passes). Every
    violation also lands in the active observability event log as a
    ``perf.regression`` event (when one is active)."""
    tol = tol or Tolerances()
    violations = []

    def _flag(entry, metric, msg, cur=None, base=None):
        violations.append(f'{entry}: {metric}: {msg}')
        if emit_events:
            from distributed_dot_product_tpu_torch.obs import events
            if events.get_active() is not None:
                events.emit('perf.regression', entry=entry, metric=metric,
                            current=cur, baseline=base, detail=msg)

    for snap, label in ((current, 'current'), (baseline, 'baseline')):
        if snap.get('schema') != PERF_SCHEMA_VERSION:
            return [f'<snapshot>: schema: {label} snapshot has schema='
                    f'{snap.get("schema")!r} (expected '
                    f'{PERF_SCHEMA_VERSION}) — refresh it with '
                    f'`perf snapshot`']

    base_entries = baseline.get('entries', {})
    cur_entries = current.get('entries', {})
    for name, base in base_entries.items():
        cur = cur_entries.get(name)
        if cur is None:
            _flag(name, 'coverage', 'entry present in the baseline but '
                  'missing from the current snapshot (deregistered? '
                  'refresh the baseline if intentional)')
            continue
        if 'error' in cur:
            _flag(name, 'error', cur['error'])
            continue
        if 'error' in base:
            # A now-working entry is an improvement — require a refresh,
            # not a pass, so the baseline never rots silently.
            _flag(name, 'error', f'baseline recorded an error '
                  f'({base["error"]}) — refresh the baseline')
            continue
        for field in _REL_FIELDS:
            if field not in base or field not in cur:
                continue
            b, c = float(base[field]), float(cur[field])
            limit = max(tol.rel * abs(b), tol.abs_floor)
            if abs(c - b) > limit:
                _flag(name, field,
                      f'{c:,.0f} vs baseline {b:,.0f} '
                      f'(|Δ|={abs(c - b):,.0f} > ±{limit:,.0f} at '
                      f'rel tol {tol.rel})', cur=c, base=b)
        if 'first_call_seconds' not in base or \
                'first_call_seconds' not in cur:
            continue                 # a baseline holds no run's times
        b = float(base['first_call_seconds'])
        c = float(cur['first_call_seconds'])
        limit = b * tol.first_call_factor + tol.first_call_slack_s
        if c > limit:
            _flag(name, 'first_call_seconds',
                  f'{c:.2f}s vs baseline {b:.2f}s (limit {limit:.2f}s '
                  f'= x{tol.first_call_factor} + '
                  f'{tol.first_call_slack_s}s)', cur=c, base=b)
    for name in cur_entries:
        if name not in base_entries:
            _flag(name, 'coverage', 'entry not in the baseline — refresh '
                  'PERF_BASELINE_TORCH.json (`perf snapshot --baseline -o '
                  'PERF_BASELINE_TORCH.json`) in the same change that '
                  'registered it')

    base_rt = baseline.get('retrace_totals', {})
    cur_rt = current.get('retrace_totals', {})
    for name, b in base_rt.items():
        c = cur_rt.get(name, 0)
        if c > b + tol.retrace_slack:
            _flag(name, 'retrace_total',
                  f'{c} traces during snapshot vs baseline {b} '
                  f'(+{tol.retrace_slack} allowed)', cur=c, base=b)
    for name, c in cur_rt.items():
        if name not in base_rt and c > tol.retrace_slack:
            _flag(name, 'retrace_total',
                  f'{c} traces during snapshot under a name not in '
                  f'the baseline', cur=c, base=0)
    return violations


# -- reporting ----------------------------------------------------------

def _si(value, unit=''):
    for scale, suffix in ((1e12, 'T'), (1e9, 'G'), (1e6, 'M'),
                          (1e3, 'K')):
        if abs(value) >= scale:
            return f'{value / scale:.2f} {suffix}{unit}'
    return f'{value:.0f} {unit}'.rstrip()


def render_report(snap):
    """Roofline table over a snapshot: one line per entry — counted
    FLOPs / bytes, arithmetic intensity, the bound, the roofline model
    time at the snapshot's peaks and, from a card snapshot, the measured
    time and the model's share of it."""
    peaks = snap.get('peaks', DEFAULT_PEAKS.as_dict())
    head = (f'perf snapshot: {len(snap.get("entries", {}))} entrypoints '
            f'on {snap.get("platform")} ({snap.get("device_kind")}) '
            f'torch {snap.get("torch_version")}\n'
            f'roofline peaks: '
            f'{peaks["flops_per_s"] / 1e12:.0f} TF/s, '
            f'{peaks["bytes_per_s"] / 1e9:.0f} GB/s '
            f'(ridge {peaks["ridge_flops_per_byte"]:.0f} FLOP/byte)')
    rows = [f'{"entrypoint":34} {"flops":>10} {"bytes":>10} '
            f'{"FLOP/B":>7} {"bound":>10} {"model µs":>9} '
            f'{"meas. µs":>9} {"share":>7} {"coll":>4} {"kern":>4} '
            f'{"first":>8}']
    for name, e in sorted(snap.get('entries', {}).items()):
        if 'error' in e:
            rows.append(f'{name:34} ERROR: {e["error"]}')
            continue
        bound = e['roofline'].replace('-bound', '')
        meas = e.get('measured_seconds')
        rows.append(
            f'{name:34} {_si(e["flops"]):>10} '
            f'{_si(e["bytes_accessed"], "B"):>10} '
            f'{e["arithmetic_intensity"]:7.2f} {bound:>10} '
            f'{e["model_seconds"] * 1e6:9.3f} '
            + (f'{meas * 1e6:9.1f} {e["fraction_of_roofline"]:7.4f} '
               if meas else f'{"-":>9} {"-":>7} ')
            + f'{e["n_collectives"]:4d} '
            f'{sum(k["calls"] for k in e["kernels"].values()):4d} '
            + (f'{e["first_call_seconds"]:7.2f}s'
               if 'first_call_seconds' in e else f'{"-":>8}'))
    rt = snap.get('retrace_totals', {})
    tail = ('retrace totals during snapshot: '
            + (' '.join(f'{k}={v}' for k, v in sorted(rt.items()))
               if rt else '(none watched)'))
    return '\n'.join([head, ''] + rows + ['', tail])


# -- CLI ----------------------------------------------------------------

def _fresh_snapshot(args):
    peaks = HardwarePeaks(flops_per_s=args.peak_tflops * 1e12,
                          bytes_per_s=args.peak_gbps * 1e9)
    entrypoints = None
    if args.registry:
        from distributed_dot_product_tpu_torch.analysis.registry import (
            resolve_registry_arg,
        )
        try:
            entrypoints = resolve_registry_arg(args.registry)
        except ValueError as e:
            raise SystemExit(str(e))
    return snapshot(entrypoints, device=args.device, peaks=peaks)


def _cmd_snapshot(args):
    snap = _fresh_snapshot(args)
    if args.baseline:
        snap = baseline_view(snap)
    text = json.dumps(snap, indent=2, sort_keys=True, default=str)
    if args.out in (None, '-'):
        print(text)
    else:
        with open(args.out, 'w') as f:
            f.write(text + '\n')
        n_err = sum('error' in e for e in snap['entries'].values())
        print(f'perf snapshot: {len(snap["entries"])} entrypoints '
              f'({n_err} errored) -> {args.out}')
    return 0


def _cmd_check(args):
    with open(args.against) as f:
        baseline = json.load(f)
    if args.current:
        with open(args.current) as f:
            current = json.load(f)
    else:
        current = _fresh_snapshot(args)
    tol = Tolerances(rel=args.rel_tol,
                     first_call_factor=args.first_call_factor,
                     first_call_slack_s=args.first_call_slack,
                     retrace_slack=args.retrace_slack,
                     abs_floor=args.abs_floor)
    cur_p, base_p = current.get('platform'), baseline.get('platform')
    if cur_p != base_p:
        print(f'perf check: the current snapshot ran on {cur_p!r} but '
              f'{args.against} on {base_p!r} — compare snapshots of one '
              f'platform (pass --device {base_p} to take a matching one)',
              file=sys.stderr)
        return 2
    violations = check_snapshots(current, baseline, tol=tol)
    for v in violations:
        print(f'PERF REGRESSION: {v}')
    n = len(current.get('entries', {}))
    print(f'perf check: {n} entrypoints vs {args.against}: '
          + ('OK' if not violations
             else f'{len(violations)} violation'
                  f'{"s" if len(violations) != 1 else ""}'))
    return 1 if violations else 0


def _cmd_report(args):
    if args.snapshot_file:
        with open(args.snapshot_file) as f:
            snap = json.load(f)
    else:
        snap = _fresh_snapshot(args)
    print(render_report(snap))
    return 0


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        prog='python -m distributed_dot_product_tpu_torch.obs.perf',
        description='program cost / roofline accounting of the '
                    'registered entrypoints and the perf-regression gate')
    parser.add_argument('--registry', metavar='MODULE:ATTR',
                        help='analyze this {name: builder} mapping '
                             'instead of the central registry')
    parser.add_argument('--device', default='cuda',
                        help="where the entrypoints run: 'cuda' (default; "
                             'adds measured times and peak memory; raises '
                             "without a card) or 'cpu' (the committed "
                             "baseline's)")
    parser.add_argument('--peak-tflops', type=float,
                        default=DEFAULT_PEAKS.flops_per_s / 1e12,
                        help='roofline compute ceiling in TF/s (default: '
                             'the H100 SXM dense bf16 rate)')
    parser.add_argument('--peak-gbps', type=float,
                        default=DEFAULT_PEAKS.bytes_per_s / 1e9,
                        help='roofline bandwidth ceiling in GB/s '
                             '(default: the H100 SXM HBM3 rate)')
    sub = parser.add_subparsers(dest='cmd', required=True)

    s = sub.add_parser('snapshot', help='run every entrypoint and write '
                                        'the cost snapshot')
    s.add_argument('-o', '--out', default=None,
                   help='output JSON path (default: stdout)')
    s.add_argument('--baseline', action='store_true',
                   help='write only the deterministic fields (the '
                        'committed PERF_BASELINE_TORCH.json)')
    s.set_defaults(fn=_cmd_snapshot)

    c = sub.add_parser('check', help='gate a snapshot against a baseline '
                                     '(exit 1 on violations)')
    c.add_argument('--against', required=True,
                   help='baseline snapshot JSON (the committed '
                        'PERF_BASELINE_TORCH.json)')
    c.add_argument('--current', default=None,
                   help='pre-computed current snapshot JSON (default: '
                        'take a fresh one)')
    c.add_argument('--rel-tol', type=float, default=Tolerances.rel,
                   help='relative tolerance on flops/bytes/memory')
    c.add_argument('--first-call-factor', type=float,
                   default=Tolerances.first_call_factor)
    c.add_argument('--first-call-slack', type=float,
                   default=Tolerances.first_call_slack_s)
    c.add_argument('--retrace-slack', type=int,
                   default=Tolerances.retrace_slack)
    c.add_argument('--abs-floor', type=float,
                   default=Tolerances.abs_floor,
                   help='ignore absolute drifts below this (field units)')
    c.set_defaults(fn=_cmd_check)

    r = sub.add_parser('report', help='render the roofline table')
    r.add_argument('snapshot_file', nargs='?', default=None,
                   help='render this snapshot JSON (default: take a '
                        'fresh one)')
    r.set_defaults(fn=_cmd_report)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == '__main__':
    # ``python -m`` runs this file as ``__main__`` beside the module the
    # kernel wrappers imported (the package's ``__init__`` imports them):
    # run the imported one, whose accounting hook they call.
    from distributed_dot_product_tpu_torch.obs import perf as _module
    sys.exit(_module.main())
