# -*- coding: utf-8 -*-
"""
Drive the resilient decode serving layer of the PyTorch / H100 port end
to end — the twin of ``examples/serve_lm.py``, with its flags, its
seeded burst and its audit.

A seeded request burst (mixed prompt lengths, optional deadlines) is
submitted through the continuous-batching scheduler; the run then
drains to idle and the driver audits the serving layer's contract:

- every submitted request reached a TERMINAL state — completed,
  evicted, deadline_expired, abandoned, failed_nan, or a typed
  rejection (at submit or in queue). Zero dropped-without-reason.
- with faults injected (``DDP_TPU_FAULT_STUCK_STEP``,
  ``DDP_TPU_FAULT_NAN_DECODE_STEP``, ``DDP_TPU_FAULT_ABANDON_REQUEST``
  env knobs), the faulted paths fire (watchdog stall recorded, NaN slot
  quarantined+retried, abandoned slot reclaimed) and readiness still
  ends READY.
- completed requests' token streams are BIT-IDENTICAL to a fault-free
  run of the same seed (``--check-identical`` reruns clean and
  compares) — a quarantine or stall must not perturb surviving
  streams.

Exit code 0 iff every audit passes. ``build_requests`` draws exactly as
the reference's does, so both submit the same requests. Runs on the card
unless given ``--device cpu``; the card computes in bf16 at head dim 32
(the decode kernels' smallest), the CPU in float32 at the reference
engine's head dim 8. ``DDP_TPU_PAGED_CACHE=1`` serves from the paged
cache (K5p on the card), as in the reference.

Run (CPU):
  python examples/torch_serve_lm.py --device cpu --requests 24
Faulted soak on the card:
  DDP_TPU_PAGED_CACHE=1 DDP_TPU_FAULT_STUCK_STEP=4 \\
  DDP_TPU_FAULT_NAN_DECODE_STEP=7 \\
      python examples/torch_serve_lm.py --requests 24 --check-identical
"""

import argparse
import contextlib
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import torch  # noqa: E402

from distributed_dot_product_tpu_torch import obs  # noqa: E402
from distributed_dot_product_tpu_torch.serve import (  # noqa: E402
    KernelEngine, Readiness, RejectedError, Scheduler, ServeConfig,
)
from distributed_dot_product_tpu_torch.utils import (  # noqa: E402
    faults as faults_lib,
)
from distributed_dot_product_tpu_torch.utils.comm import (  # noqa: E402
    resolve_device,
)
from distributed_dot_product_tpu_torch.utils.tracing import (  # noqa: E402
    MetricsRegistry,
)


def _engine(args):
    """The serving engine on ``args.device``: bf16 at head dim 32 on the
    card, float32 at the reference engine's head dim 8 on the CPU (both
    unless ``--head-dim`` says otherwise)."""
    dev = resolve_device(args.device)
    card = dev.type == 'cuda'
    head_dim = args.head_dim or (32 if card else 8)
    return KernelEngine(slots=args.slots, t_max=args.t_max,
                        vocab=args.vocab, heads=args.heads,
                        head_dim=head_dim,
                        prefill_chunk=args.prefill_chunk, seed=args.seed,
                        dtype=torch.bfloat16 if card else torch.float32,
                        device=dev)


def build_requests(args):
    """Seeded mixed burst: prompt lengths cycle short/medium/long, every
    4th request carries a deadline. Deterministic — the fault-free and
    faulted runs submit byte-identical traffic."""
    rng = np.random.default_rng(args.seed)
    reqs = []
    for i in range(args.requests):
        plen = int(rng.integers(1, args.prompt_len + 1))
        prompt = rng.integers(0, args.vocab, size=plen).astype(np.int32)
        reqs.append((f'req-{i:03d}', prompt))
    return reqs


def run_burst(args, *, fault_injector, deadline_every=0,
              flight_dir=None):
    """``fault_injector=False`` means EXPLICITLY unfaulted (the clean
    reference run) — plain None would let the scheduler re-arm the same
    env knobs and make the bit-identity audit compare a faulted run
    against itself. ``flight_dir`` (faulted run only) installs the
    incident flight recorder there: a watchdog stall auto-dumps a
    post-mortem bundle ``obs doctor`` can diagnose."""
    registry = MetricsRegistry()
    recorder = None
    if flight_dir:
        recorder = obs.flight.FlightRecorder(flight_dir,
                                             registry=registry,
                                             sample_interval=0.1)
        obs.flight.install(recorder)
    engine = _engine(args)
    # Warm all three programs before the watchdog arms: a first call
    # (kernel library load on the card) would otherwise register as a
    # stall and let the "watchdog fired" audit pass without the
    # injected stuck step ever being detected.
    engine.step(np.zeros(args.slots, np.int32),
                np.ones(args.slots, bool))
    engine.prefill(0, np.asarray([0], np.int32))
    for i in range(args.slots):
        engine.reset(i)
    cfg = ServeConfig(queue_limit=args.queue_limit,
                      max_new_tokens=args.max_new,
                      stall_timeout=args.stall_timeout,
                      # The burst intentionally overflows the queue; the
                      # audit wants typed QUEUE_FULL rejections, not
                      # partial 'evicted' streams, so the ladder stops
                      # before eviction here (eviction has its own
                      # tests).
                      evict_before_reject=False,
                      profile_warmup=args.profile_warmup)
    profiler = None
    if args.profile_warmup:
        # Opt-in: pay the profiler's one-time init HERE, so a later
        # adaptive/anomaly capture spends its bounded window on the
        # regression instead of on init.
        import tempfile
        profiler = obs.ProfileCapture(
            tempfile.mkdtemp(prefix='ddp_serve_profiles_'),
            registry=registry)
    sched = Scheduler(engine, cfg, fault_injector=fault_injector,
                      registry=registry, profiler=profiler)
    # Live device telemetry for the duration of the run: the gauges
    # (device.memory.*{device=...}, devices_reporting) land in the
    # same registry the summary below snapshots — real numbers on the
    # card, an honest devices_reporting=0 on the CPU.
    devmon = obs.DeviceMonitor(registry=registry, interval=0.2).start()
    rejected = {}
    submitted = build_requests(args)
    t0 = time.perf_counter()
    try:
        for i, (rid, prompt) in enumerate(submitted):
            deadline = None
            if deadline_every and i % deadline_every == 3:
                deadline = sched.clock() + args.deadline_s
            try:
                sched.submit(prompt, request_id=rid, deadline=deadline)
            except RejectedError as e:
                rejected[rid] = e.reason
            # Drain a tick every few submissions: a real frontend
            # interleaves arrivals with serving — and it lets the burst
            # actually overflow a small queue while slots are busy.
            if i % 4 == 3:
                sched.step()
        results = sched.run_until_idle()
        wall = time.perf_counter() - t0
    finally:
        # close() in the cleanup path: step() now re-raises unhandled
        # exceptions (after its flight dump), and an error exit must
        # not leak the watchdog thread or the scheduler's global
        # flight introspection provider.
        sched.close()
        devmon.stop()
        if recorder is not None:
            obs.flight.install(None)
    return sched, registry, submitted, rejected, results, wall, recorder


def run_load_demo(args):
    """``--load SEED``: a seeded open-loop trace (serve/loadgen.py)
    through the scheduler on a virtual clock, goodput report printed
    at exit. Exit 0 iff every submitted request is classified exactly
    once from the event log alone."""
    import tempfile

    from distributed_dot_product_tpu_torch.obs import slo as obs_slo
    from distributed_dot_product_tpu_torch.serve import (
        LoadGenConfig, ServeConfig, VirtualClock, run_load,
    )

    clock = VirtualClock()
    log_path = args.event_log or os.path.join(
        tempfile.gettempdir(), f'serve_lm_load_{os.getpid()}.jsonl')
    obs.remove_log(log_path)    # EventLog appends; a demo wants fresh
    event_log = obs.EventLog(log_path, clock=clock)
    cfg = LoadGenConfig(seed=args.load, rate=args.load_rate,
                        requests=args.requests, vocab=args.vocab)
    engine = _engine(args)
    registry = MetricsRegistry()
    devmon = obs.DeviceMonitor(registry=registry, interval=0.2).start()
    try:
        res = run_load(cfg, engine=engine,
                       serve_config=ServeConfig(
                           queue_limit=args.queue_limit,
                           max_new_tokens=max(t.new_hi
                                              for t in cfg.tenants),
                           watchdog=False),
                       registry=registry, event_log=event_log,
                       clock=clock)
    finally:
        devmon.stop()
    event_log.close()
    spec = obs_slo.SloSpec(ttft=0.25, per_token=0.05)
    report = obs_slo.goodput(log_path, spec)
    print(f'loadgen seed={args.load}: {len(res.submitted)} requests '
          f'over {res.virtual_seconds:.2f} virtual seconds '
          f'({res.wall_seconds:.2f}s wall, {res.ticks} ticks)')
    print(obs_slo.render_report(report))
    print(f'event log: {log_path}')
    ok = (res.accounted
          and report.requests == len(res.submitted)
          and sum(report.counts.values()) == report.requests)
    print(f'torch_serve_lm --load {"OK" if ok else "AUDIT FAILED"}: '
          f'{report.requests}/{len(res.submitted)} requests '
          f'classified from the event log alone')
    return 0 if ok else 1


def main(argv=None, summary=None):
    """The command line; ``summary``, a dict, receives the burst's audit
    (terminal counts by status, rejections at submit, failures, wall
    seconds, tokens) for a caller that drives it in-process."""
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument('--heads', type=int, default=2)
    p.add_argument('--head-dim', type=int, default=None,
                   help='default: 32 on the card, 8 on the CPU')
    p.add_argument('--slots', type=int, default=4)
    p.add_argument('--t-max', type=int, default=64)
    p.add_argument('--vocab', type=int, default=48)
    p.add_argument('--requests', type=int, default=24)
    p.add_argument('--prompt-len', type=int, default=12,
                   help='max prompt length (burst mixes 1..this)')
    p.add_argument('--prefill-chunk', type=int, default=4)
    p.add_argument('--max-new', type=int, default=8)
    p.add_argument('--queue-limit', type=int, default=8)
    p.add_argument('--deadline-every', type=int, default=0,
                   help='every Nth request gets a deadline (0: none)')
    p.add_argument('--deadline-s', type=float, default=0.5)
    p.add_argument('--stall-timeout', type=float, default=0.25)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--check-identical', action='store_true',
                   help='rerun fault-free and require completed '
                        'streams to match bit for bit')
    p.add_argument('--event-log',
                   default=os.environ.get(obs.events.ENV_VAR),
                   help='write the JSONL observability event log here '
                        '(default: $DDP_TPU_EVENT_LOG); the audit then '
                        'additionally requires every request timeline '
                        'to be reconstructable from the log alone')
    p.add_argument('--flight-dir',
                   default=os.environ.get('DDP_TPU_FLIGHT_DIR'),
                   help='arm the incident flight recorder rooted here '
                        '(default: $DDP_TPU_FLIGHT_DIR); a watchdog '
                        'stall / NaN storm auto-dumps a post-mortem '
                        'bundle for `obs doctor` (faulted run only)')
    p.add_argument('--profile-warmup', action='store_true',
                   help='pay the profiler\'s one-time init at startup '
                        'so a later triggered capture records the '
                        'regression, not the init')
    p.add_argument('--load', type=int, default=None, metavar='SEED',
                   help='instead of the fixed burst, run a small '
                        'seeded open-loop loadgen trace (virtual '
                        'clock, two tenants) through the scheduler '
                        'and print the goodput-under-SLO report at '
                        'exit — the runnable demo of the load/SLO '
                        'observatory')
    p.add_argument('--load-rate', type=float, default=600.0,
                   help='--load: offered rate, requests per VIRTUAL '
                        'second')
    args = p.parse_args(argv)

    if args.load is not None:
        return run_load_demo(args)

    plan = faults_lib.serve_plan_from_env()
    if plan.burst:
        args.requests = plan.burst
    injector = (faults_lib.ServeFaultInjector(plan) if plan.any()
                else None)
    if injector is not None:
        print(f'faults armed: {plan}')

    # The event log captures the FAULTED run only: the --check-identical
    # clean rerun resubmits the same request ids, and logging both would
    # double every timeline.
    event_log = obs.EventLog(args.event_log) if args.event_log else None
    log_ctx = (obs.activate(event_log) if event_log is not None
               else contextlib.nullcontext())
    with log_ctx:
        (sched, registry, submitted, rejected, results, wall,
         recorder) = run_burst(
            args, fault_injector=injector,
            deadline_every=args.deadline_every,
            # The flight recorder rides the FAULTED run only, like the
            # event log: the clean rerun would overwrite the incident
            # window with healthy traffic.
            flight_dir=args.flight_dir if injector is not None
            else None)
    if event_log is not None:
        event_log.close()

    snap = registry.snapshot()
    counters = {k: v for k, v in snap['counters'].items() if v}
    lat = snap['histograms']['serve.step_seconds']
    n_tokens = snap['counters'].get('serve.tokens_generated', 0)
    by_status = {}
    for r in results.values():
        by_status[r.status] = by_status.get(r.status, 0) + 1
    print(f'submitted={len(submitted)} rejected_at_submit={len(rejected)} '
          f'terminal={by_status}')
    print(f'counters: {counters}')
    print(f'step latency: p50={lat["p50"] * 1e3:.2f}ms '
          f'p99={lat["p99"] * 1e3:.2f}ms over {lat["count"]} steps')
    ttft = snap['histograms']['serve.ttft_seconds']
    queue_wait = snap['histograms']['serve.queue_wait_seconds']
    if ttft['count']:
        print(f'request latency: ttft p50={ttft["p50"] * 1e3:.2f}ms '
              f'p99={ttft["p99"] * 1e3:.2f}ms, queue wait '
              f'p50={queue_wait["p50"] * 1e3:.2f}ms')
    print(f'throughput: {n_tokens} tokens in {wall:.2f}s '
          f'({n_tokens / max(wall, 1e-9):,.0f} tok/s)')

    failures = []
    # 1. Full accounting: terminal state or typed rejection for everyone.
    for rid, _ in submitted:
        if rid in rejected:
            if rejected[rid] is None:
                failures.append(f'{rid}: rejection without a reason')
        elif rid not in results:
            failures.append(f'{rid}: dropped without any terminal state')
        elif results[rid].status == 'rejected' \
                and results[rid].reason is None:
            failures.append(f'{rid}: queue rejection without a reason')
    # 2. Faults fired where armed, and the surface recovered.
    if injector is not None:
        if plan.stuck_at_step is not None \
                and sched.health.stall_events < 1:
            failures.append('stuck step armed but watchdog never fired')
        if plan.nan_at_step is not None \
                and snap['counters'].get('serve.nan_quarantined', 0) < 1:
            failures.append('NaN armed but no slot was quarantined')
        if plan.abandon_request is not None \
                and by_status.get('abandoned', 0) < 1:
            failures.append('abandon armed but no stream abandoned')
    if sched.health.readiness is not Readiness.STOPPED:
        failures.append(f'close() left readiness '
                        f'{sched.health.readiness.value}')
    ready_line = [v for _, kind, v, _ in sched.health.transitions
                  if kind == 'readiness']
    if not ready_line or ready_line[-1] != Readiness.STOPPED.value \
            or (len(ready_line) > 1 and ready_line[-2]
                != Readiness.READY.value):
        failures.append(f'readiness not restored to ready before stop: '
                        f'{ready_line}')
    # 3. Event-log reconstruction: every submitted request's complete
    #    lifecycle (admit→…→retire, or reject/evict with reason) must
    #    be rebuildable from the JSONL alone — the observability
    #    layer's acceptance contract.
    if args.event_log:
        _, schema_errors = obs.validate_file(args.event_log)
        for err in schema_errors:
            failures.append(f'event-log schema: {err}')
        timelines = obs.reconstruct(args.event_log)
        unreconstructed = 0
        for rid, _ in submitted:
            tl = timelines.get(rid)
            if tl is None:
                failures.append(f'{rid}: absent from the event log')
                unreconstructed += 1
            elif not tl.complete:
                failures.append(f'{rid}: incomplete timeline: '
                                + '; '.join(tl.errors))
                unreconstructed += 1
        ok = not unreconstructed and not schema_errors
        print(f'event-log timeline audit: {"ok" if ok else "FAILED"} '
              f'({len(submitted) - unreconstructed}/{len(submitted)} '
              f'requests reconstructed from {args.event_log})')
    # 3b. Incident flight recorder: with the recorder armed and a
    #     stuck step injected, the watchdog stall must have auto-
    #     dumped a post-mortem bundle (what `obs doctor` diagnoses —
    #     scripts/smoke_serve.sh runs it over this very bundle).
    if recorder is not None:
        for d in recorder.dumps:
            print(f'flight bundle [{d["trigger"]}]: {d["path"]}')
        if injector is not None and plan.stuck_at_step is not None \
                and not any(d['trigger'] == 'stall'
                            for d in recorder.dumps):
            failures.append('stuck step armed and flight recorder '
                            'installed, but no stall bundle was '
                            'auto-dumped')
    # 4. Fault isolation: completed streams identical to a clean run.
    if args.check_identical:
        _, _, _, rej0, clean, _, _ = run_burst(args,
                                               fault_injector=False,
                                               deadline_every=0)
        for rid, r in results.items():
            if r.status != 'completed' or r.degraded:
                continue
            ref = clean.get(rid)
            if ref is not None and ref.status == 'completed' \
                    and not ref.degraded and ref.tokens != r.tokens:
                failures.append(f'{rid}: tokens diverged from the '
                                f'fault-free run')
        diverged = any('diverged' in f for f in failures)
        print(f'bit-identity check against clean rerun: '
              f'{"FAILED" if diverged else "ok"}')

    if summary is not None:
        summary.update(terminal=by_status, rejected_at_submit=len(rejected),
                       failures=failures, wall_seconds=wall, tokens=n_tokens)
    if failures:
        print('AUDIT FAILED:')
        for f in failures:
            print(f'  - {f}')
        return 1
    print(f'torch_serve_lm OK: all {len(submitted)} requests accounted '
          f'for, readiness restored')
    return 0


if __name__ == '__main__':
    sys.exit(main())
