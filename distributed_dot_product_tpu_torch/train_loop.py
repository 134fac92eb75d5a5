# -*- coding: utf-8 -*-
"""
Preemption-tolerant training loop — the port of
``distributed_dot_product_tpu/train_loop.py``:

- **Auto-resume** from the latest FINALIZED checkpoint, after
  :func:`~distributed_dot_product_tpu_torch.utils.checkpoint.recover_interrupted`
  cleans up a crash mid-save.
- **Periodic async saves** with retry and exponential backoff around
  checkpoint I/O.
- **SIGTERM/SIGINT**: the signal sets a flag, the step in flight
  finishes, a final BLOCKING save lands, the handlers are restored, and
  the result carries the exit code ``128 + signum``.
- **NaN/Inf guards**: a step built with ``guard=True`` skips its update
  on a non-finite loss or gradient; the loop counts bad steps and
  ROLLS BACK to the last checkpoint (or the initial state) after
  ``max_bad_steps`` consecutive ones, at most ``max_rollbacks`` times.
- **Retention**: ``keep_last=N`` deletes old finalized steps.

The port's train steps (:mod:`~distributed_dot_product_tpu_torch.train`)
own their module and optimizer and update them in place: ``run_training``
loads a :class:`~..utils.checkpoint.TrainState` into ``step_fn.module``
and ``step_fn.optimizer`` at the start, on resume and on rollback, and
saves their ``state_dict()``s. It keeps its own copy of the initial
state (the parameters change in place), and it processes each step's
record before the next step: the reference pipelines the record readback
by one step, which would save a state one step ahead here.

Usage::

    step_fn = make_train_step(model, optimizer, mesh, guard=True)
    state = TrainState(0, model.state_dict(), optimizer.state_dict())
    cfg = TrainLoopConfig(num_steps=1000, ckpt_dir='runs/run1',
                          ckpt_every=100, keep_last=3)
    result = run_training(step_fn, state, batch_fn, cfg)
    sys.exit(result.exit_code)   # 0, or 128+signum after a preemption

``batch_fn(step) -> batch`` must be a pure function of the step index so
a resumed run consumes exactly the batches an uninterrupted run would:
that is what makes kill/resume bit-identical.
"""

import copy
import dataclasses
import signal
import time
from typing import Callable, Dict, List, Optional, Tuple

from distributed_dot_product_tpu_torch.obs import events as obs_events
from distributed_dot_product_tpu_torch.obs.spans import span
from distributed_dot_product_tpu_torch.utils import checkpoint as ckpt
from distributed_dot_product_tpu_torch.utils import faults as faults_lib
from distributed_dot_product_tpu_torch.utils import tracing
from distributed_dot_product_tpu_torch.utils.checkpoint import TrainState
from distributed_dot_product_tpu_torch.utils.tracing import log_step

__all__ = ['TrainLoopConfig', 'TrainLoopResult', 'run_training']

_HANDLED_SIGNALS = (signal.SIGTERM, signal.SIGINT)


@dataclasses.dataclass
class TrainLoopConfig:
    """Knobs of :func:`run_training`.

    ``num_steps``: total step count to reach (a resumed run does the
    remainder). ``ckpt_every=0`` saves only on exit/preemption.
    ``keep_last=None`` disables retention GC. ``max_bad_steps``: K
    consecutive NaN/Inf-skipped steps trigger a rollback to the last
    checkpoint (or the initial state when none exists);
    ``max_rollbacks`` bounds rollback→re-diverge loops before giving up.
    ``save_retries``/``save_backoff``: transient-I/O retry policy —
    ``save_backoff`` seconds before the first retry, doubling each
    attempt. ``handle_signals=False`` leaves SIGTERM/SIGINT alone.
    ``history_limit`` bounds the per-step records kept in the result
    (oldest dropped; None keeps everything). ``tokens_per_step``
    publishes a ``train.tokens_per_s`` gauge.
    """
    num_steps: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0
    keep_last: Optional[int] = None
    async_saves: bool = True
    save_retries: int = 3
    save_backoff: float = 0.25
    max_bad_steps: int = 3
    max_rollbacks: int = 2
    handle_signals: bool = True
    final_save: bool = True
    log_every: int = 0
    history_limit: Optional[int] = 100_000
    tokens_per_step: Optional[int] = None


@dataclasses.dataclass
class TrainLoopResult:
    """What happened: the final state, per-step losses of the LAST
    execution of each step index (a rollback replays steps), robustness
    counters, and the exit code (0, or ``128 + signum`` when
    preempted)."""
    state: TrainState
    losses: Dict[int, float]
    grad_norms: Dict[int, float]
    bad_steps: int
    rollbacks: int
    resumed_from: Optional[int]
    preempted: bool
    exit_code: int


class _PreemptFlag:
    """Signal-to-flag bridge: the handler only records the signum; the
    loop reacts at the next step boundary. On the FIRST signal the
    previous handlers are restored (``restore``, set by the loop) so a
    SECOND signal escalates instead of being swallowed."""

    def __init__(self):
        self.signum = None
        self.restore = None

    def __call__(self, signum, frame):
        first = self.signum is None
        self.signum = signum
        if first and self.restore is not None:
            self.restore()

    @property
    def set(self):
        return self.signum is not None


def _save_with_retry(cfg: TrainLoopConfig, state: TrainState,
                     blocking: bool) -> str:
    """Checkpoint save with retry + exponential backoff around transient
    I/O failures. ``SimulatedCrash`` (and any non-OSError) propagates."""
    delay = cfg.save_backoff
    for attempt in range(cfg.save_retries + 1):
        try:
            return ckpt.save(cfg.ckpt_dir, state, blocking=blocking)
        except OSError as e:
            if attempt == cfg.save_retries:
                raise
            log_step(int(state.step), float('nan'), force=True,
                     extra=f'[checkpoint save failed ({e}); retry '
                           f'{attempt + 1}/{cfg.save_retries} '
                           f'in {delay:.2f}s]')
            time.sleep(delay)
            delay *= 2


def _record(rec):
    """``(loss, bad, grad_norm)`` on the host from a guarded step's
    record, or from a bare loss (bad when not finite)."""
    if isinstance(rec, dict):
        return (float(rec['loss']), bool(rec['bad_step']),
                float(rec['grad_norm']))
    loss = float(rec)
    return loss, not (loss == loss and abs(loss) != float('inf')), \
        float('nan')


def run_training(step_fn: Callable, state: TrainState,
                 batch_fn: Callable, config: TrainLoopConfig, *,
                 on_step: Optional[Callable] = None,
                 fault_injector=None,
                 registry=None) -> TrainLoopResult:
    """Run the training loop to ``config.num_steps``, surviving
    preemption, NaN/Inf divergence, a crash mid-save, and transient
    checkpoint I/O failures (see the module docstring).

    ``step_fn(batch, dropout_seed=step)``, from
    :func:`~..train.make_train_step` or :func:`~..train.make_lm_train_step`,
    carries ``step_fn.module`` and ``step_fn.optimizer``; build it with
    ``guard=True`` so it returns the ``{'loss', 'bad_step',
    'grad_norm'}`` record and skips a bad update (a bare-loss step also
    works: ``bad_step`` is derived from the loss, and the update is NOT
    skipped). ``state``: the ``TrainState`` to start from — it is copied
    and loaded into the module and optimizer (unless a checkpoint under
    ``config.ckpt_dir`` is resumed), so pass copies of ``state_dict()``s
    to start several runs from one state.

    ``on_step(step, record)`` is called after every step with the host
    record. ``fault_injector``: a
    :class:`~..utils.faults.FaultInjector` wired into both seams; when
    None, the ``DDP_TPU_FAULT_*`` env knobs are read. ``registry``:
    metrics sink (default: the process registry) for
    ``train.step_seconds``, ``train.checkpoint_save_seconds`` and
    ``train.tokens_per_s``; spans and restore/rollback/checkpoint events
    go to the active span collector and event log."""
    cfg = config
    module, optimizer = step_fn.module, step_fn.optimizer
    reg = registry or tracing.get_registry()
    h_step = reg.histogram('train.step_seconds')
    h_ckpt = reg.histogram('train.checkpoint_save_seconds')
    g_tps = (reg.gauge('train.tokens_per_s') if cfg.tokens_per_step
             else None)
    if fault_injector is None:
        plan = faults_lib.plan_from_env()
        fault_injector = faults_lib.FaultInjector(plan) if plan.any() \
            else None

    def load(st):
        # The optimizer keeps the tensors it is given (Adam updates its
        # moments in place), so it gets a copy: state0 must stay intact.
        module.load_state_dict(st.params)
        optimizer.load_state_dict(copy.deepcopy(st.opt_state))

    def current(step):
        return TrainState(step, module.state_dict(), optimizer.state_dict())

    state0 = TrainState(int(state.step), copy.deepcopy(state.params),
                        copy.deepcopy(state.opt_state))
    resumed_from = None
    if cfg.ckpt_dir is not None:
        ckpt.recover_interrupted(cfg.ckpt_dir)
        resumed_from = ckpt.latest_step(cfg.ckpt_dir)
    if resumed_from is not None:
        load(ckpt.restore(cfg.ckpt_dir, state0))
        step_i = resumed_from
        obs_events.emit('train.restore', step=resumed_from)
        log_step(step_i, float('nan'), force=bool(cfg.log_every),
                 extra=f'[resumed from checkpoint step {resumed_from} '
                       f'under {cfg.ckpt_dir}]')
    else:
        load(state0)
        step_i = state0.step

    losses: Dict[int, float] = {}
    grad_norms: Dict[int, float] = {}
    bad_total = consecutive_bad = rollbacks = 0
    last_saved = resumed_from

    # Injector first: its install() can raise (another injector active),
    # and it must do so BEFORE any signal handler is replaced.
    wrapped_batch_fn = batch_fn
    injector_ctx = None
    if fault_injector is not None:
        wrapped_batch_fn = fault_injector.wrap_batch_fn(batch_fn)
        injector_ctx = fault_injector.install()

    flag = _PreemptFlag()
    old_handlers: List[Tuple[int, object]] = []
    if cfg.handle_signals:
        try:
            for sig in _HANDLED_SIGNALS:
                old_handlers.append((sig, signal.signal(sig, flag)))
            flag.restore = lambda: [signal.signal(s, h)
                                    for s, h in old_handlers]
        except ValueError:
            # Not the main thread: signal handlers cannot be installed.
            pass

    def _do_save(step_now, blocking):
        nonlocal last_saved
        t0 = time.perf_counter()
        with span('train.checkpoint_save', step=step_now,
                  blocking=blocking):
            _save_with_retry(cfg, current(step_now), blocking=blocking)
        seconds = time.perf_counter() - t0
        h_ckpt.observe(seconds)
        obs_events.emit('train.checkpoint_save', step=step_now,
                        seconds=seconds, blocking=blocking)
        if blocking and cfg.keep_last:
            ckpt.gc_old_steps(cfg.ckpt_dir, cfg.keep_last)
        last_saved = step_now

    def _drain_async():
        """Finalize pending async saves; a failed background write drops
        its bookkeeping (its backups stay for recover_interrupted) and
        returns False so the caller re-saves blocking."""
        try:
            ckpt.wait(cfg.ckpt_dir)
            return True
        except OSError as e:
            ckpt.discard_pending(cfg.ckpt_dir)
            log_step(step_i, float('nan'), force=True,
                     extra=f'[async checkpoint flush failed ({e}); '
                           f'falling back to a blocking save]')
            return False

    def _process(idx, rec, seconds):
        """Host-side handling of step ``idx``'s record; the module holds
        the post-``idx`` state. Returns True when it rolled back."""
        nonlocal bad_total, consecutive_bad, rollbacks, step_i
        loss, bad, gnorm = _record(rec)
        losses[idx] = loss
        grad_norms[idx] = gnorm
        h_step.observe(seconds)
        if g_tps is not None and seconds > 0:
            g_tps.set(cfg.tokens_per_step / seconds)
        if cfg.history_limit:
            while len(losses) > cfg.history_limit:
                oldest = next(iter(losses))
                del losses[oldest]
                grad_norms.pop(oldest, None)
        force_log = bool(cfg.log_every) and (
            idx % cfg.log_every == 0 or bad)
        log_step(idx, loss, grad_norm=gnorm, bad=bad, seconds=seconds,
                 force=force_log)
        if on_step is not None:
            on_step(idx, {'loss': loss, 'bad_step': bad, 'grad_norm': gnorm})
        if bad:
            bad_total += 1
            consecutive_bad += 1
            if consecutive_bad >= cfg.max_bad_steps:
                rollbacks += 1
                if rollbacks > cfg.max_rollbacks:
                    raise RuntimeError(
                        f'training diverged: {consecutive_bad} '
                        f'consecutive non-finite steps persisted '
                        f'through {cfg.max_rollbacks} rollbacks')
                consecutive_bad = 0
                if cfg.ckpt_dir is not None:
                    _drain_async()
                back_to = (ckpt.latest_step(cfg.ckpt_dir)
                           if cfg.ckpt_dir is not None else None)
                if back_to is not None:
                    restored = ckpt.restore(cfg.ckpt_dir, current(0))
                    load(restored)
                    step_i = restored.step
                else:   # no checkpoint yet: the initial state IS it
                    load(state0)
                    step_i = state0.step
                obs_events.emit('train.rollback', step=step_i,
                                after_bad_steps=cfg.max_bad_steps)
                log_step(step_i, loss, force=bool(cfg.log_every),
                         extra=f'[rolled back to step {step_i} after '
                               f'{cfg.max_bad_steps} consecutive bad '
                               f'steps]')
                return True
        else:
            consecutive_bad = 0
        # Periodic save at the post-idx boundary, only after a good step:
        # a bare-loss bad step applied its poisoned update.
        boundary = idx + 1
        if (not bad and cfg.ckpt_dir is not None and cfg.ckpt_every
                and boundary % cfg.ckpt_every == 0
                and boundary < cfg.num_steps):
            _do_save(boundary, blocking=not cfg.async_saves)
            if cfg.async_saves and cfg.keep_last:
                ckpt.gc_old_steps(cfg.ckpt_dir, cfg.keep_last)
        return False

    try:
        while step_i < cfg.num_steps and not flag.set:
            batch = wrapped_batch_fn(step_i)
            if flag.set:
                break   # preemption landed while building the batch
            cur = step_i
            t0 = time.perf_counter()
            with span('train.step', step=cur):
                rec = step_fn(batch, dropout_seed=cur)
            step_i = cur + 1
            _process(cur, rec, time.perf_counter() - t0)

        preempted = flag.set
        if cfg.ckpt_dir is not None:
            flushed = _drain_async()
            if (cfg.final_save or preempted) and (
                    last_saved != step_i or not flushed):
                _do_save(step_i, blocking=True)
            elif cfg.keep_last:
                ckpt.gc_old_steps(cfg.ckpt_dir, cfg.keep_last)
    finally:
        if injector_ctx is not None:
            fault_injector.uninstall()
        for sig, handler in old_handlers:
            signal.signal(sig, handler)

    exit_code = 128 + flag.signum if preempted else 0
    if preempted:
        log_step(step_i, losses.get(step_i - 1, float('nan')),
                 force=bool(cfg.log_every),
                 extra=f'[preempted by signal {flag.signum}; state saved '
                       f'at step {step_i}; exit code {exit_code}]')
    return TrainLoopResult(
        state=current(step_i), losses=losses, grad_norms=grad_norms,
        bad_steps=bad_total, rollbacks=rollbacks, resumed_from=resumed_from,
        preempted=preempted, exit_code=exit_code)
