# -*- coding: utf-8 -*-
"""
The port's resilient training loop (``train_loop.run_training``) and
the training half of its fault harness (``utils/faults.py``), held to the
contracts of the reference's ``tests/test_train_loop.py`` and
``tests/test_faults.py`` that do not depend on buffer donation:

- kill/resume: a run preempted by SIGTERM, and one that crashes
  mid-save, resume and reproduce the uninterrupted per-step losses BIT
  for bit;
- the NaN guard: the parameters and optimizer state after an injected
  NaN step equal those before it, the step is counted, K consecutive bad
  steps roll back to the last checkpoint (or the initial state), a
  rollback on the last step re-enters training, a bad boundary is not
  checkpointed, persistent divergence raises;
- retention (``keep_last``), retried transient save errors, and the
  blocking fallback after a failed async write;
- the fault plan's env knobs, NaN poisoning, the save seam, the injector's
  exclusivity and the synthetic SIGTERM; the tracing timers the loop
  uses.

The rig is the port's attention module on the CPU (one rank), Adam at
1e-2, a guarded step, batches from a numpy generator seeded by the step.
"""

import copy
import os
import signal

import numpy as np
import pytest
import torch

from distributed_dot_product_tpu_torch import (
    DistributedDotProductAttn, make_train_step, seq_mesh,
)
from distributed_dot_product_tpu_torch.train_loop import (
    TrainLoopConfig, _PreemptFlag, run_training,
)
from distributed_dot_product_tpu_torch.utils import checkpoint as ckpt
from distributed_dot_product_tpu_torch.utils import tracing
from distributed_dot_product_tpu_torch.utils.checkpoint import (
    TrainState, latest_step,
)
from distributed_dot_product_tpu_torch.utils.faults import (
    FaultInjector, FaultPlan, SimulatedCrash, plan_from_env, poison_batch,
)

DIM, HEADS, T, B = 16, 2, 16, 2


@pytest.fixture(scope='module')
def rig():
    """One guarded step (its module and Adam updated in place by every
    run), the initial state copied, and a pure-in-step batch stream."""
    model = DistributedDotProductAttn(
        DIM, num_heads=HEADS, offset=2, device='cpu',
        generator=torch.Generator().manual_seed(1))
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    step = make_train_step(model, opt, seq_mesh(), guard=True)
    mask = torch.zeros((B, T, T), dtype=torch.bool)

    def batch_fn(i):
        x = torch.from_numpy(np.random.default_rng(1000 + i).standard_normal(
            (B, T, DIM), dtype=np.float32))
        return (x, x, x, mask, torch.zeros_like(x))

    state0 = TrainState(0, copy.deepcopy(model.state_dict()),
                        copy.deepcopy(opt.state_dict()))
    return step, state0, batch_fn


def _run(rig_tuple, num_steps, tmp=None, **kw):
    step, state0, batch_fn = rig_tuple
    cfg = TrainLoopConfig(num_steps=num_steps,
                          ckpt_dir=str(tmp) if tmp else None)
    return run_training(step, state0, batch_fn, cfg, **kw)


def _same_losses(got, want):
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal([got[i] for i in sorted(got)],
                                  [want[i] for i in sorted(want)])


def test_uninterrupted_run_counts_and_saves(rig, tmp_path):
    res = _run(rig, 4, tmp_path / 'base')
    assert sorted(res.losses) == [0, 1, 2, 3]
    assert res.bad_steps == 0 and res.rollbacks == 0
    assert not res.preempted and res.exit_code == 0
    assert res.state.step == 4
    assert latest_step(tmp_path / 'base') == 4
    # Runs from one initial state are reproducible: the loop loads it.
    _same_losses(_run(rig, 4).losses, res.losses)


def test_sigterm_resume_bit_identical(rig, tmp_path):
    step, state0, batch_fn = rig
    want = _run(rig, 6).losses
    ck = str(tmp_path / 'sig')
    cfg = TrainLoopConfig(num_steps=6, ckpt_dir=ck, ckpt_every=2)
    res1 = run_training(step, state0, batch_fn, cfg, fault_injector=(
        FaultInjector(FaultPlan(sigterm_at_step=3))))
    assert res1.preempted and res1.exit_code == 128 + signal.SIGTERM
    assert res1.state.step == 3 and latest_step(ck) == 3
    res2 = run_training(step, state0, batch_fn, cfg)          # restart
    assert res2.resumed_from == 3 and not res2.preempted
    _same_losses({**res1.losses, **res2.losses}, want)


def test_crash_mid_save_resume_bit_identical(rig, tmp_path):
    step, state0, batch_fn = rig
    want = _run(rig, 6).losses
    ck = str(tmp_path / 'crash')
    cfg = TrainLoopConfig(num_steps=6, ckpt_dir=ck, ckpt_every=2,
                          async_saves=False)
    with pytest.raises(SimulatedCrash):
        run_training(step, state0, batch_fn, cfg, fault_injector=(
            FaultInjector(FaultPlan(crash_in_save_at_step=4))))
    assert any(ckpt._TMP in n for n in os.listdir(ck))
    assert latest_step(ck) == 2
    res2 = run_training(step, state0, batch_fn, cfg)
    assert res2.resumed_from == 2 and set(res2.losses) == {2, 3, 4, 5}
    np.testing.assert_array_equal([res2.losses[i] for i in (2, 3, 4, 5)],
                                  [want[i] for i in (2, 3, 4, 5)])
    assert not any(ckpt._TMP in n for n in os.listdir(ck))


def test_nan_guard_skips_update_and_counts(rig, tmp_path):
    step, state0, batch_fn = rig
    model, opt = step.module, step.optimizer
    model.load_state_dict(state0.params)
    opt.load_state_dict(copy.deepcopy(state0.opt_state))
    inj = FaultInjector(FaultPlan(nan_at_steps=frozenset({2})))
    wrapped = inj.wrap_batch_fn(batch_fn)
    snaps = {}
    for i in range(4):
        rec = step(wrapped(i), dropout_seed=i)
        snaps[i] = (copy.deepcopy(model.state_dict()),
                    copy.deepcopy(opt.state_dict()), rec)
    assert bool(snaps[2][2]['bad_step'])
    assert not np.isfinite(float(snaps[2][2]['loss']))
    assert not any(bool(snaps[i][2]['bad_step']) for i in (0, 1, 3))
    for bad, prev in zip(snaps[2][:2], snaps[1][:2]):
        for (p, a), (_, b) in zip(ckpt._leaves(bad), ckpt._leaves(prev)):
            assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                    else a == b), p
    assert np.isfinite(float(snaps[3][2]['loss']))

    cfg = TrainLoopConfig(num_steps=4, ckpt_dir=str(tmp_path / 'nan'),
                          max_bad_steps=3)
    res = run_training(step, state0, batch_fn, cfg, fault_injector=(
        FaultInjector(FaultPlan(nan_at_steps=frozenset({2})))))
    assert res.bad_steps == 1 and res.rollbacks == 0
    assert not np.isfinite(res.losses[2]) and np.isfinite(res.losses[3])


def test_consecutive_bad_steps_roll_back_to_checkpoint(rig, tmp_path):
    step, state0, batch_fn = rig
    want = _run(rig, 6).losses
    cfg = TrainLoopConfig(num_steps=6, ckpt_dir=str(tmp_path / 'roll'),
                          ckpt_every=2, max_bad_steps=2)
    res = run_training(step, state0, batch_fn, cfg, fault_injector=(
        FaultInjector(FaultPlan(nan_at_steps=frozenset({2, 3})))))
    assert res.bad_steps == 2 and res.rollbacks == 1
    _same_losses(res.losses, want)


def test_rollback_without_checkpoint_restores_initial_state(rig):
    """No checkpoint: the rollback loads the loop's own copy of the
    initial state (the module's parameters changed in place)."""
    step, state0, batch_fn = rig
    cfg = TrainLoopConfig(num_steps=3, max_bad_steps=2)
    res = run_training(step, state0, batch_fn, cfg, fault_injector=(
        FaultInjector(FaultPlan(nan_at_steps=frozenset({0, 1})))))
    assert res.rollbacks == 1 and res.bad_steps == 2
    _same_losses(res.losses, _run(rig, 3).losses)


def test_tail_rollback_reenters_training(rig):
    step, state0, batch_fn = rig
    cfg = TrainLoopConfig(num_steps=3, max_bad_steps=2)
    res = run_training(step, state0, batch_fn, cfg, fault_injector=(
        FaultInjector(FaultPlan(nan_at_steps=frozenset({1, 2})))))
    assert res.state.step == 3
    assert res.rollbacks == 1 and res.bad_steps == 2
    _same_losses(res.losses, _run(rig, 3).losses)


def test_bad_step_boundary_not_checkpointed(rig, tmp_path):
    step, state0, batch_fn = rig
    ck = str(tmp_path / 'badsave')
    cfg = TrainLoopConfig(num_steps=4, ckpt_dir=ck, ckpt_every=2)
    res = run_training(step, state0, batch_fn, cfg, fault_injector=(
        FaultInjector(FaultPlan(nan_at_steps=frozenset({1})))))
    assert res.bad_steps == 1 and res.state.step == 4
    assert 'step_000000002' not in os.listdir(ck)
    assert latest_step(ck) == 4


def test_persistent_divergence_raises(rig):
    step, state0, batch_fn = rig
    cfg = TrainLoopConfig(num_steps=3, max_bad_steps=2, max_rollbacks=1)
    with pytest.raises(RuntimeError, match='diverged'):
        run_training(step, state0, batch_fn, cfg, fault_injector=(
            FaultInjector(FaultPlan(nan_at_steps=frozenset({0, 1}),
                                    fire_once=False))))


def test_checkpoint_retention_keep_last(rig, tmp_path):
    step, state0, batch_fn = rig
    ck = str(tmp_path / 'keep')
    cfg = TrainLoopConfig(num_steps=6, ckpt_dir=ck, ckpt_every=1,
                          keep_last=3)
    res = run_training(step, state0, batch_fn, cfg)
    assert res.state.step == 6
    assert sorted(n for n in os.listdir(ck) if n.startswith('step_')) == [
        'step_000000004', 'step_000000005', 'step_000000006']
    assert latest_step(ck) == 6


def test_preempt_flag_escalates_on_second_signal():
    flag = _PreemptFlag()
    restored = []
    flag.restore = lambda: restored.append(True)
    flag(15, None)
    assert flag.set and flag.signum == 15 and restored == [True]
    flag(15, None)
    assert restored == [True]


def test_failed_async_flush_falls_back_to_blocking_save(rig, tmp_path,
                                                        monkeypatch):
    step, state0, batch_fn = rig
    ck = str(tmp_path / 'flush')
    real_wait = ckpt.wait
    calls = {'n': 0}

    def flaky_wait(path=None):
        calls['n'] += 1
        if calls['n'] == 1:
            raise OSError('injected background-flush failure')
        return real_wait(path)
    monkeypatch.setattr(ckpt, 'wait', flaky_wait)
    cfg = TrainLoopConfig(num_steps=4, ckpt_dir=ck, ckpt_every=2)
    res = run_training(step, state0, batch_fn, cfg)
    assert calls['n'] >= 1 and res.state.step == 4
    assert latest_step(ck) == 4


def test_failed_background_write_is_raised_once_by_wait(tmp_path,
                                                        monkeypatch):
    """The port's async write runs in a thread: its error surfaces from
    ``wait`` (once), and the run's fallback save then lands."""
    def broken(target, host):
        raise OSError('disk full')
    monkeypatch.setattr(ckpt, '_write', broken)
    state = TrainState(1, {'w': torch.zeros(2)}, {'m': torch.zeros(2)})
    ckpt.save(tmp_path, state, blocking=False)
    with pytest.raises(OSError, match='disk full'):
        ckpt.wait(tmp_path)
    ckpt.discard_pending(tmp_path)
    monkeypatch.undo()
    ckpt.save(tmp_path, state)
    assert latest_step(tmp_path) == 1


def test_transient_save_errors_are_retried(rig, tmp_path):
    step, state0, batch_fn = rig
    ck = str(tmp_path / 'retry')
    cfg = TrainLoopConfig(num_steps=2, ckpt_dir=ck, save_retries=3,
                          save_backoff=0.01)
    res = run_training(step, state0, batch_fn, cfg, fault_injector=(
        FaultInjector(FaultPlan(io_error_saves=2))))
    assert res.state.step == 2 and latest_step(ck) == 2
    cfg = TrainLoopConfig(num_steps=2, ckpt_dir=str(tmp_path / 'retry2'),
                          save_retries=1, save_backoff=0.01)
    with pytest.raises(OSError):
        run_training(step, state0, batch_fn, cfg, fault_injector=(
            FaultInjector(FaultPlan(io_error_saves=10))))


def test_unguarded_step_drives_too(rig, tmp_path):
    """A bare-loss step (guard=False) runs through the loop: its losses
    equal the guarded step's on clean batches."""
    step, state0, batch_fn = rig
    bare = make_train_step(step.module, step.optimizer, seq_mesh())
    res = run_training(bare, state0, batch_fn, TrainLoopConfig(num_steps=3))
    _same_losses(res.losses, _run(rig, 3).losses)


# -- the fault harness ------------------------------------------------------


def test_poison_batch_nans_floats_only():
    batch = (torch.ones((2, 3)), torch.arange(4), None,
             torch.zeros((2,), dtype=torch.bool), {'t': torch.full((2,), 2.)})
    out = poison_batch(batch)
    assert torch.isnan(out[0]).all() and torch.isnan(out[4]['t']).all()
    assert torch.equal(out[1], torch.arange(4)) and out[2] is None
    assert out[3].dtype == torch.bool


def test_poison_batch_requires_float_leaves():
    with pytest.raises(ValueError, match='no floating'):
        poison_batch((torch.arange(4), None))


def test_plan_from_env_parses_knobs():
    plan = plan_from_env({'DDP_TPU_FAULT_NAN_STEPS': '3, 7',
                          'DDP_TPU_FAULT_IO_ERRORS': '2',
                          'DDP_TPU_FAULT_CRASH_SAVE_STEP': '10',
                          'DDP_TPU_FAULT_SIGTERM_STEP': '20'})
    assert plan.nan_at_steps == frozenset({3, 7})
    assert plan.io_error_saves == 2 and plan.crash_in_save_at_step == 10
    assert plan.sigterm_at_step == 20 and plan.any()
    assert not plan_from_env({}).any()


def test_wrapped_batch_fn_fires_once_per_step():
    inj = FaultInjector(FaultPlan(nan_at_steps=frozenset({1})))
    wrapped = inj.wrap_batch_fn(lambda i: (torch.ones(3),))
    assert not torch.isnan(wrapped(0)[0]).any()
    assert torch.isnan(wrapped(1)[0]).all()
    assert not torch.isnan(wrapped(1)[0]).any()
    inj = FaultInjector(FaultPlan(nan_at_steps=frozenset({1}),
                                  fire_once=False))
    wrapped = inj.wrap_batch_fn(lambda i: (torch.ones(3),))
    assert torch.isnan(wrapped(1)[0]).all() and torch.isnan(
        wrapped(1)[0]).all()


def test_io_error_injection_counts_down(tmp_path):
    state = TrainState(1, {'w': torch.zeros(3)}, {'m': torch.zeros(3)})
    with FaultInjector(FaultPlan(io_error_saves=2)):
        for _ in range(2):
            with pytest.raises(OSError, match='injected'):
                ckpt.save(tmp_path, state)
        ckpt.save(tmp_path, state)
    assert latest_step(tmp_path) == 1


def test_crash_mid_save_leaves_unfinalized_dir(tmp_path):
    state = TrainState(4, {'w': torch.zeros(3)}, {'m': torch.zeros(3)})
    with FaultInjector(FaultPlan(crash_in_save_at_step=4)):
        with pytest.raises(SimulatedCrash):
            ckpt.save(tmp_path, state)
    assert any(ckpt._TMP in n for n in os.listdir(tmp_path))
    assert latest_step(tmp_path) is None
    assert not issubclass(SimulatedCrash, Exception)


def test_injector_install_is_exclusive_and_restores():
    inj1 = FaultInjector(FaultPlan(io_error_saves=1))
    inj2 = FaultInjector(FaultPlan(io_error_saves=1))
    with inj1:
        with pytest.raises(RuntimeError, match='already installed'):
            inj2.install()
    assert ckpt._SAVE_FAULT_HOOK is None
    with inj2:
        assert ckpt._SAVE_FAULT_HOOK is inj2._hook
    assert ckpt._SAVE_FAULT_HOOK is None


def test_synthetic_sigterm_is_a_real_signal():
    got = []
    old = signal.signal(signal.SIGTERM, lambda s, f: got.append(s))
    try:
        inj = FaultInjector(FaultPlan(sigterm_at_step=5))
        inj.on_step(4)
        assert got == []
        inj.on_step(5)
        assert got == [signal.SIGTERM]
        inj.on_step(5)
        assert got == [signal.SIGTERM]
    finally:
        signal.signal(signal.SIGTERM, old)


def test_tracing_timers(capsys, monkeypatch):
    best, mean = tracing.time_fn(lambda x: x * 2, torch.ones(4), iters=2)
    assert 0 < best <= mean
    with tracing.timed() as t:
        sum(range(1000))
    assert t.seconds > 0
    monkeypatch.setenv(tracing.DEBUG_ENV_VAR, '1')
    tracing.measure(lambda x: x + 1)(torch.ones(2))
    tracing.log_step(3, 0.5, grad_norm=1.0, bad=True, seconds=0.01)
    out = capsys.readouterr().out
    assert 'shapes=[(2,)]' in out and 'step 3: loss=0.500000' in out
    assert 'BAD' in out
