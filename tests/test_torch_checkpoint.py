# -*- coding: utf-8 -*-
"""
The port's checkpoint module (``utils/checkpoint.py``) held to the
contracts the reference's ``tests/test_checkpoint.py`` and
``tests/test_checkpoint_robustness.py`` pin:

- a run interrupted, restored and continued gives the uninterrupted
  run's losses bit for bit, and the restored parameters and Adam moments
  equal the saved ones bit for bit;
- the latest finalized step wins; an overwrite keeps its backup until
  the new write is finalized; ``force=False`` refuses to overwrite;
- a partial write (a crash mid-save) is skipped and recovered; retention
  keeps the newest finalized steps; a mismatched template raises
  ``CheckpointMismatchError`` naming the step directory, an ``OSError``
  of the read keeps its type, a missing checkpoint is
  ``FileNotFoundError``;
- async saves: pending state per checkpoint root, ``wait`` per root or
  all, and the snapshot taken before ``save`` returns (a later in-place
  ``optimizer.step()`` does not reach the checkpoint);
- object-store URLs are refused;
- the recipe's checkpoint stage (``__graft_entry__.py``) on the 2 × 2
  gloo group: the restored step equals the uninterrupted one bit for bit.

The training rig is the port's attention module on the CPU (one rank),
Adam at 1e-2, inputs from a seeded numpy generator.
"""

import os
import threading

import numpy as np
import pytest
import torch

from torch_dist import GlooGroup

from distributed_dot_product_tpu_torch import (
    DistributedDotProductAttn, make_train_step, seq_mesh,
)
from distributed_dot_product_tpu_torch.utils import checkpoint as ckpt
from distributed_dot_product_tpu_torch.utils.checkpoint import (
    CheckpointMismatchError, TrainState, gc_old_steps, latest_step,
    recover_interrupted, restore, save, wait,
)

DIM, HEADS, T, B = 32, 4, 16, 2


def _setup(seed=2):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((B, T, DIM), dtype=np.float32))
    target = torch.from_numpy(rng.standard_normal((B, T, DIM),
                                                  dtype=np.float32))
    mask = torch.zeros((B, T, T), dtype=torch.bool)
    model = DistributedDotProductAttn(
        DIM, num_heads=HEADS, offset=2, device='cpu',
        generator=torch.Generator().manual_seed(seed))
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    step = make_train_step(model, opt, seq_mesh())
    return model, opt, step, (x, x, x, mask, target)


def _state(model, opt, step):
    return TrainState(step, model.state_dict(), opt.state_dict())


def _tree_equal(a, b):
    la, lb = list(ckpt._leaves(a)), list(ckpt._leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), p
        else:
            assert x == y, p


def test_resume_reproduces_uninterrupted_run(tmp_path):
    model, opt, step, batch = _setup()
    losses = [step(batch).item() for _ in range(4)]

    model, opt, step, batch = _setup()
    for _ in range(2):
        step(batch)
    save(tmp_path, _state(model, opt, 2))
    assert latest_step(tmp_path) == 2
    model, opt, step, batch = _setup(seed=9)        # other weights
    restored = restore(tmp_path, _state(model, opt, 0))
    assert restored.step == 2
    model.load_state_dict(restored.params)
    opt.load_state_dict(restored.opt_state)
    resumed = [step(batch).item() for _ in range(2)]
    assert resumed == losses[2:]


def test_restored_state_bitwise_equal_onto_a_fresh_optimizer(tmp_path):
    """Parameters and Adam moments (where params-only checkpointing
    silently diverges), restored onto a fresh optimizer whose moments do
    not exist yet: the template's empty state takes the disk's."""
    model, opt, step, batch = _setup()
    step(batch)
    save(tmp_path, _state(model, opt, 1))
    fresh, fopt, _, _ = _setup(seed=5)
    assert not fopt.state_dict()['state']
    got = restore(tmp_path, _state(fresh, fopt, 0))
    _tree_equal(got.params, model.state_dict())
    _tree_equal(got.opt_state, opt.state_dict())
    assert all(t.device == torch.device('cpu')
               for _, t in ckpt._leaves(got.opt_state)
               if isinstance(t, torch.Tensor))


def test_resave_same_step_keeps_backup_until_finalized(tmp_path):
    model, opt, _, _ = _setup()
    save(tmp_path, _state(model, opt, 2))
    seen = []
    real = ckpt._write

    def spy(target, host):
        seen.append(sorted(os.listdir(tmp_path)))
        real(target, host)
    ckpt._write = spy
    try:
        save(tmp_path, _state(model, opt, 2))
    finally:
        ckpt._write = real
    # During the overwrite the old step survives as the backup.
    assert seen == [['step_000000002.replaced']]
    assert latest_step(tmp_path) == 2
    assert restore(tmp_path, _state(model, opt, 0)).step == 2
    assert not os.path.isdir(tmp_path / 'step_000000002.replaced')
    with pytest.raises(FileExistsError):
        save(tmp_path, _state(model, opt, 2), force=False)


def test_restore_without_checkpoint_raises(tmp_path):
    model, opt, _, _ = _setup()
    with pytest.raises(FileNotFoundError):
        restore(tmp_path / 'empty', _state(model, opt, 0))


def test_multiple_steps_latest_wins(tmp_path):
    model, opt, _, _ = _setup()
    for s in (1, 5, 3):
        save(tmp_path, _state(model, opt, s))
    assert latest_step(tmp_path) == 5
    assert restore(tmp_path, _state(model, opt, 0)).step == 5
    assert restore(tmp_path, _state(model, opt, 0), step=3).step == 3


def test_object_store_urls_refused():
    """The port writes local (or mounted) paths; object-store URLs raise
    instead of writing somewhere unexpected."""
    for fn in (lambda: latest_step('gs://bucket/run1'),
               lambda: ckpt._step_dir('gs://bucket/run1', 7),
               lambda: save('gs://bucket/run1',
                            TrainState(1, {'w': torch.zeros(2)}, {}))):
        with pytest.raises(NotImplementedError, match='object-store'):
            fn()
    assert str(ckpt._root('relative/dir')).startswith('/')


def test_async_save_overlaps_training(tmp_path):
    model, opt, step, batch = _setup()
    ck = tmp_path / 'async'
    for i in range(1, 4):
        step(batch)
        save(ck, _state(model, opt, i), blocking=False)
    wait()
    assert latest_step(ck) == 3
    fresh, fopt, _, _ = _setup(seed=4)
    got = restore(ck, _state(fresh, fopt, 0))
    _tree_equal(got.params, model.state_dict())
    save(ck, _state(model, opt, 3), blocking=False)     # async overwrite
    wait()
    names = set(os.listdir(ck))
    assert 'step_000000003' in names
    assert not any(n.endswith('.replaced') for n in names)


def test_async_resave_same_step_without_overwrite(tmp_path):
    model, opt, step, batch = _setup()
    ck = tmp_path / 'resave'
    step(batch)
    save(ck, _state(model, opt, 1), blocking=False)
    step(batch)
    save(ck, _state(model, opt, 1), blocking=False)       # must not raise
    wait()
    got = restore(ck, _state(model, opt, 0))
    _tree_equal(got.params, model.state_dict())


def test_async_snapshot_not_raced_by_optimizer_step(tmp_path, monkeypatch):
    """PyTorch updates parameters in place: ``blocking=False`` must copy
    the state before it returns, or the background write would record
    the parameters of a LATER step. The write is held back until the
    next ``optimizer.step()`` has run."""
    model, opt, step, batch = _setup()
    step(batch)
    want = {k: v.clone() for k, v in model.state_dict().items()}
    gate = threading.Event()
    real = ckpt._write

    def held(target, host):
        gate.wait(timeout=30)
        real(target, host)
    monkeypatch.setattr(ckpt, '_write', held)
    save(tmp_path, _state(model, opt, 1), blocking=False)
    step(batch)                        # in place, while the write waits
    gate.set()
    wait(tmp_path)
    got = restore(tmp_path, _state(model, opt, 0))
    _tree_equal(got.params, want)
    assert not all(torch.equal(want[k], v)
                   for k, v in model.state_dict().items())


def _small(step, scale=1.0):
    return TrainState(step, {'w': torch.full((4,), scale)},
                      {'m': torch.zeros(4)})


def test_async_pending_state_scoped_per_root(tmp_path):
    root_a, root_b = tmp_path / 'a', tmp_path / 'b'
    save(root_a, _small(1, 1.0))
    save(root_b, _small(1, 10.0))
    save(root_a, _small(1, 2.0), blocking=False)
    save(root_b, _small(1, 20.0), blocking=False)
    pend_a, pend_b = ckpt._pending(root_a), ckpt._pending(root_b)
    assert pend_a.async_pending and pend_b.async_pending
    assert len(pend_a.backups) == 1 and len(pend_b.backups) == 1
    wait(root_a)
    assert not pend_a.async_pending and not pend_a.backups
    assert pend_b.async_pending and len(pend_b.backups) == 1
    assert not any(n.endswith('.replaced') for n in os.listdir(root_a))
    wait(root_b)
    assert not pend_b.async_pending and not pend_b.backups
    assert restore(root_a, _small(0)).params['w'].tolist() == [2.0] * 4
    assert restore(root_b, _small(0)).params['w'].tolist() == [20.0] * 4


def test_bare_wait_finalizes_all_roots(tmp_path):
    roots = (tmp_path / 'a', tmp_path / 'b')
    for root in roots:
        save(root, _small(1))
        save(root, _small(1, 2.0), blocking=False)
    wait()
    for root in roots:
        st = ckpt._pending(root)
        assert not st.async_pending and not st.backups
        assert not any(n.endswith('.replaced') for n in os.listdir(root))


@pytest.mark.parametrize('bad', ['keys', 'shape', 'dtype'])
def test_restore_mismatch_raises_diagnostic_error(tmp_path, bad):
    save(tmp_path, _small(3))
    params = {'keys': {'completely': {'different': torch.zeros(2)}},
              'shape': {'w': torch.zeros(5)},
              'dtype': {'w': torch.zeros(4, dtype=torch.float64)}}[bad]
    with pytest.raises(CheckpointMismatchError) as ei:
        restore(tmp_path, TrainState(0, params, {'m': torch.zeros(4)}))
    msg = str(ei.value)
    assert 'step_000000003' in msg
    assert 'expected (template)' in msg and 'found (on disk)' in msg
    assert 'hint' in msg and 'TrainState' in msg
    assert ei.value.__cause__ is not None
    assert restore(tmp_path, _small(0)).step == 3


def test_restore_io_errors_keep_their_type(tmp_path, monkeypatch):
    save(tmp_path, _small(1))

    def flaky(step_dir):
        raise PermissionError('storage said no')
    monkeypatch.setattr(ckpt, '_read_state', flaky)
    with pytest.raises(PermissionError):
        restore(tmp_path, _small(0))


def test_latest_step_skips_partial_write_and_recovers(tmp_path):
    """A crash mid-OVERWRITE of step 2: the old step 2 renamed to its
    backup, the new write unfinished. latest_step skips both;
    recover_interrupted removes the partial and restores the backup."""
    save(tmp_path, _small(1, 1.0))
    save(tmp_path, _small(2, 2.0))
    (tmp_path / 'step_000000002').rename(tmp_path / 'step_000000002.replaced')
    partial = tmp_path / 'step_000000002.ckpt-tmp-42'
    partial.mkdir()
    (partial / 'partial').write_text('dead write')
    assert latest_step(tmp_path) == 1
    kinds = {a for a, _ in recover_interrupted(tmp_path)}
    assert 'removed-partial' in kinds and 'restored-backup' in kinds
    assert latest_step(tmp_path) == 2
    got = restore(tmp_path, _small(0))
    assert got.step == 2 and got.params['w'].tolist() == [2.0] * 4
    assert not any(ckpt._TMP in n for n in os.listdir(tmp_path))


def test_unmarked_step_is_skipped_and_removed(tmp_path):
    """A crash after the rename but before the FINALIZED marker leaves a
    step directory without it: never restored, removed on recovery."""
    save(tmp_path, _small(1))
    save(tmp_path, _small(2))
    (tmp_path / 'step_000000002' / ckpt._FINAL).unlink()
    assert latest_step(tmp_path) == 1
    assert ('removed-partial', 'step_000000002') in recover_interrupted(
        tmp_path)
    assert sorted(os.listdir(tmp_path)) == ['step_000000001']


def test_recover_removes_stale_backup_of_finalized_step(tmp_path):
    save(tmp_path, _small(1))
    stale = tmp_path / 'step_000000001.replaced'
    stale.mkdir()
    (stale / 'junk').write_text('old')
    assert ('removed-stale-backup', 'step_000000001.replaced') in \
        recover_interrupted(tmp_path)
    assert latest_step(tmp_path) == 1 and not stale.exists()


def test_gc_old_steps_keeps_newest_finalized(tmp_path):
    for s in (1, 2, 3, 4, 5):
        save(tmp_path, _small(s, float(s)))
    partial = tmp_path / 'step_000000006.ckpt-tmp-1'
    partial.mkdir()
    assert gc_old_steps(tmp_path, keep_last=2) == [1, 2, 3]
    assert sorted(n for n in os.listdir(tmp_path) if n.startswith('step_')) \
        == ['step_000000004', 'step_000000005',
            'step_000000006.ckpt-tmp-1']
    assert restore(tmp_path, _small(0)).params['w'].tolist() == [5.0] * 4
    assert gc_old_steps(tmp_path, keep_last=10) == []
    assert gc_old_steps(tmp_path, keep_last=0) == []


def test_gc_removes_stale_backups_of_deleted_steps(tmp_path):
    for s in (1, 2, 3):
        save(tmp_path, _small(s))
    stale = tmp_path / 'step_000000001.replaced'
    stale.mkdir()
    (stale / 'junk').write_text('x')
    assert gc_old_steps(tmp_path, keep_last=1) == [1, 2]
    names = set(os.listdir(tmp_path))
    assert 'step_000000001.replaced' not in names
    assert 'step_000000003' in names


def test_recipe_checkpoint_stage_on_2x2(tmp_path):
    """``dryrun_multichip``'s checkpoint stage: the recipe's module (dim
    64, 4 heads, offset 2, 'full'), Adam 1e-3, global B 4 x T 8 with an
    all-False mask, on the 2 × 2 data × seq group; rank 0 writes, every
    rank barriers, and the step taken after restoring onto a fresh
    module and optimizer equals the uninterrupted step bit for bit."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 8, 64), dtype=np.float32)
    batch = (x, x, x, np.zeros((4, 8, 8), bool), np.zeros_like(x))
    kw = dict(key_dim=64, num_heads=4, offset=2)
    ref = DistributedDotProductAttn(device='cpu',
                                    generator=torch.Generator().manual_seed(1),
                                    **kw)
    state = {k: v.numpy() for k, v in ref.state_dict().items()}
    group = GlooGroup(4, str(tmp_path / 'store'))
    try:
        res = group.run('checkpoint_stage', kw, state, batch,
                        str(tmp_path / 'ck'))
    finally:
        group.close()
    for want, got, step, same in res:
        assert step == 1 and same
        assert np.isfinite(want) and got == want
    assert len({float(r[0]) for r in res}) == 1
