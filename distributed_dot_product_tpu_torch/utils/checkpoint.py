# -*- coding: utf-8 -*-
"""
Checkpoint / resume of training state — the port of
``distributed_dot_product_tpu/utils/checkpoint.py``.

The reference writes through orbax; here one ``torch.save`` file per
step holds the state, copied to host memory first. A step lives in
``<root>/step_NNNNNNNNN/`` and is written atomically: the file goes into
a temporary directory (``step_NNNNNNNNN.ckpt-tmp-<pid>``), is flushed to
disk (``fsync``, the directory too), the directory is renamed to its
step name, and a ``FINALIZED`` marker is written last. :func:`latest_step`
selects only directories that carry the marker, so a crash mid-save is
never restored; :func:`recover_interrupted` removes what such a crash
leaves. Overwriting an existing step keeps the old one as
``step_N.replaced`` until the new one is finalized.

``TrainState.params`` and ``.opt_state`` are the module's and the
optimizer's ``state_dict()``s (the port's train steps own their module
and optimizer). :func:`restore` checks the key paths, shapes and dtypes
on disk against a template and raises :class:`CheckpointMismatchError`
naming the step directory on any difference; the tensors land on the
template's devices. An empty mapping in the template's optimizer state
(a fresh optimizer creates its moments at its first step) takes what is
on disk, on the device of the template's first parameter.

``save(..., blocking=False)`` copies the state to host memory before it
returns — parameters are updated in place, so the background write must
not read them — and writes in a thread; :func:`wait` finalizes (per
checkpoint root, or all of them) and re-raises a failed background
write once, :func:`discard_pending` drops the bookkeeping after one.

Multi-rank: every rank of the default process group calls the functions
collectively; rank 0 decides whether a step exists, writes, and does all
directory work, and the ranks meet at barriers (``comm.synchronize``) as
the reference's processes do. Object-store URLs (``gs://...``) raise
``NotImplementedError``: the port writes local (or mounted) paths only.

Usage::

    state = TrainState(step=0, params=model.state_dict(),
                       opt_state=optimizer.state_dict())
    save(ckpt_dir, state)                    # atomic, collective
    state = restore(ckpt_dir, state)         # template = like-shaped state
    model.load_state_dict(state.params)
    optimizer.load_state_dict(state.opt_state)
"""

import os
import shutil
import threading
from pathlib import Path
from typing import Any, NamedTuple, Optional

import torch

from distributed_dot_product_tpu_torch.utils.comm import (
    get_rank, get_world_size, synchronize,
)

__all__ = ['TrainState', 'save', 'restore', 'latest_step', 'wait',
           'discard_pending', 'gc_old_steps', 'recover_interrupted',
           'CheckpointMismatchError']

_TMP = '.ckpt-tmp'            # in the name of an unfinished write
_STATE = 'state.pt'
_FINAL = 'FINALIZED'          # written last: the step is complete


class TrainState(NamedTuple):
    """Training state: a step counter, the module's ``state_dict()`` and
    the optimizer's ``state_dict()``."""
    step: int
    params: Any
    opt_state: Any


class CheckpointMismatchError(ValueError):
    """A checkpoint exists but its on-disk tree does not match the restore
    template (typically: ``TrainState`` fields, the model architecture, or
    the optimizer changed since the checkpoint was written)."""


# Fault-injection seam (see utils/faults.py): when set, called as
# ``hook(target_dir)`` at the top of ``save`` and may raise to simulate
# transient I/O failure or a crash mid-save. Never set in production.
_SAVE_FAULT_HOOK = None


def _root(path):
    """The run directory, absolutized; object-store URLs raise."""
    s = os.fspath(path)
    if '://' in s:
        raise NotImplementedError(
            f'object-store checkpoint URLs are not ported ({s!r}): the '
            f'port writes local or mounted paths only')
    return Path(os.path.abspath(s))


def _step_dir(path, step):
    return _root(path) / f'step_{step:09d}'


def _is_main():
    return get_rank() == 0


def _agree(value):
    """Rank 0's ``value`` on every rank of the default group (rank 0's
    filesystem view decides for everyone)."""
    if get_world_size() == 1:
        return value
    import torch.distributed as dist
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _is_finalized(path):
    return _TMP not in path.name and (path / _FINAL).is_file()


def _fsync_dir(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _to_host(tree):
    """A copy of ``tree`` with every tensor copied to host memory."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to('cpu', copy=True)
    if isinstance(tree, dict):
        return type(tree)((k, _to_host(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _write(target, host):
    """The atomic write of a host copy: temporary directory, fsync,
    rename, then the marker."""
    tmp = target.parent / f'{target.name}{_TMP}-{os.getpid()}'
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    with open(tmp / _STATE, 'wb') as f:
        torch.save(host, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    os.rename(tmp, target)
    _fsync_dir(target.parent)
    with open(target / _FINAL, 'w') as f:
        f.write(f'{host["step"]}\n')
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(target)


class _RootPending:
    """Deferred async-save state for ONE checkpoint root: overwrite
    backups whose removal waits for their save to finalize, whether an
    async save is outstanding, and the thread writing it (rank 0)."""

    __slots__ = ('backups', 'async_pending', 'thread', 'error')

    def __init__(self):
        self.backups = []
        self.async_pending = False
        self.thread = None
        self.error = None


# Keyed by absolutized root path, so two runs in one process never touch
# each other's deferred cleanup.
_PENDING_ROOTS = {}


def _pending(path) -> _RootPending:
    return _PENDING_ROOTS.setdefault(str(_root(path)), _RootPending())


def wait(path=None):
    """Block until outstanding ``save(..., blocking=False)`` writes have
    finalized, then remove the overwrite backups they deferred.
    ``path=None`` finalizes every root this process has saved to; a
    checkpoint root restricts the cleanup to that root. A background
    write that failed is re-raised here, once, with the bookkeeping left
    in place (:func:`discard_pending` drops it). Collective. A no-op when
    nothing is pending."""
    states = ([_pending(path)] if path is not None
              else list(_PENDING_ROOTS.values()))
    if not any(st.async_pending or st.backups for st in states):
        return
    error = None
    for st in states:
        if st.thread is not None:
            st.thread.join()
            st.thread = None
        if st.error is not None and error is None:
            error = st.error
        st.error = None
    failed = _agree(None if error is None else f'{type(error).__name__}: '
                                                f'{error}')
    if failed is not None:
        if error is not None:
            raise error
        raise OSError(f'the checkpoint write on rank 0 failed: {failed}')
    synchronize()
    for st in states:
        if _is_main():
            for backup in st.backups:
                if backup.is_dir():
                    _resolve_backup(backup)
        st.backups.clear()
        st.async_pending = False


def _resolve_backup(backup):
    """Decide the fate of one ``step_N.replaced`` overwrite backup: if
    the replacement finalized, the backup is stale — remove it; if not,
    the backup is the only surviving copy of the step — remove the
    partial replacement and restore the backup. Returns ``(action,
    name)`` pairs describing what was done."""
    orig = backup.parent / backup.name[:-len('.replaced')]
    if orig.is_dir() and _is_finalized(orig):
        shutil.rmtree(backup)
        return [('removed-stale-backup', backup.name)]
    actions = []
    if orig.is_dir():
        shutil.rmtree(orig)
        actions.append(('removed-partial', orig.name))
    backup.rename(orig)
    actions.append(('restored-backup', orig.name))
    return actions


def discard_pending(path):
    """Abandon the deferred bookkeeping for ``path`` WITHOUT touching
    disk (after a failed async write: its overwrite backups stay for
    :func:`recover_interrupted`)."""
    st = _pending(path)
    st.async_pending = False
    st.backups.clear()


def save(path, state: TrainState, *, force: bool = True,
         blocking: bool = True) -> str:
    """Write ``state`` under ``path/step_<step>/``; returns that directory.

    Atomic (see the module docstring). If the step already exists and
    ``force`` is set, the old checkpoint is kept as
    ``step_<step>.replaced`` until the new write finalizes.
    ``blocking=False`` copies the state to host memory, starts the write
    in a background thread and returns; a new ``save`` to the same root
    first waits for a pending one. Collective: every rank calls it with
    the same (replicated) state, rank 0 writes."""
    target = _step_dir(path, int(state.step))
    if _SAVE_FAULT_HOOK is not None:
        _SAVE_FAULT_HOOK(target)
    st = _pending(path)
    if st.async_pending:
        wait(path)
    backup = target.parent / (target.name + '.replaced')
    exists = _agree(target.is_dir() if _is_main() else None)
    if exists and not force:
        raise FileExistsError(
            f'{target} already exists; pass force=True to replace it')
    if _is_main():
        if exists:
            if backup.is_dir():
                shutil.rmtree(backup)
            target.rename(backup)
        host = {'step': int(state.step), 'params': _to_host(state.params),
                'opt_state': _to_host(state.opt_state)}
        if blocking:
            _write(target, host)
        else:
            def run():
                try:
                    _write(target, host)
                # Kept, and re-raised by wait():
                # graphlint: allow[silent-except]
                except Exception as exc:
                    st.error = exc
            # Not a daemon on purpose: interpreter exit waits for the
            # write to finalize rather than dropping a checkpoint.
            # graphlint: allow[thread-discipline]
            st.thread = threading.Thread(target=run, name='checkpoint-save')
            st.thread.start()
    if not blocking:
        st.async_pending = True
        if exists:
            st.backups.append(backup)
        return os.fspath(target)
    synchronize()
    if exists and _is_main() and backup.is_dir():
        shutil.rmtree(backup)
    return os.fspath(target)


def _finalized_steps(path):
    """Sorted list of steps with a finalized checkpoint under ``path``."""
    root = _root(path)
    if not root.is_dir():
        return []
    steps = []
    for child in root.iterdir():
        name = child.name
        if not name.startswith('step_') or name.endswith('.replaced'):
            continue
        try:
            step = int(name[len('step_'):])
        except ValueError:
            continue
        if _is_finalized(child):
            steps.append(step)
    return sorted(steps)


def latest_step(path) -> Optional[int]:
    """Highest step with a FINALIZED checkpoint under ``path``, or None —
    a crash mid-save leaves an unfinalized directory, which is skipped."""
    steps = _finalized_steps(path)
    return steps[-1] if steps else None


def gc_old_steps(path, keep_last: int):
    """Retention: delete all but the ``keep_last`` NEWEST finalized step
    directories (and their stale ``.replaced`` backups). Unfinalized
    directories are never touched. Returns the deleted step numbers.
    Collective."""
    if keep_last is None or keep_last < 1:
        return []
    doomed = _finalized_steps(path)[:-keep_last]
    if doomed and _is_main():
        root = _root(path)
        for step in doomed:
            for suffix in ('', '.replaced'):
                victim = root / f'step_{step:09d}{suffix}'
                if victim.is_dir():
                    shutil.rmtree(victim)
    synchronize()
    return doomed


def recover_interrupted(path):
    """Clean up after a crash mid-save, before resuming a run: remove
    unfinished writes (``*.ckpt-tmp*`` directories, and step directories
    that never got their marker and have no backup), and resolve every
    ``step_N.replaced`` backup (restored when ``step_N`` is missing or
    unfinalized, removed otherwise). Returns ``(action, name)`` pairs.
    Call when no async save is in flight. Collective."""
    root = _root(path)
    if not root.is_dir():
        return []
    actions = []
    if _is_main():
        for child in sorted(root.iterdir()):
            if _TMP in child.name:
                shutil.rmtree(child)
                actions.append(('removed-partial', child.name))
        for child in sorted(root.iterdir()):
            name = child.name
            if name.startswith('step_') and name.endswith('.replaced'):
                actions.extend(_resolve_backup(child))
        for child in sorted(root.iterdir()):
            name = child.name
            if (name.startswith('step_') and not name.endswith('.replaced')
                    and child.is_dir() and not _is_finalized(child)):
                shutil.rmtree(child)
                actions.append(('removed-partial', name))
    synchronize()
    return actions


def _read_state(step_dir):
    """The object saved in ``step_dir`` (tensors on the host)."""
    return torch.load(step_dir / _STATE, map_location='cpu',
                      weights_only=True)


def _leaves(tree, path=''):
    """``(key path, leaf)`` pairs of a nested dict / list / tuple."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f'{path}[{k!r}]')
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f'{path}[{i}]')
    else:
        yield path, tree


def _describe(leaf):
    if isinstance(leaf, torch.Tensor):
        return f'{str(leaf.dtype)[6:]}{list(leaf.shape)}'
    return type(leaf).__name__


def _tree_summary(tree):
    """Compact description of a tree: its leaves' key paths, with each
    tensor's dtype and shape."""
    items = [f'{p} {_describe(v)}' for p, v in _leaves(tree)]
    return f'{len(items)} leaves: ' + ', '.join(items[:20]) + (
        ', ...' if len(items) > 20 else '')


def _merge(tmpl, disk, path, errors, device, lazy):
    """``disk`` shaped as ``tmpl``: tensors moved to the template's
    devices; every difference of keys, lengths, shapes or dtypes appended
    to ``errors``. ``lazy``: an empty template mapping takes the disk's
    subtree (an optimizer's lazily created state)."""
    if isinstance(tmpl, dict):
        if not isinstance(disk, dict):
            errors.append(f'{path}: a mapping in the template, '
                          f'{_describe(disk)} on disk')
            return disk
        if lazy and not tmpl:
            return _to_device(disk, device)
        if set(tmpl) != set(disk):
            missing = sorted(map(repr, set(tmpl) - set(disk)))
            extra = sorted(map(repr, set(disk) - set(tmpl)))
            errors.append(f'{path}: keys differ (missing on disk: '
                          f'{missing[:8]}, not in the template: '
                          f'{extra[:8]})')
            return disk
        return type(disk)((k, _merge(tmpl[k], disk[k], f'{path}[{k!r}]',
                                     errors, device, lazy)) for k in disk)
    if isinstance(tmpl, (list, tuple)):
        if not isinstance(disk, (list, tuple)) or len(disk) != len(tmpl):
            errors.append(f'{path}: {len(tmpl)} items in the template, '
                          f'{_describe(disk)} on disk')
            return disk
        return type(tmpl)(_merge(t, d, f'{path}[{i}]', errors, device, lazy)
                          for i, (t, d) in enumerate(zip(tmpl, disk)))
    if isinstance(tmpl, torch.Tensor):
        if not isinstance(disk, torch.Tensor) or disk.dtype != tmpl.dtype \
                or disk.shape != tmpl.shape:
            errors.append(f'{path}: {_describe(tmpl)} in the template, '
                          f'{_describe(disk)} on disk')
            return disk
        return disk.to(tmpl.device)
    return disk


def _to_device(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return type(tree)((k, _to_device(v, device)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree


def _mismatch_message(step_dir, template, found, detail):
    return (
        f'failed to restore checkpoint {step_dir}: the on-disk tree does '
        f'not match the restore template.\n'
        f'  expected (template): {_tree_summary(template)}\n'
        f'  found (on disk):     {found}\n'
        f'  hint: if TrainState fields, the model architecture, or the '
        f'optimizer changed since this checkpoint was written, restore '
        f'with a template built from the OLD structure (then migrate), '
        f'or start a fresh run directory.\n'
        f'  original error: {detail}')


def restore(path, template: TrainState, *, step: Optional[int] = None
            ) -> TrainState:
    """Restore the checkpoint at ``step`` (default: the latest finalized)
    onto ``template`` (a ``TrainState`` of like-shaped state dicts): the
    key paths, shapes and dtypes on disk must match the template's, and
    every tensor lands on the device of its template tensor. Raises
    :class:`CheckpointMismatchError` naming the step directory on any
    difference, ``FileNotFoundError`` without a checkpoint, and lets an
    ``OSError`` of the read keep its type."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f'no checkpoint under {path!r}')
    step_dir = _step_dir(path, step)
    tmpl = {'step': template.step, 'params': template.params,
            'opt_state': template.opt_state}
    try:
        disk = _read_state(step_dir)
    except (KeyboardInterrupt, SystemExit, OSError):
        raise
    except Exception as e:
        raise CheckpointMismatchError(
            _mismatch_message(step_dir, tmpl, 'unreadable', e)) from e
    first = next((v for _, v in _leaves(template.params)
                  if isinstance(v, torch.Tensor)), None)
    device = 'cpu' if first is None else first.device
    errors = []
    if not isinstance(disk, dict) or set(disk) != set(tmpl):
        errors.append(f'top level: {_describe(disk)} on disk, '
                      f'{sorted(tmpl)} expected')
        merged = {}
    else:
        merged = {k: _merge(tmpl[k], disk[k], f'.{k}', errors, device,
                            lazy=k == 'opt_state')
                  for k in ('params', 'opt_state')}
    if errors:
        cause = ValueError('; '.join(errors))
        raise CheckpointMismatchError(_mismatch_message(
            step_dir, tmpl, _tree_summary(disk), cause)) from cause
    return TrainState(int(disk['step']), merged['params'],
                      merged['opt_state'])
