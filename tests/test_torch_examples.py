# -*- coding: utf-8 -*-
"""
The port's harness twins (``torch_example.py``,
``torch_example_longcontext.py``, ``examples/torch_train_lm.py``,
``examples/torch_serve_lm.py``) on the CPU at tiny widths: each runs with
``--device cpu`` and exits 0; the LM trainer's resumed run reproduces the
uninterrupted one's losses exactly; the serving driver's terminal counts
equal the reference driver's (``examples/serve_lm.py``) on the same seed,
fault-free and with the stuck-step and NaN fault knobs. Each twin runs on
the card unless given ``--device cpu``: without one it refuses.
"""

import importlib.util
import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cyclic_gc_paused():
    """The reference's retrace counters take their registry's lock in
    their finalizer, and its engines sit in reference cycles: a cyclic
    collection inside one of its locked sections deadlocks the thread
    (ROADMAP §3). The JAX side of these tests runs with the collector
    paused, and collections run only before and after each test, where
    no such section is open (so no test leaves its engines' cycles for
    a later test's section to collect)."""
    import gc
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.collect()
        gc.enable()


def _load(relpath, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_torch_example_cli_exits_0():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, 'torch_example.py'),
         '--device', 'cpu', '--seq-len', '64', '--dim', '32', '--offset',
         '16', '--steps', '2'], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert 'step 1: loss=' in res.stdout


@pytest.mark.parametrize('relpath', [
    'torch_example.py', 'torch_example_longcontext.py',
    os.path.join('examples', 'torch_train_lm.py'),
    os.path.join('examples', 'torch_serve_lm.py')])
def test_twin_refuses_without_a_card(relpath):
    """The default device is the card: with none, a twin raises before it
    builds anything — it never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default device runs')
    mod = _load(relpath, 'twin_' + os.path.basename(relpath)[:-3])
    with pytest.raises(RuntimeError, match='cuda'):
        mod.main([])


def test_longcontext_checkpoint_resume_and_generate(tmp_path):
    mod = _load('torch_example_longcontext.py', 'twin_longcontext')
    argv = ['--device', 'cpu', '--seq-len', '64', '--dim', '64', '--heads',
            '2', '--kv-heads', '1', '--steps', '2', '--ckpt-dir',
            str(tmp_path)]
    first = mod.main(argv + ['--generate', '2'])
    assert first['exit_code'] == 0 and first['resumed_from'] is None
    assert sorted(first['losses']) == [0, 1]
    assert first['decode_finite']
    again = mod.main(argv + ['--generate', '0'])
    assert again['resumed_from'] == 2
    assert sorted(again['losses']) == [2, 3]


_LM = ['--device', 'cpu', '--batch', '1', '--seq-len', '32', '--seg-len',
       '16', '--vocab', '32', '--dim', '64', '--heads', '2', '--layers', '1',
       '--log-every', '0']


def test_train_lm_resume_equals_uninterrupted(tmp_path):
    """Interrupted at step 2 and resumed, the trainer computes the same
    losses for steps 2 and 3 as a run that never stopped: the batches
    are a function of the step index and the checkpoint restores the
    model and the optimizer exactly."""
    mod = _load(os.path.join('examples', 'torch_train_lm.py'), 'twin_lm')
    whole = mod.main(_LM + ['--steps', '4', '--ckpt-every', '2',
                            '--ckpt-dir', str(tmp_path / 'a'),
                            '--generate'])
    assert whole['exit_code'] == 0 and whole['acc'] is not None
    part = mod.main(_LM + ['--steps', '2', '--ckpt-every', '2',
                           '--ckpt-dir', str(tmp_path / 'b')])
    assert part['resumed_from'] is None
    resumed = mod.main(_LM + ['--steps', '4', '--ckpt-every', '2',
                              '--ckpt-dir', str(tmp_path / 'b')])
    assert resumed['resumed_from'] == 2
    assert all(v == v for v in whole['losses'].values())
    for i in (2, 3):
        assert resumed['losses'][i] == whole['losses'][i], i


_TERMINAL = re.compile(r'submitted=(\d+) rejected_at_submit=(\d+) '
                       r'terminal=(\{.*\})')


def _serve_counts(mod, argv, capsys, **kw):
    rc = mod.main(argv, **kw)
    out = capsys.readouterr().out
    (m,) = _TERMINAL.findall(out)
    return rc, m


@pytest.mark.parametrize('faults', [False, True])
def test_serve_lm_terminal_counts_equal_the_references(faults, monkeypatch,
                                                       capsys):
    """The same seeded burst through both drivers: the same per-state
    terminal counts and rejections, every audit passing — fault-free, and
    with a stuck step and a NaN decode injected (plus the bit-identity
    check against a clean rerun)."""
    for knob in ('DDP_TPU_PAGED_CACHE', 'DDP_TPU_DECODE_KERNEL',
                 'DDP_TPU_WEIGHT_QUANT'):
        monkeypatch.delenv(knob, raising=False)
    if faults:
        monkeypatch.setenv('DDP_TPU_FAULT_STUCK_STEP', '4')
        monkeypatch.setenv('DDP_TPU_FAULT_NAN_DECODE_STEP', '7')
    argv = ['--requests', '24'] + (['--check-identical'] if faults else [])
    ref = _load(os.path.join('examples', 'serve_lm.py'), 'ref_serve_lm')
    port = _load(os.path.join('examples', 'torch_serve_lm.py'),
                 'twin_serve_lm')
    want_rc, want = _serve_counts(ref, argv, capsys)
    summary = {}
    rc, got = _serve_counts(port, ['--device', 'cpu'] + argv, capsys,
                            summary=summary)
    assert rc == want_rc == 0
    assert got == want
    assert summary['failures'] == []
