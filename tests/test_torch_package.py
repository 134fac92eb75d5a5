# -*- coding: utf-8 -*-
"""
Package contracts of the PyTorch port (``distributed_dot_product_tpu_torch``):

- importing it loads no JAX (checked in a fresh interpreter);
- no module of the port, nor ``chip_smoke.py`` or the port's profile
  scripts, imports ``jax``, ``flax`` or the reference package (an AST
  scan; the port's name begins with the reference's, so names are
  matched exactly or up to a dot);
- entry points default to the card and raise without one;
- CPU calls run the plain versions and leave the kernel launch counters
  at 0, serving (greedy generation, and the scheduler over the slab and
  paged engines) and training (K1, K3, K4, K5, K5p);
- ``chip_smoke.py`` exits non-zero and prints no result without a card,
  both in the repository and alone in an empty directory.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import distributed_dot_product_tpu_torch as port
from distributed_dot_product_tpu_torch.models import decode as tdec

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / 'distributed_dot_product_tpu_torch'
BANNED = ('jax', 'flax', 'distributed_dot_product_tpu')


def _banned(name):
    return any(name == b or name.startswith(b + '.') for b in BANNED)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_import_loads_no_jax():
    code = ('import sys, distributed_dot_product_tpu_torch\n'
            'bad = [m for m in sys.modules if m in ("jax", "flax") or '
            'm == "distributed_dot_product_tpu" or '
            'm.startswith("distributed_dot_product_tpu.")]\n'
            'assert not bad, bad\n')
    env = {**os.environ, 'PYTHONPATH': str(REPO)}
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize('path', sorted(
    [p.relative_to(REPO) for p in PORT.rglob('*.py')]
    + [Path('chip_smoke.py')]
    + [p.relative_to(REPO) for p in (REPO / 'scripts').glob('torch_*.py')]),
    ids=str)
def test_no_reference_imports(path):
    bad = [m for m in _imports(REPO / path) if _banned(m)]
    assert not bad, f'{path} imports {bad}'


def test_banned_name_matching():
    assert _banned('jax.numpy') and _banned('distributed_dot_product_tpu.ops')
    assert not _banned('distributed_dot_product_tpu_torch.ops')
    assert not _banned('jaxlib_free') and not _banned('flaxen')


def test_default_device_is_cuda_and_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert port.resolve_device('cpu') == torch.device('cpu')
    for build in (lambda: port.resolve_device(),
                  lambda: port.TransformerLM(64, 32, 4),
                  lambda: port.TransformerLM(64, 32, 4, remat=True,
                                             dtype=torch.bfloat16),
                  lambda: port.TransformerStack(32, 4),
                  lambda: port.TransformerBlock(32, 4),
                  lambda: port.DistributedDotProductAttn(
                      32, num_heads=4, softmax_impl='flash'),
                  lambda: port.OwnedDense(4, 4),
                  lambda: port.init_cache(1, 1, 4, 4),
                  lambda: port.init_slot_cache(2, 1, 4, 4),
                  lambda: port.init_paged_cache(2, 1, 4, 4, pages=2,
                                                page_size=2),
                  lambda: port.KernelEngine(2, 8),
                  lambda: port.KernelEngine(2, 8, cache_mode='paged')):
        with pytest.raises(RuntimeError, match='cuda'):
            build()


COUNTED = ('flash_attention', 'flash_attention_dq', 'flash_attention_dkv',
           'flash_decode', 'flash_decode_paged')


def test_cpu_calls_leave_launch_counters_at_zero():
    for name in COUNTED:
        getattr(port, name).launches = 0
    x = torch.randn((1, 2, 8, 32))
    port.flash_attention(x, x, x, causal=True)
    cache = tdec.init_cache(1, 2, 8, 32, dtype=torch.float32, device='cpu')
    one = torch.randn((1, 2, 1, 32))
    tdec.decode_step(one, cache, one, one)
    model = port.TransformerLM(64, 32, 4, n_layers=1, device='cpu')
    port.greedy_generate(model, torch.zeros((1, 3), dtype=torch.int32), 3, 8)
    assert all(getattr(port, name).launches == 0 for name in COUNTED)


@pytest.mark.parametrize('cache_mode', ['slab', 'paged'])
def test_cpu_scheduler_leaves_launch_counters_at_zero(cache_mode):
    for name in COUNTED:
        getattr(port, name).launches = 0
    engine = port.KernelEngine(2, 16, prefill_chunk=4, cache_mode=cache_mode,
                               page_size=4, device='cpu')
    with port.Scheduler(engine, port.ServeConfig(watchdog=False),
                        fault_injector=False) as sched:
        for prompt in ([1, 2, 3, 4, 5], [6], [7, 8]):
            sched.submit(prompt)
        results = sched.run_until_idle()
    assert {r.status for r in results.values()} == {'completed'}
    assert all(getattr(port, name).launches == 0 for name in COUNTED)


def test_cpu_train_step_leaves_launch_counters_at_zero():
    for name in COUNTED:
        getattr(port, name).launches = 0
    model = port.TransformerLM(64, 32, 4, n_layers=2, remat=True,
                               device='cpu')
    step = port.make_lm_train_step(model, torch.optim.Adam(
        model.parameters(), lr=3e-4), loss_chunk=8)
    tokens = torch.randint(0, 64, (2, 12), generator=torch.Generator()
                           .manual_seed(0))
    rec = port.make_lm_train_step(model, torch.optim.Adam(
        model.parameters(), lr=3e-4), guard=True)(
            (tokens, port.lm_targets(tokens)))
    loss = step((tokens, port.lm_targets(tokens)))
    assert torch.isfinite(loss) and not bool(rec['bad_step'])
    assert all(getattr(port, name).launches == 0 for name in COUNTED)


def test_train_step_refuses_a_multi_rank_group():
    """The language model's multi-rank step is ported now: built over a
    data x seq mesh it trains (here a one-rank mesh, without a process
    group) and gives the one-card step's loss and parameters; the
    2 x 2 gloo group is held against JAX in test_torch_flagship.py."""
    tokens = torch.randint(0, 64, (2, 12), generator=torch.Generator()
                           .manual_seed(1))
    batch = (tokens, port.lm_targets(tokens))
    after = []
    for mesh in (None, port.data_seq_mesh(1, 1)):
        model = port.TransformerLM(64, 32, 4, n_layers=1, device='cpu',
                                   generator=torch.Generator().manual_seed(2))
        step = port.make_lm_train_step(
            model, torch.optim.SGD(model.parameters(), lr=0.1), mesh=mesh,
            data_axis=None if mesh is None else 'data', loss_chunk=8)
        after.append((step(batch), model.state_dict()))
    (loss0, s0), (loss1, s1) = after
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


def test_seeded_init_is_reproducible_and_layers_differ():
    a = port.TransformerLM(64, 32, 4, n_layers=2, device='cpu',
                           generator=torch.Generator().manual_seed(3))
    b = port.TransformerLM(64, 32, 4, n_layers=2, device='cpu',
                           generator=torch.Generator().manual_seed(3))
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    w0 = sa['stack.blocks.0.attn.keys_proj.weight']
    assert not torch.equal(w0, sa['stack.blocks.1.attn.keys_proj.weight'])


def _run_chip_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env['CUDA_VISIBLE_DEVICES'] = ''
    return subprocess.run([sys.executable, 'chip_smoke.py'], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_without_card(tmp_path):
    alone = tmp_path / 'alone'
    alone.mkdir()
    shutil.copy(REPO / 'chip_smoke.py', alone)
    for cwd in (REPO, alone):
        res = _run_chip_smoke(cwd)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
